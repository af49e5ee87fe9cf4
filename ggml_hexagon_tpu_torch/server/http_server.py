"""HTTP inference server: the llama-server analog.

Counterpart of ggml_hexagon_tpu/server/http_server.py, serving the port's
continuous-batching engine (server/batch_engine.py).  Endpoints:
  POST /completion(s)        llama.cpp-native completion (+ SSE streaming)
  POST /v1/completions       OpenAI completions
  POST /v1/chat/completions  OpenAI chat (chat template applied, tools) (+ SSE)
  POST /infill               fill-in-middle (FIM-token prompt assembly)
  POST /embedding(s) /v1/embeddings  pooled decoder embeddings
  POST /tokenize /detokenize /apply-template
  POST /slots/{id}?action=save|restore|erase
  GET  /health /v1/health /metrics /slots /props /models /v1/models
  GET  /lora-adapters        [] (no adapters)

stdlib ThreadingHTTPServer + a scheduler thread driving BatchEngine ticks.
Every device call (the loop's ticks and the slot actions) runs under the
engine's lock, so the card sees one stream of work.  Grammar / JSON-schema
constraints (also lazily triggered) come in the "grammar" / "json_schema"
request fields.  Optional API-key auth: requests must carry
"Authorization: Bearer <key>" (/health and /models stay open).

What needs modules the port has not yet: the bert-family encoders'
embedding/rerank mode (/rerank: models/bert) and LoRA adapters (POST
/lora-adapters: models/lora) answer HTTP 501 with an error naming the
missing module; `--lora` and a bert-family GGUF are refused at start-up.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.chat import apply_chat_template, template_from_gguf
from ..runtime.grammar import GrammarSampler, parse_gbnf
from ..runtime.json_schema import json_schema_to_gbnf
from ..runtime.sampling import make_chain
from ..tokenizer import build_tokenizer
from .batch_engine import BatchEngine, SlotState


BERT_ARCHS = ("bert", "nomic-bert", "jina-bert-v2")

#: the GGUF pooling_type values (llama.h enum llama_pooling_type)
_POOLING_NAMES = {0: "none", 1: "mean", 2: "cls", 3: "last", 4: "rank"}

#: the JAX package's server features that need modules the port lacks:
#: feature -> the missing module
UNPORTED = {
    "rerank": "models/bert (the encoder's embedding/rerank mode)",
    "lora": "models/lora (LoRA adapters)",
}


class NotPortedError(NotImplementedError):
    """A feature that needs a module the port does not have yet (HTTP
    501)."""

    def __init__(self, feature: str):
        super().__init__(f"{feature} needs {UNPORTED[feature]}, which the "
                         "port does not have yet")


class InferenceServer:
    def __init__(self, engine: BatchEngine, api_key: str | None = None,
                 model_path: str = "", lora_paths: list | None = None):
        if lora_paths:
            raise NotPortedError("lora")
        self.engine = engine
        self.api_key = api_key
        self.model_path = model_path
        self.tokenizer = build_tokenizer(engine.vocab)
        self.template, self.template_src = template_from_gguf(
            getattr(engine, "metadata", {}))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.t_start = time.time()

    def lora_list(self) -> list:
        return []

    def _loop(self):
        while not self._stop.is_set():
            with self.engine.lock:
                worked = self.engine.step() if self.engine.has_work() else False
            if not worked:
                time.sleep(0.002)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    # -- request handling ----------------------------------------------------

    def _make_sampler(self, body: dict):
        grammar_sampler = None
        # lazy activation (llama-server grammar_lazy/grammar_triggers):
        # the grammar stays inert until a trigger pattern/token appears —
        # how tool-call grammars avoid constraining normal prose
        lazy_kw = {}
        if body.get("grammar_lazy"):
            trig = body.get("grammar_triggers", [])
            lazy_kw = dict(
                lazy=True,
                trigger_patterns=[t.get("value", t) if isinstance(t, dict)
                                  else t for t in trig
                                  if not isinstance(t, dict)
                                  or t.get("type", "pattern") != "token"],
                trigger_tokens=[t["token"] for t in trig
                                if isinstance(t, dict) and "token" in t])
        if body.get("json_schema"):
            g = parse_gbnf(json_schema_to_gbnf(body["json_schema"]))
            grammar_sampler = GrammarSampler.from_vocab(g, self.engine.vocab,
                                                        **lazy_kw)
        elif body.get("grammar"):
            g = parse_gbnf(body["grammar"])
            grammar_sampler = GrammarSampler.from_vocab(g, self.engine.vocab,
                                                        **lazy_kw)
        return make_chain(
            temp=float(body.get("temperature", 0.8)),
            top_k=int(body.get("top_k", 40)),
            top_p=float(body.get("top_p", 0.95)),
            min_p=float(body.get("min_p", 0.05)),
            penalty_repeat=float(body.get("repeat_penalty", 1.0)),
            penalty_last_n=int(body.get("repeat_last_n", 64)),
            seed=int(body.get("seed", 42)),
            grammar_sampler=grammar_sampler,
        )

    def completion(self, body: dict):
        """Returns an iterator of (text_piece, done_payload|None)."""
        prompt = body.get("prompt", "")
        ids = (
            self.tokenizer.encode(prompt, parse_special=True)
            if isinstance(prompt, str)
            else [int(t) for t in prompt]
        )
        n_predict = int(body.get("n_predict", body.get("max_tokens", 64)))
        sampler = self._make_sampler(body)
        stop_strings = body.get("stop") or []
        if isinstance(stop_strings, str):
            stop_strings = [stop_strings]
        q = self.engine.submit(
            ids, n_predict=n_predict, sampler=sampler,
            stop_strings=stop_strings,
            cache_prompt=bool(body.get("cache_prompt", True)),
        )
        t0 = time.perf_counter()
        n = 0

        def gen():
            nonlocal n
            while True:
                tok, fin = q.get(timeout=600)
                if tok is None:
                    yield None, {
                        "stop": True,
                        "stop_type": fin,
                        "tokens_predicted": n,
                        "tokens_evaluated": len(ids),
                        "timings": {
                            "predicted_ms": (time.perf_counter() - t0) * 1e3,
                            "predicted_per_second": n / max(1e-9, time.perf_counter() - t0),
                        },
                    }
                    return
                n += 1
                yield self.tokenizer.decode([tok], skip_special=False), None

        return gen()

    def chat_completion(self, body: dict):
        msgs = list(body["messages"])
        if body.get("tools"):
            # inject the tool list as a leading system block (chat.cpp's
            # per-format prompt additions) so any template carries it
            from ..runtime.toolcall import detect_format, render_tools_prompt

            fmt = detect_format(self.template_src or self.template)
            block = render_tools_prompt(body["tools"], fmt)
            if msgs and msgs[0].get("role") == "system":
                msgs[0] = dict(msgs[0],
                               content=block + (msgs[0].get("content") or ""))
            else:
                msgs.insert(0, {"role": "system", "content": block})
        prompt = apply_chat_template(
            msgs, self.template, add_assistant=True, jinja_source=self.template_src
        )
        sub = dict(body)
        sub["prompt"] = prompt
        sub.setdefault("n_predict", body.get("max_tokens", 128))
        return self.completion(sub)

    def chat_format(self) -> str:
        from ..runtime.toolcall import detect_format

        return detect_format(self.template_src or self.template)

    # -- infill ----------------------------------------------------------------

    def infill(self, body: dict):
        """POST /infill: FIM prompt assembly + completion (server.cpp:4025)."""
        from ..runtime.infill import format_infill

        md = getattr(self.engine, "metadata", {})
        prompt_tokens = []
        if body.get("prompt"):
            prompt_tokens = self.tokenizer.encode(body["prompt"],
                                                  add_bos=False)
        ids = format_infill(
            md, self.tokenizer,
            body.get("input_prefix", ""), body.get("input_suffix", ""),
            prompt_tokens=prompt_tokens,
            input_extra=body.get("input_extra") or [],
            n_predict=int(body.get("n_predict", 64)),
            n_ctx=self.engine.max_seq,
        )
        sub = dict(body)
        sub["prompt"] = ids
        return self.completion(sub)

    def _tokenize_inputs(self, prompt) -> list:
        """'input'/'content' shapes: str | [str] | [ids] | [[ids]]
        (tokenize_input_prompts, examples/server/utils.hpp)."""
        if isinstance(prompt, str):
            return [self.tokenizer.encode(prompt, parse_special=True)]
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return [[int(t) for t in prompt]]
        out = []
        for p in prompt:
            out.append(self.tokenizer.encode(p, parse_special=True)
                       if isinstance(p, str)
                       else [int(t) for t in p])
        return out

    def embeddings(self, prompt, pooling: str | None = None):
        """Pooled decoder embeddings for each input (runtime/embedding,
        under the engine's lock) -> (rows [[f32] | [[f32]]], tokens)."""
        from ..runtime.embedding import extract_embeddings

        token_lists = self._tokenize_inputs(prompt)
        if any(not t for t in token_lists):
            raise ValueError("input content cannot be empty")
        md = getattr(self.engine, "metadata", {})
        arch = md.get("general.architecture", "llama")
        if pooling is None:
            pooling = _POOLING_NAMES.get(
                int(md.get(f"{arch}.pooling_type", 1)), "mean")
        with self.engine.lock:
            e = extract_embeddings(self.engine.cfg, self.engine.weights,
                                   token_lists, pooling=pooling,
                                   device=self.engine.device)
        rows = [row.tolist() for row in e]
        return rows, sum(map(len, token_lists))

    def apply_template(self, body: dict) -> str:
        return apply_chat_template(
            list(body.get("messages", [])), self.template,
            add_assistant=True, jinja_source=self.template_src)

    def models_json(self) -> dict:
        name = os.path.basename(self.model_path) or "model"
        return {
            "object": "list",
            "data": [{
                "id": name, "object": "model",
                "created": int(self.t_start), "owned_by": "ggml_hexagon_tpu_torch",
            }],
        }

    # -- metrics -------------------------------------------------------------

    def props(self) -> dict:
        c = self.engine.cfg
        return {
            "model": {
                "n_vocab": c.n_vocab, "n_embd": c.n_embd, "n_layer": c.n_layer,
                "n_head": c.n_head, "n_head_kv": c.n_head_kv,
            },
            "total_slots": self.engine.n_slots,
            "chat_template": self.template,
        }

    def slots(self) -> list:
        return [
            {
                "id": s.id,
                "state": s.state.name,
                "n_past": s.n_past,
                "n_decoded": s.n_decoded,
            }
            for s in self.engine.slots
        ]

    def metrics_text(self) -> str:
        m = self.engine.metrics
        ttft = sorted(self.engine.ttft_samples)
        p50 = ttft[len(ttft) // 2] * 1e3 if ttft else 0.0
        lines = [
            f"ghtpu_requests_total {m['n_requests']}",
            f"ghtpu_tokens_generated_total {m['n_tokens_generated']}",
            f"ghtpu_prompt_tokens_total {m['n_prompt_tokens']}",
            f"ghtpu_prompt_tokens_cached_total {m['n_prompt_tokens_cached']}",
            f"ghtpu_ttft_p50_ms {p50:.1f}",
            f"ghtpu_decode_seconds_total {m['t_decode']:.3f}",
            f"ghtpu_prompt_seconds_total {m['t_prompt']:.3f}",
            f"ghtpu_uptime_seconds {time.time() - self.t_start:.0f}",
        ]
        return "\n".join(lines) + "\n"


def make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        # endpoints reachable without an API key (server.cpp public_endpoints)
        # the webui page itself is public like the reference's (the API
        # calls it makes still carry the key requirement)
        PUBLIC = ("/health", "/v1/health", "/models", "/v1/models",
                  "/", "/index.html")

        def _authed(self) -> bool:
            if not server.api_key or self.path.split("?")[0] in self.PUBLIC:
                return True
            auth = self.headers.get("Authorization", "")
            if auth == f"Bearer {server.api_key}":
                return True
            self._json(401, {"error": {"code": 401,
                                       "message": "Invalid API Key",
                                       "type": "authentication_error"}})
            return False

        def do_GET(self):
            if not self._authed():
                return
            if self.path in ("/", "/index.html"):
                from .webui import INDEX_HTML

                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path in ("/health", "/v1/health"):
                self._json(200, {"status": "ok"})
            elif self.path in ("/models", "/v1/models"):
                self._json(200, server.models_json())
            elif self.path == "/metrics":
                body = server.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/slots":
                self._json(200, server.slots())
            elif self.path == "/props":
                self._json(200, server.props())
            elif self.path == "/lora-adapters":
                self._json(200, server.lora_list())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                if not self._authed():
                    return
                import re as _re

                m = _re.match(r"^/slots/(\d+)\?action=(save|restore|erase)$",
                              self.path)
                if m:
                    body = self._read_body()
                    sid = int(m.group(1))
                    action = m.group(2)
                    if action == "erase":
                        with server.engine.lock:
                            n = server.engine.erase_slot(sid)
                        self._json(200, {"id_slot": sid, "n_erased": n})
                        return
                    path = body.get("filename", os.path.join(
                        tempfile.gettempdir(), f"slot_{sid}.npz"))
                    with server.engine.lock:
                        if action == "save":
                            server.engine.save_slot(sid, path)
                        else:
                            server.engine.restore_slot(sid, path)
                    self._json(200, {"id_slot": sid, "filename": path})
                    return
                body = self._read_body()
                if self.path in ("/completion", "/completions"):
                    self._completion(body, openai=False)
                elif self.path == "/v1/completions":
                    self._completion(body, openai=True)
                elif self.path == "/v1/chat/completions":
                    self._chat(body)
                elif self.path == "/infill":
                    self._infill(body)
                elif self.path in ("/embedding", "/embeddings"):
                    self._embeddings(body, openai=False)
                elif self.path == "/v1/embeddings":
                    self._embeddings(body, openai=True)
                elif self.path in ("/rerank", "/reranking",
                                   "/v1/rerank", "/v1/reranking"):
                    raise NotPortedError("rerank")
                elif self.path == "/tokenize":
                    ids = server.tokenizer.encode(
                        body.get("content", ""),
                        parse_special=bool(body.get("parse_special", True)))
                    if body.get("with_pieces"):
                        self._json(200, {"tokens": [
                            {"id": t, "piece": server.tokenizer.decode([t])}
                            for t in ids]})
                    else:
                        self._json(200, {"tokens": ids})
                elif self.path == "/detokenize":
                    text = server.tokenizer.decode(body.get("tokens", []))
                    self._json(200, {"content": text})
                elif self.path == "/apply-template":
                    self._json(200, {"prompt": server.apply_template(body)})
                elif self.path == "/lora-adapters":
                    raise NotPortedError("lora")
                else:
                    self._json(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001 — surface as HTTP 500
                from ..runtime.engine import ContextOverflowError

                code = 400 if isinstance(
                    e, (ContextOverflowError, ValueError)) else 500
                if isinstance(e, NotPortedError):
                    code = 501
                self._json(code, {"error": f"{type(e).__name__}: {e}"})

        def _embeddings(self, body, openai: bool):
            prompt = body.get("input", body.get("content"))
            if prompt is None:
                self._json(400, {"error":
                                 '"input" or "content" must be provided'})
                return
            rows, n_tokens = server.embeddings(prompt)
            if openai:
                self._json(200, {
                    "object": "list",
                    "data": [{"object": "embedding", "index": i,
                              "embedding": row}
                             for i, row in enumerate(rows)],
                    "model": server.models_json()["data"][0]["id"],
                    "usage": {"prompt_tokens": n_tokens,
                              "total_tokens": n_tokens},
                })
            else:
                self._json(200, [{"index": i, "embedding": row}
                                 for i, row in enumerate(rows)])

        def _infill(self, body):
            pieces = server.infill(body)
            text = ""
            final = {}
            for p, d in pieces:
                if p is not None:
                    text += p
                else:
                    final = d
            self._json(200, {"content": text, **final})

        def _stream(self, pieces, wrap):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            for piece, done in pieces:
                payload = wrap(piece, done)
                self.wfile.write(b"data: " + json.dumps(payload).encode() + b"\n\n")
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")

        def _completion(self, body, openai: bool):
            pieces = server.completion(body)
            if body.get("stream"):
                self._stream(
                    pieces,
                    lambda p, d: (
                        {"content": p or "", "stop": bool(d), **(d or {})}
                        if not openai
                        else {"choices": [{"text": p or "",
                                           "finish_reason": d and d.get("stop_type")}]}
                    ),
                )
                return
            text = ""
            final = {}
            for p, d in pieces:
                if p is not None:
                    text += p
                else:
                    final = d
            if openai:
                self._json(200, {
                    "object": "text_completion",
                    "choices": [{"text": text, "index": 0,
                                 "finish_reason": final.get("stop_type")}],
                    "usage": {
                        "prompt_tokens": final.get("tokens_evaluated", 0),
                        "completion_tokens": final.get("tokens_predicted", 0),
                    },
                })
            else:
                self._json(200, {"content": text, **final})

        def _chat(self, body):
            pieces = server.chat_completion(body)
            if body.get("stream"):
                self._stream(
                    pieces,
                    lambda p, d: {
                        "object": "chat.completion.chunk",
                        "choices": [{
                            "delta": ({"content": p} if p is not None else {}),
                            "finish_reason": d and d.get("stop_type"),
                        }],
                    },
                )
                return
            text = ""
            final = {}
            for p, d in pieces:
                if p is not None:
                    text += p
                else:
                    final = d
            msg = {"role": "assistant", "content": text}
            finish = final.get("stop_type")
            if body.get("tools"):
                from ..runtime.toolcall import (parse_chat_output,
                                                tool_calls_json)

                parsed = parse_chat_output(text, server.chat_format())
                msg["content"] = parsed.content or None
                if parsed.reasoning:
                    msg["reasoning_content"] = parsed.reasoning
                if parsed.tool_calls:
                    msg["tool_calls"] = tool_calls_json(parsed)
                    finish = "tool_calls"
            self._json(200, {
                "object": "chat.completion",
                "choices": [{
                    "index": 0,
                    "message": msg,
                    "finish_reason": finish,
                }],
                "usage": {
                    "prompt_tokens": final.get("tokens_evaluated", 0),
                    "completion_tokens": final.get("tokens_predicted", 0),
                },
            })

    return Handler


def build_server(gguf_path, n_slots: int = 4, max_seq: int = 2048,
                 api_key: str | None = None, lora: list | None = None,
                 draft_path: str | None = None, n_draft: int = 8,
                 ctx_shift: bool = False, **engine_kw) -> InferenceServer:
    """The server for a decoder GGUF: the continuous-batching engine on the
    card (engine_kw: kv_dtype, device, ...).  A bert-family GGUF (the JAX
    package's embedding/rerank mode) and LoRA adapters are refused: the
    port has no models/bert nor models/lora yet."""
    from ..gguf.reader import GGUFReader

    if lora:
        raise NotPortedError("lora")
    with GGUFReader.open(gguf_path) as r:
        arch = r.metadata.get("general.architecture", "llama")
    if arch in BERT_ARCHS:
        raise NotPortedError("rerank")
    draft = None
    if draft_path:
        from .batch_engine import DraftModel

        draft = DraftModel.from_gguf(draft_path, n_slots, max_seq,
                                     **{k: v for k, v in engine_kw.items()
                                        if k in ("device", "kv_dtype")})
    engine = BatchEngine.from_gguf(gguf_path, n_slots=n_slots,
                                   max_seq=max_seq, draft=draft,
                                   n_draft=n_draft, ctx_shift=ctx_shift,
                                   **engine_kw)
    return InferenceServer(engine, api_key=api_key, model_path=str(gguf_path))


def serve(gguf_path: str, host: str = "127.0.0.1", port: int = 8080,
          n_slots: int = 4, max_seq: int = 2048, **kw):
    srv = build_server(gguf_path, n_slots=n_slots, max_seq=max_seq, **kw)
    srv.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(srv))
    print(f"listening on http://{host}:{port} ({n_slots} slots, "
          f"ctx {max_seq})")
    try:
        httpd.serve_forever()
    finally:
        srv.stop()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="inference server")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--api-key", default=None)
    p.add_argument("--lora", action="append", default=None,
                   metavar="PATH[:SCALE]",
                   help="LoRA adapter GGUF (repeatable)")
    p.add_argument("-md", "--model-draft", default=None,
                   help="draft model GGUF for speculative decoding")
    p.add_argument("--draft-max", type=int, default=8,
                   help="max draft tokens per round")
    p.add_argument("--ctx-shift", action="store_true",
                   help="context-shift full slots instead of finishing")
    a = p.parse_args(argv)
    serve(a.model, a.host, a.port, a.slots, a.ctx_size,
          api_key=a.api_key, lora=a.lora, draft_path=a.model_draft,
          n_draft=a.draft_max, ctx_shift=a.ctx_shift)


if __name__ == "__main__":
    main()
