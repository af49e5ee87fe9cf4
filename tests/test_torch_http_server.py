"""The port's HTTP server (server/http_server.py) and the host modules it
serves with, copied from the JAX package.

  - every case of tests/test_http_server.py and every decoder-mode case of
    tests/test_server_endpoints.py, held within the port: a real server on
    loopback over tests/_torch_gguf_model.py's 2-layer Q4_K/Q6_K GGUF at
    2 query / 1 KV heads of 128 (FIM specials at spare vocabulary ids),
    the CPU plain versions;
  - the greedy text of /completion (plain and SSE) equal to the same
    request through a fresh engine's complete;
  - the routes that need modules the port lacks (models/bert,
    models/lora) answer 501 naming the module, and the decoder embedding
    routes, which runtime/embedding now serves, answer 200 (held to
    extract_embeddings in test_torch_embedding.py); a bert-family GGUF and
    LoRA adapters are refused at start-up; GET /lora-adapters is [];
  - the copies (runtime/chat, grammar, json_schema, toolcall, infill)
    against the JAX modules on the same inputs: every chat template and
    the template detection, json_schema_to_gbnf, the grammar sampler's
    masks along an accepted text, tool-call detection, prompts and
    parsing, FIM prompt assembly.
"""
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.gguf.writer import GGUFWriter
from ggml_hexagon_tpu.runtime import chat as j_chat
from ggml_hexagon_tpu.runtime import grammar as j_grammar
from ggml_hexagon_tpu.runtime import infill as j_infill
from ggml_hexagon_tpu.runtime import json_schema as j_schema
from ggml_hexagon_tpu.runtime import toolcall as j_tool
from ggml_hexagon_tpu.tokenizer import Vocab as JVocab

from _torch_gguf_model import vocab_fields, write_model
from ggml_hexagon_tpu_torch.runtime import chat as p_chat
from ggml_hexagon_tpu_torch.runtime import grammar as p_grammar
from ggml_hexagon_tpu_torch.runtime import infill as p_infill
from ggml_hexagon_tpu_torch.runtime import json_schema as p_schema
from ggml_hexagon_tpu_torch.runtime import toolcall as p_tool
from ggml_hexagon_tpu_torch.server.batch_engine import BatchEngine
from ggml_hexagon_tpu_torch.server.http_server import (InferenceServer,
                                                       NotPortedError,
                                                       build_server,
                                                       make_handler)
from ggml_hexagon_tpu_torch.tokenizer import Vocab, build_tokenizer

FIM = {"tokenizer.ggml.fim_pre_token_id": 262,
       "tokenizer.ggml.fim_suf_token_id": 263,
       "tokenizer.ggml.fim_mid_token_id": 264}
SHAPE = dict(n_slots=2, max_seq=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, so a request's logits do not follow the load
    (see test_torch_batch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("http") / "tiny-q4_k_m.gguf"
    write_model(path, nh=2, nkv=1, extra_metadata=FIM)
    be = BatchEngine.from_gguf(path, device="cpu", **SHAPE)
    return {"path": path, "engine": be}


def _fresh(model):
    be = model["engine"]
    eng = BatchEngine(be.cfg, be.weights, be.vocab, device="cpu", **SHAPE)
    eng.metadata = be.metadata
    return eng


def _spawn(srv):
    srv.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def http_server(model):
    srv = InferenceServer(model["engine"], model_path=str(model["path"]))
    httpd, url = _spawn(srv)
    yield url
    httpd.shutdown()
    srv.stop()


AUTH = {"Authorization": "Bearer sk-test"}


@pytest.fixture(scope="module")
def decoder_server(model):
    srv = InferenceServer(_fresh(model), api_key="sk-test",
                          model_path=str(model["path"]))
    httpd, url = _spawn(srv)
    yield url
    httpd.shutdown()
    srv.stop()


def post(url, path, payload, headers=None):
    req = urllib.request.Request(
        url + path, json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def get(url, path, headers=None):
    req = urllib.request.Request(url + path, headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read().decode()


def _status(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code, json.loads(e.value.read())


# -- tests/test_http_server.py ----------------------------------------------


def test_health(http_server):
    assert json.loads(get(http_server, "/health")) == {"status": "ok"}


def test_props_and_slots(http_server):
    props = json.loads(get(http_server, "/props"))
    assert props["model"]["n_layer"] == 2
    assert props["total_slots"] == 2
    assert len(json.loads(get(http_server, "/slots"))) == 2


def test_completion(http_server):
    r = post(http_server, "/completion",
             {"prompt": "hello world", "n_predict": 6, "temperature": 0})
    assert r["stop"] is True and r["tokens_predicted"] >= 1
    assert isinstance(r["content"], str)
    r2 = post(http_server, "/completion",
              {"prompt": "hello world", "n_predict": 6, "temperature": 0})
    assert r2["content"] == r["content"]


def test_completion_text_equals_engine_complete(model, http_server):
    """The greedy text of /completion, plain and streamed as SSE, equals
    the same request through a fresh engine (the prompt evaluated from
    slot 0 of the cache in both: cache_prompt false)."""
    body = {"prompt": "the model card", "n_predict": 8, "temperature": 0,
            "cache_prompt": False}
    eng = _fresh(model)
    tok = build_tokenizer(eng.vocab)
    ids = tok.encode(body["prompt"], parse_special=True)
    want = "".join(tok.decode([t], skip_special=False)
                   for t in eng.complete(ids, n_predict=8))
    assert post(http_server, "/completion", body)["content"] == want
    req = urllib.request.Request(
        http_server + "/completion", json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        events = [ln[6:] for ln in r.read().decode().split("\n\n")
                  if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[-1]["stop"] is True
    assert "".join(c["content"] for c in chunks) == want


def test_openai_completions(http_server):
    r = post(http_server, "/v1/completions",
             {"prompt": "hello", "max_tokens": 4, "temperature": 0})
    assert r["object"] == "text_completion"
    assert r["usage"]["completion_tokens"] >= 1


def test_chat_completion(http_server):
    r = post(http_server, "/v1/chat/completions",
             {"messages": [{"role": "user", "content": "hello"}],
              "max_tokens": 4, "temperature": 0})
    assert r["object"] == "chat.completion"
    assert r["choices"][0]["message"]["role"] == "assistant"


def test_tokenize_roundtrip(http_server):
    r = post(http_server, "/tokenize", {"content": "hello world"})
    assert isinstance(r["tokens"], list) and r["tokens"]
    r2 = post(http_server, "/detokenize", {"tokens": r["tokens"]})
    assert isinstance(r2["content"], str)


def test_concurrent_http_requests(http_server):
    results = {}

    def go(i):
        results[i] = post(http_server, "/completion",
                          {"prompt": f"hello text {'the ' * i}",
                           "n_predict": 5, "temperature": 0})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == 4
    for r in results.values():
        assert r["stop"] is True


def test_metrics(http_server):
    m = get(http_server, "/metrics")
    assert "ghtpu_requests_total" in m
    assert "ghtpu_tokens_generated_total" in m


def test_error_handling(http_server):
    assert _status(lambda: post(http_server, "/nope", {}))[0] == 404


def test_slot_save_restore_endpoint(http_server, tmp_path):
    post(http_server, "/completion",
         {"prompt": "hello", "n_predict": 2, "temperature": 0})
    p = str(tmp_path / "slot0.npz")
    r = post(http_server, "/slots/0?action=save", {"filename": p})
    assert r["filename"] == p
    r2 = post(http_server, "/slots/0?action=restore", {"filename": p})
    assert r2["id_slot"] == 0


def test_chat_completion_tool_calls_wire():
    """Tool calls assembled into the OpenAI wire shape from a scripted
    generation."""

    class StubServer:
        template = "chatml"
        template_src = "{% if tools %}<tool_call>{% endif %}"
        api_key = None
        engine = object()

        def chat_format(self):
            return p_tool.detect_format(self.template_src)

        def chat_completion(self, body):
            text = ('Checking.<tool_call>{"name": "get_weather", '
                    '"arguments": {"city": "Paris"}}</tool_call>')
            yield text, None
            yield None, {"stop_type": "eos", "tokens_evaluated": 5,
                         "tokens_predicted": 9}

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(StubServer()))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        res = post(f"http://127.0.0.1:{httpd.server_address[1]}",
                   "/v1/chat/completions", {
                       "messages": [{"role": "user",
                                     "content": "weather in Paris?"}],
                       "tools": [{"type": "function",
                                  "function": {"name": "get_weather"}}]})
        msg = res["choices"][0]["message"]
        assert res["choices"][0]["finish_reason"] == "tool_calls"
        assert msg["content"] == "Checking."
        tc = msg["tool_calls"][0]
        assert tc["type"] == "function"
        assert tc["function"]["name"] == "get_weather"
        assert json.loads(tc["function"]["arguments"]) == {"city": "Paris"}
    finally:
        httpd.shutdown()


def test_webui_served_at_root(http_server):
    with urllib.request.urlopen(http_server + "/", timeout=30) as r:
        assert r.status == 200
        assert "text/html" in r.headers["Content-Type"]
        body = r.read().decode()
    assert "/v1/chat/completions" in body and "<form" in body


# -- tests/test_server_endpoints.py, decoder mode -------------------------------


def test_api_key_required(decoder_server):
    assert json.loads(get(decoder_server, "/health"))["status"] == "ok"
    assert json.loads(get(decoder_server, "/v1/models"))["object"] == "list"
    assert _status(lambda: post(decoder_server, "/completion",
                                {"prompt": "a"}))[0] == 401
    assert _status(lambda: get(decoder_server, "/props"))[0] == 401
    assert _status(lambda: post(decoder_server, "/completion", {"prompt": "a"},
                                headers={"Authorization": "Bearer wrong"})
                   )[0] == 401


def test_completions_alias_with_key(decoder_server):
    r = post(decoder_server, "/completions",
             {"prompt": "hello world", "n_predict": 2, "temperature": 0},
             headers=AUTH)
    assert r["stop"] is True


def test_infill_http(decoder_server):
    r = post(decoder_server, "/infill",
             {"input_prefix": "hello", "input_suffix": "world",
              "n_predict": 2, "temperature": 0}, headers=AUTH)
    assert r["stop"] is True and isinstance(r["content"], str)


def test_apply_template(decoder_server):
    r = post(decoder_server, "/apply-template",
             {"messages": [{"role": "user", "content": "hi"}]}, headers=AUTH)
    assert "hi" in r["prompt"]


def test_slot_erase(decoder_server):
    r = post(decoder_server, "/slots/0?action=erase", {}, headers=AUTH)
    assert r["id_slot"] == 0 and "n_erased" in r


def test_lora_adapters_empty(decoder_server):
    assert json.loads(get(decoder_server, "/lora-adapters",
                          headers=AUTH)) == []


def test_tokenize_with_pieces(decoder_server):
    r = post(decoder_server, "/tokenize",
             {"content": "hello world", "with_pieces": True}, headers=AUTH)
    assert all("id" in t and "piece" in t for t in r["tokens"])


def test_props_and_models(decoder_server):
    p = json.loads(get(decoder_server, "/props", headers=AUTH))
    assert p["model"]["n_embd"] == 256 and p["chat_template"] == "chatml"
    m = json.loads(get(decoder_server, "/v1/models"))
    assert m["data"][0]["id"].endswith(".gguf")


class _FakeTok:
    def encode(self, s, add_bos=False):
        return [100 + ord(c) % 50 for c in s][:8]


INFILL_CASES = [
    ({"tokenizer.ggml.fim_pre_token_id": 5,
      "tokenizer.ggml.fim_suf_token_id": 6,
      "tokenizer.ggml.fim_mid_token_id": 7,
      "tokenizer.ggml.bos_token_id": 1},
     ("def f(:", "return x"), dict(n_ctx=512)),
    ({"tokenizer.ggml.fim_pre_token_id": 5,
      "tokenizer.ggml.fim_suf_token_id": 6,
      "tokenizer.ggml.fim_mid_token_id": 7,
      "tokenizer.ggml.fim_rep_token_id": 8,
      "tokenizer.ggml.fim_sep_token_id": 9,
      "tokenizer.ggml.add_bos_token": False},
     ("pre", "suf"),
     dict(input_extra=[{"filename": "a.py", "text": "ctx"}],
          spm_infill=True, n_batch=64, n_ctx=512)),
]


@pytest.mark.parametrize("case", range(len(INFILL_CASES)))
def test_format_infill_matches_jax(case):
    md, (pre, suf), kw = INFILL_CASES[case]
    want = j_infill.format_infill(md, _FakeTok(), pre, suf, **kw)
    assert p_infill.format_infill(md, _FakeTok(), pre, suf, **kw) == want
    assert want[-1] == 7


def test_format_infill_requires_fim_tokens():
    with pytest.raises(ValueError):
        p_infill.format_infill({}, _FakeTok(), "a", "b")


# -- the routes and modes the port has not yet ----------------------------------


@pytest.mark.parametrize("path,missing", [
    ("/embedding", "runtime/embedding"), ("/embeddings", "runtime/embedding"),
    ("/v1/embeddings", "runtime/embedding"), ("/rerank", "models/bert"),
    ("/v1/rerank", "models/bert"), ("/reranking", "models/bert"),
    ("/lora-adapters", "models/lora")])
def test_unported_routes_answer_501(decoder_server, path, missing):
    """Each route the JAX server has: 501 naming the missing module, but
    the embedding routes, which runtime/embedding serves since it was
    ported: one row of n_embd floats for the one input."""
    payload = {"input": "hello", "query": "hello", "documents": ["world"]}
    if missing == "runtime/embedding":
        got = post(decoder_server, path, payload, headers=AUTH)
        rows = got["data"] if path == "/v1/embeddings" else got
        assert len(rows) == 1 and len(rows[0]["embedding"]) == 256
        return
    code, body = _status(lambda: post(decoder_server, path, payload,
                                      headers=AUTH))
    assert code == 501 and missing in body["error"]


def test_bert_gguf_and_lora_refused_at_start_up(model, tmp_path):
    path = tmp_path / "bert.gguf"
    w = GGUFWriter()
    w.add("general.architecture", "bert")
    w.write_file(str(path))
    with pytest.raises(NotPortedError, match="models/bert"):
        build_server(path, device="cpu")
    with pytest.raises(NotPortedError, match="models/lora"):
        build_server(model["path"], lora=["adapter.gguf"], device="cpu")
    with pytest.raises(NotPortedError, match="models/lora"):
        InferenceServer(model["engine"], lora_paths=["adapter.gguf"])


def test_build_server_serves_the_decoder(model):
    srv = build_server(model["path"], n_slots=1, max_seq=32, device="cpu")
    assert srv.engine.n_slots == 1 and srv.engine.device.type == "cpu"
    assert srv.template == "chatml"


# -- the copied host modules against the JAX package's ----------------------------

MSGS = [
    {"role": "system", "content": "You are helpful."},
    {"role": "user", "content": "Hi"},
    {"role": "assistant", "content": "Hello!"},
    {"role": "user", "content": "Bye"},
]


@pytest.mark.parametrize("name", sorted(j_chat.FORMATTERS))
def test_chat_template_matches_jax(name):
    assert sorted(p_chat.FORMATTERS) == sorted(j_chat.FORMATTERS)
    for msgs in (MSGS, MSGS[1:], MSGS[1:2]):
        for add in (True, False):
            assert (p_chat.apply_chat_template(msgs, name, add)
                    == j_chat.apply_chat_template(msgs, name, add))


FINGERPRINTS = [
    "<|im_start|>", "<|im_sep|>", "[INST]", "[SYSTEM_PROMPT] [INST]",
    "' [INST] ' + system_message", "[AVAILABLE_TOOLS] [INST]",
    "bos_token + '[INST]' content.strip() <<SYS>> [/INST]", "<<SYS>> [INST]",
    "<|assistant|> <|end|>", "<|user|> </s> <|assistant|>",
    "<|user|> <|endoftext|>", "bos_token + message['role']",
    "<start_of_turn>", "GPT4 Correct ", "USER: ASSISTANT: ",
    "SYSTEM: USER: ", "### Instruction: <|EOT|>",
    "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>",
    "<|start_header_id|><|end_header_id|><|eot_id|>", "[gMASK]sop",
    "[gMASK]<sop>", "<用户>", "<｜Assistant｜><｜User｜><｜end▁of▁sentence｜>",
    "[|system|][|assistant|][|endofturn|]", "rwkv-world",
    "<|start_of_role|>", "<|role_start|>", " Ассистент:",
    "<role>ASSISTANT</role> 'HUMAN'", "User: Assistant: ", "plain"]


def test_template_detection_matches_jax():
    for src in FINGERPRINTS:
        assert p_chat.detect_template(src) == j_chat.detect_template(src), src
        md = {"tokenizer.chat_template": src}
        assert p_chat.template_from_gguf(md) == j_chat.template_from_gguf(md)
    assert p_chat.template_from_gguf({}) == j_chat.template_from_gguf({})


SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"},
                                      "ok": {"type": "boolean"}},
     "required": ["name"]},
    {"type": "array", "items": {"enum": ["a", "b"]}, "minItems": 1,
     "maxItems": 3},
    {"anyOf": [{"type": "integer"}, {"type": "boolean"}, {"type": "null"}]},
    {"$defs": {"pt": {"type": "object", "properties": {
        "x": {"type": "number"}, "y": {"type": "number"}}}},
     "type": "array", "prefixItems": [{"$ref": "#/$defs/pt"},
                                      {"const": "end"}]},
    '{"type": "string"}',
]


@pytest.mark.parametrize("case", range(len(SCHEMAS)))
def test_json_schema_to_gbnf_matches_jax(case):
    s = SCHEMAS[case]
    assert p_schema.json_schema_to_gbnf(s) == j_schema.json_schema_to_gbnf(s)


GRAMMARS = [
    ('root ::= "hello" " " ("world" | "model")', "hello world"),
    ("root ::= [a-h]+ [0-9]{2}", "heh"),
    ('root ::= "t" [^x]* "t"', "text"),
    (p_schema.json_schema_to_gbnf(SCHEMAS[0]), '{"name": "h"}'),
]


@pytest.mark.parametrize("case", range(len(GRAMMARS)))
def test_grammar_masks_match_jax(case):
    """The grammar sampler over the test model's vocabulary: the masked
    candidates before and after each accepted character of the text, and
    can_end, equal to the JAX sampler's."""
    gbnf, text = GRAMMARS[case]
    md = vocab_fields(300)
    samplers = [g.GrammarSampler.from_vocab(g.parse_gbnf(gbnf), V.from_gguf(md))
                for g, V in ((p_grammar, Vocab), (j_grammar, JVocab))]
    rng = np.random.default_rng(case)
    for step in range(len(text) + 1):
        logits = rng.normal(size=300).astype(np.float32)
        cands = [SimpleNamespace(logits=logits.copy(), probs=None)
                 for _ in samplers]
        for smp, c in zip(samplers, cands):
            smp.apply(c)
        assert np.array_equal(cands[0].logits, cands[1].logits), step
        assert np.isfinite(cands[0].logits).any()
        assert samplers[0].grammar.can_end == samplers[1].grammar.can_end
        if step < len(text):
            for smp in samplers:
                smp.grammar.accept_text(text[step])


TOOL_TEXTS = [
    ("hermes_2_pro", 'Sure.\n<tool_call>\n{"name": "get_weather", '
     '"arguments": {"city": "Paris"}}\n</tool_call>'),
    ("mistral_nemo", '[TOOL_CALLS][{"name": "get_weather", '
     '"arguments": {"city": "Rome"}}]'),
    ("llama_3x", '{"name": "get_weather", "parameters": {"city": "Lima"}}'),
    ("command_r7b", '<|START_THINKING|>think<|END_THINKING|>'
     '<|START_ACTION|>[{"tool_name": "f", "parameters": {"a": 1}}]'
     '<|END_ACTION|>'),
    ("deepseek_r1", "<think>chain of thought here</think>The answer is 4."),
    ("firefunction", 'functools[{"name": "a", "arguments": {"x": 1}}]'),
    ("generic", "Just a normal answer with no calls."),
    ("functionary_v3_2", 'all\nLet me check.>>>get_weather\n{"city": '
     '"Oslo"}>>>get_time\n{"tz": "CET"}'),
    ("functionary_v3_1", 'ok <function=add>{"a": 1, "b": 2}</function>'),
    ("llama_3x_builtin", "<|python_tag|>print(1+1)"),
]


@pytest.mark.parametrize("fmt,text", TOOL_TEXTS)
def test_toolcall_parsing_matches_jax(fmt, text):
    def fields(parse):
        """content, reasoning and the calls without their random ids"""
        calls = [{k: v for k, v in c.items() if k != "id"}
                 for c in parse_mod(parse).tool_calls_json(parse)]
        return parse.content, parse.reasoning, calls

    def parse_mod(parse):
        return p_tool if isinstance(parse, p_tool.ChatParse) else j_tool

    p = p_tool.parse_chat_output(text, fmt)
    j = j_tool.parse_chat_output(text, fmt)
    assert fields(p) == fields(j)


def test_toolcall_detection_and_prompts_match_jax():
    tools = [{"type": "function", "function": {
        "name": "get_weather", "description": "Weather of a city",
        "parameters": {"type": "object",
                       "properties": {"city": {"type": "string"}}}}}]
    for src in ["{% if x %}<tool_call>{% endif %}", "... [TOOL_CALLS] ...",
                "<|START_ACTION|>", "functools[", "<|python_tag|>... ipython",
                "plain template", None, "blah >>>all more",
                "<|start_header_id|> <function=", "<think>"]:
        fmt = p_tool.detect_format(src)
        assert fmt == j_tool.detect_format(src), src
        assert (p_tool.render_tools_prompt(tools, fmt)
                == j_tool.render_tools_prompt(tools, fmt)), fmt
