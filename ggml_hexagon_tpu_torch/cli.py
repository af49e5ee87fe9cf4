"""Command-line interface of the PyTorch/CUDA port: the reference's tool
suite as subcommands.

    python -m ggml_hexagon_tpu_torch.cli <subcommand> ... [--device cpu]

Counterpart of ggml_hexagon_tpu/cli.py, with its parser's flags and names
for every subcommand whose modules the port has (run `gen-docs` for the
flags):
  generate        <- llama-cli (main): sampling flags, --prompt-cache,
                     --cache-type, --lookahead/--lookup/--draft-model,
                     --on-device
  chat            <- simple-chat / llama-cli conversation mode
  perplexity      <- llama-perplexity: PPL, HellaSwag, Winogrande,
                     multiple choice
  imatrix         <- llama-imatrix; eval-callback <- eval-callback
  bench           <- llama-bench + batched-bench (-b parallel sweep)
  embedding / retrieval / passkey / infill / parallel / save-load-state
                  <- same-named
  gguf-info / gguf-hash / gguf-split / convert-legacy / convert-llama2c
                  <- gguf tools + converters
  gbnf-validator  <- gbnf-validator; tokenize <- llama-tokenize
  quantize        <- llama-quantize (+imatrix); quantize-stats
  gen-docs        <- gen-docs

The subcommands that run a model take --device (default cuda): with no
card they exit non-zero naming it, unless --device cpu asks for the plain
versions on the CPU.  Every model loads through the fused load pipeline
(the port's forward runs fused layers only).  The f32 parity modes of the
JAX CLI (GHT_COMPUTE_F32, GHT_PPL_F32) and an f32 KV cache run no kernel
contract the port has (K1 and K3 are int8 and bf16): those runs exit 2.
quantize and quantize-stats run on the host (the numpy encoders, and the
native library of quant/native for Q4_0, Q8_0, Q4_K and Q6_K).  Left out
until their modules are ported: finetune, export-lora, cvector-generator,
llava and tts.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: models loaded once a process: the "-m" value -> (cfg, weights, vocab,
#: metadata), fused and on their device (see preload)
_MODELS: dict = {}

#: environment switches of the JAX CLI's f32 parity runs, by subcommand
_F32_MODES = {"generate": "GHT_COMPUTE_F32", "perplexity": "GHT_PPL_F32"}

#: --cache-type -> the port's KV cache type (no f32 cache)
_CACHE_TYPES = {"f16": "bf16", "bf16": "bf16", "q8_0": "q8_0",
                "q4_0": "q4_0"}


class Refused(Exception):
    """A run the port cannot make (exit 2, the message on stderr)."""


def preload(name: str, cfg, weights, vocab, metadata: dict):
    """Serve `-m name` from a model already loaded in this process (fused,
    on its device) instead of reading a file: a caller that runs several
    subcommands in-process loads the model once (a GGUF held in a buffer
    loads this way too)."""
    _MODELS[str(name)] = (cfg, weights, vocab, dict(metadata))


def _device(args):
    from . import resolve_device

    return resolve_device(args.device)


def _model(path, device):
    """(cfg, weights, vocab, metadata) of `-m path`, fused, on device."""
    if str(path) in _MODELS:
        return _MODELS[str(path)]
    from .server.batch_engine import load_fused

    _MODELS[str(path)] = load_fused(path, device)
    return _MODELS[str(path)]


def _engine(path, device, **kw):
    from .runtime.engine import Engine

    cfg, weights, vocab, _ = _model(path, device)
    return Engine(cfg, weights, vocab, device=device, **kw)


def cmd_generate(args):
    from .runtime.device_sampling import DeviceSamplerParams
    from .runtime.sampling import make_chain

    if args.cache_type not in _CACHE_TYPES:
        raise Refused(f"--cache-type {args.cache_type}: the port's KV caches "
                      "are bf16, q8_0 and q4_0")
    dev = _device(args)
    eng = _engine(args.model, dev, max_seq=args.ctx_size,
                  kv_dtype=_CACHE_TYPES[args.cache_type])
    if args.prompt_tokens:
        ids = [int(t) for t in args.prompt_tokens.replace(",", " ").split()]
    elif args.prompt is None:
        print("error: --prompt required", file=sys.stderr)
        return 1
    elif eng.tokenizer is None:
        print("error: model has no tokenizer; use --prompt-tokens",
              file=sys.stderr)
        return 1
    else:
        ids = eng.tokenizer.encode(args.prompt)
    print(f"prompt tokens: {ids}", file=sys.stderr)
    if args.on_device:
        toks = list(eng.generate_ondevice(
            ids, n_predict=args.n_predict,
            params=DeviceSamplerParams(temp=args.temp, top_k=args.top_k,
                                       top_p=args.top_p, min_p=args.min_p),
            seed=args.seed))
    elif args.lookahead or args.lookup or args.draft_model:
        if args.draft_model:  # examples/speculative analog
            from .runtime.speculative import SpeculativeDecoder

            dec = SpeculativeDecoder(
                eng, _engine(args.draft_model, dev, max_seq=args.ctx_size))
            kind = "speculative"
        elif args.lookup:  # examples/lookup analog
            from .runtime.lookup import LookupDecoder

            dec = LookupDecoder(eng)
            kind = "lookup"
        else:  # examples/lookahead analog
            from .runtime.lookahead import LookaheadDecoder

            dec = LookaheadDecoder(eng)
            kind = "lookahead"
        toks = dec.generate(ids, n_predict=args.n_predict,
                            sampler=make_chain(temp=args.temp, seed=args.seed))
        print(f"[{kind}: {dec.stats.n_accepted}/{dec.stats.n_drafted} "
              f"drafted tokens accepted]", file=sys.stderr)
    else:
        chain = make_chain(temp=args.temp, top_k=args.top_k, top_p=args.top_p,
                           min_p=args.min_p, seed=args.seed,
                           penalty_repeat=args.repeat_penalty,
                           penalty_last_n=args.repeat_last_n)
        reuse = False
        if args.prompt_cache and os.path.exists(args.prompt_cache):
            # llama-cli --prompt-cache: restore the saved session and reuse
            # the longest matching prompt prefix (main.cpp:238-368)
            eng.load_state(args.prompt_cache)
            reuse = True
            print(f"restored prompt cache ({eng.n_past} tokens)",
                  file=sys.stderr)
        toks = []
        for t in eng.generate(ids, n_predict=args.n_predict, sampler=chain,
                              reuse_cache=reuse):
            toks.append(t)
            if args.stream:
                sys.stdout.write(eng.tokenizer.decode([t], skip_special=False)
                                 if eng.tokenizer else f"{t} ")
                sys.stdout.flush()
        if args.prompt_cache:
            eng.save_state(args.prompt_cache)
    if not args.stream:
        print(eng.tokenizer.decode(toks) if eng.tokenizer else
              " ".join(str(t) for t in toks))
    else:
        print()
    print(f"[{eng.perf.report()}]", file=sys.stderr)
    return 0


def cmd_eval_callback(args):
    """eval-callback analog: run one eval on the tap route, print every
    tapped tensor (examples/eval-callback/eval-callback.cpp)."""
    import torch

    from .models.llama import forward, init_kv_cache
    from .tokenizer import build_tokenizer

    dev = _device(args)
    cfg, weights, vocab, _ = _model(args.model, dev)
    ids = build_tokenizer(vocab).encode(args.prompt)
    taps = []

    def tap(name, x, **_kw):
        taps.append((name, x))

    kv = init_kv_cache(cfg, 1, max(len(ids), 8), "bf16", dev)
    forward(cfg, weights, torch.tensor([ids], dtype=torch.int64, device=dev),
            kv, 0, logits_all=True, tap=tap)
    seen = set()
    for name, x in taps:
        if name in seen:
            continue
        seen.add(name)
        a = x.to(torch.float32).reshape(-1).cpu().numpy()
        head = " ".join(f"{v:9.4f}" for v in a[: args.n_values])
        print(f"{name:36s} shape={tuple(x.shape)} "
              f"sum={a.sum():12.4f}  [{head} ...]")
    print(f"{len(seen)} tensors dumped")
    return 0


def cmd_embedding(args):
    """llama-embedding analog: pooled embeddings for one or more prompts."""
    from .runtime.embedding import extract_embeddings
    from .tokenizer import build_tokenizer

    dev = _device(args)
    cfg, weights, vocab, _ = _model(args.model, dev)
    tok = build_tokenizer(vocab)
    prompts = args.prompt if args.prompt else [sys.stdin.read()]
    ids = [tok.encode(p) for p in prompts]
    emb = extract_embeddings(cfg, weights, ids, pooling=args.pooling,
                             normalize=not args.no_normalize, device=dev)
    for row in emb:
        print(" ".join(f"{v:.6f}" for v in row[: args.n_print]) +
              (" ..." if len(row) > args.n_print else ""))
    return 0


def cmd_retrieval(args):
    """llama-retrieval analog: chunk files, embed, rank vs a query."""
    import numpy as np

    from .runtime.embedding import extract_embeddings
    from .tokenizer import build_tokenizer

    chunks = []
    for path in args.files:
        with open(path) as fh:
            text = fh.read()
        for seg in text.split(args.separator):
            seg = seg.strip()
            if len(seg) >= args.chunk_size:
                chunks.append((path, seg))
            elif seg and chunks and chunks[-1][0] == path:
                chunks[-1] = (path, chunks[-1][1] + args.separator + seg)
            elif seg:
                chunks.append((path, seg))
    dev = _device(args)
    cfg, weights, vocab, _ = _model(args.model, dev)
    tok = build_tokenizer(vocab)
    emb = extract_embeddings(cfg, weights, [tok.encode(c) for _, c in chunks],
                             pooling=args.pooling, device=dev)
    q = extract_embeddings(cfg, weights, [tok.encode(args.query)],
                           pooling=args.pooling, device=dev)[0]
    sims = emb @ q
    for i in np.argsort(-sims)[: args.top_k]:
        src, text = chunks[i]
        print(f"{sims[i]:.4f}  {src}: {text[:120]!r}")
    return 0


def cmd_passkey(args):
    """llama-passkey analog: long-context retrieval smoke test."""
    from .runtime.sampling import make_chain

    if args.grp_attn_n > 1:
        raise Refused("--grp-attn-n > 1 (self-extend) needs the forward's "
                      "cache_pos / write_pos and kv_ops.kv_rerotate, which "
                      "the port does not have yet")
    eng = _engine(args.model, _device(args), max_seq=args.ctx_size)
    junk = ("The grass is green. The sky is blue. The sun is yellow. "
            "Here we go. There and back again. ")
    key = str(args.passkey)
    pos = args.pos if args.pos >= 0 else args.n_junk // 2
    parts = [junk] * args.n_junk
    parts.insert(pos, f" The pass key is {key}. Remember it. {key} is the "
                      "pass key. ")
    prompt = ("There is an important info hidden inside a lot of irrelevant "
              "text. Find it and memorize it. " + "".join(parts) +
              " What is the pass key? The pass key is")
    ids = eng.tokenizer.encode(prompt)
    print(f"prompt: {len(ids)} tokens, key at junk index {pos}",
          file=sys.stderr)
    toks = list(eng.generate(ids, n_predict=args.n_predict,
                             sampler=make_chain(temp=0.0)))
    out = eng.tokenizer.decode(toks)
    ok = key in out
    print(f"response: {out.strip()!r}\npasskey {'FOUND' if ok else 'MISSING'}")
    return 0 if ok else 1


def greedy_continue(eng, last_tok, n):
    """n greedy tokens decoded one by one after feeding last_tok."""
    import numpy as np

    out = []
    logits = eng.decode_one(np.asarray([last_tok], np.int64))
    for _ in range(n):
        tok = int(np.argmax(logits[0]))
        out.append(tok)
        logits = eng.decode_one(np.asarray([tok], np.int64))
    return out


def cmd_save_load_state(args):
    """save-load-state analog: prove state round-trip determinism."""
    import numpy as np

    dev = _device(args)
    eng = _engine(args.model, dev, max_seq=args.ctx_size)
    ids = eng.tokenizer.encode(args.prompt)
    state = args.output or "state.bin"
    eng.prefill(np.asarray(ids[:-1], np.int64)[None, :])
    eng.save_state(state)  # the state holds the prompt prefix only
    first = greedy_continue(eng, ids[-1], args.n_predict)
    eng2 = _engine(args.model, dev, max_seq=args.ctx_size)
    eng2.load_state(state)  # resumes without re-running the prompt
    second = greedy_continue(eng2, ids[-1], args.n_predict)
    same = first == second
    print(f"first : {first}\nsecond: {second}\n"
          f"state round-trip {'OK' if same else 'MISMATCH'}")
    return 0 if same else 1


def cmd_infill(args):
    """llama-infill analog: fill-in-middle completion via FIM tokens."""
    from .runtime.infill import format_infill
    from .runtime.sampling import make_chain

    dev = _device(args)
    md = _model(args.model, dev)[3]
    eng = _engine(args.model, dev, max_seq=args.ctx_size)
    try:
        ids = format_infill(md, eng.tokenizer, args.in_prefix, args.in_suffix,
                            n_predict=args.n_predict, n_ctx=args.ctx_size)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    chain = make_chain(temp=args.temp, seed=args.seed)
    toks = list(eng.generate(ids, n_predict=args.n_predict, sampler=chain))
    print(args.in_prefix + eng.tokenizer.decode(toks) + args.in_suffix)
    return 0


def cmd_parallel(args):
    """llama-parallel analog (examples/parallel/parallel.cpp): N clients
    answering M sequences with continuous batching; per-client and
    aggregate throughput."""
    import numpy as np

    from .runtime.sampling import make_chain
    from .server.batch_engine import BatchEngine
    from .tokenizer import build_tokenizer

    pool = [
        "What is the meaning of life?",
        "Tell me an interesting fact about llamas.",
        "What is the best way to cook a steak?",
        "Are you familiar with the Special Theory of Relativity?",
        "Recommend some interesting books to read.",
        "What is the best way to learn a new language?",
    ]
    if args.file:
        with open(args.file) as fh:
            pool = [ln.strip() for ln in fh if ln.strip()]
    system = ("A chat between a curious user and an artificial intelligence "
              "assistant.\n\n")
    dev = _device(args)
    cfg, weights, vocab, md = _model(args.model, dev)
    eng = BatchEngine(cfg, weights, vocab, n_slots=args.parallel,
                      max_seq=args.ctx_size, device=dev)
    eng.metadata = md
    tok = build_tokenizer(eng.vocab)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    queues = []
    for i in range(args.sequences):
        q = pool[int(rng.integers(len(pool)))]
        ids = tok.encode(system + f"User: {q}\nAssistant:")
        queues.append((i, q, eng.submit(
            ids, n_predict=args.n_predict,
            sampler=make_chain(temp=args.temp, seed=args.seed + i))))
    eng.run_until_idle()
    n_gen = 0
    for i, q, outq in queues:
        n = 0
        while True:
            tokid, _ = outq.get(timeout=600)
            if tokid is None:
                break
            n += 1
        n_gen += n
        print(f"seq {i:3d} | prompt: {q[:40]:40s} | generated {n} tokens")
    dt = time.perf_counter() - t0
    m = eng.metrics
    print(f"\nn_parallel = {args.parallel}, n_sequences = {args.sequences}")
    print(f"prompt tokens: {m['n_prompt_tokens']}, "
          f"generated: {m['n_tokens_generated']}")
    print(f"total time: {dt:.2f} s, "
          f"throughput: {(m['n_prompt_tokens'] + n_gen) / dt:.2f} t/s")
    return 0


def cmd_convert_llama2c(args):
    from .gguf.llama2c import convert_llama2c

    out = convert_llama2c(args.model, args.vocab, args.output)
    print(f"wrote {out}")
    return 0


def cmd_gguf_split(args):
    from .gguf.split import merge_gguf, split_gguf

    if args.merge:
        out = merge_gguf(args.input, args.output)
        print(f"merged -> {out}")
    else:
        paths = split_gguf(args.input, args.output,
                           max_tensors=args.split_max_tensors)
        print("\n".join(paths))
    return 0


def cmd_gguf_hash(args):
    from .gguf.ghash import hash_gguf

    algos = [a for a, on in (("sha256", args.sha256 or not (args.sha1 or args.uuid)),
                             ("sha1", args.sha1), ("uuid", args.uuid)) if on]
    res = hash_gguf(args.model, algos)
    for algo in algos:
        if algo == "uuid":
            print(f"UUIDv5  {res['uuid']}  {args.model}")
            continue
        table = res[algo]
        for name in table:
            if name != "__model__":
                print(f"{algo}  {table[name]}  {args.model}:{name}")
        print(f"{algo}  {table['__model__']}  {args.model}")
    return 0


def cmd_gbnf_validator(args):
    """gbnf-validator analog: parse a grammar, check an input string."""
    from .runtime.grammar import GBNFParser

    try:
        with open(args.grammar) as fh:
            g = GBNFParser(fh.read()).parse()
    except Exception as e:  # noqa: BLE001 — any parse failure is reported
        print(f"grammar parse error: {e}", file=sys.stderr)
        return 1
    if args.input:
        with open(args.input) as fh:
            text = fh.read()
    else:
        text = sys.stdin.read()
    for i, ch in enumerate(text):
        if not g.accept_char(ord(ch)):
            print(f"input invalid at offset {i} (char {ch!r})")
            return 1
    if not g.can_end:
        print("input is a valid prefix but incomplete")
        return 1
    print("input valid")
    return 0


def cmd_perplexity(args):
    from .runtime import evaluate as ev
    from .tokenizer import build_tokenizer

    dev = _device(args)
    cfg, weights, vocab, _ = _model(args.model, dev)
    if args.file:
        with open(args.file) as fh:
            text = fh.read()
    else:
        text = sys.stdin.read()
    tok = build_tokenizer(vocab)
    if args.hellaswag:
        res = ev.hellaswag(cfg, weights, text, tok,
                           n_tasks=args.hellaswag_tasks, device=dev,
                           progress=lambda r: print(
                               f"{r.n_done}\t{100*r.acc:.8f}", file=sys.stderr))
        print(json.dumps({"hellaswag_acc": res.acc, "sigma": res.sigma,
                          "tasks": res.n_done}))
        return 0
    if args.winogrande:
        res = ev.winogrande(cfg, weights, text, tok,
                            n_tasks=args.winogrande_tasks, device=dev,
                            progress=lambda r: print(
                                f"{r.n_done}\t{100*r.acc:.4f}", file=sys.stderr))
        print(json.dumps({"winogrande_acc": res.acc, "sigma": res.sigma,
                          "tasks": res.n_done}))
        return 0
    if args.multiple_choice:
        res = ev.multiple_choice(cfg, weights, text, tok,
                                 n_tasks=args.multiple_choice_tasks,
                                 device=dev)
        print(json.dumps({"multiple_choice_acc": res.acc,
                          "sigma": res.sigma, "tasks": res.n_done}))
        return 0
    ids = tok.encode(text, add_bos=False)
    print(f"{len(ids)} tokens, n_ctx={args.ctx_size}", file=sys.stderr)

    def progress(i, n, ppl):
        print(f"[{i}/{n}] ppl={ppl:.4f}", file=sys.stderr)

    res = ev.perplexity(cfg, weights, ids, n_ctx=args.ctx_size,
                        bos_id=vocab.bos_id, progress=progress, device=dev)
    print(json.dumps({"ppl": res.ppl, "err": res.err, "tokens": res.nll_count}))
    return 0


def cmd_imatrix(args):
    from .runtime.evaluate import IMatrixCollector
    from .tokenizer import build_tokenizer

    dev = _device(args)
    cfg, weights, vocab, _ = _model(args.model, dev)
    with open(args.file) as fh:
        text = fh.read()
    ids = build_tokenizer(vocab).encode(text, add_bos=False)
    col = IMatrixCollector(cfg, weights, device=dev)
    n_ctx = args.ctx_size
    chunks = len(ids) // n_ctx
    for c in range(chunks):
        col.process_chunk(ids[c * n_ctx:(c + 1) * n_ctx])
        print(f"[{c+1}/{chunks}]", file=sys.stderr)
    col.save(args.output)
    print(f"wrote {args.output} ({len(col.sums)} tensors)")
    return 0


def cmd_quantize_stats(args):
    from .gguf import GGUFReader
    from .quant.stats import quantize_stats

    with GGUFReader.open(args.model) as r:
        rows = quantize_stats(r, args.type, include=args.include_layers,
                              exclude=args.exclude_layers,
                              per_layer=args.per_layer)
    for s in rows:
        print(f"{s.qtype:8s} {s.name:40s} rmse {s.rmse:.6f} "
              f"max {s.max_err:.6f} mean|e| {s.mean_abs:.6f}")
    return 0


def cmd_quantize(args):
    from .gguf import GGUFReader
    from .quant.policy import FTYPES, quantize_model
    from .runtime.evaluate import IMatrixCollector

    if args.ftype not in FTYPES:
        print(f"unknown ftype {args.ftype}; choices: {sorted(FTYPES)}", file=sys.stderr)
        return 1
    imatrix = IMatrixCollector.load(args.imatrix) if args.imatrix else None

    def progress(name, ttype):
        print(f"  {name} -> {ttype.name}", file=sys.stderr)

    with GGUFReader.open(args.input) as r:
        quantize_model(r, args.output, args.ftype, imatrix=imatrix, progress=progress)
    print(f"wrote {args.output}")
    return 0


def cmd_tokenize(args):
    from .gguf.reader import GGUFReader
    from .tokenizer import Vocab, build_tokenizer

    with GGUFReader.open(args.model) as r:
        vocab = Vocab.from_gguf(r.metadata)
    tok = build_tokenizer(vocab)
    # llama-tokenize parses control tokens unless --no-parse-special
    # (examples/tokenize/tokenize.cpp:372)
    ids = tok.encode(args.text, parse_special=not args.no_parse_special)
    for i in ids:
        print(f"{i:7d} -> {vocab.tokens[i]!r}")
    return 0


def cmd_gguf_info(args):
    from .gguf.reader import GGUFReader

    with GGUFReader.open(args.model) as r:
        print(f"version: {r.version}  alignment: {r.alignment}")
        print(f"metadata ({len(r.metadata)}):")
        for k, v in r.metadata.items():
            s = repr(v)
            print(f"  {k} = {s[:80]}{'...' if len(s) > 80 else ''}")
        print(f"tensors ({len(r.tensors)}):")
        total = 0
        for t in r.tensors.values():
            total += t.n_bytes
            print(f"  {t.name:40s} {t.ggml_type.name:6s} ne={list(t.ne)} {t.n_bytes/1e6:.2f} MB")
        print(f"total tensor bytes: {total/1e9:.3f} GB")
    return 0


def cmd_bench(args):
    """llama-bench-style sweep: pp / tg rows (and batched pp+tg@pl rows)
    of each model, t/s on the host clock around work that ends in a
    device synchronisation."""
    import numpy as np

    from .runtime.engine import Engine

    dev = _device(args)
    rows = []
    for m in args.model:
        cfg, weights, vocab, _ = _model(m, dev)
        eng = Engine(cfg, weights, vocab, device=dev,
                     max_seq=max(args.n_prompt) + max(args.n_gen) + 8)
        rng = np.random.default_rng(0)
        for pp in args.n_prompt:
            eng.reset()
            ids = rng.integers(3, eng.cfg.n_vocab - 1, size=pp)
            eng.prefill(ids[None, :])  # warm-up
            eng.reset()
            t0 = time.perf_counter()
            eng.prefill(ids[None, :])
            dt = time.perf_counter() - t0
            rows.append({"model": m, "test": f"pp{pp}", "t/s": round(pp / dt, 2)})
        for tg in args.n_gen:
            eng.reset()
            eng.generate_ondevice([1, 2, 3], n_predict=tg, stop_at_eos=False)
            eng.reset()
            t0 = time.perf_counter()
            eng.generate_ondevice([1, 2, 3], n_predict=tg, stop_at_eos=False)
            dt = time.perf_counter() - t0
            rows.append({"model": m, "test": f"tg{tg}", "t/s": round(tg / dt, 2)})
        # batched-bench analog: parallel-sequence throughput sweep
        # (examples/batched-bench: PP/TG/PL matrix, total t/s)
        for pl in args.batch or []:
            if pl == 1:
                continue
            pp, tg = min(args.n_prompt), min(args.n_gen)
            beng = Engine(cfg, weights, vocab, device=dev,
                          max_seq=pp + tg + 8, batch=pl)
            prompts = rng.integers(3, beng.cfg.n_vocab - 1, size=(pl, pp))

            def run_batched():
                beng.reset()
                logits = beng.prefill(prompts)
                toks = np.argmax(logits, axis=-1)
                for _ in range(tg):
                    logits = beng.decode_one(toks)
                    toks = np.argmax(logits, axis=-1)

            run_batched()  # warm-up
            t0 = time.perf_counter()
            run_batched()
            dt = time.perf_counter() - t0
            rows.append({"model": m, "test": f"pp{pp}+tg{tg}@pl{pl}",
                         "t/s": round(pl * (pp + tg) / dt, 2)})
    if args.output == "json":
        print(json.dumps(rows, indent=2))
    else:  # markdown
        print("| model | test | t/s |")
        print("| --- | --- | --- |")
        for r in rows:
            print(f"| {r['model']} | {r['test']} | {r['t/s']} |")
    return 0


def cmd_chat(args):
    """simple-chat / llama-cli conversation-mode analog: a stdin REPL that
    applies the model's chat template per turn and reuses the KV prefix."""
    from .runtime.chat import apply_chat_template, template_from_gguf
    from .runtime.sampling import make_chain

    dev = _device(args)
    tmpl, tmpl_src = template_from_gguf(_model(args.model, dev)[3])
    eng = _engine(args.model, dev, max_seq=args.ctx_size)
    messages = []
    if args.system:
        messages.append({"role": "system", "content": args.system})
    print("chat started; empty line or EOF exits", file=sys.stderr)
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        if not line.strip():
            break
        messages.append({"role": "user", "content": line})
        prompt = apply_chat_template(messages, tmpl, add_assistant=True,
                                     jinja_source=tmpl_src)
        ids = eng.tokenizer.encode(prompt)
        chain = make_chain(temp=args.temp, seed=args.seed)
        toks = []
        # longest-prefix KV reuse across turns (server prompt-cache style)
        for t in eng.generate(ids, n_predict=args.n_predict, sampler=chain,
                              reuse_cache=True):
            toks.append(t)
            sys.stdout.write(eng.tokenizer.decode([t], skip_special=False))
            sys.stdout.flush()
        print()
        messages.append({"role": "assistant",
                         "content": eng.tokenizer.decode(toks)})
    return 0


def cmd_convert_legacy(args):
    """convert_llama_ggml_to_gguf analog: pre-GGUF llama files -> GGUF."""
    from .gguf.legacy import convert_ggml_to_gguf

    print(convert_ggml_to_gguf(args.input, args.output))
    return 0


def cmd_gen_docs(args):
    """gen-docs analog: emit markdown docs for every subcommand."""
    p = build_parser()
    sub_actions = [a for a in p._actions
                   if isinstance(a, argparse._SubParsersAction)]
    lines = ["# CLI reference", "",
             "Generated by `gen-docs` (the reference's examples/gen-docs "
             "analog).", ""]
    for name, sp in sorted(sub_actions[0].choices.items()):
        lines.append(f"## {name}")
        lines.append("")
        lines.append("```")
        lines.append(sp.format_help().rstrip())
        lines.append("```")
        lines.append("")
    text = "\n".join(lines)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _add_device(sp):
    sp.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels on the card) or "
                         "cpu (the plain versions)")


def build_parser():
    p = argparse.ArgumentParser(prog="ggml_hexagon_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="generate text from a prompt")
    g.add_argument("-m", "--model", required=True)
    g.add_argument("-p", "--prompt")
    g.add_argument("--prompt-tokens", help="raw token ids, e.g. '1,2,3'")
    g.add_argument("-n", "--n-predict", type=int, default=64)
    g.add_argument("-c", "--ctx-size", type=int, default=2048)
    g.add_argument("--temp", type=float, default=0.8)
    g.add_argument("--top-k", type=int, default=40)
    g.add_argument("--top-p", type=float, default=0.95)
    g.add_argument("--min-p", type=float, default=0.05)
    g.add_argument("--repeat-penalty", type=float, default=1.0)
    g.add_argument("--repeat-last-n", type=int, default=64)
    g.add_argument("-s", "--seed", type=int, default=42)
    g.add_argument("--stream", action="store_true")
    g.add_argument("--lookahead", action="store_true",
                   help="Jacobi lookahead decoding (no draft model)")
    g.add_argument("--lookup", action="store_true",
                   help="n-gram lookup decoding (no draft model)")
    g.add_argument("--prompt-cache",
                   help="session file: save/restore KV across runs")
    g.add_argument("-ct", "--cache-type", default="bf16",
                   choices=["f32", "f16", "bf16", "q8_0", "q4_0"],
                   help="KV cache dtype (type_k/type_v analog; f32 is "
                        "refused: the port's caches are bf16, q8_0, q4_0)")
    g.add_argument("-md", "--draft-model",
                   help="draft model GGUF for speculative decoding")
    g.add_argument("--on-device", action="store_true",
                   help="device-side decode loop (no per-token host sync)")
    _add_device(g)
    g.set_defaults(fn=cmd_generate)

    ec = sub.add_parser("eval-callback",
                        help="dump every tapped tensor for one eval")
    ec.add_argument("-m", "--model", required=True)
    ec.add_argument("-p", "--prompt", default="hello world")
    ec.add_argument("--n-values", type=int, default=4)
    _add_device(ec)
    ec.set_defaults(fn=cmd_eval_callback)

    em = sub.add_parser("embedding", help="pooled prompt embeddings")
    em.add_argument("-m", "--model", required=True)
    em.add_argument("-p", "--prompt", action="append")
    em.add_argument("--pooling", default="mean",
                    choices=["mean", "cls", "last", "none"])
    em.add_argument("--no-normalize", action="store_true")
    em.add_argument("--n-print", type=int, default=8)
    _add_device(em)
    em.set_defaults(fn=cmd_embedding)

    rt = sub.add_parser("retrieval", help="embed file chunks, rank vs query")
    rt.add_argument("-m", "--model", required=True)
    rt.add_argument("--files", nargs="+", required=True)
    rt.add_argument("--query", required=True)
    rt.add_argument("--chunk-size", type=int, default=64)
    rt.add_argument("--separator", default="\n")
    rt.add_argument("--top-k", type=int, default=3)
    rt.add_argument("--pooling", default="mean")
    _add_device(rt)
    rt.set_defaults(fn=cmd_retrieval)

    pk = sub.add_parser("passkey", help="long-context retrieval smoke test")
    pk.add_argument("-m", "--model", required=True)
    pk.add_argument("--n-junk", type=int, default=250)
    pk.add_argument("--passkey", type=int, default=42)
    pk.add_argument("--pos", type=int, default=-1)
    pk.add_argument("-n", "--n-predict", type=int, default=16)
    pk.add_argument("-c", "--ctx-size", type=int, default=8192)
    pk.add_argument("--grp-attn-n", type=int, default=1,
                    help="self-extend group factor (main.cpp --grp-attn-n; "
                         "values above 1 are refused)")
    pk.add_argument("--grp-attn-w", type=int, default=512,
                    help="self-extend window (main.cpp --grp-attn-w)")
    _add_device(pk)
    pk.set_defaults(fn=cmd_passkey)

    sl = sub.add_parser("save-load-state", help="state round-trip check")
    sl.add_argument("-m", "--model", required=True)
    sl.add_argument("-p", "--prompt", default="The quick brown fox")
    sl.add_argument("-n", "--n-predict", type=int, default=8)
    sl.add_argument("-c", "--ctx-size", type=int, default=512)
    sl.add_argument("-o", "--output")
    _add_device(sl)
    sl.set_defaults(fn=cmd_save_load_state)

    inf = sub.add_parser("infill", help="fill-in-middle completion")
    inf.add_argument("-m", "--model", required=True)
    inf.add_argument("--in-prefix", required=True)
    inf.add_argument("--in-suffix", required=True)
    inf.add_argument("-n", "--n-predict", type=int, default=32)
    inf.add_argument("-c", "--ctx-size", type=int, default=2048)
    inf.add_argument("--temp", type=float, default=0.0)
    inf.add_argument("--seed", type=int, default=0)
    _add_device(inf)
    inf.set_defaults(fn=cmd_infill)

    gs = sub.add_parser("gguf-split", help="shard or merge GGUF files")
    gs.add_argument("input")
    gs.add_argument("output")
    gs.add_argument("--merge", action="store_true")
    gs.add_argument("--split-max-tensors", type=int, default=128)
    gs.set_defaults(fn=cmd_gguf_split)

    gh = sub.add_parser("gguf-hash", help="per-tensor + model digests")
    gh.add_argument("model")
    gh.add_argument("--sha256", action="store_true")
    gh.add_argument("--sha1", action="store_true")
    gh.add_argument("--uuid", action="store_true")
    gh.set_defaults(fn=cmd_gguf_hash)

    qs = sub.add_parser("quantize-stats", help="round-trip error per qtype")
    qs.add_argument("-m", "--model", required=True)
    qs.add_argument("--type", action="append", required=True,
                    help="quant type name (repeatable), e.g. Q4_K")
    qs.add_argument("-l", "--include-layers")
    qs.add_argument("-L", "--exclude-layers")
    qs.add_argument("--per-layer", action="store_true")
    qs.set_defaults(fn=cmd_quantize_stats)

    q = sub.add_parser("quantize", help="quantize a GGUF model")
    q.add_argument("input")
    q.add_argument("output")
    q.add_argument("ftype")
    q.add_argument("--imatrix")
    q.set_defaults(fn=cmd_quantize)

    gv = sub.add_parser("gbnf-validator", help="validate input vs a grammar")
    gv.add_argument("grammar")
    gv.add_argument("input", nargs="?")
    gv.set_defaults(fn=cmd_gbnf_validator)

    pp = sub.add_parser("perplexity",
                        help="perplexity / benchmark scoring over a file")
    pp.add_argument("-m", "--model", required=True)
    pp.add_argument("-f", "--file")
    pp.add_argument("-c", "--ctx-size", type=int, default=512)
    pp.add_argument("--hellaswag", action="store_true",
                    help="score HellaSwag acc_norm (6-line-per-task file)")
    pp.add_argument("--hellaswag-tasks", type=int, default=400)
    pp.add_argument("--winogrande", action="store_true",
                    help="score Winogrande (CSV tasks file)")
    pp.add_argument("--winogrande-tasks", type=int, default=None)
    pp.add_argument("--multiple-choice", action="store_true",
                    help="score multiple-choice JSON tasks (MMLU-class)")
    pp.add_argument("--multiple-choice-tasks", type=int, default=None)
    _add_device(pp)
    pp.set_defaults(fn=cmd_perplexity)

    im = sub.add_parser("imatrix", help="collect importance matrix")
    im.add_argument("-m", "--model", required=True)
    im.add_argument("-f", "--file", required=True)
    im.add_argument("-o", "--output", default="imatrix.npz")
    im.add_argument("-c", "--ctx-size", type=int, default=512)
    _add_device(im)
    im.set_defaults(fn=cmd_imatrix)

    tk = sub.add_parser("tokenize", help="tokenize text")
    tk.add_argument("-m", "--model", required=True)
    tk.add_argument("--no-parse-special", action="store_true",
                    help="do not parse control tokens")
    tk.add_argument("text")
    tk.set_defaults(fn=cmd_tokenize)

    gi = sub.add_parser("gguf-info", help="inspect a GGUF file")
    gi.add_argument("model")
    gi.set_defaults(fn=cmd_gguf_info)

    b = sub.add_parser("bench", help="pp/tg throughput sweep")
    b.add_argument("-m", "--model", action="append", required=True)
    b.add_argument("-p", "--n-prompt", type=int, nargs="+", default=[512])
    b.add_argument("-n", "--n-gen", type=int, nargs="+", default=[128])
    b.add_argument("-b", "--batch", type=int, nargs="+", default=[],
                   help="parallel-sequence counts (batched-bench analog)")
    b.add_argument("-o", "--output", choices=["json", "md"], default="md")
    _add_device(b)
    b.set_defaults(fn=cmd_bench)

    gd = sub.add_parser("gen-docs", help="emit markdown CLI docs")
    gd.add_argument("-o", "--output")
    gd.set_defaults(fn=cmd_gen_docs)

    ch = sub.add_parser("chat", help="interactive chat REPL")
    ch.add_argument("-m", "--model", required=True)
    ch.add_argument("--system", help="system prompt")
    ch.add_argument("-n", "--n-predict", type=int, default=256)
    ch.add_argument("-c", "--ctx-size", type=int, default=4096)
    ch.add_argument("--temp", type=float, default=0.8)
    ch.add_argument("-s", "--seed", type=int, default=42)
    _add_device(ch)
    ch.set_defaults(fn=cmd_chat)

    cl = sub.add_parser("convert-legacy",
                        help="legacy GGML/GGMF/GGJT file -> GGUF")
    cl.add_argument("input")
    cl.add_argument("output")
    cl.set_defaults(fn=cmd_convert_legacy)

    pa = sub.add_parser("parallel",
                        help="multi-client continuous-batching simulation")
    pa.add_argument("-m", "--model", required=True)
    pa.add_argument("-np", "--parallel", type=int, default=4,
                    help="number of slots (clients)")
    pa.add_argument("-ns", "--sequences", type=int, default=8,
                    help="total sequences to process")
    pa.add_argument("-n", "--n-predict", type=int, default=32)
    pa.add_argument("-c", "--ctx-size", type=int, default=1024)
    pa.add_argument("-f", "--file", help="newline-separated prompt pool")
    pa.add_argument("--temp", type=float, default=0.8)
    pa.add_argument("-s", "--seed", type=int, default=42)
    _add_device(pa)
    pa.set_defaults(fn=cmd_parallel)

    c2c = sub.add_parser("convert-llama2c",
                         help="llama2.c checkpoint + vocab -> GGUF")
    c2c.add_argument("--model", required=True, help="llama2.c model.bin")
    c2c.add_argument("--vocab", required=True,
                     help="tokenizer.bin or GGUF vocab file")
    c2c.add_argument("-o", "--output", required=True)
    c2c.set_defaults(fn=cmd_convert_llama2c)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    env = _F32_MODES.get(args.cmd)
    try:
        if env and os.environ.get(env):
            raise Refused(f"{env} asks for f32 compute, which no kernel of "
                          "the port runs (K1 and K3 are int8 and bf16)")
        if getattr(args, "device", None) is not None:
            try:
                _device(args)
            except RuntimeError:
                print(f"error: no CUDA card for --device {args.device}; pass "
                      "--device cpu to run the plain versions on the CPU",
                      file=sys.stderr)
                return 1
        return args.fn(args)
    except Refused as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
