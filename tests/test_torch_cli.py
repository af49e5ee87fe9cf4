"""The port's command-line tools (ggml_hexagon_tpu_torch/cli.py).

Each ported subcommand runs through `main([..., "--device", "cpu"])` on
the 2-layer Llama GGUF of tests/_torch_gguf_model.py (with FIM token ids in
its metadata, for infill), and what it prints or writes is held to the
port's library calls on the same weights (the CLI's floats are never held
against the JAX CLI's: the JAX package on the CPU runs exact dequant where
the port runs its kernel contract); the host tools (gguf-info, tokenize,
gguf-hash, gguf-split, gbnf-validator) print and write byte for byte what
the JAX CLI does, and the converters (convert-llama2c, convert-legacy)
write byte-equal files on in-process inputs; gen-docs lists exactly the
ported subcommands; the f32 parity modes, an f32 cache and self-extend are
refused with exit 2, and without a card a model subcommand exits 1 naming
it unless --device cpu asks for the CPU.
"""
import json
import struct

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread)
from _torch_gguf_model import write_model
from ggml_hexagon_tpu import cli as jcli
from ggml_hexagon_tpu_torch import cli
from ggml_hexagon_tpu_torch.runtime import evaluate as PE
from ggml_hexagon_tpu_torch.runtime.embedding import extract_embeddings
from ggml_hexagon_tpu_torch.runtime.engine import Engine
from ggml_hexagon_tpu_torch.runtime.lookup import LookupDecoder
from ggml_hexagon_tpu_torch.runtime.sampling import make_chain
from ggml_hexagon_tpu_torch.server.batch_engine import load_fused
from ggml_hexagon_tpu_torch.tokenizer import build_tokenizer

CPU = ["--device", "cpu"]
PROMPT = "hello world the model"
WORDS = ("hello", "world", "the", "model")  # one SPM token each
PORTED = sorted([
    "generate", "chat", "infill", "parallel", "passkey", "save-load-state",
    "perplexity", "imatrix", "eval-callback", "embedding", "retrieval",
    "tokenize", "gguf-info", "gguf-hash", "gguf-split", "gbnf-validator",
    "convert-llama2c", "convert-legacy", "bench", "gen-docs", "quantize",
    "quantize-stats"])
LEFT_OUT = ("finetune", "export-lora", "cvector-generator", "llava", "tts")


def text(seed, n):
    rng = np.random.default_rng(seed)
    return " ".join(WORDS[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    path = tmp / "tiny-q4_k_m.gguf"
    write_model(path, extra_metadata={
        "tokenizer.ggml.fim_pre_token_id": 3,
        "tokenizer.ggml.fim_suf_token_id": 4,
        "tokenizer.ggml.fim_mid_token_id": 5})
    cfg, weights, vocab, md = load_fused(path, torch.device("cpu"))
    return {"path": str(path), "tmp": tmp, "cfg": cfg, "weights": weights,
            "vocab": vocab, "md": md, "tok": build_tokenizer(vocab)}


def run(capsys, argv, rc=0):
    got = cli.main(argv)
    out = capsys.readouterr()
    assert got == rc, out.err
    return out.out, out.err


def engine(model, **kw):
    return Engine(model["cfg"], model["weights"], model["vocab"],
                  device="cpu", **kw)


def greedy(model, ids, n, **kw):
    eng = engine(model, max_seq=64, **kw)
    return eng, list(eng.generate(ids, n, sampler=make_chain(temp=0.0),
                                  stop_ids={eng.vocab.eos_id}))


@pytest.mark.parametrize("extra,kv", [
    ([], "bf16"), (["--on-device"], "bf16"), (["--lookup"], "bf16"),
    (["--lookahead"], "bf16"), (["-md", None], "bf16"),
    (["--cache-type", "q8_0"], "q8_0"), (["--cache-type", "q4_0"], "q4_0"),
    (["--cache-type", "f16"], "bf16")])
def test_generate_prints_the_library_tokens(model, capsys, extra, kv):
    """Greedy: the plain chain, the device sampler, lookup, lookahead and a
    draft model print the Engine's greedy text (a speculative route's
    tokens the Engine's on this model, held in test_torch_speculative.py)."""
    extra = [model["path"] if a is None else a for a in extra]
    out, err = run(capsys, ["generate", "-m", model["path"], "-p", PROMPT,
                            "-n", "6", "--temp", "0", "-c", "64", *extra,
                            *CPU])
    eng, toks = greedy(model, model["tok"].encode(PROMPT), 6, kv_dtype=kv)
    assert out == eng.tokenizer.decode(toks) + "\n"
    assert "prompt tokens: [1, 269, 279, 285, 295]" in err
    if "--lookup" in extra:
        assert "[lookup: " in err


def test_generate_prompt_cache_reuses_the_state(model, capsys, tmp_path):
    cache = str(tmp_path / "session.bin")
    argv = ["generate", "-m", model["path"], "-p", PROMPT, "-n", "4",
            "--temp", "0", "-c", "64", "--prompt-cache", cache, *CPU]
    first, _ = run(capsys, argv)
    e = engine(model, max_seq=64)
    e.load_state(cache)
    assert e.n_past == 5 + 4 and e.cached_tokens[:5] == [1, 269, 279, 285, 295]
    ids = model["tok"].encode(PROMPT)
    want = e.tokenizer.decode(list(e.generate(
        ids, 4, sampler=make_chain(temp=0.0), reuse_cache=True))) + "\n"
    second, err = run(capsys, argv)
    assert "restored prompt cache (9 tokens)" in err
    # the reused run prefills the last prompt token alone (K1) where the
    # first prefilled all five: it prints the library's reuse run's text
    assert second == want
    assert "prefill 1 tok" in err  # all but one prompt token reused


def test_save_load_state(model, capsys, tmp_path):
    out, _ = run(capsys, ["save-load-state", "-m", model["path"], "-p",
                          PROMPT, "-n", "4", "-c", "64", "-o",
                          str(tmp_path / "s.bin"), *CPU])
    assert out.endswith("state round-trip OK\n")
    first = json.loads(out.splitlines()[0].split(":", 1)[1])
    ids = model["tok"].encode(PROMPT)
    eng = engine(model, max_seq=64)
    eng.prefill(np.asarray([ids[:-1]]))
    assert first == cli.greedy_continue(eng, ids[-1], 4)


def test_perplexity_prints_the_library_value(model, capsys, tmp_path):
    f = tmp_path / "corpus.txt"
    f.write_text(text(1, 40))
    out, err = run(capsys, ["perplexity", "-m", model["path"], "-f", str(f),
                            "-c", "16", *CPU])
    ids = model["tok"].encode(text(1, 40), add_bos=False)
    want = PE.perplexity(model["cfg"], model["weights"], ids, n_ctx=16,
                         bos_id=model["vocab"].bos_id, device="cpu")
    assert json.loads(out) == {"ppl": want.ppl, "err": want.err,
                               "tokens": want.nll_count}
    assert "[2/2] ppl=" in err


def test_choice_benchmarks_print_the_library_scores(model, capsys, tmp_path):
    hs = "\n".join(line for t in range(2) for line in
                   [text(10 + t, 9), str(t)] + [text(20 + 4 * t + j, 2)
                                                for j in range(4)])
    wg = "\n".join(f"{i},{text(30 + i, 4)} _ {text(40 + i, 4)},hello,the,"
                   f"{1 + i}" for i in range(2))
    mc = json.dumps([{"question": text(50, 8), "answers": [text(60 + j, 2)
                                                           for j in range(3)],
                      "label": 1}])
    m = model
    for flag, body, fn, key in (
            ("--hellaswag", hs, PE.hellaswag, "hellaswag_acc"),
            ("--winogrande", wg, PE.winogrande, "winogrande_acc"),
            ("--multiple-choice", mc, PE.multiple_choice,
             "multiple_choice_acc")):
        f = tmp_path / "tasks.txt"
        f.write_text(body)
        out, _ = run(capsys, ["perplexity", "-m", m["path"], "-f", str(f),
                              flag, *CPU])
        res = fn(m["cfg"], m["weights"], body, m["tok"], device="cpu")
        assert json.loads(out) == {key: res.acc, "sigma": res.sigma,
                                   "tasks": res.n_done}
        assert res.n_done == (2 if flag != "--multiple-choice" else 1)


def test_imatrix_writes_the_library_collector(model, capsys, tmp_path):
    f = tmp_path / "corpus.txt"
    f.write_text(text(2, 40))
    o = str(tmp_path / "imatrix.npz")
    out, _ = run(capsys, ["imatrix", "-m", model["path"], "-f", str(f), "-o",
                          o, "-c", "16", *CPU])
    assert out == f"wrote {o} (15 tensors)\n"
    ids = model["tok"].encode(text(2, 40), add_bos=False)
    col = PE.IMatrixCollector(model["cfg"], model["weights"], device="cpu")
    for c in range(len(ids) // 16):
        col.process_chunk(ids[c * 16:(c + 1) * 16])
    z = np.load(o)
    for name, v in col.result().items():
        assert np.array_equal(z[name], v)
        assert int(z[f"__count__{name}"]) == 16 * (len(ids) // 16)


def test_eval_callback_prints_every_tap(model, capsys):
    out, _ = run(capsys, ["eval-callback", "-m", model["path"], "-p", PROMPT,
                          *CPU])
    lines = out.splitlines()
    names = [ln.split()[0] for ln in lines[:-1]]
    want = [f"blk.{il}.{n}" for il in range(2) for n in (
        "attn_q.weight", "attn_k.weight", "attn_v.weight",
        "attn_output.weight", "ffn_gate.weight", "ffn_up.weight",
        "ffn_down.weight", "l_out")] + ["output.weight"]
    assert names == want and lines[-1] == "17 tensors dumped"
    assert "shape=(1, 5, 1024)" in lines[0] and "shape=(1, 5, 512)" in lines[6]


def test_embedding_and_retrieval_print_the_library_rows(model, capsys,
                                                        tmp_path):
    m = model
    out, _ = run(capsys, ["embedding", "-m", m["path"], "-p", "hello world",
                          "-p", "the model", "--n-print", "4", *CPU])
    emb = extract_embeddings(m["cfg"], m["weights"],
                             [m["tok"].encode(p) for p in ("hello world",
                                                           "the model")],
                             device="cpu")
    assert out == "".join(" ".join(f"{v:.6f}" for v in row[:4]) + " ...\n"
                          for row in emb)
    doc = tmp_path / "doc.txt"
    doc.write_text("\n".join(text(70 + i, 6) for i in range(4)))
    out, _ = run(capsys, ["retrieval", "-m", m["path"], "--files", str(doc),
                          "--query", "hello world", "--chunk-size", "8",
                          "--top-k", "2", *CPU])
    chunks = [s.strip() for s in doc.read_text().split("\n")]
    e = extract_embeddings(m["cfg"], m["weights"],
                           [m["tok"].encode(c) for c in chunks], device="cpu")
    q = extract_embeddings(m["cfg"], m["weights"],
                           [m["tok"].encode("hello world")], device="cpu")[0]
    sims = e @ q
    assert out == "".join(f"{sims[i]:.4f}  {doc}: {chunks[i]!r}\n"
                          for i in np.argsort(-sims)[:2])


def test_passkey_infill_parallel_chat_bench(model, capsys, monkeypatch):
    m = model
    rc = cli.main(["passkey", "-m", m["path"], "--n-junk", "1", "-n", "4",
                   "-c", "512", *CPU])
    out = capsys.readouterr().out
    assert rc in (0, 1) and out.splitlines()[-1].startswith("passkey ")
    out, _ = run(capsys, ["infill", "-m", m["path"], "--in-prefix", "hello ",
                          "--in-suffix", " model", "-n", "3", "-c", "64",
                          *CPU])
    assert out.startswith("hello ") and out.endswith(" model\n")
    out, _ = run(capsys, ["parallel", "-m", m["path"], "-np", "2", "-ns", "3",
                          "-n", "3", "-c", "128", "--temp", "0", *CPU])
    assert sum(ln.startswith("seq ") for ln in out.splitlines()) == 3
    assert "n_parallel = 2, n_sequences = 3" in out
    lines = iter(["hello world", ""])
    monkeypatch.setattr("builtins.input", lambda _p="": next(lines))
    out, _ = run(capsys, ["chat", "-m", m["path"], "-n", "3", "-c", "128",
                          "--temp", "0", *CPU])
    assert out.count("\n") == 1
    out, _ = run(capsys, ["bench", "-m", m["path"], "-p", "16", "-n", "4",
                          "-b", "2", *CPU])
    rows = out.splitlines()
    assert rows[:2] == ["| model | test | t/s |", "| --- | --- | --- |"]
    assert [r.split(" | ")[1] for r in rows[2:]] == ["pp16", "tg4",
                                                      "pp16+tg4@pl2"]


# -- the host tools, byte for byte against the JAX CLI ------------------------


def _both(capsys, argv):
    """(the port's stdout, the JAX CLI's) for argv."""
    rp = cli.main(argv)
    mine = capsys.readouterr().out
    rj = jcli.main(argv)
    theirs = capsys.readouterr().out
    assert rp == rj
    return mine, theirs


@pytest.mark.parametrize("argv", [
    ["gguf-info", "{m}"], ["tokenize", "-m", "{m}", "hello world <s>"],
    ["tokenize", "-m", "{m}", "--no-parse-special", "hello <s>"],
    ["gguf-hash", "{m}"], ["gguf-hash", "{m}", "--sha1", "--uuid"]])
def test_host_tools_print_what_the_jax_cli_prints(model, capsys, argv):
    argv = [a.format(m=model["path"]) for a in argv]
    mine, theirs = _both(capsys, argv)
    assert mine == theirs and mine


def test_gguf_split_and_merge_are_byte_equal(model, capsys, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    rp = cli.main(["gguf-split", model["path"], str(tmp_path / "p" / "m"),
                   "--split-max-tensors", "8"])
    mine = capsys.readouterr().out
    rj = jcli.main(["gguf-split", model["path"], str(tmp_path / "j" / "m"),
                    "--split-max-tensors", "8"])
    theirs = capsys.readouterr().out
    assert rp == rj == 0
    assert mine.replace("/p/", "/j/") == theirs
    shards = mine.split()
    assert len(shards) == 3
    for s in shards:
        assert (open(s, "rb").read()
                == open(s.replace("/p/", "/j/"), "rb").read())
    run(capsys, ["gguf-split", "--merge", shards[0],
                 str(tmp_path / "merged.gguf")])
    jcli.main(["gguf-split", "--merge", shards[0].replace("/p/", "/j/"),
               str(tmp_path / "jmerged.gguf")])
    capsys.readouterr()
    merged = (tmp_path / "merged.gguf").read_bytes()
    assert merged == (tmp_path / "jmerged.gguf").read_bytes()
    assert merged == open(model["path"], "rb").read()


@pytest.mark.parametrize("grammar,inp", [
    ('root ::= "a" [0-9]+ "z"', "a123z"), ('root ::= "a" [0-9]+ "z"', "a12"),
    ('root ::= "a" [0-9]+ "z"', "ab"), ("root ::= ", "x")])
def test_gbnf_validator_matches_jax(capsys, tmp_path, grammar, inp):
    g, i = tmp_path / "g.gbnf", tmp_path / "in.txt"
    g.write_text(grammar)
    i.write_text(inp)
    rp = cli.main(["gbnf-validator", str(g), str(i)])
    mine = capsys.readouterr()
    rj = jcli.main(["gbnf-validator", str(g), str(i)])
    theirs = capsys.readouterr()
    assert rp == rj and mine.out == theirs.out
    assert (mine.err == "") == (theirs.err == "")


def _llama2c_files(tmp):
    """A 2-layer llama2.c checkpoint (separate classifier) and a karpathy
    tokenizer.bin, written as tests/test_llama2c.py writes them."""
    rng = np.random.default_rng(7)
    dim, hidden, L, H, V, seq = 64, 128, 2, 4, 300, 32
    ck = tmp / "model.bin"
    with open(ck, "wb") as f:
        f.write(struct.pack("<7i", dim, hidden, L, H, H, -V, seq))
        for shape in ((V, dim), (L, dim), (L, dim, dim), (L, dim, dim),
                      (L, dim, dim), (L, dim, dim), (L, dim), (L, hidden, dim),
                      (L, dim, hidden), (L, hidden, dim), (dim,),
                      (seq, dim // H), (V, dim)):
            f.write(rng.normal(size=shape).astype("<f4").tobytes())
    toks = (["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
            + [f"tok{i} x" for i in range(41)])
    tb = tmp / "tokenizer.bin"
    with open(tb, "wb") as f:
        f.write(struct.pack("<i", max(len(t) for t in toks)))
        for i, t in enumerate(toks):
            b = t.encode()
            f.write(struct.pack("<f", -float(i)) + struct.pack("<i", len(b))
                    + b)
    return ck, tb


def test_converters_write_byte_equal_files(capsys, tmp_path):
    from test_legacy_ggml import _build_ggjt

    ck, tb = _llama2c_files(tmp_path)
    # the vocabulary from tokenizer.bin, then from the GGUF file written
    vocab = str(tb)
    for n in range(2):
        out = [str(tmp_path / f"{w}{n}.gguf") for w in ("p", "j")]
        argv = ["convert-llama2c", "--model", str(ck), "--vocab", vocab, "-o"]
        assert cli.main(argv + [out[0]]) == jcli.main(argv + [out[1]]) == 0
        assert open(out[0], "rb").read() == open(out[1], "rb").read()
        vocab = out[0]
    src = tmp_path / "old.ggjt"
    src.write_bytes(_build_ggjt())
    for pkg, name in ((cli, "p.gguf"), (jcli, "j.gguf")):
        assert pkg.main(["convert-legacy", str(src),
                         str(tmp_path / name)]) == 0
    capsys.readouterr()
    assert ((tmp_path / "p.gguf").read_bytes()
            == (tmp_path / "j.gguf").read_bytes())


def test_gen_docs_lists_the_ported_subcommands(capsys, tmp_path):
    out, _ = run(capsys, ["gen-docs"])
    names = [ln[3:] for ln in out.splitlines() if ln.startswith("## ")]
    assert names == PORTED
    for left in LEFT_OUT:
        assert f"## {left}\n" not in out
    o = tmp_path / "cli.md"
    out, _ = run(capsys, ["gen-docs", "-o", str(o)])
    assert out == f"wrote {o}\n" and "## perplexity" in o.read_text()


@pytest.mark.parametrize("argv,env,needle", [
    (["generate", "-p", "x"], "GHT_COMPUTE_F32", "GHT_COMPUTE_F32"),
    (["perplexity", "-f", "x"], "GHT_PPL_F32", "GHT_PPL_F32"),
    (["generate", "-p", "x", "--cache-type", "f32"], None, "f32"),
    (["passkey", "--grp-attn-n", "4"], None, "kv_rerotate")])
def test_refused_runs_exit_2(model, capsys, monkeypatch, argv, env, needle):
    if env:
        monkeypatch.setenv(env, "1")
    rc = cli.main(argv[:1] + ["-m", model["path"]] + argv[1:] + CPU)
    err = capsys.readouterr().err
    assert rc == 2 and needle in err


@pytest.mark.parametrize("argv", [
    ["generate", "-p", "x"], ["perplexity", "-f", "x"], ["bench"],
    ["eval-callback"]])
def test_no_card_without_device_cpu_exits_non_zero(model, capsys,
                                                   monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(argv[:1] + ["-m", model["path"]] + argv[1:])
    err = capsys.readouterr().err
    assert rc == 1 and "no CUDA card" in err and "--device cpu" in err


def test_preload_serves_a_loaded_model(model, capsys):
    """A model loaded in-process (a buffer's, say) is served under a name."""
    cli.preload("<loaded>", model["cfg"], model["weights"], model["vocab"],
                model["md"])
    try:
        out, _ = run(capsys, ["generate", "-m", "<loaded>", "-p", PROMPT,
                              "-n", "3", "--temp", "0", "-c", "64", *CPU])
    finally:
        cli._MODELS.pop("<loaded>")
    eng, toks = greedy(model, model["tok"].encode(PROMPT), 3)
    assert out == eng.tokenizer.decode(toks) + "\n"


def test_lookup_decoder_is_what_generate_runs(model):
    eng = engine(model, max_seq=64)
    toks = LookupDecoder(eng).generate(model["tok"].encode(PROMPT), 6,
                                       sampler=make_chain(temp=0.0))
    assert toks == greedy(model, model["tok"].encode(PROMPT), 6)[1]
