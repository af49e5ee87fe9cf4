"""The port's evaluation (runtime/evaluate.py) against the JAX package's.

The model is the 2-layer Llama GGUF of tests/_torch_gguf_model.py (8/4
heads of 128, vocab 300, SPM), loaded fused by both packages; the JAX side
runs in the mode of the port's kernel contract, op by op
(_torch_gguf_model.jax_matching_mode).  Every sequence is built from the
vocabulary's whole words (one token each), so that the choice tasks come
to the two chunk lengths the perplexity cases use (16 tokens: K3 on every
projection and on the head; 8: K1) and the JAX side runs two shapes.

Measured on this model (one torch thread): the 16-token chunk's logits
NMSE 2.2e-5 and the 8-token chunk's 1.1e-4 against JAX (the target
logprobs 1.1e-6 and 6.7e-6: an ulp of the f32 sums flips an int8
activation rounding now and then, which the next layers carry; see
test_torch_load.py); |d ln PPL| 4.0e-3 over 2 chunks; imatrix entries
NMSE <= 2.1e-5 (dense) and <= 6.1e-5 (per expert on the Mixtral-shaped
file, 4 experts top-2, every routed mask equal to JAX's); every scored
task's choice equal to JAX's (the smallest top-2 gap 0.072, the scores
within 0.0097 of JAX's).  Limits: logits and imatrix NMSE <= 5e-4 (the
mul_mat budget of the reference's op tests), |d ln PPL| <= 1e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread)
from _torch_gguf_model import jax_matching_mode, write_model
from _torch_port import nmse
from ggml_hexagon_tpu.runtime import evaluate as JE
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.runtime import evaluate as PE
from ggml_hexagon_tpu_torch.server.batch_engine import load_fused
from ggml_hexagon_tpu_torch.tokenizer import build_tokenizer

NMSE_MAX = 5e-4
DLNPPL_MAX = 1e-2
TIE = 1e-2  # choices compared where the top-2 mean logprobs differ more
#: the vocabulary's whole words (one SPM token each)
WORDS = ("hello", "world", "the", "model")


def words(seed, n):
    rng = np.random.default_rng(seed)
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


#: HellaSwag: context of 13 words, 4 endings of 2 (16 tokens with BOS)
HELLASWAG = "\n".join(
    line for t in range(3) for line in
    [words(10 + t, 13), str(t % 4)] + [words(20 + 4 * t + j, 2)
                                       for j in range(4)])
#: Winogrande: 15 words with a blank, one-word choices
WINOGRANDE = "\n".join(
    f"{i},{words(30 + i, 7)} _ {words(40 + i, 7)},{WORDS[i]},{WORDS[i + 1]},"
    f"{1 + i % 2}" for i in range(3))
#: MMLU-class: a 12-word question, 3 answers of 3 words
MULTIPLE_CHOICE = [{"question": words(50 + i, 12),
                    "answers": [words(60 + 3 * i + j, 3) for j in range(3)],
                    "label": i % 3} for i in range(2)]
N_CTX = (16, 8)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    path = tmp / "tiny-q4_k_m.gguf"
    write_model(path)
    cfg, weights, vocab, _ = load_fused(path, torch.device("cpu"))
    out = {"cfg": cfg, "weights": weights, "vocab": vocab, "tmp": tmp}
    tok = build_tokenizer(vocab)
    out["tok"] = tok
    corpus = tok.encode(words(1, 40), add_bos=False)
    out["corpus"] = corpus
    with pytest.MonkeyPatch.context() as mp:
        jax_matching_mode(mp, eager=(JE,))
        je = JEngine.from_gguf(str(path), fuse=True, max_seq=32)
        jc, jw = je.cfg, je.weights
        out["jtok"] = je.tokenizer
        ids = [1] + corpus[:15]
        out["chunk"] = {n: JE._chunk_logprobs(jc, jw, ids[:n], jnp.bfloat16)
                        for n in N_CTX}
        out["ppl"] = JE.perplexity(jc, jw, corpus, n_ctx=16, bos_id=1)
        col = JE.IMatrixCollector(jc, jw)
        col.process_chunk(ids)
        out["imatrix"] = col
        col.save(str(tmp / "jax_imatrix.npz"))
        out["choices"] = _jax_choices(jc, jw, je.tokenizer)
    return out


def _jax_choices(cfg, w, tok):
    """JAX's per-candidate scores of every task, as its score functions
    compute them (score_choice_tasks, winogrande)."""
    def mean_lp(s, a, b):
        return JE._mean_continuation_logprob(cfg, w, s, a, b, jnp.bfloat16)

    out = {"hellaswag": [], "multiple_choice": [], "winogrande": []}
    tasks = (("hellaswag", JE.parse_hellaswag(HELLASWAG)),
             ("multiple_choice", [(t["question"], t["answers"], t["label"])
                                  for t in MULTIPLE_CHOICE]))
    for kind, ts in tasks:
        for ctx, cands, _ in ts:
            seqs = [tok.encode(ctx + " " + c, add_bos=True) for c in cands]
            cp = JE._common_prefix(seqs)
            out[kind].append([mean_lp(s, cp, len(s)) for s in seqs])
    for first, second, c1, c2, _ in JE.parse_winogrande_csv(WINOGRANDE):
        seqs = [tok.encode(first + c + second, add_bos=True) for c in (c1, c2)]
        n_bases = [len(tok.encode(first + c, add_bos=True)) for c in (c1, c2)]
        cp = JE._common_prefix(seqs)
        skip = all(len(s) - cp > 3 for s in seqs)
        row = []
        for s, nb in zip(seqs, n_bases):
            start = nb if skip else cp
            last = 1 if len(s) - start > 1 else 0
            row.append(mean_lp(s, start, len(s) - last))
        out["winogrande"].append(row)
    return out


def _centered(lp):
    lp = np.asarray(lp, np.float64)
    return lp - lp.mean(axis=-1, keepdims=True)


@pytest.mark.parametrize("n", N_CTX)
def test_chunk_logprobs_match_jax(ref, n):
    """n=16 runs K3 on every projection and the head, n=8 K1: the logits
    (the log-softmax centred per row) and the target logprobs within NMSE
    5e-4 of JAX's."""
    jl, jlp = ref["chunk"][n]
    ids = [1] + ref["corpus"][:n - 1]
    pl, plp = PE._chunk_logprobs(ref["cfg"], ref["weights"], ids,
                                 device="cpu")
    assert plp.shape == (n, ref["cfg"].n_vocab) and pl.shape == (n - 1,)
    assert nmse(_centered(plp.numpy()), _centered(jlp)) <= NMSE_MAX
    assert nmse(pl, jl) <= NMSE_MAX


def test_perplexity_bookkeeping_and_value(ref):
    """Two chunks of 16: each chunk's first token replaced by BOS, NLL over
    the chunk's second half (n_ctx - 1 - n_ctx // 2 = 7 targets a chunk);
    the count, the chunk count and the chunk ppls' bookkeeping as
    JAX's, the port's result equal to its own chunk logprobs summed by
    hand, and |d ln PPL| <= 1e-2."""
    cfg, w, corpus = ref["cfg"], ref["weights"], ref["corpus"]
    fed = []
    real = PE._chunk_logprobs

    def spy(cfg_, w_, chunk, *a, **k):
        fed.append(list(chunk))
        return real(cfg_, w_, chunk, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PE, "_chunk_logprobs", spy)
        got = PE.perplexity(cfg, w, corpus, n_ctx=16, bos_id=1, device="cpu")
    want = ref["ppl"]
    stream = [1] + list(corpus)
    assert len(fed) == 2 == len(got.chunk_ppls) == len(want.chunk_ppls)
    for c, chunk in enumerate(fed):
        assert chunk == [1] + stream[c * 16 + 1:(c + 1) * 16]
    assert got.nll_count == want.nll_count == 2 * 7
    nll = -sum(float(v) for chunk in fed
               for v in real(cfg, w, chunk, device="cpu")[0][8:])
    assert got.nll_sum == pytest.approx(nll, rel=1e-12)
    assert abs(np.log(got.ppl) - np.log(want.ppl)) <= DLNPPL_MAX
    for g, j in zip(got.chunk_ppls, want.chunk_ppls):
        assert abs(np.log(g) - np.log(j)) <= DLNPPL_MAX


def test_kl_divergence_of_a_model_with_itself(ref):
    cfg, w = ref["cfg"], ref["weights"]
    res = PE.kl_divergence(cfg, w, cfg, w, ref["corpus"][:32], n_ctx=16,
                           device="cpu")
    assert res["kld_mean"] == 0.0 and res["kld_max"] == 0.0
    assert res["same_top1"] == 1.0 and res["n"] == 32


def test_imatrix_matches_jax(ref):
    """15 entries (7 a layer, the head), each within NMSE 5e-4 of JAX's,
    counts exact; the .npz files load in both packages."""
    jcol = ref["imatrix"]
    col = PE.IMatrixCollector(ref["cfg"], ref["weights"], device="cpu")
    col.process_chunk([1] + ref["corpus"][:15])
    assert sorted(col.sums) == sorted(jcol.sums) and len(col.sums) == 15
    assert col.counts == jcol.counts
    for name in col.sums:
        assert nmse(col.sums[name], jcol.sums[name]) <= NMSE_MAX, name
    path = str(ref["tmp"] / "port_imatrix.npz")
    col.save(path)
    mine, theirs = JE.IMatrixCollector.load(path), PE.IMatrixCollector.load(
        str(ref["tmp"] / "jax_imatrix.npz"))
    assert sorted(mine) == sorted(theirs) == sorted(col.result())
    for name, v in col.result().items():
        assert np.array_equal(mine[name], v)
        assert np.array_equal(theirs[name], jcol.result()[name])
    z = np.load(path)
    assert int(z["__count__output.weight"]) == 16


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    path = tmp_path_factory.mktemp("eval_moe") / "tiny-mixtral.gguf"
    write_model(path, seed=4, nh=4, nkv=2, n_expert=4)
    ids = [1] + [int(t) for t in
                 np.random.default_rng(5).integers(3, 300, 15)]
    routed = {"jax": {}, "port": {}}

    def recorder(where, inner):
        def tap(name, x, expert=None):
            if expert is not None:
                e, _, sel = expert
                routed[where][(name, e)] = np.asarray(sel).reshape(-1)
            inner(name, x, expert=expert)
        return tap

    with pytest.MonkeyPatch.context() as mp:
        jax_matching_mode(mp, eager=(JE,))
        je = JEngine.from_gguf(str(path), fuse=True, max_seq=32)
        jcol = JE.IMatrixCollector(je.cfg, je.weights)
        jfwd = JE.forward
        mp.setattr(JE, "forward", lambda *a, tap=None, **k: jfwd(
            *a, tap=recorder("jax", tap), **k))
        jcol.process_chunk(ids)
    cfg, weights, _, _ = load_fused(path, torch.device("cpu"))
    col = PE.IMatrixCollector(cfg, weights, device="cpu")
    pfwd = PE.forward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PE, "forward", lambda *a, tap=None, **k: pfwd(
            *a, tap=recorder("port", tap), **k))
        PL.MOE_ROUTING = []
        try:
            col.process_chunk(ids)
            probs = [p for p, _ in PL.MOE_ROUTING]
        finally:
            PL.MOE_ROUTING = None
    return {"jax": jcol, "port": col, "routed": routed, "probs": probs}


def test_imatrix_per_expert_matches_jax(moe):
    """The Mixtral-shaped file (4 experts, top-2): the routed masks first
    (a differing one must be a near-tie of the router; this seed has
    none), then every entry within NMSE 5e-4 and the per-expert counts
    exact."""
    jr, pr = moe["routed"]["jax"], moe["routed"]["port"]
    assert sorted(jr) == sorted(pr) and jr
    for key in jr:
        if not np.array_equal(jr[key], pr[key]):
            il = int(key[0].split(".")[1])
            p = np.sort(moe["probs"][il].numpy().reshape(-1, 4), axis=-1)
            margin = float((p[:, -2] - p[:, -3]).min())
            pytest.fail(f"routing of {key} differs (top-2/3 margin "
                        f"{margin:.2e}): pick another seed")
    jcol, col = moe["jax"], moe["port"]
    assert sorted(col.sums) == sorted(jcol.sums)
    exps = [n for n in col.sums if "_exps" in n]
    assert len(exps) == 6
    for name in col.sums:
        assert nmse(col.sums[name], jcol.sums[name]) <= NMSE_MAX, name
        c, jc = col.counts[name], jcol.counts[name]
        if name in exps:
            assert c.shape == (4,) and np.array_equal(c, jc)
            assert c.sum() == 2 * 16
        else:
            assert c == jc == 16
    for name, v in col.result().items():
        assert nmse(v, jcol.result()[name]) <= NMSE_MAX


def test_parse_functions_match_jax():
    assert PE.parse_hellaswag(HELLASWAG) == JE.parse_hellaswag(HELLASWAG)
    assert (PE.parse_hellaswag(HELLASWAG, n_tasks=2, seed=3)
            == JE.parse_hellaswag(HELLASWAG, n_tasks=2, seed=3))
    assert (PE.parse_winogrande_csv(WINOGRANDE)
            == JE.parse_winogrande_csv(WINOGRANDE))
    assert PE.parse_multiple_choice(MULTIPLE_CHOICE, 1) == [
        (MULTIPLE_CHOICE[0]["question"], MULTIPLE_CHOICE[0]["answers"], 0)]
    with pytest.raises(ValueError):
        PE.parse_hellaswag("a\nb\nc")


def _held_choices(got, want):
    """The same choice wherever JAX's top-2 scores differ by more than
    TIE; returns the tasks compared."""
    n = 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        top = np.sort(w)[-2:]
        if top[1] - top[0] > TIE:
            assert int(np.argmax(g)) == int(np.argmax(w)), (g, w)
            n += 1
    return n


def test_choice_scoring_matches_jax(ref):
    """HellaSwag, MMLU-class and Winogrande: each task's choice JAX's
    wherever JAX's top-2 scores differ by more than 1e-2 (all 8 tasks
    here); the ScoreResults count what the scores pick."""
    cfg, w, tok = ref["cfg"], ref["weights"], ref["tok"]
    want = ref["choices"]
    hs = PE.parse_hellaswag(HELLASWAG)
    mc = PE.parse_multiple_choice(MULTIPLE_CHOICE)
    got = {kind: [PE.choice_scores(cfg, w, c, cands, tok, device="cpu")
                  for c, cands, _ in ts]
           for kind, ts in (("hellaswag", hs), ("multiple_choice", mc))}
    got["winogrande"] = [PE.winogrande_scores(cfg, w, e, tok, device="cpu")
                         for e in PE.parse_winogrande_csv(WINOGRANDE)]
    assert sum(_held_choices(got[k], want[k]) for k in want) >= 6
    for kind, ts, fn in (("hellaswag", hs, PE.hellaswag),
                         ("multiple_choice", mc, PE.multiple_choice)):
        res = fn(cfg, w, HELLASWAG if kind == "hellaswag"
                 else MULTIPLE_CHOICE, tok, device="cpu")
        right = sum(int(np.argmax(s)) == t[2] for s, t in zip(got[kind], ts))
        assert (res.n_done, res.n_correct) == (len(ts), right)
    res = PE.winogrande(cfg, w, WINOGRANDE, tok, device="cpu")
    right = sum((1 if s[0] > s[1] else 2) == e[4] for s, e in zip(
        got["winogrande"], PE.parse_winogrande_csv(WINOGRANDE)))
    assert (res.n_done, res.n_correct) == (3, right)
    for seqs in ([tok.encode(c + " " + a, add_bos=True) for a in cands]
                 for c, cands, _ in hs + mc):
        assert {len(s) for s in seqs} <= {16, 8}, [len(s) for s in seqs]
