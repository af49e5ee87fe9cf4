"""The port's speculative, lookup and lookahead decoders and the Engine's
eval_tokens against the port's greedy decoding and the JAX package.

The model is the 2-layer Llama GGUF of tests/_torch_gguf_model.py (a
second file of another seed, same vocabulary, is the different draft),
loaded fused by both packages; the JAX Engine runs its forward op by op in
the mode of the port's kernel contract
(_torch_gguf_model.jax_matching_mode).

  greedy     SpeculativeDecoder (the same model as draft, p_min 0, and a
             different one), LookupDecoder (with and without a static
             n-gram cache) and LookaheadDecoder give the port Engine's
             greedy tokens, held by test_torch_batch_engine.py's rule: the
             verify scores 1 + k rows (K1, or K3 above 8) where decoding
             runs one row, so each step's logits within ROUTE_NMSE and the
             tokens equal up to the first near-tie;
  stats      their SpecStats (rounds, drafted, accepted) equal those of the
             JAX decoders on the same weights, and their tokens the JAX
             decoders' tokens, up to a near-tie;
  eval       eval_tokens against the JAX Engine's: the logits of every
             position within NMSE 5e-4, n_past and cached_tokens equal, for
             blocks of 3 (bucket 4), 5 (bucket 8) and 9 (bucket 16, K3), one
             of them a block whose bucket ends at max_seq.

Measured: every decoder's tokens equal the Engine's greedy tokens (each
step's logits within NMSE 1.1e-3 of the decode step's) and the JAX
decoder's (within NMSE 9.8e-4), the SpecStats equal JAX's (speculative and
lookup_static 6 of 6 drafted tokens accepted in 2 rounds, the other draft
0 of 21, lookahead 0 of 2, plain lookup none drafted: the continuation's
n-grams are not in the prompt); eval_tokens' logits within NMSE 3.6e-4 of
JAX's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread)
from _torch_gguf_model import jax_matching_mode, write_model
from _torch_port import nmse
from ggml_hexagon_tpu.runtime import engine as JEM
from ggml_hexagon_tpu.runtime import lookahead as JLA
from ggml_hexagon_tpu.runtime import lookup as JLU
from ggml_hexagon_tpu.runtime import speculative as JSP
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine
from ggml_hexagon_tpu_torch.runtime import lookahead as PLA
from ggml_hexagon_tpu_torch.runtime import lookup as PLU
from ggml_hexagon_tpu_torch.runtime import speculative as PSP
from ggml_hexagon_tpu_torch.runtime.engine import Engine
from ggml_hexagon_tpu_torch.runtime.lookahead import LookaheadDecoder
from ggml_hexagon_tpu_torch.runtime.lookup import LookupDecoder, NgramCache
from ggml_hexagon_tpu_torch.runtime.sampling import greedy_chain
from ggml_hexagon_tpu_torch.runtime.speculative import (SpeculativeDecoder,
                                                        check_compat)
from ggml_hexagon_tpu_torch.server.batch_engine import load_fused

NMSE_MAX = 5e-4
ROUTE_NMSE = 1e-2
MAX_SEQ = 32
N_GEN = 8
#: a repetitive prompt, so that lookup and lookahead find n-grams
PROMPT = [1, 269, 279, 285, 295, 269, 279]
#: (prefill, block) cases of eval_tokens; the last block's bucket (8)
#: ends at MAX_SEQ
EVAL_CASES = [(6, 3), (6, 9), (24, 5)]


class Rec:
    """The greedy chain, recording the logits of every sample."""

    def __init__(self):
        self.inner = greedy_chain()
        self.logits = []

    def sample(self, logits):
        self.logits.append(np.array(logits, np.float32))
        return self.inner.sample(logits)


def _decoders(mod, target, draft, diff_draft, corpus):
    """Each decoder of a package (mod: its speculative, lookup and
    lookahead modules) on target; name -> decoder.  corpus: the tokens of
    lookup_static's n-gram cache (the prompt and the greedy continuation,
    so that its drafts are taken)."""
    sp, lu, la = mod
    static = lu.NgramCache()
    static.update(corpus)
    return {
        "speculative": sp.SpeculativeDecoder(target, draft, n_draft=3,
                                             p_min=0.0),
        "speculative_other": sp.SpeculativeDecoder(target, diff_draft,
                                                   n_draft=3, p_min=0.0),
        "lookup": lu.LookupDecoder(target, n_draft=4),
        "lookup_static": lu.LookupDecoder(target, n_draft=4,
                                          static_cache=static),
        "lookahead": la.LookaheadDecoder(target, n_window=4, n_level=3,
                                         n_draft=3),
    }


def _run(dec):
    dec.target.reset()
    if getattr(dec, "draft", None) is not None:
        dec.draft.reset()
    rec = Rec()
    toks = dec.generate(PROMPT, n_predict=N_GEN, sampler=rec, stop_ids=set())
    s = dec.stats
    return toks, rec.logits[:len(toks)], (s.n_rounds, s.n_drafted,
                                          s.n_accepted)


def _prefill(eng, ids):
    """The prompt in calls of at most 8 tokens (each one 8-token bucket: one
    shape for the JAX side)."""
    for i in range(0, len(ids), 8):
        eng.prefill(np.asarray([ids[i:i + 8]]))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spec")
    path, other = tmp / "tiny-q4_k_m.gguf", tmp / "tiny-other.gguf"
    write_model(path)
    write_model(other, seed=9)
    out = {"port": load_fused(path, torch.device("cpu")),
           "other": load_fused(other, torch.device("cpu"))}
    rec = Rec()
    base = list(_engine(out).generate(PROMPT, n_predict=N_GEN, sampler=rec,
                                      stop_ids=set()))
    out["base"] = (base, rec.logits)
    with pytest.MonkeyPatch.context() as mp:
        jax_matching_mode(mp, eager=(JEM,))
        je = JEngine.from_gguf(str(path), fuse=True, max_seq=MAX_SEQ)
        jo = JEngine.from_gguf(str(other), fuse=True, max_seq=MAX_SEQ)

        def jeng(e):
            return JEngine(e.cfg, e.weights, e.vocab, max_seq=MAX_SEQ)

        decs = _decoders((JSP, JLU, JLA), jeng(je), jeng(je), jeng(jo),
                         PROMPT + base)
        out["jax"] = {name: _run(d) for name, d in decs.items()}
        out["eval"] = []
        e = jeng(je)
        rng = np.random.default_rng(2)
        for n_pre, n_blk in EVAL_CASES:
            ids = rng.integers(3, 300, n_pre + n_blk).tolist()
            e.reset()
            _prefill(e, ids[:n_pre])
            logits = e.eval_tokens(ids[n_pre:])
            out["eval"].append((ids, np.asarray(logits), e.n_past,
                                list(e.cached_tokens)))
    return out


def _engine(ref, which="port"):
    cfg, w, vocab, _ = ref[which]
    return Engine(cfg, w, vocab, max_seq=MAX_SEQ, device="cpu")


def _gap(row):
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def _held(got, want):
    """Two greedy runs ((tokens, sampled logits) each): every step's logits
    within ROUTE_NMSE and the same tokens, up to the first step whose
    tokens differ, which must be a near-tie the measured difference
    explains.  Returns the steps held."""
    (gt, gl), (wt, wl) = got, want
    for i in range(min(len(gt), len(wt))):
        assert nmse(gl[i], wl[i]) <= ROUTE_NMSE, (i, nmse(gl[i], wl[i]))
        if gt[i] != wt[i]:
            d = float(np.abs(gl[i] - wl[i]).max())
            assert min(_gap(gl[i]), _gap(wl[i])) <= 2 * d, (i, gt, wt)
            return i
    assert len(gt) == len(wt)
    return len(gt)


@pytest.fixture(scope="module")
def port_runs(ref):
    decs = _decoders((PSP, PLU, PLA), _engine(ref), _engine(ref),
                     _engine(ref, "other"), PROMPT + ref["base"][0])
    return {"base": ref["base"],
            "runs": {name: _run(d) for name, d in decs.items()}}


DECODERS = ("speculative", "speculative_other", "lookup", "lookup_static",
            "lookahead")


@pytest.mark.parametrize("name", DECODERS)
def test_decoder_gives_the_engine_greedy_tokens(port_runs, name):
    toks, logits, stats = port_runs["runs"][name]
    assert len(toks) == N_GEN
    assert _held((toks, logits), port_runs["base"]) == N_GEN
    n_rounds, n_drafted, n_accepted = stats
    assert 0 <= n_accepted <= n_drafted and n_rounds >= 1
    if name in ("speculative", "lookup_static"):  # drafts that agree
        assert n_accepted >= n_drafted // 2 and n_drafted > 0


@pytest.mark.parametrize("name", DECODERS)
def test_spec_stats_match_jax(ref, port_runs, name):
    got, want = port_runs["runs"][name], ref["jax"][name]
    steps = _held(got[:2], want[:2])
    if steps == N_GEN:
        assert got[2] == want[2]


def test_decoders_are_the_ported_classes():
    """lookup and lookahead ride SpeculativeDecoder's accept loop, and the
    n-gram cache predicts the longest matching context first."""
    assert issubclass(LookupDecoder, SpeculativeDecoder)
    assert issubclass(LookaheadDecoder, SpeculativeDecoder)
    c = NgramCache()
    c.update([1, 2, 3, 1, 2, 4, 1, 2, 4])
    assert c.predict([9, 1, 2]) == 4 and c.predict([3]) == 1
    assert c.predict([77]) is None


def test_check_compat_refuses_another_vocabulary(ref):
    e = _engine(ref)
    check_compat(e, _engine(ref, "other"))
    f = _engine(ref)
    f.vocab = dataclasses.replace(e.vocab, tokens=list(e.vocab.tokens))
    f.vocab.tokens[10] = "different"
    with pytest.raises(ValueError, match="mismatch at id 10"):
        check_compat(e, f)


@pytest.mark.parametrize("case", range(len(EVAL_CASES)))
def test_eval_tokens_matches_jax(ref, case):
    ids, want, n_past, cached = ref["eval"][case]
    n_pre, n_blk = EVAL_CASES[case]
    e = _engine(ref)
    _prefill(e, ids[:n_pre])
    got = e.eval_tokens(ids[n_pre:])
    assert got.shape == want.shape == (n_blk, 300)
    assert nmse(got, want) <= NMSE_MAX
    assert (e.n_past, e.cached_tokens) == (n_past, cached) == (
        n_pre + n_blk, ids)
    if case == len(EVAL_CASES) - 1:
        assert n_pre + 8 == MAX_SEQ  # the bucket ends at the window
