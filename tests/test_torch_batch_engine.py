"""The port's continuous-batching engine (server/batch_engine.py) and what
it runs: the forward with per-row positions, parked rows and logits_idx,
the context shift (runtime/kv_ops.kv_shift) and the slot files.

The model is tests/_torch_gguf_model.py's 2-layer Q4_K/Q6_K GGUF, loaded by
both packages' fused pipelines (one JAX load for the module); (c), which
runs the port alone, takes the same file at 2 query / 1 KV heads
(NARROW).  The JAX side
runs op by op in interpret mode, its forward swapped onto the instance as
tests/test_torch_load.py does (see its docstring: jit reorders the f32
sums of the norm prologues, whose last-ulp changes flip int8 activation
roundings).

  (a) the forward at T=8 and T=1 on three rows at their own positions, one
      parked at the last slot, with logits_idx, under bf16, q8_0 and q4_0
      KV: the live rows' logits within NMSE 5e-4 of the JAX forward, and
      the cache below the parked slot within the same budget (the T=1 step
      starts from the JAX cache, as test_torch_load.py's steps do: int8 and
      int4 roundings of keys that differ in the last ulp amplify);
  (b) one submit trace (3 requests on 2 slots, bf16 KV, max_seq 64) through
      the JAX BatchEngine and the port's: the same tokens, ticks and
      counters;
  (c) every case of tests/test_batch_engine.py, held within the port: a
      slot's tokens equal to the request alone through the port's Engine
      (bf16 KV and compute, where the JAX cases run f32, which the port's
      cache does not have);
  (d) kv_shift against the JAX kv_shift, NMSE <= 1e-7 on the dequantized
      cache, bf16, q8_0 and q4_0;
  (e) slot files written by either package restore in the other (q4_0).
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine
from ggml_hexagon_tpu.runtime.kv_ops import kv_shift as j_kv_shift
from ggml_hexagon_tpu.server.batch_engine import BatchEngine as JBatchEngine

from _torch_gguf_model import jax_cache, port_cache, write_model
from _torch_port import nmse
from ggml_hexagon_tpu_torch.models.llama import forward, init_kv_cache
from ggml_hexagon_tpu_torch.runtime.engine import Engine
from ggml_hexagon_tpu_torch.runtime.kv_ops import kv_dequant, kv_shift
from ggml_hexagon_tpu_torch.runtime.sampling import greedy_chain, make_chain
from ggml_hexagon_tpu_torch.server.batch_engine import (PROMPT_CHUNK,
                                                        BatchEngine,
                                                        DraftModel)

NMSE_MAX = 5e-4
#: (c)'s model: tests/_torch_gguf_model.py's file at 2 query / 1 KV heads
#: of 128 (d = 256): every branch of the 8/4-head file (wqkv in layer 0,
#: wqk + a Q6_K wv and a Q6_K down in layer 1, the Q6_K head) at a quarter
#: of its width, so that the server's many forwards stay cheap on the CPU
NARROW = dict(nh=2, nkv=1)
KV = {"bf16": jnp.bfloat16, "q8_0": "q8_0", "q4_0": "q4_0"}
S_FWD = 32
POS8, IDX8 = [0, 3, S_FWD - 1], [7, 4, 0]
POS1 = [8, 7, S_FWD - 1]
LIVE = [0, 1]
SCHED = dict(n_slots=2, max_seq=64)
SCHED_PROMPTS = [[1, 40, 80, 120, 160], [1, 33, 66, 99, 132, 165, 198],
                 [1, 7, 14, 21]]
SCHED_N = 4
COUNTERS = ("n_requests", "n_tokens_generated", "n_prompt_tokens",
            "n_prompt_tokens_cached", "n_draft_proposed", "n_draft_accepted",
            "n_ctx_shifts", "n_draft_rounds_decoupled")


def _drain(q):
    out = []
    while True:
        tok, fin = q.get_nowait()
        if tok is None:
            return out, fin
        out.append(tok)


def _schedule(be, max_ticks=12):
    """The shared submit trace: all requests at once, ticks counted."""
    qs = [be.submit(p, n_predict=SCHED_N, stop_ids=set())
          for p in SCHED_PROMPTS]
    ticks = 0
    while be.has_work():
        assert ticks < max_ticks, "the trace took more ticks than allowed"
        be.step()
        ticks += 1
    return {"tokens": [_drain(q) for q in qs], "ticks": ticks,
            "metrics": {k: be.metrics[k] for k in COUNTERS}}


def _forward_cases(cfg, weights, kv):
    """The JAX forward on the per-row cases of (a): returns the T=8 logits,
    the cache after it, the T=1 logits and the cache after that."""
    rng = np.random.default_rng(7)
    cache = JL.init_kv_cache(cfg, 3, S_FWD, kv)
    t8 = rng.integers(3, cfg.n_vocab, (3, 8)).astype(np.int32)
    l8, cache = JL.forward(cfg, weights, jnp.asarray(t8), cache,
                           jnp.asarray(POS8, jnp.int32),
                           logits_idx=jnp.asarray(IDX8, jnp.int32))
    after8 = jax_cache(cache)
    t1 = rng.integers(3, cfg.n_vocab, (3, 1)).astype(np.int32)
    l1, cache = JL.forward(cfg, weights, jnp.asarray(t1), cache,
                           jnp.asarray(POS1, jnp.int32))
    return dict(t8=t8, l8=np.asarray(l8), after8=after8, t1=t1,
                l1=np.asarray(l1), after1=jax_cache(cache))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "tiny-q4_k_m.gguf"
    write_model(path)
    out = {"path": path}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_FAST_INTERPRET", "1")
        mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
        mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
        je = JEngine.from_gguf(str(path), fuse=True, max_seq=S_FWD)
        out["jax"] = je
        for kv, jkv in KV.items():
            out[kv] = _forward_cases(je.cfg, je.weights, jkv)
        jbe = JBatchEngine(je.cfg, je.weights, je.vocab, kv_dtype=jnp.bfloat16,
                           **SCHED)
        jbe._fwd = partial(JL.forward, je.cfg, compute_dtype=jnp.bfloat16)
        out["sched"] = _schedule(jbe)
    port = BatchEngine.from_gguf(path, device="cpu", **SCHED)
    out["cfg"], out["weights"], out["vocab"] = (port.cfg, port.weights,
                                                port.vocab)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU's f32 GEMM (the plain K3) sums in an
    order that follows the thread count, which a loaded machine's BLAS may
    change from call to call; (c)'s bit-equal comparisons need one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cache_nmse(got: dict, want: dict, kv: str, rows, below: int):
    """NMSE of the dequantized caches (port layout) over `rows`, slots <
    below."""
    g = {k: v[:, rows, :below] for k, v in got.items()}
    w = {k: v[:, rows, :below] for k, v in want.items()}
    return max(nmse(kv_dequant(g, n).numpy(), kv_dequant(w, n).numpy())
               for n in ("k", "v"))


@pytest.mark.parametrize("kv", list(KV))
def test_forward_per_row_positions_match_jax(ref, kv):
    """(a) T=8 from an empty cache with rows at 0 and 3 and one parked at
    S-1 (logits_idx picks each live row's last prompt token), then T=1 at
    rows' own positions: the live rows' logits and the written cache below
    the parked slot against the JAX forward."""
    r, cfg, w = ref[kv], ref["cfg"], ref["weights"]
    cache = init_kv_cache(cfg, 3, S_FWD, kv, device="cpu")
    l8, cache = forward(cfg, w, torch.from_numpy(r["t8"]).long(), cache,
                        torch.tensor(POS8), logits_idx=torch.tensor(IDX8))
    assert l8.shape == (3, cfg.n_vocab)
    assert nmse(l8.numpy()[LIVE], r["l8"][LIVE]) <= NMSE_MAX
    want8 = port_cache(r["after8"], kv)
    assert _cache_nmse(cache, want8, kv, LIVE, S_FWD - 1) <= NMSE_MAX
    cache = port_cache(r["after8"], kv)  # the T=1 step from the JAX cache
    l1, cache = forward(cfg, w, torch.from_numpy(r["t1"]).long(), cache,
                        torch.tensor(POS1))
    assert torch.isfinite(l1).all()
    assert nmse(l1.numpy()[LIVE], r["l1"][LIVE]) <= NMSE_MAX
    want1 = port_cache(r["after1"], kv)
    assert _cache_nmse(cache, want1, kv, LIVE, S_FWD - 1) <= NMSE_MAX


def test_scalar_offset_is_the_per_row_forward_of_equal_rows(ref):
    """An int offset (the Engine's) and per-row offsets that are all equal
    give the same logits and cache, bit for bit (forward turns the int into
    the [B] offsets at entry)."""
    cfg, w = ref["cfg"], ref["weights"]
    toks = torch.from_numpy(ref["bf16"]["t8"][:2]).long()
    out = []
    for pos in (3, torch.tensor([3, 3])):
        cache = init_kv_cache(cfg, 2, S_FWD, "bf16", device="cpu")
        lg, cache = forward(cfg, w, toks, cache, pos, logits_all=True)
        out.append((lg, cache))
    assert torch.equal(out[0][0], out[1][0])
    for n in ("k", "v"):
        assert torch.equal(out[0][1][n], out[1][1][n])


def test_schedule_matches_jax_batch_engine(ref):
    """(b) The same submit trace through both engines: tokens, finish
    reasons, tick count and counters equal."""
    be = BatchEngine(ref["cfg"], ref["weights"], ref["vocab"], device="cpu",
                     **SCHED)
    got = _schedule(be)
    assert got == ref["sched"]
    assert got["metrics"]["n_tokens_generated"] == 3 * SCHED_N


def _rand_cache(cfg, kv, B, S, seed):
    """A JAX-format cache (jax_cache's numpy arrays) of random content."""
    rng = np.random.default_rng(seed)
    W = cfg.n_head_kv * cfg.hd
    shape = (cfg.n_layer, B, S, W)
    if kv == "bf16":
        x = rng.normal(size=shape).astype(np.float32)
        bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
        return {"k": bits.numpy(), "v": bits.numpy()[..., ::-1].copy()}
    qmax = 127 if kv == "q8_0" else 7
    return {n: rng.integers(-qmax, qmax + 1, shape).astype(np.int8)
            for n in ("k", "v")} | {
        n: (rng.random(shape[:3]) * 0.02 + 1e-3).astype(np.float32)
        for n in ("k_d", "v_d")}


def _to_jax(c, kv):
    out = {}
    for n, a in c.items():
        if kv == "bf16":
            out[n] = jnp.asarray(torch.from_numpy(a).view(torch.bfloat16)
                                 .float().numpy(), jnp.bfloat16)
        elif kv == "q4_0" and n in ("k", "v"):
            out[n] = jnp.asarray(a, jnp.int4)
        else:
            out[n] = jnp.asarray(a)
    return out


@pytest.mark.parametrize("kv", list(KV))
def test_kv_shift_matches_jax(ref, kv):
    """(d) Drop slots [4, 4+5) of a 24-slot cache, move the rest down and
    re-rotate K: the port's cache, dequantized, within NMSE 1e-7 of JAX's
    (all slots: both leave the tail past S - n_discard as it was)."""
    cfg = ref["cfg"]
    c = _rand_cache(cfg, kv, 2, 24, seed=5)
    want = jax_cache(j_kv_shift(ref["jax"].cfg, _to_jax(c, kv), 4, 5, 20))
    got = kv_shift(cfg, port_cache(c, kv), 4, 5, 20)
    for n in ("k", "v"):
        g = kv_dequant(got, n).numpy()
        w = kv_dequant(port_cache(want, kv), n).numpy()
        assert nmse(g, w) <= 1e-7, n
    moved = kv_dequant(port_cache(c, kv), "v")[:, :, 9:]
    assert torch.equal(kv_dequant(got, "v")[:, :, 4:19], moved)


def test_slot_files_restore_across_packages(ref, tmp_path):
    """(e) q4_0: a slot file of the JAX BatchEngine restores into the
    port's and one of the port's into JAX's, every plane equal."""
    je, cfg = ref["jax"], ref["cfg"]
    c = _rand_cache(cfg, "q4_0", 2, 16, seed=9)
    jbe = JBatchEngine(je.cfg, je.weights, je.vocab, n_slots=2, max_seq=16,
                       kv_dtype="q4_0")
    jbe.kv = _to_jax(c, "q4_0")
    jbe.slots[1].n_past, jbe.slots[1].prompt = 11, list(range(3, 14))
    jbe.save_slot(1, str(tmp_path / "jax.npz"))
    pbe = BatchEngine(cfg, ref["weights"], ref["vocab"], n_slots=2,
                      max_seq=16, kv_dtype="q4_0", device="cpu")
    pbe.restore_slot(0, str(tmp_path / "jax.npz"))
    want = port_cache(c, "q4_0")
    for n, a in pbe.kv.items():
        assert torch.equal(a[:, 0], want[n][:, 1]), n
    assert pbe.slots[0].n_past == 11
    assert pbe.slots[0].settled == list(range(3, 14))
    pbe.save_slot(0, str(tmp_path / "port.npz"))
    jbe2 = JBatchEngine(je.cfg, je.weights, je.vocab, n_slots=2, max_seq=16,
                        kv_dtype="q4_0")
    jbe2.restore_slot(1, str(tmp_path / "port.npz"))
    back = jax_cache(jbe2.kv)
    for n in c:
        assert np.array_equal(back[n][:, 1], c[n][:, 1]), n
    assert jbe2.slots[1].n_past == 11


# -- (c) the JAX package's BatchEngine cases, held within the port ----------


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "narrow-q4_k_m.gguf"
    write_model(path, **NARROW)
    be = BatchEngine.from_gguf(path, device="cpu", n_slots=1, max_seq=8)
    return {"cfg": be.cfg, "weights": be.weights, "vocab": be.vocab}


class Rec:
    """A sampler chain (greedy by default) that records the logits of
    every sample it draws."""

    def __init__(self, inner=None):
        self.inner = inner or greedy_chain()
        self.logits = []

    def sample(self, logits):
        self.logits.append(np.array(logits, np.float32))
        return self.inner.sample(logits)


def _engine(small, **kw):
    return BatchEngine(small["cfg"], small["weights"], small["vocab"],
                       device="cpu", **kw)


def _alone(small, prompt, n, sampler=None, **kw):
    """The request alone on a fresh engine of the same shape: its tokens
    and the logits it sampled from."""
    rec = Rec(sampler)
    out = _engine(small, **kw).complete(prompt, n_predict=n, sampler=rec,
                                      stop_ids=set())
    return out, rec.logits


def _baseline(small, prompt, n, max_seq=128):
    """The request through the port's Engine (B=1), its prompt in the
    server's chunks (PROMPT_CHUNK wide, not the Engine's 8/32/128/512
    buckets: at <= 8 rows the prefill runs the decode GEMVs, whose int8
    activations move the logits by NMSE ~2e-3 against the prefill GEMM's,
    as in the JAX package)."""
    eng = Engine(small["cfg"], small["weights"], small["vocab"], max_seq=max_seq,
                 device="cpu")
    c = min(PROMPT_CHUNK, max_seq - 1)
    eng._chunks = lambda t: [(min(c, t - i), c) for i in range(0, t, c)]
    rec = Rec()
    out = list(eng.generate(prompt, n_predict=n, sampler=rec, stop_ids=set()))
    return out, rec.logits


def _draft(small, n_slots, max_seq=128):
    """A draft model sharing the target's weights, its own cache."""
    return DraftModel(small["cfg"], small["weights"], n_slots=n_slots,
                      max_seq=max_seq, device="cpu")


#: the logits of one request through two routes: the speculative verify
#: scores 1 + k tokens a row (above 8 rows: the prefill GEMM) where plain
#: decoding runs the decode GEMV (int8 activations), a T=1 step the decode
#: GEMV where a prompt tick ran the GEMM (as K1 and K3 differ in the JAX
#: package, NMSE ~2e-3 on this model), and the Engine's B=1 step beside
#: the server's B-row step, whose f32 sums differ in the last ulp, which one
#: int8 activation rounding amplifies (8e-4 measured at one step; see
#: test_torch_load.py's docstring); their tokens are held by _held's
#: near-tie rule
ROUTE_NMSE = 1e-2


def _gap(row):
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def _held(got, want):
    """Two greedy runs of one request ((tokens, sampled logits) each): the
    same tokens, each step's logits within ROUTE_NMSE, up to the first step
    whose tokens differ, which must be a near-tie the measured difference
    explains (a top-2 gap of either run within twice the step's max
    |difference|).  Returns the steps held."""
    (gt, gl), (wt, wl) = got, want
    for i in range(min(len(gt), len(wt))):
        assert nmse(gl[i], wl[i]) <= ROUTE_NMSE, (i, nmse(gl[i], wl[i]))
        if gt[i] != wt[i]:
            d = float(np.abs(gl[i] - wl[i]).max())
            gaps = (_gap(gl[i]), _gap(wl[i]))
            assert min(gaps) <= 2 * d, (i, gt[i], wt[i], gaps, d)
            return i
    assert len(gt) == len(wt)
    return len(gt)


def test_single_request_matches_engine(small):
    be = _engine(small, n_slots=2, max_seq=128)
    prompt = [1, 10, 20, 30]
    rec = Rec()
    got = be.complete(prompt, n_predict=12, sampler=rec, stop_ids=set())
    _held((got, rec.logits), _baseline(small, prompt, 12))


def _batched(small, prompts, n, **kw):
    be = _engine(small, **kw)
    recs = [Rec() for _ in prompts]
    queues = [be.submit(p, n_predict=n, sampler=r, stop_ids=set())
              for p, r in zip(prompts, recs)]
    be.run_until_idle()
    return be, [_drain(q) + (r.logits,) for q, r in zip(queues, recs)]


def test_concurrent_requests_all_match(small):
    """Batching and slot interleaving change no sequence's result: each
    slot's tokens and logits equal the request alone, bit for bit (the
    same kernels at the same shapes), and the Engine's within _held."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 299, size=n).tolist() for n in (4, 9, 17, 3)]
    _, outs = _batched(small, prompts, 10, n_slots=4, max_seq=128)
    for p, (out, _, logits) in zip(prompts, outs):
        alone = _alone(small, p, 10, n_slots=4, max_seq=128)
        assert out == alone[0], p[:3]
        assert all(np.array_equal(a, b) for a, b in zip(logits, alone[1]))
        _held((out, logits), _baseline(small, p, 10))


def test_more_requests_than_slots(small):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 299, size=5).tolist() for _ in range(5)]
    be, outs = _batched(small, prompts, 6, n_slots=2, max_seq=128)
    for p, (out, fin, _) in zip(prompts, outs):
        assert fin == "length"
        assert out == _alone(small, p, 6, n_slots=2, max_seq=128)[0]
    assert be.metrics["n_requests"] == 5
    assert be.metrics["n_tokens_generated"] == 30


def test_long_prompt_chunked(small):
    be = _engine(small, n_slots=2, max_seq=256)
    prompt = np.random.default_rng(2).integers(3, 299, size=150).tolist()
    assert len(prompt) > PROMPT_CHUNK
    rec = Rec()
    got = be.complete(prompt, n_predict=5, sampler=rec, stop_ids=set())
    _held((got, rec.logits), _baseline(small, prompt, 5, max_seq=256))


def test_slot_save_restore(small, tmp_path):
    """A slot saved mid-stream, restored into a fresh engine, continues as
    the unsaved one did (decoded here with the forward directly)."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, 299, size=10).tolist()
    be2 = _engine(small, n_slots=2, max_seq=128)
    rec = Rec()
    q2 = be2.submit(prompt, n_predict=8, sampler=rec, stop_ids=set())
    while be2.slots[0].state.name != "GENERATING":
        be2.step()
    p = str(tmp_path / "slot.npz")
    be2.save_slot(0, p)
    be2.run_until_idle()
    want, _ = _drain(q2)
    be3 = _engine(small, n_slots=2, max_seq=128)
    be3.restore_slot(0, p)
    s = be3.slots[0]
    B, park = be3.n_slots, be3.park_pos

    def fwd(tok, pos):
        logits, be3.kv = be3._fwd(
            be3.weights, torch.tensor([[tok]] + [[0]] * (B - 1)), be3.kv,
            torch.tensor([pos] + [park] * (B - 1)))
        return logits[0].numpy()

    # the last prompt token again at its slot gives the pending logits (at
    # T=1, where the prompt tick ran T=127: held, not bit-equal), then the
    # decode from the restored rows
    cur = fwd(s.prompt[-1], s.n_past - 1)
    sampler = Rec()
    got = []
    for _ in range(len(want)):
        got.append(sampler.sample(cur))
        cur = fwd(got[-1], s.n_past)
        s.n_past += 1
    _held((got, sampler.logits), (want, rec.logits))


def test_speculative_decoding_matches_and_accepts(small):
    """Draft == target: the outputs equal non-speculative decoding up to a
    near-tie, and multi-token accepts happen.  The floor is "some", not
    the JAX case's quarter: the draft proposes through T=1 greedy steps
    (the decode GEMV, int8 activations) and the target verifies 1 + k rows
    a slot (above 8 rows: the prefill GEMM), two routes whose logits differ
    by NMSE ~2e-3 on this model, whose near-uniform random logits flip
    the argmax at that distance (5 of 68 proposals accepted); the JAX case
    runs one f32 route on both sides.  chip_smoke.py holds the 8B, whose
    logits are less flat, to SPEC_ACCEPT_MIN (20%; 35% measured)."""
    prompts = [[1, 10, 20, 30], [1, 50, 60]]
    be, outs = _batched(small, prompts, 12, n_slots=2, max_seq=128,
                        draft=_draft(small, 2), n_draft=4, draft_p_min=0.0)
    for p, (out, _, logits) in zip(prompts, outs):
        _held((out, logits), _alone(small, p, 12, n_slots=2, max_seq=128))
    assert be.metrics["n_draft_proposed"] > 0
    assert be.metrics["n_draft_accepted"] > 0


def test_ctx_shift_slot_survives_window(small):
    be = _engine(small, n_slots=1, max_seq=48, ctx_shift=True, n_keep=4)
    q = be.submit([1, 10, 20, 30], n_predict=70, stop_ids=set())
    be.run_until_idle()
    out, fin = _drain(q)
    assert len(out) == 70 and fin == "length"
    assert be.metrics["n_ctx_shifts"] >= 1


def test_prompt_cache_multiturn_reuse(small):
    """A second turn extending the resident tokens prefills only its tail
    (one prompt tick for a >128-token prompt) and gives the cold run's
    tokens."""
    be = _engine(small, n_slots=1, max_seq=256)
    rng = np.random.default_rng(3)
    p1 = rng.integers(3, 299, size=150).tolist()
    out1 = be.complete(p1, n_predict=6, stop_ids=set())
    assert be.metrics["n_prompt_tokens_cached"] == 0
    p2 = p1 + out1 + rng.integers(3, 299, size=5).tolist()
    ticks = 0
    orig = be._prompt_tick

    def counting(slots):
        nonlocal ticks
        ticks += 1
        return orig(slots)

    be._prompt_tick = counting
    rec = Rec()
    out2 = be.complete(p2, n_predict=6, sampler=rec, stop_ids=set())
    assert be.metrics["n_prompt_tokens_cached"] >= len(p1)
    assert ticks == 1
    _held((out2, rec.logits), _alone(small, p2, 6, n_slots=1, max_seq=256))
    _held((out2, rec.logits), _baseline(small, p2, 6, max_seq=256))


def test_prompt_cache_opt_out_and_divergent_prefix(small):
    be = _engine(small, n_slots=1, max_seq=128)
    p1 = [1, 10, 20, 30, 40, 50]
    be.complete(p1, n_predict=4, stop_ids=set())
    q = be.submit(p1, n_predict=4, stop_ids=set(), cache_prompt=False)
    be.run_until_idle()
    assert be.metrics["n_prompt_tokens_cached"] == 0
    assert _drain(q)[0] == _alone(small, p1, 4, n_slots=1, max_seq=128)[0]
    p3 = [1, 10, 20, 99, 98]
    rec = Rec()
    out3 = be.complete(p3, n_predict=4, sampler=rec, stop_ids=set())
    assert be.metrics["n_prompt_tokens_cached"] == 3
    _held((out3, rec.logits), _alone(small, p3, 4, n_slots=1, max_seq=128))


def test_prompt_cache_slot_affinity(small):
    be = _engine(small, n_slots=2, max_seq=128)
    pa, pb = [1, 10, 20, 30, 40], [1, 50, 60, 70, 80]
    qa = be.submit(pa, n_predict=3, stop_ids=set())
    qb = be.submit(pb, n_predict=3, stop_ids=set())
    be.run_until_idle()
    _drain(qa), _drain(qb)
    cached0 = be.metrics["n_prompt_tokens_cached"]
    rec = Rec()
    out = be.complete(pb, n_predict=3, sampler=rec, stop_ids=set())
    assert be.metrics["n_prompt_tokens_cached"] - cached0 == len(pb) - 1
    _held((out, rec.logits), _alone(small, pb, 3, n_slots=2, max_seq=128))


def test_spec_draft_decoupling_policy():
    assert BatchEngine._spec_continue(4, 4)
    assert BatchEngine._spec_continue(2, 4)
    assert not BatchEngine._spec_continue(1, 4)
    assert not BatchEngine._spec_continue(3, 8)
    assert BatchEngine._spec_continue(1, 1)


def test_spec_decoupled_still_matches_baseline(small):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 299, size=n).tolist() for n in (4, 7, 5, 9)]
    _, outs = _batched(small, prompts, 8, n_slots=4, max_seq=128,
                       draft=_draft(small, 4), n_draft=6, draft_p_min=0.02)
    for p, (out, _, logits) in zip(prompts, outs):
        _held((out, logits), _alone(small, p, 8, n_slots=4, max_seq=128))


def test_slot_save_restore_quantized_kv(small, tmp_path):
    """q8_0: every plane (the scales k_d / v_d too) round-trips through a
    slot file; the slot erased and restored continues the next request as
    the unsaved slot did, bit for bit (the restored rows are reused), and
    as a fresh engine does within _held."""
    prompt = [1, 10, 20, 30]
    be = _engine(small, n_slots=2, max_seq=128, kv_dtype="q8_0")
    out1 = be.complete(prompt, n_predict=6, stop_ids=set())
    assert set(be.kv) == {"k", "v", "k_d", "v_d"}
    path = str(tmp_path / "slot0.npz")
    sid = next(s.id for s in be.slots if s.n_past > 0)
    be.save_slot(sid, path)
    orig = {n: a[:, sid].clone() for n, a in be.kv.items()}
    n_past = be.slots[sid].n_past
    p2 = prompt + out1 + [7, 8]
    want = be.complete(p2, n_predict=6, stop_ids=set())
    be.erase_slot(sid)
    be.kv = {n: torch.zeros_like(a) for n, a in be.kv.items()}
    be.restore_slot(sid, path)
    for n in orig:
        assert torch.equal(be.kv[n][:, sid], orig[n]), n
    assert be.slots[sid].n_past == n_past
    assert be.slots[sid].settled == (prompt + out1)[:n_past]
    rec = Rec()
    cached0 = be.metrics["n_prompt_tokens_cached"]
    out2 = be.complete(p2, n_predict=6, sampler=rec, stop_ids=set())
    assert be.metrics["n_prompt_tokens_cached"] - cached0 == n_past
    assert out2 == want
    _held((out2, rec.logits),
          _alone(small, p2, 6, n_slots=2, max_seq=128, kv_dtype="q8_0"))


class Drawn(Rec):
    """Rec that also records what every sample returned."""

    def __init__(self, inner):
        super().__init__(inner)
        self.tokens = []

    def sample(self, logits):
        self.tokens.append(super().sample(logits))
        return self.tokens[-1]


def test_spec_stateful_sampler_matches_nonspec(small):
    """A stateful stochastic chain (repeat-penalty ring, seeded draws):
    every speculative position is sampled exactly once, so the emitted
    tokens are the chain's draws in order, and the same chain replayed on
    the logits it saw draws them again; the first token (the prompt tick's
    logits, one route in both runs) equals the non-speculative run's."""
    def mk():
        return make_chain(temp=0.9, top_k=0, top_p=1.0, min_p=0.0,
                          penalty_last_n=8, penalty_repeat=1.4, seed=11)

    prompt = [1, 10, 20, 30]
    be_ref = _engine(small, n_slots=1, max_seq=128)
    q = be_ref.submit(prompt, n_predict=14, sampler=mk(), stop_ids=set())
    be_ref.run_until_idle()
    want, _ = _drain(q)
    be = _engine(small, n_slots=1, max_seq=128, draft=_draft(small, 1),
                 n_draft=4, draft_p_min=0.0)
    drawn = Drawn(mk())
    q = be.submit(prompt, n_predict=14, sampler=drawn, stop_ids=set())
    be.run_until_idle()
    got, _ = _drain(q)
    assert len(got) == 14 and got == drawn.tokens[:14]
    replay = mk()
    assert [replay.sample(lg) for lg in drawn.logits] == drawn.tokens
    assert got[0] == want[0]
    assert be.metrics["n_draft_proposed"] > 0


def test_ctx_shift_draft_refeed_bounded(small):
    """After a context shift the draft cache is fed again in chunks, not
    one token a forward; generation with a draft survives the shift."""
    prompt = [1, 10, 20, 30]
    be_ref = _engine(small, n_slots=1, max_seq=48, ctx_shift=True, n_keep=4)
    rec_ref = Rec()
    q = be_ref.submit(prompt, n_predict=50, sampler=rec_ref, stop_ids=set())
    be_ref.run_until_idle()
    want, _ = _drain(q)
    want_logits = rec_ref.logits
    assert be_ref.metrics["n_ctx_shifts"] >= 1
    draft = _draft(small, 1, max_seq=64)
    be = _engine(small, n_slots=1, max_seq=48, draft=draft, n_draft=4,
                 draft_p_min=0.0, ctx_shift=True, n_keep=4)
    calls = {"one": 0, "chunk": 0}
    inner = draft._fwd

    def counting_fwd(w, toks, kv, pos, **kw):
        calls["one" if toks.shape[1] == 1 else "chunk"] += 1
        return inner(w, toks, kv, pos, **kw)

    draft._fwd = counting_fwd
    rec = Rec()
    q = be.submit(prompt, n_predict=50, sampler=rec, stop_ids=set())
    be.run_until_idle()
    got, fin = _drain(q)
    # the shifts come at other times (the speculative room reserves 1 +
    # n_draft slots): the prefix before the first shift is held
    _held((got[:30], rec.logits[:30]), (want[:30], want_logits[:30]))
    assert len(got) == 50 and fin == "length"
    assert be.metrics["n_ctx_shifts"] >= 1
    assert calls["chunk"] >= be.metrics["n_ctx_shifts"]
    assert calls["one"] <= 50 * (1 + 4 + 2), calls
    assert int(draft.n_past[0]) >= be.slots[0].n_past - 1
