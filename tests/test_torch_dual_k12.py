"""The host's side of K7 (the interleaved dual QKV GEMV, one il_dual_kernel
launch over two plane sets) and K12 (single-token GQA cache attention, one
launch of a cluster a row and KV head): their plans, pure functions of the
shapes and the card's SM count, so they run here without a card; a torch
emulation of K12's per-split records and their merge, in the kernel's
order; and K7's padding of ternary parts whose group count is not a
multiple of 8, through the plain twin.  The SM counts are the H100 SXM's
132 and the PCIe card's 114."""
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.ops import attention as PA
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.quant.formats import GGMLType

SMS = (132, 114)


def _planes(n, k, qtype, seed=0):
    g = torch.Generator()
    g.manual_seed(seed + n + k)
    return random_qtensor(g, n, k, qtype, "cpu").with_fast_planes(
        "il").without_wire()


def _part(n, k, qtype):
    """A K7 part's plan key (K, G, packed, fb, bias, tiles) as
    kernels.fast_dual forms it: the planes' geometry after padding, from
    64 rows of random planes of the type, and n rows' tiles."""
    qt = kernels.padded_il_planes(_planes(64, k, qtype))
    return (qt.k, qt.fs.shape[1], PF._is_packed(qt.cfg), qt.fb is not None,
            PF._needs_xg(qt.cfg, qt.fb), -(-n // kernels.IL_ROWS))


#: the configurations' pairs (8B Q4_K_M il, 8B IQ3_XXS il) and ternary
#: parts with G = 4 (K = 1024) and G = 43 (K = 11008) in either position
_PAIRS = {"8b_q4k_q6k": ((5120, 4096, GGMLType.Q4_K),
                         (1024, 4096, GGMLType.Q6_K)),
          "8b_iq2s_q4k": ((5120, 4096, GGMLType.IQ2_S),
                          (1024, 4096, GGMLType.Q4_K)),
          "tq1g4_q4k": ((1024, 1024, GGMLType.TQ1_0),
                        (512, 1024, GGMLType.Q4_K)),
          "q8_0_tq1g4": ((512, 1024, GGMLType.Q8_0),
                         (1024, 1024, GGMLType.TQ1_0)),
          "q4k_tq2g43": ((512, 11008, GGMLType.Q4_K),
                         (1024, 11008, GGMLType.TQ2_0))}


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_k7_plan_covers_both_parts_within_the_card(pair):
    """Every tile of both parts once a split and every stage once a tile,
    at most one wave of blocks (SMs x blocks an SM), and each part's
    shared memory, the launch's being the larger, within the budget of
    its blocks an SM, at 1, 4 and 8 rows, plain and normed."""
    parts = tuple(_part(*shape) for shape in _PAIRS[pair])
    for sms in SMS:
        for nb in (1, 4, 8):
            for mode in (0, 1):
                plan = kernels.pick_il_dual(*parts, nb, mode, sms)
                assert plan.per_sm in (1, 2)
                budget = min(kernels.SMEM_BLOCK,
                             kernels.SMEM_SM // plan.per_sm - 1024)
                blocks = 0
                gw = kernels.dual_width(*parts)
                for (K, G, packed, fb, bias, tiles), pp in zip(
                        parts, (plan.a, plan.b)):
                    geo = kernels.il_geo(K, G, packed, gw)
                    assert 1 <= pp.ks <= min(geo.nst, 32)
                    assert 1 <= pp.nbx <= tiles and 1 <= pp.ns <= 8
                    seen = [tile for bx in range(pp.nbx)
                            for tile in range(bx, tiles, pp.nbx)]
                    assert sorted(seen) == list(range(tiles))
                    stages = [s for y in range(pp.ks)
                              for s in range(y * geo.nst // pp.ks,
                                             (y + 1) * geo.nst // pp.ks)]
                    assert stages == list(range(geo.nst))
                    assert pp.smem == kernels.il_smem(geo, fb, bias, pp.ns,
                                                      pp.ks, K // G, nb)
                    assert pp.smem <= plan.smem <= budget
                    blocks += pp.nbx * pp.ks
                assert blocks <= sms * plan.per_sm


def test_k7_width_is_128_only_where_both_parts_take_it():
    """The configurations' pairs stage 128 groups at once; a ternary part
    (8 or 48 groups after padding) puts both parts at 16, which stages
    every group count that is a multiple of 8 (Q4_K at K = 11008: 344)."""
    for pair, want in (("8b_q4k_q6k", 128), ("8b_iq2s_q4k", 128),
                       ("tq1g4_q4k", 16), ("q4k_tq2g43", 16)):
        parts = tuple(_part(*shape) for shape in _PAIRS[pair])
        gw = kernels.dual_width(*parts)
        assert gw == want
        for K, G, packed, *_ in parts:
            geo = kernels.il_geo(K, G, packed, gw)
            assert geo.GW == gw and geo.nrb == -(-G // gw)
            assert geo.nper % geo.NP == 0


def test_k7_plan_shares_the_card_by_plane_bytes():
    """On the 8B Q4_K_M il pair (5120 Q4_K rows, 1024 Q6_K rows, whose
    byte planes take twice the stages a row) part a, which holds about 71%
    of the plane bytes, gets the larger share of the blocks."""
    a, b = (_part(*shape) for shape in _PAIRS["8b_q4k_q6k"])
    plan = kernels.pick_il_dual(a, b, 1, 1, 132)
    assert plan.a.nbx * plan.a.ks > plan.b.nbx * plan.b.ks


def gqa_split_range(p, S, swa, nsplit, sp):
    """The slots [a0, a1) that split sp of nsplit takes of a row at
    position p, and whether the row is dead (no live slot: every slot,
    each with the score -1e30), as csrc/attention.cu's decode_gqa_kernel
    finds them on the card (live_range and the split arithmetic)."""
    hi = min(p, S - 1)
    lo = max(0, p - swa + 1) if swa > 0 else 0
    dead = hi < lo
    if dead:
        lo, hi = 0, S - 1
    ln = (hi - lo + nsplit) // nsplit
    a0 = lo + sp * ln
    return a0, max(a0, min(hi + 1, a0 + ln)), dead


def _live(p, S, swa):
    return [t for t in range(S) if t <= p and (not swa or p - t < swa)]


@pytest.mark.parametrize("swa", [0, 256])
@pytest.mark.parametrize("B,Hkv,S", [(1, 8, 1024), (4, 8, 1024),
                                     (1, 8, 8192), (8, 8, 1024), (1, 1, 40),
                                     (16, 8, 2048)])
def test_k12_plan_covers_every_live_slot_once(B, Hkv, S, swa):
    """The splits (a cluster's blocks: 1 to 8, one wave of clusters, each
    split at least 32 cache slots) take every live slot of a row exactly
    once, with the device's range arithmetic; a row with none (pos -1)
    takes every slot, dead."""
    for sms in SMS:
        ns = kernels.pick_gqa_splits(B, Hkv, S, sms)
        assert 1 <= ns <= kernels.GQA_MAX_SPLITS
        assert B * Hkv * ns <= max(sms, B * Hkv)
        assert ns == 1 or S / ns >= kernels.GQA_MIN_SLOTS
        for p in (-1, 0, 3, 700, 1023, 2000):
            live = _live(p, S, swa)
            got, deads = [], set()
            for sp in range(ns):
                a0, a1, dead = gqa_split_range(p, S, swa, ns, sp)
                assert 0 <= a0 and a1 <= S
                got += range(a0, a1)
                deads.add(dead)
            assert deads == {not live}
            assert got == (live or list(range(S)))


def test_k12_plan_at_the_8b_decode_step():
    """B = 1 and the 8B's 8 KV heads: clusters of 8, 64 blocks."""
    assert kernels.pick_gqa_splits(1, 8, 1024, 132) == 8


def _k12_emulated(qg, k, v, pos, scale, swa, cap, ns):
    """decode_gqa_kernel's arithmetic in f32 torch: per split its passes of
    up to 512 slots (scores, the pass's max, p, its sum, p.v, the running
    sums rescaled once a pass), then rank 0's merge of the splits' (max,
    denominator, accumulator) records in rank order."""
    B, Hkv, G, _, D = qg.shape
    S = k.shape[1]
    out = torch.empty(B, Hkv, G, 1, D)
    for b in range(B):
        for h in range(Hkv):
            q = qg[b, h, :, 0].float() * scale
            recs = []
            for sp in range(ns):
                a0, a1, dead = gqa_split_range(int(pos[b]), S, swa,
                                                       ns, sp)
                m = torch.full((G,), -1e30)
                den = torch.zeros(G)
                acc = torch.zeros(G, D)
                for p0 in range(a0, a1, 512):
                    p1 = min(a1, p0 + 512)
                    s = q @ k[b, p0:p1, h].float().T
                    if cap:
                        s = torch.tanh(s / cap) * cap
                    if dead:
                        s = torch.full_like(s, -1e30)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    den = den * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ v[b, p0:p1, h].float()
                    m = m_new
                recs.append((m, den, acc))
            M = torch.stack([r[0] for r in recs]).max(dim=0).values
            L = torch.zeros(G)
            A = torch.zeros(G, D)
            for m, den, acc in recs:
                f = torch.exp(m - M)
                L = L + den * f
                A = A + acc * f[:, None]
            out[b, h, :, 0] = A / torch.clamp_min(L, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("swa,cap", [(0, 0.0), (256, 0.0), (0, 30.0)],
                         ids=["plain", "swa", "cap"])
def test_k12_merge_emulation_matches_plain(swa, cap):
    """At S = 2048 over 2 splits (shares of 1024 slots: two score passes
    each) and 3 (a ragged last share), rows at the last slot, mid-cache,
    near the start and dead (pos -1: the mean of v): the records and their
    merge give decode_attn_gqa_plain's output within 1e-6."""
    rng = np.random.default_rng(14)
    B, Hkv, G, S, D = 4, 2, 4, 2048, 128
    qg = torch.tensor(rng.normal(size=(B, Hkv, G, 1, D)), dtype=torch.float32)
    k, v = (torch.tensor(rng.normal(size=(B, S, Hkv, D)),
                         dtype=torch.float32).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.tensor([2047, 700, 3, -1], dtype=torch.int32)
    want = PA.decode_attn_gqa_plain(qg, k, v, pos, D ** -0.5, swa, cap)
    for ns in (2, 3):
        got = _k12_emulated(qg, k, v, pos, D ** -0.5, swa, cap, ns)
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("pair", ["tq1g4_q4k", "q8_0_tq1g4", "q4k_tq2g43"])
def test_k7_padded_ternary_parts_give_the_plain_output(pair, B):
    """A ternary part whose G is not a multiple of 8 runs on its padded
    planes with x's zero columns (kernels._pad_call, as fast_dual pads
    it): the plain twin of each part on those gives fast_dual_plain's
    output on the unpadded planes."""
    shapes = _PAIRS[pair]
    a, b = (_planes(n // 4, k, qtype) for n, k, qtype in shapes)
    K = a.k
    rng = np.random.default_rng(B)
    x = torch.tensor(rng.normal(size=(B, K)),
                     dtype=torch.float32).to(torch.bfloat16)
    xgs = [PF.group_sums(q, x, "plain") for q in (a, b)]
    want = PF.fast_dual_plain(x, a, b, xg_a=xgs[0], xg_b=xgs[1])
    cols, padded = [], 0
    for q, xg in zip((a, b), xgs):
        if kernels.il_pad(K, q.fs.shape[1])[1] != q.fs.shape[1]:
            q, xp, _, xg = kernels._pad_call(q, x, None, xg, 0)
            padded += 1
            assert q.fs.shape[1] % 8 == 0 and xp.shape[1] == q.k
        else:
            xp = x
        cols.append(PF._fast_plain(xp, q, PF._family(q.cfg), xg=xg))
    assert padded == 1
    got = torch.cat(cols, dim=1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _event(name, start, end, device):
    from types import SimpleNamespace
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=start, end=end))


def _decode_window(per_step, n=5, leak=0):
    """Profiler events of n decode steps (ProfilerStep ranges 100 us each,
    and their GPU annotations), per_step kernel records (name -> count)
    inside each step, and `leak` records of the first name starting before
    the window (the warm-up step's)."""
    ev = []
    for i in range(n):
        lo = 100.0 * (i + 1)
        ev += [_event("ProfilerStep*", lo, lo + 100, "CPU"),
               _event("ProfilerStep*", lo + 1, lo + 99, "CUDA")]
        for name, count in per_step.items():
            ev += [_event(f"void (anonymous namespace)::{name}<1, 128>()",
                          lo + 2 + j, lo + 3 + j, "CUDA") for j in range(count)]
    first = next(iter(per_step))
    ev += [_event(f"{first}<1, 128>", 60.0 + j, 61.0 + j, "CUDA")
           for j in range(leak)]
    return ev


@pytest.mark.parametrize("case", ["exact", "warmup_leak", "lost", "extra"])
def test_decode_profile_counts_kernels_inside_the_window(case):
    """chip_smoke's profiler check of the interleaved decode steps: only
    kernels starting inside the five ProfilerStep ranges count (a record
    of the warm-up step traced before them does not); exactly one
    il_gemv_kernel a K6/K8 call and one il_dual_kernel a K7 call is
    exact, fewer is a window to trace again, and any more raises."""
    import chip_smoke

    table = {"step": {"fast_nibble_normed": 2, "fast_byte": 1, "fast_dual": 1}}
    per = {"il_gemv_kernel": 3, "il_dual_kernel": 1}
    if case == "lost":
        per["il_gemv_kernel"] = 2
    ev = _decode_window(per, leak=2 if case == "warmup_leak" else 0)
    if case == "extra":
        ev.append(_event("il_dual_kernel<0, 16>", 150.5, 151.0, "CUDA"))
        with pytest.raises(AssertionError, match="decode steps"):
            chip_smoke.il_kernel_counts(ev, table, 5)
        return
    seen, exact, _ = chip_smoke.il_kernel_counts(ev, table, 5)
    assert seen["il_dual_kernel"] == 5
    assert exact == (case != "lost")
