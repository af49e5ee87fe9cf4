"""The host's tile and split choices for the wgmma GEMMs, K3 and K6 above
8 rows (token tile, K over blocks), and K4 (live cache slots over blocks):
pure functions of the shapes, so they run here without a card.  The
card's SM count is stubbed at the H100's 132; K10's GEMV (its walk of the
wire planes and its splits) too."""
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.quant.formats import GGMLType
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS as QCONFIGS_T

H100_SMS = 132
DEV = torch.device("cuda", 0)


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(kernels, "_sm_count", lambda index: H100_SMS)


@pytest.mark.parametrize("B,Hkv,S", [(1, 8, 1024), (4, 8, 1024),
                                     (1, 8, 8192), (1, 1, 64), (8, 8, 512)])
def test_decode_splits_cover_the_card_with_whole_slices(B, Hkv, S):
    ns = kernels._pick_nsplit(B * Hkv, S, min_slots=32)
    assert ns >= 1
    assert S / ns >= 32 or ns == 1   # at least 32 slots of the cache a split
    if S >= 32 * 132 // (B * Hkv):  # a cache long enough to fill the card
        assert B * Hkv * ns >= H100_SMS


def test_decode_splits_at_the_8b_decode_step():
    """B=1, 8 KV heads, 1024 slots: 32 splits, 256 blocks for 132 SMs."""
    assert kernels._pick_nsplit(8, 1024, min_slots=32) == 32


@pytest.mark.parametrize("M,n2,K,want", [
    (512, 28672, 4096, 1),    # gate_up: 224 x 2 tiles already fill the card
    (32, 28672, 4096, 1),
    (512, 4096, 14336, 2),    # down: 32 x 2 tiles
    (128, 4096, 14336, 4),
    (32, 4096, 14336, 4),
    (512, 4096, 4096, 2),     # wo
    (512, 6144, 4096, 4),     # wqkv: 96 tiles, a wave of 132 cut to 0.75
])
def test_gemm_splits_at_the_8b_shapes(sms, M, n2, K, want):
    assert kernels._gemm_splits(M, n2, K, DEV) == want


@pytest.mark.parametrize("M", [9, 32, 100, 128, 200, 512])
@pytest.mark.parametrize("n2,K", [(128, 1024), (1024, 4096), (4096, 14336),
                                  (128256, 4096)])
def test_gemm_splits_keep_eight_stages_a_split(sms, M, n2, K):
    ks = kernels._gemm_splits(M, n2, K, DEV)
    assert 1 <= ks <= 8
    assert ks == 1 or K // 64 // ks >= 8


@pytest.mark.parametrize("M,want", [(9, 32), (32, 32), (33, 128), (128, 128),
                                    (129, 256), (512, 256), (1024, 256)])
def test_gemm_token_tile(M, want):
    assert kernels.gemm_token_tile(M) == want


@pytest.mark.parametrize("M,n2,K,want", [
    (512, 14336, 4096, 1),    # a Mixtral expert's gate: 112 x 2 tiles
    (128, 14336, 4096, 1),    # 112 tiles: one wave either way
    (512, 4096, 14336, 2),    # an expert's down: 32 x 2 tiles
    (1024, 4096, 14336, 1),   # past the 512-token chunk: 32 x 4 tiles
    (1024, 28672, 4096, 1),
])
def test_gemm_splits_at_the_il_shapes(sms, M, n2, K, want):
    assert kernels._gemm_splits(M, n2, K, DEV) == want


#: K6's GEMM launch keys by family and group bias, on planes built here
_GEMM_KEYS = {GGMLType.IQ4_XS: "fast_byte_gemm", GGMLType.Q8_0: "fast_byte_gemm",
              GGMLType.Q6_K: "fast_byte_gemm_derived",
              GGMLType.Q5_K: "fast_byte_gemm_stored",
              GGMLType.Q4_K: "fast_nibble_gemm_stored",
              GGMLType.Q4_0: "fast_nibble_gemm_derived",
              GGMLType.IQ3_XXS: "fast_coded_gemm",
              GGMLType.IQ2_S: "fast_coded_gemm"}


@pytest.mark.parametrize("qtype", list(_GEMM_KEYS), ids=lambda t: t.name)
def test_gemm_keys_name_family_and_bias(qtype):
    g = torch.Generator()
    g.manual_seed(int(qtype))
    qt = random_qtensor(g, 128, 256, qtype, "cpu").with_fast_planes("il")
    assert qt.fl == "il"
    assert kernels.gemm_key(qt) == _GEMM_KEYS[qtype]
    assert kernels.gemm_key(qt) in kernels.GEMM_LAUNCHES


# ---------------------------------------------------------------------------
# K1 / K2 / K5 (csrc/qp8_gemv.cu): the picker of tile, ring and K splits
# ---------------------------------------------------------------------------

_T = GGMLType
#: every K1/K2/K5 launch shape of the configurations that serve t-planes
#: (the interleaved ones launch none): the plane sets of one launch as
#: (type, lanes, K), two for K2; the rows the grid takes apart (K5: P rows,
#: each against one expert's lanes, 2 at decode and 16 at the 8-token
#: bucket; 1 otherwise)
_GEMV_LAUNCHES = {
    # Llama-3-8B Q4_K_M: wqkv, wqk + wv (K2; apart at the 8-token bucket),
    # wo, gate_up, the Q4_K / Q6_K down, the Q6_K head (128256 lanes)
    "8b_wqkv": ([(_T.Q4_K, 6144, 4096)], (1,)),
    "8b_wqk_wv": ([(_T.Q4_K, 5120, 4096), (_T.Q6_K, 1024, 4096)], (1,)),
    "8b_wqk": ([(_T.Q4_K, 5120, 4096)], (1,)),
    "8b_wv_q6k": ([(_T.Q6_K, 1024, 4096)], (1,)),
    "8b_wo": ([(_T.Q4_K, 4096, 4096)], (1,)),
    "8b_gate_up": ([(_T.Q4_K, 28672, 4096)], (1,)),
    "8b_down_q4k": ([(_T.Q4_K, 4096, 14336)], (1,)),
    "8b_down_q6k": ([(_T.Q6_K, 4096, 14336)], (1,)),
    "8b_head_q6k": ([(_T.Q6_K, 129024, 4096)], (1,)),
    # Llama-3-8B IQ4_XS: the Q5_K wv and down (layers 0-3)
    "iq4xs_wv_q5k": ([(_T.Q5_K, 1024, 4096)], (1,)),
    "iq4xs_down_q5k": ([(_T.Q5_K, 4096, 14336)], (1,)),
    # Mixtral-8x7B Q5_K_M and IQ4_XS: Q5_K wq / wo, the Q6_K head (32000
    # lanes), the Q5_K gate / up and Q5_K / Q6_K down expert stacks (K5)
    "mixtral_wq_q5k": ([(_T.Q5_K, 4096, 4096)], (1,)),
    "mixtral_head_q6k": ([(_T.Q6_K, 32256, 4096)], (1,)),
    "mixtral_gate_q5k": ([(_T.Q5_K, 14336, 4096)], (2, 16)),
    "mixtral_down_q5k": ([(_T.Q5_K, 4096, 14336)], (2, 16)),
    "mixtral_down_q6k": ([(_T.Q6_K, 4096, 14336)], (2, 16)),
    # Llama-3-8B IQ3_XXS: IQ2_S wqk + Q4_K wv (K2; apart at the bucket),
    # IQ3_S wo, IQ3_XXS gate_up and down, the Q5_K head
    "iq3_wqk_wv": ([(_T.IQ2_S, 5120, 4096), (_T.Q4_K, 1024, 4096)], (1,)),
    "iq3_wqk": ([(_T.IQ2_S, 5120, 4096)], (1,)),
    "iq3_wv_q4k": ([(_T.Q4_K, 1024, 4096)], (1,)),
    "iq3_wo": ([(_T.IQ3_S, 4096, 4096)], (1,)),
    "iq3_gate_up": ([(_T.IQ3_XXS, 28672, 4096)], (1,)),
    "iq3_down": ([(_T.IQ3_XXS, 4096, 14336)], (1,)),
    "iq3_head_q5k": ([(_T.Q5_K, 129024, 4096)], (1,)),
    # Mixtral-8x7B IQ3_XXS: IQ2_S wq, the Q5_K head, IQ3_XXS stacks (K5)
    "mixtral_iq3_wq": ([(_T.IQ2_S, 4096, 4096)], (1,)),
    "mixtral_iq3_head_q5k": ([(_T.Q5_K, 32256, 4096)], (1,)),
    "mixtral_gate_iq3": ([(_T.IQ3_XXS, 14336, 4096)], (2, 16)),
    "mixtral_down_iq3": ([(_T.IQ3_XXS, 4096, 14336)], (2, 16)),
}


class _Planes:
    """What kernels.gemv_geo reads of a t-plane set, without its bytes: a
    stored bias plane exactly where the type is asymmetric (the offset
    types derive theirs, the coded ones have none)."""

    def __init__(self, qtype, k):
        from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS

        self.cfg = QCONFIGS[qtype]
        self.k = k
        self.fb = object() if self.cfg.asym in ("min", "minsb") else None


@pytest.mark.parametrize("qtype", sorted({t for planes, _ in _GEMV_LAUNCHES.values()
                                          for t, _, _ in planes}, key=int),
                         ids=lambda t: t.name)
def test_gemv_geometry_of_real_planes(qtype):
    """The geometry the picker reads (unit rows, low parts, groups a unit
    row, chunks, bias plane) is that of planes built here at a small K."""
    from ggml_hexagon_tpu_torch.ops.qmm_qp8 import _pack_bits

    g = torch.Generator()
    g.manual_seed(int(qtype))
    qt = random_qtensor(g, 256, 1024, qtype, "cpu").with_fast_planes("t")
    assert qt.fl == "t"
    geo = kernels.gemv_geo(qt)
    assert geo == kernels.gemv_geo(_Planes(qtype, 1024))
    bl, bh = _pack_bits(qt.cfg)
    assert geo.U == 1024 * (bh or bl) // 8 and geo.nchunks * qt.cfg.gs == geo.U
    assert geo.E * geo.U == 1024 and geo.nl * geo.U == 1024 * bl // 8
    assert qt.fq.shape[0] == (geo.nl + bool(bh)) * geo.U


def _gemv_boxes(geo, cols):
    """The TMA boxes of a ring stage (csrc/qp8_gemv.cu make_maps), as (dims
    innermost first, element bytes): the low parts, the scales, the high
    rows and the bias where the planes have them."""
    boxes = [((cols, geo.gs, geo.nl), 1), ((cols, 1, geo.E), 2)]
    if geo.bh:
        boxes.append(((cols, geo.gs), 1))
    if geo.fb:
        boxes.append(((cols, 1, geo.E), 2))
    return boxes


def _check_gemv_plan(planes, nb, rows_z):
    geos = tuple(kernels.gemv_geo(_Planes(t, k)) for t, _, k in planes)
    n2s = tuple(n for _, n, _ in planes)
    plan = kernels.pick_gemv(geos, n2s, nb, rows_z, H100_SMS)
    # column tiles cover every plane's lanes exactly
    assert plan.cols in (128, 256)
    assert all(n % plan.cols == 0 for n in n2s)
    # every split is a whole number of unit chunks, none empty (the
    # kernel's split: chunks [y * n / ks, (y + 1) * n / ks) of block row y)
    for geo in geos:
        assert 1 <= plan.ks <= geo.nchunks
        ends = [y * geo.nchunks // plan.ks * geo.gs for y in range(plan.ks + 1)]
        assert ends[0] == 0 and ends[-1] == geo.U
        assert all(e % geo.gs == 0 for e in ends)
        assert all(b > a for a, b in zip(ends, ends[1:]))
    # the ring, the activation and the sums fit the block's shared memory,
    # and per_sm blocks fit an SM
    sb = max(kernels.gemv_stage(g, plan.cols)[0] for g in geos)
    slots = max(kernels.gemv_slots(g, plan.ks) for g in geos)
    assert plan.smem == kernels.gemv_smem(nb, sb, plan.ns, slots)
    assert plan.smem <= kernels.SMEM_BLOCK == 227 * 1024
    assert plan.per_sm in (1, 2)
    assert plan.per_sm * (plan.smem + 1024) <= kernels.SMEM_SM
    assert plan.ns * sb <= plan.smem
    # teams at work: no more than the block has, and a round's stages fit
    # the ring when the block has more stages than it
    teams = 128 * kernels.gemv_cols_per_thread(nb) // plan.cols
    assert 1 <= plan.nteam <= teams
    per = max(-(-g.nchunks // plan.ks) for g in geos)
    assert plan.ns >= min(2, per)
    if per > plan.ns:
        assert plan.nteam <= (plan.ns - 1) * min(g.items for g in geos)
    # legal TMA boxes: inner bytes a multiple of 16, every dim 1..256, no
    # dim past the tensor's
    for geo in geos:
        for dims, elem in _gemv_boxes(geo, plan.cols):
            assert dims[0] * elem % 16 == 0
            assert all(1 <= d <= 256 for d in dims)
        assert geo.gs <= geo.U and plan.cols <= min(n2s)
    return plan


@pytest.mark.parametrize("name", list(_GEMV_LAUNCHES))
def test_gemv_plans_fit_at_every_batch(sms, name):
    """Every launch shape picks a legal plan at 1..8 rows (K5: its P rows)."""
    planes, rows = _GEMV_LAUNCHES[name]
    if rows == (1,):
        for nb in range(1, 9):
            _check_gemv_plan(planes, nb, 1)
    else:
        for p in rows:
            _check_gemv_plan(planes, 1, p)


@pytest.mark.parametrize("name", [n for n, (_, r) in _GEMV_LAUNCHES.items()
                                  if r == (1,)])
def test_gemv_decode_plans_take_two_blocks_an_sm(sms, name):
    """At one row every launch of the decode step keeps two blocks an SM
    (eight consumer warps), two or more chunks a split."""
    planes, _ = _GEMV_LAUNCHES[name]
    plan = _check_gemv_plan(planes, 1, 1)
    assert plan.per_sm == 2
    for t, _, k in planes:
        geo = kernels.gemv_geo(_Planes(t, k))
        assert geo.nchunks // plan.ks >= 2


def test_gemv_plan_splits_whole_chunks_on_a_ragged_count(sms):
    """wqkv's 64 unit chunks over 11 splits: blocks of 5 and 6 chunks."""
    geo = kernels.gemv_geo(_Planes(_T.Q4_K, 4096))
    assert geo.nchunks == 64
    sizes = [(y + 1) * 64 // 11 - y * 64 // 11 for y in range(11)]
    assert sorted(set(sizes)) == [5, 6] and sum(sizes) == 64


def test_gemv_picker_needs_no_card():
    """The picker is pure Python: it runs here on the card's SM count."""
    geo = kernels.gemv_geo(_Planes(_T.Q4_K, 4096))
    plan = kernels.pick_gemv((geo,), (4096,), 1, 1, H100_SMS)
    assert plan == kernels.pick_gemv((geo,), (4096,), 1, 1, H100_SMS)
    assert isinstance(plan, kernels.GemvPlan)


# ---------------------------------------------------------------------------
# K6 at B <= 8 and K8 (csrc/fast_il.cu): the picker of splits, ring and
# persistent blocks
# ---------------------------------------------------------------------------

#: every K6 (B <= 8) and K8 launch shape of the configurations that serve
#: interleaved planes: (type, rows, K), and the input rows a launch takes
#: (K6: 1..8; K8: P = 2 at decode, 16 at the 8-token bucket)
_IL_LAUNCHES = {
    # Llama-3-8B IQ4_XS: wqk, gate_up, wo, down (IQ4_XS)
    "iq4xs_wqk": ((_T.IQ4_XS, 5120, 4096), "k6"),
    "iq4xs_gate_up": ((_T.IQ4_XS, 28672, 4096), "k6"),
    "iq4xs_wo": ((_T.IQ4_XS, 4096, 4096), "k6"),
    "iq4xs_down": ((_T.IQ4_XS, 4096, 14336), "k6"),
    # Mixtral-8x7B IQ4_XS and the Q5_K_M / IQ3_XXS default layouts: wq
    # IQ4_XS, wk/wv Q8_0; the IQ4_XS expert stacks (K8)
    "mixtral_wq_iq4xs": ((_T.IQ4_XS, 4096, 4096), "k6"),
    "mixtral_wk_q8_0": ((_T.Q8_0, 1024, 4096), "k6"),
    "mixtral_gate_iq4xs": ((_T.IQ4_XS, 14336, 4096), "k8"),
    "mixtral_down_iq4xs": ((_T.IQ4_XS, 4096, 14336), "k8"),
    # Llama-3-8B Q4_K_M il (and il ffn): wqkv, wqk, wv Q6_K, gate_up, wo,
    # down Q4_K / Q6_K, the Q6_K head (129024 rows)
    "il_wqkv": ((_T.Q4_K, 6144, 4096), "k6"),
    "il_wqk": ((_T.Q4_K, 5120, 4096), "k6"),
    "il_wv_q6k": ((_T.Q6_K, 1024, 4096), "k6"),
    "il_gate_up": ((_T.Q4_K, 28672, 4096), "k6"),
    "il_wo": ((_T.Q4_K, 4096, 4096), "k6"),
    "il_down_q4k": ((_T.Q4_K, 4096, 14336), "k6"),
    "il_down_q6k": ((_T.Q6_K, 4096, 14336), "k6"),
    "il_head_q6k": ((_T.Q6_K, 129024, 4096), "k6"),
    # Mixtral-8x7B Q4_K_M il: wq Q4_K, wo Q5_K (stored bias), the Q6_K head
    # (32256 rows); Q4_K gate and down and Q6_K down stacks (K8)
    "mixtral_il_wq": ((_T.Q4_K, 4096, 4096), "k6"),
    "mixtral_il_wo_q5k": ((_T.Q5_K, 4096, 4096), "k6"),
    "mixtral_il_head_q6k": ((_T.Q6_K, 32256, 4096), "k6"),
    "mixtral_il_gate_q4k": ((_T.Q4_K, 14336, 4096), "k8"),
    "mixtral_il_down_q4k": ((_T.Q4_K, 4096, 14336), "k8"),
    "mixtral_il_down_q6k": ((_T.Q6_K, 4096, 14336), "k8"),
    # Llama-3-8B IQ3_XXS il: IQ2_S wqk, Q4_K wv, IQ3_S wo, IQ3_XXS gate_up
    # and down, the Q5_K head; iq1 and ternary alone
    "iq3_il_wqk": ((_T.IQ2_S, 5120, 4096), "k6"),
    "iq3_il_wv_q4k": ((_T.Q4_K, 1024, 4096), "k6"),
    "iq3_il_wo": ((_T.IQ3_S, 4096, 4096), "k6"),
    "iq3_il_gate_up": ((_T.IQ3_XXS, 28672, 4096), "k6"),
    "iq3_il_down": ((_T.IQ3_XXS, 4096, 14336), "k6"),
    "iq3_il_head_q5k": ((_T.Q5_K, 129024, 4096), "k6"),
    "iq1s": ((_T.IQ1_S, 1024, 4096), "k6"),
    "tq2": ((_T.TQ2_0, 1024, 4096), "k6"),
    # Mixtral-8x7B IQ3_XXS il: IQ2_S wq, the IQ3_XXS stacks (K8)
    "mixtral_iq3_il_wq": ((_T.IQ2_S, 4096, 4096), "k6"),
    "mixtral_iq3_il_gate": ((_T.IQ3_XXS, 14336, 4096), "k8"),
    "mixtral_iq3_il_down": ((_T.IQ3_XXS, 4096, 14336), "k8"),
}


def _il_kind(qtype):
    """(packed, stored fb, any bias) of interleaved planes of qtype."""
    from ggml_hexagon_tpu_torch.ops.qmm_fast import _family
    from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS

    cfg = QCONFIGS[qtype]
    fb = cfg.asym != "none"
    return _family(cfg) != "byte", fb, fb or bool(cfg.offset)


def _check_il_plan(qtype, rows, K, nb, tiles, rows_z, mode, sms):
    cfg_packed, fb, bias = _il_kind(qtype)
    from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS

    G = K // QCONFIGS[qtype].gs
    geo = kernels.il_geo(K, G, cfg_packed)
    # the stages cover the planes: residue blocks tile the groups (the
    # last one ragged past G), a stage's periods tile a residue block's,
    # every weight byte once
    assert (geo.nrb - 1) * geo.GW < G <= geo.nrb * geo.GW
    assert geo.GW == 128 or G % geo.GW == 0
    assert geo.nper % geo.NP == 0 and geo.spr * geo.NP == geo.nper
    assert geo.nper * G * (2 if cfg_packed else 1) == K
    assert geo.wb == geo.GW * geo.NP * kernels.IL_ROWS <= 16384
    plan = kernels.pick_il_gemv(K, G, cfg_packed, fb, bias, nb, tiles, rows_z,
                                mode, sms)
    # whole-stage splits, none empty, a legal ring, one wave of blocks
    assert 1 <= plan.ks <= min(geo.nst, 32)
    ends = [y * geo.nst // plan.ks for y in range(plan.ks + 1)]
    assert all(b > a for a, b in zip(ends, ends[1:]))
    assert 1 <= plan.ns <= 8 and 1 <= plan.nbx <= tiles
    assert plan.per_sm in (1, 2)
    assert plan.nbx * plan.ks * rows_z <= max(sms * plan.per_sm,
                                              plan.ks * rows_z)
    # the ring, the scales and the activation fit the block, per_sm blocks
    # an SM; the layout's parts as the kernel lays them out
    assert plan.smem == kernels.il_smem(geo, fb, bias, plan.ns, plan.ks,
                                        K // G, nb)
    assert plan.smem <= kernels.SMEM_BLOCK
    assert plan.per_sm * (plan.smem + 1024) <= kernels.SMEM_SM
    arb = kernels.il_touched(geo, plan.ks)
    assert plan.smem >= (plan.ns * geo.wb + 2 * geo.fsb * (2 if fb else 1)
                         + arb * (K // G) * nb * geo.GW * 2)
    # legal TMA boxes: weights (GW, NP, rows) bytes, scales (GW, rows) bf16
    for dims, elem in (((geo.GW, geo.NP, kernels.IL_ROWS), 1),
                       ((geo.GW, kernels.IL_ROWS), 2)):
        assert dims[0] * elem % 16 == 0 and all(1 <= d <= 256 for d in dims)
    return plan


@pytest.mark.parametrize("sm_count", [H100_SMS, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("name", list(_IL_LAUNCHES))
def test_il_gemv_plans_fit_every_served_shape(name, sm_count):
    """Every K6 (B <= 8, each mode) and K8 (P = 2, 16) launch of the served
    interleaved configurations gets a legal plan at 132 and 114 SMs."""
    (qtype, rows, K), kind = _IL_LAUNCHES[name]
    tiles = rows // kernels.IL_ROWS
    if kind == "k6":
        for nb in range(1, 9):
            for mode in range(4):
                _check_il_plan(qtype, rows, K, nb, tiles, 1, mode, sm_count)
    else:
        for p in (2, 16):
            _check_il_plan(qtype, rows, K, 1, tiles, p, 0, sm_count)


@pytest.mark.parametrize("name", ["il_gate_up", "iq4xs_gate_up",
                                  "il_head_q6k", "mixtral_il_gate_q4k"])
def test_il_gemv_wide_shapes_keep_k_whole(name):
    """Shapes with tiles for every block slot keep K whole (no split sums)
    and two blocks an SM at one row."""
    (qtype, rows, K), kind = _IL_LAUNCHES[name]
    rows_z = 2 if kind == "k8" else 1
    plan = _check_il_plan(qtype, rows, K, 1, rows // kernels.IL_ROWS, rows_z,
                          0, H100_SMS)
    assert plan.ks == 1 and plan.per_sm == 2


@pytest.mark.parametrize("K,G,packed", [(3072, 12, False), (2048, 256, True)])
def test_il_gemv_refuses_shapes_it_cannot_stage(K, G, packed):
    """No plan where G is not a multiple of 8 and the wrapper does not pad
    (byte planes of 12 groups) or a packed row's periods do not pair up in
    8s: the wrapper raises instead of falling back."""
    with pytest.raises(ValueError):
        kernels.il_geo(K, G, packed)
    with pytest.raises(ValueError):
        kernels.pick_il_gemv(K, G, packed, False, False, 1, 16, 1, 0,
                             H100_SMS)


@pytest.mark.parametrize("K,G,want", [(1024, 4, (2048, 8)),
                                      (11008, 43, (12288, 48))])
def test_il_gemv_pads_ternary_groups_to_eights(K, G, want):
    """Ternary at K = 1024 (G = 4) and K = 11008 (G = 43), groups of 256 on
    packed planes: the wrapper pads each period's groups to G' =
    8*ceil(G/8), whose geometry stages and plans at every row count and
    mode, as the GEMM's K % 64 and G' % 8 hold."""
    Kp, Gp = kernels.il_pad(K, G)
    assert (Kp, Gp) == want and Kp // Gp == K // G == 256
    with pytest.raises(ValueError):
        kernels.il_geo(K, G, True)
    geo = kernels.il_geo(Kp, Gp, True)
    assert geo.nper * Gp * 2 == Kp and geo.GW % 16 == 0
    assert Kp % 64 == 0 and Gp % 8 == 0
    for nb in (1, 8):
        for mode in range(4):
            plan = kernels.pick_il_gemv(Kp, Gp, True, False, False, nb, 64,
                                        1, mode, H100_SMS)
            assert plan.smem <= kernels.SMEM_BLOCK
    plan = kernels.pick_il_gemv(Kp, Gp, True, False, False, 1, 64, 16, 0,
                                H100_SMS)
    assert plan.smem <= kernels.SMEM_BLOCK


@pytest.mark.parametrize("qtype", [_T.TQ1_0, _T.TQ2_0], ids=lambda t: t.name)
@pytest.mark.parametrize("K", [1024, 11008])
def test_padded_ternary_planes_give_the_same_products(qtype, K):
    """The padded planes (zero codes' groups at zero scale) and the padded
    activations give K6's plain, pre-interleaved and act products and K8's
    gathered rows of the unpadded planes: the plain twins on both agree up
    to the f32 sums' order (every added product is an exact zero), and the
    padding is made once a tensor."""
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    g = torch.Generator()
    g.manual_seed(K + int(qtype))
    qt = random_qtensor(g, 128, K, qtype, "cpu").with_fast_planes("il")
    G = qt.fs.shape[1]
    assert qt.fl == "il" and G % 8
    pq = kernels.padded_il_planes(qt)
    assert kernels.padded_il_planes(qt) is pq
    assert (pq.k, pq.fs.shape[1]) == kernels.il_pad(K, G)
    assert pq.fq.shape == (qt.fq.shape[0], pq.k // 2)
    xs = torch.randn(3, 2 * K, generator=g).to(torch.bfloat16)
    for mode, x in ((0, xs[:, :K]), (3, xs[:, :K]), (2, xs)):
        kw = dict(act="silu") if mode == 2 else dict(pre_il=mode == 3)
        want = PF.fast_coded_plain(x, qt, **kw)
        _, xp, _, _ = kernels._pad_call(qt, x, None, None, mode)
        assert xp.shape[1] == (2 if mode == 2 else 1) * pq.k
        torch.testing.assert_close(PF.fast_coded_plain(xp, pq, **kw), want,
                                   rtol=1e-5, atol=1e-6)
    ids = torch.tensor([1, 0], dtype=torch.int32)
    want = PF.fast_indirect_plain(xs[:2, :K], qt, ids, 64)
    _, xp, _, _ = kernels._pad_call(qt, xs[:2, :K], None, None, 0)
    torch.testing.assert_close(PF.fast_indirect_plain(xp, pq, ids, 64), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sm_count", [H100_SMS, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("K,G,packed,gw", [(14336, 56, True, 16),
                                           (11008, 344, True, 128),
                                           (11008, 344, False, 128),
                                           (4096, 8, False, 16),
                                           (3072, 24, False, 16)])
def test_il_gemv_stages_groups_of_eight(K, G, packed, gw, sm_count):
    """G a multiple of 8 but not of 16 (ternary at K = 14336, groups of 32
    at K = 11008): residue blocks of gw with the last one ragged, whole
    periods a stage, and a plan that fits at every row count and mode."""
    geo = kernels.il_geo(K, G, packed)
    assert geo.GW == gw and (geo.nrb - 1) * geo.GW < G <= geo.nrb * geo.GW
    assert geo.nper % geo.NP == 0 and geo.spr * geo.NP == geo.nper
    assert geo.nper * G * (2 if packed else 1) == K
    # a stage's per-period boxes: GW bytes (a multiple of 16) x 64 rows,
    # from rows of G * nper bytes (a multiple of 16)
    assert geo.GW % 16 == 0 and geo.nper * G % 16 == 0
    for nb in (1, 8):
        for mode in range(3):
            plan = kernels.pick_il_gemv(K, G, packed, False, True, nb, 64, 1,
                                        mode, sm_count)
            assert plan.smem <= kernels.SMEM_BLOCK
            assert 1 <= plan.ks <= min(geo.nst, 32) and 1 <= plan.ns <= 8
    plan = kernels.pick_il_gemv(K, G, packed, False, False, 1, 3, 16, 0,
                                sm_count)
    assert plan.nbx <= 3 and plan.smem <= kernels.SMEM_BLOCK


@pytest.mark.parametrize("qtype", [_T.Q4_K, _T.Q6_K, _T.IQ4_XS, _T.IQ3_XXS,
                                   _T.TQ2_0], ids=lambda t: t.name)
def test_il_geometry_of_real_planes(qtype):
    """The stage geometry matches planes built here: a weight row is nper
    periods of G residues (K or K/2 bytes; ternary's G = 16 at K = 4096)."""
    g = torch.Generator()
    g.manual_seed(int(qtype))
    qt = random_qtensor(g, 128, 4096, qtype, "cpu").with_fast_planes("il")
    assert qt.fl == "il"
    packed, fb, _ = _il_kind(qtype)
    G = qt.fs.shape[1]
    geo = kernels.il_geo(qt.k, G, packed)
    assert qt.fq.shape[1] == geo.nper * G
    assert (qt.fb is not None) == fb


# ---------------------------------------------------------------------------
# K10 at B <= 8 (csrc/qmm_wire.cu wire_gemv_kernel): the picker of splits,
# ring and persistent blocks over the wire planes
# ---------------------------------------------------------------------------

#: the conformance phase's K10 shapes (rows, K, types): the Llama-3-8B wq,
#: gate, down and head, every type at 4096 x 4096, and the card tests'
#: edges (64 rows at K = 256 and 11008)
_WIRE_SHAPES = ([(4096, 4096, (_T.Q4_K,)), (14336, 4096, (_T.Q4_K,)),
                 (4096, 14336, (_T.Q6_K,)), (128256, 4096, (_T.Q6_K,))]
                + [(rows, K, tuple(sorted(QCONFIGS_T, key=int)))
                   for rows, K in ((4096, 4096), (64, 256), (64, 11008))])


def _wire_args(qtype, K):
    cfg = QCONFIGS_T[qtype]
    return (K, cfg.bits_lo, cfg.bits_hi, cfg.superblock, cfg.asym, cfg.gs)


def _wire_split_stages(geo, ks):
    """The stages [first, end) of each of ks splits, as the kernel cuts
    them (csrc/qmm_wire.cu wire_gemv_kernel: st0 = split * nst / ks)."""
    return [(y * geo.nst // ks, (y + 1) * geo.nst // ks) for y in range(ks)]


def _wire_columns(geo, first, end):
    """The columns a split of stages [first, end) takes: every run (s, r)
    of its high positions."""
    h = torch.arange(first * geo.HW, end * geo.HW)
    return torch.cat([s * geo.Kp + r * geo.Kph + h for s in range(geo.per)
                      for r in range(geo.R)])


@pytest.mark.parametrize("sm_count", [H100_SMS, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("shape", range(len(_WIRE_SHAPES)),
                         ids=lambda i: f"{_WIRE_SHAPES[i][0]}x{_WIRE_SHAPES[i][1]}")
def test_wire_gemv_plans_fit_every_conformance_shape(shape, sm_count):
    """Every K10 launch at B <= 8 of the conformance phase and the card
    tests gets a legal plan at 132 and 114 SMs: shared memory within a
    block's (and, two an SM, within half the SM's), whole stages a split,
    at most one wave of persistent blocks, and tile counters within the
    65536 of kernels._COUNTERS (the 128256-row head takes 2004)."""
    rows, K, types = _WIRE_SHAPES[shape]
    tiles = rows // kernels.WIRE_ROWS
    assert tiles <= 1 << 16
    for qtype in types:
        geo = kernels.wire_geo(*_wire_args(qtype, K))
        assert geo.nst * geo.HW == geo.Kph and geo.R * geo.Kph == geo.Kp
        assert geo.HW in (32, 64, 128) and geo.HW % 16 == 0
        for nb in (1, 2, 8):
            plan = kernels.pick_wire_gemv(*_wire_args(qtype, K), tiles, nb,
                                          sm_count)
            assert plan.smem <= kernels.SMEM_BLOCK
            assert plan.smem == kernels.wire_smem(geo, plan.ns, plan.ks, nb)
            if plan.per_sm == 2:
                assert plan.smem <= kernels.SMEM_SM // 2 - 1024
            assert 1 <= plan.ks <= min(geo.nst, 32) and 1 <= plan.ns <= 8
            assert 1 <= plan.nbx <= tiles
            assert plan.nbx * plan.ks <= sm_count * plan.per_sm


@pytest.mark.parametrize("qtype", [_T.Q5_K, _T.Q5_0, _T.Q6_K, _T.Q3_K,
                                   _T.Q4_K, _T.Q2_K, _T.Q8_0],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("K", [256, 4096, 11008, 14336])
def test_wire_gemv_splits_hold_whole_high_plane_periods(qtype, K):
    """A split's columns are every column of its high positions: the high
    byte of column c is c % Kph (4 low-plane bytes a high byte for Q5_0,
    Q5_1 and Q5_K, 2 for Q6_K and Q3_K), so no high byte is fetched by two
    splits, and the splits partition K."""
    cfg = QCONFIGS_T[qtype]
    geo = kernels.wire_geo(*_wire_args(qtype, K))
    if cfg.bits_hi:
        assert geo.R == {(4, 1): 4, (4, 2): 2, (2, 1): 2}[
            (cfg.bits_lo, cfg.bits_hi)]
    for ks in sorted({1, 2, 3, min(geo.nst, 32)}):
        if ks > geo.nst:
            continue
        seen = torch.zeros(K, dtype=torch.int64)
        high = []
        for first, end in _wire_split_stages(geo, ks):
            assert end > first
            cols = _wire_columns(geo, first, end)
            seen[cols] += 1
            high.append(set((cols % geo.Kph).tolist()))
        assert bool((seen == 1).all())
        assert sum(len(h) for h in high) == geo.Kph  # disjoint high bytes


def test_wire_gemv_at_the_8b_shapes():
    """The 8B's 4096-row shapes split K to cover the card; the head keeps
    K whole (2004 tiles fill every block slot)."""
    for rows, K, qtype in ((4096, 4096, _T.Q4_K), (4096, 14336, _T.Q6_K)):
        plan = kernels.pick_wire_gemv(*_wire_args(qtype, K), rows // 64, 1,
                                      H100_SMS)
        assert plan.ks > 1
    plan = kernels.pick_wire_gemv(*_wire_args(_T.Q6_K, 4096), 128256 // 64,
                                  1, H100_SMS)
    assert plan.ks == 1 and plan.nbx == H100_SMS * plan.per_sm


def test_wire_gemv_picker_needs_no_card():
    """The picker is pure Python: it runs here on the card's SM count."""
    args = _wire_args(_T.Q4_K, 4096)
    plan = kernels.pick_wire_gemv(*args, 64, 1, H100_SMS)
    assert plan == kernels.pick_wire_gemv(*args, 64, 1, H100_SMS)
    assert isinstance(plan, kernels.WirePlan)
