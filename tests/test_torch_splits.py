"""The host's tile and split choices for the wgmma GEMMs, K3 and K6 above
8 rows (token tile, K over blocks), and K4 (live cache slots over blocks):
pure functions of the shapes, so they run here without a card.  The
card's SM count is stubbed at the H100's 132."""
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.quant.formats import GGMLType

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
