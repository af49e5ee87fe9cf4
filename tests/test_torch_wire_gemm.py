"""K10 above 8 rows and in f32 (csrc/qmm_wire_gemm.cu, csrc/qmm_wire.cu):
the picker of token tile, K splits and ring, and a torch emulation of the
GEMM's walk of the wire planes, held against the plain twin here without a
card.

The emulation follows the kernel index by index: the pre-pass's order of x
(a stage's runs, permuted inside each 32-column chunk), each thread's 8
plane bytes a row and chunk (run s, position hh, the low box r and the high
bits' shift), each run's scale record (its group offset within the words
the producer copies), the decode's integer steps and f32 roundings, and
the wgmma fragments' k indices (bf16 k16 steps; TF32 k8 steps, each f32
operand split into big = rna(v) and small = rna(v - big), three products).
"""
import math

import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.ops import qmatmul as PQ
from ggml_hexagon_tpu_torch.quant.formats import GGMLType as _T
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS

H100_SMS = 132
NMSE_F32 = 1e-10  # K10 in f32 on the card (test_torch_kernels_gpu.py)
KVALUES_IQ4NL = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38,
                 53, 69, 89, 113)


def _args(qtype, K):
    cfg = QCONFIGS[qtype]
    return (K, cfg.bits_lo, cfg.bits_hi, cfg.superblock, cfg.asym, cfg.gs)


def _nmse(got, want):
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).mean() / ((want ** 2).mean() + 1e-30))


# ---------------------------------------------------------------------------
# the picker (pure Python on the card's SM count)
# ---------------------------------------------------------------------------

#: the 8B's K10 shapes (rows, K, type) and the card tests' edges
_GEMM_SHAPES = [(4096, 4096, _T.Q4_K), (14336, 4096, _T.Q4_K),
                (4096, 14336, _T.Q6_K), (128256, 4096, _T.Q6_K),
                (4096, 256, _T.Q2_K), (4096, 11008, _T.Q5_K),
                (192, 11008, _T.Q3_K), (4096, 14336, _T.IQ2_XS)]


@pytest.mark.parametrize("B", [9, 32, 33, 128, 129, 512, 513])
@pytest.mark.parametrize("shape", range(len(_GEMM_SHAPES)),
                         ids=lambda i: "{}x{}-{}".format(*_GEMM_SHAPES[i][:2],
                                                         _GEMM_SHAPES[i][2].name))
def test_wire_gemm_plans_fit_shared_memory(shape, B):
    """Every GEMM launch gets a token tile of its batch, whole stages of 64
    columns a split (at least 8 each), a ring that fits the block's 227 KB
    and tile counters within kernels._COUNTERS, in bf16 and f32."""
    rows, K, qtype = _GEMM_SHAPES[shape]
    n_pad = -(-rows // 128) * 128
    for f32 in (False, True):
        plan = kernels.pick_wire_gemm(*_args(qtype, K), n_pad, B, H100_SMS,
                                      f32)
        assert plan.N == (64 if f32 else 32 if B <= 32 else
                          128 if B <= 128 else 256)
        geo = kernels.wire_gemm_geo(*_args(qtype, K), plan.N, f32)
        assert geo.nst == K // 64 and geo.hw * geo.per == 64
        # a stage's hw positions divide a low box's row: no stage straddles
        # two boxes r
        assert geo.Kph % geo.hw == 0 and geo.R * geo.Kph == geo.Kp
        assert plan.smem == kernels.wire_gemm_smem(geo, plan.ns)
        assert plan.smem <= kernels.SMEM_BLOCK
        assert 1 <= plan.ns <= 8 and plan.ns <= -(-geo.nst // plan.ks)
        assert plan.ks == 1 or geo.nst // plan.ks >= 8
        assert plan.tiles == n_pad // 128 * -(-B // plan.N) <= 1 << 16


def test_wire_gemm_splits_where_tiles_leave_sms_idle():
    """The 8B's 4096-row wq gives 32 row tiles of 128: at B = 512 two token
    tiles, 64 blocks, so K splits in two; the 14336-row gate keeps K
    whole (224 blocks)."""
    wq = kernels.pick_wire_gemm(*_args(_T.Q4_K, 4096), 4096, 512, H100_SMS)
    gate = kernels.pick_wire_gemm(*_args(_T.Q4_K, 4096), 14336, 512, H100_SMS)
    assert (wq.N, wq.ks) == (256, 2) and (gate.N, gate.ks) == (256, 1)
    small = kernels.pick_wire_gemm(*_args(_T.Q4_K, 4096), 4096, 9, H100_SMS)
    assert small.N == 32 and small.ks >= 4


@pytest.mark.parametrize("nb", [1, 8])
@pytest.mark.parametrize("rows,K,qtype", [(4096, 4096, _T.Q4_K),
                                          (4096, 14336, _T.Q6_K),
                                          (64, 11008, _T.Q5_K)])
def test_wire_gemv_f32_plans_hold_f32_activations(rows, K, qtype, nb):
    """The f32 GEMV keeps its split's activation in f32: twice the bytes
    of bf16, still within a block's shared memory."""
    tiles = rows // kernels.WIRE_ROWS
    geo = kernels.wire_geo(*_args(qtype, K))
    plan = kernels.pick_wire_gemv(*_args(qtype, K), tiles, nb, H100_SMS, True)
    assert plan.smem == kernels.wire_smem(geo, plan.ns, plan.ks, nb, True)
    assert plan.smem <= kernels.SMEM_BLOCK
    lmax = -(-geo.nst // plan.ks) * geo.HW
    assert plan.smem > nb * geo.per * geo.R * (lmax * 4 + lmax // 32 * 16)


# ---------------------------------------------------------------------------
# the emulation of the GEMM's walk
# ---------------------------------------------------------------------------

def _perm_bf16(p):
    q = p & 31
    t, s, e = q >> 3, (q >> 2) & 1, q & 3
    return (p & ~31) + 16 * s + 2 * t + (e & 1) + 8 * (e >> 1)


def _perm_tf32(p):
    q = p & 31
    t, s, e = q >> 3, (q >> 1) & 3, q & 1
    return (p & ~31) + 8 * s + t + 4 * e


def tf32(x):
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    r = ((b + 0x1000) & ~0x1FFF)
    r = torch.where((b & 0x7F800000) == 0x7F800000, b, r)
    return r.view(torch.float32)


def split_tf32(x):
    big = tf32(x)
    return big, tf32(x - big)


def emulate_wire_gemm(x, qt, f32: bool):
    """The GEMM's result for x f32 [B, K] on qt's wire planes, walked as
    the kernel walks them; [B, n_pad] f64."""
    cfg = qt.cfg
    q, qh, d, sc, dmin, m = PQ._wire_planes(qt)
    K, n_pad, B = qt.k, q.shape[0], x.shape[0]
    bl, bh, gs = cfg.bits_lo, cfg.bits_hi, cfg.gs
    N = kernels.wire_gemm_tile(B, f32)
    geo = kernels.wire_gemm_geo(*_args(cfg.qtype, K), N, f32)
    per, Kp, Kph, R, hw = geo.per, geo.Kp, geo.Kph, geo.R, geo.hw
    nh = Kph // hw
    n, scw, nrec = kernels._wire_record(hw, gs, cfg.superblock, cfg.asym)
    lgs = int(math.log2(gs))
    perm = _perm_tf32 if f32 else _perm_bf16
    qb = q.view(torch.uint8).to(torch.int64)
    hb = qh.to(torch.int64) if bh else None
    beta = 128 if (cfg.signed or cfg.lut) else 0
    lut = torch.tensor(KVALUES_IQ4NL, dtype=torch.int64) + 128
    # the pre-pass and the weights, both at the k positions of the tiles
    xk = torch.zeros(B, K, dtype=torch.float32)
    wk = torch.zeros(n_pad, K, dtype=torch.float32)
    for st in range(geo.nst):
        r, h0 = st // nh, (st % nh) * hw
        for p in range(64):
            s, hh = p // hw, p % hw
            xk[:, st * 64 + perm(p)] = x[:, s * Kp + r * Kph + h0 + hh]
        for c in range(2):
            for t in range(4):
                s = 0 if per == 1 else c if per == 2 else 2 * c + (t >> 1)
                hh = 32 * c + 8 * t if per == 1 else 8 * t if per == 2 \
                    else 8 * (t & 1)
                assert hh + 8 <= hw
                lo = qb[:, r * Kph + h0 + hh:r * Kph + h0 + hh + 8]
                cs = s * Kp + r * Kph + h0
                g0, gl = cs >> lgs, (16 * (hh >> 4)) >> lgs if hw >= gs else 0
                if cfg.superblock:
                    # the record's sc bytes: the words from g0 // 4 on
                    w0, w1 = g0 >> 2, (g0 + n - 1) >> 2
                    bi = (g0 & 3) + gl
                    assert bi < 4 * (w1 - w0 + 1) and w1 - w0 + 1 <= scw
                    g = 4 * w0 + bi
                    scale = d[:, cs >> 8] * sc[:, g].to(torch.float32)
                    bias = (-dmin[:, cs >> 8] * m[:, g].to(torch.float32)
                            if cfg.asym == "minsb" else None)
                else:
                    assert gl < n and g0 + gl == (cs + hh) >> lgs
                    scale = d[:, g0 + gl]
                    bias = m[:, g0 + gl] if cfg.asym == "min" else None
                # the eight codes, as the prmt into 2^23 + u leaves them
                if cfg.signed:
                    u = lo ^ 0x80
                else:
                    u = (lo >> (bl * s)) & ((1 << bl) - 1)
                    if bh:
                        hi = hb[:, h0 + hh:h0 + hh + 8]
                        u = u | (((hi >> (bh * (s * R + r))) & ((1 << bh) - 1))
                                 << bl)
                    if cfg.lut:
                        u = lut[u]
                qv = (u - beta).to(torch.float32)
                if cfg.asym == "none":
                    w = (qv + float(cfg.offset)) * scale[:, None]
                else:
                    w = qv * scale[:, None] + bias[:, None]
                col = st * 64 + 32 * c + 8 * t
                for e in range(8):
                    wk[:, st * 64 + perm(32 * c + 8 * t + e)] = w[:, e]
                    assert 32 * c + 8 * t + e < 64 and col + e < K
    if not f32:
        xb = xk.to(torch.bfloat16).double()
        return xb @ wk.to(torch.bfloat16).double().t()
    (xb, xs), (wb, ws) = split_tf32(xk), split_tf32(wk)
    xb, xs, wb, ws = (v.double() for v in (xb, xs, wb, ws))
    return xs @ wb.t() + xb @ ws.t() + xb @ wb.t()


_EMU_TYPES = sorted(QCONFIGS, key=int)


@pytest.mark.parametrize("K", [256, 768])
@pytest.mark.parametrize("qtype", _EMU_TYPES, ids=lambda t: t.name)
def test_wire_gemm_walk_meets_the_plain_twin(qtype, K):
    """Every wire type's GEMM walk in bf16 (one token tile of 32, 192 rows:
    a ragged second row tile) lies within NMSE 1e-9 of qmm_wire_plain: the
    same bf16 weights and x, f32 sums in another order."""
    g = torch.Generator()
    g.manual_seed(int(qtype) * 7 + K)
    qt = random_qtensor(g, 150, K, qtype, "cpu")
    x = torch.randn(12, K, generator=g)
    got = emulate_wire_gemm(x, qt, False)
    want = PQ.qmm_wire_plain(x, qt, torch.bfloat16)
    assert _nmse(got, want) <= 1e-9


@pytest.mark.parametrize("qtype", [_T.Q4_K, _T.Q6_K, _T.Q5_1, _T.Q8_0,
                                   _T.IQ4_XS, _T.Q3_K, _T.Q2_K, _T.TQ2_0],
                         ids=lambda t: t.name)
def test_wire_gemm_tf32_split_meets_the_f32_contract(qtype):
    """In f32 the GEMM splits the decoded weight and x into TF32 big and
    small parts and sums three products: emulated bit for bit (cvt.rna),
    within NMSE 1e-10 of the plain twin's f32 product (the card's f32
    limit), which one TF32 product alone, or two, misses."""
    K = 512
    g = torch.Generator()
    g.manual_seed(int(qtype) + 11)
    qt = random_qtensor(g, 128, K, qtype, "cpu")
    x = torch.randn(9, K, generator=g)
    want = PQ.qmm_wire_plain(x, qt, torch.float32)
    got = emulate_wire_gemm(x, qt, True)
    assert _nmse(got, want) <= NMSE_F32
    (xb, _), (wb, ws) = split_tf32(x), split_tf32(PQ._dequant_expr(
        qt, torch.float32))
    one = xb.double() @ wb.double().t()
    two = one + xb.double() @ ws.double().t()
    assert _nmse(one, want) > NMSE_F32 and _nmse(two, want) > NMSE_F32
