"""Wire-plane dequantization, the wire-plane matmul (K10) and the
quantized-matmul dispatcher.

Counterpart of ggml_hexagon_tpu/ops/qmatmul.py: the q8 activation parity
mode (:36-110, `q8_act_kind`, `quantize_act_ref`, `GHT_Q8_ACT`), the wire
dequant (:116-164, `_dequant_expr`, `dequantize_jax`), the XLA matmul
(:167-182, `qmatmul_xla`, here plain PyTorch), the whole-K Pallas matmul
over the wire planes (:203-310, `_qmm_kernel` behind `qmatmul_pallas`,
here K10: csrc/qmm_wire.cu beside its plain twin) and the dispatcher
(:320-373, `qmatmul`, `qmatmul_normed`).  The main path dequantizes the
embedding-row gather here (wire-less tensors reconstruct from their matmul
planes) and routes every quantized projection through `qmatmul`, or
`qmatmul_normed` where the RMSNorm folds into the matmul.
"""
from __future__ import annotations

import math
import os

import torch

from .. import kernels
from ..quant.pack import QConfig, QTensor
from .basic import rms_norm
from .qmm_fast import (MAX_FAST_BATCH, dequantize_fast, qmatmul_fast,
                       qmatmul_fast_normed, uninterleave_norm)
from .qmm_qp8 import KVALUES_IQ4NL, _unpack_rows, qp8_matmul


# ---------------------------------------------------------------------------
# q8 activation quantization (opt-in parity mode, GHT_Q8_ACT=1)
#
# llama.cpp's CPU backend quantizes each activation row to the weight
# type's vec_dot_type (Q8_0 / Q8_1 / Q8_K) before an integer dot; the
# default contract here is exact f32.  This mode reproduces the reference's
# activation rounding (quantize_row_q8_{0,K}_ref) and contracts the
# dequantized q8 rows in f32, so perplexity parity runs differ from the
# reference by summation order only.
# ---------------------------------------------------------------------------

def q8_act_kind(cfg: QConfig) -> str:
    """Weight type -> activation quant format (the vec_dot_type column of
    llama.cpp's type_traits_cpu)."""
    if cfg.lut:
        return "q8_0"  # IQ4_NL
    if cfg.superblock or cfg.code_map or cfg.gs >= 256:
        return "q8_K"  # K-quants, i-quants, ternary
    if cfg.asym == "min":
        return "q8_1"  # Q4_1 / Q5_1
    return "q8_0"      # Q4_0 / Q5_0 / Q8_0


def _roundf_away(v):
    """C roundf: round half away from zero."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def quantize_act_ref(x, kind: str):
    """Quantize-dequantize activation rows as the reference's on-the-fly
    activation quantizers do; returns f32 of x's shape.

    q8_0/q8_1: per-32 block, d = fp16(amax/127), q = roundf(x * 127/amax),
    dequantized with the fp16-rounded d.  q8_K: per-256 block, iscale =
    -127/max (max the SIGNED value of largest magnitude, the first on
    ties), q = min(127, nearest_int(iscale*x)) rounding half to even,
    d = 1/iscale."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    xf = x.to(torch.float32)
    if kind in ("q8_0", "q8_1"):
        QK = 32
        if K % QK:
            raise ValueError(f"row {K} not divisible by {QK}")
        xb = xf.reshape(*lead, K // QK, QK)
        amax = xb.abs().amax(dim=-1, keepdim=True)
        d = (amax / 127.0).to(torch.float16).to(torch.float32)
        # a true division: `127.0 / amax` multiplies by a reciprocal in
        # PyTorch, one rounding off
        iscale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                             torch.zeros_like(amax))
        q = _roundf_away(xb * iscale)
        return (q * d).reshape(*lead, K)
    if kind != "q8_K":
        raise ValueError(f"activation format {kind!r}")
    QK = 256
    if K % QK:
        raise ValueError(f"row {K} not divisible by {QK}")
    xb = xf.reshape(*lead, K // QK, QK)
    ab = xb.abs()
    amax = ab.amax(dim=-1, keepdim=True)
    idx = torch.argmax(ab, dim=-1, keepdim=True)
    smax = torch.gather(xb, -1, idx)  # signed extreme
    zero = torch.zeros_like(amax)
    iscale = torch.where(amax > 0, torch.full_like(smax, -127.0) / smax, zero)
    q = torch.clamp_max(torch.round(xb * iscale), 127.0)
    d = torch.where(amax > 0, torch.full_like(iscale, 1.0) / iscale, zero)
    return (q * d).reshape(*lead, K)


def _q8_act_enabled() -> bool:
    return os.environ.get("GHT_Q8_ACT", "") not in ("", "0")


def _dequant_expr(qt: QTensor, dtype):
    """Dequantized weight [n_pad, K], computed in f32 then cast."""
    cfg = qt.cfg
    if cfg.signed:
        q = qt.q.to(torch.float32)
    else:
        q = _unpack_rows(qt.q, cfg.bits_lo)
        if cfg.bits_hi:
            q = q + (_unpack_rows(qt.qh, cfg.bits_hi) << cfg.bits_lo)
        if cfg.lut:
            lut = torch.tensor(KVALUES_IQ4NL, dtype=torch.int32,
                               device=q.device)
            q = lut[q.long()]
        q = q.to(torch.float32)
    if cfg.superblock:
        scale_g = (torch.repeat_interleave(qt.d, 256 // cfg.gs, dim=1)
                   * qt.sc.to(torch.float32))
    else:
        scale_g = qt.d
    scale = torch.repeat_interleave(scale_g, cfg.gs, dim=1)
    if cfg.asym == "minsb":
        bias_g = (-torch.repeat_interleave(qt.dmin, 256 // cfg.gs, dim=1)
                  * qt.m.to(torch.float32))
        w = q * scale + torch.repeat_interleave(bias_g, cfg.gs, dim=1)
    elif cfg.asym == "min":
        w = q * scale + torch.repeat_interleave(qt.m, cfg.gs, dim=1)
    elif cfg.offset:
        w = (q + float(cfg.offset)) * scale
    else:
        w = q * scale
    return w.to(dtype)


def dequantize(qt: QTensor, dtype=torch.float32):
    """Whole-tensor dequantize; wire-less tensors use their matmul
    planes."""
    if qt.q is None:
        return dequantize_fast(qt, dtype)
    return _dequant_expr(qt, dtype)


def _contract(x, w, compute_dtype):
    """x [..., K] @ w [n, K].T with both operands rounded to
    compute_dtype and the products summed in f32 (XLA's dot_general with
    preferred_element_type=f32; a bf16 torch.matmul would round the sum to
    bf16)."""
    xc = x.to(compute_dtype).to(torch.float32)
    return torch.matmul(xc, w.to(compute_dtype).to(torch.float32).t())


def qmatmul_xla(x, qt: QTensor, out_dtype=torch.float32,
                compute_dtype=torch.bfloat16):
    """y = x @ dequant(qt).T: the weight dequantized in compute_dtype (from
    the matmul planes when the wire is gone), the product summed in f32.
    Under GHT_Q8_ACT=1 the activation takes the reference's q8 rounding
    first and the contraction runs in f32."""
    if x.shape[-1] != qt.k:
        raise ValueError(f"x K={x.shape[-1]} vs weight K={qt.k}")
    if _q8_act_enabled():
        x = quantize_act_ref(x, q8_act_kind(qt.cfg))
        compute_dtype = torch.float32
    y = _contract(x, dequantize(qt, compute_dtype), compute_dtype)
    return y[..., :qt.n].to(out_dtype)


def _wire_planes(qt: QTensor):
    """The wire planes of qt in the dtypes K10 reads: q uint8 (int8 for a
    signed type), qh uint8, d f32, sc int8, dmin f32, m uint8 (minsb) or
    f32 (min).  The sources differ (m is uint8 from synth, int32 from other
    plane sources), so the integer planes are normalised here."""
    cfg = qt.cfg
    if qt.q is None:
        raise ValueError("K10 reads the wire planes; this tensor has none")

    def as_(t, dtype):
        return None if t is None else t.to(dtype).contiguous()

    m_dtype = torch.float32 if cfg.asym == "min" else torch.uint8
    return (as_(qt.q, torch.int8 if cfg.signed else torch.uint8),
            as_(qt.qh, torch.uint8), as_(qt.d, torch.float32),
            as_(qt.sc, torch.int8), as_(qt.dmin, torch.float32),
            as_(qt.m, m_dtype))


def qmm_wire_plain(x2, qt: QTensor, compute_dtype=torch.bfloat16):
    """Plain K10 (`_qmm_kernel`'s arithmetic): the weight dequantized in
    f32 from the wire planes, both operands rounded to compute_dtype, the
    products summed in f32 -> [B, n_pad] f32.  The IQ4 types take their
    LUT values, as the wire dequant does (the JAX kernel contracts their
    raw 4-bit codes)."""
    return _contract(x2, _dequant_expr(qt, torch.float32), compute_dtype)


def qmatmul_pallas(x, qt: QTensor, out_dtype=torch.float32,
                   compute_dtype=torch.bfloat16, plain=False):
    """K10: the whole-K dequant x matmul over the wire planes of any
    QConfig, x [..., K] -> [..., n].  compute_dtype is bf16 or f32; the
    rows run as given (the JAX entry pads them to 8 for the TPU).  CPU
    tensors (or plain=True) take the plain twin, CUDA tensors the
    kernel."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    if K != qt.k:
        raise ValueError(f"x K={K} vs weight K={qt.k}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute dtype {compute_dtype}: K10 takes bf16 "
                         "or f32")
    x2 = x.reshape(-1, K)
    if plain or not x2.is_cuda:
        y = qmm_wire_plain(x2, qt, compute_dtype)
    else:
        y = kernels.qmm_wire(x2.to(torch.float32).contiguous(), qt.cfg,
                             _wire_planes(qt), qt.k, compute_dtype)
    return y[:, :qt.n].to(out_dtype).reshape(*lead, qt.n)


def _takes_planes(x, qt: QTensor) -> bool:
    """The JAX dispatcher's gate (ops/qmatmul.py:336-337, :365-366): the
    matmul planes serve up to MAX_FAST_BATCH rows, and any count once the
    wire planes are gone."""
    B = math.prod(x.shape[:-1])
    return qt.fq is not None and (B <= MAX_FAST_BATCH or qt.q is None)


def qmatmul(x, qt: QTensor, out_dtype=torch.float32,
            compute_dtype=torch.bfloat16, backend: str = "auto",
            plain=False):
    """Quantized matmul x [..., K] -> [..., n].

    backend "auto" routes as the JAX dispatcher does: a weight with matmul
    planes takes them (t-planes: qp8_matmul, K1 at <= 8 rows and K3 above;
    interleaved planes: K6, its GEMV at <= 8 rows and its GEMM above) at up
    to MAX_FAST_BATCH rows, and at any count when its wire planes are gone;
    a weight without matmul planes, or more rows on a weight that keeps its
    wire, takes qmatmul_xla.  "fast", "pallas" (K10) and "xla" pick a route
    outright."""
    if backend == "auto":
        if not _takes_planes(x, qt):
            return qmatmul_xla(x, qt, out_dtype, compute_dtype)
        if qt.fl == "t":
            return qp8_matmul(x, qt, out_dtype=out_dtype, plain=plain)
        return qmatmul_fast(x, qt, out_dtype=out_dtype, plain=plain)
    if backend == "fast":
        return qmatmul_fast(x, qt, out_dtype=out_dtype, plain=plain)
    if backend == "pallas":
        return qmatmul_pallas(x, qt, out_dtype, compute_dtype, plain=plain)
    if backend == "xla":
        return qmatmul_xla(x, qt, out_dtype, compute_dtype)
    raise ValueError(f"backend {backend!r}")


def qmatmul_normed(x, qt: QTensor, wn_il, eps: float,
                   out_dtype=torch.float32, plain=False):
    """RMSNorm + quantized matmul: t-planes go to qp8_matmul_normed (K1's
    norm prologue at <= 8 rows, the norm then K3 above), interleaved planes
    to qmatmul_fast_normed (K6's normed mode) where `qmatmul` would take
    the planes (up to MAX_FAST_BATCH rows, any count without wire); wn_il
    is the norm weight in the planes' column order
    (models/fuse.attach_norm_planes).  Elsewhere the norm runs apart and
    `qmatmul` takes the rows."""
    B = math.prod(x.shape[:-1])
    if B <= MAX_FAST_BATCH or _takes_planes(x, qt):
        return qmatmul_fast_normed(x, qt, wn_il, eps, out_dtype=out_dtype,
                                   plain=plain)
    wn = wn_il if qt.fl == "t" else uninterleave_norm(wn_il, qt.cfg.gs)
    return qmatmul(rms_norm(x, wn, eps), qt, out_dtype=out_dtype, plain=plain)


def take_rows_wire(qt: QTensor, ids) -> QTensor:
    """The wire planes of rows `ids` (flat) as a standalone QTensor."""
    def g(a):
        return None if a is None else a.index_select(0, ids)

    return QTensor(qt.cfg, ids.numel(), qt.k, g(qt.q), g(qt.d), g(qt.qh),
                   g(qt.sc), g(qt.dmin), g(qt.m))
