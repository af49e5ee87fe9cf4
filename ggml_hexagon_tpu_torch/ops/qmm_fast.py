"""Interleaved-layout ("il") quantized matmul: plane building, the plain
version, and the wrapper over the CUDA kernel K6 (byte planes).

Counterpart of ggml_hexagon_tpu/ops/qmm_fast.py: `supports_fast` and
`build_fast_planes` (:120-242; `_int_values` and `_group_scale_bias` are
shared with ops/qmm_qp8.py), `_fast_ref` (:683-706), `_interleave_x`
(:721-734), `dequantize_fast` and `qmatmul_fast` (:817-869).  The
layout stores weight column j as original column (j % G)*gs + j//G, so
column j's scale is fs[:, j % G]:

  fq  int8 [n2, K]  interleaved integer values (rows padded to 512, or to
                    2048 from 65536 rows)
  fs  bf16 [n2, G]  per-group scales
  fb  bf16 [n2, G]  affine bias, or None (always None for Q8_0)

Numerics contract (qmm_fast.py:464-494, 768), held by the plain version
and the kernel alike: x is rounded to bf16; at B <= 8 each product is f32
x times the f32 weight q*scale, summed in f32; above 8 rows q*scale is
rounded to bf16 and the bf16 x bf16 products are summed in f32.

The port has the byte family only (Q8_0 and the IQ4 LUT types, whose
values fit int8).  The nibble kernel's planes (Q4_0/Q4_1/Q4_K when the JAX
package runs with GHT_QP8=0, coded i-quants at widths without a t-layout)
and byte planes with a group bias (Q5_0/Q5_1/Q4_1-class types at widths
without a t-layout) raise NotImplementedError: ROADMAP.md queue 2, K6
nibble.
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from ..quant.pack import QConfig, QTensor
from .qmm_qp8 import _group_scale_bias, _int_values, dequantize_qp8, qp8_matmul

#: the interleaved-layout entry serves up to this many rows
#: (ops/qmatmul.qmatmul routes larger batches elsewhere)
MAX_FAST_BATCH = 512
#: row quantum of the interleaved planes
_BN = 512


def _is_nibble(cfg: QConfig) -> bool:
    return (cfg.bits_lo == 4 and cfg.bits_hi == 0 and not cfg.signed
            and not cfg.lut and not cfg.expand)


def supports_fast(cfg: QConfig, k: int) -> bool:
    """True when (cfg, K) can build interleaved planes."""
    G = k // cfg.gs
    if G < 1 or k % cfg.gs:
        return False
    packed = _is_nibble(cfg) or bool(cfg.code_map)
    if packed and ((k // 2) % G or (k // 2) < G):
        return False
    if not packed and k % G:
        return False
    return G % 128 == 0 or G in (8, 16, 32, 64) or k % 128 == 0


def _no_nibble(cfg: QConfig):
    if _is_nibble(cfg) or cfg.code_map:
        raise NotImplementedError(
            f"{cfg.qtype.name}: packed 4-bit interleaved planes need K6's "
            "nibble kernel, not ported yet (ROADMAP.md queue 2)")


def build_fast_planes(qt: QTensor):
    """-> (fq, fs, fb) interleaved planes from the wire planes, or
    (None,)*3 when (cfg, K) has none.  Byte-equal to the JAX package's
    host build; runs on the wire planes' device."""
    cfg = qt.cfg
    K = qt.k
    if not supports_fast(cfg, K):
        return None, None, None
    _no_nibble(cfg)
    v = _int_values(qt)                                   # [n_pad, K]
    scale_g, bias_g = _group_scale_bias(qt)
    G = K // cfg.gs
    rows = v.shape[0]
    # the interleave is a [G, gs] transpose of each row
    fq = v.reshape(rows, G, cfg.gs).transpose(1, 2).reshape(rows, K).to(
        torch.int8)
    if cfg.offset and cfg.asym == "none":
        bias_g = None  # derivable as offset * scale
    quantum = 2048 if rows >= 65536 else _BN
    n2 = -(-rows // quantum) * quantum
    if n2 != rows:
        pad = (0, 0, 0, n2 - rows)
        fq = torch.nn.functional.pad(fq, pad)
        scale_g = torch.nn.functional.pad(scale_g, pad)
        if bias_g is not None:
            bias_g = torch.nn.functional.pad(bias_g, pad)
    fs = scale_g.to(torch.bfloat16).contiguous()
    fb = None if bias_g is None else bias_g.to(torch.bfloat16).contiguous()
    return fq.contiguous(), fs, fb


def _interleave_x(x2, G: int, gs: int):
    """Activation [B, K] into the planes' interleaved column order."""
    B, K = x2.shape
    return x2.reshape(B, G, gs).transpose(1, 2).reshape(B, K)


def dequantize_fast(qt: QTensor, dtype=torch.float32):
    """Dequantized [n2, K] matrix in the original column order from the
    planes of either layout."""
    if qt.fl == "t":
        return dequantize_qp8(qt, dtype)
    cfg = qt.cfg
    _no_nibble(cfg)
    K, gs = qt.k, cfg.gs
    G = K // gs
    v = qt.fq.to(torch.int32)
    if qt.fb is None and cfg.offset:
        v = v + int(cfg.offset)
    w_il = v.to(torch.float32) * qt.fs.to(torch.float32).repeat(1, gs)
    if qt.fb is not None:
        w_il = w_il + qt.fb.to(torch.float32).repeat(1, gs)
    rows = w_il.shape[0]
    # the inverse of the interleave is the opposite [gs, G] transpose
    return w_il.reshape(rows, gs, G).transpose(1, 2).reshape(rows, K).to(dtype)


def _byte_planes(qt: QTensor):
    """Raise unless qt carries bias-free interleaved byte planes."""
    if qt.fq is None or qt.fl != "il":
        raise ValueError("expected a weight with interleaved planes")
    _no_nibble(qt.cfg)
    if qt.fb is not None or qt.cfg.offset:
        raise NotImplementedError(
            f"{qt.cfg.qtype.name}: interleaved byte planes with a group bias "
            "are not ported yet (ROADMAP.md queue 2, K6)")


def fast_byte_plain(x, qt: QTensor):
    """Plain K6 (the JAX `_fast_ref` with the kernel's rounding): x bf16
    [B, K] in natural order -> y [B, n2] f32."""
    B, K = x.shape
    G = qt.fs.shape[1]
    x_il = _interleave_x(x.to(torch.bfloat16), G, K // G).to(torch.float32)
    sc = qt.fs.repeat(1, K // G)                     # bf16 [n2, K]: fs[:, j % G]
    if B <= 8:
        w = qt.fq.to(torch.float32) * sc.to(torch.float32)
    else:
        w = (qt.fq.to(torch.bfloat16) * sc).to(torch.float32)
    return x_il @ w.t()


def fast_byte(x, qt: QTensor):
    """K6: the kernel for CUDA tensors, the plain version for CPU ones."""
    if not x.is_cuda:
        return fast_byte_plain(x, qt)
    return kernels.fast_byte(x, qt)


def qmatmul_fast(x, qt: QTensor, out_dtype=torch.float32, plain=False):
    """y = x @ dequant(qt).T over the matmul planes: the t-layout goes to
    qp8_matmul (K1/K3), the interleaved layout to K6."""
    if qt.fl == "t":
        return qp8_matmul(x, qt, out_dtype=out_dtype, plain=plain)
    _byte_planes(qt)
    if x.shape[-1] != qt.k:
        raise ValueError(f"x width {x.shape[-1]} vs weight K={qt.k}")
    lead = x.shape[:-1]
    B = math.prod(lead) if lead else 1
    x2 = x.reshape(B, qt.k).to(torch.bfloat16).contiguous()
    y = (fast_byte_plain if plain else fast_byte)(x2, qt)
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)
