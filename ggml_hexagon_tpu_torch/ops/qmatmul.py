"""Wire-plane dequantization in plain PyTorch, and the quantized-matmul
dispatcher.

Counterpart of ggml_hexagon_tpu/ops/qmatmul.py:116-164 (`_unpack_plane`,
`_dequant_expr`, `dequantize_jax`) and :320-373 (`qmatmul`,
`qmatmul_normed`): the main path dequantizes the embedding-row gather here
(wire-less tensors reconstruct from their matmul planes) and routes every
quantized projection through `qmatmul`, or `qmatmul_normed` where the
RMSNorm folds into the matmul.
"""
from __future__ import annotations

import math

import torch

from ..quant.pack import QTensor
from .basic import rms_norm
from .qmm_fast import (MAX_FAST_BATCH, dequantize_fast, qmatmul_fast,
                       qmatmul_fast_normed, uninterleave_norm)
from .qmm_qp8 import KVALUES_IQ4NL, _unpack_rows, qp8_matmul


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


def qmatmul(x, qt: QTensor, out_dtype=torch.float32, plain=False):
    """Quantized matmul x [..., K] -> [..., n] over the matmul planes (the
    JAX dispatcher's fast-plane cases): t-planes go to qp8_matmul (K1 at
    <= 8 rows, K3 above), interleaved planes to qmatmul_fast (K6) for up
    to MAX_FAST_BATCH rows.  Anything else raises: the port has no
    wire-plane matmul."""
    if qt.fq is None:
        raise NotImplementedError("quantized weight without matmul planes")
    if qt.fl == "t":
        return qp8_matmul(x, qt, out_dtype=out_dtype, plain=plain)
    B = math.prod(x.shape[:-1])
    if B > MAX_FAST_BATCH:
        raise NotImplementedError(
            f"{B} rows on interleaved planes: the port's K6 takes "
            f"<= {MAX_FAST_BATCH}")
    return qmatmul_fast(x, qt, out_dtype=out_dtype, plain=plain)


def qmatmul_normed(x, qt: QTensor, wn_il, eps: float,
                   out_dtype=torch.float32, plain=False):
    """RMSNorm + quantized matmul: t-planes go to qp8_matmul_normed (K1's
    norm prologue at <= 8 rows, the norm then K3 above), interleaved planes
    to qmatmul_fast_normed (K6's normed mode) for up to MAX_FAST_BATCH
    rows; wn_il is the norm weight in the planes' column order
    (models/fuse.attach_norm_planes).  Above that the norm runs apart and
    `qmatmul` takes the rows."""
    B = math.prod(x.shape[:-1])
    if B <= MAX_FAST_BATCH:
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
