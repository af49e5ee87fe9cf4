"""Wire-plane dequantization in plain PyTorch.

Counterpart of ggml_hexagon_tpu/ops/qmatmul.py:116-164 (`_unpack_plane`,
`_dequant_expr`, `dequantize_jax`): the main path uses it for the Q4_K
embedding-row gather; wire-less tensors reconstruct from their t-planes.
"""
from __future__ import annotations

import torch

from ..quant.pack import QTensor
from .qmm_qp8 import KVALUES_IQ4NL, _unpack_rows, dequantize_qp8


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
    """Whole-tensor dequantize; wire-less tensors use their t-planes."""
    if qt.q is None:
        return dequantize_qp8(qt, dtype)
    return _dequant_expr(qt, dtype)


def take_rows_wire(qt: QTensor, ids) -> QTensor:
    """The wire planes of rows `ids` (flat) as a standalone QTensor."""
    def g(a):
        return None if a is None else a.index_select(0, ids)

    return QTensor(qt.cfg, ids.numel(), qt.k, g(qt.q), g(qt.d), g(qt.qh),
                   g(qt.sc), g(qt.dmin), g(qt.m))
