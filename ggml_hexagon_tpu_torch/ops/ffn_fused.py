"""The whole-FFN megakernel (K9): wo + residual -> RMSNorm -> gate_up ->
act(gate)*up (silu, gelu or relu) -> down + residual in one launch, for the rows of a decode
step (B <= 8).

Counterpart of ggml_hexagon_tpu/ops/ffn_fused.py: `supports_ffn_fused`
(:175-200), the arithmetic of `_ffn_kernel` (:93-172, with `_phase_dot`
:50-82 and `_side_bias` :84-87) as `ffn_fused_plain`, and the entry
`ffn_fused` (:275-312).  The CUDA kernel is csrc/ffn_fused.cu, bound by
kernels.ffn_fused.

Layout contract (models/fuse.attach_ffn_fused_layout): the output rows of
wo and ffn_down are permuted by interleave_perm(d, 32), so the hidden state
flows through the three phases in the il32 column order that gate_up's
interleaved planes consume; gate_up is w_gateup_il (its rows in ffn_down's
interleaved column order); wn_il is the ffn norm weight in that order.

Numerics, the TPU kernel's (every step below is what `ffn_fused_plain`
does and what the kernel does, up to the order of f32 sums and the last
ulp of rsqrt and exp):

  phase A  h2 = x_a @ wo'^T + xg_a @ fb^T + h_il, f32: x_a the bf16
           attention output interleaved, xg_a the group sums of the f32
           attention output, h_il the f32 residual interleaved
  phase B  inv = rsqrt(mean(h2^2) + eps); xb = h2 * inv * wn_il in f32,
           stored as bf16; xg_b the lane-aligned group sums of the f32 xb
           (column r*G + g in group g); gu = xb @ gate_up'^T + xg_b @ fb^T
  phase C  xd = bf16(act(gate) * up), in f32 (ops.basic.act_f32); out = xd @ down'^T + bias +
           h2, the bias xs @ bf16(tile(fb)) (stored fb) or off * (xs @
           bf16(tile(fs))) (Q6_K -32, Q4_0 -8), xs = bf16(xd[:, :K/2] +
           xd[:, K/2:]) on nibble and coded planes, xd on byte planes; coded
           down planes carry no bias
  dots     nibble and coded weights bf16(q * scale), byte weights at these
           rows f32(q) * f32(scale) against the f32 activation; products
           summed in f32 (ops/qmm_fast._body_plain)

The JAX entry pads the rows to 8, the TPU's sublane tile; every phase is
row-independent (each row its own norm and group sums), so the port runs
the B rows it is given.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..quant.pack import QTensor
from .basic import act_f32
from .qmm_fast import (_body_plain, _interleave_x, _is_nibble,
                       _is_packed, _offset_bias, _sums_il, _sums_natural,
                       supports_fused_epilogue, uninterleave_cols)

#: rows one launch takes (the rows of a decode step)
MAX_ROWS = 8


def supports_ffn_fused(wo, gu_il, dn, d: int, n_ff: int) -> bool:
    """Whether a layer's wo, gate_up (w_gateup_il) and ffn_down can run as
    one K9 launch: interleaved planes with a full-K decode blocking on all
    three; nibble wo and gate_up, each with a stored fb (their bias side
    dots take group sums); G = d/gs lane-aligned (G % 128 == 0) and the
    same gs on both; the JAX kernel's block sizes (d % 512, 2*n_ff %
    1024); exact n and k and unpadded rows on all three."""
    for qt in (wo, gu_il, dn):
        if not (isinstance(qt, QTensor) and qt.fq is not None
                and qt.fl == "il" and supports_fused_epilogue(qt)):
            return False
    if not (_is_nibble(wo.cfg) and _is_nibble(gu_il.cfg)):
        return False
    if wo.fb is None or gu_il.fb is None:
        return False
    G = d // wo.cfg.gs
    if d % G or G % 128 or wo.cfg.gs != gu_il.cfg.gs:
        return False
    if d % 512 or (2 * n_ff) % 1024:
        return False
    if wo.n != d or wo.k != d or gu_il.k != d or gu_il.n != 2 * n_ff:
        return False
    if dn.k != n_ff or dn.n != d:
        return False
    return (wo.fq.shape[0] == d and gu_il.fq.shape[0] == 2 * n_ff
            and dn.fq.shape[0] == d)


def _check_act(act: str):
    """Phase B's activations: silu, gelu and relu (JAX `_ffn_kernel`'s
    `_act`)."""
    if act not in kernels.ACT_IDS:
        raise NotImplementedError(f"act {act!r}: K9 takes "
                                  f"{tuple(kernels.ACT_IDS)}")


def ffn_fused_plain(x_a, xg_a, h_il, wn_il, wo: QTensor, gu_il: QTensor,
                    dn: QTensor, eps: float, act: str = "silu"):
    """Plain K9: x_a bf16 [B, d] (the attention output in wo's interleaved
    order), xg_a f32 [B, G] (its group sums, from the f32 values), h_il f32
    [B, d] (the residual, interleaved), wn_il f32 [d] -> the layer output
    f32 [B, d] in the il32 order of the permuted rows."""
    _check_act(act)
    G = wo.fs.shape[1]
    n_ff = dn.k
    # phase A: wo + its side bias + the residual
    y = _body_plain(x_a, wo.fq, wo.fs, wo.cfg)
    y = y + xg_a @ wo.fb.to(torch.float32).t()
    h2 = y + h_il
    # phase B: the norm, its group sums, gate_up + its side bias
    inv = torch.rsqrt(torch.mean(h2 * h2, dim=1, keepdim=True) + eps)
    xb = h2 * inv * wn_il.to(torch.float32)
    xg_b = _sums_il(xb, G)
    gu = _body_plain(xb.to(torch.bfloat16), gu_il.fq, gu_il.fs, gu_il.cfg)
    gu = gu + xg_b @ gu_il.fb.to(torch.float32).t()
    # phase C: act(gate)*up, down + its bias + h2
    g, u = gu[:, :n_ff], gu[:, n_ff:]
    xd = (act_f32(act, g) * u).to(torch.bfloat16)
    y = _body_plain(xd, dn.fq, dn.fs, dn.cfg)
    off = _offset_bias(dn.cfg, dn.fb)
    if dn.fb is not None or off:
        half = n_ff // 2
        xs = xd[:, :half] + xd[:, half:] if _is_packed(dn.cfg) else xd
        tile = dn.fb if dn.fb is not None else dn.fs
        tile = tile.repeat(1, xs.shape[1] // tile.shape[1])
        bias = xs.to(torch.float32) @ tile.to(torch.float32).t()
        y = y + (bias if dn.fb is not None else off * bias)
    return y + h2


def _k9(x, plain: bool):
    if plain or not x.is_cuda:
        return ffn_fused_plain
    return kernels.ffn_fused


def ffn_fused(attn, h, wo: QTensor, gu_il: QTensor, dn: QTensor, wn_il,
              eps: float, act: str = "silu", out_dtype=torch.bfloat16,
              plain: bool = False):
    """attn [B <= 8, d]: the attention output (before wo); h [B, d]: the
    residual; both in the natural column order.  Returns the layer output
    h' [B, d] in the natural order, as out_dtype.  The kernel for CUDA
    tensors, the plain version for CPU ones (or with plain=True).

    wo and dn carry their output rows permuted by interleave_perm(d, 32)
    (models/fuse.attach_ffn_fused_layout), gu_il is the w_gateup_il tensor
    and wn_il the ffn norm weight interleaved like its columns."""
    _check_act(act)
    B, d = attn.shape
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"K9 takes 1..{MAX_ROWS} rows, got {B}")
    gs = wo.cfg.gs
    G = d // gs
    attn = attn.to(torch.float32)
    x_a = _interleave_x(attn, G, gs).to(torch.bfloat16).contiguous()
    xg_a = _sums_natural(attn, G).contiguous()
    h_il = _interleave_x(h.to(torch.float32), G, gs).contiguous()
    wn = wn_il.to(torch.float32).contiguous()
    y = _k9(attn, plain)(x_a, xg_a, h_il, wn, wo, gu_il, dn, float(eps), act)
    return uninterleave_cols(y, gs).to(out_dtype)
