"""Interleaved-layout ("il") quantized matmul: plane building, the plain
versions, and the wrappers over the CUDA kernels K6 (byte, nibble and
coded planes, each in its plain, normed, act and residual modes), K7 (two
projections of one activation in one launch) and K8 (gathered experts).

Counterpart of ggml_hexagon_tpu/ops/qmm_fast.py: `supports_fast` and
`build_fast_planes` (:120-242, the coded repack :204-208; `_int_values`,
`_group_scale_bias`, `encode_codes` and `decode_codes` are shared with
ops/qmm_qp8.py), `_offset_bias` and `_needs_xg` (:292-300),
`_pick_blocks` (:523-597, the blocking that decides which fused entries
apply and where the kernel takes its own group sums), `_interleave_x`
(:721-734), `_fast_core`'s group sums (:757-767), `dequantize_fast` and
`qmatmul_fast` (:817-869), `_dual_blocking`, `supports_dual` and
`qmatmul_fast_dual` (:1016-1107), `supports_fused_epilogue` and
`interleave_perm` (:1110-1127), `qmatmul_fast_act` and `qmatmul_fast_res`
(:1130-1233), `supports_indirect` and `qmatmul_fast_indirect`
(:1300-1356), `uninterleave_cols`, `uninterleave_norm` and
`qmatmul_fast_normed` (:1359-1433).  The layout stores weight column j as
original column (j % G)*gs + j//G, so column j's scale is fs[:, j % G]:

  fq  int8  [n2, K]    byte family: values (rows padded to 512, or to 2048
                       from 65536 rows)
      uint8 [n2, K/2]  nibble family (Q4_0, Q4_1, Q4_K): byte b holds
                       column b in its low nibble and b + K/2 in its high
                       one; (K/2) % G == 0, so both take fs[:, b % G]
      uint8 [n2, K/2]  coded family (the i-quants and ternary, code_map):
                       the same packing of 4-bit sign+magnitude codes (bit 3
                       the sign; ternary value + 1), decoded arithmetically
                       (`decode_codes`) before the scale; no group bias
  fs  bf16  [n2, G]    per-group scales
  fb  bf16  [n2, G]    affine bias, or None; the symmetric-offset types
                       derive it as off * fs (Q4_0 -8, Q5_0 -16, Q3_K -4,
                       Q6_K -32)

Numerics contract (qmm_fast.py:319-521, 757-767), held by the plain
versions and the kernels alike:

  activation  x rounded to bf16 and interleaved; normed: inv =
              rsqrt(mean(x^2) + eps) over the f32 of that bf16 x, then
              bf16((x*inv)*wn_il); act: act(g)*u in f32 of the bf16 gate
              ++ up halves (interleaved already), rounded to bf16.
  product     byte planes at B <= 8: f32 x times the f32 weight q*scale;
              byte planes above 8 rows, nibble and coded planes at every
              B: q*scale rounded to bf16 (q the decoded code on coded
              planes); products summed in f32.
  bias        y += xg @ fb^T, or off * (xg @ fs^T), with xg [B, G] the
              group sums of the activation: in the kernel from the bf16
              effective activation (mode 2: the full K in one block and
              G % 128 == 0), else from the caller's un-rounded input
              (mode 1: the pre-norm x*wn_il, scaled by inv in the kernel,
              in the normed mode; act(g)*u of the un-rounded gate_up
              output in the act mode).  K8 always takes mode 1.
  residual    an f32 row, added last: y + (bias + res).

Coded nibble planes arise under GHT_QP8=0 (layout "il") for every coded
type, and on the default route where a width has no t-layout; K6, K7 and K8
take them in every mode (`_nibble_kernel` with `cm`, `_nibble_y`
:432-461).
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from ..quant.pack import QConfig, QTensor
from .basic import act_f32, rms_norm
from .qmm_qp8 import (_group_scale_bias, _int_values, decode_codes,
                      dequantize_qp8, encode_codes, qp8_matmul, qp8_matmul_act, qp8_matmul_dual,
                      qp8_matmul_indirect, qp8_matmul_normed, qp8_matmul_res,
                      supports_qp8_dual, supports_qp8_indirect)

#: the interleaved-layout entry serves up to this many rows
#: (ops/qmatmul.qmatmul routes larger batches elsewhere)
MAX_FAST_BATCH = 512
#: row quantum of the interleaved planes
_BN = 512
#: rows of the byte family's f32 route, and of K7
_DECODE_ROWS = 8


def _is_nibble(cfg: QConfig) -> bool:
    return (cfg.bits_lo == 4 and cfg.bits_hi == 0 and not cfg.signed
            and not cfg.lut and not cfg.expand)


def _is_packed(cfg: QConfig) -> bool:
    return _is_nibble(cfg) or bool(cfg.code_map)


def _family(cfg: QConfig) -> str:
    """The planes' kernel family: "coded" (4-bit codes), "nibble" (4-bit
    values) or "byte"."""
    if cfg.code_map:
        return "coded"
    return "nibble" if _is_nibble(cfg) else "byte"


def supports_fast(cfg: QConfig, k: int) -> bool:
    """True when (cfg, K) can build interleaved planes."""
    G = k // cfg.gs
    if G < 1 or k % cfg.gs:
        return False
    packed = _is_packed(cfg)
    if packed and ((k // 2) % G or (k // 2) < G):
        return False
    if not packed and k % G:
        return False
    return G % 128 == 0 or G in (8, 16, 32, 64) or k % 128 == 0


def _offset_bias(cfg: QConfig, fb) -> float:
    """The offset of a bias derived as offset * scale (no fb plane stored:
    the symmetric-offset types), else 0.0."""
    return float(cfg.offset) if (fb is None and cfg.offset) else 0.0


def _needs_xg(cfg: QConfig, fb) -> bool:
    """Whether the planes carry a group bias (stored or derived)."""
    return fb is not None or bool(_offset_bias(cfg, fb))


def build_fast_planes(qt: QTensor):
    """-> (fq, fs, fb) interleaved planes from the wire planes, or
    (None,)*3 when (cfg, K) has none.  Byte-equal to the JAX package's
    host build; runs on the wire planes' device."""
    cfg = qt.cfg
    K = qt.k
    if not supports_fast(cfg, K):
        return None, None, None
    v = _int_values(qt)                                   # [n_pad, K]
    scale_g, bias_g = _group_scale_bias(qt)
    G = K // cfg.gs
    rows = v.shape[0]
    # the interleave is a [G, gs] transpose of each row
    v = v.reshape(rows, G, cfg.gs).transpose(1, 2).reshape(rows, K)
    if cfg.code_map:
        v = encode_codes(cfg.code_map, v).to(torch.int32)
    if _is_packed(cfg):
        # byte b: interleaved column b (low nibble), b + K/2 (high nibble)
        fq = (v[:, :K // 2] | (v[:, K // 2:] << 4)).to(torch.uint8)
    else:
        fq = v.to(torch.int8)
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


def _n_slices(cols: int, G: int, bn: int, per_col: int = 12) -> int:
    """The JAX kernel's column slicing of a weight block (qmm_fast.py:414),
    which `_pick_blocks` budgets for."""
    target = max(512, 25 * 1024 * 1024 // (per_col * bn))
    if cols <= target:
        return 1
    for n in (2, 4, 7, 8, 14, 16, 28, 32, 56):
        if cols % n == 0 and cols // n <= target and (cols // n) % G == 0:
            return n
    return 1


def _pick_blocks(B: int, K: int, nibble: bool, gs: int):
    """-> (bn, nkj): the JAX package's row block and K-split for B rows
    (qmm_fast.py:523-597, without its GHT_QMM_* overrides).  The port's
    kernels split nothing; nkj == 1 decides, as in the JAX dispatch, where
    the fused norm, act and residual modes and the gathered experts apply
    (each needs the full K in one block), and where the kernel takes its
    own group sums."""
    mb = 1024 * 1024
    G = K // gs
    pmax = gs // 2 if nibble else gs
    valid = [p for p in range(1, pmax + 1) if pmax % p == 0]
    per_col = 12 if nibble else 8
    cols = K // 2 if nibble else K
    if B <= 8:
        for bn in ((1024, 512, 256) if nibble else (2048, 1024, 512, 256)):
            fixed = 2 * bn * G * 2 * 2 + B * bn * 4 + K * 4
            blk = (B * K * 2 + bn * cols) * 2
            if fixed + blk + per_col * bn * cols <= 96 * mb:
                return bn, 1
    for bn in (2048, 1024, 512):
        nsl = (_n_slices(cols, G, bn, per_col)
               if (nibble or cols > 8192) else 1)
        csl = cols // nsl
        if csl % G:
            continue
        fixed = 2 * bn * G * 2 * 2 + B * bn * 4
        if fixed + B * K * 2 + bn * cols * 2 + per_col * bn * csl <= 96 * mb:
            return bn, 1
    for bn in (512, 256, 128):
        fixed = 2 * bn * G * 2 * 2 + B * bn * 4
        for p in valid:
            bk = K // p
            bcols = bk // 2 if nibble else bk
            blk = (B * bk * 2 + bn * bcols) * 2
            if fixed + blk + (12 if nibble else 6) * bn * bcols <= 13 * mb:
                return bn, p
    return 128, valid[-1]


def _padded_rows(B: int) -> int:
    """The JAX entries pad the rows to a multiple of 8 before blocking."""
    return max(8, -(-B // 8) * 8)


def supports_fused_epilogue(qt, B: int = 8) -> bool:
    """True when the tensor's decode blocking takes the full K in one block
    (nkj == 1), which the fused act-mul and residual modes need; t-planes
    always qualify."""
    if not isinstance(qt, QTensor) or qt.fq is None:
        return False
    if qt.fl == "t":
        return True
    _, nkj = _pick_blocks(max(8, B), qt.k, _is_packed(qt.cfg), qt.cfg.gs)
    return nkj == 1


def interleave_perm(k: int, gs: int):
    """The layout's column interleave: new column j <- original column
    (j % G)*gs + j//G (models/fuse.py permutes gate_up rows by it)."""
    G = k // gs
    j = torch.arange(k)
    return (j % G) * gs + j // G


def uninterleave_cols(x, gs: int):
    """Inverse of the column interleave along the last axis."""
    K = x.shape[-1]
    lead = x.shape[:-1]
    return x.reshape(*lead, gs, K // gs).transpose(-1, -2).reshape(*lead, K)


def uninterleave_norm(wn_il, gs: int):
    """A norm weight interleaved by models/fuse.py, back in natural order."""
    K = wn_il.shape[-1]
    return wn_il.reshape(gs, K // gs).transpose(0, 1).reshape(K)


def _interleave_x(x2, G: int, gs: int, pre_il: bool = False):
    """Activation [B, K] into the planes' interleaved column order; with
    pre_il, x2 is in that order already (the w_gateup_il prefill path)."""
    if pre_il:
        return x2
    B, K = x2.shape
    return x2.reshape(B, G, gs).transpose(1, 2).reshape(B, K)


def _sums_natural(x2, G: int):
    """f32 group sums [B, G] of x2 [B, K] in natural column order (group g
    is columns g*gs ... g*gs + gs - 1)."""
    B, K = x2.shape
    return x2.to(torch.float32).reshape(B, G, K // G).sum(dim=2)


def _sums_il(x_il, G: int):
    """f32 group sums [B, G] of x_il [B, K] in interleaved order (column
    r*G + g belongs to group g)."""
    B, K = x_il.shape
    return x_il.to(torch.float32).reshape(B, K // G, G).sum(dim=1)


def dequantize_fast(qt: QTensor, dtype=torch.float32):
    """Dequantized [n2, K] matrix in the original column order from the
    planes of either layout."""
    if qt.fl == "t":
        return dequantize_qp8(qt, dtype)
    cfg = qt.cfg
    K, gs = qt.k, cfg.gs
    G = K // gs
    if _is_packed(cfg):
        p = qt.fq.to(torch.int32)
        v = torch.cat([p & 15, p >> 4], dim=1)
        if cfg.code_map:
            v = decode_codes(cfg.code_map, v)
    else:
        v = qt.fq.to(torch.int32)
    if qt.fb is None and cfg.offset:
        v = v + int(cfg.offset)
    w_il = v.to(torch.float32) * qt.fs.to(torch.float32).repeat(1, gs)
    if qt.fb is not None:
        w_il = w_il + qt.fb.to(torch.float32).repeat(1, gs)
    rows = w_il.shape[0]
    # the inverse of the interleave is the opposite [gs, G] transpose
    return w_il.reshape(rows, gs, G).transpose(1, 2).reshape(rows, K).to(dtype)


def _il_planes(qt: QTensor):
    """Raise unless qt carries interleaved planes."""
    if qt.fq is None or qt.fl != "il":
        raise ValueError("expected a weight with interleaved planes")


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------

def _kernel_x_plain(x, G: int, wn=None, eps=None, act: str = "",
                    pre_il: bool = False):
    """The kernel's bf16 interleaved activation [B, K] (`_kernel_x`) and
    the normed mode's rsqrt factor [B, 1] (else None): x interleaved (or
    taken as it is with pre_il), RMS-normed with the interleaved weight wn
    when eps is given, or act(gate)*up (act silu, gelu or relu,
    ops.basic.act_f32) of the interleaved halves of x [B, 2K] with act."""
    if bool(act) + (eps is not None) + pre_il > 1:
        raise ValueError("K6 takes one mode: pre_il, normed or act")
    xb = x.to(torch.bfloat16)
    if act:
        xw = xb.to(torch.float32)
        K = xw.shape[1] // 2
        return (act_f32(act, xw[:, :K]) * xw[:, K:]).to(torch.bfloat16), None
    x_il = _interleave_x(xb, G, xb.shape[1] // G, pre_il)
    if eps is None:
        return x_il, None
    xf = x_il.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=1, keepdim=True) + eps)
    return (xf * inv * wn.to(torch.float32)).to(torch.bfloat16), inv


def _body_plain(x_il, fq, fs, cfg: QConfig):
    """x_il bf16 [B, K] against the planes' rows -> [B, rows] f32 (f32
    weights on byte planes at B <= 8; q*scale rounded to bf16 on byte
    planes above and on nibble and coded planes at every B)."""
    B, K = x_il.shape
    sc = fs.repeat(1, K // fs.shape[1])            # bf16 [rows, K]: fs[:, j % G]
    if _is_packed(cfg):
        p = fq.to(torch.int32)
        v = torch.cat([p & 15, p >> 4], dim=1)     # interleaved column order
        if cfg.code_map:
            v = decode_codes(cfg.code_map, v)
        w = (v.to(torch.bfloat16) * sc).to(torch.float32)
    elif B <= _DECODE_ROWS:
        w = fq.to(torch.float32) * sc.to(torch.float32)
    else:
        w = (fq.to(torch.bfloat16) * sc).to(torch.float32)
    return x_il.to(torch.float32) @ w.t()


def _bias_plain(xg, fb, fs, off: float):
    """The group-bias term [B, rows] (`_bias_term`): xg @ fb^T, or
    off * (xg @ fs^T) when the bias is derived."""
    if fb is not None:
        return xg @ fb.to(torch.float32).t()
    return off * (xg @ fs.to(torch.float32).t())


def _fast_plain(x, qt: QTensor, family: str, wn=None, eps=None,
                act: str = "", res=None, pre_il: bool = False, xg=None):
    _il_planes(qt)
    if _family(qt.cfg) != family:
        raise ValueError(f"{qt.cfg.qtype.name} planes are not of the "
                         f"{family} family")
    G = qt.fs.shape[1]
    x_il, inv = _kernel_x_plain(x, G, wn, eps, act, pre_il)
    y = _body_plain(x_il, qt.fq, qt.fs, qt.cfg)
    once = None
    if _needs_xg(qt.cfg, qt.fb):
        if xg is None:     # mode 2: sums of the effective activation
            xg = _sums_il(x_il, G)
        elif inv is not None:
            xg = xg * inv  # mode 1, normed: the pre-norm sums rescaled
        once = _bias_plain(xg, qt.fb, qt.fs, _offset_bias(qt.cfg, qt.fb))
    elif xg is not None:
        raise ValueError("group sums given for planes without a bias")
    if res is not None:
        r = torch.nn.functional.pad(res.to(torch.float32),
                                    (0, y.shape[1] - res.shape[1]))
        once = r if once is None else once + r
    return y if once is None else y + once


def fast_byte_plain(x, qt: QTensor, wn=None, eps=None, act: str = "",
                    res=None, pre_il: bool = False, xg=None):
    """Plain K6 on byte planes (the JAX `_byte_kernel` with the kernel's
    rounding), every mode: x bf16 [B, K] in natural order (interleaved with
    pre_il; [B, 2K] gate ++ up, interleaved, with act); xg f32 [B, G] the
    mode-1 group sums of planes with a bias (None: mode 2) -> y [B, n2]
    f32, plus res [B, n] on its first n columns when given."""
    return _fast_plain(x, qt, "byte", wn, eps, act, res, pre_il, xg)


def fast_nibble_plain(x, qt: QTensor, wn=None, eps=None, act: str = "",
                      res=None, pre_il: bool = False, xg=None):
    """Plain K6 on nibble planes (the JAX `_nibble_kernel`, `_nibble_y`
    :432-461): as fast_byte_plain."""
    return _fast_plain(x, qt, "nibble", wn, eps, act, res, pre_il, xg)


def fast_coded_plain(x, qt: QTensor, wn=None, eps=None, act: str = "",
                     res=None, pre_il: bool = False, xg=None):
    """Plain K6 on coded nibble planes (`_nibble_y` with `cm`: each code
    decoded by `decode_codes`, then bf16(value * scale)): as
    fast_byte_plain; the planes carry no group bias, so xg stays None."""
    return _fast_plain(x, qt, "coded", wn, eps, act, res, pre_il, xg)


def fast_byte(x, qt: QTensor, wn=None, eps=None, act: str = "", res=None,
              pre_il: bool = False, xg=None):
    """K6 on byte planes: the kernel for CUDA tensors, the plain version
    for CPU ones."""
    if not x.is_cuda:
        return fast_byte_plain(x, qt, wn, eps, act, res, pre_il, xg)
    return kernels.fast_byte(x, qt, wn=wn, eps=eps, act=act, res=res,
                             pre_il=pre_il, xg=xg)


def fast_nibble(x, qt: QTensor, wn=None, eps=None, act: str = "", res=None,
                pre_il: bool = False, xg=None):
    """K6 on nibble planes: the kernel for CUDA tensors, the plain version
    for CPU ones."""
    if not x.is_cuda:
        return fast_nibble_plain(x, qt, wn, eps, act, res, pre_il, xg)
    return kernels.fast_nibble(x, qt, wn=wn, eps=eps, act=act, res=res,
                               pre_il=pre_il, xg=xg)


def fast_coded(x, qt: QTensor, wn=None, eps=None, act: str = "", res=None,
               pre_il: bool = False, xg=None):
    """K6 on coded nibble planes: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if not x.is_cuda:
        return fast_coded_plain(x, qt, wn, eps, act, res, pre_il, xg)
    return kernels.fast_coded(x, qt, wn=wn, eps=eps, act=act, res=res,
                              pre_il=pre_il, xg=xg)


def fast_dual_plain(x, qt_a: QTensor, qt_b: QTensor, wn_a=None, wn_b=None,
                    eps=None, xg_a=None, xg_b=None):
    """Plain K7 (`_dual_kernel`): x bf16 [B <= 8, K] in natural order, each
    part on its own family and group geometry, normed with its own
    interleaved weight when eps is given, biased with its own group sums
    (xg_*: mode 1; None: mode 2) -> [B, n2_a + n2_b] f32, part a first."""
    return torch.cat([
        _fast_plain(x, qt, _family(qt.cfg), wn, eps, xg=xg)
        for qt, wn, xg in ((qt_a, wn_a, xg_a), (qt_b, wn_b, xg_b))], dim=1)


def fast_dual(x, qt_a: QTensor, qt_b: QTensor, wn_a=None, wn_b=None,
              eps=None, xg_a=None, xg_b=None):
    """K7: the kernel for CUDA tensors, the plain version for CPU ones."""
    if not x.is_cuda:
        return fast_dual_plain(x, qt_a, qt_b, wn_a, wn_b, eps, xg_a, xg_b)
    return kernels.fast_dual(x, qt_a, qt_b, wn_a=wn_a, wn_b=wn_b, eps=eps,
                             xg_a=xg_a, xg_b=xg_b)


def fast_indirect_plain(x, qt: QTensor, ids, npe: int, xg=None):
    """Plain K8: x bf16 [P, K], ids [P], xg f32 [P, G] the group sums of
    the un-interleaved input (planes with a bias) -> y [P, npe] f32, row p
    against rows [ids[p]*npe, (ids[p]+1)*npe) of the stacked planes on
    K6's B <= 8 route of their family; an id outside [0, E) gives a NaN
    row.  The rows are gathered with device-side index arithmetic: the ids
    never reach the host."""
    _il_planes(qt)
    P, K = x.shape
    G = qt.fs.shape[1]
    bias = _needs_xg(qt.cfg, qt.fb)
    off = _offset_bias(qt.cfg, qt.fb)
    x_il = _interleave_x(x.to(torch.bfloat16), G, K // G)
    ids = ids.to(torch.long)
    valid = (ids >= 0) & (ids < qt.fq.shape[0] // npe)
    rows = (torch.where(valid, ids, torch.zeros_like(ids))[:, None] * npe
            + torch.arange(npe, device=x.device))
    ys = []
    for p, r in enumerate(rows):
        fs = qt.fs.index_select(0, r)
        y = _body_plain(x_il[p:p + 1], qt.fq.index_select(0, r), fs, qt.cfg)
        if bias:
            fb = None if qt.fb is None else qt.fb.index_select(0, r)
            y = y + _bias_plain(xg[p:p + 1], fb, fs, off)
        ys.append(y)
    y = torch.cat(ys)
    return torch.where(valid[:, None], y, torch.full_like(y, float("nan")))


def fast_indirect(x, qt: QTensor, ids, npe: int, xg=None):
    """K8: the kernel for CUDA tensors, the plain version for CPU ones."""
    if not x.is_cuda:
        return fast_indirect_plain(x, qt, ids, npe, xg)
    return kernels.fast_indirect(x, qt, ids, npe, xg=xg)


# ---------------------------------------------------------------------------
# public entries (the JAX package's signatures)
# ---------------------------------------------------------------------------

def _rows(x, qt: QTensor, width: int):
    """x [..., width] -> (lead shape, rows B, x [B, width] as given, the
    same rounded to bf16).  The mode-1 group sums take the first: the
    kernel's input is the second."""
    _il_planes(qt)
    if x.shape[-1] != width:
        raise ValueError(f"x width {x.shape[-1]} vs {width} for K={qt.k}")
    lead = x.shape[:-1]
    B = math.prod(lead) if lead else 1
    xr = x.reshape(B, width)
    return lead, B, xr, xr.to(torch.bfloat16).contiguous()


def _xg_mode(qt: QTensor, nkj: int = 1) -> int:
    """0: no group bias; 2: the kernel sums its own activation (the full K
    in one block and G % 128 == 0); 1: the caller's input gives the sums
    (`_fast_core` :757-767)."""
    if not _needs_xg(qt.cfg, qt.fb):
        return 0
    return 2 if nkj == 1 and qt.fs.shape[1] % 128 == 0 else 1


def group_sums(qt: QTensor, xr, mode: str, wn=None, nkj: int = 1,
               act: str = "silu"):
    """The mode-1 group sums f32 [B, G] that an entry hands K6 or K7 for the
    rows xr [B, K] (act: [B, 2K]) as the caller gave them, un-rounded, or
    None where the planes have no bias or the kernel takes its own (mode
    2).  mode: "plain" and "res" (natural column order), "pre_il"
    (interleaved order), "normed" (the pre-norm x*wn_il, interleaved; the
    kernel scales them by its rsqrt factor), "act" (act(g)*u of the
    interleaved halves).  nkj: the blocking's K-split."""
    if _xg_mode(qt, nkj) != 1:
        return None
    G = qt.fs.shape[1]
    if mode in ("plain", "res"):
        return _sums_natural(xr, G)
    if mode == "pre_il":
        return _sums_il(xr, G)
    if mode == "normed":
        return _sums_il(_interleave_x(xr, G, qt.cfg.gs).to(torch.float32)
                        * wn.to(torch.float32), G)
    if mode == "act":
        g = xr[:, :qt.k].to(torch.float32)
        return _sums_il(act_f32(act, g) * xr[:, qt.k:].to(torch.float32), G)
    raise ValueError(f"mode {mode!r}")


_K6 = {"byte": (fast_byte, fast_byte_plain),
       "nibble": (fast_nibble, fast_nibble_plain),
       "coded": (fast_coded, fast_coded_plain)}


def _k6(qt: QTensor, plain: bool):
    return _K6[_family(qt.cfg)][plain]


def _full_k(qt: QTensor, B: int, what: str):
    if not supports_fused_epilogue(qt, _padded_rows(B)):
        raise ValueError(f"{what} needs a full-K blocking: {qt.n}x{qt.k} at "
                         f"{B} rows has none")


def qmatmul_fast(x, qt: QTensor, out_dtype=torch.float32, plain=False,
                 pre_interleaved=False):
    """y = x @ dequant(qt).T over the matmul planes: the t-layout goes to
    qp8_matmul (K1/K3), the interleaved layout to K6.  pre_interleaved: x's
    columns are in the planes' interleaved order already (no effect on
    t-planes, which have none)."""
    if qt.fl == "t":
        return qp8_matmul(x, qt, out_dtype=out_dtype, plain=plain)
    lead, B, xr, x2 = _rows(x, qt, qt.k)
    _, nkj = _pick_blocks(_padded_rows(B), qt.k, _is_packed(qt.cfg),
                          qt.cfg.gs)
    xg = group_sums(qt, xr, "pre_il" if pre_interleaved else "plain", nkj=nkj)
    y = _k6(qt, plain)(x2, qt, pre_il=pre_interleaved, xg=xg)
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def qmatmul_fast_normed(x, qt: QTensor, wn_il, eps: float,
                        out_dtype=torch.float32, plain=False):
    """Fused RMSNorm + matmul: y = rms_norm(x, wn) @ dequant(qt).T, with
    wn_il the norm weight interleaved like qt's columns (models/fuse.py).
    t-planes take qp8_matmul_normed (wn_il is the raw weight there); a
    blocking that splits K takes the norm apart, as the JAX entry does."""
    if qt.fl == "t":
        return qp8_matmul_normed(x, qt, wn_il, eps, out_dtype=out_dtype,
                                 plain=plain)
    lead, B, xr, x2 = _rows(x, qt, qt.k)
    gs = qt.cfg.gs
    _, nkj = _pick_blocks(_padded_rows(B), qt.k, _is_packed(qt.cfg), gs)
    if nkj > 1:
        xn = rms_norm(x, uninterleave_norm(wn_il, gs), eps)
        return qmatmul_fast(xn, qt, out_dtype=out_dtype, plain=plain)
    wn = wn_il.to(torch.float32).contiguous()
    xg = group_sums(qt, xr, "normed", wn)
    y = _k6(qt, plain)(x2, qt, wn=wn, eps=float(eps), xg=xg)
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def qmatmul_fast_res(x, qt: QTensor, res, out_dtype=torch.float32,
                     plain=False):
    """y = x @ dequant(qt).T + res, the residual added in the kernel."""
    if qt.fl == "t":
        return qp8_matmul_res(x, qt, res, out_dtype=out_dtype, plain=plain)
    lead, B, xr, x2 = _rows(x, qt, qt.k)
    _full_k(qt, B, "the residual mode")
    r2 = res.to(torch.float32).reshape(B, qt.n).contiguous()
    y = _k6(qt, plain)(x2, qt, res=r2, xg=group_sums(qt, xr, "res"))
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def qmatmul_fast_act(x, qt: QTensor, act: str, res=None,
                     out_dtype=torch.float32, plain=False):
    """Fused act-mul + matmul: (act(gate)*up) @ dequant(qt).T [+ res]; x
    [..., 2K] is the raw output of a gate_up projection whose rows were
    permuted at load (models/fuse.interleave_gateup_rows) so both halves
    arrive in qt's interleaved column order.  t-planes take qp8_matmul_act
    (natural order)."""
    if qt.fl == "t":
        return qp8_matmul_act(x, qt, act, res=res, out_dtype=out_dtype,
                              plain=plain)
    lead, B, xr, x2 = _rows(x, qt, 2 * qt.k)
    _full_k(qt, B, "the act mode")
    r2 = (None if res is None
          else res.to(torch.float32).reshape(B, qt.n).contiguous())
    y = _k6(qt, plain)(x2, qt, act=act, res=r2,
                       xg=group_sums(qt, xr, "act", act=act))
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def _dual_blocking(qt_a: QTensor, qt_b: QTensor):
    """The JAX package's common row block of an interleaved dual launch
    (K7) at decode, or None."""
    if qt_a.fq is None or qt_b.fq is None or qt_a.k != qt_b.k:
        return None
    if qt_a.fl == "t" or qt_b.fl == "t":
        return None
    if qt_a.n != qt_a.fq.shape[0] or qt_b.n != qt_b.fq.shape[0]:
        return None  # padding rows would land mid-output
    bns = []
    for qt in (qt_a, qt_b):
        bn, nkj = _pick_blocks(8, qt.k, _is_packed(qt.cfg), qt.cfg.gs)
        if nkj != 1:
            return None
        bns.append(bn)
    bn = min(bns)
    if qt_a.n % bn or qt_b.n % bn:
        bn = 512 if (qt_a.n % 512 == 0 and qt_b.n % 512 == 0) else None
    return bn


def supports_dual(qt_a, qt_b) -> bool:
    """Whether one launch can run both projections of the same activation:
    a pair of t-planes through K2 (supports_qp8_dual), a pair of
    interleaved planes through K7 where `_dual_blocking` finds a common
    row block; never a pair of mixed layouts."""
    if not (isinstance(qt_a, QTensor) and isinstance(qt_b, QTensor)):
        return False
    if qt_a.fl == "t" and qt_b.fl == "t":
        return supports_qp8_dual(qt_a, qt_b)
    return _dual_blocking(qt_a, qt_b) is not None


def qmatmul_fast_dual(x, qt_a: QTensor, qt_b: QTensor, wn_a_il=None,
                      wn_b_il=None, eps=None, out_dtype=torch.float32,
                      plain=False):
    """Two projections of the same activation in one launch, at decode (B
    <= 8): the row [x @ A' ++ x @ B'], the flat q++k++v row of the
    mixed-type QKV.  A pair of t-planes takes qp8_matmul_dual (K2; wn_a_il
    is the raw norm weight there, shared), an interleaved pair K7, each
    part normed with its own interleaved weight when eps is given."""
    if qt_a.fl == "t" and qt_b.fl == "t":
        return qp8_matmul_dual(x, qt_a, qt_b, wn=wn_a_il, eps=eps,
                               out_dtype=out_dtype, plain=plain)
    if _dual_blocking(qt_a, qt_b) is None:
        raise ValueError("qmatmul_fast_dual: no common blocking for planes "
                         f"{tuple(qt_a.fq.shape)} and {tuple(qt_b.fq.shape)}")
    lead, B, xr, x2 = _rows(x, qt_a, qt_a.k)
    _il_planes(qt_b)
    if B > _DECODE_ROWS:
        raise ValueError(f"K7 takes <= {_DECODE_ROWS} rows, got {B}")
    wns, xgs = [], []
    for qt, wn in ((qt_a, wn_a_il), (qt_b, wn_b_il)):
        wn = None if eps is None else wn.to(torch.float32).contiguous()
        wns.append(wn)
        xgs.append(group_sums(qt, xr, "plain" if eps is None else "normed",
                              wn))
    y = (fast_dual_plain if plain else fast_dual)(
        x2, qt_a, qt_b, wns[0], wns[1], None if eps is None else float(eps),
        xgs[0], xgs[1])
    return y.reshape(*lead, qt_a.n + qt_b.n).to(out_dtype)


def supports_indirect(qt, npe: int) -> bool:
    """Stacked [E*npe, k] expert planes can serve the gathered-expert path:
    t-planes as supports_qp8_indirect says (K5); interleaved planes when
    their decode blocking takes the full K and a row block divides npe
    (K8)."""
    if not isinstance(qt, QTensor) or qt.fq is None or npe <= 0:
        return False
    if qt.fl == "t":
        return supports_qp8_indirect(qt, npe)
    bn, nkj = _pick_blocks(8, qt.k, _is_packed(qt.cfg), qt.cfg.gs)
    if nkj != 1:
        return False
    return any(npe % b == 0 for b in (bn, 512, 256, 128) if b <= bn)


def qmatmul_fast_indirect(x, qt: QTensor, ids, npe: int,
                          out_dtype=torch.float32, plain=False):
    """MUL_MAT_ID: y[p] = x[p] @ dequant(W_{ids[p]}).T over stacked expert
    planes [(E*npe), k]; only the selected experts' planes are read, and
    the ids stay on x's device.  t-planes take qp8_matmul_indirect (K5),
    interleaved ones K8 (group sums, where the planes carry a bias, from
    the un-rounded x).  Returns [P, npe]."""
    if qt.fl == "t":
        return qp8_matmul_indirect(x, qt, ids, npe, out_dtype=out_dtype,
                                   plain=plain)
    _il_planes(qt)
    P, K = x.shape
    if K != qt.k or not supports_indirect(qt, npe) or qt.fq.shape[0] % npe:
        raise ValueError(f"x [{P}, {K}] / {npe} rows an expert do not fit "
                         f"the stacked planes {tuple(qt.fq.shape)}")
    xg = (_sums_natural(x, qt.fs.shape[1]) if _needs_xg(qt.cfg, qt.fb)
          else None)
    y = (fast_indirect_plain if plain else fast_indirect)(
        x.to(torch.bfloat16).contiguous(), qt, ids.to(torch.int32).contiguous(),
        npe, xg)
    return y.to(out_dtype)
