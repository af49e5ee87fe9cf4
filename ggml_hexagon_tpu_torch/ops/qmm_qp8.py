"""Transposed-plane (qp8) quantized GEMV/GEMM: t-plane building, plain
PyTorch versions, and the wrappers over the CUDA kernels K1-K3.

Counterpart of ggml_hexagon_tpu/ops/qmm_qp8.py.  Plane layout (one set
serves decode and prefill):

  fq  u8  [K*(bits_lo+bits_hi)/8, n2]: bits_lo-packed value plane (value k
      sits in byte row k mod (K*bits_lo/8) at shift bits_lo*(k div that)),
      the bits_hi plane's rows concatenated below in the same scheme
  fs  bf16 [G, n2]  per-group scales, transposed
  fb  bf16 [G, n2]  affine bias (minsb: -dmin*m; min: m), or None;
      symmetric offsets derive as off*fs

Numerics contracts (held by the plain versions and the kernels alike):

  decode (B <= 8, K1/K2): the effective activation (raw, RMSNorm(x)*wn, or
      silu(gate)*up) is quantized to int8 per 256-lane segment
      (iscale = 127/amax, round half to even); integer group dots are
      scaled by fs * (amax/127); the bias is group sums * fb, or
      off * fs * group sums; an optional residual is added.
  prefill (B > 8, K3): w*scale is rounded to bf16, then a bf16 x bf16
      product accumulated in f32; the bias is f32 group sums of x times
      fb (or off*fs).

The wrappers launch the kernel for CUDA tensors and run the plain version
for CPU tensors; they never fall back from one to the other.  `plain=True`
on the public entries runs the plain versions whatever the device (the
on-card comparison in chip_smoke.py).
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from ..quant.pack import QConfig, QTensor

#: activation-quant segment width (the reference's q8_K block)
SEG = 256
#: decode batch bound for the GEMV path (above: the prefill GEMM)
QP8_MAX_DECODE = 8
#: lane quantum of the t-planes' output axis
_BN = 512

KVALUES_IQ4NL = (-127, -104, -83, -65, -49, -35, -22, -10,
                 1, 13, 25, 38, 53, 69, 89, 113)


# ---------------------------------------------------------------------------
# plane geometry
# ---------------------------------------------------------------------------

def _pack_bits(cfg: QConfig):
    """(bits_lo, bits_hi) of the packed t-plane, or None when the type has
    no t-layout (signed int8 and LUT formats).  Coded formats pack their
    arithmetic codes: iq2/iq1 2+1 bits, iq3 4+0, ternary 2+0."""
    if cfg.lut or (cfg.signed and not cfg.code_map):
        return None
    if cfg.code_map in ("iq2", "iq1"):
        return 2, 1
    if cfg.code_map in ("iq3xxs", "iq3s"):
        return 4, 0
    if cfg.code_map == "tern":
        return 2, 0
    if cfg.code_map or cfg.expand:
        return None
    if (cfg.bits_lo, cfg.bits_hi) in ((4, 0), (4, 1), (4, 2),
                                      (2, 0), (2, 1)):
        return cfg.bits_lo, cfg.bits_hi
    return None


def pick_depth(cfg: QConfig, k: int) -> int | None:
    """Chunk depth dividing K and every shift-slice period of the packed
    planes, spanning >= 2 groups (the TPU decode kernel's chunking; here it
    only gates which (cfg, K) pairs have t-planes)."""
    pb = _pack_bits(cfg)
    if pb is None:
        return None
    bits_lo, bits_hi = pb
    periods = [k * bits_lo // 8]
    if bits_hi:
        periods.append(k * bits_hi // 8)
    for d in (512, 256, 128, 64, 32):
        if not (d % cfg.gs or k % d or any(p % d for p in periods)
                or d // cfg.gs < 2):
            return d
    return None


def supports_qp8(cfg: QConfig, k: int) -> bool:
    """True when (cfg, K) can build transposed planes."""
    if _pack_bits(cfg) is None or k % SEG:
        return False
    return pick_depth(cfg, k) is not None


# ---------------------------------------------------------------------------
# t-plane building (torch; runs where the wire planes live)
# ---------------------------------------------------------------------------

def _unpack_rows(plane, bits: int):
    """Row-planar packed bytes [N, K*bits/8] -> [N, K] int32."""
    per = 8 // bits
    mask = (1 << bits) - 1
    p = plane.to(torch.int32)
    parts = [(p >> (bits * s)) & mask for s in range(per)]
    return parts[0] if per == 1 else torch.cat(parts, dim=1)


def _int_values(qt: QTensor):
    """Integer weight values [n_pad, K] from the wire planes."""
    cfg = qt.cfg
    if cfg.signed:
        return qt.q.to(torch.int32)
    q = _unpack_rows(qt.q, cfg.bits_lo)
    if cfg.bits_hi:
        q = q + (_unpack_rows(qt.qh, cfg.bits_hi) << cfg.bits_lo)
    if cfg.lut:
        lut = torch.tensor(KVALUES_IQ4NL, dtype=torch.int32, device=q.device)
        q = lut[q.long()]
    return q


def _group_scale_bias(qt: QTensor):
    """f32 per-group scale [n_pad, G] and bias (or None)."""
    cfg = qt.cfg
    d = qt.d.to(torch.float32)
    if cfg.superblock:
        scale_g = (torch.repeat_interleave(d, 256 // cfg.gs, dim=1)
                   * qt.sc.to(torch.float32))
    else:
        scale_g = d
    bias_g = None
    if cfg.asym == "minsb":
        bias_g = (-torch.repeat_interleave(qt.dmin.to(torch.float32),
                                           256 // cfg.gs, dim=1)
                  * qt.m.to(torch.float32))
    elif cfg.asym == "min":
        bias_g = qt.m.to(torch.float32)
    elif cfg.offset:
        bias_g = float(cfg.offset) * scale_g
    return scale_g, bias_g


_CODE_ALPHABETS = {
    "iq2": (0, 8, 25, 43),
    "iq3xxs": (4, 12, 20, 28, 36, 44, 52, 62),
    "iq3s": (1, 3, 5, 7, 9, 11, 13, 15),
    "iq1": (0, 1, 7, 9),
}


def encode_codes(cm: str, v):
    """int values -> stored sign+magnitude codes (bit 3 = sign, bits 0-2 =
    magnitude code; ternary: value+1).  Raises on out-of-alphabet values."""
    if cm == "tern":
        if int(v.min()) < -1 or int(v.max()) > 2:
            raise ValueError(f"ternary values outside [-1, 2]")
        return (v + 1).to(torch.uint8)
    mags = _CODE_ALPHABETS[cm]
    lut = torch.full((256,), -1, dtype=torch.int32, device=v.device)
    lut[torch.tensor(mags, device=v.device)] = torch.arange(
        len(mags), dtype=torch.int32, device=v.device)
    a = v.abs()
    c = lut[a.long().clamp(max=255)]
    if 0 not in mags:
        # zero rows only come from n -> n_pad padding
        c = torch.where((a == 0) & (c < 0), torch.zeros_like(c), c)
    if bool((c < 0).any()):
        raise ValueError(f"{cm}: values outside alphabet {mags}")
    out = ((v < 0).to(torch.int32) << 3) | c
    if 0 in mags:
        out = torch.where(a == 0, out & 7, out)
    return out.to(torch.uint8)


def build_t_planes(qt: QTensor):
    """-> (fq, fs, fb) transposed planes from the wire planes, or
    (None,)*3 when (cfg, K) has no t-layout.  Byte-equal to the JAX
    package's host build; runs on the wire planes' device."""
    cfg = qt.cfg
    K = qt.k
    if not supports_qp8(cfg, K):
        return None, None, None
    v = _int_values(qt)                                 # [n_pad, K]
    if cfg.code_map:
        codes = encode_codes(cfg.code_map, v).to(torch.int32)
        if _pack_bits(cfg) == (2, 1):
            v = (codes & 3) | (((codes >> 3) & 1) << 2)
        else:
            v = codes
    scale_g, bias_g = _group_scale_bias(qt)
    if cfg.offset and cfg.asym == "none":
        bias_g = None  # derived in-kernel as off * scale
    n_pad = v.shape[0]
    quantum = 2048 if n_pad >= 65536 else _BN
    n2 = -(-n_pad // quantum) * quantum
    if n2 != n_pad:
        pad = (0, 0, 0, n2 - n_pad)
        v = torch.nn.functional.pad(v, pad)
        scale_g = torch.nn.functional.pad(scale_g, pad)
        if bias_g is not None:
            bias_g = torch.nn.functional.pad(bias_g, pad)
    vT = v.t().contiguous()                             # [K, n2]
    bits_lo, bits_hi = _pack_bits(cfg)

    def pack(plane, bits):
        per = 8 // bits
        rows = K // per
        out = torch.zeros((rows, n2), dtype=torch.int32, device=plane.device)
        for s in range(per):
            out |= plane[s * rows:(s + 1) * rows] << (bits * s)
        return (out & 0xFF).to(torch.uint8)

    fq = pack(vT & ((1 << bits_lo) - 1), bits_lo)
    if bits_hi:
        fq = torch.cat([fq, pack(vT >> bits_lo, bits_hi)], dim=0)
    fs = scale_g.t().contiguous().to(torch.bfloat16)
    fb = None if bias_g is None else bias_g.t().contiguous().to(torch.bfloat16)
    return fq, fs, fb


def _offset_bias_t(cfg: QConfig, fb) -> float:
    """Symmetric-offset formats (Q4_0/Q5_0/Q3_K/Q6_K): bias = offset *
    scale, derived from the scale plane (no fb plane)."""
    return float(cfg.offset) if (fb is None and cfg.offset) else 0.0


def _unpack_t(qt: QTensor):
    """Integer weight values [K, n2] (int32) from the t-planes."""
    cfg = qt.cfg
    if cfg.code_map:
        raise NotImplementedError(
            f"{cfg.qtype.name}: coded t-planes have no compute path in the "
            "port yet")
    bits_lo, bits_hi = _pack_bits(cfg)
    K = qt.k
    rows_lo = K * bits_lo // 8
    w = _unpack_rows(qt.fq[:rows_lo].t(), bits_lo).t()
    if bits_hi:
        wh = _unpack_rows(qt.fq[rows_lo:].t(), bits_hi).t()
        w = w | (wh << bits_lo)
    return w


def dequantize_qp8(qt: QTensor, dtype=torch.float32):
    """Dequantized [n2, K] matrix from the t-planes."""
    gs = qt.cfg.gs
    sT = torch.repeat_interleave(qt.fs.to(torch.float32), gs, dim=0)
    wT = _unpack_t(qt).to(torch.float32) * sT
    off = _offset_bias_t(qt.cfg, qt.fb)
    if off:
        wT = wT + off * sT
    if qt.fb is not None:
        wT = wT + torch.repeat_interleave(qt.fb.to(torch.float32), gs, dim=0)
    return wT.t().to(dtype)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------

def qp8_prologue_plain(x, wn=None, eps=None, act: str = ""):
    """Effective f32 activation [B, K]: raw, RMSNorm(x)*wn, or
    silu(gate)*up of x [B, 2K]."""
    if act not in ("", "silu"):
        raise NotImplementedError(f"act {act!r}: K1 takes silu only")
    xf = x.to(torch.float32)
    if act:
        K = xf.shape[1] // 2
        g = xf[:, :K]
        return g * torch.sigmoid(g) * xf[:, K:]
    if eps is not None:
        inv = torch.rsqrt(torch.mean(xf * xf, dim=1, keepdim=True) + eps)
        return xf * inv * wn.to(torch.float32)
    return xf


def quant_act_seg(xf):
    """Per-SEG int8 activation quantization: (x8 as f32 ints [B, K],
    segment scales xs = amax/127 [B, K/SEG])."""
    B, K = xf.shape
    xb = xf.reshape(B, K // SEG, SEG)
    amax = torch.amax(torch.abs(xb), dim=2)
    # a true division (scalar / tensor in torch is reciprocal-then-multiply,
    # which can move x * iscale across a rounding tie)
    iscale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                         torch.zeros_like(amax))
    x8 = torch.round(xb * iscale[:, :, None]).reshape(B, K)
    return x8, amax * (1.0 / 127.0)


def _gemv_body_plain(x8, xs, qt: QTensor):
    """Integer group dots scaled in the partial domain: y [B, n2] f32."""
    cfg = qt.cfg
    K, gs = qt.k, cfg.gs
    G = K // gs
    B = x8.shape[0]
    vT = _unpack_t(qt).to(torch.float32)                       # [K, n2]
    n2 = vT.shape[1]
    Pg = torch.bmm(x8.reshape(B, G, gs).transpose(0, 1),
                   vT.reshape(G, gs, n2)).transpose(0, 1)      # [B, G, n2]
    xs_g = xs[:, (torch.arange(G, device=xs.device) * gs) // SEG]  # [B, G]
    scT = qt.fs.to(torch.float32)
    y = (Pg * (scT[None] * xs_g[:, :, None])).sum(dim=1)
    off = _offset_bias_t(cfg, qt.fb)
    if qt.fb is not None or off:
        s8 = x8.reshape(B, G, gs).sum(dim=2)
        fbT = (qt.fb.to(torch.float32) if qt.fb is not None else off * scT)
        y = y + (fbT[None] * (s8 * xs_g)[:, :, None]).sum(dim=1)
    return y


def qp8_gemv_plain(x, qt: QTensor, wn=None, eps=None, act: str = "",
                   res=None):
    """Plain K1: x [B, K] (or [B, 2K] with act) -> y [B, n2] f32."""
    x8, xs = quant_act_seg(qp8_prologue_plain(x, wn, eps, act))
    y = _gemv_body_plain(x8, xs, qt)
    if res is not None:
        y = y.clone()
        y[:, :res.shape[1]] += res.to(torch.float32)
    return y


def qp8_dual_plain(x, qt_a: QTensor, qt_b: QTensor, wn=None, eps=None):
    """Plain K2: one shared prologue, two projections -> [B, n_a + n_b]."""
    x8, xs = quant_act_seg(qp8_prologue_plain(x, wn, eps))
    return torch.cat([_gemv_body_plain(x8, xs, qt_a),
                      _gemv_body_plain(x8, xs, qt_b)], dim=1)


def qp8_gemm_plain(x, qt: QTensor):
    """Plain K3: x bf16 [B, K] -> y [B, n2] f32 (bf16 w*scale, f32 sums)."""
    cfg = qt.cfg
    gs = cfg.gs
    B, K = x.shape
    G = K // gs
    sc = torch.repeat_interleave(qt.fs, gs, dim=0)             # bf16 [K, n2]
    wsc = _unpack_t(qt).to(torch.bfloat16) * sc                # bf16
    xf = x.to(torch.bfloat16).to(torch.float32)
    acc = xf @ wsc.to(torch.float32)
    off = _offset_bias_t(cfg, qt.fb)
    if qt.fb is not None or off:
        xg = xf.reshape(B, G, gs).sum(dim=2)
        fb = (qt.fb if qt.fb is not None else off * qt.fs).to(torch.float32)
        acc = acc + xg @ fb
    return acc


# ---------------------------------------------------------------------------
# kernel wrappers: the kernel for CUDA tensors, the plain version for CPU
# ---------------------------------------------------------------------------

def _no_code_map(*qts):
    for qt in qts:
        if qt.cfg.code_map:
            raise NotImplementedError(
                f"{qt.cfg.qtype.name}: coded t-planes have no compute path "
                "in the port yet")


def qp8_gemv(x, qt: QTensor, wn=None, eps=None, act: str = "", res=None):
    """K1: B <= 8 decode GEMV -> y [B, n2] f32."""
    _no_code_map(qt)
    if not x.is_cuda:
        return qp8_gemv_plain(x, qt, wn, eps, act, res)
    return kernels.qp8_gemv(x, qt, wn=wn, eps=eps, act=act, res=res)


def qp8_dual(x, qt_a: QTensor, qt_b: QTensor, wn=None, eps=None):
    """K2: shared prologue + two projections -> y [B, n2_a + n2_b] f32."""
    _no_code_map(qt_a, qt_b)
    if not x.is_cuda:
        return qp8_dual_plain(x, qt_a, qt_b, wn, eps)
    return kernels.qp8_dual(x, qt_a, qt_b, wn=wn, eps=eps)


def qp8_gemm(x, qt: QTensor):
    """K3: B > 8 prefill GEMM, x bf16 -> y [B, n2] f32."""
    _no_code_map(qt)
    if not x.is_cuda:
        return qp8_gemm_plain(x, qt)
    return kernels.qp8_gemm(x, qt)


# ---------------------------------------------------------------------------
# public entries (the JAX package's signatures)
# ---------------------------------------------------------------------------

def _lead2(x, qt: QTensor, width: int, decode_only: bool = False):
    """x [..., width] -> (lead shape, rows B, x as [B, width]); raises on
    a weight without t-planes, a width that does not fit it, or more rows
    than the decode kernels take."""
    if qt.fq is None:
        raise ValueError("quantized weight without t-planes")
    if x.shape[-1] != width:
        raise ValueError(f"x width {x.shape[-1]} vs {width} for K={qt.k}")
    lead = x.shape[:-1]
    B = math.prod(lead) if lead else 1
    if decode_only and B > QP8_MAX_DECODE:
        raise ValueError(f"{B} rows: the decode entry takes <= {QP8_MAX_DECODE}")
    return lead, B, x.reshape(B, width)


def qp8_matmul(x, qt: QTensor, out_dtype=torch.float32, plain=False):
    """y = x @ dequant(qt).T (decode: K1 on q8 activations; prefill: K3)."""
    lead, B, x2 = _lead2(x, qt, qt.k)
    if B <= QP8_MAX_DECODE:
        x2 = x2.to(torch.float32)
        y = (qp8_gemv_plain if plain else qp8_gemv)(x2, qt)
    else:
        x2 = x2.to(torch.bfloat16)
        y = (qp8_gemm_plain if plain else qp8_gemm)(x2, qt)
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def qp8_matmul_normed(x, qt: QTensor, wn, eps: float,
                      out_dtype=torch.float32, plain=False):
    """Fused RMSNorm + matmul (decode, K1); prefill: norm, then K3."""
    lead, B, x2 = _lead2(x, qt, qt.k)
    if B > QP8_MAX_DECODE:
        from .basic import rms_norm

        return qp8_matmul(rms_norm(x, wn, eps), qt, out_dtype=out_dtype,
                          plain=plain)
    y = (qp8_gemv_plain if plain else qp8_gemv)(
        x2.to(torch.float32), qt, wn=wn.to(torch.float32), eps=float(eps))
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def qp8_matmul_res(x, qt: QTensor, res, out_dtype=torch.float32,
                   plain=False):
    """Decode matmul with the residual added in the kernel."""
    lead, B, x2 = _lead2(x, qt, qt.k, decode_only=True)
    r2 = res.to(torch.float32).reshape(B, qt.n)
    y = (qp8_gemv_plain if plain else qp8_gemv)(
        x2.to(torch.float32), qt, res=r2)
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def qp8_matmul_act(x, qt: QTensor, act: str, res=None,
                   out_dtype=torch.float32, plain=False):
    """Fused act-mul + matmul: (act(gate)*up) @ dequant(qt).T [+ res]; x
    [..., 2K] is the raw gate_up output in natural column order."""
    lead, B, x2 = _lead2(x, qt, 2 * qt.k, decode_only=True)
    r2 = None if res is None else res.to(torch.float32).reshape(B, qt.n)
    y = (qp8_gemv_plain if plain else qp8_gemv)(
        x2.to(torch.float32), qt, act=act, res=r2)
    return y[:, :qt.n].reshape(*lead, qt.n).to(out_dtype)


def supports_qp8_dual(qt_a, qt_b) -> bool:
    """Both t-layout, same K, unpadded lanes (padding would land
    mid-output)."""
    return (isinstance(qt_a, QTensor) and isinstance(qt_b, QTensor)
            and qt_a.fq is not None and qt_b.fq is not None
            and qt_a.k == qt_b.k and qt_a.fl == qt_b.fl == "t"
            and qt_a.fq.shape[1] == qt_a.n and qt_b.fq.shape[1] == qt_b.n
            and qt_a.n % 256 == 0 and qt_b.n % 256 == 0)


def qp8_matmul_dual(x, qt_a: QTensor, qt_b: QTensor, wn=None, eps=None,
                    out_dtype=torch.float32, plain=False):
    """Two projections of the same activation in one launch (K2), output
    row [x @ A' ++ x @ B'] — the flat q++k++v row of the mixed-type QKV."""
    if not supports_qp8_dual(qt_a, qt_b):
        raise ValueError("qp8_matmul_dual: planes of different K, layout or "
                         "padded lanes")
    lead, B, x2 = _lead2(x, qt_a, qt_a.k, decode_only=True)
    y = (qp8_dual_plain if plain else qp8_dual)(
        x2.to(torch.float32), qt_a, qt_b,
        wn=None if wn is None else wn.to(torch.float32),
        eps=None if eps is None else float(eps))
    return y.reshape(*lead, qt_a.n + qt_b.n).to(out_dtype)
