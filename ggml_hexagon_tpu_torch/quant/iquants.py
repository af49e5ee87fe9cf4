"""i-quant (and ternary) dequantizers — NumPy, bit-faithful (the port's
own copy of ggml_hexagon_tpu/quant/iquants.py, with its own iq_data.npz;
quant/pack.py expands the same planes in torch on the wire's device, and
expand_to_planes here is the oracle its tests hold it to).

Importance-matrix quant formats (IQ1/IQ2/IQ3 codebook grids, IQ4 non-linear
LUT, TQ ternary).  Grid constants are wire-format data extracted from the
reference header (tools/extract_iq_grids.py -> iq_data.npz).  Semantics
follow ggml/src/ggml-quants.c dequantize_row_iq* / tq*; every decoder is
differentially tested byte-for-byte against gguf-py's independent
implementation on random bit patterns.

Codebook *encoders* (the iq2/iq3/iq1 searches) are implemented below with
the reference's search structure but a whole-codebook snap in place of the
truncated neighbour lists — see the encoder section comment.
"""
from __future__ import annotations

import os

import numpy as np

from .formats import GGMLType, QK_K, TYPE_TRAITS

_DATA = np.load(os.path.join(os.path.dirname(__file__), "iq_data.npz"))

# published IQ4_NL lookup table (ggml-quants.c:2434)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)
KSIGNS = _DATA["ksigns_iq2xs"]  # [128] sign bytes (bit i -> sign of elem i)
IQ2XXS_GRID = _DATA["iq2xxs_grid"].view(np.uint8).reshape(256, 8)
IQ2XS_GRID = _DATA["iq2xs_grid"].view(np.uint8).reshape(512, 8)
IQ2S_GRID = _DATA["iq2s_grid"].view(np.uint8).reshape(1024, 8)
IQ3XXS_GRID = _DATA["iq3xxs_grid"].view(np.uint8).reshape(256, 4)
IQ3S_GRID = _DATA["iq3s_grid"].view(np.uint8).reshape(512, 4)
IQ1S_GRID = _DATA["iq1s_grid"].view(np.int8).reshape(2048, 8)
IQ1S_DELTA = 0.125
IQ1M_DELTA = 0.125


def _f16(b):  # little-endian f16 bytes -> f32
    return b.copy().view("<f2").astype(np.float32)


def _signs_from_byte(sb):
    """sign byte(s) [...]-> [... , 8] multipliers (+1/-1)."""
    bits = (sb[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(bits != 0, -1.0, 1.0).astype(np.float32)


def dequantize_iq4_nl(buf: np.ndarray, n: int) -> np.ndarray:
    b = buf.reshape(-1, 18)
    d = _f16(b[:, :2]).reshape(-1, 1)
    qs = b[:, 2:]
    lo = KVALUES_IQ4NL[qs & 0xF].astype(np.float32)
    hi = KVALUES_IQ4NL[qs >> 4].astype(np.float32)
    return (d * np.concatenate([lo, hi], axis=1)).reshape(-1)[:n]


def dequantize_iq4_xs(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ4_XS].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(nb, 1, 1)
    scales_h = b[:, 2:4].copy().view("<u2").reshape(nb).astype(np.uint32)
    scales_l = b[:, 4:8]
    qs = b[:, 8:].reshape(nb, 8, 16)
    ib = np.arange(8)
    ls_lo = (scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF
    ls_hi = (scales_h[:, None] >> (2 * ib)) & 3
    ls = (ls_lo | (ls_hi << 4)).astype(np.int32) - 32  # [nb, 8]
    lo = KVALUES_IQ4NL[qs & 0xF].astype(np.float32)
    hi = KVALUES_IQ4NL[qs >> 4].astype(np.float32)
    vals = np.concatenate([lo, hi], axis=2)  # [nb, 8, 32]
    return (d * ls[:, :, None] * vals).reshape(-1)[:n]


def dequantize_iq2_xxs(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ2_XXS].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = _f16(b[:, :2]).reshape(nb)
    q16 = b[:, 2:].copy().view("<u2").reshape(nb, 8, 4)  # per 32 elems: 4 u16
    aux8 = q16[:, :, :2].copy().view(np.uint8).reshape(nb, 8, 4)  # grid idx
    aux32 = (
        q16[:, :, 2].astype(np.uint32) | (q16[:, :, 3].astype(np.uint32) << 16)
    )  # [nb, 8]
    db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.25  # [nb, 8]
    grid = IQ2XXS_GRID[aux8].astype(np.float32)  # [nb, 8, 4, 8]
    sidx = (aux32[:, :, None] >> (7 * np.arange(4)[None, None, :])) & 127
    signs = _signs_from_byte(KSIGNS[sidx])  # [nb, 8, 4, 8]
    out = db[:, :, None, None] * grid * signs
    return out.reshape(-1)[:n]


def dequantize_iq2_xs(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ2_XS].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = _f16(b[:, :2]).reshape(nb)
    q16 = b[:, 2:66].copy().view("<u2").reshape(nb, 8, 4)  # [nb, 32] u16
    scales = b[:, 66:74]  # [nb, 8] nibble pairs
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16)  # per 16
    db = d[:, None] * (0.5 + ls.astype(np.float32)) * 0.25  # [nb, 16]
    grid = IQ2XS_GRID[q16 & 511].astype(np.float32)  # [nb, 8, 4, 8]
    signs = _signs_from_byte(KSIGNS[q16 >> 9])
    out = grid * signs  # [nb, 8, 4, 8]; scale index = per 16 elems
    out = out.reshape(nb, 16, 16) * db[:, :, None]
    return out.reshape(-1)[:n]


def dequantize_iq2_s(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ2_S].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = _f16(b[:, :2]).reshape(nb)
    qs = b[:, 2 : 2 + 32]  # grid low bytes, per 8 elems
    sign_bytes = b[:, 34 : 34 + 32]
    qh = b[:, 66 : 66 + 8]
    scales = b[:, 74 : 74 + 8]
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16)
    db = d[:, None] * (0.5 + ls.astype(np.float32)) * 0.25
    i = np.arange(32)
    hi = (qh[:, i // 4].astype(np.uint16) << (8 - 2 * (i % 4))) & 0x300
    idx = qs.astype(np.uint16) | hi
    grid = IQ2S_GRID[idx].astype(np.float32)  # [nb, 32, 8]
    signs = _signs_from_byte(sign_bytes)  # [nb, 32, 8]
    out = (grid * signs).reshape(nb, 16, 16) * db[:, :, None]
    return out.reshape(-1)[:n]


def dequantize_iq3_xxs(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ3_XXS].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = _f16(b[:, :2]).reshape(nb)
    qs = b[:, 2:66]  # 64 grid indices (1 byte per 4 elems)
    aux32 = b[:, 66:98].copy().view("<u4").reshape(nb, 8)  # scale+signs per 32
    db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.5
    # per 32 elems: 8 grid u32s (4 vals each); 4 sign packets of 8 elems
    grid = IQ3XXS_GRID[qs].astype(np.float32).reshape(nb, 8, 4, 8)
    sidx = (aux32[:, :, None] >> (7 * np.arange(4)[None, None, :])) & 127
    signs = _signs_from_byte(KSIGNS[sidx])  # [nb, 8, 4, 8]
    out = db[:, :, None, None] * grid * signs
    return out.reshape(-1)[:n]


def dequantize_iq3_s(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ3_S].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = _f16(b[:, :2]).reshape(nb)
    qs = b[:, 2:66]  # 64 low bytes, 1 per 4 elems
    qh = b[:, 66:74]  # high bits, per 32-elem chunk
    sign_bytes = b[:, 74:106]  # [nb, 32] explicit, per 8 elems
    scales = b[:, 106:110]  # 4 nibble pairs -> 8 scales per 32
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 8)
    db = d[:, None] * (1 + 2 * ls.astype(np.float32))  # [nb, 8]
    i = np.arange(64)
    hi = ((qh[:, i // 8].astype(np.uint16) << (8 - (i % 8))) & 0x100)
    idx = qs.astype(np.uint16) | hi
    grid = IQ3S_GRID[idx].astype(np.float32).reshape(nb, 8, 8, 4)
    sbits = (sign_bytes[..., None] >> np.arange(8)) & 1
    signs = np.where(sbits != 0, -1.0, 1.0).astype(np.float32).reshape(nb, 8, 8, 4)
    out = db[:, :, None, None] * grid * signs
    return out.reshape(-1)[:n]


def dequantize_iq1_s(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ1_S].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = _f16(b[:, :2]).reshape(nb)
    qs = b[:, 2:34]  # [nb, 32] low 8 bits of grid index, per 8 elems
    qh = b[:, 34:50].copy().view("<u2").reshape(nb, 8).astype(np.uint32)  # per 32
    dl = d[:, None] * (2 * ((qh >> 12) & 7).astype(np.float32) + 1)  # [nb, 8]
    delta = np.where((qh & 0x8000) != 0, -IQ1S_DELTA, IQ1S_DELTA).astype(np.float32)
    i = np.arange(32)
    hi3 = ((qh[:, i // 4] >> (3 * (i % 4))) & 7).astype(np.uint16) << 8
    idx = qs.astype(np.uint16) | hi3
    grid = IQ1S_GRID[idx].astype(np.float32).reshape(nb, 8, 4, 8)
    out = dl[:, :, None, None] * (grid + delta[:, :, None, None])
    return out.reshape(-1)[:n]


def dequantize_iq1_m(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.IQ1_M].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    qs = b[:, 0:32]  # per 8 elems low bits
    qh = b[:, 32:48]  # [nb, 16] 4 bits per 8-elem group
    sc = b[:, 48:56].copy().view("<u2").reshape(nb, 4).astype(np.uint32)
    # f16 scale packed in the top 4 bits of the four u16 scale words
    sc_u16 = ((sc[:, 0] >> 12) | (((sc[:, 1] >> 12) & 0xF) << 4)
              | (((sc[:, 2] >> 12) & 0xF) << 8) | (((sc[:, 3] >> 12) & 0xF) << 12))
    d = sc_u16.astype(np.uint16).view(np.float16).astype(np.float32)  # [nb]
    # 3-bit sub-scales: per 16 elems, packed 2x3bits per u16 (plus the spare)
    i16 = np.arange(16)
    ls = (sc[:, i16 // 4] >> (3 * (i16 % 4))) & 0x7  # [nb, 16]
    dl = d[:, None] * (2 * ls.astype(np.float32) + 1)  # per 16 elems
    # grid index: low 8 bits from qs, high 3 bits from qh nibbles
    i = np.arange(32)
    hi = ((qh[:, i // 2].astype(np.uint16) >> (4 * (i % 2))) & 7) << 8
    idx = qs.astype(np.uint16) | hi
    grid = IQ1S_GRID[idx].astype(np.float32)  # [nb, 32, 8]
    # delta per 8-elem group: bit 3 of the qh nibble
    dbit = ((qh[:, i // 2] >> (4 * (i % 2))) & 0x8) != 0
    delta = np.where(dbit, -IQ1M_DELTA, IQ1M_DELTA).astype(np.float32)
    vals = grid + delta[:, :, None]  # [nb, 32, 8]
    out = vals.reshape(nb, 16, 16) * dl[:, :, None]
    return out.reshape(-1)[:n]


def dequantize_tq1_0(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.TQ1_0].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    qs = b[:, 0:48]
    qh = b[:, 48:52]
    d = _f16(b[:, 52:54]).reshape(nb, 1)
    pow3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)
    out = np.zeros((nb, QK_K), dtype=np.float32)
    # elements 0..159: qs[0:32], 5 trits per byte, stride 32
    q = qs[:, 0:32].astype(np.uint16)
    for j in range(5):
        t = ((q * pow3[j]) & 0xFF) * 3 // 256
        out[:, 32 * j : 32 * (j + 1)] = t.astype(np.float32) - 1
    # elements 160..239: qs[32:48], 5 trits per byte, stride 16
    q = qs[:, 32:48].astype(np.uint16)
    for j in range(5):
        t = ((q * pow3[j]) & 0xFF) * 3 // 256
        out[:, 160 + 16 * j : 160 + 16 * (j + 1)] = t.astype(np.float32) - 1
    # elements 240..255: qh, 4 trits per byte, stride 4
    q = qh.astype(np.uint16)
    for j in range(4):
        t = ((q * pow3[j]) & 0xFF) * 3 // 256
        out[:, 240 + 4 * j : 240 + 4 * (j + 1)] = t.astype(np.float32) - 1
    return (out * d).reshape(-1)[:n]


def dequantize_tq2_0(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.TQ2_0].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    qs = b[:, 0:64].reshape(nb, 2, 32)
    d = _f16(b[:, 64:66]).reshape(nb, 1)
    parts = [(qs >> (2 * j)) & 3 for j in range(4)]
    q = np.stack(parts, axis=2).reshape(nb, QK_K).astype(np.float32) - 1
    return (q * d).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# encoders for the tractable types
# ---------------------------------------------------------------------------

def _best_index_iq4(x: np.ndarray) -> np.ndarray:
    """Exact best_index_int8 over the ascending 16-entry IQ4 LUT
    (ggml-quants.c:4562): nearest value, ties to the UPPER index."""
    vals = KVALUES_IQ4NL.astype(np.float32)
    mu = np.clip(np.searchsorted(vals, x, side="right"), 1, 15)
    lo, hi = vals[mu - 1], vals[mu]
    idx = np.where((x - lo) < (hi - x), mu - 1, mu)
    idx = np.where(x <= vals[0], 0, idx)
    idx = np.where(x >= vals[15], 15, idx)
    return idx.astype(np.uint8)


def _nearest_int(v: np.ndarray) -> np.ndarray:
    """ggml nearest_int: round half to even (the 12582912.0f trick)."""
    return np.rint(v).astype(np.int32)


def _iq4_impl(xb: np.ndarray, qw, sbs: int):
    """Exact quantize_row_iq4_nl_impl (ggml-quants.c:4573, ntry=7) over
    all super-blocks at once; xb [nbl, sbs] f32, qw same shape or None.
    Returns (d fp16-rounded f32 [nbl], L [nbl, sbs] u8,
    ls [nbl, sbs/32] i32 six-bit scales or None).

    All arithmetic stays f32 with the C code's sequential accumulation
    order (sum loops unrolled over the 32-lane axis) — byte parity with
    llama-quantize depends on matching every rounding."""
    f32 = np.float32
    nbl = xb.shape[0]
    nb32 = sbs // 32
    lut = KVALUES_IQ4NL.astype(f32)
    sigma2 = np.zeros(nbl, f32)
    for j in range(sbs):  # sequential f32 sum, C order
        sigma2 += xb[:, j] * xb[:, j]
    sigma2 *= f32(2.0 / sbs)
    scales = np.zeros((nbl, nb32), f32)
    L = np.zeros((nbl, sbs), np.uint8)
    amax_scale = np.zeros(nbl, f32)
    max_scale = np.zeros(nbl, f32)
    for ib in range(nb32):
        b = xb[:, ib * 32:(ib + 1) * 32]
        if qw is not None:
            w = (qw[:, ib * 32:(ib + 1) * 32]
                 * np.sqrt(sigma2[:, None] + b * b)).astype(f32)
        else:
            w = (b * b).astype(f32)
        ab = np.abs(b)
        am_i = ab.argmax(axis=1)          # first max (strict > in C)
        rows = np.arange(nbl)
        amax = ab[rows, am_i]
        mx = b[rows, am_i]
        live = amax >= f32(1e-15)         # GROUP_MAX_EPS

        def sums(idv):
            ql = _best_index_iq4(idv[:, None] * b)
            q = lut[ql]
            sumqx = np.zeros(nbl, f32)
            sumq2 = np.zeros(nbl, f32)
            for j in range(32):           # sequential f32, C order
                sumqx += w[:, j] * q[:, j] * b[:, j]
                sumq2 += w[:, j] * q[:, j] * q[:, j]
            return ql, sumqx, sumq2

        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(live, (-mx / lut[0]).astype(f32), f32(0))
            idv = np.where(d != 0, f32(1) / d, f32(0))
            ql0, sumqx, sumq2 = sums(idv)
            d = np.where(sumq2 != 0, sumqx / sumq2, f32(0))
            best = d * sumqx
            for itry in range(-7, 8):
                idv = np.where(live, (f32(itry) + lut[0]) / mx, f32(0))
                _, sx, s2 = sums(idv)
                upd = live & (s2 > 0) & (sx * sx > best * s2)
                d = np.where(upd, sx / s2, d)
                best = np.where(upd, d * sx, best)
        scales[:, ib] = np.where(live, d, f32(0))
        L[:, ib * 32:(ib + 1) * 32] = ql0  # single-block path placeholder
        bigger = np.abs(scales[:, ib]) > amax_scale
        amax_scale = np.where(bigger, np.abs(scales[:, ib]), amax_scale)
        max_scale = np.where(bigger, scales[:, ib], max_scale)
    if nb32 > 1:
        d = (-max_scale / f32(32)).astype(f32)
        d16 = d.astype(np.float16).astype(f32)
        with np.errstate(divide="ignore", invalid="ignore"):
            idv = np.where(d != 0, f32(1) / d, f32(0))
        ls = np.zeros((nbl, nb32), np.int32)
        for ib in range(nb32):
            l = np.clip(_nearest_int(idv * scales[:, ib]), -32, 31)
            dl = (d * l.astype(f32)).astype(f32)
            with np.errstate(divide="ignore", invalid="ignore"):
                idl = np.where(dl != 0, f32(1) / dl, f32(0))
            b = xb[:, ib * 32:(ib + 1) * 32]
            L[:, ib * 32:(ib + 1) * 32] = _best_index_iq4(idl[:, None] * b)
            ls[:, ib] = l + 32
        return d16, L, ls
    # single-block (IQ4_NL): recompute L at the fp16-rounded... no — the
    # C code re-indexes with id = 1/scales[0] BEFORE fp16 rounding
    d16 = scales[:, 0].astype(np.float16).astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        idv = np.where(scales[:, 0] != 0, f32(1) / scales[:, 0], f32(0))
    L = _best_index_iq4(idv[:, None] * xb)
    return d16, L, None


def quantize_iq4_nl(x: np.ndarray, quant_weights=None) -> np.ndarray:
    """Exact quantize_iq4_nl (ggml-quants.c:4684, ntry=7, imatrix-aware)."""
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, 32)
    nb = xb.shape[0]
    qw = (None if quant_weights is None
          else np.ascontiguousarray(quant_weights, np.float32).reshape(nb, 32))
    d16, L, _ = _iq4_impl(xb, qw, 32)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, :2] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = (L[:, :16] | (L[:, 16:] << 4)).astype(np.uint8)
    return out.reshape(-1)


def quantize_iq4_xs(x: np.ndarray, quant_weights=None) -> np.ndarray:
    """Exact quantize_iq4_xs (ggml-quants.c:4722: 256-superblock, 6-bit
    sub-scales split into scales_l nibbles + scales_h 2-bit pairs)."""
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    nbl = xb.shape[0]
    qw = (None if quant_weights is None
          else np.ascontiguousarray(quant_weights,
                                    np.float32).reshape(nbl, QK_K))
    d16, L, ls = _iq4_impl(xb, qw, QK_K)
    out = np.zeros((nbl, 136), dtype=np.uint8)
    out[:, 0:2] = d16.astype(np.float16).view(np.uint8).reshape(nbl, 2)
    scales_h = np.zeros(nbl, np.uint16)
    scales_l = np.zeros((nbl, 4), np.uint8)
    for ib in range(8):
        l = ls[:, ib].astype(np.uint16)
        if ib % 2 == 0:
            scales_l[:, ib // 2] |= (l & 0xF).astype(np.uint8)
        else:
            scales_l[:, ib // 2] |= ((l & 0xF) << 4).astype(np.uint8)
        scales_h |= ((l >> 4) << (2 * ib)).astype(np.uint16)
    out[:, 2:4] = scales_h.view(np.uint8).reshape(nbl, 2)
    out[:, 4:8] = scales_l
    q4 = np.empty((nbl, 128), np.uint8)
    for i in range(8):
        q4[:, 16 * i:16 * i + 16] = (L[:, 32 * i:32 * i + 16]
                                     | (L[:, 32 * i + 16:32 * i + 32] << 4))
    out[:, 8:] = q4
    return out.reshape(-1)


def quantize_tq2_0(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    nb = xb.shape[0]
    d = np.abs(xb).max(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0, 1.0 / d, 0.0)
    q = np.rint(xb * inv[:, None]).astype(np.int32) + 1  # {0,1,2}
    q = np.clip(q, 0, 2).astype(np.uint8)
    qc = q.reshape(nb, 2, 4, 32)
    packed = (qc[:, :, 0] | (qc[:, :, 1] << 2) | (qc[:, :, 2] << 4) | (qc[:, :, 3] << 6))
    out = np.empty((nb, 66), dtype=np.uint8)
    out[:, 0:64] = packed.reshape(nb, 64)
    out[:, 64:66] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# codebook encoders (imatrix-aware)
# ---------------------------------------------------------------------------
# Same search structure as the reference's quantize_row_iq*_impl
# (ggml-quants.c:2954-4742): per sub-block sign factoring (with the 7-bit
# ksigns parity trick), a scale-candidate sweep, codebook snapping, and
# sumqx/sumq2 scale refits.  One deliberate improvement: where the reference
# snaps off-grid points via precomputed *truncated* neighbour lists
# (iq2_find_best_neighbour), we search the WHOLE codebook against the true
# dequant values — a strict superset of the reference's search space, so
# weighted error is never worse.  Encoders accept quant_weights=None by
# substituting uniform weights (the reference asserts an imatrix instead).


def _block_weights(x, qw, sigma_mult=1.0):
    """weight[i] = qw[i] * sqrt(sigma2 + x[i]^2) per 256-block (x [N,256])."""
    sigma2 = sigma_mult * np.mean(x * x, axis=1, keepdims=True)
    if qw is None:
        qw = 1.0
    return qw * np.sqrt(sigma2 + x * x)


def _extract_signs(x, w, parity: bool):
    """Per 8-group sign bytes.  parity=True: 7-bit ksigns encoding — if the
    group has an odd number of negatives, flip the least-important element
    (min w*x^2) so the 8th sign is recoverable from parity.
    x [N, 256] -> (xval [N,256], sbytes [N,32] uint8)."""
    g = x.reshape(-1, 32, 8)
    wg = w.reshape(-1, 32, 8)
    neg = (g < 0).astype(np.uint8)
    xval = np.abs(g)
    bits = (neg << np.arange(8, dtype=np.uint8)).sum(axis=2).astype(np.uint8)
    if parity:
        odd = (np.bitwise_count(bits) & 1).astype(bool)
        imp = wg * g * g
        imin = np.argmin(imp, axis=2)
        rows = np.nonzero(odd)
        xval[rows[0], rows[1], imin[odd]] *= -1.0
        bits[odd] ^= (1 << imin[odd]).astype(np.uint8)
        bits &= 127
    return xval.reshape(x.shape), bits.reshape(x.shape[0], 32)


def _snap_global(xv, w, scale, qvals, chunk=8192):
    """Best codebook row per cell: argmin_g sum_i w*(x - scale*q_g)^2.
    xv, w [M, C]; scale [M]; qvals [G, C] -> idx [M]."""
    q2 = (qvals * qvals).T  # [C, G]
    qt = qvals.T
    out = np.empty(xv.shape[0], dtype=np.int64)
    for s in range(0, xv.shape[0], chunk):
        e = min(s + chunk, xv.shape[0])
        a = (w[s:e] * xv[s:e]) @ qt          # [m, G]
        b = w[s:e] @ q2                      # [m, G]
        sc = scale[s:e, None]
        out[s:e] = np.argmax(2.0 * sc * a - sc * sc * b, axis=1)
    return out


def _refit_scale(xv, w, q):
    """scale = sum(w x q)/sum(w q q) per row; also returns the score
    sumqx^2/sumq2 the reference maximizes."""
    sumqx = np.sum(w * xv * q, axis=-1)
    sumq2 = np.sum(w * q * q, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(sumq2 > 0, sumqx / np.where(sumq2 == 0, 1, sumq2), 0.0)
    return np.maximum(scale, 0.0), np.where(sumq2 > 0, sumqx * sumqx / np.where(sumq2 == 0, 1, sumq2), 0.0)


def _signgrid_search(xval, weight, sub, cell, kmax, step, qvals):
    """Shared iq2/iq3 search.  xval/weight [N,256] (signs factored out).
    Returns (scales [N, 256//sub], idx [N, 256//cell])."""
    N = xval.shape[0]
    nsub = 256 // sub
    xs = xval.reshape(N * nsub, sub)
    ws = weight.reshape(N * nsub, sub)
    maxv = np.maximum(xs.max(axis=1), 0.0)
    # candidate sweep with free (non-codebook) levels, like the reference's
    # is-loop; the codebook constraint is applied in the snap passes below
    best_scale = np.zeros(N * nsub, np.float32)
    best_score = np.zeros(N * nsub, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i_s in range(-6, 7):
            denom = 2 * kmax - 1 + i_s * step
            idv = np.where(maxv > 0, denom / np.where(maxv == 0, 1, maxv), 0.0)
            L = np.clip(np.rint(0.5 * (idv[:, None] * xs - 1)), 0, kmax - 1)
            q = 2 * L + 1
            scale, score = _refit_scale(xs, ws, q)
            better = score > best_score
            best_score = np.where(better, score, best_score)
            best_scale = np.where(better, scale, best_scale)
    scale = best_scale
    ncell = sub // cell
    xc = xs.reshape(-1, cell)
    wc = ws.reshape(-1, cell)
    for _ in range(2):  # snap -> refit, twice
        idx = _snap_global(xc, wc, np.repeat(scale, ncell), qvals)
        q = qvals[idx].reshape(N * nsub, sub)
        scale, _ = _refit_scale(xs, ws, q)
    return (scale.reshape(N, nsub).astype(np.float32),
            idx.reshape(N, 256 // cell))


def _pack_subscales(scales, d):
    """l = clip(round(0.5*(scale/d - 1)), 0, 15) (iq2/iq3 sub-scales)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    return np.clip(np.rint(0.5 * (inv[:, None] * scales - 1)), 0, 15).astype(np.uint8)


def _iq2_subblock_exact(xb, qw, variant, sub, ncell, parity, sigma_mult,
                        eps, memset_dead_L, iog_tracked, is_lo, is_hi,
                        qp_init):
    """Shared exact iq2 sub-block search (quantize_row_iq2_{xxs,xs,s}_impl
    bodies differ only in the knobs above).  xb [N, 256] f32, qw same or
    None (ones — the C asserts quant_weights for xxs/xs, so None has no
    reference behavior; ones keeps the same machinery).
    Returns (scales [N, nsub] f32, gidx [N, nsub, ncell] i32,
    signs [N, nsub, ncell] u8, live [N, nsub] bool)."""
    f32 = np.float32
    kmap, _, grid = _iq2_tables(variant)
    gridq = (grid - 1) // 2
    N = xb.shape[0]
    nsub = QK_K // sub
    sumx2 = np.zeros(N, f32)
    for j in range(QK_K):                            # C sequential f32
        sumx2 += xb[:, j] * xb[:, j]
    sigma2 = (f32(sigma_mult) * sumx2 / f32(QK_K)).astype(f32)
    if qw is None:
        qw = np.ones_like(xb)

    scales = np.zeros((N, nsub), f32)
    gidx = np.zeros((N, nsub, ncell), np.int32)
    sgn = np.zeros((N, nsub, ncell), np.uint8)
    live_all = np.zeros((N, nsub), bool)
    L = np.zeros((N, sub), np.int32)                 # persists across ib
    arange8 = 2 * np.arange(8)
    smask = np.uint8(127) if parity else np.uint8(255)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for ib in range(nsub):
            xbs = xb[:, sub * ib:sub * ib + sub]
            w = (qw[:, sub * ib:sub * ib + sub]
                 * np.sqrt(sigma2[:, None] + xbs * xbs)).astype(f32)
            waux = np.sqrt(w).astype(f32)
            g = xbs.reshape(N, ncell, 8)
            wg = w.reshape(N, ncell, 8)
            neg = g < 0
            xval = np.abs(g).astype(f32)
            bits = (neg.astype(np.uint8)
                    << np.arange(8, dtype=np.uint8)).sum(
                        axis=2).astype(np.uint8)
            if parity:
                odd = (np.bitwise_count(bits) & 1).astype(bool)
                imp = (wg * g * g).astype(f32)
                imin = np.argmin(imp, axis=2)
                rr = np.nonzero(odd)
                xval[rr[0], rr[1], imin[odd]] *= f32(-1)
                bits[odd] ^= (np.uint8(1) << imin[odd]).astype(np.uint8)
                bits &= 127
            xval = xval.reshape(N, sub)
            mx = xval.max(axis=1)
            live = mx >= f32(eps)
            if memset_dead_L:
                L[~live] = 0
            best = np.zeros(N, f32)
            if qp_init:
                from .ref_numpy import make_qp_quants

                L0, scale = make_qp_quants(xval, 4, w)
                L = np.where(live[:, None], L0.astype(np.int32), L)
                eff = (scale * f32(3)).astype(f32)
                denom = np.where(live & (eff > 0), eff, f32(1))
            else:
                mxs = np.where(live, mx, f32(1))
                scale = (mxs / f32(5)).astype(f32)
                denom = mxs
            iog = np.ones((N, ncell), bool)
            for is_ in range(is_lo, is_hi + 1):
                id_ = ((f32(5) + f32(is_) * f32(0.1)) / denom).astype(f32)
                this_scale = (f32(1) / id_).astype(f32)
                t = (f32(0.5) * (id_[:, None] * xval - f32(1))).astype(f32)
                laux = np.clip(_nearest_int(t), 0, 2)
                u = (laux.reshape(N, ncell, 8) << arange8).sum(axis=2)
                gi = kmap[u]
                on = gi >= 0
                need = live[:, None] & ~on
                if need.any():
                    ri, ci = np.nonzero(need)
                    gi_n = _iq2s_neighbour(
                        u[need], xval.reshape(N, ncell, 8)[ri, ci],
                        waux.reshape(N, ncell, 8)[ri, ci],
                        this_scale[ri], variant)
                    laux = laux.reshape(N, ncell, 8).copy()
                    laux[ri, ci] = gridq[gi_n]
                    laux = laux.reshape(N, sub)
                qv = (2 * laux + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(sub):                 # C sequential f32
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                upd = live & (sumq2 > 0) & (sumqx * sumqx > best * sumq2)
                ns = (sumqx / sumq2).astype(f32)
                scale = np.where(upd, ns, scale)
                best = np.where(upd, (ns * sumqx).astype(f32), best)
                L = np.where(upd[:, None], laux, L)
                iog = np.where(upd[:, None], on, iog)
            if iog_tracked:
                post = live & (~iog).any(axis=1) & (scale > 0)
                cellsel = ~iog                       # off-grid cells only
            else:
                post = live & (scale > 0)            # xxs: ALL cells
                cellsel = np.ones((N, ncell), bool)
            if post.any():
                id2 = (f32(1) / np.where(post, scale, f32(1))).astype(f32)
                t = (f32(0.5) * (id2[:, None] * xval - f32(1))).astype(f32)
                lp = np.clip(_nearest_int(t), 0, 2)
                u = (lp.reshape(N, ncell, 8) << arange8).sum(axis=2)
                cells = post[:, None] & cellsel
                ri, ci = np.nonzero(cells)
                ui = u[cells]
                gi = kmap[ui].copy()
                bad = gi < 0
                if bad.any():
                    gi[bad] = _iq2s_neighbour(
                        ui[bad], xval.reshape(N, ncell, 8)[ri[bad],
                                                           ci[bad]],
                        waux.reshape(N, ncell, 8)[ri[bad], ci[bad]],
                        scale[ri[bad]], variant)
                # on-grid cells: gridq[gi] == the clamped lp codes, so a
                # single grid-point rewrite covers both C branches
                L = L.reshape(N, ncell, 8).copy()
                L[ri, ci] = gridq[gi]
                L = L.reshape(N, sub)
                qv = (2 * L + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(sub):
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                ok = post & (sumq2 > 0)
                scale = np.where(ok, (sumqx / sumq2).astype(f32), scale)
            flip = live & (scale < 0)
            scale = np.abs(scale)
            bits = np.where(flip[:, None],
                            (~bits).astype(np.uint8) & smask, bits)
            uf = (L.reshape(N, ncell, 8) << arange8).sum(axis=2)
            gf = kmap[uf]
            gidx[:, ib] = np.where(live[:, None], gf, 0)
            sgn[:, ib] = np.where(live[:, None], bits, 0)
            live_all[:, ib] = live
            scales[:, ib] = np.where(live, scale, f32(0))
    return scales, gidx, sgn, live_all


def quantize_iq2_xxs(x, quant_weights=None):
    """Exact quantize_row_iq2_xxs_impl (ggml-quants.c:2954); byte parity
    with llama-quantize verified in tests/test_quant_vs_libggml.py."""
    f32 = np.float32
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    qw = (None if quant_weights is None
          else np.asarray(quant_weights, np.float32).reshape(xb.shape))
    N = xb.shape[0]
    scales, gidx, sgn, _live = _iq2_subblock_exact(
        xb, qw, "xxs", 32, 4, True, 1.0, 1e-15, True, False, -6, 6, True)
    max_scale = scales.max(axis=1)
    dead = max_scale == 0
    d = (max_scale / f32(31)).astype(f32)
    d16 = np.where(dead, f32(0), d).astype(np.float16)
    idv = (f32(1) / np.where(dead, f32(1), d)).astype(f32)
    ls = np.clip(_nearest_int(
        (f32(0.5) * (idv[:, None] * scales - f32(1))).astype(f32)), 0, 15)
    idx4 = gidx.astype(np.uint32)
    s4 = sgn.astype(np.uint32)
    aux32a = (idx4[..., 0] | (idx4[..., 1] << 8) | (idx4[..., 2] << 16)
              | (idx4[..., 3] << 24))
    aux32b = (s4[..., 0] | (s4[..., 1] << 7) | (s4[..., 2] << 14)
              | (s4[..., 3] << 21)
              | (np.where(dead[:, None], 0, ls).astype(np.uint32) << 28))
    aux32a = np.where(dead[:, None], np.uint32(0), aux32a)
    aux32b = np.where(dead[:, None], np.uint32(0), aux32b)
    out = np.zeros((N, 66), np.uint8)
    out[:, :2] = d16.view(np.uint8).reshape(N, 2)
    packed = np.stack([aux32a, aux32b], axis=2)      # [N, 8, 2] u32
    out[:, 2:] = packed.astype("<u4").view(np.uint8).reshape(N, 64)
    return out.reshape(-1)


def quantize_iq2_xs(x, quant_weights=None):
    """Exact quantize_row_iq2_xs_impl (ggml-quants.c:3127); byte parity
    with llama-quantize verified in tests/test_quant_vs_libggml.py."""
    f32 = np.float32
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    qw = (None if quant_weights is None
          else np.asarray(quant_weights, np.float32).reshape(xb.shape))
    N = xb.shape[0]
    scales, gidx, sgn, _live = _iq2_subblock_exact(
        xb, qw, "xs", 16, 2, True, 1.0, 1e-15, True, True, -9, 9, False)
    max_scale = scales.max(axis=1)
    dead = max_scale == 0
    d = (max_scale / f32(31)).astype(f32)
    d16 = np.where(dead, f32(0), d).astype(np.float16)
    idv = (f32(1) / np.where(dead, f32(1), d)).astype(f32)
    ls = np.clip(_nearest_int(
        (f32(0.5) * (idv[:, None] * scales - f32(1))).astype(f32)), 0, 15)
    ls = np.where(dead[:, None], 0, ls)
    q16 = (gidx.reshape(N, 32).astype(np.uint16)
           | (sgn.reshape(N, 32).astype(np.uint16) << 9))
    q16 = np.where(dead[:, None], np.uint16(0), q16)
    out = np.zeros((N, 74), np.uint8)
    out[:, :2] = d16.view(np.uint8).reshape(N, 2)
    out[:, 2:66] = q16.astype("<u2").view(np.uint8).reshape(N, 64)
    out[:, 66:74] = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    return out.reshape(-1)


_IQ2_TABLES = {}


def _iq2s_tables():
    return _iq2_tables("s")


def _iq2_tables(variant: str):
    """kmap + padded neighbour table for the iq2 grids, exactly
    iq2xs_init_impl (ggml-quants.c:2564): for each off-grid 16-bit
    2-bit-field code, ALL grid points through the end of the nwant-th
    (d2, index)-ordered distance shell (nwant=2 for xxs/xs, 1 for s).
    kmap_size = 43692 (the quantizer only produces field values 0..2)."""
    if variant in _IQ2_TABLES:
        return _IQ2_TABLES[variant]
    # published bytes {8, 25, 43} -> codes {0, 1, 2} -> lattice 2l+1
    pub = {"xxs": IQ2XXS_GRID, "xs": IQ2XS_GRID,
           "s": IQ2S_GRID}[variant].astype(np.int32)
    nwant = 1 if variant == "s" else 2
    l8 = np.select([pub == 8, pub == 25, pub == 43], [0, 1, 2])
    grid = (2 * l8 + 1).astype(np.int32)             # [1024, 8] in 1/3/5
    kmap_size = 43692
    uu = (l8 << (2 * np.arange(8))).sum(axis=1)
    kmap = np.full(kmap_size, -1, np.int32)
    kmap[uu] = np.arange(grid.shape[0])
    off = np.nonzero(kmap < 0)[0]
    counts = np.zeros(len(off), np.int64)
    chunks = []
    for s in range(0, len(off), 4096):               # chunk the 43k rows
        o = off[s:s + 4096]
        pos = ((o[:, None] >> (2 * np.arange(8))) & 3) * 2 + 1
        d2 = ((grid[None, :, :].astype(np.int32)
               - pos[:, None, :]) ** 2).sum(axis=2, dtype=np.int32)
        order = np.argsort(d2, axis=1, kind="stable")
        d2s = np.take_along_axis(d2, order, axis=1)
        shell = d2s[:, :1]
        c = np.zeros(len(o), np.int64)
        for _ in range(nwant):                       # full nwant shells
            c = (d2s <= shell).sum(axis=1)
            nxt = np.where(d2s > shell, d2s,
                           np.iinfo(np.int32).max).min(axis=1)
            shell = np.where((nxt < np.iinfo(np.int32).max)[:, None],
                             nxt[:, None], shell)
        counts[s:s + 4096] = c
        chunks.append(order[:, :int(c.max())])
    maxn = int(counts.max())
    nbt = np.full((kmap_size, maxn), -1, np.int32)
    row = 0
    for ch in chunks:
        n, m = ch.shape
        sel = off[row:row + n]
        nbt[sel, :m] = np.where(
            np.arange(m)[None] < counts[row:row + n, None], ch, -1)
        row += n
    _IQ2_TABLES[variant] = (kmap, nbt, grid)
    return _IQ2_TABLES[variant]


def _iq2s_neighbour(u, xv, wv, sc, variant: str = "s"):
    """Vectorized iq2_find_best_neighbour (ggml-quants.c:2930): first
    strict-minimum weighted 8-dim distance over the neighbour list."""
    f32 = np.float32
    kmap, nbt, grid = _iq2_tables(variant)
    cand = nbt[u]
    q = grid.astype(f32)[cand]                       # [M, maxn, 8]
    d2 = np.zeros(cand.shape, f32)
    for i in range(8):                               # C sequential f32
        diff = (sc[:, None] * q[:, :, i] - xv[:, i:i + 1]).astype(f32)
        d2 += (wv[:, i:i + 1] * diff * diff).astype(f32)
    d2 = np.where(cand >= 0, d2, np.inf)
    j = np.argmin(d2, axis=1)
    return cand[np.arange(len(u)), j]


def _iq2s_impl(xb, qw):
    """Exact quantize_row_iq2_s_impl (ggml-quants.c:4749): 16-weight
    sub-blocks, 2 cells of 8, kMaxQ=3, is in -9..9 with step 0.1, full
    8-bit signs, non-imatrix weight 0.25*sigma2 + x^2, d fudge 0.9875.
    Returns (d16 [N,2] u8, qs [N,32] u8, sgn [N,32] u8, qh [N,8] u8,
    ls [N,16] i32)."""
    f32 = np.float32
    kmap, _, grid = _iq2s_tables()
    gridq = (grid - 1) // 2                          # codes [1024, 8]
    N = xb.shape[0]
    xb = xb.astype(f32)
    sumx2 = np.zeros(N, f32)
    for j in range(QK_K):                            # C sequential f32
        sumx2 += xb[:, j] * xb[:, j]
    sigma2 = (f32(2) * sumx2 / f32(QK_K)).astype(f32)

    scales = np.zeros((N, 16), f32)
    qs_all = np.zeros((N, 16, 2), np.int32)
    sg_all = np.zeros((N, 16, 2), np.uint8)
    live_all = np.zeros((N, 16), bool)
    L = np.zeros((N, 16), np.int32)                  # persists across ib
    arange8 = 2 * np.arange(8)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for ib in range(16):
            xb16 = xb[:, 16 * ib:16 * ib + 16]
            if qw is not None:
                w = (qw[:, 16 * ib:16 * ib + 16]
                     * np.sqrt(sigma2[:, None] + xb16 * xb16)).astype(f32)
            else:
                w = (f32(0.25) * sigma2[:, None] + xb16 * xb16).astype(f32)
            waux = np.sqrt(w).astype(f32)
            neg = xb16.reshape(N, 2, 8) < 0
            bits = (neg.astype(np.uint8)
                    << np.arange(8, dtype=np.uint8)).sum(
                        axis=2).astype(np.uint8)     # [N, 2] full signs
            xval = np.abs(xb16).astype(f32)
            mx = xval.max(axis=1)
            live = mx >= f32(1e-8)                   # GROUP_MAX_EPS_IQ2_S
            mxs = np.where(live, mx, f32(1))
            best = np.zeros(N, f32)
            scale = (mxs / f32(5)).astype(f32)
            iog = np.ones((N, 2), bool)              # C inits true (4817)
            for is_ in range(-9, 10):
                id_ = ((f32(5) + f32(is_) * f32(0.1)) / mxs).astype(f32)
                this_scale = (f32(1) / id_).astype(f32)
                t = (f32(0.5) * (id_[:, None] * xval - f32(1))).astype(f32)
                laux = np.clip(_nearest_int(t), 0, 2)
                u = (laux.reshape(N, 2, 8) << arange8).sum(axis=2)  # [N,2]
                gi = kmap[u]
                on = gi >= 0
                need = live[:, None] & ~on
                if need.any():
                    ri, ci = np.nonzero(need)
                    gi_n = _iq2s_neighbour(
                        u[need], xval.reshape(N, 2, 8)[ri, ci],
                        waux.reshape(N, 2, 8)[ri, ci], this_scale[ri])
                    laux = laux.reshape(N, 2, 8).copy()
                    laux[ri, ci] = gridq[gi_n]
                    laux = laux.reshape(N, 16)
                qv = (2 * laux + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(16):                  # C sequential f32
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                upd = live & (sumq2 > 0) & (sumqx * sumqx > best * sumq2)
                ns = (sumqx / sumq2).astype(f32)
                scale = np.where(upd, ns, scale)
                best = np.where(upd, (ns * sumqx).astype(f32), best)
                L = np.where(upd[:, None], laux, L)
                iog = np.where(upd[:, None], on, iog)
            post = live & (~iog).any(axis=1) & (scale > 0)
            if post.any():
                id2 = (f32(1) / np.where(post, scale, f32(1))).astype(f32)
                t = (f32(0.5) * (id2[:, None] * xval - f32(1))).astype(f32)
                lp = np.clip(_nearest_int(t), 0, 2)
                u = (lp.reshape(N, 2, 8) << arange8).sum(axis=2)
                cells = post[:, None] & ~iog         # only off-grid cells
                ri, ci = np.nonzero(cells)
                L = L.reshape(N, 2, 8).copy()
                L[ri, ci] = lp.reshape(N, 2, 8)[ri, ci]
                ui = u[cells]
                gi = kmap[ui]
                bad = gi < 0
                if bad.any():
                    gi_n = _iq2s_neighbour(
                        ui[bad], xval.reshape(N, 2, 8)[ri[bad], ci[bad]],
                        waux.reshape(N, 2, 8)[ri[bad], ci[bad]],
                        scale[ri[bad]])
                    L[ri[bad], ci[bad]] = gridq[gi_n]
                L = L.reshape(N, 16)
                qv = (2 * L + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(16):
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                ok = post & (sumq2 > 0)
                scale = np.where(ok, (sumqx / sumq2).astype(f32), scale)
            flip = live & (scale < 0)
            scale = np.abs(scale)
            bits = np.where(flip[:, None], (~bits).astype(np.uint8), bits)
            uf = (L.reshape(N, 2, 8) << arange8).sum(axis=2)
            gf = kmap[uf]
            qs_all[:, ib] = np.where(live[:, None], gf, 0)
            sg_all[:, ib] = np.where(live[:, None], bits, 0)
            live_all[:, ib] = live
            scales[:, ib] = np.where(live, scale, f32(0))
    max_scale = scales.max(axis=1)
    dead = max_scale == 0
    d = (max_scale / f32(31)).astype(f32)
    d16 = np.where(dead, f32(0), (d * f32(0.9875)).astype(f32)).astype(
        np.float16)
    idv = (f32(1) / np.where(dead, f32(1), d)).astype(f32)
    ls = np.clip(_nearest_int(
        (f32(0.5) * (idv[:, None] * scales - f32(1))).astype(f32)), 0, 15)
    ls = np.where(dead[:, None], 0, ls)
    i8 = qs_all.reshape(N, 32)                       # [N, 32] cell order
    qh = np.zeros((N, 8), np.uint32)
    hi = (i8 >> 8).reshape(N, 8, 4)
    qh = (hi[:, :, 0] | (hi[:, :, 1] << 2) | (hi[:, :, 2] << 4)
          | (hi[:, :, 3] << 6)).astype(np.uint8)
    qh = np.where(dead[:, None], 0, qh).astype(np.uint8)
    qs = np.where(dead[:, None], 0, i8 & 255).astype(np.uint8)
    sgn = np.where(dead[:, None], 0, sg_all.reshape(N, 32)).astype(np.uint8)
    return d16.view(np.uint8).reshape(N, 2), qs, sgn, qh, ls


def quantize_iq2_s(x, quant_weights=None):
    """Exact quantize_row_iq2_s_impl — see _iq2s_impl; byte parity with
    llama-quantize verified in tests/test_quant_vs_libggml.py."""
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    qw = (None if quant_weights is None
          else np.asarray(quant_weights, np.float32).reshape(xb.shape))
    N = xb.shape[0]
    d16, qs, sgn, qh, ls = _iq2s_impl(xb, qw)
    out = np.zeros((N, 82), np.uint8)
    out[:, :2] = d16
    out[:, 2:34] = qs
    out[:, 34:66] = sgn
    out[:, 66:74] = qh
    out[:, 74:82] = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    return out.reshape(-1)


_IQ3_TABLES = {}


def _iq3_tables(variant: str):
    """kmap + padded neighbour table + lattice for the iq3 grids, exactly
    iq3xs_init_impl (ggml-quants.c:3358): for each off-grid 12-bit index,
    ALL grid points sorted by (d2, grid index) through the end of the
    nwant-th distance shell (nwant=2 for the 256-grid / xxs, 3 for the
    512-grid / s; iq3_compare_func breaks d2 ties by index, which a
    stable argsort on d2 reproduces)."""
    if variant in _IQ3_TABLES:
        return _IQ3_TABLES[variant]
    if variant == "xxs":
        # the npz grid holds the PUBLISHED dequant bytes (8l+4, but 62
        # for l=7); the quantizer's internal lattice (kgrid_256) is 2l+1
        l4 = (IQ3XXS_GRID.astype(np.int32) - 4) // 8
        nwant = 2
    else:
        l4 = (IQ3S_GRID.astype(np.int32) - 1) // 2   # stored as 2l+1
        nwant = 3
    grid = 2 * l4 + 1                                # lattice values 1..15
    gsz = grid.shape[0]
    uu = (l4 << (3 * np.arange(4))).sum(axis=1)
    kmap = np.full(4096, -1, np.int32)
    kmap[uu] = np.arange(gsz)
    off = np.nonzero(kmap < 0)[0]
    pos = ((off[:, None] >> (3 * np.arange(4))) & 7) * 2 + 1
    d2 = ((grid[None, :, :] - pos[:, None, :]) ** 2).sum(axis=2)
    order = np.argsort(d2, axis=1, kind="stable")    # (d2, index) order
    d2s = np.take_along_axis(d2, order, axis=1)
    shell = d2s[:, :1]
    counts = np.zeros(len(off), np.int64)
    for _ in range(nwant):
        counts = (d2s <= shell).sum(axis=1)
        nxt = np.where(d2s > shell, d2s, np.iinfo(np.int64).max).min(axis=1)
        shell = np.where((nxt < np.iinfo(np.int64).max)[:, None],
                         nxt[:, None], shell)
    maxn = int(counts.max())
    nbt = np.full((4096, maxn), -1, np.int32)
    nbt[off] = np.where(np.arange(maxn)[None] < counts[:, None],
                        order[:, :maxn], -1)
    _IQ3_TABLES[variant] = (kmap, nbt, grid.astype(np.int32))
    return _IQ3_TABLES[variant]


def _iq3_neighbour(u, xv, wv, sc, variant: str):
    """Vectorized iq3_find_best_neighbour (ggml-quants.c:3524): first
    strict-minimum weighted distance over the cell's neighbour list.
    u [M] off-grid 12-bit codes, xv [M,4], wv=waux [M,4], sc [M] f32."""
    f32 = np.float32
    kmap, nbt, grid = _iq3_tables(variant)
    cand = nbt[u]                                    # [M, maxn], -1 pad
    q = grid.astype(f32)[cand]                       # [M, maxn, 4] 2l+1
    d2 = np.zeros(cand.shape, f32)
    for i in range(4):                               # C sequential f32
        diff = (sc[:, None] * q[:, :, i] - xv[:, i:i + 1]).astype(f32)
        d2 += (wv[:, i:i + 1] * diff * diff).astype(f32)
    d2 = np.where(cand >= 0, d2, np.inf)
    j = np.argmin(d2, axis=1)                        # first best, like C
    return cand[np.arange(len(u)), j]


def _iq3xxs_impl(xb, qw):
    """Exact quantize_row_iq3_xxs_impl (ggml-quants.c:3548): 31-candidate
    scale sweep with truncated-neighbour grid snapping, off-grid re-snap
    post-pass, parity signs with min-importance flip — all arithmetic in
    f32 with the C code's sequential accumulation order.
    Returns (d_f16bytes [N,2] u8, q3idx [N,64] u8, aux32 [N,8] u32)."""
    f32 = np.float32
    kmap, _, _grid = _iq3_tables("xxs")
    gridq = (_grid - 1) // 2                            # L codes [256,4]
    N = xb.shape[0]
    xb = xb.astype(f32)
    rows = np.arange(N)
    sumx2 = np.zeros(N, f32)
    for j in range(QK_K):                            # C sequential f32
        sumx2 += xb[:, j] * xb[:, j]
    sigma2 = (f32(2) * sumx2 / f32(QK_K)).astype(f32)

    scales = np.zeros((N, 8), f32)
    q3idx = np.zeros((N, 8, 8), np.int32)
    sign4 = np.zeros((N, 8, 4), np.uint32)
    L = np.zeros((N, 32), np.int32)                  # persists across ib
    iog = np.ones((N, 8), bool)                      # is_on_grid persists
    arange4 = 3 * np.arange(4)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for ib in range(8):
            xb32 = xb[:, 32 * ib:32 * ib + 32]
            if qw is not None:
                w = (qw[:, 32 * ib:32 * ib + 32]
                     * np.sqrt(sigma2[:, None] + xb32 * xb32)).astype(f32)
            else:
                w = (xb32 * xb32).astype(f32)
            waux = np.sqrt(w).astype(f32)
            # signs per 8-group with odd-parity flip at first-min w*x*x
            g = xb32.reshape(N, 4, 8)
            wg = w.reshape(N, 4, 8)
            neg = g < 0
            xval = np.abs(g).astype(f32)
            bits = (neg.astype(np.uint8)
                    << np.arange(8, dtype=np.uint8)).sum(
                        axis=2).astype(np.uint8)
            odd = (np.bitwise_count(bits) & 1).astype(bool)
            imp = (wg * g * g).astype(f32)
            imin = np.argmin(imp, axis=2)
            rr = np.nonzero(odd)
            xval[rr[0], rr[1], imin[odd]] *= f32(-1)
            bits[odd] ^= (np.uint8(1) << imin[odd]).astype(np.uint8)
            bits &= 127
            xval = xval.reshape(N, 32)
            mx = xval.max(axis=1)
            live = mx >= f32(1e-8)                   # GROUP_MAX_EPS_IQ3_XXS
            L[~live] = 0                             # C memset on dead
            mxs = np.where(live, mx, f32(1))
            best = np.zeros(N, f32)
            scale = (mxs / f32(15)).astype(f32)
            for is_ in range(-15, 16):
                id_ = ((f32(15) + f32(is_) * f32(0.2)) / mxs).astype(f32)
                this_scale = (f32(1) / id_).astype(f32)
                t = (f32(0.5) * (id_[:, None] * xval - f32(1))).astype(f32)
                laux = np.clip(_nearest_int(t), 0, 7)
                u = (laux.reshape(N, 8, 4) << arange4).sum(axis=2)  # [N,8]
                gi = kmap[u]
                on = gi >= 0
                need = live[:, None] & ~on
                if need.any():
                    ri, ci = np.nonzero(need)
                    gi_n = _iq3_neighbour(
                        u[need], xval.reshape(N, 8, 4)[ri, ci],
                        waux.reshape(N, 8, 4)[ri, ci], this_scale[ri],
                        "xxs")
                    laux = laux.reshape(N, 8, 4).copy()
                    laux[ri, ci] = gridq[gi_n]
                    laux = laux.reshape(N, 32)
                qv = (2 * laux + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(32):                  # C sequential f32
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                upd = live & (sumq2 > 0) & (sumqx * sumqx > best * sumq2)
                ns = (sumqx / sumq2).astype(f32)
                scale = np.where(upd, ns, scale)
                best = np.where(upd, (ns * sumqx).astype(f32), best)
                L = np.where(upd[:, None], laux, L)
                iog = np.where(upd[:, None], on, iog)
            # post-pass: re-snap off-grid cells at the final scale
            post = live & (~iog).any(axis=1) & (scale > 0)
            if post.any():
                id2 = (f32(1) / np.where(post, scale, f32(1))).astype(f32)
                t = (f32(0.5) * (id2[:, None] * xval - f32(1))).astype(f32)
                lp = np.clip(_nearest_int(t), 0, 7)
                u = (lp.reshape(N, 8, 4) << arange4).sum(axis=2)
                cells = post[:, None] & ~iog
                ri, ci = np.nonzero(cells)
                ui = u[cells]
                gi = kmap[ui].copy()
                bad = gi < 0
                if bad.any():
                    gi[bad] = _iq3_neighbour(
                        ui[bad], xval.reshape(N, 8, 4)[ri[bad], ci[bad]],
                        waux.reshape(N, 8, 4)[ri[bad], ci[bad]],
                        scale[ri[bad]], "xxs")
                L = L.reshape(N, 8, 4).copy()
                L[ri, ci] = gridq[gi]
                L = L.reshape(N, 32)
                qv = (2 * L + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(32):
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                ok = post & (sumq2 > 0)
                scale = np.where(ok, (sumqx / sumq2).astype(f32), scale)
            # negative-scale flip ("should never happen" guard, C 3708)
            flip = live & (scale < 0)
            scale = np.abs(scale)
            bits = np.where(flip[:, None], (~bits) & np.uint8(127), bits)
            # encode this sub-block
            uf = (L.reshape(N, 8, 4) << arange4).sum(axis=2)
            gf = kmap[uf]
            q3idx[:, ib] = np.where(live[:, None], gf, 0)
            sign4[:, ib] = np.where(live[:, None], bits.astype(np.uint32),
                                    0)
            scales[:, ib] = np.where(live, scale, f32(0))
    max_scale = scales.max(axis=1)
    dead = max_scale == 0
    d = (max_scale / f32(31)).astype(f32)
    d16 = np.where(dead, f32(0), (d * f32(1.0125)).astype(f32)).astype(
        np.float16)
    idv = (f32(1) / np.where(dead, f32(1), d)).astype(f32)
    ls = np.clip(_nearest_int(
        (f32(0.5) * (idv[:, None] * scales - f32(1))).astype(f32)), 0, 15)
    aux32 = (sign4[..., 0] | (sign4[..., 1] << 7) | (sign4[..., 2] << 14)
             | (sign4[..., 3] << 21)
             | (np.where(dead[:, None], 0, ls).astype(np.uint32) << 28))
    q3idx = np.where(dead[:, None, None], 0, q3idx)
    aux32 = np.where(dead[:, None], np.uint32(0), aux32)
    return (d16.view(np.uint8).reshape(N, 2),
            q3idx.reshape(N, 64).astype(np.uint8), aux32.astype("<u4"))


def quantize_iq3_xxs(x, quant_weights=None):
    """Exact quantize_row_iq3_xxs_impl — see _iq3xxs_impl; byte parity
    with llama-quantize verified in tests/test_quant_vs_libggml.py."""
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    qw = (None if quant_weights is None
          else np.asarray(quant_weights, np.float32).reshape(xb.shape))
    N = xb.shape[0]
    d16, q3, aux32 = _iq3xxs_impl(xb, qw)
    out = np.zeros((N, 98), np.uint8)
    out[:, :2] = d16
    out[:, 2:66] = q3
    out[:, 66:98] = aux32.view(np.uint8).reshape(N, 32)
    return out.reshape(-1)


def _iq3s_impl(xb, qw):
    """Exact quantize_row_iq3_s_impl (ggml-quants.c:3776): like the xxs
    search but over the 512-entry grid with nwant=3 neighbour shells,
    FULL 8-bit signs (no parity flip), is in -9..9, is_on_grid reset per
    sub-block, the post-pass re-snapping ALL cells, d fudge 1.033 and
    nibble-packed sub-scales.  Returns (d16 [N,2] u8, qs [N,64] u8,
    qh [N,8] u8, signs [N,32] u8, ls [N,8] i32)."""
    f32 = np.float32
    kmap, _, grid = _iq3_tables("s")
    gridq = (grid - 1) // 2                          # L codes [512, 4]
    N = xb.shape[0]
    xb = xb.astype(f32)
    sumx2 = np.zeros(N, f32)
    for j in range(QK_K):                            # C sequential f32
        sumx2 += xb[:, j] * xb[:, j]
    sigma2 = (f32(2) * sumx2 / f32(QK_K)).astype(f32)

    scales = np.zeros((N, 8), f32)
    gf_all = np.zeros((N, 8, 8), np.int32)
    sg_all = np.zeros((N, 8, 4), np.uint8)
    qh = np.zeros((N, 8), np.uint8)
    live_all = np.zeros((N, 8), bool)
    L = np.zeros((N, 32), np.int32)                  # persists across ib
    arange4 = 3 * np.arange(4)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for ib in range(8):
            xb32 = xb[:, 32 * ib:32 * ib + 32]
            if qw is not None:
                w = (qw[:, 32 * ib:32 * ib + 32]
                     * np.sqrt(sigma2[:, None] + xb32 * xb32)).astype(f32)
            else:
                w = (xb32 * xb32).astype(f32)
            waux = np.sqrt(w).astype(f32)
            neg = xb32.reshape(N, 4, 8) < 0
            bits = (neg.astype(np.uint8)
                    << np.arange(8, dtype=np.uint8)).sum(
                        axis=2).astype(np.uint8)     # full 8-bit signs
            xval = np.abs(xb32).astype(f32)
            mx = xval.max(axis=1)
            live = mx != 0                           # C: if (!max)
            mxs = np.where(live, mx, f32(1))
            best = np.zeros(N, f32)
            scale = (mxs / f32(15)).astype(f32)
            iog = np.zeros((N, 8), bool)             # reset per sub-block
            for is_ in range(-9, 10):
                id_ = ((f32(15) + f32(is_) * f32(0.2)) / mxs).astype(f32)
                this_scale = (f32(1) / id_).astype(f32)
                t = (f32(0.5) * (id_[:, None] * xval - f32(1))).astype(f32)
                laux = np.clip(_nearest_int(t), 0, 7)
                u = (laux.reshape(N, 8, 4) << arange4).sum(axis=2)
                gi = kmap[u]
                on = gi >= 0
                need = live[:, None] & ~on
                if need.any():
                    ri, ci = np.nonzero(need)
                    gi_n = _iq3_neighbour(
                        u[need], xval.reshape(N, 8, 4)[ri, ci],
                        waux.reshape(N, 8, 4)[ri, ci], this_scale[ri],
                        "s")
                    laux = laux.reshape(N, 8, 4).copy()
                    laux[ri, ci] = gridq[gi_n]
                    laux = laux.reshape(N, 32)
                qv = (2 * laux + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(32):                  # C sequential f32
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                upd = live & (sumq2 > 0) & (sumqx * sumqx > best * sumq2)
                ns = (sumqx / sumq2).astype(f32)
                scale = np.where(upd, ns, scale)
                best = np.where(upd, (ns * sumqx).astype(f32), best)
                L = np.where(upd[:, None], laux, L)
                iog = np.where(upd[:, None], on, iog)
            # post-pass: re-snap ALL cells at the final scale (the
            # is_on_grid skip is commented out in the reference)
            post = live & (~iog).any(axis=1) & (scale > 0)
            if post.any():
                id2 = (f32(1) / np.where(post, scale, f32(1))).astype(f32)
                t = (f32(0.5) * (id2[:, None] * xval - f32(1))).astype(f32)
                lp = np.clip(_nearest_int(t), 0, 7)
                u = (lp.reshape(N, 8, 4) << arange4).sum(axis=2)
                cells = np.broadcast_to(post[:, None], (N, 8))
                ri, ci = np.nonzero(cells)
                ui = u[cells]
                gi = kmap[ui].copy()
                bad = gi < 0
                if bad.any():
                    gi[bad] = _iq3_neighbour(
                        ui[bad], xval.reshape(N, 8, 4)[ri[bad], ci[bad]],
                        waux.reshape(N, 8, 4)[ri[bad], ci[bad]],
                        scale[ri[bad]], "s")
                L = L.reshape(N, 8, 4).copy()
                L[ri, ci] = gridq[gi]
                L = L.reshape(N, 32)
                qv = (2 * L + 1).astype(f32)
                sumqx = np.zeros(N, f32)
                sumq2 = np.zeros(N, f32)
                for i in range(32):
                    sumqx += (w[:, i] * xval[:, i] * qv[:, i]).astype(f32)
                    sumq2 += (w[:, i] * qv[:, i] * qv[:, i]).astype(f32)
                ok = post & (sumq2 > 0)
                scale = np.where(ok, (sumqx / sumq2).astype(f32), scale)
            flip = live & (scale < 0)
            scale = np.abs(scale)
            bits = np.where(flip[:, None], (~bits).astype(np.uint8), bits)
            uf = (L.reshape(N, 8, 4) << arange4).sum(axis=2)
            gf = kmap[uf]
            gf_all[:, ib] = np.where(live[:, None], gf, 0)
            sg_all[:, ib] = np.where(live[:, None], bits, 0)
            qh[:, ib] = np.where(
                live, ((gf >> 8) << np.arange(8)).sum(axis=1), 0
            ).astype(np.uint8)
            live_all[:, ib] = live
            scales[:, ib] = np.where(live, scale, f32(0))
    # qs/signs POINTERS only advance on live sub-blocks in the C code
    # (the dead-sub-block `continue` skips them) — compact accordingly;
    # qh and the nibble scales keep original ib indexing
    qs_out = np.zeros((N, 8, 8), np.uint8)
    sg_out = np.zeros((N, 8, 4), np.uint8)
    slot = np.cumsum(live_all, axis=1) - 1
    ri, ib_i = np.nonzero(live_all)
    qs_out[ri, slot[ri, ib_i]] = (gf_all[ri, ib_i] & 255).astype(np.uint8)
    sg_out[ri, slot[ri, ib_i]] = sg_all[ri, ib_i]
    max_scale = scales.max(axis=1)
    dead = max_scale == 0
    d = (max_scale / f32(31)).astype(f32)
    d16 = np.where(dead, f32(0), (d * f32(1.033)).astype(f32)).astype(
        np.float16)
    idv = (f32(1) / np.where(dead, f32(1), d)).astype(f32)
    ls = np.clip(_nearest_int(
        (f32(0.5) * (idv[:, None] * scales - f32(1))).astype(f32)), 0, 15)
    ls = np.where(dead[:, None], 0, ls)
    return (d16.view(np.uint8).reshape(N, 2),
            qs_out.reshape(N, 64), qh, sg_out.reshape(N, 32), ls)


def quantize_iq3_s(x, quant_weights=None):
    """Exact quantize_row_iq3_s_impl — see _iq3s_impl; byte parity with
    llama-quantize verified in tests/test_quant_vs_libggml.py."""
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    qw = (None if quant_weights is None
          else np.asarray(quant_weights, np.float32).reshape(xb.shape))
    N = xb.shape[0]
    d16, qs, qh, sgn, ls = _iq3s_impl(xb, qw)
    out = np.zeros((N, 110), np.uint8)
    out[:, :2] = d16
    out[:, 2:66] = qs
    out[:, 66:74] = qh
    out[:, 74:106] = sgn
    out[:, 106:110] = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    return out.reshape(-1)


def _iq1_split_search(xs, ws, delta):
    """Exact weighted 3-level (-1/0/+1 + shift*delta) split search
    (quantize_row_iq1_s_impl): sort, prefix sums, scan (i1,i2) splits for
    both shift signs.  xs, ws [M, B] -> (L [M,B] in {0,1,2}, scale [M],
    shift [M] in {+1,-1})."""
    M, B = xs.shape
    order = np.argsort(xs, axis=1, kind="stable")
    xs_s = np.take_along_axis(xs, order, axis=1)
    ws_s = np.take_along_axis(ws, order, axis=1)
    sumx = np.zeros((M, B + 1), np.float64)
    sumw = np.zeros((M, B + 1), np.float64)
    np.cumsum(ws_s * xs_s, axis=1, out=sumx[:, 1:])
    np.cumsum(ws_s, axis=1, out=sumw[:, 1:])
    i1 = np.arange(B + 1)[:, None]
    i2 = np.arange(B + 1)[None, :]
    valid = (i2 >= i1)[None]  # [1, B+1, B+1]
    best_score = np.full(M, -np.finfo(np.float32).tiny, np.float64)
    best = None
    for shift in (1, -1):
        lv = np.array([-1 + shift * delta, shift * delta, 1 + shift * delta])
        s1 = sumx[:, i1[:, 0]][:, :, None]
        s2 = sumx[:, i2[0]][:, None, :]
        sT = sumx[:, -1][:, None, None]
        w1 = sumw[:, i1[:, 0]][:, :, None]
        w2 = sumw[:, i2[0]][:, None, :]
        wT = sumw[:, -1][:, None, None]
        sumqx = s1 * lv[0] + (s2 - s1) * lv[1] + (sT - s2) * lv[2]
        sumq2 = w1 * lv[0] ** 2 + (w2 - w1) * lv[1] ** 2 + (wT - w2) * lv[2] ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where((sumq2 > 0) & valid, sumqx * sumqx / np.where(sumq2 == 0, 1, sumq2), -np.inf)
        flat = score.reshape(M, -1)
        k = np.argmax(flat, axis=1)
        sc_ = flat[np.arange(M), k]
        better = sc_ > best_score
        cand_i1, cand_i2 = np.divmod(k, B + 1)
        cand_scale = (np.take_along_axis(sumqx.reshape(M, -1), k[:, None], 1)[:, 0]
                      / np.maximum(np.take_along_axis(sumq2.reshape(M, -1), k[:, None], 1)[:, 0], 1e-30))
        if best is None:
            best = [cand_i1.copy(), cand_i2.copy(), cand_scale.copy(),
                    np.full(M, shift)]
            best_score = sc_
        else:
            for arr, cand in zip(best, (cand_i1, cand_i2, cand_scale,
                                        np.full(M, shift))):
                arr[better] = cand[better]
            best_score = np.where(better, sc_, best_score)
    bi1, bi2, scale, shifts = best
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.broadcast_to(np.arange(B), (M, B)).copy(), axis=1)
    L = (ranks >= bi1[:, None]).astype(np.int8) + (ranks >= bi2[:, None]).astype(np.int8)
    negative = scale < 0
    L[negative] = 2 - L[negative]
    shifts = np.where(negative, -shifts, shifts)
    scale = np.abs(scale)
    return L, scale.astype(np.float32), shifts.astype(np.int8)


def quantize_iq1_s(x, quant_weights=None):
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    qw = None if quant_weights is None else np.asarray(quant_weights, np.float32).reshape(xb.shape)
    N = xb.shape[0]
    w = _block_weights(xb, qw, sigma_mult=2.0)
    xs = xb.reshape(N * 8, 32)
    ws = w.reshape(N * 8, 32)
    _, scale, shifts = _iq1_split_search(xs, ws, IQ1S_DELTA)
    # snap each 8-group to the 2048-row grid at the chosen shift, refit
    gridf = IQ1S_GRID.astype(np.float32)
    xc = xs.reshape(-1, 8)
    wc = ws.reshape(-1, 8)
    shift_e = np.repeat(shifts, 4).astype(np.float32)
    qv_p = gridf + IQ1S_DELTA
    qv_m = gridf - IQ1S_DELTA
    idx_p = _snap_global(xc, wc, np.repeat(scale, 4), qv_p)
    idx_m = _snap_global(xc, wc, np.repeat(scale, 4), qv_m)
    idx = np.where(shift_e > 0, idx_p, idx_m)
    q = np.where(shift_e[:, None] > 0, qv_p[idx], qv_m[idx]).reshape(N * 8, 32)
    scale, _ = _refit_scale(xs, ws, q)
    scales = scale.reshape(N, 8)
    idx = idx.reshape(N, 8, 4)
    d = scales.max(axis=1) / 15.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    ls = np.clip(np.rint(0.5 * (inv[:, None] * scales - 1)), 0, 7).astype(np.uint32)
    out = np.zeros((N, 50), np.uint8)
    out[:, :2] = (d * 1.125).astype(np.float16).view(np.uint8).reshape(N, 2)
    out[:, 2:34] = (idx & 255).astype(np.uint8).reshape(N, 32)
    hi = (idx >> 8).astype(np.uint32)  # 3 bits per 8-group
    qh = (hi[..., 0] | (hi[..., 1] << 3) | (hi[..., 2] << 6) | (hi[..., 3] << 9)
          | (ls << 12) | ((shifts.reshape(N, 8) < 0).astype(np.uint32) << 15))
    out[:, 34:50] = qh.astype("<u2").view(np.uint8).reshape(N, 16)
    return out.reshape(-1)


def quantize_iq1_m(x, quant_weights=None):
    xb = np.ascontiguousarray(x, np.float32).reshape(-1, QK_K)
    qw = None if quant_weights is None else np.asarray(quant_weights, np.float32).reshape(xb.shape)
    N = xb.shape[0]
    w = _block_weights(xb, qw, sigma_mult=2.0)
    xs = xb.reshape(N * 16, 16)
    ws = w.reshape(N * 16, 16)
    _, scale, _ = _iq1_split_search(xs, ws, IQ1M_DELTA)
    # per-8-group shift chosen in the snap (reference: best_k combo search)
    gridf = IQ1S_GRID.astype(np.float32)
    xc = xs.reshape(-1, 8)
    wc = ws.reshape(-1, 8)
    both = np.concatenate([gridf + IQ1M_DELTA, gridf - IQ1M_DELTA], axis=0)
    idx2 = _snap_global(xc, wc, np.repeat(scale, 2), both)
    gshift = idx2 >= len(gridf)
    idx = np.where(gshift, idx2 - len(gridf), idx2)
    q = both[idx2].reshape(N * 16, 16)
    scale, _ = _refit_scale(xs, ws, q)
    scales = scale.reshape(N, 16)
    d = scales.max(axis=1) / 15.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    ls = np.clip(np.rint(0.5 * (inv[:, None] * scales - 1)), 0, 7).astype(np.uint32)
    idx = idx.reshape(N, 32)
    gshift = gshift.reshape(N, 32)
    out = np.zeros((N, 56), np.uint8)
    out[:, 0:32] = (idx & 255).astype(np.uint8)
    hi = (idx >> 8).astype(np.uint8)
    nib = (hi | (gshift.astype(np.uint8) << 3)).reshape(N, 16, 2)
    out[:, 32:48] = nib[:, :, 0] | (nib[:, :, 1] << 4)
    d16 = (d * 1.1125).astype(np.float16).view(np.uint16).astype(np.uint32)  # [N]
    sc = np.zeros((N, 4), np.uint32)
    for ib in range(16):
        sc[:, ib // 4] |= ls[:, ib] << (3 * (ib % 4))
    sc[:, 0] |= ((d16 >> 0) & 0xF) << 12
    sc[:, 1] |= ((d16 >> 4) & 0xF) << 12
    sc[:, 2] |= ((d16 >> 8) & 0xF) << 12
    sc[:, 3] |= ((d16 >> 12) & 0xF) << 12
    out[:, 48:56] = sc.astype("<u2").view(np.uint8).reshape(N, 8)
    return out.reshape(-1)


DEQUANT_IQ = {
    GGMLType.IQ4_NL: dequantize_iq4_nl,
    GGMLType.IQ4_XS: dequantize_iq4_xs,
    GGMLType.IQ2_XXS: dequantize_iq2_xxs,
    GGMLType.IQ2_XS: dequantize_iq2_xs,
    GGMLType.IQ2_S: dequantize_iq2_s,
    GGMLType.IQ3_XXS: dequantize_iq3_xxs,
    GGMLType.IQ3_S: dequantize_iq3_s,
    GGMLType.IQ1_S: dequantize_iq1_s,
    GGMLType.IQ1_M: dequantize_iq1_m,
    GGMLType.TQ1_0: dequantize_tq1_0,
    GGMLType.TQ2_0: dequantize_tq2_0,
}

QUANT_IQ = {
    GGMLType.IQ4_NL: quantize_iq4_nl,
    GGMLType.IQ4_XS: quantize_iq4_xs,
    GGMLType.TQ2_0: quantize_tq2_0,
    GGMLType.IQ2_XXS: quantize_iq2_xxs,
    GGMLType.IQ2_XS: quantize_iq2_xs,
    GGMLType.IQ2_S: quantize_iq2_s,
    GGMLType.IQ3_XXS: quantize_iq3_xxs,
    GGMLType.IQ3_S: quantize_iq3_s,
    GGMLType.IQ1_S: quantize_iq1_s,
    GGMLType.IQ1_M: quantize_iq1_m,
}

QUANT_IQ_IMATRIX = {
    GGMLType.IQ4_NL: quantize_iq4_nl,
    GGMLType.IQ4_XS: quantize_iq4_xs,
    GGMLType.IQ2_XXS: quantize_iq2_xxs,
    GGMLType.IQ2_XS: quantize_iq2_xs,
    GGMLType.IQ2_S: quantize_iq2_s,
    GGMLType.IQ3_XXS: quantize_iq3_xxs,
    GGMLType.IQ3_S: quantize_iq3_s,
    GGMLType.IQ1_S: quantize_iq1_s,
    GGMLType.IQ1_M: quantize_iq1_m,
}


# ---------------------------------------------------------------------------
# exact (int8 value, f32 group scale) decompositions for the planar loader
# ---------------------------------------------------------------------------

def expand_to_planes(buf: np.ndarray, qtype: GGMLType, N: int, K: int):
    """Decompose y = scale_g * q with integer q (|q| <= 127) and per-group
    f32 scale — exact: dequant(planes) == dequantize_iq*(wire) bitwise.

    IQ1 formats fold their +/-0.125 delta into q via q*8 and scale/8
    (both exact in f32/int8).
    """
    nb = N * K // QK_K

    def f16(b):
        return b.copy().view("<f2").astype(np.float32)

    if qtype == GGMLType.IQ2_XXS:
        b = buf.reshape(nb, TYPE_TRAITS[qtype].type_size)
        d = f16(b[:, :2]).reshape(nb)
        q16 = b[:, 2:].copy().view("<u2").reshape(nb, 8, 4)
        aux8 = q16[:, :, :2].copy().view(np.uint8).reshape(nb, 8, 4)
        aux32 = q16[:, :, 2].astype(np.uint32) | (q16[:, :, 3].astype(np.uint32) << 16)
        db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.25
        grid = IQ2XXS_GRID[aux8].astype(np.int16)
        sidx = (aux32[:, :, None] >> (7 * np.arange(4)[None, None, :])) & 127
        sbits = (KSIGNS[sidx][..., None] >> np.arange(8)) & 1
        q = grid * np.where(sbits != 0, -1, 1)
        return q.reshape(N, K).astype(np.int8), db.reshape(N, K // 32)
    if qtype == GGMLType.IQ2_XS:
        b = buf.reshape(nb, TYPE_TRAITS[qtype].type_size)
        d = f16(b[:, :2]).reshape(nb)
        q16 = b[:, 2:66].copy().view("<u2").reshape(nb, 32)
        scales = b[:, 66:74]
        ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16)
        db = d[:, None] * (0.5 + ls.astype(np.float32)) * 0.25
        grid = IQ2XS_GRID[q16 & 511].astype(np.int16)
        sbits = (KSIGNS[q16 >> 9][..., None] >> np.arange(8)) & 1
        q = grid * np.where(sbits != 0, -1, 1)
        return q.reshape(N, K).astype(np.int8), db.reshape(N, K // 16)
    if qtype == GGMLType.IQ2_S:
        b = buf.reshape(nb, TYPE_TRAITS[qtype].type_size)
        d = f16(b[:, :2]).reshape(nb)
        qs = b[:, 2:34]
        sign_bytes = b[:, 34:66]
        qh = b[:, 66:74]
        scales = b[:, 74:82]
        ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16)
        db = d[:, None] * (0.5 + ls.astype(np.float32)) * 0.25
        i = np.arange(32)
        hi = (qh[:, i // 4].astype(np.uint16) << (8 - 2 * (i % 4))) & 0x300
        grid = IQ2S_GRID[qs.astype(np.uint16) | hi].astype(np.int16)
        sbits = (sign_bytes[..., None] >> np.arange(8)) & 1
        q = grid * np.where(sbits != 0, -1, 1)
        return q.reshape(N, K).astype(np.int8), db.reshape(N, K // 16)
    if qtype == GGMLType.IQ3_XXS:
        b = buf.reshape(nb, TYPE_TRAITS[qtype].type_size)
        d = f16(b[:, :2]).reshape(nb)
        qs = b[:, 2:66]
        aux32 = b[:, 66:98].copy().view("<u4").reshape(nb, 8)
        db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.5
        grid = IQ3XXS_GRID[qs].astype(np.int16).reshape(nb, 8, 4, 8)
        sidx = (aux32[:, :, None] >> (7 * np.arange(4)[None, None, :])) & 127
        sbits = (KSIGNS[sidx][..., None] >> np.arange(8)) & 1
        q = grid * np.where(sbits != 0, -1, 1)
        return q.reshape(N, K).astype(np.int8), db.reshape(N, K // 32)
    if qtype == GGMLType.IQ3_S:
        b = buf.reshape(nb, TYPE_TRAITS[qtype].type_size)
        d = f16(b[:, :2]).reshape(nb)
        qs = b[:, 2:66]
        qh = b[:, 66:74]
        sign_bytes = b[:, 74:106]
        scales = b[:, 106:110]
        ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 8)
        db = d[:, None] * (1 + 2 * ls.astype(np.float32))
        i = np.arange(64)
        hi = (qh[:, i // 8].astype(np.uint16) << (8 - (i % 8))) & 0x100
        grid = IQ3S_GRID[qs.astype(np.uint16) | hi].astype(np.int16).reshape(nb, 8, 4, 8)
        sbits = (sign_bytes[..., None] >> np.arange(8)) & 1
        q = grid * np.where(sbits != 0, -1, 1).reshape(nb, 8, 4, 8)
        return q.reshape(N, K).astype(np.int8), db.reshape(N, K // 32)
    if qtype == GGMLType.IQ1_S:
        b = buf.reshape(nb, TYPE_TRAITS[qtype].type_size)
        d = f16(b[:, :2]).reshape(nb)
        qs = b[:, 2:34]
        qh = b[:, 34:50].copy().view("<u2").reshape(nb, 8).astype(np.uint32)
        dl8 = d[:, None] * (2 * ((qh >> 12) & 7).astype(np.float32) + 1) / 8.0
        delta8 = np.where((qh & 0x8000) != 0, -1, 1).astype(np.int16)  # 8*delta
        i = np.arange(32)
        idx = qs.astype(np.uint16) | (((qh[:, i // 4] >> (3 * (i % 4))) & 7) << 8).astype(np.uint16)
        grid = IQ1S_GRID[idx].astype(np.int16).reshape(nb, 8, 4, 8)
        q = 8 * grid + delta8[:, :, None, None]
        return q.reshape(N, K).astype(np.int8), dl8.reshape(N, K // 32)
    if qtype == GGMLType.IQ1_M:
        b = buf.reshape(nb, TYPE_TRAITS[qtype].type_size)
        qs = b[:, 0:32]
        qh = b[:, 32:48]
        sc = b[:, 48:56].copy().view("<u2").reshape(nb, 4).astype(np.uint32)
        sc_u16 = ((sc[:, 0] >> 12) | (((sc[:, 1] >> 12) & 0xF) << 4)
                  | (((sc[:, 2] >> 12) & 0xF) << 8) | (((sc[:, 3] >> 12) & 0xF) << 12))
        d = sc_u16.astype(np.uint16).view(np.float16).astype(np.float32)
        i16 = np.arange(16)
        ls = (sc[:, i16 // 4] >> (3 * (i16 % 4))) & 0x7
        dl8 = d[:, None] * (2 * ls.astype(np.float32) + 1) / 8.0
        i = np.arange(32)
        hi = ((qh[:, i // 2].astype(np.uint16) >> (4 * (i % 2))) & 7) << 8
        grid = IQ1S_GRID[qs.astype(np.uint16) | hi].astype(np.int16)  # [nb,32,8]
        dbit = ((qh[:, i // 2] >> (4 * (i % 2))) & 0x8) != 0
        delta8 = np.where(dbit, -1, 1).astype(np.int16)
        q = 8 * grid + delta8[:, :, None]
        return q.reshape(N, K).astype(np.int8), dl8.reshape(N, K // 16)
    if qtype in (GGMLType.TQ1_0, GGMLType.TQ2_0):
        fn = dequantize_tq1_0 if qtype == GGMLType.TQ1_0 else dequantize_tq2_0
        ts = TYPE_TRAITS[qtype].type_size
        b = buf.reshape(nb, ts)
        d = f16(b[:, 52:54] if qtype == GGMLType.TQ1_0 else b[:, 64:66]).reshape(nb)
        y = fn(buf, N * K).reshape(nb, QK_K)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = np.where(d[:, None] != 0, y / np.where(d[:, None] == 0, 1, d[:, None]), 0.0)
        with np.errstate(invalid="ignore"):
            q = np.rint(np.nan_to_num(q)).astype(np.int8)
        return q.reshape(N, K), d.reshape(N, K // 256)
    raise NotImplementedError(f"expand: {qtype.name}")
