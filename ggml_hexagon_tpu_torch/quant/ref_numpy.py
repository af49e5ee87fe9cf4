"""Reference (de)quantizers for GGUF block formats — NumPy, bit-faithful
(the port's own copy of ggml_hexagon_tpu/quant/ref_numpy.py; the port
imports nothing of the JAX package, and the CPU tests hold the two
byte-equal).

Semantics match the reference implementation (ggml/src/ggml-quants.c
quantize_row_*_ref / dequantize_row_*) so that perplexity parity holds: fp16
scale rounding, C-style float->int casts, nearest-even rounding where the
reference uses its `nearest_int` trick, and the exact scale-search algorithms
(`make_qx_quants`, `make_qkx2_quants`, `make_q3_quants`).  Everything is
vectorized over blocks; nothing here is a translation of C loops — the
algorithms are re-derived as array programs.

These are the *host-side* oracles: used for quantizing models, building test
fixtures, and as the correctness reference for the Pallas kernels
(tests mirror /root/reference tests/test-quantize-fns.cpp thresholds).
"""
from __future__ import annotations

import numpy as np

from .formats import GGMLType, QK_K, TYPE_TRAITS, row_size

GROUP_MAX_EPS = 1e-15


# ---------------------------------------------------------------------------
# rounding helpers
# ---------------------------------------------------------------------------

def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.trunc(x + np.copysign(np.float32(0.5), x))


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int: round-to-nearest-even (the 12582912 magic trick).

    The C trick operates on FLOAT values — inputs must round through f32
    first (numpy promotion quietly makes some quotients f64, which can
    round the other way at half-points; bit us in the r5 imatrix parity)."""
    return np.rint(np.asarray(x, np.float32)).astype(np.int32)


def _f16(x: np.ndarray) -> np.ndarray:
    """Round f32 -> f16 -> f32 (the precision the wire format stores)."""
    return np.asarray(x, dtype=np.float32).astype(np.float16).astype(np.float32)


def _signed_absmax(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (amax, signed value attaining amax), first occurrence wins.

    Matches the reference scan `if (amax < fabsf(v)) { amax = fabsf(v); max = v; }`
    which keeps the *first* element achieving the max magnitude.
    """
    ax = np.abs(x)
    idx = np.argmax(ax, axis=-1)
    rows = np.arange(x.shape[0])
    return ax[rows, idx], x[rows, idx]


def _blocks(x: np.ndarray, qk: int) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    assert x.size % qk == 0, f"size {x.size} not multiple of {qk}"
    return x.reshape(-1, qk)


# ---------------------------------------------------------------------------
# simple 32-element block formats
# ---------------------------------------------------------------------------

def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, 32)
    _, mx = _signed_absmax(xb)
    d = mx / -8.0
    with np.errstate(divide="ignore", invalid="ignore"):
        id = np.where(d != 0, 1.0 / d, 0.0).astype(np.float32)
    q = np.minimum(15, np.trunc(xb * id[:, None] + 8.5).astype(np.int32)).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = (lo | (hi << 4)).astype(np.uint8)
    nb = xb.shape[0]
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = qs
    return out.reshape(-1)


def dequantize_q4_0(buf: np.ndarray, n: int) -> np.ndarray:
    b = buf.reshape(-1, 18)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    qs = b[:, 2:]
    lo = (qs & 0x0F).astype(np.int32) - 8
    hi = (qs >> 4).astype(np.int32) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return out.reshape(-1)[:n]


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, 32)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 15.0
    with np.errstate(divide="ignore", invalid="ignore"):
        id = np.where(d != 0, 1.0 / d, 0.0).astype(np.float32)
    q = np.minimum(15, np.trunc((xb - mn[:, None]) * id[:, None] + 0.5).astype(np.int32)).astype(np.uint8)
    qs = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    nb = xb.shape[0]
    out = np.empty((nb, 20), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 4:] = qs
    return out.reshape(-1)


def dequantize_q4_1(buf: np.ndarray, n: int) -> np.ndarray:
    b = buf.reshape(-1, 20)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    qs = b[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)[:n]


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, 32)
    _, mx = _signed_absmax(xb)
    d = mx / -16.0
    with np.errstate(divide="ignore", invalid="ignore"):
        id = np.where(d != 0, 1.0 / d, 0.0).astype(np.float32)
    q = np.minimum(31, np.trunc(xb * id[:, None] + 16.5).astype(np.int32)).astype(np.uint32)
    lo, hi = q[:, :16], q[:, 16:]
    qs = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)
    shifts = np.arange(16, dtype=np.uint32)
    qh = (((lo >> 4) & 1) << shifts).sum(axis=1, dtype=np.uint32) | (
        ((hi >> 4) & 1) << (shifts + 16)
    ).sum(axis=1, dtype=np.uint32)
    nb = xb.shape[0]
    out = np.empty((nb, 22), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:6] = qh.astype("<u4").view(np.uint8).reshape(nb, 4)
    out[:, 6:] = qs
    return out.reshape(-1)


def dequantize_q5_0(buf: np.ndarray, n: int) -> np.ndarray:
    b = buf.reshape(-1, 22)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    qh = b[:, 2:6].copy().view("<u4").reshape(-1).astype(np.uint32)
    qs = b[:, 6:]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh[:, None] >> j) << 4) & 0x10
    xh1 = ((qh[:, None] >> (j + 16)) << 4) & 0x10
    lo = ((qs & 0x0F) | xh0).astype(np.int32) - 16
    hi = ((qs >> 4) | xh1).astype(np.int32) - 16
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return out.reshape(-1)[:n]


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, 32)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 31.0
    with np.errstate(divide="ignore", invalid="ignore"):
        id = np.where(d != 0, 1.0 / d, 0.0).astype(np.float32)
    q = np.trunc((xb - mn[:, None]) * id[:, None] + 0.5).astype(np.uint32)
    q = np.minimum(31, q)
    lo, hi = q[:, :16], q[:, 16:]
    qs = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)
    shifts = np.arange(16, dtype=np.uint32)
    qh = (((lo >> 4) & 1) << shifts).sum(axis=1, dtype=np.uint32) | (
        ((hi >> 4) & 1) << (shifts + 16)
    ).sum(axis=1, dtype=np.uint32)
    nb = xb.shape[0]
    out = np.empty((nb, 24), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 4:8] = qh.astype("<u4").view(np.uint8).reshape(nb, 4)
    out[:, 8:] = qs
    return out.reshape(-1)


def dequantize_q5_1(buf: np.ndarray, n: int) -> np.ndarray:
    b = buf.reshape(-1, 24)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    qh = b[:, 4:8].copy().view("<u4").reshape(-1).astype(np.uint32)
    qs = b[:, 8:]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh[:, None] >> j) << 4) & 0x10
    xh1 = ((qh[:, None] >> (j + 16)) << 4) & 0x10
    lo = ((qs & 0x0F) | xh0).astype(np.float32)
    hi = ((qs >> 4) | xh1).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)[:n]


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, 32)
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    with np.errstate(divide="ignore", invalid="ignore"):
        id = np.where(d != 0, 1.0 / d, 0.0).astype(np.float32)
    q = _roundf(xb * id[:, None]).astype(np.int8)
    nb = xb.shape[0]
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_0(buf: np.ndarray, n: int) -> np.ndarray:
    b = buf.reshape(-1, 34)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    q = b[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)[:n]


def quantize_q8_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, 32)
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    with np.errstate(divide="ignore", invalid="ignore"):
        id = np.where(d != 0, 1.0 / d, 0.0).astype(np.float32)
    q = _roundf(xb * id[:, None]).astype(np.int32)
    s = (d * q.sum(axis=1)).astype(np.float32)
    nb = xb.shape[0]
    out = np.empty((nb, 36), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = s.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 4:] = q.astype(np.int8).view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_1(buf: np.ndarray, n: int) -> np.ndarray:
    b = buf.reshape(-1, 36)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    q = b[:, 4:].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# K-quant scale-search primitives (vectorized over groups)
# ---------------------------------------------------------------------------

def make_qx_quants(
    x: np.ndarray, nmax: int, qw: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Per-group RMSE-optimal symmetric scale search (rmse_type=1).

    x: [G, n] groups.  Returns (L [G, n] in [0, 2*nmax-1] offset by +nmax,
    scale [G]).  Grid-searches 19 candidate inverse scales exactly like the
    reference (initial + is in -9..9, is != 0) keeping the weighted-LS refit.
    """
    G, n = x.shape
    xf = np.ascontiguousarray(x, np.float32)
    amax, mx = _signed_absmax(xf)
    dead = amax < GROUP_MAX_EPS
    w = ((xf * xf) if qw is None
         else np.ascontiguousarray(qw, np.float32))

    with np.errstate(divide="ignore", invalid="ignore"):
        iscale0 = np.where(
            dead, 0.0,
            -np.float32(nmax) / np.where(mx == 0, 1.0, mx)).astype(
            np.float32)

    def trial(iscale):
        # sequential f32 accumulation in the C loop's order — the
        # imatrix-weighted sums have enough dynamic range that numpy's
        # pairwise summation flips candidate decisions (r5 byte parity)
        l = np.clip(_nearest_int(iscale[:, None] * xf), -nmax, nmax - 1)
        lf = l.astype(np.float32)
        sumlx = np.zeros(G, np.float32)
        suml2 = np.zeros(G, np.float32)
        for j in range(n):
            sumlx += w[:, j] * xf[:, j] * lf[:, j]
            suml2 += w[:, j] * lf[:, j] * lf[:, j]
        return l, sumlx, suml2

    L, sumlx, suml2 = trial(iscale0)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 != 0, sumlx / suml2, 0.0).astype(np.float32)
    best = scale * sumlx
    for is_ in range(-9, 10):
        if is_ == 0:
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            isc = np.where(
                dead, 0.0,
                -(np.float32(nmax) + np.float32(0.1) * np.float32(is_))
                / np.where(mx == 0, 1.0, mx)).astype(np.float32)
        l, slx, sl2 = trial(isc)
        better = (sl2 > 0) & (slx * slx > best * sl2)
        if better.any():
            L = np.where(better[:, None], l, L)
            with np.errstate(divide="ignore", invalid="ignore"):
                scale = np.where(better, slx / sl2, scale).astype(
                    np.float32)
            best = np.where(better, scale * slx, best)
    L = np.where(dead[:, None], 0, L + nmax)
    scale = np.where(dead, 0.0, scale)
    return L.astype(np.int32), scale.astype(np.float32)


def make_qkx2_quants(
    x: np.ndarray,
    nmax: int,
    weights: np.ndarray,
    rmin: float,
    rdelta: float,
    nstep: int,
    use_mad: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Asymmetric (scale, min) search. x, weights: [G, n].

    Returns (L [G, n] in [0, nmax], scale [G], the_min [G]).
    """
    G, n = x.shape
    mn = np.minimum(x.min(axis=1), 0.0)
    mx = x.max(axis=1)
    sum_w = weights.sum(axis=1)
    sum_x = (weights * x).sum(axis=1)
    flat = mx == mn

    rng = np.where(flat, 1.0, mx - mn)
    iscale = nmax / rng
    scale = 1.0 / iscale

    def quant_at(isc, base):
        return np.clip(_nearest_int(isc[:, None] * (x - base[:, None])), 0, nmax)

    L = quant_at(iscale, mn)
    diff0 = scale[:, None] * L + mn[:, None] - x
    diff0 = np.abs(diff0) if use_mad else diff0 * diff0
    best_mad = (weights * diff0).sum(axis=1)
    cur_min = mn.copy()

    for is_ in range(nstep + 1):
        isc = (rmin + rdelta * is_ + nmax) / rng
        # the reference quantizes candidates against the RUNNING min
        # (updated on acceptance), not the original block min
        laux = quant_at(isc, cur_min)
        lf = laux.astype(np.float32)
        sum_l = _seq_sum(weights * lf)
        sum_l2 = _seq_sum(weights * lf * lf)
        sum_xl = _seq_sum(weights * lf * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            fixup = this_min > 0
            this_min = np.where(fixup, 0.0, this_min)
            this_scale = np.where(
                fixup, np.where(sum_l2 != 0, sum_xl / sum_l2, this_scale), this_scale
            )
        diff = this_scale[:, None] * laux + this_min[:, None] - x
        diff = np.abs(diff) if use_mad else diff * diff
        mad = (weights * diff).sum(axis=1)
        better = (D > 0) & (mad < best_mad)
        if better.any():
            L = np.where(better[:, None], laux, L)
            best_mad = np.where(better, mad, best_mad)
            scale = np.where(better, this_scale, scale)
            cur_min = np.where(better, this_min, cur_min)

    L = np.where(flat[:, None], 0, L)
    scale = np.where(flat, 0.0, scale)
    the_min = np.where(flat, -mn, -cur_min)
    return L.astype(np.int32), scale.astype(np.float32), the_min.astype(np.float32)


def _seq_sum(arr: np.ndarray) -> np.ndarray:
    """[G, n] -> [G] f32 sum in the C loop's sequential order (numpy's
    pairwise summation rounds differently; byte parity needs C order)."""
    acc = np.zeros(arr.shape[0], np.float32)
    a32 = arr.astype(np.float32, copy=False)
    for j in range(arr.shape[1]):
        acc += a32[:, j]
    return acc


def make_qkx3_quants(
    x: np.ndarray,
    nmax: int,
    weights: np.ndarray,
    rmin: float,
    rdelta: float,
    nstep: int,
    use_mad: bool,
    degenerate_leq: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact make_qkx3_quants (ggml-quants.c, the IMATRIX asymmetric
    search): like make_qkx2 but the degenerate gate is `max <= min`, and
    the candidate sweep recomputes iscale from the RUNNING min — both the
    (rmin + rdelta*is + nmax)/(max - min) denominator and the
    quantization offset track the accepted min.
    x, weights: [G, n].  Returns (L [G, n] in [0, nmax], scale, the_min).
    degenerate_leq=False gives make_qkx2_quants' `max == min` gate — the
    ONLY difference between the two C functions (when weights are given),
    so exact qkx2 consumers (Q2_K's plain path) call here with it."""
    G, n = x.shape
    mn0 = np.minimum(x.min(axis=1), 0.0).astype(np.float32)
    mx = x.max(axis=1).astype(np.float32)
    sum_w = _seq_sum(weights)
    sum_x = _seq_sum(weights * x)
    flat = (mx <= mn0) if degenerate_leq else (mx == mn0)

    rng0 = np.where(flat, 1.0, mx - mn0).astype(np.float32)
    iscale = (np.float32(nmax) / rng0).astype(np.float32)
    scale = (np.float32(1.0) / iscale).astype(np.float32)
    cur_min = mn0.copy()

    def quant_at(isc, base):
        return np.clip(_nearest_int(isc[:, None] * (x - base[:, None])),
                       0, nmax)

    L = quant_at(iscale, cur_min)
    diff0 = (scale[:, None] * L.astype(np.float32)
             + cur_min[:, None] - x)
    diff0 = np.abs(diff0) if use_mad else diff0 * diff0
    best_mad = _seq_sum(weights * diff0)

    for is_ in range(nstep + 1):
        rng = np.where(flat, 1.0, mx - cur_min).astype(np.float32)
        isc = (np.float32(rmin + rdelta * is_ + nmax) / rng).astype(
            np.float32)
        laux = quant_at(isc, cur_min)
        lf = laux.astype(np.float32)
        sum_l = _seq_sum(weights * lf)
        sum_l2 = _seq_sum(weights * lf * lf)
        sum_xl = _seq_sum(weights * lf * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = ((sum_w * sum_xl - sum_x * sum_l) / D).astype(
                np.float32)
            this_min = ((sum_l2 * sum_x - sum_l * sum_xl) / D).astype(
                np.float32)
            fixup = this_min > 0
            this_min = np.where(fixup, 0.0, this_min).astype(np.float32)
            this_scale = np.where(
                fixup, np.where(sum_l2 != 0, sum_xl / sum_l2, this_scale),
                this_scale).astype(np.float32)
        diff = this_scale[:, None] * lf + this_min[:, None] - x
        diff = np.abs(diff) if use_mad else diff * diff
        mad = _seq_sum(weights * diff)
        better = (D > 0) & (mad < best_mad)
        if better.any():
            L = np.where(better[:, None], laux, L)
            best_mad = np.where(better, mad, best_mad)
            scale = np.where(better, this_scale, scale)
            cur_min = np.where(better, this_min, cur_min)

    L = np.where(flat[:, None], 0, L)
    scale = np.where(flat, 0.0, scale)
    the_min = np.where(flat, -mn0, -cur_min)
    return (L.astype(np.int32), scale.astype(np.float32),
            the_min.astype(np.float32))


def make_qp_quants(x: np.ndarray, nmax: int, sw: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Exact make_qp_quants (ggml-quants.c — the IMATRIX super-scale
    quantizer): non-negative entries x [G, n] with per-entry weights sw,
    9-candidate iscale sweep + up-to-5 rounds of coordinate descent.
    Returns (L [G, n] int, scale [G])."""
    G, n = x.shape
    xf = np.ascontiguousarray(x, np.float32)
    swf = np.ascontiguousarray(sw, np.float32)
    mx = xf.max(axis=1)
    zero = mx == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(zero, 0.0, nmax / np.where(mx == 0, 1.0, mx)
                          ).astype(np.float32)
        scale = np.where(zero, 0.0, 1.0 / np.where(iscale == 0, 1.0,
                                                   iscale)).astype(
            np.float32)
    L0 = _nearest_int(iscale[:, None] * xf).astype(np.float32)
    d0 = xf - scale[:, None] * L0
    best_mse = _seq_sum(swf * d0 * d0)
    for is_ in range(-4, 5):
        if is_ == 0:
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            isc = (np.float32(0.1 * is_ + nmax)
                   / np.where(mx == 0, 1.0, mx)).astype(np.float32)
            sc_is = (1.0 / isc).astype(np.float32)
        l = np.minimum(nmax, _nearest_int(isc[:, None] * xf)).astype(
            np.float32)
        di = xf - sc_is[:, None] * l
        mse = _seq_sum(swf * di * di)
        upd = ~zero & (mse < best_mse)
        best_mse = np.where(upd, mse, best_mse)
        iscale = np.where(upd, isc, iscale)
    L = np.minimum(nmax, _nearest_int(iscale[:, None] * xf)).astype(
        np.int32)
    Lf = L.astype(np.float32)
    sumlx = _seq_sum(swf * xf * Lf)
    suml2 = _seq_sum(swf * Lf * Lf)
    for _ in range(5):
        changed = np.zeros(G, dtype=bool)
        for i in range(n):
            # all products stay f32 (int32 operands promote numpy to f64,
            # which rounds make_qp's running sums differently than the C
            # f32 chain — one f16 ulp of d was enough to flip bytes)
            w, xi = swf[:, i], xf[:, i]
            li = L[:, i]
            lif = li.astype(np.float32)
            slx = sumlx - w * xi * lif
            sl2 = suml2 - w * lif * lif
            cond = (slx > 0) & (sl2 > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                new_l = np.minimum(nmax, _nearest_int(
                    np.where(cond, xi * sl2 / np.where(slx == 0, 1.0, slx),
                             lif)))
            nlf = new_l.astype(np.float32)
            neq = cond & (new_l != li)
            slx2 = (slx + w * xi * nlf).astype(np.float32)
            sl22 = (sl2 + w * nlf * nlf).astype(np.float32)
            acc = neq & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(acc, new_l, li)
            sumlx = np.where(acc, slx2, sumlx)
            suml2 = np.where(acc, sl22, suml2)
            changed |= acc
        if not changed.any():
            break
    with np.errstate(divide="ignore", invalid="ignore"):
        out_scale = np.where(zero | (suml2 == 0), 0.0,
                             sumlx / np.where(suml2 == 0, 1.0, suml2))
    return L, out_scale.astype(np.float32)


def make_q3_quants(x: np.ndarray, nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric search with coordinate-descent refinement (do_rmse=true).

    x: [G, n].  Returns (L [G, n] offset +nmax, scale [G]).
    """
    G, n = x.shape
    xf = np.ascontiguousarray(x, np.float32)
    amax, mx = _signed_absmax(xf)
    dead = amax < GROUP_MAX_EPS
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(
            dead, 0.0,
            -np.float32(nmax) / np.where(mx == 0, 1.0, mx)).astype(
            np.float32)
    L = np.clip(_nearest_int(iscale[:, None] * xf), -nmax, nmax - 1)
    w = xf * xf
    # f32 sums in C order (see _seq_sum); int operands stay out of the
    # products so numpy can't promote them to f64
    Lf = L.astype(np.float32)
    sumlx = _seq_sum(w * xf * Lf)
    suml2 = _seq_sum(w * Lf * Lf)
    for _ in range(5):
        n_changed = np.zeros(G, dtype=bool)
        for i in range(n):
            wi, xi, li = w[:, i], xf[:, i], L[:, i]
            lif = li.astype(np.float32)
            slx = (sumlx - wi * xi * lif).astype(np.float32)
            sl2 = (suml2 - wi * lif * lif).astype(np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                new_l = np.clip(
                    _nearest_int(np.where(
                        slx > 0,
                        xi * sl2 / np.where(slx == 0, 1, slx), lif)),
                    -nmax,
                    nmax - 1,
                )
            nlf = new_l.astype(np.float32)
            cand = (slx > 0) & (new_l != li)
            slx2 = (slx + wi * xi * nlf).astype(np.float32)
            sl22 = (sl2 + wi * nlf * nlf).astype(np.float32)
            accept = cand & (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(accept, new_l, li)
            sumlx = np.where(accept, slx2, sumlx)
            suml2 = np.where(accept, sl22, suml2)
            n_changed |= accept
        if not n_changed.any():
            break
    L = np.where(dead[:, None], 0, L + nmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where((suml2 > 0) & ~dead, sumlx / suml2, 0.0)
    return L.astype(np.int32), scale.astype(np.float32)


# ---------------------------------------------------------------------------
# K-quants
# ---------------------------------------------------------------------------

def _pack_k4_scales(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """Pack 8 6-bit (scale, min) pairs into 12 bytes (block_q4_K.scales)."""
    nb = ls.shape[0]
    sc = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(8):
        if j < 4:
            sc[:, j] = ls[:, j]
            sc[:, j + 4] = lm[:, j]
        else:
            sc[:, j + 4] = (ls[:, j] & 0xF) | ((lm[:, j] & 0xF) << 4)
            sc[:, j - 4] |= (ls[:, j] >> 4) << 6
            sc[:, j] |= (lm[:, j] >> 4) << 6
    return sc


def _unpack_k4_scales(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of _pack_k4_scales -> (sc6 [nb, 8], m6 [nb, 8]) as int32."""
    nb = sc.shape[0]
    d6 = np.zeros((nb, 8), dtype=np.int32)
    m6 = np.zeros((nb, 8), dtype=np.int32)
    for j in range(8):
        if j < 4:
            d6[:, j] = sc[:, j] & 63
            m6[:, j] = sc[:, j + 4] & 63
        else:
            d6[:, j] = (sc[:, j + 4] & 0xF) | ((sc[:, j - 4] >> 6) << 4)
            m6[:, j] = (sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)
    return d6, m6


def _q45_imatrix_scales(xb: np.ndarray, qw: np.ndarray, nmax_g: int):
    """Shared head of quantize_row_q{4,5}_K_impl's imatrix path:
    per-super-block sigma2 = 2*Σx²/256, weight = qw*sqrt(sigma2 + x²),
    make_qkx3(-0.9, .05, 36) group scales/mins, make_qp(63) super-scales.
    Returns (L3 [nb,8,32], sc_packed, d, dmin)."""
    nb = xb.shape[0]
    g = xb.reshape(nb * 8, 32)
    sigma2 = np.float32(2.0) * _seq_sum(xb * xb) / np.float32(QK_K)
    weights = (qw.reshape(nb * 8, 32)
               * np.sqrt(sigma2.repeat(8)[:, None] + g * g)).astype(
        np.float32)
    L3, scales, mins = make_qkx3_quants(g, nmax_g, weights, -0.9, 0.05,
                                        36, False)
    sw = _seq_sum(weights).reshape(nb, 8)
    Ls, dm = make_qp_quants(scales.reshape(nb, 8), 63, sw)
    Lm, mm = make_qp_quants(mins.reshape(nb, 8), 63, sw)
    sc_packed = _pack_k4_scales(np.minimum(63, Ls).astype(np.uint8),
                                np.minimum(63, Lm).astype(np.uint8))
    return L3.reshape(nb, 8, 32), sc_packed, _f16(dm), _f16(mm)


def quantize_q4_K(x: np.ndarray, quant_weights: np.ndarray | None = None) -> np.ndarray:
    xb = _blocks(x, QK_K)
    nb = xb.shape[0]
    g = xb.reshape(nb * 8, 32)  # 8 sub-blocks of 32
    if quant_weights is not None:
        qw = np.ascontiguousarray(quant_weights, np.float32).reshape(
            nb, QK_K)
        L3, sc_packed, d, dmin = _q45_imatrix_scales(xb, qw, 15)
        d6, m6 = _unpack_k4_scales(sc_packed)
        # C: const float d = fp16(d)*sc — f32 multiply; an int32 operand
        # promotes numpy to f64, whose extra precision flips half-way
        # requantize roundings (2 bytes in 5.6 MB on the parity model)
        dl = d[:, None] * d6.astype(np.float32)
        ml = dmin[:, None] * m6.astype(np.float32)
        gx = xb.reshape(nb, 8, 32)
        with np.errstate(divide="ignore", invalid="ignore"):
            l = _nearest_int((gx + ml[:, :, None])
                             / np.where(dl == 0, 1.0, dl)[:, :, None])
        l = np.where((dl != 0)[:, :, None], np.clip(l, 0, 15),
                     L3).astype(np.uint8)
        l2 = l.reshape(nb, 4, 2, 32)
        qs = (l2[:, :, 0, :] | (l2[:, :, 1, :] << 4)).reshape(nb, 128)
        out = np.empty((nb, TYPE_TRAITS[GGMLType.Q4_K].type_size),
                       dtype=np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 4:16] = sc_packed
        out[:, 16:] = qs
        return out.reshape(-1)
    f32 = np.float32
    av = np.sqrt(_seq_sum(g * g) / f32(32.0))[:, None]
    weights = (av + np.abs(g)).astype(f32)
    L2, scales, mins = make_qkx3_quants(g, 15, weights, -1.0, 0.1, 20,
                                        False, degenerate_leq=False)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(max_scale > 0, f32(63.0)
                             / np.where(max_scale == 0, 1,
                                        max_scale).astype(f32),
                             0.0).astype(f32)
        inv_min = np.where(max_min > 0, f32(63.0)
                           / np.where(max_min == 0, 1,
                                      max_min).astype(f32), 0.0).astype(f32)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales)
                    & 0xFF).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins)
                    & 0xFF).astype(np.uint8)
    sc_packed = _pack_k4_scales(ls, lm)
    d = _f16(max_scale.astype(f32) / f32(63.0))
    dmin = _f16(max_min.astype(f32) / f32(63.0))
    # requantize with quantized scales (C `if (!d) continue` keeps qkx2 L)
    d6, m6 = _unpack_k4_scales(sc_packed)
    dl = (d[:, None] * d6).astype(f32)  # [nb, 8]
    ml = (dmin[:, None] * m6).astype(f32)
    gx = xb.reshape(nb, 8, 32)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = _nearest_int((gx + ml[:, :, None]) / np.where(dl == 0, 1.0, dl).astype(f32)[:, :, None])
    l = np.where((dl != 0)[:, :, None], np.clip(l, 0, 15),
                 L2.reshape(nb, 8, 32)).astype(np.uint8)
    # pack nibbles: per 64 elems, 32 bytes of lo|hi<<4
    l2 = l.reshape(nb, 4, 2, 32)
    qs = (l2[:, :, 0, :] | (l2[:, :, 1, :] << 4)).reshape(nb, 128)
    out = np.empty((nb, TYPE_TRAITS[GGMLType.Q4_K].type_size), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = sc_packed
    out[:, 16:] = qs
    return out.reshape(-1)


def dequantize_q4_K(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.Q4_K].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(nb)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(nb)
    d6, m6 = _unpack_k4_scales(b[:, 4:16])
    qs = b[:, 16:].reshape(nb, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)  # [nb, subblock, 32]
    dl = d[:, None] * d6
    ml = dmin[:, None] * m6
    out = dl[:, :, None] * q - ml[:, :, None]
    return out.reshape(-1)[:n]


def quantize_q5_K(x: np.ndarray, quant_weights: np.ndarray | None = None) -> np.ndarray:
    xb = _blocks(x, QK_K)
    nb = xb.shape[0]
    g = xb.reshape(nb * 8, 32)
    if quant_weights is None:
        av = np.sqrt((g * g).mean(axis=1, keepdims=True))
        weights = av + np.abs(g)
    else:
        qw = np.ascontiguousarray(quant_weights, np.float32).reshape(
            nb, QK_K)
        L3, sc_packed, d, dmin = _q45_imatrix_scales(xb, qw, 31)
        d6, m6 = _unpack_k4_scales(sc_packed)
        # C: const float d = fp16(d)*sc — f32 multiply; an int32 operand
        # promotes numpy to f64, whose extra precision flips half-way
        # requantize roundings (2 bytes in 5.6 MB on the parity model)
        dl = d[:, None] * d6.astype(np.float32)
        ml = dmin[:, None] * m6.astype(np.float32)
        gx = xb.reshape(nb, 8, 32)
        with np.errstate(divide="ignore", invalid="ignore"):
            l = _nearest_int((gx + ml[:, :, None])
                             / np.where(dl == 0, 1.0, dl)[:, :, None])
        L = np.where((dl != 0)[:, :, None], np.clip(l, 0, 31),
                     L3).astype(np.int32).reshape(nb, QK_K)
        qh = np.zeros((nb, 32), dtype=np.uint8)
        ql = np.empty((nb, 4, 32), dtype=np.uint8)
        Lc = L.reshape(nb, 4, 2, 32)
        for c in range(4):
            l1 = Lc[:, c, 0, :]
            l2 = Lc[:, c, 1, :]
            qh |= (((l1 > 15).astype(np.uint8) << (2 * c))
                   | ((l2 > 15).astype(np.uint8) << (2 * c + 1)))
            ql[:, c, :] = ((l1 & 0xF) | ((l2 & 0xF) << 4)).astype(np.uint8)
        out = np.empty((nb, TYPE_TRAITS[GGMLType.Q5_K].type_size),
                       dtype=np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 4:16] = sc_packed
        out[:, 16:48] = qh
        out[:, 48:] = ql.reshape(nb, 128)
        return out.reshape(-1)
    f32 = np.float32
    av = np.sqrt(_seq_sum(g * g) / f32(32.0))[:, None]
    weights = (av + np.abs(g)).astype(f32)
    L2, scales, mins = make_qkx3_quants(g, 31, weights, -0.5, 0.1, 15,
                                        False, degenerate_leq=False)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(max_scale > 0, f32(63.0)
                             / np.where(max_scale == 0, 1,
                                        max_scale).astype(f32),
                             0.0).astype(f32)
        inv_min = np.where(max_min > 0, f32(63.0)
                           / np.where(max_min == 0, 1,
                                      max_min).astype(f32), 0.0).astype(f32)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales)
                    & 0xFF).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins)
                    & 0xFF).astype(np.uint8)
    sc_packed = _pack_k4_scales(ls, lm)
    d = _f16(max_scale.astype(f32) / f32(63.0))
    dmin = _f16(max_min.astype(f32) / f32(63.0))
    d6, m6 = _unpack_k4_scales(sc_packed)
    dl = (d[:, None] * d6).astype(f32)
    ml = (dmin[:, None] * m6).astype(f32)
    gx = xb.reshape(nb, 8, 32)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = _nearest_int((gx + ml[:, :, None]) / np.where(dl == 0, 1.0, dl).astype(f32)[:, :, None])
    L = np.where((dl != 0)[:, :, None], np.clip(l, 0, 31),
                 L2.reshape(nb, 8, 32)).astype(np.int32).reshape(nb, QK_K)
    # pack: per 64-elem chunk c (0..3): ql nibbles, qh bits 2c / 2c+1
    qh = np.zeros((nb, 32), dtype=np.uint8)
    ql = np.empty((nb, 4, 32), dtype=np.uint8)
    Lc = L.reshape(nb, 4, 2, 32)
    for c in range(4):
        l1 = Lc[:, c, 0, :]
        l2 = Lc[:, c, 1, :]
        qh |= ((l1 > 15).astype(np.uint8) << (2 * c)) | ((l2 > 15).astype(np.uint8) << (2 * c + 1))
        ql[:, c, :] = ((l1 & 0xF) | ((l2 & 0xF) << 4)).astype(np.uint8)
    out = np.empty((nb, TYPE_TRAITS[GGMLType.Q5_K].type_size), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = sc_packed
    out[:, 16:48] = qh
    out[:, 48:] = ql.reshape(nb, 128)
    return out.reshape(-1)


def dequantize_q5_K(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.Q5_K].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(nb)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(nb)
    d6, m6 = _unpack_k4_scales(b[:, 4:16])
    qh = b[:, 16:48]
    ql = b[:, 48:].reshape(nb, 4, 32)
    out = np.empty((nb, 8, 32), dtype=np.float32)
    dl = d[:, None] * d6
    ml = dmin[:, None] * m6
    for c in range(4):
        hi_bit1 = (qh >> (2 * c)) & 1
        hi_bit2 = (qh >> (2 * c + 1)) & 1
        q1 = (ql[:, c, :] & 0x0F).astype(np.float32) + hi_bit1 * 16.0
        q2 = (ql[:, c, :] >> 4).astype(np.float32) + hi_bit2 * 16.0
        out[:, 2 * c, :] = dl[:, 2 * c, None] * q1 - ml[:, 2 * c, None]
        out[:, 2 * c + 1, :] = dl[:, 2 * c + 1, None] * q2 - ml[:, 2 * c + 1, None]
    return out.reshape(-1)[:n]


def quantize_q6_K(x: np.ndarray, quant_weights: np.ndarray | None = None) -> np.ndarray:
    xb = _blocks(x, QK_K)
    nb = xb.shape[0]
    g = xb.reshape(nb * 16, 16)
    if quant_weights is None:
        qw = None
    else:
        # quantize_row_q6_K_impl passes the RAW imatrix weights to
        # make_qx_quants — its sigma2 weighting is commented out in the
        # reference (ggml-quants.c): using it here broke byte parity (r5)
        qw = np.ascontiguousarray(
            quant_weights, np.float32).reshape(nb * 16, 16)
    _, scales = make_qx_quants(g, 32, qw)
    scales = scales.reshape(nb, 16)
    aidx = np.argmax(np.abs(scales), axis=1)
    rows = np.arange(nb)
    max_scale = scales[rows, aidx]
    max_abs = np.abs(max_scale)
    dead = max_abs < GROUP_MAX_EPS
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(dead, 0.0, -128.0 / np.where(max_scale == 0, 1.0, max_scale))
        d16 = _f16(np.where(dead, 0.0, 1.0 / np.where(iscale == 0, 1.0, iscale)))
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    dl = d16[:, None] * sc8.astype(np.float32)  # [nb, 16]
    gx = xb.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = _nearest_int(gx / np.where(dl == 0, 1.0, dl)[:, :, None])
    L = np.where((dl != 0)[:, :, None], np.clip(l, -32, 31), 0) + 32
    L = np.where(dead[:, None, None], 32 * 0, L)  # dead blocks: all handled below
    L = L.reshape(nb, QK_K).astype(np.int32)
    L = np.where(dead[:, None], 0, L)
    # pack ql/qh: per 128-elem half h (0,1): quarters q0..q3 of 32
    Lh = L.reshape(nb, 2, 4, 32)
    ql = np.empty((nb, 2, 2, 32), dtype=np.uint8)
    qh = np.empty((nb, 2, 32), dtype=np.uint8)
    for h in range(2):
        q1, q2, q3, q4 = (Lh[:, h, k, :] for k in range(4))
        ql[:, h, 0, :] = ((q1 & 0xF) | ((q3 & 0xF) << 4)).astype(np.uint8)
        ql[:, h, 1, :] = ((q2 & 0xF) | ((q4 & 0xF) << 4)).astype(np.uint8)
        qh[:, h, :] = ((q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)).astype(
            np.uint8
        )
    ts = TYPE_TRAITS[GGMLType.Q6_K].type_size
    out = np.empty((nb, ts), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = np.where(dead[:, None], 0, sc8.astype(np.int16)).astype(np.int8).view(np.uint8)
    out[:, 208:210] = np.where(dead, 0.0, d16).astype(np.float16).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def dequantize_q6_K(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.Q6_K].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 2, 32)
    qh = b[:, 128:192].reshape(nb, 2, 32)
    sc = b[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = b[:, 208:210].copy().view(np.float16).astype(np.float32).reshape(nb)
    out = np.empty((nb, 2, 4, 32), dtype=np.float32)
    for h in range(2):
        q1 = ((ql[:, h, 0, :] & 0xF) | (((qh[:, h, :] >> 0) & 3) << 4)).astype(np.int32) - 32
        q2 = ((ql[:, h, 1, :] & 0xF) | (((qh[:, h, :] >> 2) & 3) << 4)).astype(np.int32) - 32
        q3 = ((ql[:, h, 0, :] >> 4) | (((qh[:, h, :] >> 4) & 3) << 4)).astype(np.int32) - 32
        q4 = ((ql[:, h, 1, :] >> 4) | (((qh[:, h, :] >> 6) & 3) << 4)).astype(np.int32) - 32
        base = 8 * h
        for k, q in enumerate((q1, q2, q3, q4)):
            # scale index: within 128-half, quarter k covers elems [32k,32k+32) ->
            # scales (2k + l//16), l in 0..31
            s_lo = sc[:, base + 2 * k]
            s_hi = sc[:, base + 2 * k + 1]
            dd = d[:, None]
            out[:, h, k, :16] = dd * s_lo[:, None] * q[:, :16]
            out[:, h, k, 16:] = dd * s_hi[:, None] * q[:, 16:]
    return out.reshape(-1)[:n]


def _quantize_q2_K_imatrix(xb: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """Exact quantize_row_q2_K_impl (the reference's IMATRIX path):
    weight = qw*sqrt(sigma2 + x^2) per 16-group, make_qkx3(-0.9, .05, 36),
    make_qp super-scales (15), then requantize keeping the qkx3 codes
    where the quantized group scale collapsed to zero."""
    nb = xb.shape[0]
    g = xb.reshape(nb * 16, 16)
    sigma2 = _seq_sum(xb * xb) / np.float32(QK_K)
    weights = (qw.reshape(nb * 16, 16)
               * np.sqrt(sigma2.repeat(16)[:, None] + g * g)).astype(
        np.float32)
    L3, scales, mins = make_qkx3_quants(g, 3, weights, -0.9, 0.05, 36,
                                        False)
    sw = _seq_sum(weights).reshape(nb, 16)
    Ls, dm = make_qp_quants(scales.reshape(nb, 16), 15, sw)
    Lm, mm = make_qp_quants(mins.reshape(nb, 16), 15, sw)
    d = _f16(dm)
    dmin = _f16(mm)
    sc_packed = (Ls.astype(np.uint8) | (Lm.astype(np.uint8) << 4))
    dl = d[:, None] * (sc_packed & 0xF).astype(np.float32)
    ml = dmin[:, None] * (sc_packed >> 4).astype(np.float32)
    gx = xb.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = _nearest_int((gx + ml[:, :, None])
                         / np.where(dl == 0, 1.0, dl)[:, :, None])
    # groups whose quantized scale is 0 KEEP the qkx3 codes (C `continue`)
    L = np.where((dl != 0)[:, :, None], np.clip(l, 0, 3),
                 L3.reshape(nb, 16, 16)).reshape(nb, QK_K).astype(np.uint8)
    Lh = L.reshape(nb, 2, 4, 32)
    qs = (Lh[:, :, 0, :] | (Lh[:, :, 1, :] << 2) | (Lh[:, :, 2, :] << 4)
          | (Lh[:, :, 3, :] << 6)).reshape(nb, 64)
    ts = TYPE_TRAITS[GGMLType.Q2_K].type_size
    out = np.empty((nb, ts), dtype=np.uint8)
    out[:, 0:16] = sc_packed
    out[:, 16:80] = qs
    out[:, 80:82] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 82:84] = dmin.astype(np.float16).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def quantize_q2_K(x: np.ndarray, quant_weights: np.ndarray | None = None) -> np.ndarray:
    xb = _blocks(x, QK_K)
    nb = xb.shape[0]
    if quant_weights is not None:
        return _quantize_q2_K_imatrix(
            xb, np.ascontiguousarray(quant_weights,
                                     np.float32).reshape(nb, QK_K))
    g = xb.reshape(nb * 16, 16)
    weights = np.abs(g)
    L2, scales, mins = make_qkx3_quants(g, 3, weights, -0.5, 0.1, 15,
                                        True, degenerate_leq=False)
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    q4scale = 15.0
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    sc4 = np.zeros((nb, 16), dtype=np.uint8)
    pos = max_scale > 0
    f32 = np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        isc = np.where(pos, f32(q4scale) / np.where(
            max_scale == 0, 1, max_scale).astype(f32), 0.0).astype(f32)
    sc4 = np.where(pos[:, None], _nearest_int(isc[:, None] * scales), 0).astype(np.uint8)
    d = np.where(pos, _f16(max_scale.astype(f32) / f32(q4scale)),
                 0.0).astype(f32)
    posm = max_min > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscm = np.where(posm, f32(q4scale) / np.where(
            max_min == 0, 1, max_min).astype(f32), 0.0).astype(f32)
    m4 = np.where(posm[:, None], _nearest_int(iscm[:, None] * mins), 0).astype(np.uint8)
    dmin = np.where(posm, _f16(max_min.astype(f32) / f32(q4scale)),
                    0.0).astype(f32)
    sc_packed = (sc4 | (m4 << 4)).astype(np.uint8)
    # requantize (C `if (!d) continue` keeps the qkx2 codes)
    dl = d[:, None] * (sc_packed & 0xF).astype(f32)
    ml = dmin[:, None] * (sc_packed >> 4).astype(f32)
    gx = xb.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = _nearest_int((gx + ml[:, :, None]).astype(f32)
                         / np.where(dl == 0, 1.0, dl).astype(
                             f32)[:, :, None])
    L = np.where((dl != 0)[:, :, None], np.clip(l, 0, 3),
                 L2.reshape(nb, 16, 16)).reshape(nb, QK_K).astype(np.uint8)
    # pack 2-bit: per 128-half, qs byte l = L[l] | L[l+32]<<2 | L[l+64]<<4 | L[l+96]<<6
    Lh = L.reshape(nb, 2, 4, 32)
    qs = (
        Lh[:, :, 0, :] | (Lh[:, :, 1, :] << 2) | (Lh[:, :, 2, :] << 4) | (Lh[:, :, 3, :] << 6)
    ).reshape(nb, 64)
    ts = TYPE_TRAITS[GGMLType.Q2_K].type_size
    out = np.empty((nb, ts), dtype=np.uint8)
    out[:, 0:16] = sc_packed
    out[:, 16:80] = qs
    out[:, 80:82] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 82:84] = dmin.astype(np.float16).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def dequantize_q2_K(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.Q2_K].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    sc = b[:, 0:16]
    qs = b[:, 16:80].reshape(nb, 2, 32)
    d = b[:, 80:82].copy().view(np.float16).astype(np.float32).reshape(nb)
    dmin = b[:, 82:84].copy().view(np.float16).astype(np.float32).reshape(nb)
    out = np.empty((nb, 2, 4, 2, 16), dtype=np.float32)
    for h in range(2):
        for j in range(4):
            q32 = (qs[:, h, :] >> (2 * j)) & 3
            for half in range(2):
                is_ = 8 * h + 2 * j + half
                dl = d * (sc[:, is_] & 0xF).astype(np.float32)
                ml = dmin * (sc[:, is_] >> 4).astype(np.float32)
                out[:, h, j, half, :] = (
                    dl[:, None] * q32[:, 16 * half : 16 * half + 16].astype(np.float32)
                    - ml[:, None]
                )
    return out.reshape(-1)[:n]


def quantize_q3_K(x: np.ndarray, quant_weights: np.ndarray | None = None) -> np.ndarray:
    xb = _blocks(x, QK_K)
    nb = xb.shape[0]
    g = xb.reshape(nb * 16, 16)
    L_grp = None
    if quant_weights is None:
        L_grp, scales = make_q3_quants(g, 4)
        L_grp = L_grp.reshape(nb, 16, 16)
        scales = scales.reshape(nb, 16)
        aidx = np.argmax(np.abs(scales), axis=1)
        rows = np.arange(nb)
        max_scale = scales[rows, aidx]
        nz = max_scale != 0
        with np.errstate(divide="ignore", invalid="ignore"):
            iscale = np.where(
                nz, np.float32(-32.0)
                / np.where(max_scale == 0, 1, max_scale).astype(
                    np.float32), 0.0).astype(np.float32)
        l6 = (np.clip(_nearest_int(iscale[:, None] * scales), -32, 31)
              + 32).astype(np.int32)
        l6 = np.where(nz[:, None], l6, 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            d16 = np.where(
                nz, _f16(np.float32(1.0)
                         / np.where(iscale == 0, 1, iscale).astype(
                             np.float32)), 0.0).astype(np.float32)
    else:
        # quantize_row_q3_K_impl imatrix path: group make_qx with
        # weight = qw*sqrt(2*Σx²/256 + x²), SUPER-scale ALSO via
        # make_qx_quants over the 16 group scales weighted by the group
        # weight sums (not the -32/max normalization)
        qw = np.ascontiguousarray(quant_weights, np.float32).reshape(nb, QK_K)
        sigma2 = (np.float32(2.0) * _seq_sum(xb * xb)
                  / np.float32(QK_K))[:, None]
        w = (qw * np.sqrt(sigma2 + xb * xb)).reshape(nb * 16, 16).astype(
            np.float32)
        L_grp, scales = make_qx_quants(g, 4, w)
        L_grp = L_grp.reshape(nb, 16, 16)  # +4-offset group codes
        sw = _seq_sum(w).reshape(nb, 16)
        scales = scales.reshape(nb, 16)
        l6, d_block = make_qx_quants(scales, 32, sw)  # +32-offset 6-bit
        d16 = _f16(d_block)
    # pack 6-bit scales into 12 bytes
    scb = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(16):
        lj = l6[:, j]
        if j < 8:
            scb[:, j] |= (lj & 0xF).astype(np.uint8)
        else:
            scb[:, j - 8] |= ((lj & 0xF) << 4).astype(np.uint8)
        scb[:, 8 + j % 4] |= ((lj >> 4) << (2 * (j // 4))).astype(np.uint8)
    # re-extract 6-bit scales (identical to pack inverse) and requantize
    sc6 = np.zeros((nb, 16), dtype=np.int32)
    for j in range(16):
        lo = (scb[:, j] & 0xF) if j < 8 else (scb[:, j - 8] >> 4)
        hi = (scb[:, 8 + j % 4] >> (2 * (j // 4))) & 3
        sc6[:, j] = (lo | (hi << 4)).astype(np.int32) - 32
    dl = d16[:, None] * sc6.astype(np.float32)
    gx = xb.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = _nearest_int(gx / np.where(dl == 0, 1.0, dl)[:, :, None])
    keep = (L_grp - 4) if L_grp is not None else 0  # imatrix: zero-scale
    # groups keep the group-level make_qx codes (C `continue`)
    L = np.where((dl != 0)[:, :, None], np.clip(l, -4, 3), keep) + 4
    L = L.reshape(nb, QK_K).astype(np.int32)
    # hmask: bit set when L > 3 (then L -= 4); bit index: elem j -> byte j%32, bit j//32
    hm_bit = (L > 3).astype(np.uint8)
    L = np.where(L > 3, L - 4, L)
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    Lr = hm_bit.reshape(nb, 8, 32)
    for bit in range(8):
        hmask |= Lr[:, bit, :] << bit
    Lh = L.reshape(nb, 2, 4, 32)
    qs = (
        Lh[:, :, 0, :] | (Lh[:, :, 1, :] << 2) | (Lh[:, :, 2, :] << 4) | (Lh[:, :, 3, :] << 6)
    ).astype(np.uint8).reshape(nb, 64)
    ts = TYPE_TRAITS[GGMLType.Q3_K].type_size
    out = np.empty((nb, ts), dtype=np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = scb
    out[:, 108:110] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def dequantize_q3_K(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.Q3_K].type_size
    b = buf.reshape(-1, ts)
    nb = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(nb, 2, 32)
    scb = b[:, 96:108]
    d = b[:, 108:110].copy().view(np.float16).astype(np.float32).reshape(nb)
    sc6 = np.zeros((nb, 16), dtype=np.int32)
    for j in range(16):
        lo = (scb[:, j] & 0xF) if j < 8 else (scb[:, j - 8] >> 4)
        hi = (scb[:, 8 + j % 4] >> (2 * (j // 4))) & 3
        sc6[:, j] = (lo | (hi << 4)).astype(np.int32) - 32
    out = np.empty((nb, 2, 4, 2, 16), dtype=np.float32)
    for h in range(2):
        for j in range(4):
            q32 = ((qs[:, h, :] >> (2 * j)) & 3).astype(np.int32)
            m = 1 << (4 * h + j)
            hb32 = ((hmask & m) != 0).astype(np.int32)
            qv = q32 - np.where(hb32 != 0, 0, 4)
            for half in range(2):
                is_ = 8 * h + 2 * j + half
                dl = d * sc6[:, is_].astype(np.float32)
                out[:, h, j, half, :] = dl[:, None] * qv[:, 16 * half : 16 * half + 16]
    return out.reshape(-1)[:n]


def quantize_q8_K(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x, QK_K)
    nb = xb.shape[0]
    amax, mx = _signed_absmax(xb)
    dead = amax == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(dead, 0.0, -128.0 / np.where(mx == 0, 1, mx))
    q = np.minimum(127, _nearest_int(iscale[:, None] * xb)).astype(np.int32)
    q = np.where(dead[:, None], 0, q)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(dead, 0.0, 1.0 / np.where(iscale == 0, 1, iscale)).astype(np.float32)
    bsums = q.reshape(nb, 16, 16).sum(axis=2).astype(np.int16)
    ts = TYPE_TRAITS[GGMLType.Q8_K].type_size
    out = np.empty((nb, ts), dtype=np.uint8)
    out[:, 0:4] = d.astype("<f4").view(np.uint8).reshape(nb, 4)
    out[:, 4 : 4 + QK_K] = q.astype(np.int8).view(np.uint8)
    out[:, 4 + QK_K :] = bsums.astype("<i2").view(np.uint8).reshape(nb, 32)
    return out.reshape(-1)


def dequantize_q8_K(buf: np.ndarray, n: int) -> np.ndarray:
    ts = TYPE_TRAITS[GGMLType.Q8_K].type_size
    b = buf.reshape(-1, ts)
    d = b[:, 0:4].copy().view("<f4").astype(np.float32)
    q = b[:, 4 : 4 + QK_K].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# float formats
# ---------------------------------------------------------------------------

def quantize_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint8).reshape(-1)


def dequantize_f32(buf: np.ndarray, n: int) -> np.ndarray:
    return buf.copy().view("<f4")[:n].astype(np.float32)


def quantize_f16(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).astype(np.float16).view(np.uint8).reshape(-1)


def dequantize_f16(buf: np.ndarray, n: int) -> np.ndarray:
    return buf.copy().view("<f2")[:n].astype(np.float32)


def quantize_bf16(x: np.ndarray) -> np.ndarray:
    xi = np.ascontiguousarray(x, np.float32).view(np.uint32)
    # round-to-nearest-even to bf16, NaN-safe (matches ggml_compute_fp32_to_bf16)
    nan = (xi & 0x7FFFFFFF) > 0x7F800000
    rounded = (xi + (0x7FFF + ((xi >> 16) & 1))) >> 16
    out = np.where(nan, (xi >> 16) | 64, rounded).astype(np.uint16)
    return out.view(np.uint8).reshape(-1)


def dequantize_bf16(buf: np.ndarray, n: int) -> np.ndarray:
    u16 = buf.copy().view("<u2")[:n].astype(np.uint32)
    return (u16 << 16).view(np.float32)


# ---------------------------------------------------------------------------
# dispatch tables
# ---------------------------------------------------------------------------

QUANTIZE = {
    GGMLType.F32: quantize_f32,
    GGMLType.F16: quantize_f16,
    GGMLType.BF16: quantize_bf16,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q4_1: quantize_q4_1,
    GGMLType.Q5_0: quantize_q5_0,
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q8_0: quantize_q8_0,
    GGMLType.Q8_1: quantize_q8_1,
    GGMLType.Q2_K: quantize_q2_K,
    GGMLType.Q3_K: quantize_q3_K,
    GGMLType.Q4_K: quantize_q4_K,
    GGMLType.Q5_K: quantize_q5_K,
    GGMLType.Q6_K: quantize_q6_K,
    GGMLType.Q8_K: quantize_q8_K,
}

DEQUANTIZE = {
    GGMLType.F32: dequantize_f32,
    GGMLType.F16: dequantize_f16,
    GGMLType.BF16: dequantize_bf16,
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_1: dequantize_q4_1,
    GGMLType.Q5_0: dequantize_q5_0,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q8_1: dequantize_q8_1,
    GGMLType.Q2_K: dequantize_q2_K,
    GGMLType.Q3_K: dequantize_q3_K,
    GGMLType.Q4_K: dequantize_q4_K,
    GGMLType.Q5_K: dequantize_q5_K,
    GGMLType.Q6_K: dequantize_q6_K,
    GGMLType.Q8_K: dequantize_q8_K,
}

from .iquants import DEQUANT_IQ, QUANT_IQ, QUANT_IQ_IMATRIX  # noqa: E402  (circular-safe)

DEQUANTIZE.update(DEQUANT_IQ)
QUANTIZE.update(QUANT_IQ)

# imatrix-aware encoders (quant_weights kwarg supported)
QUANTIZE_IMATRIX = {
    GGMLType.Q2_K: quantize_q2_K,
    GGMLType.Q3_K: quantize_q3_K,
    GGMLType.Q4_K: quantize_q4_K,
    GGMLType.Q5_K: quantize_q5_K,
    GGMLType.Q6_K: quantize_q6_K,
}
QUANTIZE_IMATRIX.update(QUANT_IQ_IMATRIX)  # iq encoders take quant_weights kw


def quantize(x: np.ndarray, qtype: GGMLType, quant_weights: np.ndarray | None = None) -> np.ndarray:
    """Quantize a flat f32 array to packed bytes (uint8)."""
    if quant_weights is not None and qtype in QUANTIZE_IMATRIX:
        return QUANTIZE_IMATRIX[qtype](x, quant_weights=quant_weights)
    return QUANTIZE[qtype](x)


def dequantize(buf: np.ndarray, qtype: GGMLType, n: int) -> np.ndarray:
    """Dequantize packed bytes back to f32 (first n elements)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    assert buf.size == row_size(qtype, _pad_n(qtype, n)), (
        f"{qtype.name}: buf {buf.size}B vs n={n}"
    )
    return DEQUANTIZE[qtype](buf, n)


def _pad_n(qtype: GGMLType, n: int) -> int:
    bs = TYPE_TRAITS[qtype].block_size
    return (n + bs - 1) // bs * bs
