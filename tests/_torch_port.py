"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the small adapter from a JAX QTensor to the numpy leaf dict that
ggml_hexagon_tpu_torch.convert takes, and tiny quantized fixtures."""
import dataclasses

import numpy as np

from ggml_hexagon_tpu.quant.pack import QTensor as JQTensor

PLANES = ("q", "d", "qh", "sc", "dmin", "m", "fq", "fs", "fb")


def _np(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def jax_qt_leaf(qt: JQTensor) -> dict:
    """JAX QTensor -> {"qtype", "n", "k", "fl", planes...} of numpy."""
    leaf = {"qtype": int(qt.cfg.qtype), "n": qt.n, "k": qt.k, "fl": qt.fl}
    leaf.update({f: _np(getattr(qt, f)) for f in PLANES})
    return leaf


def jax_tree_to_numpy(tree):
    """The JAX weights tree with QTensor leaves as dicts, arrays as numpy."""
    if tree is None:
        return None
    if isinstance(tree, JQTensor):
        return jax_qt_leaf(tree)
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return _np(tree)


def to_port(cfg, tree, device="cpu"):
    """Carry a JAX (cfg, weights) across into the port."""
    from ggml_hexagon_tpu_torch.convert import convert

    return convert(dataclasses.asdict(cfg), jax_tree_to_numpy(tree), device)


def port_qt(qt: JQTensor, device="cpu"):
    from ggml_hexagon_tpu_torch.convert import qtensor_from_numpy

    return qtensor_from_numpy(jax_qt_leaf(qt), device)


def nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / (np.mean(want ** 2) + 1e-30))


#: the coded types' value alphabets (magnitudes; ternary: the values)
CODE_VALUES = {"iq2": (0, 8, 25, 43),
               "iq3xxs": (4, 12, 20, 28, 36, 44, 52, 62),
               "iq3s": (1, 3, 5, 7, 9, 11, 13, 15),
               "iq1": (0, 1, 7, 9),
               "tern": (-1, 0, 1, 2)}


def coded_qtensor(qtype, n: int, k: int, seed: int = 0, n_align: int = 128):
    """A JAX wire QTensor of a coded type (an i-quant below 4 bits, or
    ternary) as the JAX loader holds one after expanding the wire: int8
    values, each a sign times a magnitude of the type's alphabet, and one
    f32 scale a group, of weights with RMS about 1/sqrt(k); rows padded
    with zeros to n_align.  Drawn directly: the package's encoders take
    seconds per 0.5 M weights."""
    from ggml_hexagon_tpu.quant.pack import QCONFIGS

    cfg = QCONFIGS[qtype]
    rng = np.random.default_rng(seed * 1009 + int(qtype) * 31 + n + k)
    vals = np.asarray(CODE_VALUES[cfg.code_map])
    q = vals[rng.integers(0, len(vals), (n, k))]
    if cfg.code_map != "tern":
        q = q * rng.choice([-1, 1], (n, k))
    rms = float(np.sqrt(np.mean(vals.astype(np.float64) ** 2)))
    d = (rng.random((n, k // cfg.gs)) + 0.5) / (rms * np.sqrt(k))
    n_pad = -(-n // n_align) * n_align
    qp = np.zeros((n_pad, k), np.int8)
    qp[:n] = q
    dp = np.zeros((n_pad, k // cfg.gs), np.float32)
    dp[:n] = d
    return JQTensor(cfg, n, k, q=qp, d=dp)


def normed_input(seed: int, B: int, k: int):
    """(x [B, k], eps) whose rows all have the mean square 4 - eps exactly:
    signed permutations of one vector of multiples of 1/8 (every partial
    sum of squares exact), eps = 4 - that mean (exact, Sterbenz), so
    rsqrt(mean + eps) = 0.5 in any summation order and any rsqrt (XLA's
    and PyTorch's rsqrt differ in the last bit on ~40% of rows)."""
    rng = np.random.default_rng(seed)
    base = np.round(rng.normal(size=k) * 1.7 * 8) / 8
    x = np.stack([base[rng.permutation(k)] * rng.choice([-1.0, 1.0], k)
                  for _ in range(B)]).astype(np.float32)
    mean = np.float32(np.sum(base.astype(np.float32) ** 2)) / np.float32(k)
    assert 2.0 <= mean < 4.0
    return x, float(np.float32(4.0) - mean)


def wire_qtensor(qtype, n: int, k: int, seed: int = 0, n_align: int = 128):
    """A JAX wire QTensor of any type in the dtypes and shapes
    `quantize_tensor` gives (the expanded i-quants and ternary as
    `coded_qtensor` draws them): uniform packed bytes (int8 values in
    -127..127 for Q8_0), f16-exact scales, 6-bit sub-scales (IQ4_XS: signed
    -32..31), with mins that centre the weights (m = sc, dmin = d *
    (2^bits - 1) / 2; Q4_1 and Q5_1: an f32 m = -d * (2^bits - 1) / 2) and
    d giving an RMS about 1/sqrt(k), as models/synth.random_qtensor draws
    them; IQ4_NL draws the sign of d.  Rows past n, up to a multiple of
    n_align, are zero, as `pack_tensor` pads them.  Drawn directly: the
    package's K-quant encoder takes tens of seconds per 16 M weights, its
    i-quant encoders seconds per 0.5 M."""
    from ggml_hexagon_tpu.quant.iquants import KVALUES_IQ4NL
    from ggml_hexagon_tpu.quant.pack import QCONFIGS

    cfg = QCONFIGS[qtype]
    if cfg.expand:
        return coded_qtensor(qtype, n, k, seed, n_align)
    rng = np.random.default_rng(seed * 1009 + int(qtype) * 31 + n + k)
    u_rms = np.sqrt(1 / 3 + 0.05 + 0.05 ** 2)        # of U(0.05, 1.05)
    if cfg.signed or cfg.lut:
        if cfg.signed:                               # Q8_0
            q = rng.integers(-127, 128, (n, k)).astype(np.int8)
            q_rms = np.sqrt((255 * 255 - 1) / 12)
        else:                                        # 4-bit LUT codes
            q = rng.integers(0, 256, (n, k // 2), dtype=np.uint8)
            q_rms = np.sqrt(np.mean(np.asarray(KVALUES_IQ4NL, np.float64) ** 2))
        sc = None
        if cfg.superblock:                           # IQ4_XS
            sc = rng.integers(-32, 32, (n, k // cfg.gs)).astype(np.int8)
            sc_rms, groups = np.sqrt(np.mean(np.arange(-32.0, 32.0) ** 2)), k // 256
        else:
            sc_rms, groups = 1.0, k // cfg.gs
        d0 = 1.0 / (np.sqrt(k) * q_rms * sc_rms * u_rms)
        d = ((rng.random((n, groups)) + 0.05) * d0).astype(np.float16).astype(
            np.float32)
        if cfg.lut and not cfg.superblock:           # IQ4_NL: signed d
            d = d * rng.choice([-1.0, 1.0], d.shape).astype(np.float32)
        return _pad_rows(JQTensor(cfg, n, k, q=q, d=d, sc=sc), n_align)
    n_q = 2 ** (cfg.bits_lo + cfg.bits_hi)
    q = rng.integers(0, 256, (n, k * cfg.bits_lo // 8), dtype=np.uint8)
    qh = (rng.integers(0, 256, (n, k * cfg.bits_hi // 8), dtype=np.uint8)
          if cfg.bits_hi else None)
    q_rms = np.sqrt((n_q * n_q - 1) / 12)
    sc = m = dmin = None
    if cfg.superblock:
        sc = rng.integers(0, 64, (n, k // cfg.gs)).astype(
            np.int8 if cfg.asym == "none" else np.int32)
        sc_rms, groups = np.sqrt(np.mean(np.arange(64.0) ** 2)), k // 256
    else:
        sc_rms, groups = 1.0, k // cfg.gs
    d0 = 1.0 / (np.sqrt(k) * q_rms * sc_rms * u_rms)
    d = ((rng.random((n, groups)) + 0.05) * d0).astype(np.float16).astype(
        np.float32)
    if cfg.asym == "minsb":
        dmin = (d * ((n_q - 1) / 2)).astype(np.float16).astype(np.float32)
        m = sc.astype(np.int32)
    elif cfg.asym == "min":
        m = (-d * ((n_q - 1) / 2)).astype(np.float16).astype(np.float32)
    return _pad_rows(JQTensor(cfg, n, k, q=q, d=d, qh=qh, sc=sc, dmin=dmin,
                              m=m), n_align)


def _pad_rows(qt, n_align: int):
    """Zero rows appended to every wire plane up to a multiple of
    n_align."""
    n_pad = -(-qt.n // n_align) * n_align
    if n_pad == qt.n:
        return qt

    def pad(a):
        if a is None:
            return None
        out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
        out[:qt.n] = a
        return out

    return JQTensor(qt.cfg, qt.n, qt.k, q=pad(qt.q), d=pad(qt.d),
                    qh=pad(qt.qh), sc=pad(qt.sc), dmin=pad(qt.dmin),
                    m=pad(qt.m))
