"""The port's interleaved layout and its byte-plane matmul (K6) against the
JAX package, on the same planes and inputs:

  planes       byte-equal to `build_fast_planes` (Q8_0, and IQ4_NL, whose
               LUT values are byte planes too);
  plain K6     `fast_byte_plain` against `qmatmul_fast(interpret=True)`,
               the Pallas `_byte_kernel` in interpret mode, at B in
               {1, 8, 16} (f32 route at <= 8 rows, bf16 route above),
               rtol = atol = 5e-4, the JAX package's own kernel-vs-oracle
               tolerance;
  dequantize   `dequantize_fast` against the JAX one, exactly (both take
               the same f32 expression);
  take_rows    interleaved planes gather on their rows (axis 0);
  dispatch     `qmatmul` sends t-planes to qp8_matmul and interleaved
               planes to K6, the rows past 512 on planes with wire and a
               weight without matmul planes to the wire route, and the
               rows past 512 on interleaved planes without wire to K6
               (its GEMM on the card), as the JAX dispatcher does: byte,
               nibble and coded planes and the normed entry at 520 rows
               against the JAX `qmatmul` / `qmatmul_normed` with
               GHT_FAST_INTERPRET=1 (the Pallas kernels in interpret
               mode), rtol = atol = 5e-4.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops import qmm_fast as JF
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import coded_qtensor, jax_qt_leaf, normed_input, port_qt
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.ops.qmatmul import qmatmul, qmatmul_normed
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS, use_qp8_layout

# the JAX ops package exports a function named qmatmul beside the module
JQ = importlib.import_module("ggml_hexagon_tpu.ops.qmatmul")
TOL = dict(rtol=5e-4, atol=5e-4)
_QT = {}


def _qt(qtype=GGMLType.Q8_0, n=1024, k=512):
    """A JAX QTensor with interleaved planes (wire kept) and its port
    twin, cached."""
    key = (qtype, n, k)
    if key not in _QT:
        rng = np.random.default_rng(int(qtype) * 3 + n + k)
        w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
        jq = quantize_tensor(w, qtype).astype_device(fast=True)
        assert jq.fl == "il"
        _QT[key] = (jq, port_qt(jq))
    return _QT[key]


def _bits(t):
    """A plane as numpy, bf16 as its uint16 bits."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    t = np.asarray(t)
    return t.view(np.uint16) if t.dtype.name == "bfloat16" else t


@pytest.mark.parametrize("qtype,n,k", [(GGMLType.Q8_0, 300, 512),
                                       (GGMLType.Q8_0, 1024, 4096),
                                       (GGMLType.IQ4_NL, 256, 512)],
                         ids=["q8_0_padded", "q8_0_wk", "iq4_nl"])
def test_interleaved_planes_byte_equal(qtype, n, k):
    rng = np.random.default_rng(n + k)
    qt = quantize_tensor(rng.normal(size=(n, k)).astype(np.float32), qtype)
    want = JF.build_fast_planes(qt)
    got = PF.build_fast_planes(port_qt(qt))
    assert not use_qp8_layout(QCONFIGS[qtype], k)
    for name, g, w in zip(("fq", "fs", "fb"), got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("B", [1, 8, 16])
def test_fast_byte_plain_matches_pallas(B):
    jq, pq = _qt()
    x = np.random.default_rng(B).normal(size=(B, jq.k)).astype(np.float32)
    want = JF.qmatmul_fast(jnp.asarray(x), jq, interpret=True)
    got = PF.qmatmul_fast(torch.from_numpy(x), pq)
    assert got.shape == (B, jq.n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fast_byte_wrapper_takes_plain_only_on_cpu():
    """On CPU tensors the K6 wrapper is the plain version, bit for bit."""
    _, pq = _qt()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, pq.k)).astype(np.float32)).to(torch.bfloat16)
    torch.testing.assert_close(PF.fast_byte(x, pq), PF.fast_byte_plain(x, pq),
                               rtol=0, atol=0)


def test_dequantize_fast_matches_jax():
    jq, pq = _qt(n=300)
    want = np.asarray(JF.dequantize_fast(jq.without_wire()))
    got = PF.dequantize_fast(pq.without_wire()).numpy()
    np.testing.assert_array_equal(got, want)


def test_take_rows_interleaved_matches_jax():
    jq, pq = _qt(n=512)
    perm = np.random.default_rng(4).permutation(jq.n)
    want = jax_qt_leaf(jq.take_rows(perm))
    got = pq.take_rows(torch.from_numpy(perm))
    for f in ("q", "d", "fq", "fs"):
        np.testing.assert_array_equal(_bits(getattr(got, f)), want[f],
                                      err_msg=f)


def test_qmatmul_dispatch(monkeypatch):
    """t-planes -> qp8_matmul, interleaved -> K6 up to 512 rows; beyond
    that on planes that keep their wire, and for a weight without matmul
    planes, the wire route (qmatmul_xla); beyond 512 rows on interleaved
    planes without wire K6, each held against the JAX dispatcher in the
    same mode."""
    jq, pq = _qt()
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, pq.k)).astype(np.float32))
    torch.testing.assert_close(qmatmul(x, pq), PF.qmatmul_fast(x, pq),
                               rtol=0, atol=0)
    rng = np.random.default_rng(6)
    jt = quantize_tensor(rng.normal(size=(512, 512)).astype(np.float32),
                         GGMLType.Q5_K).astype_device(fast=True)
    pt = port_qt(jt)
    assert pt.fl == "t"
    want = JF.qmatmul_fast(jnp.asarray(x.numpy()), jt, interpret=True)
    np.testing.assert_allclose(qmatmul(x, pt).numpy(), np.asarray(want), **TOL)
    x513 = rng.normal(size=(513, pq.k)).astype(np.float32)
    want = JQ.qmatmul(jnp.asarray(x513), jq)
    np.testing.assert_allclose(qmatmul(torch.from_numpy(x513), pq).numpy(),
                               np.asarray(want), **TOL)
    monkeypatch.setenv("GHT_FAST_INTERPRET", "1")  # the JAX route to K6
    want = JQ.qmatmul(jnp.asarray(x513), jq.without_wire())
    np.testing.assert_allclose(
        qmatmul(torch.from_numpy(x513), pq.without_wire()).numpy(),
        np.asarray(want), **TOL)
    monkeypatch.delenv("GHT_FAST_INTERPRET")
    jw = quantize_tensor(rng.normal(size=(128, 512)).astype(np.float32),
                         GGMLType.Q8_0)
    pw = port_qt(jw)
    assert pw.fq is None
    np.testing.assert_allclose(qmatmul(x, pw).numpy(),
                               np.asarray(JQ.qmatmul(jnp.asarray(x.numpy()),
                                                     jw)), **TOL)


def test_nibble_planes_raise():
    """A ternary tensor at K=1024 has no t-layout (a 2-group chunk must
    divide its K/4 shift period) and takes coded nibble planes on the
    default route: byte-equal to the JAX build, served by K6's coded
    family, and refused by the byte and nibble families' wrappers."""
    qt = quantize_tensor(np.random.default_rng(7).normal(
        size=(128, 1024)).astype(np.float32), GGMLType.TQ2_0)
    assert not use_qp8_layout(QCONFIGS[GGMLType.TQ2_0], 1024)
    assert PF.supports_fast(QCONFIGS[GGMLType.TQ2_0], 1024)
    il = port_qt(qt).with_fast_planes()
    assert il.fl == "il"
    np.testing.assert_array_equal(il.fq.numpy(),
                                  np.asarray(JF.build_fast_planes(qt)[0]))
    x = torch.ones(2, 1024, dtype=torch.bfloat16)
    assert PF.fast_coded(x, il).shape == (2, 512)
    for family in (PF.fast_nibble, PF.fast_byte):
        with pytest.raises(ValueError):
            family(x, il)


def _il_without_wire(qtype, n=128, k=512):
    """(JAX QTensor on interleaved planes, wire dropped, port twin): Q8_0
    and Q4_K quantized from normal weights, IQ3_XXS drawn as alphabet
    values (`coded_qtensor`)."""
    if qtype == GGMLType.IQ3_XXS:
        wire = coded_qtensor(qtype, n, k, seed=3)
    else:
        rng = np.random.default_rng(int(qtype) + n + k)
        wire = quantize_tensor(
            rng.normal(size=(n, k)).astype(np.float32) * 0.05, qtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_QP8", "0")
        jq = wire.astype_device(fast=True)
    assert jq.fl == "il"
    jq = jq.without_wire()
    return jq, port_qt(jq)


_ABOVE_512 = [GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.IQ3_XXS]


@pytest.mark.parametrize("qtype", _ABOVE_512, ids=["byte", "nibble", "coded"])
def test_qmatmul_above_512_rows_without_wire(monkeypatch, qtype):
    """520 rows on interleaved planes without wire take K6 in both packages
    (the JAX dispatcher's `B <= MAX_FAST_BATCH or qt.q is None`): the
    port's route against the JAX qmatmul with the Pallas kernel in
    interpret mode."""
    jq, pq = _il_without_wire(qtype)
    assert PF._family(pq.cfg) == ("byte", "nibble", "coded")[
        _ABOVE_512.index(qtype)]
    x = np.random.default_rng(8).normal(size=(520, pq.k)).astype(np.float32)
    monkeypatch.setenv("GHT_FAST_INTERPRET", "1")
    want = JQ.qmatmul(jnp.asarray(x), jq)
    np.testing.assert_allclose(qmatmul(torch.from_numpy(x), pq).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", _ABOVE_512, ids=["byte", "nibble", "coded"])
def test_qmatmul_normed_above_512_rows_without_wire(monkeypatch, qtype):
    """The normed entry at 520 rows on interleaved planes without wire:
    K6's normed route in both packages (rows of an exact rsqrt,
    `normed_input`)."""
    jq, pq = _il_without_wire(qtype)
    x, eps = normed_input(11, 520, pq.k)
    wn = np.random.default_rng(12).uniform(0.5, 1.5, pq.k).astype(np.float32)
    wn_il = wn[PF.interleave_perm(pq.k, pq.cfg.gs).numpy()]
    monkeypatch.setenv("GHT_FAST_INTERPRET", "1")
    want = JQ.qmatmul_normed(jnp.asarray(x), jq, jnp.asarray(wn_il), eps)
    got = qmatmul_normed(torch.from_numpy(x), pq, torch.from_numpy(wn_il), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
