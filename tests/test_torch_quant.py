"""The port's quant layer against the JAX package: t-planes byte-equal to
`build_t_planes` for every `_pack_bits` family, and wire dequantization
equal to `dequantize_jax`."""
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops.qmatmul import dequantize_jax
from ggml_hexagon_tpu.ops.qmm_qp8 import build_t_planes as jax_build_t_planes
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import jax_qt_leaf, port_qt
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P
from ggml_hexagon_tpu_torch.ops.qmatmul import dequantize
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS as PORT_QCONFIGS

# one type per (bits_lo, bits_hi, bias kind) family of `_pack_bits`, plus
# the coded families (2+1 magnitude+sign, 4+0 sign+code, 2+0 ternary)
T_FAMILIES = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K, GGMLType.Q5_0,
              GGMLType.Q5_1, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q2_K,
              GGMLType.Q3_K, GGMLType.IQ2_XXS, GGMLType.IQ3_S,
              GGMLType.TQ2_0]


def _wire(qtype, n=200, k=512, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, k)).astype(np.float32)
    return quantize_tensor(w, qtype)


@pytest.mark.parametrize("qtype", T_FAMILIES, ids=lambda t: t.name)
def test_t_planes_byte_equal(qtype):
    # ternary groups span 256 values: a chunk of 2 groups must divide the
    # K/4 shift-slice period, so K >= 2048
    qt = _wire(qtype, n=64, k=2048) if qtype == GGMLType.TQ2_0 else _wire(qtype)
    want = jax_build_t_planes(qt)
    assert want[0] is not None
    got = P.build_t_planes(port_qt(qt))
    for name, g, w in zip(("fq", "fs", "fb"), got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.view(torch.int16).numpy().view(np.uint16) if g.dtype == torch.bfloat16 \
            else g.numpy()
        w = np.asarray(w)
        w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_unsupported_types_have_no_t_planes():
    for qtype in (GGMLType.Q8_0, GGMLType.IQ4_NL):
        assert P.build_t_planes(port_qt(_wire(qtype, n=128, k=256))) == (
            None, None, None)
    assert P.supports_qp8(PORT_QCONFIGS[GGMLType.Q4_K], 4096)
    assert not P.supports_qp8(PORT_QCONFIGS[GGMLType.Q4_K], 4096 + 32)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K,
                                   GGMLType.Q8_0, GGMLType.Q5_1,
                                   GGMLType.IQ4_NL, GGMLType.Q5_K],
                         ids=lambda t: t.name)
def test_wire_dequant_matches_jax(qtype):
    qt = _wire(qtype, n=128, k=512, seed=1)
    want = np.asarray(dequantize_jax(qt))
    got = dequantize(port_qt(qt)).numpy()
    # both evaluate the same f32 expression; only FMA contraction may differ
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_t_dequant_matches_wire():
    """dequantize of a wire-less tensor reconstructs from the t-planes
    (bf16 scale planes: NMSE budget 5e-5, as the JAX package's test)."""
    qt = _wire(GGMLType.Q4_K, n=256, k=512, seed=2)
    pt = port_qt(qt).with_fast_planes()
    exact = dequantize(pt).numpy()
    got = dequantize(pt.without_wire()).numpy()[:qt.n]
    nmse = float(np.mean((got - exact) ** 2) / np.mean(exact ** 2))
    assert nmse < 5e-5, nmse


def test_take_rows_matches_jax():
    qt = _wire(GGMLType.Q6_K, n=512, k=256, seed=3).astype_device(fast=True)
    assert qt.fl == "t"
    perm = np.random.default_rng(0).permutation(qt.n)
    want = jax_qt_leaf(qt.take_rows(perm))
    got = port_qt(qt).take_rows(torch.from_numpy(perm))
    for f in ("q", "qh", "sc", "d", "fq"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f], err_msg=f)
    np.testing.assert_array_equal(
        got.fs.view(torch.int16).numpy().view(np.uint16), want["fs"])
