"""The interleaved layout's fused modes and gathered experts against the JAX
package, on the same planes and inputs (IQ4_XS and Q8_0 byte planes):

  planes       IQ4_XS interleaved planes byte-equal to `build_fast_planes`;
               IQ4_XS wire dequant against `dequantize_jax` (rtol 1e-6);
  K6 modes     the plain normed, residual and act modes (`fast_byte_plain`
               through `qmatmul_fast_normed/res/act`) against the JAX entries
               with interpret=True, the Pallas `_byte_kernel` in interpret
               mode, at B in {1, 8} (normed also at 16, the bf16 route);
               act at K = 768, whose G = 24 is not lane-aligned, like the
               full width's 448; rtol = atol = 5e-4, the JAX package's own
               kernel-vs-oracle tolerance;
  K8           plain `fast_indirect_plain` (through `qmatmul_fast_indirect`)
               against the JAX entry in interpret mode, P in {2, 16} with
               duplicate ids, same tolerance; an id outside [0, E) gives a
               NaN row;
  gates        `_pick_blocks`, `supports_fused_epilogue`, `supports_dual`
               and `supports_indirect` agree with the JAX functions (an
               interleaved pair that the JAX package runs through K7 runs
               through the port's K7); the interleave helpers equal the
               JAX ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops import qmm_fast as JF
from ggml_hexagon_tpu.ops.qmatmul import dequantize_jax
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import port_qt
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.ops.qmatmul import dequantize

TOL = dict(rtol=5e-4, atol=5e-4)
TYPES = [GGMLType.IQ4_XS, GGMLType.Q8_0]
_QT = {}


def _qt(qtype, n, k, fast=True):
    """A JAX QTensor (interleaved planes and wire) and its port twin."""
    key = (qtype, n, k, fast)
    if key not in _QT:
        rng = np.random.default_rng(int(qtype) * 7 + n + k)
        w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
        jq = quantize_tensor(w, qtype)
        if fast:
            jq = jq.astype_device(fast=True)
            assert jq.fl == "il"
        _QT[key] = (jq, port_qt(jq))
    return _QT[key]


def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    t = np.asarray(t)
    return t.view(np.uint16) if t.dtype.name == "bfloat16" else t


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n,k", [(300, 512), (1024, 4096)],
                         ids=["padded", "k4096"])
def test_iq4xs_interleaved_planes_byte_equal(n, k):
    jq, pq = _qt(GGMLType.IQ4_XS, n, k, fast=False)
    want = JF.build_fast_planes(jq)
    got = PF.build_fast_planes(pq)
    for name, g, w in zip(("fq", "fs", "fb"), got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_iq4xs_wire_dequant_matches_jax():
    jq, pq = _qt(GGMLType.IQ4_XS, 300, 512, fast=False)
    assert pq.sc.dtype == torch.int8 and int(pq.sc.min()) < 0
    np.testing.assert_allclose(dequantize(pq).numpy(),
                               np.asarray(dequantize_jax(jq)), rtol=1e-6)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("B", [1, 8, 16])
def test_normed_plain_matches_pallas(qtype, B):
    jq, pq = _qt(qtype, 1024, 512)
    x = _rand(B, B, 512) * 3.0
    wn = np.random.default_rng(1).random(512).astype(np.float32) + 0.5
    wn_il = wn[JF.interleave_perm(512, 32)]
    want = JF.qmatmul_fast_normed(jnp.asarray(x), jq, jnp.asarray(wn_il),
                                  1e-5, interpret=True)
    got = PF.qmatmul_fast_normed(torch.from_numpy(x), pq,
                                 torch.from_numpy(wn_il), 1e-5)
    assert got.shape == (B, jq.n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_normed_with_split_k_norms_apart_like_jax(qtype, monkeypatch):
    """Where the blocking splits K (very wide K), the normed entry norms
    apart and runs the plain mode, in both packages; forced here."""
    jq, pq = _qt(qtype, 1024, 512)
    for mod in (JF, PF):
        monkeypatch.setattr(mod, "_pick_blocks", lambda *a: (512, 2))
    x = _rand(4, 4, 512) * 3.0
    wn = np.random.default_rng(2).random(512).astype(np.float32) + 0.5
    wn_il = wn[JF.interleave_perm(512, 32)]
    want = JF.qmatmul_fast_normed(jnp.asarray(x), jq, jnp.asarray(wn_il),
                                  1e-5, interpret=True)
    got = PF.qmatmul_fast_normed(torch.from_numpy(x), pq,
                                 torch.from_numpy(wn_il), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("B", [1, 8])
def test_res_plain_matches_pallas(qtype, B):
    jq, pq = _qt(qtype, 1024, 512)
    x, res = _rand(B, B, 512), _rand(B + 10, B, 1024)
    want = JF.qmatmul_fast_res(jnp.asarray(x), jq, jnp.asarray(res),
                               interpret=True)
    got = PF.qmatmul_fast_res(torch.from_numpy(x), pq, torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("with_res", [False, True], ids=["", "res"])
def test_act_plain_matches_pallas(qtype, B, with_res):
    jq, pq = _qt(qtype, 512, 768)
    assert 768 // jq.cfg.gs == 24
    x = _rand(B, B, 2 * 768) * 2.0
    res = _rand(B + 20, B, 512) if with_res else None
    want = JF.qmatmul_fast_act(jnp.asarray(x), jq, "silu",
                               res=None if res is None else jnp.asarray(res),
                               interpret=True)
    got = PF.qmatmul_fast_act(torch.from_numpy(x), pq, "silu",
                              res=None if res is None else torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_act_other_than_silu_raises():
    """K6's act mode takes silu, gelu and relu (gelu and relu against the
    JAX kernel: tests/test_torch_gemma_ops.py); other acts raise."""
    _, pq = _qt(GGMLType.Q8_0, 512, 768)
    assert PF.qmatmul_fast_act(torch.zeros(1, 1536), pq, "gelu").shape == (1, 512)
    with pytest.raises(NotImplementedError):
        PF.qmatmul_fast_act(torch.zeros(1, 1536), pq, "relu2")


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("ids", [[2, 0], [3, 3], [1, 3, 0, 2, 2, 1, 0, 3] * 2],
                         ids=["P2", "P2_dup", "P16"])
def test_indirect_plain_matches_pallas(qtype, ids):
    npe = 256
    jq, pq = _qt(qtype, 4 * npe, 512)
    assert PF.supports_indirect(pq, npe) and JF.supports_indirect(jq, npe)
    x = _rand(len(ids), len(ids), 512)
    ids = np.asarray(ids, np.int32)
    want = JF.qmatmul_fast_indirect(jnp.asarray(x), jq, jnp.asarray(ids), npe,
                                    interpret=True)
    got = PF.qmatmul_fast_indirect(torch.from_numpy(x), pq,
                                   torch.from_numpy(ids), npe)
    assert got.shape == (len(ids), npe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_indirect_plain_marks_bad_ids():
    _, pq = _qt(GGMLType.IQ4_XS, 4 * 256, 512)
    y = PF.qmatmul_fast_indirect(torch.ones(2, 512), pq,
                                 torch.tensor([1, 4], dtype=torch.int32), 256)
    assert torch.isfinite(y[0]).all() and torch.isnan(y[1]).all()


@pytest.mark.parametrize("K", [512, 768, 4096, 14336])
@pytest.mark.parametrize("B", [1, 8, 16, 128, 512])
@pytest.mark.parametrize("nibble,gs", [(False, 32), (True, 32), (False, 16)])
def test_pick_blocks_matches_jax(K, B, nibble, gs):
    assert PF._pick_blocks(B, K, nibble, gs) == JF._pick_blocks(B, K, nibble, gs)


def test_gates_agree_with_jax():
    """supports_fused_epilogue / supports_indirect / supports_dual on the
    same planes, the port's and the JAX package's."""
    from ggml_hexagon_tpu.ops import qmm_qp8 as JQ

    jt = quantize_tensor(_rand(3, 512, 512) * 0.05,
                         GGMLType.Q5_K).astype_device(fast=True)
    jt2 = quantize_tensor(_rand(4, 512, 512) * 0.05,
                          GGMLType.Q6_K).astype_device(fast=True)
    assert jt.fl == jt2.fl == "t"
    pt, pt2 = port_qt(jt), port_qt(jt2)
    il = [_qt(t, n, k) for t, n, k in ((GGMLType.IQ4_XS, 1024, 512),
                                        (GGMLType.Q8_0, 1024, 512),
                                        (GGMLType.IQ4_XS, 300, 512),
                                        (GGMLType.IQ4_XS, 512, 768))]
    for jq, pq in il + [(jt, pt), (jt2, pt2)]:
        for B in (1, 8, 16):
            assert (PF.supports_fused_epilogue(pq, B)
                    == JF.supports_fused_epilogue(jq, B))
        for npe in (128, 256, 100):
            assert PF.supports_indirect(pq, npe) == JF.supports_indirect(jq, npe)
    assert PF.supports_dual(pt, pt2) == JF.supports_dual(jt, jt2)
    assert JQ.supports_qp8_dual(jt, jt2)
    for (ja, pa), (jb, pb) in [((jt, pt), il[0]), (il[0], (jt2, pt2)),
                               (il[2], il[0])]:
        assert not JF.supports_dual(ja, jb)
        assert not PF.supports_dual(pa, pb)
    assert JF.supports_dual(il[0][0], il[1][0])
    assert PF.supports_dual(il[0][1], il[1][1])


def test_interleave_helpers_match_jax():
    x = _rand(5, 3, 768)
    perm = PF.interleave_perm(768, 32)
    np.testing.assert_array_equal(perm.numpy(), JF.interleave_perm(768, 32))
    np.testing.assert_array_equal(
        PF.uninterleave_cols(torch.from_numpy(x), 32).numpy(),
        np.asarray(JF.uninterleave_cols(jnp.asarray(x), 32)))
    np.testing.assert_array_equal(
        PF.uninterleave_norm(torch.from_numpy(x[0]), 32).numpy(),
        np.asarray(JF.uninterleave_norm(jnp.asarray(x[0]), 32)))
    # the interleave and its inverse
    np.testing.assert_array_equal(
        PF.uninterleave_cols(torch.from_numpy(x)[:, perm], 32).numpy(), x)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_pre_interleaved_plain_matches_pallas(qtype):
    """The w_gateup_il prefill route: x already in the planes' order."""
    jq, pq = _qt(qtype, 1024, 512)
    x = _rand(9, 16, 512)
    x_il = x[:, JF.interleave_perm(512, 32)]
    want = JF.qmatmul_fast(jnp.asarray(x_il), jq, interpret=True,
                           pre_interleaved=True)
    got = PF.qmatmul_fast(torch.from_numpy(x_il), pq, pre_interleaved=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), PF.qmatmul_fast(torch.from_numpy(x), pq).numpy(),
        rtol=0, atol=0)
