"""The interleaved layout everywhere (the JAX package under GHT_QP8=0): the
port's nibble planes, its byte planes with a group bias, K7 and K8's nibble
variant against the JAX package, on the same planes and inputs.

  planes     interleaved planes byte-equal to `build_fast_planes`: nibble
             (Q4_K, Q4_0, Q4_1) and byte with a stored fb plane (Q5_K) or a
             bias derived as offset * scale (Q6_K, Q5_0); `dequantize_fast`
             equal to the JAX one;
  K6         every plain mode (plain, pre_il, normed, res, act) through the
             port's entries against the JAX entries with interpret=True
             (the Pallas `_nibble_kernel` / `_byte_kernel` in interpret
             mode) at B in {1, 8, 16}: at K = 768, whose G (24, or 48 at
             gs 16) is not lane-aligned, the group sums come from the
             caller (mode 1); at K = 4096 (Q4_K, G = 128) and K = 2048
             (Q6_K, G = 128) the kernel takes its own (mode 2);
  K7         plain `fast_dual_plain` through `qmatmul_fast_dual` against the
             JAX entry on a Q4_K + Q6_K pair, normed and not;
  K8         plain `fast_indirect_plain` through `qmatmul_fast_indirect`
             against the JAX entry, P in {2, 16} with duplicate ids, on
             nibble stacks and on byte stacks with a bias;
  gates      `supports_dual`, `supports_indirect` and
             `supports_fused_epilogue` agree with the JAX functions;
  repairs    `qmatmul_fast_normed` blocks nibble planes as nibble planes;
             the mode-1 group sums take the un-rounded input;
             `fuse._concat_qtensors` keeps the parts' layout when it
             rebuilds padded planes from the wire.

Tolerance rtol = atol = 5e-4, the JAX package's kernel-vs-oracle tolerance.
The normed cases take inputs whose RMS factor is exact in both packages
(`normed_input`): XLA's and PyTorch's rsqrt differ in the last bit on
about 40% of rows, which can move one bf16 rounding of the normed
activation and with it single outputs by ~1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import fuse as JFU
from ggml_hexagon_tpu.ops import qmm_fast as JF
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import jax_qt_leaf, normed_input, port_qt
from ggml_hexagon_tpu_torch.models import fuse as PFU
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS, QTensor, use_qp8_layout

TOL = dict(rtol=5e-4, atol=5e-4)
_QT = {}


def _jax_il(qt):
    """A JAX QTensor given its planes as the JAX package builds them under
    GHT_QP8=0."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_QP8", "0")
        jq = qt.astype_device(fast=True)
    assert jq.fl == "il"
    return jq


def _qt(qtype, n, k, seed=0):
    """A JAX QTensor with interleaved planes (wire kept) and its port twin,
    cached."""
    key = (qtype, n, k, seed)
    if key not in _QT:
        rng = np.random.default_rng(int(qtype) * 11 + n + k + seed)
        w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
        jq = _jax_il(quantize_tensor(w, qtype))
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


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q4_0,
                                   GGMLType.Q4_1, GGMLType.Q5_K,
                                   GGMLType.Q6_K, GGMLType.Q5_0],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("n,k", [(300, 512), (256, 768)],
                         ids=["padded", "k768"])
def test_planes_byte_equal_under_qp8_off(qtype, n, k, monkeypatch):
    rng = np.random.default_rng(n + k + int(qtype))
    qt = quantize_tensor(rng.normal(size=(n, k)).astype(np.float32), qtype)
    monkeypatch.setenv("GHT_QP8", "0")
    want = JF.build_fast_planes(qt)
    pq = port_qt(qt)
    assert not use_qp8_layout(pq.cfg, k)
    got = PF.build_fast_planes(pq)
    cfg = QCONFIGS[qtype]
    assert (got[2] is None) == bool(cfg.offset and cfg.asym == "none")
    for name, g, w in zip(("fq", "fs", "fb"), got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)
    il = pq.with_fast_planes()
    assert il.fl == "il" and torch.equal(il.fq, got[0])


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q4_0,
                                   GGMLType.Q6_K, GGMLType.Q5_K],
                         ids=lambda t: t.name)
def test_dequantize_fast_matches_jax(qtype):
    jq, pq = _qt(qtype, 300, 768)
    want = np.asarray(JF.dequantize_fast(jq.without_wire()))
    np.testing.assert_array_equal(PF.dequantize_fast(pq.without_wire()).numpy(),
                                  want)


def test_use_qp8_layout_honours_ght_qp8(monkeypatch):
    cfg = QCONFIGS[GGMLType.Q4_K]
    monkeypatch.delenv("GHT_QP8", raising=False)
    assert use_qp8_layout(cfg, 4096)
    for off in ("0", ""):
        monkeypatch.setenv("GHT_QP8", off)
        assert not use_qp8_layout(cfg, 4096)
    monkeypatch.setenv("GHT_QP8", "1")
    _, pq = _qt(GGMLType.Q4_K, 256, 768)
    wire = QTensor(pq.cfg, pq.n, pq.k, pq.q, pq.d, pq.qh, pq.sc, pq.dmin,
                   pq.m)
    assert wire.with_fast_planes().fl == "t"
    assert wire.with_fast_planes("il").fl == "il"
    assert wire.with_fast_planes("t").fl == "t"


#: (qtype, K): mode 1 at K = 768, mode 2 at the lane-aligned G = 128
CASES = [(GGMLType.Q4_K, 768), (GGMLType.Q4_K, 4096), (GGMLType.Q4_0, 768),
         (GGMLType.Q6_K, 768), (GGMLType.Q6_K, 2048), (GGMLType.Q5_K, 768)]
MODES = ["plain", "pre_il", "normed", "res", "act"]


def _mode_call(mod, mode, x, qt, k, wn_il, res, eps=1e-5, **kw):
    if mode == "plain":
        return mod.qmatmul_fast(x, qt, **kw)
    if mode == "pre_il":
        return mod.qmatmul_fast(x, qt, pre_interleaved=True, **kw)
    if mode == "normed":
        return mod.qmatmul_fast_normed(x, qt, wn_il, eps, **kw)
    if mode == "res":
        return mod.qmatmul_fast_res(x, qt, res, **kw)
    return mod.qmatmul_fast_act(x, qt, "silu", res=res, **kw)


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"{c[0].name}_k{c[1]}")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B", [1, 8, 16])
def test_mode_plain_matches_pallas(case, mode, B):
    """Each K6 mode of the port's plain version against the JAX entry with
    the Pallas kernel in interpret mode, on the same planes and inputs."""
    qtype, k = case
    jq, pq = _qt(qtype, 512, k)
    width = 2 * k if mode == "act" else k
    x = _rand(B * 7 + k, B, width) * (2.0 if mode == "act" else 1.5)
    eps = 1e-5
    if mode == "normed":
        x, eps = normed_input(B * 7 + k, B, k)
    wn = np.random.default_rng(k).random(k).astype(np.float32) + 0.5
    wn_il = wn[JF.interleave_perm(k, jq.cfg.gs)]
    res = _rand(B + 3, B, jq.n) if mode in ("res", "act") else None
    jw = None if res is None else jnp.asarray(res)
    pw = None if res is None else torch.from_numpy(res)
    want = _mode_call(JF, mode, jnp.asarray(x), jq, k, jnp.asarray(wn_il), jw,
                      eps, interpret=True)
    got = _mode_call(PF, mode, torch.from_numpy(x), pq, k,
                     torch.from_numpy(wn_il), pw, eps)
    assert got.shape == (B, jq.n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_nibble_wrapper_takes_plain_only_on_cpu():
    """On CPU tensors the K6 nibble wrapper is the plain version, bit for
    bit, and the family wrappers refuse each other's planes."""
    _, pq = _qt(GGMLType.Q4_K, 512, 768)
    x = torch.from_numpy(_rand(3, 2, 768)).to(torch.bfloat16)
    torch.testing.assert_close(PF.fast_nibble(x, pq),
                               PF.fast_nibble_plain(x, pq), rtol=0, atol=0)
    with pytest.raises(ValueError):
        PF.fast_byte_plain(x, pq)


@pytest.mark.parametrize("k", [768, 4096])
@pytest.mark.parametrize("normed", [True, False], ids=["normed", "raw"])
@pytest.mark.parametrize("B", [1, 8])
def test_dual_plain_matches_pallas(k, normed, B):
    """K7 on the 8B Q4_K_M pair (Q4_K wqk, Q6_K wv): mode 1 on both parts
    at K = 768, mode 2 at K = 4096."""
    ja, pa = _qt(GGMLType.Q4_K, 1024, k, seed=1)
    jb, pb = _qt(GGMLType.Q6_K, 512, k, seed=2)
    assert JF.supports_dual(ja, jb) and PF.supports_dual(pa, pb)
    x = _rand(B + k, B, k) * 1.5
    kw = {}
    if normed:
        x, eps = normed_input(B + k, B, k)
        kw = dict(eps=eps)
    wn = np.random.default_rng(5).random(k).astype(np.float32) + 0.5
    wa, wb = wn[JF.interleave_perm(k, 32)], wn[JF.interleave_perm(k, 16)]
    want = JF.qmatmul_fast_dual(
        jnp.asarray(x), ja, jb, jnp.asarray(wa) if normed else None,
        jnp.asarray(wb) if normed else None, interpret=True, **kw)
    got = PF.qmatmul_fast_dual(
        torch.from_numpy(x), pa, pb, torch.from_numpy(wa) if normed else None,
        torch.from_numpy(wb) if normed else None, **kw)
    assert got.shape == (B, 1536)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dual_refuses_prefill_rows():
    _, pa = _qt(GGMLType.Q4_K, 1024, 768, seed=1)
    _, pb = _qt(GGMLType.Q6_K, 512, 768, seed=2)
    with pytest.raises(ValueError):
        PF.qmatmul_fast_dual(torch.zeros(9, 768), pa, pb)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q4_0,
                                   GGMLType.Q6_K, GGMLType.Q5_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("ids", [[2, 0], [3, 3], [1, 3, 0, 2, 2, 1, 0, 3] * 2],
                         ids=["P2", "P2_dup", "P16"])
def test_indirect_plain_matches_pallas(qtype, ids):
    npe = 256
    jq, pq = _qt(qtype, 4 * npe, 768)
    assert PF.supports_indirect(pq, npe) and JF.supports_indirect(jq, npe)
    x = _rand(len(ids), len(ids), 768) * 1.5
    ids = np.asarray(ids, np.int32)
    want = JF.qmatmul_fast_indirect(jnp.asarray(x), jq, jnp.asarray(ids), npe,
                                    interpret=True)
    got = PF.qmatmul_fast_indirect(torch.from_numpy(x), pq,
                                   torch.from_numpy(ids), npe)
    assert got.shape == (len(ids), npe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_indirect_nibble_plain_marks_bad_ids():
    _, pq = _qt(GGMLType.Q4_K, 4 * 256, 768)
    y = PF.qmatmul_fast_indirect(torch.ones(2, 768), pq,
                                 torch.tensor([1, 4], dtype=torch.int32), 256)
    assert torch.isfinite(y[0]).all() and torch.isnan(y[1]).all()


def test_gates_agree_with_jax():
    """supports_dual / supports_indirect / supports_fused_epilogue on the
    same interleaved planes, the port's and the JAX package's."""
    qts = [_qt(GGMLType.Q4_K, 1024, 768, seed=1),
           _qt(GGMLType.Q6_K, 512, 768, seed=2),
           _qt(GGMLType.Q4_K, 300, 768),
           _qt(GGMLType.Q4_0, 1024, 4096),
           _qt(GGMLType.Q5_K, 512, 4096)]
    for ja, pa in qts:
        for B in (1, 8, 16):
            assert (PF.supports_fused_epilogue(pa, B)
                    == JF.supports_fused_epilogue(ja, B))
        for npe in (128, 256, 100):
            assert PF.supports_indirect(pa, npe) == JF.supports_indirect(ja, npe)
        for jb, pb in qts:
            assert PF.supports_dual(pa, pb) == JF.supports_dual(ja, jb)
    assert PF.supports_dual(qts[0][1], qts[1][1])
    assert not PF.supports_dual(qts[0][1], qts[2][1])  # padded rows


def test_normed_blocks_nibble_planes_as_nibble(monkeypatch):
    """Repair: the normed entry asked `_pick_blocks` for a byte blocking on
    nibble planes.  The two differ where it matters: at K = 37120 and 512
    rows nibble planes keep the full K in one block (the fused norm) and
    byte planes split it (the norm apart)."""
    assert PF._pick_blocks(512, 37120, True, 32)[1] == 1
    assert PF._pick_blocks(512, 37120, False, 32)[1] > 1
    seen = []
    real = PF._pick_blocks
    monkeypatch.setattr(PF, "_pick_blocks",
                        lambda B, K, nib, gs: seen.append(nib) or real(B, K, nib, gs))
    _, pq = _qt(GGMLType.Q4_K, 512, 768)
    wn = torch.rand(768) + 0.5
    PF.qmatmul_fast_normed(torch.randn(2, 768), pq, wn, 1e-5)
    assert seen == [True]


@pytest.mark.parametrize("mode", ["plain", "res", "normed", "act"])
def test_mode1_group_sums_take_the_unrounded_input(mode):
    """Repair: the mode-1 group sums come from the caller's un-rounded x
    (the JAX entries sum x before the kernel's bf16 cast).  Summing the bf16
    x instead moves the Q4_1 bias term by more than the tolerance, so the
    test holds the un-rounded route against JAX and shows the gap."""
    jq, pq = _qt(GGMLType.Q4_1, 512, 768, seed=3)
    assert pq.fb is not None and PF._xg_mode(pq) == 1
    width = 1536 if mode == "act" else 768
    # large, far from bf16-exact (the act product grows as the square)
    x = _rand(11, 4, width) * (2.0 if mode == "act" else 8.0) + (
        3.0 if mode == "act" else 20.0)
    eps = 1e-5
    if mode == "normed":
        x, eps = normed_input(11, 4, 768)
        x = x + np.float32(1 / 1024)   # off the bf16 grid; mean square moves
    wn = np.random.default_rng(6).random(768).astype(np.float32) + 0.5
    wn_il = wn[JF.interleave_perm(768, 32)]
    res = _rand(12, 4, 512) if mode in ("res", "act") else None
    jw = None if res is None else jnp.asarray(res)
    pw = None if res is None else torch.from_numpy(res)
    want = np.asarray(_mode_call(JF, mode, jnp.asarray(x), jq, 768,
                                 jnp.asarray(wn_il), jw, eps, interpret=True))
    got = _mode_call(PF, mode, torch.from_numpy(x), pq, 768,
                     torch.from_numpy(wn_il), pw, eps).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    xr = torch.from_numpy(x).to(torch.bfloat16).float()
    rounded = _mode_call(PF, mode, xr, pq, 768, torch.from_numpy(wn_il),
                         pw, eps).numpy()
    if mode != "normed":   # normed sums x*wn: the rounded x moves it too
        assert not np.allclose(rounded, want, **TOL)


def test_concat_keeps_the_parts_layout(monkeypatch):
    """Repair: fusing padded interleaved parts rebuilt them on the default
    layout (t-planes for Q4_K); it keeps the parts' layout, as the JAX
    package under GHT_QP8=0 does."""
    rng = np.random.default_rng(8)
    parts = [_jax_il(quantize_tensor(rng.normal(size=(n, 512)).astype(
        np.float32) * 0.05, GGMLType.Q4_K)) for n in (256, 128)]
    assert all(p.fq.shape[0] == 512 for p in parts)     # padded planes
    monkeypatch.setenv("GHT_QP8", "0")
    want = JFU._concat_qtensors(parts)
    monkeypatch.setenv("GHT_QP8", "1")
    got = PFU._concat_qtensors([port_qt(p) for p in parts])
    assert got.fl == want.fl == "il"
    leaf = jax_qt_leaf(want)
    for f in ("fq", "fs", "fb"):
        np.testing.assert_array_equal(_bits(getattr(got, f)), leaf[f],
                                      err_msg=f)
