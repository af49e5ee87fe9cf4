"""The plain versions of the port's qp8 kernels against the JAX package's
Pallas kernels in interpret mode, on the same planes and inputs:

  K1 `_qp8_decode_kernel` (raw, normed, res, act; B in {1, 4, 8}),
  K2 `_qp8_dual_kernel` (Q4_K + Q6_K, one shared norm),
  K3 `_tpf_kernel` (B = 16).

Tolerance rtol = atol = 5e-4, the JAX package's own kernel-vs-oracle
tolerance (tests/test_qmm_qp8.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops import qmm_qp8 as J
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import port_qt
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P

TOL = dict(rtol=5e-4, atol=5e-4)
TYPES = [GGMLType.Q4_K, GGMLType.Q6_K]
_QT = {}


def _qt(qtype, n=512, k=512):
    """A JAX t-layout QTensor (wire kept) and its port twin, cached."""
    key = (qtype, n, k)
    if key not in _QT:
        rng = np.random.default_rng(int(qtype) * 7 + n + k)
        w = rng.normal(size=(n, k)).astype(np.float32)
        jq = quantize_tensor(w, qtype).astype_device(fast=True)
        assert jq.fl == "t"
        _QT[key] = (jq, port_qt(jq))
    return _QT[key]


def _x(B, K, seed):
    return np.random.default_rng(seed).normal(size=(B, K)).astype(np.float32)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("mode", ["raw", "normed", "res", "act"])
def test_decode_gemv_plain_matches_pallas(qtype, B, mode):
    jq, pq = _qt(qtype)
    K, n = jq.k, jq.n
    x = _x(B, 2 * K if mode == "act" else K, seed=B)
    wn = np.random.default_rng(5).random(K).astype(np.float32) + 0.5
    res = _x(B, n, seed=9)
    eps = 1e-5
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if mode == "raw":
        want = J.qp8_matmul(xj, jq, interpret=True)
        got = P.qp8_matmul(xt, pq)
    elif mode == "normed":
        want = J.qp8_matmul_normed(xj, jq, jnp.asarray(wn), eps, interpret=True)
        got = P.qp8_matmul_normed(xt, pq, torch.from_numpy(wn), eps)
    elif mode == "res":
        want = J.qp8_matmul_res(xj, jq, jnp.asarray(res), interpret=True)
        got = P.qp8_matmul_res(xt, pq, torch.from_numpy(res))
    else:
        want = J.qp8_matmul_act(xj, jq, "silu", res=jnp.asarray(res),
                                interpret=True)
        got = P.qp8_matmul_act(xt, pq, "silu", res=torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B", [1, 4])
def test_dual_plain_matches_pallas(B):
    ja, pa = _qt(GGMLType.Q4_K, n=1024)
    jb, pb = _qt(GGMLType.Q6_K, n=512)
    x = _x(B, ja.k, seed=11)
    wn = np.random.default_rng(12).random(ja.k).astype(np.float32) + 0.5
    want = J.qp8_matmul_dual(jnp.asarray(x), ja, jb, wn=jnp.asarray(wn),
                             eps=1e-5, interpret=True)
    got = P.qp8_matmul_dual(torch.from_numpy(x), pa, pb,
                            wn=torch.from_numpy(wn), eps=1e-5)
    assert got.shape == (B, 1536)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_prefill_gemm_plain_matches_pallas(qtype):
    jq, pq = _qt(qtype)
    x = _x(16, jq.k, seed=13)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = J.qp8_matmul(xb, jq, interpret=True)
    got = P.qp8_matmul(torch.from_numpy(x).to(torch.bfloat16), pq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padded_head_slices_to_n():
    """n not a multiple of the lane quantum: planes pad, outputs slice."""
    jq, pq = _qt(GGMLType.Q6_K, n=300)
    assert pq.fq.shape[1] == 512
    x = _x(2, jq.k, seed=14)
    want = J.qp8_matmul(jnp.asarray(x), jq, interpret=True)
    got = P.qp8_matmul(torch.from_numpy(x), pq)
    assert got.shape == (2, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gemv_kernel_wrapper_takes_plain_only_on_cpu():
    """On CPU tensors the K1 wrapper is the plain version, bit for bit."""
    _, pq = _qt(GGMLType.Q4_K)
    x = torch.from_numpy(_x(3, pq.k, seed=15))
    torch.testing.assert_close(P.qp8_gemv(x, pq), P.qp8_gemv_plain(x, pq),
                               rtol=0, atol=0)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_act_other_than_silu_raises(act):
    """K1's prologue and its plain version take silu only."""
    _, pq = _qt(GGMLType.Q4_K)
    x = torch.from_numpy(_x(1, 2 * pq.k, seed=16))
    with pytest.raises(NotImplementedError):
        P.qp8_matmul_act(x, pq, act)
