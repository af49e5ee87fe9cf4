"""The port's wire-plane matmul (K10), q8 parity mode, attention oracles,
masked flash attention (K11) and single-token GQA cache attention (K12)
against the JAX package, on the same numpy-seeded inputs.

  dequantize      the port's wire dequant against `dequantize_jax`, all 21
                  types, bit-exact (the same f32 expression);
  qmatmul_xla     against the JAX `qmatmul_xla`, all 21 types at N=128,
                  K=256, B=4 and N=200 (rows padded to 256), B=3: both
                  round the operands to bf16 and sum the exact products in
                  f32, in another order: NMSE <= 1e-6;
  plain K10       `qmatmul_pallas` on the CPU (the `_qmm_kernel`
                  arithmetic) against `qmatmul_pallas(interpret=True)` at
                  the same shapes, NMSE <= 1e-6, and in f32 compute.  The
                  JAX kernel contracts the IQ4 types' raw 4-bit codes (it
                  has no LUT step, ggml_hexagon_tpu/ops/qmatmul.py:203-235),
                  so for IQ4_NL and IQ4_XS the port, which takes the LUT
                  values like the wire dequant, is held against the JAX
                  `qmatmul_xla` (the same roundings) and, with the LUT
                  switched off, against the JAX kernel;
  q8 parity mode  `q8_act_kind` for every type and `quantize_act_ref` for
                  q8_0, q8_1 and q8_K, bit-exact, ties and a zero row
                  included; `qmatmul_xla` under GHT_Q8_ACT=1 on both sides
                  (f32 contraction in another order: rtol = atol = 1e-5);
  K11             the plain twin against `flash_attention_pallas(
                  interpret=True)` and `dense_attention` on
                  tests/test_attention.py's fixture (its dead tail
                  included), rtol = atol = 2e-5 (f32, another order);
  K11 TF32 split   a torch emulation of the card kernel's arithmetic
                  (q*scale, k, p and v rounded bit for bit to TF32 as big
                  + small, three products, two for bf16 k and v, online
                  softmax over 32-slot tiles) within 1e-5 of the plain
                  twin on the same fixture: the split meets the f32
                  contract without a card;
  K12             the plain twin against `decode_attention_pallas(
                  interpret=True)` for (swa, cap) = (0, 0), (64, 0),
                  (0, 30), rtol = atol = 2e-5;
  dispatch        `qmatmul`'s four backends against their JAX routes;
  synth           `random_qtensor` draws Q4_1 and Q5_1 with their m plane.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops import attention as JA
from ggml_hexagon_tpu.ops.qmm_fast import qmatmul_fast as jax_qmatmul_fast
from ggml_hexagon_tpu.quant.pack import QCONFIGS as JCONFIGS
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import nmse, port_qt, wire_qtensor
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.ops import attention as PA
from ggml_hexagon_tpu_torch.ops import qmatmul as PQ
from ggml_hexagon_tpu_torch.quant.formats import GGMLType
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS

# the JAX ops package exports a function named qmatmul beside the module
JQ = importlib.import_module("ggml_hexagon_tpu.ops.qmatmul")
NMSE_MAX = 1e-6
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
TYPES = sorted(QCONFIGS, key=int)
SHAPES = [(128, 4), (200, 3)]        # (n, B) at K = 256
K = 256


def _x(B, seed=0):
    return np.random.default_rng(seed).normal(size=(B, K)).astype(np.float32)


_QT = {}


def _qt(qtype, n):
    key = (qtype, n)
    if key not in _QT:
        jq = wire_qtensor(GGMLType(int(qtype)), n, K, seed=5)
        _QT[key] = jq, port_qt(jq)
    return _QT[key]


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_dequantize_matches_jax(qtype):
    jq, pq = _qt(qtype, 128)
    want = np.asarray(JQ.dequantize_jax(jq, jnp.float32))
    np.testing.assert_array_equal(PQ.dequantize(pq).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}-B{s[1]}")
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_qmatmul_xla_matches_jax(qtype, shape):
    n, B = shape
    jq, pq = _qt(qtype, n)
    x = _x(B)
    want = np.asarray(JQ.qmatmul_xla(jnp.asarray(x), jq))
    got = PQ.qmatmul_xla(torch.from_numpy(x), pq)
    assert got.shape == (B, n)
    assert nmse(got.numpy(), want) <= NMSE_MAX


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}-B{s[1]}")
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_qmm_wire_plain_matches_jax(qtype, shape):
    n, B = shape
    jq, pq = _qt(qtype, n)
    x = _x(B, seed=1)
    got = PQ.qmatmul_pallas(torch.from_numpy(x), pq)
    assert got.shape == (B, n) and torch.isfinite(got).all()
    jpallas = np.asarray(JQ.qmatmul_pallas(jnp.asarray(x), jq, interpret=True))
    if not QCONFIGS[qtype].lut:
        assert nmse(got.numpy(), jpallas) <= NMSE_MAX
        return
    want = np.asarray(JQ.qmatmul_xla(jnp.asarray(x), jq))
    assert nmse(got.numpy(), want) <= NMSE_MAX
    raw = dataclasses.replace(pq, cfg=dataclasses.replace(pq.cfg, lut=False))
    assert nmse(PQ.qmatmul_pallas(torch.from_numpy(x), raw).numpy(),
                jpallas) <= NMSE_MAX


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q5_1,
                                   GGMLType.IQ2_XS], ids=lambda t: t.name)
def test_qmm_wire_plain_f32_matches_jax(qtype):
    jq, pq = _qt(qtype, 200)
    x = _x(3, seed=2)
    want = np.asarray(JQ.qmatmul_pallas(jnp.asarray(x), jq,
                                        compute_dtype=jnp.float32,
                                        interpret=True))
    got = PQ.qmatmul_pallas(torch.from_numpy(x), pq,
                            compute_dtype=torch.float32)
    assert nmse(got.numpy(), want) <= NMSE_MAX


@pytest.mark.parametrize("B", [9, 512])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K,
                                   GGMLType.Q8_0], ids=lambda t: t.name)
def test_qmm_wire_plain_f32_above_eight_rows_matches_jax(qtype, B):
    """The rows K10's GEMM takes in f32 (B = 9 and 512): the plain twin
    against the JAX kernel in interpret mode."""
    jq, pq = _qt(qtype, 128)
    x = _x(B, seed=3)
    want = np.asarray(JQ.qmatmul_pallas(jnp.asarray(x), jq,
                                        compute_dtype=jnp.float32,
                                        interpret=True))
    got = PQ.qmatmul_pallas(torch.from_numpy(x), pq,
                            compute_dtype=torch.float32)
    assert got.shape == (B, 128)
    assert nmse(got.numpy(), want) <= NMSE_MAX


def test_q8_act_kind_matches_jax():
    for qtype in TYPES:
        assert PQ.q8_act_kind(QCONFIGS[qtype]) == JQ.q8_act_kind(
            JCONFIGS[qtype]), qtype.name


def _act_rows():
    """Random rows, a zero row and rows of exact rounding ties: for q8_0 a
    block whose amax is 127 (iscale 1) holding k + 0.5 values, for q8_K a
    block whose signed extreme is -127 holding them, and a block whose
    largest magnitude occurs twice with both signs (the first wins)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 512)).astype(np.float32) * 3
    x[1] = 0.0
    x[2, :32] = np.arange(32) - 15.5
    x[2, 0] = 127.0
    x[3, :256] = (np.arange(256) % 19) - 8.5
    x[3, 7] = -127.0
    x[4, :256] = rng.normal(size=256)
    x[4, 10], x[4, 200] = -5.0, 5.0
    x[5, 256:] = rng.normal(size=256)
    x[5, 300], x[5, 301] = 6.0, -6.0
    return x


@pytest.mark.parametrize("kind", ["q8_0", "q8_1", "q8_K"])
def test_quantize_act_ref_matches_jax(kind):
    x = _act_rows()
    want = np.asarray(JQ.quantize_act_ref(jnp.asarray(x), kind))
    got = PQ.quantize_act_ref(torch.from_numpy(x), kind).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q4_1,
                                   GGMLType.Q4_K, GGMLType.IQ4_NL,
                                   GGMLType.TQ2_0], ids=lambda t: t.name)
def test_qmatmul_xla_q8_mode_matches_jax(qtype, monkeypatch):
    monkeypatch.setenv("GHT_Q8_ACT", "1")
    jq, pq = _qt(qtype, 128)
    x = _x(4, seed=3)
    want = np.asarray(JQ.qmatmul_xla(jnp.asarray(x), jq))
    got = PQ.qmatmul_xla(torch.from_numpy(x), pq).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("GHT_Q8_ACT", "0")
    exact = PQ.qmatmul_xla(torch.from_numpy(x), pq).numpy()
    assert np.abs(exact - got).max() > 1e-4   # the mode changes the result


@pytest.fixture(scope="module")
def attn_inputs():
    """tests/test_attention.py's fixture: B=2, H=4, T=16, S=512, D=64, a
    causal-style mask with the last 64 slots dead."""
    r = np.random.default_rng(0)
    B, H, T, S, D = 2, 4, 16, 512, 64
    q = r.normal(size=(B, H, T, D)).astype(np.float32)
    k = r.normal(size=(B, H, S, D)).astype(np.float32)
    v = r.normal(size=(B, H, S, D)).astype(np.float32)
    t_idx = np.arange(T)[:, None]
    s_idx = np.arange(S)[None, :]
    mask = np.where(s_idx <= (S - T + t_idx), 0.0, -1e30).astype(np.float32)
    mask[:, -64:] = -1e30
    return q, k, v, mask[None, None], 1.0 / np.sqrt(D)


def test_flash_attn_plain_matches_jax(attn_inputs):
    q, k, v, mask, scale = attn_inputs
    jx = [jnp.asarray(a) for a in (q, k, v, mask)]
    px = [torch.from_numpy(a) for a in (q, k, v, mask)]
    want = np.asarray(JA.flash_attention_pallas(*jx, scale, chunk=128,
                                                interpret=True))
    got = PA.flash_attention_pallas(*px, scale, chunk=128)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    dense = np.asarray(JA.dense_attention(*jx, scale))
    np.testing.assert_allclose(got.numpy(), dense, **ATTN_TOL)
    np.testing.assert_allclose(PA.dense_attention(*px, scale).numpy(), dense,
                               **ATTN_TOL)
    scan = np.asarray(JA.flash_attention_scan(*jx, scale, chunk=256))
    np.testing.assert_allclose(
        PA.flash_attention_scan(*px, scale, chunk=256).numpy(), scan,
        **ATTN_TOL)
    with pytest.raises(ValueError):
        PA.flash_attention_pallas(*px, scale, chunk=384)


def test_flash_attn_plain_dead_rows_average_v(attn_inputs):
    """A row with every slot masked gets the mean of v, as in JAX (the
    mask value is finite)."""
    q, k, v, mask, scale = attn_inputs
    mask = mask.copy()
    mask[..., 3, :] = -1e30
    jx = [jnp.asarray(a) for a in (q, k, v, mask)]
    want = np.asarray(JA.flash_attention_pallas(*jx, scale, chunk=128,
                                                interpret=True))
    got = PA.flash_attention_pallas(*[torch.from_numpy(a)
                                      for a in (q, k, v, mask)], scale,
                                    chunk=128).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    np.testing.assert_allclose(got[:, :, 3], v.mean(axis=2), **ATTN_TOL)


def _tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with
    ties away from zero (on the magnitude), as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _tf32_products(a, b, b_exact):
    """a @ b as the card kernel forms it: three TF32 products (big*big,
    big*small, small*big; two when b is exact in TF32), each exact in f64
    here, summed in f32."""
    ab, as_ = _split(a)
    bb, bs = (b, torch.zeros_like(b)) if b_exact else _split(b)
    d = lambda u, v: (u.double() @ v.double())  # noqa: E731
    return (d(as_, bb) + d(ab, bs) + d(ab, bb)).to(torch.float32)


def _flash_tf32(q, k, v, mask, scale, bf16_kv, kt=32):
    """K11's arithmetic on the card: online softmax over kt-slot tiles,
    scores and p @ v through the TF32 split."""
    qf = q.to(torch.float32) * scale
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    B, H, T, D = q.shape
    S = k.shape[2]
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, D))
    for s0 in range(0, S, kt):
        sl = slice(s0, s0 + kt)
        s = _tf32_products(qf, kf[:, :, sl].transpose(-1, -2), bf16_kv)
        s = s + mask[..., sl]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _tf32_products(p, vf[:, :, sl],
                                                      bf16_kv)
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attn_tf32_split_meets_the_f32_contract(attn_inputs, dtype):
    """The card's K11 rounds q*scale, k, p and v to TF32 big + small parts
    (bf16 k and v are exact in TF32): emulated bit for bit, it lies within
    1e-5 of the plain twin (f32), dead tail included; on f32 inputs,
    dropping the small parts of q, k and v would not."""
    q, k, v, mask, scale = attn_inputs
    px = [torch.from_numpy(a) for a in (q, k, v, mask)]
    qd, kd, vd = (t.to(dtype) for t in px[:3])
    want = PA.flash_attn_plain(qd, kd, vd, px[3], scale, chunk=128)
    got = _flash_tf32(qd, kd, vd, px[3], scale, dtype == torch.bfloat16)
    assert float((got - want).abs().max()) <= 1e-5
    if dtype == torch.float32:
        one = _flash_tf32(_tf32(qd), _tf32(kd), _tf32(vd), px[3], scale, True)
        assert float((one - want).abs().max()) > 1e-5


@pytest.mark.parametrize("swa,cap", [(0, 0.0), (64, 0.0), (0, 30.0)])
def test_decode_attn_gqa_plain_matches_jax(swa, cap):
    rng = np.random.default_rng(0)
    B, Hkv, G, S, D = 2, 4, 2, 256, 128
    qg = rng.normal(size=(B, Hkv, G, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    pos = np.array([37, 200], np.int32)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(JA.decode_attention_pallas(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scale, swa=swa, logit_cap=cap, interpret=True))
    got = PA.decode_attention_pallas(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), scale, swa=swa, logit_cap=cap)
    assert got.dtype == torch.float32 and got.shape == qg.shape
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.fixture(scope="module")
def q4k_planes():
    """A Q4_K weight with t-planes and its wire, from the JAX encoder."""
    w = np.random.default_rng(4).normal(size=(256, K)).astype(np.float32)
    jq = quantize_tensor(w, GGMLType.Q4_K).astype_device(fast=True)
    pq = port_qt(jq)
    assert pq.fl == "t" and pq.q is not None
    return jq, pq


@pytest.mark.parametrize("backend", ["auto", "fast", "pallas", "xla"])
def test_qmatmul_backends_match_jax(q4k_planes, backend):
    """Each backend against the JAX route it names ("auto" at 3 rows: the
    t-planes, the JAX dispatcher's route on the TPU)."""
    jq, pq = q4k_planes
    x = _x(3, seed=6)
    jx = jnp.asarray(x)
    want = {"auto": lambda: jax_qmatmul_fast(jx, jq, interpret=True),
            "fast": lambda: jax_qmatmul_fast(jx, jq, interpret=True),
            "pallas": lambda: JQ.qmatmul_pallas(jx, jq, interpret=True),
            "xla": lambda: JQ.qmatmul_xla(jx, jq)}[backend]()
    got = PQ.qmatmul(torch.from_numpy(x), pq, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)
    if backend == "auto":
        torch.testing.assert_close(got, PQ.qmatmul(torch.from_numpy(x), pq,
                                                   backend="fast"),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_1, GGMLType.Q5_1],
                         ids=lambda t: t.name)
def test_random_qtensor_min_types_draw_m(qtype):
    """Q4_1 and Q5_1 carry an f32 m plane [n_pad, k/32] (the wire's min);
    their weights centre at 0 with an RMS of about 1/sqrt(k)."""
    gen = torch.Generator().manual_seed(1)
    qt = random_qtensor(gen, 128, 512, qtype, "cpu")
    assert qt.m is not None and qt.m.dtype == torch.float32
    assert qt.m.shape == (128, 512 // 32)
    w = PQ.dequantize(qt)
    assert torch.isfinite(w).all()
    rms = float(w.pow(2).mean().sqrt()) * 512 ** 0.5
    assert abs(float(w.mean())) * 512 ** 0.5 < 0.05 and 0.8 < rms < 1.2
