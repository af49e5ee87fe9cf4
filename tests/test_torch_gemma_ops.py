"""The kernel branches that Gemma-class models reach, their plain versions
against the JAX package's Pallas kernels in interpret mode (no model):

  acts    `gelu` and `relu` against jax.nn.gelu(approximate=True) and
          jax.nn.relu, in f32 and bf16; `act_f32` (the kernels' form)
          against the JAX kernels' `_apply_act_f32`;
  K1      the act mode in gelu and relu, with and without the residual,
          on Q4_K and Q6_K t-planes, B = 1 and 8 (`qp8_matmul_act` against
          the JAX entry with interpret=True);
  K6      the act mode in gelu and relu, with and without the residual, on
          Q8_0 byte, Q4_K nibble and IQ3_XXS coded interleaved planes at
          K = 768 (G = 24, not lane-aligned: the caller's group sums), B =
          1 and 8;
  K9      `ffn_fused` in gelu and relu at D = 4096 (the smallest width the
          megakernel takes), NFF = 512, Q4_K wo and gate_up, a Q4_K and a
          Q6_K down, B = 1 and 3;
  K4      `fused_decode_attention` at a head width of 256 (Gemma-2's) on
          bf16, int8 (q8_0) and packed 4-bit (q4_0) caches, with a sliding
          window that masks and a logit cap that bends the scores.

Tolerances: K1, K6 and K9 NMSE <= 1e-6 (K9's own op test's): tanh differs
by an ulp between XLA and torch (and XLA's vectorised tanh from its scalar
one), which flips an int8 (K1) or bf16 (K6, K9) rounding of about one
activation in a hundred, so the outputs are not bit for bit (K6's gelu at
B = 8: NMSE 1e-7, max |d| 0.011 on outputs of 13).  K4
rtol = atol = 1e-5 (f32 on both sides, another summation order).  The acts
themselves: f32 within 1e-6 (XLA's and torch's tanh and exp differ by a few
ulp), bf16 within one bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops import basic as JB
from ggml_hexagon_tpu.ops import ffn_fused as JFF
from ggml_hexagon_tpu.ops import qmm_fast as JF
from ggml_hexagon_tpu.ops import qmm_qp8 as JQ
from ggml_hexagon_tpu.ops.basic import RopeParams as JRopeParams
from ggml_hexagon_tpu.ops.basic import rope_freqs as jax_rope_freqs
from ggml_hexagon_tpu.ops.decode_attn import \
    fused_decode_attention as jax_fused
from ggml_hexagon_tpu.ops.qmm_fast import interleave_perm as j_perm
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import coded_qtensor, nmse, port_qt, wire_qtensor
from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.ops import basic as PB
from ggml_hexagon_tpu_torch.ops import decode_attn as PD
from ggml_hexagon_tpu_torch.ops import ffn_fused as PFF
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as PQ

NMSE_OP = 1e-6
ACTS = ["gelu", "relu"]
_QT = {}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _qt(qtype, n, k, layout):
    """A JAX QTensor with matmul planes of `layout` and its port twin."""
    key = (qtype, n, k, layout)
    if key not in _QT:
        if qtype == GGMLType.IQ3_XXS:  # drawn as the loader holds them
            jq = coded_qtensor(qtype, n, k, seed=3).astype_device(
                layout=layout)
        else:
            rng = np.random.default_rng(int(qtype) * 7 + n + k)
            w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
            jq = quantize_tensor(w, qtype).astype_device(layout=layout)
        assert jq.fl == layout
        _QT[key] = (jq, port_qt(jq))
    return _QT[key]


# ---------------------------------------------------------------------------
# the activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = _rand(1, 4096, scale=3.0)
    want = np.asarray(JB.gelu(jnp.asarray(x, dtype)).astype(jnp.float32))
    got = PB.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_matches_jax(dtype):
    x = _rand(2, 4096, scale=3.0)
    want = np.asarray(jax.nn.relu(jnp.asarray(x, dtype)).astype(jnp.float32))
    got = PB.relu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_act_f32_matches_kernel_form(act):
    x = _rand(3, 4096, scale=4.0)
    want = np.asarray(JQ._apply_act_f32(act, jnp.asarray(x)))
    got = PB.act_f32(act, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert PB.act(act, torch.from_numpy(x)).shape == x.shape


# ---------------------------------------------------------------------------
# K1 and K6: the act mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("with_res", [False, True], ids=["", "res"])
def test_k1_act_plain_matches_pallas(qtype, act, B, with_res):
    jq, pq = _qt(qtype, 512, 512, "t")
    x = _rand(10 + B, B, 2 * jq.k, scale=2.0)
    res = _rand(20 + B, B, jq.n) if with_res else None
    want = JQ.qp8_matmul_act(jnp.asarray(x), jq, act,
                             res=None if res is None else jnp.asarray(res),
                             interpret=True)
    kernels.reset_launches()
    got = PQ.qp8_matmul_act(torch.from_numpy(x), pq, act,
                            res=None if res is None else torch.from_numpy(res))
    err = nmse(got.numpy(), np.asarray(want))
    assert err <= NMSE_OP, (qtype.name, act, B, with_res, err)
    assert set(kernels.LAUNCHES.values()) == {0}  # CPU: plain


@pytest.mark.parametrize("qtype", [GGMLType.Q8_0, GGMLType.Q4_K,
                                   GGMLType.IQ3_XXS], ids=lambda t: t.name)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("with_res", [False, True], ids=["", "res"])
def test_k6_act_plain_matches_pallas(qtype, act, B, with_res):
    jq, pq = _qt(qtype, 512, 768, "il")
    assert 768 // jq.cfg.gs == 24
    x = _rand(30 + B, B, 2 * 768, scale=2.0)
    res = _rand(40 + B, B, 512) if with_res else None
    want = JF.qmatmul_fast_act(jnp.asarray(x), jq, act,
                               res=None if res is None else jnp.asarray(res),
                               interpret=True)
    got = PF.qmatmul_fast_act(torch.from_numpy(x), pq, act,
                              res=None if res is None else torch.from_numpy(res))
    err = nmse(got.numpy(), np.asarray(want))
    assert err <= NMSE_OP, (qtype.name, act, B, with_res, err)


# ---------------------------------------------------------------------------
# K9: phase B's act
# ---------------------------------------------------------------------------

D, NFF, EPS = 4096, 512, 1e-5


@pytest.fixture(scope="module")
def k9_ref():
    """The megakernel layout's planes (as tests/test_torch_ffn_fused.py
    builds them) for a Q4_K and a Q6_K down, and the JAX op's output in
    interpret mode per act and B."""
    rng = np.random.default_rng(7)
    perm_d = np.asarray(j_perm(D, 32))
    wo = wire_qtensor(GGMLType.Q4_K, D, D, seed=11).astype_device(layout="il")
    gu = wire_qtensor(GGMLType.Q4_K, 2 * NFF, D, seed=12).astype_device(
        layout="il")
    wo_p = wo.take_rows(perm_d)
    wn_il = (rng.random(D).astype(np.float32) + 0.5)[perm_d]
    attn = (rng.normal(size=(3, D)) * 0.3).astype(np.float32)
    h = (rng.normal(size=(3, D)) * 0.5).astype(np.float32)
    out = {"attn": attn, "h": h, "wn_il": wn_il, "port_wo": port_qt(wo_p),
           "cases": {}}
    for name, qtype in (("Q4_K", GGMLType.Q4_K), ("Q6_K", GGMLType.Q6_K)):
        dn = wire_qtensor(qtype, D, NFF, seed=13).astype_device(layout="il")
        pc = np.asarray(j_perm(NFF, dn.cfg.gs))
        gu_il = gu.take_rows(np.concatenate([pc, NFF + pc]))
        dn_p = dn.take_rows(perm_d)
        want = {(act, B): np.asarray(JFF.ffn_fused(
            jnp.asarray(attn[:B]), jnp.asarray(h[:B]), wo_p, gu_il, dn_p,
            jnp.asarray(wn_il), EPS, act=act, out_dtype=jnp.float32,
            interpret=True)) for act in ACTS for B in (1, 3)}
        out["cases"][name] = {"want": want,
                              "port": (port_qt(gu_il), port_qt(dn_p))}
    return out


@pytest.mark.parametrize("down", ["Q4_K", "Q6_K"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("B", [1, 3])
def test_k9_act_plain_matches_pallas(k9_ref, down, act, B):
    case = k9_ref["cases"][down]
    gu, dn = case["port"]
    got = PFF.ffn_fused(torch.from_numpy(k9_ref["attn"][:B]),
                        torch.from_numpy(k9_ref["h"][:B]), k9_ref["port_wo"],
                        gu, dn, torch.from_numpy(k9_ref["wn_il"]), EPS,
                        act=act, out_dtype=torch.float32)
    want = case["want"][(act, B)]
    err = nmse(got.numpy(), want)
    assert err <= NMSE_OP, (down, act, B, err)


# ---------------------------------------------------------------------------
# K4 at a head width of 256
# ---------------------------------------------------------------------------

Hq, Hkv, HD = 4, 2, 256


@pytest.mark.parametrize("kv", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("swa,cap", [(0, 0.0), (24, 3.0)],
                         ids=["plain", "swa_cap"])
def test_k4_head_256_plain_matches_pallas(kv, swa, cap):
    B, S = 2, 256
    rng = np.random.default_rng({"bf16": 1, "q8_0": 2, "q4_0": 3}[kv] + swa)
    qkv = rng.normal(size=(B, (Hq + 2 * Hkv) * HD)).astype(np.float32)
    pos = [40, 200]
    kw = {}
    if kv == "bf16":
        kc = rng.normal(size=(B, S, Hkv * HD)).astype(np.float32)
        vc = rng.normal(size=(B, S, Hkv * HD)).astype(np.float32)
        jk, jv = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
        tk = torch.from_numpy(kc).to(torch.bfloat16)
        tv = torch.from_numpy(vc).to(torch.bfloat16)
    else:
        qmax = 127 if kv == "q8_0" else 7
        kc = rng.integers(-qmax, qmax + 1, size=(B, S, Hkv * HD)).astype(np.int8)
        vc = rng.integers(-qmax, qmax + 1, size=(B, S, Hkv * HD)).astype(np.int8)
        kd = (rng.random((B, S)) * 2.0 / qmax).astype(np.float32)
        vd = (rng.random((B, S)) * 2.0 / qmax).astype(np.float32)
        jdt = jnp.int8 if kv == "q8_0" else jnp.int4
        jk, jv = jnp.asarray(kc, jdt), jnp.asarray(vc, jdt)
        tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
        if kv == "q4_0":
            tk, tv = PD.pack_int4(tk), PD.pack_int4(tv)
        kw = dict(k_scale=kd, v_scale=vd)
    params = dict(Hq=Hq, Hkv=Hkv, D=HD, scale=1 / np.sqrt(HD), mscale=1.0,
                  swa=swa, logit_cap=cap)
    rp = dict(n_dims=HD, mode="neox", freq_base=10000.0)
    jinv, _ = jax_rope_freqs(JRopeParams(**rp))
    want = jax_fused(jnp.asarray(qkv), jk, jv, jnp.asarray(pos, jnp.int32),
                     jinv, chunk=64, interpret=True,
                     **{k: jnp.asarray(v) for k, v in kw.items()}, **params)
    # the rope's cos and sin as the JAX side computes them: XLA's and
    # torch's cos of 200 rad differ by 1e-5, which is not the kernel's
    ang = jnp.asarray(pos, jnp.float32)[:, None] * jinv[None, :]
    cs = torch.from_numpy(np.array(jnp.concatenate(
        [jnp.cos(ang), jnp.sin(ang)], axis=1)))
    got = PD.fused_decode_attention(
        torch.from_numpy(qkv), tk, tv, torch.tensor(pos, dtype=torch.int32),
        None, cos_sin=cs, **{k: torch.from_numpy(v) for k, v in kw.items()},
        **params)
    for name, g, w in zip(("attn", "k_row", "v_row"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   rtol=1e-5, atol=1e-5)
    if swa:  # the window masks: slots below pos - swa + 1 change nothing
        kc2 = tk.clone()
        kc2[:, :pos[1] - swa] = 0
        again = PD.fused_decode_attention(
            torch.from_numpy(qkv), kc2, tv, torch.tensor(pos, dtype=torch.int32),
            None, cos_sin=cs, **{k: torch.from_numpy(v) for k, v in kw.items()},
            **params)
        torch.testing.assert_close(again[0][1], got[0][1], rtol=0, atol=0)
        assert not torch.equal(again[0][0], got[0][0])
