"""The port's attention against the JAX package:

  plain K4 vs `fused_decode_attention(interpret=True)`: bf16 and int8 KV,
  one chunk (`_kernel_single`) and several (`_kernel`), pos 0 and later;
  plain `flash_attention_cache` vs the JAX scan at S=256, chunk 128.

Both sides compute in f32 in a different summation order: rtol = atol =
1e-5 (measured max |diff| ~1e-6 on outputs of magnitude ~1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops.attention import \
    flash_attention_cache as jax_flash
from ggml_hexagon_tpu.ops.basic import RopeParams as JRopeParams
from ggml_hexagon_tpu.ops.basic import rope_freqs as jax_rope_freqs
from ggml_hexagon_tpu.ops.decode_attn import \
    fused_decode_attention as jax_fused

from ggml_hexagon_tpu_torch.ops import decode_attn as PD
from ggml_hexagon_tpu_torch.ops.attention import flash_attention_cache
from ggml_hexagon_tpu_torch.ops.basic import RopeParams, rope_freqs

TOL = dict(rtol=1e-5, atol=1e-5)
Hq, Hkv, D = 8, 2, 128


def _inputs(B, S, quant, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, (Hq + 2 * Hkv) * D)).astype(np.float32)
    if quant:
        kc = rng.integers(-127, 128, size=(B, S, Hkv * D)).astype(np.int8)
        vc = rng.integers(-127, 128, size=(B, S, Hkv * D)).astype(np.int8)
        kd = (rng.random((B, S)) * 0.02).astype(np.float32)
        vd = (rng.random((B, S)) * 0.02).astype(np.float32)
    else:
        kc = rng.normal(size=(B, S, Hkv * D)).astype(np.float32)
        vc = rng.normal(size=(B, S, Hkv * D)).astype(np.float32)
        kd = vd = None
    return qkv, kc, vc, kd, vd


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("S,chunk", [(256, 1024), (256, 64)],
                         ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("pos", [[0, 0], [1, 200], [256, 37]],
                         ids=["pos0", "pos1_200", "pos256_37"])
def test_decode_attention_plain_matches_pallas(quant, S, chunk, pos):
    B = 2
    qkv, kc, vc, kd, vd = _inputs(B, S, quant, seed=S + pos[1])
    params = dict(Hq=Hq, Hkv=Hkv, D=D, scale=1 / np.sqrt(D), mscale=1.0)
    rp = dict(n_dims=D, mode="neox", freq_base=500000.0)
    jinv, _ = jax_rope_freqs(JRopeParams(**rp))
    jpos = jnp.asarray(pos, jnp.int32)
    if quant:
        jk, jv = jnp.asarray(kc), jnp.asarray(vc)
        tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    else:  # the bf16 cache: identical rounded values on both sides
        jk, jv = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
        tk = torch.from_numpy(kc).to(torch.bfloat16)
        tv = torch.from_numpy(vc).to(torch.bfloat16)
    want = jax_fused(
        jnp.asarray(qkv), jk, jv, jpos, jinv,
        k_scale=None if kd is None else jnp.asarray(kd),
        v_scale=None if vd is None else jnp.asarray(vd),
        chunk=chunk, interpret=True, **params)
    tinv, _ = rope_freqs(RopeParams(**rp))
    got = PD.fused_decode_attention(
        torch.from_numpy(qkv), tk, tv, torch.tensor(pos, dtype=torch.int32),
        tinv, k_scale=None if kd is None else torch.from_numpy(kd),
        v_scale=None if vd is None else torch.from_numpy(vd), **params)
    for name, g, w in zip(("attn", "k_row", "v_row"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("swa,cap", [(16, 0.0), (0, 2.0), (100, 2.0)],
                         ids=["swa", "cap", "swa_cap"])
def test_decode_attention_swa_and_logit_cap_match_pallas(swa, cap):
    """The options the llama path does not take yet (sliding window, logit
    soft-cap), on several chunks."""
    B, S = 2, 256
    qkv, kc, vc, _, _ = _inputs(B, S, False, seed=5)
    pos = [40, 200]
    params = dict(Hq=Hq, Hkv=Hkv, D=D, scale=1 / np.sqrt(D), mscale=1.0,
                  swa=swa, logit_cap=cap)
    rp = dict(n_dims=D, mode="neox", freq_base=500000.0)
    jinv, _ = jax_rope_freqs(JRopeParams(**rp))
    want = jax_fused(jnp.asarray(qkv), jnp.asarray(kc, jnp.bfloat16),
                     jnp.asarray(vc, jnp.bfloat16), jnp.asarray(pos, jnp.int32),
                     jinv, chunk=64, interpret=True, **params)
    tinv, _ = rope_freqs(RopeParams(**rp))
    got = PD.fused_decode_attention(
        torch.from_numpy(qkv), torch.from_numpy(kc).to(torch.bfloat16),
        torch.from_numpy(vc).to(torch.bfloat16),
        torch.tensor(pos, dtype=torch.int32), tinv, **params)
    for name, g, w in zip(("attn", "k_row", "v_row"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_flash_attention_cache_matches_jax(quant):
    B, G, T, S = 2, 4, 24, 256
    rng = np.random.default_rng(7)
    qg = rng.normal(size=(B, Hkv, G, T, D)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, size=(B, Hkv, S, D)).astype(np.int8)
        v = rng.integers(-127, 128, size=(B, Hkv, S, D)).astype(np.int8)
        ks = (rng.random((B, S)) * 0.02).astype(np.float32)
        vs = (rng.random((B, S)) * 0.02).astype(np.float32)
    else:
        k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
        v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
        ks = vs = None
    pos = np.asarray([0, 100], np.int32)
    kw = dict(swa=0, logit_cap=0.0, chunk=128)
    want = jax_flash(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(pos), T, 1 / np.sqrt(D),
                     k_scale=None if ks is None else jnp.asarray(ks),
                     v_scale=None if vs is None else jnp.asarray(vs), **kw)
    got = flash_attention_cache(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), T, 1 / np.sqrt(D),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_wrapper_takes_plain_only_on_cpu():
    qkv, kc, vc, _, _ = _inputs(1, 64, False, seed=3)
    args = (torch.from_numpy(qkv), torch.from_numpy(kc).to(torch.bfloat16),
            torch.from_numpy(vc).to(torch.bfloat16),
            torch.tensor([5], dtype=torch.int32), None)
    kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=0.1)
    for g, w in zip(PD.decode_attn(*args, **kw),
                    PD.decode_attn_plain(*args, **kw)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
