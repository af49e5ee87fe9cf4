"""The port's IQ3_XXS serving paths against the JAX package on a 2-layer
Llama-shaped model (d=1024, 16 query / 4 KV heads of 128, so n_gqa 4 and
unpadded wq/wk parts that fuse as the full-size ones do, n_ff 2048), on both
layouts (tests/_torch_iq3xxs.py builds the JAX reference):

  t    the default route: the coded IQ2_S wqk beside the Q4_K wv through K2
       at decode, the IQ3_S wo (K1 residual mode), the IQ3_XXS gate_up (K1
       normed) and down (K1 act mode), K3 at prefill, the Q5_K head on K1;
  il   under GHT_QP8=0: the same pair through K7 (a coded part beside a
       Q4_K nibble part with its stored bias), K6 on coded nibble planes in
       the normed, residual and act modes, K6's coded GEMM at prefill.

Covered, for bf16 and q8_0 KV: prefill of 3 tokens and 3 decode steps, a
16-token prefill (logits NMSE <= 5e-4, the mul_mat budget of the
reference's op tests), and the Engine's greedy tokens against the JAX
Engine's on a prompt whose top-2 logits are not a near-tie.  Each JAX
reference is built once for the module.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import llama as JL

import _torch_iq3xxs as R
from _torch_port import to_port
from ggml_hexagon_tpu_torch.models import fuse as PFU
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes


@pytest.fixture(scope="module")
def llama_t():
    return R.reference(moe=False, layout="t", seed=0, prompt_mult=17)


@pytest.fixture(scope="module")
def llama_il():
    return R.reference(moe=False, layout="il", seed=0, prompt_mult=17)


MODELS = ["llama_t", "llama_il"]


@pytest.mark.parametrize("model", MODELS)
def test_llama_layers_take_the_iq3xxs_layouts(request, model):
    """The port's own fuse_weights on the carried-across unfused weights
    gives the JAX package's fused planes and norm weights byte for byte:
    the coded IQ2_S wq/wk fused to wqk beside a Q4_K wv, which decode runs
    as one dual launch (K2 on t-planes, K7 on interleaved ones)."""
    ref = request.getfixturevalue(model)
    fl = ref["layout"]
    pcfg, unfused = to_port(ref["cfg"], ref["unfused"])
    mine = drop_wire_planes(PFU.fuse_weights(unfused, pcfg))
    theirs = ref["port_fused"]
    want = {"wqk": ("IQ2_S", fl), "wv": ("Q4_K", fl), "wo": ("IQ3_S", fl),
            "w_gateup_il": ("IQ3_XXS", fl), "ffn_down": ("IQ3_XXS", fl)}
    for il, (lm, lt) in enumerate(zip(mine["layers"], theirs["layers"])):
        assert sorted(lm) == sorted(lt), il
        assert R.types(lm) == want, il
        for key, v in lm.items():
            w = lt[key]
            if not isinstance(v, QTensor):
                torch.testing.assert_close(v, w, rtol=0, atol=0)
                continue
            assert v.q is None, (il, key)
            for f in ("fq", "fs", "fb"):
                g, t = getattr(v, f), getattr(w, f)
                assert (g is None) == (t is None), (il, key, f)
                if g is not None:
                    assert torch.equal(g, t), (il, key, f)
    lw = mine["layers"][0]
    supports = P.supports_qp8_dual if fl == "t" else PF.supports_dual
    assert supports(lw["wqk"], lw["wv"])
    assert mine["tok_embd"].cfg.qtype.name == "IQ3_S"
    assert mine["output"].cfg.qtype.name == "Q5_K"
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(ref["cfg"])


def test_iq3s_embedding_matches_jax(llama_t):
    """The IQ3_S embedding (an expanded signed wire: q * d per group)
    gathers and dequantizes the JAX package's rows exactly."""
    ids = [[0, 7, 299, 150]]
    want = JL.embed(llama_t["unfused"]["tok_embd"], jnp.asarray(ids),
                    jnp.float32)
    got = PL.embed(llama_t["port_fused"]["tok_embd"], torch.tensor(ids),
                   torch.float32)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kv", list(R.KV))
def test_forward_prefill3_and_decode_match_jax(request, model, kv):
    R.check_prefill3_and_decode(request.getfixturevalue(model), kv)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kv", list(R.KV))
def test_forward_prefill16_matches_jax(request, model, kv):
    R.check_prefill16(request.getfixturevalue(model), kv)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kv", list(R.KV))
def test_engine_greedy_tokens_match_jax_engine(request, model, kv):
    R.check_engine_tokens(request.getfixturevalue(model), kv)


@pytest.mark.parametrize("model", MODELS)
def test_decode_step_runs_the_dual_entry_on_the_coded_pair(request, model,
                                                           monkeypatch):
    """Every layer's decode QKV is one dual launch on the coded wqk (2560
    rows) beside the Q4_K wv, as the JAX forward does."""
    ref = request.getfixturevalue(model)
    calls = []
    real = PL.qmatmul_fast_dual
    monkeypatch.setattr(PL, "qmatmul_fast_dual",
                        lambda *a, **kw: calls.append(a[1].n) or real(*a, **kw))
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, R.MAX_SEQ, "bf16", device="cpu")
    PL.forward(cfg, w, torch.tensor([[3]]), cache, 0)
    assert calls == [2560, 2560]
