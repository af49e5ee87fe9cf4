"""The port's IQ3_XXS serving paths against the JAX package on a 2-layer
Mixtral-shaped model (d=512, 4 query / 2 KV heads of 128, E=8 experts of
n_ff 512, top-2, under Mixtral's policy: n_expert 8), on both layouts
(tests/_torch_iq3xxs.py builds the JAX reference):

  t    the default route: the coded IQ2_S wq on K1, Q8_0 wk/wv on K6 byte
       planes, the Q5_K wo (K1 residual mode), IQ3_XXS gate/up/down stacks
       gathered through K5 at decode and every expert through K3 at
       prefill, the Q5_K head;
  il   under GHT_QP8=0: wq on K6's coded family, wk/wv K6 byte, wo K6 byte
       with its stored bias (residual mode), the stacks through K8 on coded
       nibble planes at decode and every expert through K6's coded GEMM at
       prefill.

Covered, for bf16 and q8_0 KV: prefill of 3 tokens and 3 decode steps and a
16-token prefill, every layer's top-k ids equal to the JAX routing first,
then logits NMSE <= 5e-4; the Engine's greedy tokens against the JAX
Engine's.  Each JAX reference is built once for the module.
"""
import pytest

import _torch_iq3xxs as R
from ggml_hexagon_tpu_torch.models import llama as PL


@pytest.fixture(scope="module")
def mixtral_t():
    return R.reference(moe=True, layout="t", seed=2, prompt_mult=23)


@pytest.fixture(scope="module")
def mixtral_il():
    return R.reference(moe=True, layout="il", seed=3, prompt_mult=23)


MODELS = ["mixtral_t", "mixtral_il"]


@pytest.mark.parametrize("model", MODELS)
def test_mixtral_layers_take_the_iq3xxs_layouts(request, model):
    ref = request.getfixturevalue(model)
    fl = ref["layout"]
    for il, lw in enumerate(ref["port_fused"]["layers"]):
        assert R.types(lw) == {
            "wq": ("IQ2_S", fl), "wk": ("Q8_0", "il"), "wv": ("Q8_0", "il"),
            "wo": ("Q5_K", fl), "ffn_gate_exps": ("IQ3_XXS", fl),
            "ffn_up_exps": ("IQ3_XXS", fl),
            "ffn_down_exps": ("IQ3_XXS", fl)}, il
        assert PL._supports_moe_indirect(ref["port_cfg"], lw)
    assert ref["port_fused"]["tok_embd"].cfg.qtype.name == "IQ3_S"
    assert ref["port_fused"]["output"].cfg.qtype.name == "Q5_K"


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
