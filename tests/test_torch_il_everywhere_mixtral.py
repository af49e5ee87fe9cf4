"""The mixtral half of tests/_torch_il_everywhere.py's checks (the models, the
routes and what is covered are described there); each model has a file
of its own so that the two JAX references build on two workers."""
import pytest

import _torch_il_everywhere as R
from ggml_hexagon_tpu_torch.models import llama as PL


@pytest.fixture(scope="module")
def mixtral_ref():
    return R.reference(moe=True, seed=2, prompt_mult=23)


MODELS = ["mixtral_ref"]


def test_mixtral_layers_take_the_interleaved_layouts(mixtral_ref):
    lws = mixtral_ref["port_fused"]["layers"]
    for i, dn in enumerate(("Q6_K", "Q4_K")):
        assert R.types(lws[i]) == {
            "wq": ("Q4_K", "il"), "wk": ("Q8_0", "il"), "wv": ("Q8_0", "il"),
            "wo": ("Q5_K", "il"), "ffn_gate_exps": ("Q4_K", "il"),
            "ffn_up_exps": ("Q4_K", "il"), "ffn_down_exps": (dn, "il")}, i
        assert lws[i]["wo"].fb is not None
        assert PL._supports_moe_indirect(mixtral_ref["port_cfg"], lws[i])


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
