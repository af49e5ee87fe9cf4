"""The Gemma-2-shaped model of tests/_torch_gemma2.py (the model, the
routes and what is covered are described there) on the interleaved layout
everywhere (the JAX package under GHT_QP8=0), bf16 KV: K6's act mode in
gelu without the residual (nibble down in layer 0, byte down with the
derived bias in layer 1), K6's normed and plain modes, K7 on the Q4_K wqk +
Q6_K wv pair at a head width of 256."""
import pytest

import _torch_gemma2 as R
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF


@pytest.fixture(scope="module")
def ref():
    return R.reference("il")


def test_layers_take_the_interleaved_layouts(ref):
    il = ("Q4_K", "il")
    want = [{"wqkv": il, "wo": il, "w_gateup_il": il, "ffn_down": il},
            {"wqk": il, "wv": ("Q6_K", "il"), "wo": il, "w_gateup_il": il,
             "ffn_down": ("Q6_K", "il")}]
    layers = ref["port_fused"]["layers"]
    assert [R.types(lw) for lw in layers] == want
    assert PF.supports_dual(layers[1]["wqk"], layers[1]["wv"])
    assert ref["port_fused"]["output"].fl == "il"


def test_forward_prefill_and_decode_match_jax(ref):
    R.check_prefill_and_decode(ref, "bf16")


def test_forward_prefill16_matches_jax(ref):
    R.check_prefill16(ref, "bf16")


def test_engine_greedy_tokens_match_jax_engine(ref):
    R.check_engine_tokens(ref, "bf16")
