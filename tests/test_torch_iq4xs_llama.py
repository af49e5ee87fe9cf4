"""The llama half of tests/_torch_iq4xs.py's checks (the models, the
routes and what is covered are described there); each model has a file
of its own so that the two JAX references build on two workers."""
import dataclasses

import pytest
import torch

import _torch_iq4xs as R
from _torch_port import to_port
from ggml_hexagon_tpu_torch.models import fuse as PFU
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes


@pytest.fixture(scope="module")
def llama_ref():
    return R.reference(moe=False, seed=0, prompt_mult=17)


MODELS = ["llama_ref"]


def test_llama_layers_take_the_iq4xs_layouts(llama_ref):
    """The port's own fuse_weights on the carried-across unfused weights
    gives the JAX package's fused planes and norm weights byte for byte:
    wqk (IQ4_XS, interleaved) beside a Q5_K wv on t-planes, and w_gateup_il
    rows permuted into the interleaved ffn_down's column order."""
    pcfg, unfused = to_port(llama_ref["cfg"], llama_ref["unfused"])
    mine = drop_wire_planes(PFU.fuse_weights(unfused, pcfg))
    theirs = llama_ref["port_fused"]
    want = [{"wqk": ("IQ4_XS", "il"), "wv": ("Q5_K", "t"),
             "wo": ("IQ4_XS", "il"), "w_gateup_il": ("IQ4_XS", "il"),
             "ffn_down": (dn, fl)} for dn, fl in (("Q5_K", "t"),
                                                  ("IQ4_XS", "il"))]
    for il, (lm, lt) in enumerate(zip(mine["layers"], theirs["layers"])):
        assert sorted(lm) == sorted(lt), il
        assert R.types(lm) == want[il], il
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
    lw1 = mine["layers"][1]
    assert not torch.equal(lw1["attn_norm_il"], lw1["attn_norm_il_v"])
    assert mine["tok_embd"].cfg.qtype.name == "IQ4_XS"
    assert mine["output"].cfg.qtype.name == "Q6_K"
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(llama_ref["cfg"])


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
