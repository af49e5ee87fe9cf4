"""The llama half of tests/_torch_il_everywhere.py's checks (the models, the
routes and what is covered are described there); each model has a file
of its own so that the two JAX references build on two workers."""
import dataclasses

import pytest
import torch

import _torch_il_everywhere as R
from _torch_port import to_port
from ggml_hexagon_tpu_torch.models import fuse as PFU
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes


@pytest.fixture(scope="module")
def llama_ref():
    return R.reference(moe=False, seed=0, prompt_mult=17)


MODELS = ["llama_ref"]


def test_llama_layers_take_the_interleaved_layouts(llama_ref):
    """The port's own fuse_weights on the carried-across unfused weights
    gives the JAX package's fused planes and norm weights byte for byte:
    wqk (Q4_K) beside a Q6_K wv in layer 0, which K7 takes, wqkv in layer
    1, all interleaved."""
    pcfg, unfused = to_port(llama_ref["cfg"], llama_ref["unfused"])
    mine = drop_wire_planes(PFU.fuse_weights(unfused, pcfg))
    theirs = llama_ref["port_fused"]
    il = ("Q4_K", "il")
    want = [{"wqk": il, "wv": ("Q6_K", "il"), "wo": il, "w_gateup_il": il,
             "ffn_down": ("Q6_K", "il")},
            {"wqkv": il, "wo": il, "w_gateup_il": il, "ffn_down": il}]
    for i, (lm, lt) in enumerate(zip(mine["layers"], theirs["layers"])):
        assert sorted(lm) == sorted(lt), i
        assert R.types(lm) == want[i], i
        for key, v in lm.items():
            w = lt[key]
            if not isinstance(v, QTensor):
                torch.testing.assert_close(v, w, rtol=0, atol=0)
                continue
            assert v.q is None, (i, key)
            for f in ("fq", "fs", "fb"):
                g, t = getattr(v, f), getattr(w, f)
                assert (g is None) == (t is None), (i, key, f)
                if g is not None:
                    assert torch.equal(g, t), (i, key, f)
    lw0 = mine["layers"][0]
    assert PF.supports_dual(lw0["wqk"], lw0["wv"])
    assert lw0["wv"].fb is None and lw0["wqk"].fb is not None
    assert mine["output"].cfg.qtype.name == "Q6_K"
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(llama_ref["cfg"])


def test_decode_step_runs_k7_on_the_mixed_pair(llama_ref, monkeypatch):
    """The decode step sends layer 0's interleaved wqk + wv pair to the
    dual entry (K7) and layer 1's wqkv to the normed one, as the JAX
    forward does."""
    calls = []
    real = PL.qmatmul_fast_dual
    monkeypatch.setattr(PL, "qmatmul_fast_dual",
                        lambda *a, **kw: calls.append(a[1].n) or real(*a, **kw))
    cfg, w = llama_ref["port_cfg"], llama_ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, R.MAX_SEQ, "bf16", device="cpu")
    PL.forward(cfg, w, torch.tensor([[3]]), cache, 0)
    assert calls == [1536]


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
