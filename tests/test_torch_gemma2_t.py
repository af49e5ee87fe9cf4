"""The Gemma-2-shaped model of tests/_torch_gemma2.py (the model, the
routes and what is covered are described there) on the default t-planes,
bf16 KV: K1's act mode in gelu without the residual, K2 on the Q4_K wqk +
Q6_K wv pair, K4 at D = 256 with the window and the cap; and Gemma (1),
which the same branches admit, at one prefill and decode step."""
import dataclasses

import pytest
import torch

import _torch_gemma2 as R
from _torch_port import nmse, to_port
from ggml_hexagon_tpu_torch.models import fuse as PFU
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.quant.pack import drop_wire_planes


@pytest.fixture(scope="module")
def ref():
    return R.reference("t")


def test_layers_take_the_t_layouts(ref):
    """The port's own fuse_weights on the carried-across unfused weights
    gives the JAX package's fused layers: wqkv in layer 0, wqk + a Q6_K wv
    in layer 1 (K2's pair), the post-norms carried, the head the Q6_K
    embedding's planes."""
    pcfg, unfused = to_port(ref["cfg"], ref["unfused"])
    mine = drop_wire_planes(PFU.fuse_weights(unfused, pcfg))
    t = ("Q4_K", "t")
    want = [{"wqkv": t, "wo": t, "w_gateup_il": t, "ffn_down": t},
            {"wqk": t, "wv": ("Q6_K", "t"), "wo": t, "w_gateup_il": t,
             "ffn_down": ("Q6_K", "t")}]
    for i, (lm, lt) in enumerate(zip(mine["layers"], ref["port_fused"]["layers"])):
        assert sorted(lm) == sorted(lt), i
        assert R.types(lm) == want[i], i
        assert "post_attn_norm" in lm and "post_ffn_norm" in lm
    lw1 = mine["layers"][1]
    assert PF.supports_dual(lw1["wqk"], lw1["wv"])
    assert unfused["output"] is unfused["tok_embd"]
    assert mine["output"].cfg.qtype.name == "Q6_K" and mine["output"].fl == "t"
    assert torch.equal(mine["output"].fq, mine["tok_embd"].fq)
    assert mine["tok_embd"].q is not None  # the gather's wire planes
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(ref["cfg"])


def test_forward_prefill_and_decode_match_jax(ref):
    R.check_prefill_and_decode(ref, "bf16")


def test_forward_prefill16_matches_jax(ref):
    R.check_prefill16(ref, "bf16")


def test_engine_greedy_tokens_match_jax_engine(ref):
    R.check_engine_tokens(ref, "bf16")


def test_window_and_caps_bend_the_logits(ref):
    R.check_window_and_caps_bend(ref)


def test_decode_takes_gelu_without_residual_and_k4_options(ref, monkeypatch):
    """A decode step sends each layer's down through the act entry in gelu
    with no residual (the post-FFN norm comes after it), wo through the
    plain entry, and K4 layer 0's window and both layers' cap."""
    acts, attn = [], []
    real_act, real_attn = PL.qmatmul_fast_act, PL.fused_decode_attention
    monkeypatch.setattr(PL, "qmatmul_fast_act", lambda *a, **kw: acts.append(
        (a[2], kw.get("res"))) or real_act(*a, **kw))
    monkeypatch.setattr(PL, "fused_decode_attention", lambda *a, **kw: attn.append(
        (kw["D"], kw["swa"], kw["logit_cap"])) or real_attn(*a, **kw))
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, R.MAX_SEQ, "bf16", device="cpu")
    PL.forward(cfg, w, torch.tensor([[3]]), cache, 9)
    assert acts == [("gelu", None)] * 2
    assert attn == [(256, R.WINDOW, R.ATTN_CAP), (256, 0, R.ATTN_CAP)]


def test_gemma_1_matches_jax():
    """Gemma (no post-norms, window or caps; the embedding scale, gelu and
    the tied head) at an 11-token prefill and one decode step."""
    g = R.reference("t", arch="gemma", full=False)
    cfg, w = g["port_cfg"], g["port_fused"]
    PL.check_supported(cfg)
    cache = PL.init_kv_cache(cfg, 1, R.MAX_SEQ, "bf16", device="cpu")
    lp, cache = PL.forward(cfg, w, torch.tensor([R.PROMPT11]), cache, 0,
                           logits_all=True)
    assert nmse(lp.numpy(), g["bf16"]["prefill11"]) <= R.NMSE_MAX
    ld, _ = PL.forward(cfg, w, torch.tensor([[R.STEPS[0]]]), cache,
                       len(R.PROMPT11))
    assert nmse(ld.numpy(), g["bf16"]["steps"][0]) <= R.NMSE_MAX
