"""The port's interleaved-everywhere route (the JAX package under GHT_QP8=0)
against the JAX package, on two 2-layer Q4_K_M models whose per-tensor
types come from the JAX `QuantPolicy("Q4_K_M", 8, ...)`: a policy built for
8 layers puts layer 0's attn_v and ffn_down on Q6_K (the _use_more_bits
layers) and layer 1's on Q4_K, as the full-depth models mix them.

  llama     d=1024, 8 query / 4 KV heads of 128, n_ff 2048: layer 0 fuses
            Q4_K wq/wk to wqk (1536 rows) beside a Q6_K wv, which decode runs
            through K7 (nibble part a, byte part b with the derived bias);
            layer 1 fuses wqkv; Q4_K wo and gate/up (w_gateup_il, rows
            permuted into ffn_down's interleaved order); ffn_down Q6_K
            (layer 0, K6 byte act mode, group sums in the kernel: G = 128)
            and Q4_K (layer 1, K6 nibble act mode, group sums from the
            caller: G = 64); Q4_K embedding, Q6_K head (K6 byte, derived
            bias).
  mixtral   d=512, 4 query / 2 KV heads of 128, E=8 experts of n_ff 512,
            top-2, under Mixtral's policy (n_expert 8): Q4_K wq (K6 nibble),
            Q8_0 wk/wv (K6 byte), Q5_K wo (K6 byte residual mode, stored fb
            plane), Q4_K gate/up stacks (K8 nibble), down stacks Q6_K (layer
            0, K8 byte with the derived bias) and Q4_K (layer 1, K8 nibble),
            Q4_K embedding, Q6_K head, f32 router.

Weights are drawn with numpy and quantized by the JAX package, given their
planes and fused there under GHT_QP8=0, and carried across with `convert`.
The JAX side runs in the mode that matches the port's kernel contract
(GHT_FAST_INTERPRET=1 and the llama interpret flags: the Pallas kernels in
interpret mode).  Covered, for bf16 and q8_0 KV: prefill of 3 tokens and 3
decode steps, a 16-token prefill, and the Engine's greedy tokens against
the JAX Engine's.  The MoE model's top-k ids of every layer must match
first; every logits NMSE <= 5e-4, the mul_mat budget of the reference's op
tests.  Each JAX reference is built once for the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import fuse as JF
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.quant.pack import drop_wire_planes as j_drop_wire
from ggml_hexagon_tpu.quant.pack import quantize_tensor
from ggml_hexagon_tpu.quant.policy import QuantPolicy
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine

from _torch_port import nmse, to_port
from ggml_hexagon_tpu_torch.models import fuse as PFU
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes
from ggml_hexagon_tpu_torch.runtime.engine import Engine

NMSE_MAX = 5e-4
KV = {"bf16": jnp.bfloat16, "q8_0": "q8_0"}
PROMPT3 = [5, 30, 61]
STEPS = [7, 11, 13]
MAX_SEQ = 32


def _build_jax(moe: bool, seed: int):
    """(cfg, unfused, fused) JAX weights with Q4_K_M policy types on the
    interleaved layout (call under GHT_QP8=0)."""
    rng = np.random.default_rng(seed)
    if moe:
        d, nh, nkv, E, n_ff = 512, 4, 2, 8, 512
        cfg = JL.LlamaConfig(n_vocab=300, n_embd=d, n_layer=2, n_head=nh,
                             n_head_kv=nkv, n_ff=n_ff, n_expert=E,
                             n_expert_used=2, rope_theta=1e6, head_dim=128)
    else:
        d, nh, nkv, E, n_ff = 1024, 8, 4, 0, 2048
        cfg = JL.LlamaConfig(n_vocab=300, n_embd=d, n_layer=2, n_head=nh,
                             n_head_kv=nkv, n_ff=n_ff, rope_theta=500000.0,
                             head_dim=128)
    policy = QuantPolicy("Q4_K_M", 8, n_gqa=nh // nkv, n_expert=max(E, 1))

    def q(name, n, k, fast=True):
        w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
        qt = quantize_tensor(w, policy.tensor_type(name, (n, k)))
        return qt.astype_device(fast=True) if fast else qt

    def norm_w():
        return jnp.asarray(rng.random(d) + 0.5, jnp.float32)

    nq, nk = nh * 128, nkv * 128
    layers = []
    for il in range(2):
        p = f"blk.{il}."
        lw = {"attn_norm": norm_w(),
              "wq": q(p + "attn_q.weight", nq, d),
              "wk": q(p + "attn_k.weight", nk, d),
              "wv": q(p + "attn_v.weight", nk, d),
              "wo": q(p + "attn_output.weight", d, nq),
              "ffn_norm": norm_w()}
        if moe:
            lw["ffn_gate_inp"] = jnp.asarray(
                rng.normal(size=(E, d)).astype(np.float32) * 0.05)
            lw["ffn_gate_exps"] = q(p + "ffn_gate_exps.weight", E * n_ff, d)
            lw["ffn_up_exps"] = q(p + "ffn_up_exps.weight", E * n_ff, d)
            lw["ffn_down_exps"] = q(p + "ffn_down_exps.weight", E * d, n_ff)
        else:
            lw["ffn_gate"] = q(p + "ffn_gate.weight", n_ff, d)
            lw["ffn_up"] = q(p + "ffn_up.weight", n_ff, d)
            lw["ffn_down"] = q(p + "ffn_down.weight", d, n_ff)
        layers.append(lw)
    weights = {"tok_embd": q("token_embd.weight", cfg.n_vocab, d, fast=False),
               "output_norm": norm_w(),
               "output": q("output.weight", cfg.n_vocab, d),
               "layers": layers}
    weights, cfg = JF.permute_rope_neox(weights, cfg)
    return cfg, weights, j_drop_wire(JF.fuse_weights(weights, cfg))


def _jax_routing(mp, log):
    """Record the top-k ids of every JAX `_moe_ffn` call."""
    orig = JL._moe_ffn

    def wrapped(cfg, lw, f, compute_dtype, *a, **kw):
        router = JL.matmul(f, lw["ffn_gate_inp"]).astype(jnp.float32)
        _, topi = jax.lax.top_k(jax.nn.softmax(router, axis=-1),
                                cfg.n_expert_used)
        log.append(np.asarray(topi))
        return orig(cfg, lw, f, compute_dtype, *a, **kw)

    mp.setattr(JL, "_moe_ffn", wrapped)


def _reference(moe: bool, seed: int, prompt_mult: int):
    """The JAX model's logits (and routing) in the matching mode under
    GHT_QP8=0, and the port's carried-across weights."""
    out = {"moe": moe}
    routes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_QP8", "0")
        cfg, unfused, fused = _build_jax(moe, seed)
        out.update(cfg=cfg, unfused=unfused)
        rng = np.random.default_rng(1)
        out["prompt16"] = rng.integers(0, cfg.n_vocab, (1, 16)).astype(np.int32)
        out["prompt7"] = (np.arange(7, dtype=np.int32) * prompt_mult + 3)[None]
        mp.setenv("GHT_FAST_INTERPRET", "1")
        mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
        mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
        for name, kvd in KV.items():
            eng = JEngine(cfg, fused, max_seq=MAX_SEQ, kv_dtype=kvd)
            lg = [eng.prefill(out["prompt7"])]
            toks = []
            for _ in range(3):
                toks.append(int(np.argmax(lg[-1][0])))
                lg.append(eng.decode_one(np.array([toks[-1]])))
            out[name] = {"engine_tokens": toks}
        if moe:
            _jax_routing(mp, routes)
        for name, kvd in KV.items():
            r = out[name]
            kv = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
            del routes[:]
            lp, kv = JL.forward(cfg, fused, jnp.asarray([PROMPT3], jnp.int32),
                                kv, jnp.int32(0), logits_all=True)
            r["prefill3"] = (np.asarray(lp), list(routes))
            r["steps"] = []
            for i, tok in enumerate(STEPS):
                del routes[:]
                ld, kv = JL.forward(cfg, fused, jnp.asarray([[tok]], jnp.int32),
                                    kv, jnp.int32(3 + i))
                r["steps"].append((np.asarray(ld), list(routes)))
            del routes[:]
            kv16 = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
            l16, _ = JL.forward(cfg, fused, jnp.asarray(out["prompt16"]),
                                kv16, jnp.int32(0), logits_all=True)
            r["prefill16"] = (np.asarray(l16), list(routes))
    pcfg, pfused = to_port(cfg, fused)
    out["port_cfg"], out["port_fused"] = pcfg, drop_wire_planes(pfused)
    return out


@pytest.fixture(scope="module")
def llama_ref():
    return _reference(moe=False, seed=0, prompt_mult=17)


@pytest.fixture(scope="module")
def mixtral_ref():
    return _reference(moe=True, seed=2, prompt_mult=23)


MODELS = ["llama_ref", "mixtral_ref"]


def _types(lw):
    return {k: (v.cfg.qtype.name, v.fl) for k, v in lw.items()
            if isinstance(v, QTensor)}


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
        assert _types(lm) == want[i], i
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


def test_mixtral_layers_take_the_interleaved_layouts(mixtral_ref):
    lws = mixtral_ref["port_fused"]["layers"]
    for i, dn in enumerate(("Q6_K", "Q4_K")):
        assert _types(lws[i]) == {
            "wq": ("Q4_K", "il"), "wk": ("Q8_0", "il"), "wv": ("Q8_0", "il"),
            "wo": ("Q5_K", "il"), "ffn_gate_exps": ("Q4_K", "il"),
            "ffn_up_exps": ("Q4_K", "il"), "ffn_down_exps": (dn, "il")}, i
        assert lws[i]["wo"].fb is not None
        assert PL._supports_moe_indirect(mixtral_ref["port_cfg"], lws[i])


def _run(cfg, w, tokens, cache, pos, **kw):
    routes = []
    PL.MOE_ROUTING = routes
    try:
        logits, cache = PL.forward(cfg, w, tokens, cache, pos, **kw)
    finally:
        PL.MOE_ROUTING = None
    return logits.numpy(), [t.numpy() for _, t in routes], cache


def _check(got, want, what):
    (g, g_ids), (w, w_ids) = got, want
    assert len(g_ids) == len(w_ids), what
    for il, (a, b) in enumerate(zip(g_ids, w_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: layer {il} ids")
    err = nmse(g, w)
    assert err <= NMSE_MAX, (what, err, float(np.abs(g - w).max()))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kv", list(KV))
def test_forward_prefill3_and_decode_match_jax(request, model, kv):
    ref = request.getfixturevalue(model)
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    lp, ids, cache = _run(cfg, w, torch.tensor([PROMPT3]), cache, 0,
                          logits_all=True)
    _check((lp, ids), ref[kv]["prefill3"], "prefill T=3")
    for i, tok in enumerate(STEPS):
        ld, ids, cache = _run(cfg, w, torch.tensor([[tok]]), cache, 3 + i)
        _check((ld, ids), ref[kv]["steps"][i], f"decode step {i}")


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kv", list(KV))
def test_forward_prefill16_matches_jax(request, model, kv):
    ref = request.getfixturevalue(model)
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    l16, ids, _ = _run(cfg, w, torch.from_numpy(ref["prompt16"]).long(),
                       cache, 0, logits_all=True)
    _check((l16, ids), ref[kv]["prefill16"], "prefill T=16")


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kv", list(KV))
def test_engine_greedy_tokens_match_jax_engine(request, model, kv):
    ref = request.getfixturevalue(model)
    toks = ref[kv]["engine_tokens"]
    eng = Engine(ref["port_cfg"], ref["port_fused"], max_seq=MAX_SEQ,
                 kv_dtype=kv, device="cpu")
    mine = list(eng.generate(ref["prompt7"][0], n_predict=len(toks)))
    assert mine == toks


def test_decode_step_runs_k7_on_the_mixed_pair(llama_ref, monkeypatch):
    """The decode step sends layer 0's interleaved wqk + wv pair to the
    dual entry (K7) and layer 1's wqkv to the normed one, as the JAX
    forward does."""
    calls = []
    real = PL.qmatmul_fast_dual
    monkeypatch.setattr(PL, "qmatmul_fast_dual",
                        lambda *a, **kw: calls.append(a[1].n) or real(*a, **kw))
    cfg, w = llama_ref["port_cfg"], llama_ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, "bf16", device="cpu")
    PL.forward(cfg, w, torch.tensor([[3]]), cache, 0)
    assert calls == [1536]
