"""The 2-layer models shared by tests/test_torch_iq4xs_llama.py and
tests/test_torch_iq4xs_mixtral.py: the JAX reference built once per model,
and the checks both files run.

The port's IQ4_XS serving paths against the JAX package, on two 2-layer
models whose per-tensor types come from the JAX `QuantPolicy("IQ4_XS", 8,
...)`: a policy built for 8 layers puts layer 0's ffn_down on Q5_K
t-planes (the first eighth of the layers) and layer 1's on IQ4_XS
interleaved planes, as the full-depth models mix them.

  llama     d=1024, 8 query / 2 KV heads of 128 (n_gqa 4), n_ff 512: IQ4_XS
            wq/wk (fused to wqk, interleaved), Q5_K wv (t), IQ4_XS wo and
            gate/up (fused to a row-permuted w_gateup_il where ffn_down is
            interleaved), IQ4_XS embedding, Q6_K head.  Decode runs K6's
            normed (wqk, gate_up), residual (wo) and act (layer 1's down)
            modes beside K1 (wv, layer 0's down, the head); prefill runs
            K6's normed mode and K6 on the pre-interleaved act product.
  mixtral   d=512, 4 query / 2 KV heads of 128, E=8 experts of n_ff 512,
            top-2, under Mixtral's policy (n_expert 8): IQ4_XS wq, Q8_0
            wk/wv (all interleaved, unfused), Q5_K wo, IQ4_XS gate/up
            stacks, down stacks Q5_K (layer 0, K5) and IQ4_XS (layer 1,
            K8), IQ4_XS embedding, Q6_K head, f32 router.

Weights are drawn with numpy and quantized by the JAX package, fused there,
and carried across with `convert`.  The JAX side runs in the mode that
matches the port's kernel contract (GHT_FAST_INTERPRET=1 and the llama
interpret flags: the Pallas kernels in interpret mode).  Covered, for bf16
and q8_0 KV: prefill of 3 tokens and 3 decode steps, a 16-token prefill,
and the Engine's greedy tokens against the JAX Engine's.  The MoE model's
top-k ids of every layer must match first; every logits NMSE <= 5e-4, the
mul_mat budget of the reference's op tests.  Each JAX reference is built
once for the module.  The greedy prompts (multipliers 17 and 23) are ones
whose top-2 logits are not a near-tie: with prompt multiplier 13 and q8_0
KV the Llama-shaped model's first token has a top-2 gap of 7e-3, and the
port (NMSE 1.5e-4 against the eager JAX forward) picks the other one, as
far from the JAX Engine's jitted forward as that eager forward is
(1.5e-4).
"""
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
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes
from ggml_hexagon_tpu_torch.runtime.engine import Engine

NMSE_MAX = 5e-4
KV = {"bf16": jnp.bfloat16, "q8_0": "q8_0"}
PROMPT3 = [5, 30, 61]
STEPS = [7, 11, 13]
MAX_SEQ = 32


def _build_jax(moe: bool, seed: int):
    """(cfg, unfused, fused) JAX weights with IQ4_XS policy types."""
    rng = np.random.default_rng(seed)
    if moe:
        d, nh, nkv, E, n_ff = 512, 4, 2, 8, 512
        cfg = JL.LlamaConfig(n_vocab=300, n_embd=d, n_layer=2, n_head=nh,
                             n_head_kv=nkv, n_ff=n_ff, n_expert=E,
                             n_expert_used=2, rope_theta=1e6, head_dim=128)
    else:
        d, nh, nkv, E, n_ff = 1024, 8, 2, 0, 512
        cfg = JL.LlamaConfig(n_vocab=300, n_embd=d, n_layer=2, n_head=nh,
                             n_head_kv=nkv, n_ff=n_ff, rope_theta=500000.0,
                             head_dim=128)
    policy = QuantPolicy("IQ4_XS", 8, n_gqa=nh // nkv, n_expert=max(E, 1))

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


def reference(moe: bool, seed: int, prompt_mult: int):
    """The JAX model's logits (and routing) in the matching mode, and the
    port's carried-across weights."""
    cfg, unfused, fused = _build_jax(moe, seed)
    out = {"cfg": cfg, "unfused": unfused, "moe": moe}
    rng = np.random.default_rng(1)
    out["prompt16"] = rng.integers(0, cfg.n_vocab, (1, 16)).astype(np.int32)
    out["prompt7"] = (np.arange(7, dtype=np.int32) * prompt_mult + 3)[None]
    routes = []
    with pytest.MonkeyPatch.context() as mp:
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


def types(lw):
    return {k: (v.cfg.qtype.name, v.fl) for k, v in lw.items()
            if isinstance(v, QTensor)}


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


def check_prefill3_and_decode(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    lp, ids, cache = _run(cfg, w, torch.tensor([PROMPT3]), cache, 0,
                          logits_all=True)
    _check((lp, ids), ref[kv]["prefill3"], "prefill T=3")
    for i, tok in enumerate(STEPS):
        ld, ids, cache = _run(cfg, w, torch.tensor([[tok]]), cache, 3 + i)
        _check((ld, ids), ref[kv]["steps"][i], f"decode step {i}")


def check_prefill16(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    l16, ids, _ = _run(cfg, w, torch.from_numpy(ref["prompt16"]).long(),
                       cache, 0, logits_all=True)
    _check((l16, ids), ref[kv]["prefill16"], "prefill T=16")


def check_engine_tokens(ref, kv):
    toks = ref[kv]["engine_tokens"]
    eng = Engine(ref["port_cfg"], ref["port_fused"], max_seq=MAX_SEQ,
                 kv_dtype=kv, device="cpu")
    mine = list(eng.generate(ref["prompt7"][0], n_predict=len(toks)))
    assert mine == toks
