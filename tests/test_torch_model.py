"""The port's Llama forward and Engine against the JAX package on a 2-layer
Q4_K_M-shaped model (layer 1 raises wv and ffn_down to Q6_K, as the policy
does for the 8B's mixed layers; Q4_K embedding, Q6_K head; 8 query heads,
4 KV heads of 128, n_ff 512), fused and carried across.

The JAX side runs in the mode that matches the port's kernel contract:
GHT_FAST_INTERPRET=1 and the llama interpret flags route it through the
Pallas kernels in interpret mode (its plain-CPU mode takes exact XLA
dequant instead, which rounds differently: two valid kernel paths differ
by up to 0.135 on logits of ~3 from int8 rounding flips).

Covered: prefill T=3 (decode kernels K1), T=16 (prefill kernel K3) and 3
decode steps (K1 + K2 + K4), bf16 and q8_0 KV; then Engine.prefill /
decode_one against the JAX Engine.  Tolerance: logits NMSE <= 5e-4, the
mul_mat budget of the reference's op tests.  Measured on CPU, on logits of
magnitude up to 5.4: T=3 and the decode steps max|diff| 2.1e-6 (bf16 KV)
and 2.4e-6 (q8_0 KV); T=16 max|diff| 0.031 and 0.069, NMSE 1.7e-5 and
2.8e-5.  Each prefill op alone agrees within 5e-6; the two sides sum the
bf16 GEMM in another f32 order, and where that moves a value across a
bf16 rounding step (the activations are cast to bf16 between ops) the
flip carries through the later layers."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import fuse as JF
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import drop_wire_planes as j_drop_wire
from ggml_hexagon_tpu.quant.pack import quantize_tensor
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine

from _torch_port import nmse, to_port
from ggml_hexagon_tpu_torch.models import fuse as PF
from ggml_hexagon_tpu_torch.models.llama import forward, init_kv_cache
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes
from ggml_hexagon_tpu_torch.runtime.engine import Engine

NMSE_MAX = 5e-4
KV = {"bf16": jnp.bfloat16, "q8_0": "q8_0"}
PROMPT3 = [5, 30, 61]
STEPS = [7, 11, 13]
MAX_SEQ = 32


def _build_jax(seed=0, nh=8, nkv=4, hd=128, n_layer=2, n_vocab=300,
               n_ff=512):
    rng = np.random.default_rng(seed)
    cfg = JL.LlamaConfig(n_vocab=n_vocab, n_embd=nh * hd, n_layer=n_layer,
                         n_head=nh, n_head_kv=nkv, n_ff=n_ff,
                         rope_theta=500000.0, head_dim=hd)
    d = cfg.n_embd

    def q(n, k, t=GGMLType.Q4_K, fast=True):
        w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
        return quantize_tensor(w, t).astype_device(fast=fast)

    def norm_w():
        return jnp.asarray(rng.random(d) + 0.5, jnp.float32)

    layers = []
    for il in range(n_layer):
        hi = GGMLType.Q6_K if il else GGMLType.Q4_K
        layers.append({
            "attn_norm": norm_w(), "wq": q(nh * hd, d), "wk": q(nkv * hd, d),
            "wv": q(nkv * hd, d, hi), "wo": q(d, nh * hd),
            "ffn_norm": norm_w(), "ffn_gate": q(n_ff, d),
            "ffn_up": q(n_ff, d), "ffn_down": q(d, n_ff, hi)})
    weights = {"tok_embd": q(n_vocab, d, fast=False),
               "output_norm": norm_w(),
               "output": q(n_vocab, d, GGMLType.Q6_K),
               "layers": layers}
    # the production load pipeline: "norm" rope permuted to NEOX, fused
    weights, cfg = JF.permute_rope_neox(weights, cfg)
    fused = j_drop_wire(JF.fuse_weights(weights, cfg))
    return cfg, weights, fused


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its logits in the matching mode, and the port's
    carried-across weights; built once for the module."""
    cfg, unfused, fused = _build_jax()
    out = {"cfg": cfg, "unfused": unfused, "fused": fused}
    rng = np.random.default_rng(1)
    out["prompt16"] = rng.integers(0, cfg.n_vocab, (1, 16)).astype(np.int32)
    out["prompt7"] = (np.arange(7, dtype=np.int32) * 13 + 3)[None]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_FAST_INTERPRET", "1")
        mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
        mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
        for name, kvd in KV.items():
            kv = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
            lp, kv = JL.forward(cfg, fused, jnp.asarray([PROMPT3], jnp.int32),
                                kv, jnp.int32(0), logits_all=True)
            steps = []
            for i, tok in enumerate(STEPS):
                ld, kv = JL.forward(cfg, fused, jnp.asarray([[tok]], jnp.int32),
                                    kv, jnp.int32(3 + i))
                steps.append(np.asarray(ld))
            kv16 = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
            l16, _ = JL.forward(cfg, fused, jnp.asarray(out["prompt16"]), kv16,
                                jnp.int32(0), logits_all=True)
            out[name] = {"prefill3": np.asarray(lp), "steps": steps,
                         "prefill16": np.asarray(l16)}
            eng = JEngine(cfg, fused, max_seq=MAX_SEQ, kv_dtype=kvd)
            lg = [eng.prefill(out["prompt7"])]
            toks = []
            for _ in range(3):
                toks.append(int(np.argmax(lg[-1][0])))
                lg.append(eng.decode_one(np.array([toks[-1]])))
            out[name]["engine"] = (lg, toks)
    pcfg, pfused = to_port(cfg, fused)
    out["port_cfg"], out["port_fused"] = pcfg, pfused
    return out


def _planes_equal(got: QTensor, want: QTensor, where: str):
    assert (got.n, got.k, got.cfg, got.fl) == (want.n, want.k, want.cfg,
                                              want.fl), where
    for f in ("fq", "fs", "fb"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), (where, f)
        if g is not None:
            assert torch.equal(g.view(torch.uint8) if g.dtype != torch.uint8
                               else g, w.view(torch.uint8) if w.dtype != torch.uint8
                               else w), (where, f)


def test_port_fuse_matches_jax_fuse(ref):
    """The port's own fuse_weights on the carried-across unfused weights
    gives the JAX package's fused planes, byte for byte."""
    pcfg, unfused = to_port(ref["cfg"], ref["unfused"])
    mine = drop_wire_planes(PF.fuse_weights(unfused, pcfg))
    theirs = ref["port_fused"]
    for il, (lm, lt) in enumerate(zip(mine["layers"], theirs["layers"])):
        assert sorted(lm) == sorted(lt), il
        for key in lm:
            if isinstance(lt[key], QTensor):
                _planes_equal(lm[key], lt[key], f"layer {il} {key}")
            else:
                torch.testing.assert_close(lm[key], lt[key], rtol=0, atol=0)
    assert "wqkv" in mine["layers"][0] and "wqk" in mine["layers"][1]
    assert "w_gateup_il" in mine["layers"][0]


def test_config_carries_across(ref):
    assert dataclasses.asdict(ref["port_cfg"]) == dataclasses.asdict(ref["cfg"])


def _check(got, want, what):
    err = nmse(got, want)
    assert err <= NMSE_MAX, (what, err, float(np.abs(got - want).max()))


@pytest.mark.parametrize("kv", list(KV))
def test_forward_prefill3_and_decode_match_jax(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    lp, cache = forward(cfg, w, torch.tensor([PROMPT3]), cache, 0,
                        logits_all=True)
    _check(lp.numpy(), ref[kv]["prefill3"], "prefill T=3")
    for i, tok in enumerate(STEPS):
        ld, cache = forward(cfg, w, torch.tensor([[tok]]), cache, 3 + i)
        _check(ld.numpy(), ref[kv]["steps"][i], f"decode step {i}")


@pytest.mark.parametrize("kv", list(KV))
def test_forward_prefill16_matches_jax(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    l16, _ = forward(cfg, w, torch.from_numpy(ref["prompt16"]).long(), cache,
                     0, logits_all=True)
    _check(l16.numpy(), ref[kv]["prefill16"], "prefill T=16")


@pytest.mark.parametrize("kv", list(KV))
def test_engine_matches_jax_engine(ref, kv):
    want, toks = ref[kv]["engine"]
    eng = Engine(ref["port_cfg"], ref["port_fused"], max_seq=MAX_SEQ,
                 kv_dtype=kv, device="cpu")
    got = [eng.prefill(ref["prompt7"])]
    for tok in toks:  # the JAX engine's greedy tokens drive both
        got.append(eng.decode_one(np.array([tok])))
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g, w, f"engine step {i}")
    assert eng.n_past == 7 + len(toks)
    assert [int(np.argmax(g[0])) for g in got[:-1]] == toks
