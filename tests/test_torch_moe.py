"""The port's MoE path against the JAX package.

  K5        `qp8_indirect_plain` (through `qp8_matmul_indirect`) against the
            Pallas `_qp8_indirect_kernel` in interpret mode, Q5_K and Q6_K
            stacked experts, P in {2, 5} and duplicate ids; rtol = atol =
            5e-4, the JAX package's kernel-vs-oracle tolerance.
  slices    `qtensor_rows` of t-planes (lanes) and interleaved planes (rows)
            equal the JAX slices.
  synth     the random weights are zero-mean with a checkpoint's RMS; the
            random Q5_K_M MoE model builds its mixture and serves on the
            CPU without a kernel launch.
  convert   interleaved leaves and the dense f32 router cross unchanged.
  model     a 2-layer Mixtral-shaped model: d=512 (Q5_K has t-planes only
            from K=512: both of its shift-slice periods must hold a 2-group
            chunk), 4 query / 2 KV heads of 128, E=4 experts of n_ff 512,
            top-2; Q5_K wq/wo and gate/up stacks, Q8_0 wk/wv (interleaved),
            down stacks Q5_K (layer 0) and Q6_K (layer 1), Q5_K embedding,
            Q6_K head, f32 router.  Prefill T=3 (gathered experts, P=6), 3
            decode steps (P=2, K4) and a 16-token prefill (every expert
            through K3), bf16 and q8_0 KV, against JAX `forward` in the mode
            that matches the port's kernel contract (GHT_FAST_INTERPRET=1
            and the llama interpret flags).  The top-k expert ids of every
            layer must match first; then logits NMSE <= 5e-4, the mul_mat
            budget of the reference's op tests.
  engine    the Engine's greedy tokens against the JAX Engine's, and its
            logits against JAX `forward` on the same chunks (the 8-bucket
            prefill, then one token a step), NMSE <= 5e-4.  The logits are
            not held against the JAX Engine itself: its jitted forward and
            the eager one differ on this model by up to NMSE 0.12 with q8_0
            KV (and 5.9e-4 with bf16) for some prompts, where XLA's fusions
            move values across bf16 and int8 rounding steps and the routing
            amplifies the change.  The seeds (model 2, prompt multiplier 23)
            are ones where the routing of the two sides agrees.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import fuse as JF
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.ops import qmm_qp8 as JQ
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import drop_wire_planes as j_drop_wire
from ggml_hexagon_tpu.quant.pack import quantize_tensor
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine

from _torch_port import jax_qt_leaf, jax_tree_to_numpy, nmse, port_qt, to_port
from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.convert import convert_weights
from ggml_hexagon_tpu_torch.models import fuse as PF
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.models.synth import build_moe_model, random_qtensor
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as PQ
from ggml_hexagon_tpu_torch.ops.qmatmul import dequantize
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes
from ggml_hexagon_tpu_torch.runtime.engine import Engine

TOL = dict(rtol=5e-4, atol=5e-4)
NMSE_MAX = 5e-4
KV = {"bf16": jnp.bfloat16, "q8_0": "q8_0"}
PROMPT3 = [5, 30, 61]
STEPS = [7, 11, 13]
MAX_SEQ = 32
_STACKS = {}


def _stack(qtype, E=4, npe=256, K=512):
    """Stacked expert weights [E*npe, K] (JAX t-layout, wire kept) and the
    port twin, cached."""
    key = (qtype, E, npe, K)
    if key not in _STACKS:
        rng = np.random.default_rng(int(qtype) + E + npe)
        w = rng.normal(size=(E * npe, K)).astype(np.float32)
        jq = quantize_tensor(w, qtype).astype_device(fast=True)
        assert jq.fl == "t" and JQ.supports_qp8_indirect(jq, npe)
        _STACKS[key] = (jq, port_qt(jq))
    return _STACKS[key]


@pytest.mark.parametrize("qtype", [GGMLType.Q5_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("ids", [[2, 0], [3, 1, 0, 3, 2], [1, 1]],
                         ids=["P2", "P5", "P2_dup"])
def test_indirect_plain_matches_pallas(qtype, ids):
    jq, pq = _stack(qtype)
    npe = 256
    assert PQ.supports_qp8_indirect(pq, npe)
    x = np.random.default_rng(len(ids)).normal(
        size=(len(ids), jq.k)).astype(np.float32)
    ids = np.asarray(ids, np.int32)
    want = JQ.qp8_matmul_indirect(jnp.asarray(x), jq, jnp.asarray(ids), npe,
                                  interpret=True)
    got = PQ.qp8_matmul_indirect(torch.from_numpy(x), pq,
                                 torch.from_numpy(ids), npe)
    assert got.shape == (len(ids), npe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_indirect_refuses_padded_or_misaligned_stacks():
    _, pq = _stack(GGMLType.Q5_K)
    assert not PQ.supports_qp8_indirect(pq, 100)
    with pytest.raises(ValueError):
        PQ.qp8_matmul_indirect(torch.zeros(2, pq.k), pq,
                               torch.zeros(2, dtype=torch.int32), 100)


@pytest.mark.parametrize("qtype", [GGMLType.Q5_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_qtensor_rows_matches_jax(qtype):
    rng = np.random.default_rng(8)
    jq = quantize_tensor(rng.normal(size=(1024, 512)).astype(np.float32),
                         qtype).astype_device(fast=True)
    want = jax_qt_leaf(JL.qtensor_rows(jq, 256, 512))
    got = PL.qtensor_rows(port_qt(jq), 256, 512)
    assert (got.n, got.fl) == (512, want["fl"])
    for f in ("q", "d", "fq", "fs", "fb"):
        g = getattr(got, f)
        if want[f] is None:
            assert g is None, f
            continue
        g = (g.view(torch.int16).numpy().view(np.uint16)
             if g.dtype == torch.bfloat16 else g.numpy())
        np.testing.assert_array_equal(g, want[f], err_msg=f)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q5_K,
                                   GGMLType.Q6_K, GGMLType.Q8_0,
                                   GGMLType.IQ4_XS, GGMLType.IQ4_NL],
                         ids=lambda t: t.name)
def test_random_weights_are_centred_with_checkpoint_rms(qtype):
    """The synthetic weights are zero-mean with RMS about 1/sqrt(K), so a
    full-width random model's attention and router stay smooth functions
    (mean within 5% of the RMS, RMS within 10% of 1/sqrt(K)); the IQ4
    types' codes index the non-linear table, whose RMS sizes d."""
    K = 4096
    g = torch.Generator().manual_seed(int(qtype))
    w = dequantize(random_qtensor(g, 256, K, qtype, "cpu"))
    rms = float(w.pow(2).mean().sqrt())
    assert abs(float(w.mean())) < 0.05 * rms
    assert abs(rms * K ** 0.5 - 1) < 0.1, rms * K ** 0.5


def test_random_moe_model_serves_on_cpu():
    """build_moe_model draws the Q5_K_M mixture at n_expert=8 (Q5_K wq/wo
    and gate/up stacks on t-planes, Q8_0 wk/wv interleaved, Q5_K or Q6_K
    down stacks, f32 router), drops every matmul weight's wire planes, and
    serves on the CPU through the plain versions: no kernel launches."""
    cfg = PL.LlamaConfig(n_vocab=300, n_embd=512, n_layer=2, n_head=4,
                         n_head_kv=2, n_ff=512, n_expert=8, n_expert_used=2,
                         head_dim=128, rope_theta=1e6)
    cfg2, w = build_moe_model(cfg, seed=1, device="cpu")
    assert cfg2.rope_mode == "neox"
    for lw in w["layers"]:
        kinds = {k: (v.cfg.qtype.name, v.fl) for k, v in lw.items()
                 if isinstance(v, QTensor)}
        assert kinds["wq"] == kinds["wo"] == ("Q5_K", "t")
        assert kinds["wk"] == kinds["wv"] == ("Q8_0", "il")
        assert kinds["ffn_gate_exps"] == kinds["ffn_up_exps"] == ("Q5_K", "t")
        assert kinds["ffn_down_exps"] in {("Q5_K", "t"), ("Q6_K", "t")}
        assert all(lw[k].q is None for k in kinds)
        assert lw["ffn_gate_inp"].dtype == torch.float32
    assert w["tok_embd"].q is not None and w["output"].cfg.qtype.name == "Q6_K"
    kernels.reset_launches()
    eng = Engine(cfg2, w, max_seq=32, device="cpu")
    toks = list(eng.generate(np.arange(5) % cfg.n_vocab, n_predict=4))
    assert len(toks) == 4 and all(0 <= t < cfg.n_vocab for t in toks)
    assert set(kernels.LAUNCHES.values()) == {0}


def test_convert_carries_interleaved_leaves_and_router():
    rng = np.random.default_rng(9)
    jq = quantize_tensor(rng.normal(size=(256, 512)).astype(np.float32),
                         GGMLType.Q8_0).astype_device(fast=True)
    router = rng.normal(size=(4, 512)).astype(np.float32)
    tree = convert_weights(jax_tree_to_numpy(
        {"layers": [{"wk": jq, "ffn_gate_inp": jnp.asarray(router)}]}), "cpu")
    lw = tree["layers"][0]
    wk = lw["wk"]
    assert isinstance(wk, QTensor) and wk.fl == "il" and wk.fq.shape == (512, 512)
    assert wk.fq.dtype == torch.int8 and wk.fs.dtype == torch.bfloat16
    np.testing.assert_array_equal(wk.fq.numpy(), np.asarray(jq.fq))
    np.testing.assert_array_equal(
        wk.fs.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jq.fs).view(np.uint16))
    assert lw["ffn_gate_inp"].dtype == torch.float32
    np.testing.assert_array_equal(lw["ffn_gate_inp"].numpy(), router)


# ---------------------------------------------------------------------------
# the 2-layer Mixtral-shaped model
# ---------------------------------------------------------------------------

def _build_jax(seed=2, n_layer=2, d=512, nh=4, nkv=2, hd=128, E=4, n_ff=512,
               n_vocab=300):
    rng = np.random.default_rng(seed)
    cfg = JL.LlamaConfig(n_vocab=n_vocab, n_embd=d, n_layer=n_layer,
                         n_head=nh, n_head_kv=nkv, n_ff=n_ff, n_expert=E,
                         n_expert_used=2, rope_theta=1e6, head_dim=hd)

    def q(n, k, t, fast=True):
        w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
        return quantize_tensor(w, t).astype_device(fast=fast)

    def norm_w():
        return jnp.asarray(rng.random(d) + 0.5, jnp.float32)

    layers = []
    for il in range(n_layer):
        layers.append({
            "attn_norm": norm_w(),
            "wq": q(nh * hd, d, GGMLType.Q5_K),
            "wk": q(nkv * hd, d, GGMLType.Q8_0),
            "wv": q(nkv * hd, d, GGMLType.Q8_0),
            "wo": q(d, nh * hd, GGMLType.Q5_K),
            "ffn_norm": norm_w(),
            "ffn_gate_inp": jnp.asarray(
                rng.normal(size=(E, d)).astype(np.float32) * 0.05),
            "ffn_gate_exps": q(E * n_ff, d, GGMLType.Q5_K),
            "ffn_up_exps": q(E * n_ff, d, GGMLType.Q5_K),
            "ffn_down_exps": q(E * d, n_ff,
                               GGMLType.Q6_K if il else GGMLType.Q5_K)})
    weights = {"tok_embd": q(n_vocab, d, GGMLType.Q5_K, fast=False),
               "output_norm": norm_w(),
               "output": q(n_vocab, d, GGMLType.Q6_K),
               "layers": layers}
    weights, cfg = JF.permute_rope_neox(weights, cfg)
    fused = j_drop_wire(JF.fuse_weights(weights, cfg))
    return cfg, weights, fused


def _jax_routing(mp, log):
    """Record the top-k ids of every JAX `_moe_ffn` call (eager forward)."""
    orig = JL._moe_ffn

    def wrapped(cfg, lw, f, compute_dtype, *a, **kw):
        router = JL.matmul(f, lw["ffn_gate_inp"]).astype(jnp.float32)
        _, topi = jax.lax.top_k(jax.nn.softmax(router, axis=-1),
                                cfg.n_expert_used)
        log.append(np.asarray(topi))
        return orig(cfg, lw, f, compute_dtype, *a, **kw)

    mp.setattr(JL, "_moe_ffn", wrapped)


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its logits and routing in the matching mode, and the
    port's carried-across weights; built once for the module."""
    cfg, unfused, fused = _build_jax()
    out = {"cfg": cfg, "unfused": unfused}
    rng = np.random.default_rng(1)
    out["prompt16"] = rng.integers(0, cfg.n_vocab, (1, 16)).astype(np.int32)
    out["prompt7"] = (np.arange(7, dtype=np.int32) * 23 + 3)[None]
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
            kv = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
            p8 = np.pad(out["prompt7"], ((0, 0), (0, 1)))
            lf, kv = JL.forward(cfg, fused, jnp.asarray(p8), kv, jnp.int32(0),
                                logits_all=True)
            chunks = [np.asarray(lf)[:, 6]]
            for i, tok in enumerate(toks):
                lf, kv = JL.forward(cfg, fused, jnp.asarray([[tok]], jnp.int32),
                                    kv, jnp.int32(7 + i))
                chunks.append(np.asarray(lf))
            out[name] = {"engine": (chunks, toks)}
        with pytest.MonkeyPatch.context() as mp2:
            routes = []
            _jax_routing(mp2, routes)
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
                    ld, kv = JL.forward(cfg, fused,
                                        jnp.asarray([[tok]], jnp.int32), kv,
                                        jnp.int32(3 + i))
                    r["steps"].append((np.asarray(ld), list(routes)))
                del routes[:]
                kv16 = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
                l16, _ = JL.forward(cfg, fused, jnp.asarray(out["prompt16"]),
                                    kv16, jnp.int32(0), logits_all=True)
                r["prefill16"] = (np.asarray(l16), list(routes))
    pcfg, pfused = to_port(cfg, fused)
    out["port_cfg"] = pcfg
    out["port_fused"] = drop_wire_planes(pfused)
    return out


def test_port_fuse_leaves_mixtral_layers_unfused(ref):
    """Q5_K wq with Q8_0 wk fuses to nothing, in the port as in JAX; the
    port's own load pipeline gives the JAX planes byte for byte."""
    pcfg, unfused = to_port(ref["cfg"], ref["unfused"])
    mine = drop_wire_planes(PF.fuse_weights(unfused, pcfg))
    for il, (lm, lt) in enumerate(zip(mine["layers"], ref["port_fused"]["layers"])):
        assert sorted(lm) == sorted(lt), il
        assert {"wq", "wk", "wv", "ffn_gate_inp", "ffn_gate_exps"} <= set(lm)
        assert not {"wqkv", "wqk", "attn_norm_il", "ffn_norm_il"} & set(lm)
        assert lm["wk"].fl == "il" and lm["wq"].fl == "t"
        for key, v in lm.items():
            if isinstance(v, QTensor):
                assert v.q is None, (il, key)  # wire dropped, experts too
                for f in ("fq", "fs", "fb"):
                    g, w = getattr(v, f), getattr(lt[key], f)
                    assert (g is None) == (w is None), (il, key, f)
                    if g is not None:
                        assert torch.equal(g, w), (il, key, f)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(ref["cfg"])


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
    assert len(g_ids) == len(w_ids) == 2, what
    for il, (a, b) in enumerate(zip(g_ids, w_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: layer {il} ids")
    err = nmse(g, w)
    assert err <= NMSE_MAX, (what, err, float(np.abs(g - w).max()))


@pytest.mark.parametrize("kv", list(KV))
def test_forward_prefill3_and_decode_match_jax(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    lp, ids, cache = _run(cfg, w, torch.tensor([PROMPT3]), cache, 0,
                          logits_all=True)
    _check((lp, ids), ref[kv]["prefill3"], "prefill T=3")
    for i, tok in enumerate(STEPS):
        ld, ids, cache = _run(cfg, w, torch.tensor([[tok]]), cache, 3 + i)
        _check((ld, ids), ref[kv]["steps"][i], f"decode step {i}")


@pytest.mark.parametrize("kv", list(KV))
def test_forward_prefill16_matches_jax(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    l16, ids, _ = _run(cfg, w, torch.from_numpy(ref["prompt16"]).long(),
                       cache, 0, logits_all=True)
    _check((l16, ids), ref[kv]["prefill16"], "prefill T=16")


@pytest.mark.parametrize("kv", list(KV))
def test_engine_greedy_tokens_match_jax_engine(ref, kv):
    want, toks = ref[kv]["engine"]  # JAX forward's chunk logits, JAX Engine's tokens
    eng = Engine(ref["port_cfg"], ref["port_fused"], max_seq=MAX_SEQ,
                 kv_dtype=kv, device="cpu")
    got = [eng.prefill(ref["prompt7"])]
    mine = []
    for _ in toks:
        mine.append(int(np.argmax(got[-1][0])))
        got.append(eng.decode_one(np.array([mine[-1]])))
    assert mine == toks
    for i, (g, w) in enumerate(zip(got, want)):
        err = nmse(g, w)
        assert err <= NMSE_MAX, (i, err)
