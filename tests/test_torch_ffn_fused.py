"""The port's whole-FFN megakernel path (K9; the JAX package under
GHT_FFN_FUSED=1) against the JAX package: the op `ffn_fused` (its plain
version, on the CPU) against the JAX `ffn_fused(interpret=True)`, the gate
`supports_ffn_fused` and the layout `attach_ffn_fused_layout` against
theirs, and a 2-layer model in the megakernel layout against the JAX
forward under GHT_QP8=0, GHT_FFN_FUSED=1 and the interpret flags.

  op      D = 4096 (the smallest width supports_ffn_fused takes: G = D/32
          must be a multiple of 128), NFF = 512; Q4_K wo and gate_up
          (interleaved nibble planes with a stored fb); down Q4_K (nibble,
          stored fb), Q6_K (byte, derived -32), Q5_K (byte, stored fb), Q4_0
          (nibble, derived -8) and IQ3_XXS (coded, no bias); B = 1 and 3.
          NMSE <= 1e-6: the same roundings on both sides; rsqrt's and exp's
          last bit and the order of f32 sums are all that differ.
  model   d = 4096 with Llama-3-8B attention (32 query / 8 KV heads of 128,
          so wo is d x d), NFF = 512, 2 layers whose types come from
          QuantPolicy("Q4_K_M", 8, ...): layer 0's attn_v and ffn_down Q6_K,
          layer 1's Q4_K; both layers take the megakernel layout.  bf16 KV:
          a 3-token prefill (the fallback: wo and down outputs un-permuted,
          down in K6's pre-interleaved mode), 3 decode steps (K9), a
          16-token prefill, and the Engine's greedy tokens against the JAX
          Engine's.  Logits NMSE <= 5e-4, the reference's mul_mat budget.

Wire planes are drawn with numpy (`wire_qtensor`, `coded_qtensor`): the JAX
K-quant encoder takes about 37 s for one 4096 x 4096 Q4_K tensor.  Each
JAX reference is built once for the module.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import fuse as JF
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.ops import ffn_fused as JFF
from ggml_hexagon_tpu.ops.qmm_fast import interleave_perm as j_perm
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import QCONFIGS as JQC
from ggml_hexagon_tpu.quant.pack import drop_wire_planes as j_drop_wire
from ggml_hexagon_tpu.quant.policy import QuantPolicy
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine

from _torch_port import (coded_qtensor, nmse, port_qt, to_port,
                         wire_qtensor)
from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models import fuse as PFU
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.ops import ffn_fused as PFF
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS as PQC
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes
from ggml_hexagon_tpu_torch.runtime.engine import Engine

D, NFF, EPS = 4096, 512, 1e-5
NMSE_OP = 1e-6
NMSE_MAX = 5e-4
DOWN = {"Q4_K": GGMLType.Q4_K, "Q6_K": GGMLType.Q6_K, "Q5_K": GGMLType.Q5_K,
        "Q4_0": GGMLType.Q4_0, "IQ3_XXS": GGMLType.IQ3_XXS}
PROMPT3 = [5, 30, 61]
STEPS = [7, 11, 13]
MAX_SEQ = 32


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def op_ref():
    """Per down type: the JAX planes in the megakernel layout (wo and down
    rows permuted by interleave_perm(D, 32), gate_up rows in down's
    interleaved column order), the same carried into the port, and the JAX
    op's output in interpret mode at B = 1 and 3."""
    rng = np.random.default_rng(2)
    perm_d = np.asarray(j_perm(D, 32))
    wo = wire_qtensor(GGMLType.Q4_K, D, D, seed=1).astype_device(layout="il")
    gu = wire_qtensor(GGMLType.Q4_K, 2 * NFF, D, seed=2).astype_device(
        layout="il")
    wo_p = wo.take_rows(perm_d)
    wn_il = (rng.random(D).astype(np.float32) + 0.5)[perm_d]
    attn = (rng.normal(size=(3, D)) * 0.3).astype(np.float32)
    h = (rng.normal(size=(3, D)) * 0.5).astype(np.float32)
    out = {"attn": attn, "h": h, "wn_il": wn_il, "wo": wo, "wo_p": wo_p,
           "port_wo": port_qt(wo_p), "cases": {}}
    for name, qtype in DOWN.items():
        w = (coded_qtensor(qtype, D, NFF, seed=3) if JQC[qtype].code_map
             else wire_qtensor(qtype, D, NFF, seed=3))
        dn = w.astype_device(layout="il")
        pc = np.asarray(j_perm(NFF, dn.cfg.gs))
        gu_il = gu.take_rows(np.concatenate([pc, NFF + pc]))
        dn_p = dn.take_rows(perm_d)
        want = {B: np.asarray(JFF.ffn_fused(
            jnp.asarray(attn[:B]), jnp.asarray(h[:B]), wo_p, gu_il, dn_p,
            jnp.asarray(wn_il), EPS, act="silu", out_dtype=jnp.float32,
            interpret=True)) for B in (1, 3)}
        out["cases"][name] = {"jax": (gu_il, dn, dn_p), "want": want,
                              "port": (port_qt(gu_il), port_qt(dn_p))}
    return out


@pytest.mark.parametrize("down", list(DOWN))
@pytest.mark.parametrize("B", [1, 3])
def test_op_matches_jax_interpret(op_ref, down, B):
    case = op_ref["cases"][down]
    gu, dn = case["port"]
    kernels.reset_launches()
    got = PFF.ffn_fused(_t(op_ref["attn"][:B]), _t(op_ref["h"][:B]),
                        op_ref["port_wo"], gu, dn, _t(op_ref["wn_il"]), EPS,
                        out_dtype=torch.float32)
    want = case["want"][B]
    assert got.shape == (B, D) and got.dtype == torch.float32
    err = nmse(got.numpy(), want)
    assert err <= NMSE_OP, (down, B, err, float(np.abs(got.numpy() - want).max()))
    assert set(kernels.LAUNCHES.values()) == {0}  # CPU tensors: plain


def test_op_families_cover_every_down_branch(op_ref):
    """The five down types reach K9's five branches: nibble with a stored
    fb or a derived offset, byte with either, coded without a bias."""
    from ggml_hexagon_tpu_torch.ops.qmm_fast import _family, _offset_bias

    got = {}
    for name, case in op_ref["cases"].items():
        dn = case["port"][1]
        got[name] = (_family(dn.cfg), dn.fb is not None,
                     _offset_bias(dn.cfg, dn.fb))
    assert got == {"Q4_K": ("nibble", True, 0.0), "Q6_K": ("byte", False, -32.0),
                   "Q5_K": ("byte", True, 0.0), "Q4_0": ("nibble", False, -8.0),
                   "IQ3_XXS": ("coded", False, 0.0)}


def test_op_refuses_other_acts_and_rows(op_ref):
    gu, dn = op_ref["cases"]["Q4_K"]["port"]
    args = (op_ref["port_wo"], gu, dn, _t(op_ref["wn_il"]), EPS)
    with pytest.raises(NotImplementedError):
        PFF.ffn_fused(_t(op_ref["attn"][:1]), _t(op_ref["h"][:1]), *args,
                      act="gelu")
    x9 = torch.zeros(9, D)
    with pytest.raises(ValueError):
        PFF.ffn_fused(x9, x9, *args)


def _gate_cases(op_ref):
    """(name, wo, gu_il, dn) on both sides: the five layouts that qualify,
    then wo on IQ4_XS or coded planes, and wo or gate_up without fb."""
    out = []
    for name, case in op_ref["cases"].items():
        gu_j, _, dn_j = case["jax"]
        gu_p, dn_p = case["port"]
        out.append((name, (op_ref["wo_p"], gu_j, dn_j),
                    (op_ref["port_wo"], gu_p, dn_p), True))
    gu_j, _, dn_j = op_ref["cases"]["Q4_K"]["jax"]
    gu_p, dn_p = op_ref["cases"]["Q4_K"]["port"]
    wj, wp = op_ref["wo_p"], op_ref["port_wo"]
    for qt_name in ("IQ4_XS", "IQ3_XXS"):
        qtype = GGMLType[qt_name]
        out.append((f"{qt_name}_wo",
                    (dataclasses.replace(wj, cfg=JQC[qtype]), gu_j, dn_j),
                    (dataclasses.replace(wp, cfg=PQC[qtype]), gu_p, dn_p),
                    False))
    out.append(("wo_without_fb", (dataclasses.replace(wj, fb=None), gu_j, dn_j),
                (dataclasses.replace(wp, fb=None), gu_p, dn_p), False))
    out.append(("gate_up_without_fb",
                (wj, dataclasses.replace(gu_j, fb=None), dn_j),
                (wp, dataclasses.replace(gu_p, fb=None), dn_p), False))
    return out


def test_supports_ffn_fused_matches_jax(op_ref):
    for name, j, p, want in _gate_cases(op_ref):
        assert JFF.supports_ffn_fused(*j, D, NFF) == want, name
        assert PFF.supports_ffn_fused(*p, D, NFF) == want, name


def _layer(wo, gu_il, dn, wn_il, extra=None):
    lw = {"wo": wo, "w_gateup_il": gu_il, "ffn_down": dn, "ffn_norm_il": wn_il}
    lw.update(extra or {})
    return lw


def test_attach_layout_matches_jax(op_ref, monkeypatch):
    """attach_ffn_fused_layout marks and permutes the layers JAX marks:
    the Q4_K / Q6_K layouts yes, a layer with a router (MoE) or an IQ4_XS
    wo no; the permuted planes equal the JAX package's byte for byte."""
    monkeypatch.setenv("GHT_FFN_FUSED", "1")
    cfg = JL.LlamaConfig(n_vocab=64, n_embd=D, n_layer=4, n_head=32,
                         n_head_kv=8, n_ff=NFF)
    wo = op_ref["wo"]
    wn = jnp.asarray(op_ref["wn_il"])
    router = jnp.zeros((8, D), jnp.float32)
    layers = []
    for down in ("Q4_K", "Q6_K"):
        gu_il, dn, _ = op_ref["cases"][down]["jax"]
        layers.append(_layer(wo, gu_il, dn, wn))
    gu_il, dn, _ = op_ref["cases"]["Q4_K"]["jax"]
    layers.append(_layer(wo, gu_il, dn, wn, {"ffn_gate_inp": router}))
    layers.append(_layer(dataclasses.replace(wo, cfg=JQC[GGMLType.IQ4_XS]),
                         gu_il, dn, wn))
    theirs = JF.attach_ffn_fused_layout({"layers": layers}, cfg)["layers"]
    pcfg, pw = to_port(cfg, {"layers": layers[:3]})
    last = dict(pw["layers"][0])
    last["wo"] = dataclasses.replace(last["wo"], cfg=PQC[GGMLType.IQ4_XS])
    mine = PFU.attach_ffn_fused_layout(
        {"layers": pw["layers"] + [last]}, pcfg)["layers"]
    assert ["ffp" in lw for lw in theirs] == [True, True, False, False]
    assert ["ffp" in lw for lw in mine] == [True, True, False, False]
    for lt, lm in zip(theirs[:2], mine[:2]):
        assert lm["ffp"] is None
        for key in ("wo", "ffn_down"):
            t = port_qt(lt[key])
            for f in ("fq", "fs", "fb"):
                a, b = getattr(lm[key], f), getattr(t, f)
                assert (a is None) == (b is None), (key, f)
                assert a is None or torch.equal(a, b), (key, f)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _build_jax(seed: int):
    """(cfg, unfused, fused) JAX weights with Q4_K_M policy types on the
    interleaved layout (call under GHT_QP8=0 and GHT_FFN_FUSED=1)."""
    rng = np.random.default_rng(seed)
    d, nh, nkv, n_ff = D, 32, 8, NFF
    cfg = JL.LlamaConfig(n_vocab=256, n_embd=d, n_layer=2, n_head=nh,
                         n_head_kv=nkv, n_ff=n_ff, rope_theta=500000.0,
                         head_dim=128)
    policy = QuantPolicy("Q4_K_M", 8, n_gqa=nh // nkv, n_expert=1)
    seeds = iter(range(seed * 100, seed * 100 + 100))

    def q(name, n, k, fast=True):
        qt = wire_qtensor(policy.tensor_type(name, (n, k)), n, k,
                          seed=next(seeds))
        return qt.astype_device(fast=True, layout="il") if fast else qt

    def norm_w():
        return jnp.asarray(rng.random(d) + 0.5, jnp.float32)

    nq, nk = nh * 128, nkv * 128
    layers = []
    for il in range(2):
        p = f"blk.{il}."
        layers.append({"attn_norm": norm_w(),
                       "wq": q(p + "attn_q.weight", nq, d),
                       "wk": q(p + "attn_k.weight", nk, d),
                       "wv": q(p + "attn_v.weight", nk, d),
                       "wo": q(p + "attn_output.weight", d, nq),
                       "ffn_norm": norm_w(),
                       "ffn_gate": q(p + "ffn_gate.weight", n_ff, d),
                       "ffn_up": q(p + "ffn_up.weight", n_ff, d),
                       "ffn_down": q(p + "ffn_down.weight", d, n_ff)})
    weights = {"tok_embd": q("token_embd.weight", cfg.n_vocab, d, fast=False),
               "output_norm": norm_w(),
               "output": q("output.weight", cfg.n_vocab, d),
               "layers": layers}
    weights, cfg = JF.permute_rope_neox(weights, cfg)
    return cfg, weights, j_drop_wire(JF.fuse_weights(weights, cfg))


@pytest.fixture(scope="module")
def model_ref():
    """The JAX model's logits in the matching mode (the Pallas kernels in
    interpret mode, the megakernel at decode), its Engine's greedy tokens,
    and the port's carried-across weights."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_QP8", "0")
        mp.setenv("GHT_FFN_FUSED", "1")
        cfg, unfused, fused = _build_jax(seed=0)
        assert all("ffp" in lw for lw in fused["layers"])
        out.update(cfg=cfg, unfused=unfused)
        rng = np.random.default_rng(1)
        out["prompt16"] = rng.integers(0, cfg.n_vocab, (1, 16)).astype(np.int32)
        out["prompt7"] = (np.arange(7, dtype=np.int32) * 17 + 3)[None]
        mp.setenv("GHT_FAST_INTERPRET", "1")
        mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
        mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
        eng = JEngine(cfg, fused, max_seq=MAX_SEQ, kv_dtype=jnp.bfloat16)
        lg = eng.prefill(out["prompt7"])
        toks = []
        for _ in range(3):
            toks.append(int(np.argmax(lg[0])))
            lg = eng.decode_one(np.array([toks[-1]]))
        out["engine_tokens"] = toks
        kv = JL.init_kv_cache(cfg, 1, MAX_SEQ, jnp.bfloat16)
        lp, kv = JL.forward(cfg, fused, jnp.asarray([PROMPT3], jnp.int32), kv,
                            jnp.int32(0), logits_all=True)
        out["prefill3"] = np.asarray(lp)
        out["steps"] = []
        for i, tok in enumerate(STEPS):
            ld, kv = JL.forward(cfg, fused, jnp.asarray([[tok]], jnp.int32),
                                kv, jnp.int32(3 + i))
            out["steps"].append(np.asarray(ld))
        kv16 = JL.init_kv_cache(cfg, 1, MAX_SEQ, jnp.bfloat16)
        l16, _ = JL.forward(cfg, fused, jnp.asarray(out["prompt16"]), kv16,
                            jnp.int32(0), logits_all=True)
        out["prefill16"] = np.asarray(l16)
    pcfg, pfused = to_port(cfg, fused)
    out["port_cfg"], out["port_fused"] = pcfg, drop_wire_planes(pfused)
    return out


def _check(got, want, what):
    err = nmse(got, want)
    assert err <= NMSE_MAX, (what, err, float(np.abs(got - want).max()))


def test_fuse_weights_gives_the_jax_megakernel_layout(model_ref):
    """The port's own fuse_weights(ffn_fused=True) on the carried-across
    unfused weights gives the JAX package's fused layers byte for byte, the
    marker included; convert and drop_wire_planes carry the None-valued
    marker across; without the option no layer is marked."""
    pcfg, unfused = to_port(model_ref["cfg"], model_ref["unfused"])
    mine = drop_wire_planes(PFU.fuse_weights(unfused, pcfg, ffn_fused=True))
    theirs = model_ref["port_fused"]
    for i, (lm, lt) in enumerate(zip(mine["layers"], theirs["layers"])):
        assert sorted(lm) == sorted(lt), i
        assert "ffp" in lm and lm["ffp"] is None and lt["ffp"] is None, i
        for key, v in lm.items():
            w = lt[key]
            if v is None:
                continue
            if not isinstance(v, QTensor):
                torch.testing.assert_close(v, w, rtol=0, atol=0)
                continue
            for f in ("fq", "fs", "fb"):
                g, t = getattr(v, f), getattr(w, f)
                assert (g is None) == (t is None), (i, key, f)
                if g is not None:
                    assert torch.equal(g, t), (i, key, f)
    dn = [lw["ffn_down"].cfg.qtype.name for lw in mine["layers"]]
    assert dn == ["Q6_K", "Q4_K"]
    plain = PFU.fuse_weights(unfused, pcfg)
    assert not any("ffp" in lw for lw in plain["layers"])


def _run(cfg, w, tokens, cache, pos, **kw):
    logits, cache = PL.forward(cfg, w, tokens, cache, pos, **kw)
    return logits.numpy(), cache


def test_forward_prefill3_and_decode_match_jax(model_ref, monkeypatch):
    """The 3-token prefill runs the split fallback, each decode step one
    K9 call a layer (the plain version here), as the JAX forward does."""
    calls = []
    real = PL.ffn_fused
    monkeypatch.setattr(PL, "ffn_fused",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    cfg, w = model_ref["port_cfg"], model_ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, "bf16", device="cpu")
    lp, cache = _run(cfg, w, torch.tensor([PROMPT3]), cache, 0,
                     logits_all=True)
    _check(lp, model_ref["prefill3"], "prefill T=3")
    assert calls == []
    for i, tok in enumerate(STEPS):
        ld, cache = _run(cfg, w, torch.tensor([[tok]]), cache, 3 + i)
        _check(ld, model_ref["steps"][i], f"decode step {i}")
    assert calls == [(1, D)] * (2 * len(STEPS))


def test_forward_prefill16_matches_jax(model_ref):
    cfg, w = model_ref["port_cfg"], model_ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, "bf16", device="cpu")
    l16, _ = _run(cfg, w, torch.from_numpy(model_ref["prompt16"]).long(),
                  cache, 0, logits_all=True)
    _check(l16, model_ref["prefill16"], "prefill T=16")


def test_engine_greedy_tokens_match_jax_engine(model_ref):
    toks = model_ref["engine_tokens"]
    eng = Engine(model_ref["port_cfg"], model_ref["port_fused"],
                 max_seq=MAX_SEQ, kv_dtype="bf16", device="cpu")
    mine = list(eng.generate(model_ref["prompt7"][0], n_predict=len(toks)))
    assert mine == toks
