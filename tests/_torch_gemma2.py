"""The 2-layer Gemma-2-shaped model shared by tests/test_torch_gemma2_t.py
and tests/test_torch_gemma2_il.py: the JAX reference built once per file
(one layout each, so that `--dist loadfile` builds the two on two
workers), and the checks both files run.

The model: n_embd 512, 4 query heads and 2 KV heads of 256 (Gemma-2's
head width and query groups of 2; with one KV head wk's 256 lanes would
pad its t-planes to 512 and the fused wqkv fall back to the interleaved
layout, where the full-size model's 2048 lanes do not), n_ff 512,
vocabulary 384, per-tensor types from the JAX
`QuantPolicy("Q4_K_M", 2, n_gqa=2, has_output=False)`: layer 0 all Q4_K
(wqkv fused), layer 1 a Q6_K attn_v and ffn_down (the _use_more_bits
layer: wqk + wv, K2 or K7 at decode), the head tied to the Q6_K token
embedding.  The gemma2 branches: the embedding scaled by sqrt(512), a gelu
FFN (K1's or K6's act mode in gelu, without the residual, which the
post-FFN norm keeps out of the kernel), sandwich post-norms (wo without the
residual epilogue), a sliding window of 8 on layer 0 (layer 1 global), the
attention logit cap 5 and the final logit cap 3.  Random weights keep the
scores and logits near unit size, so caps this small take tanh out of its
linear range (a cap of 50 or 30, the real model's, would not bend them).
The prompts are longer than the window, so the window masks: an 11-token
prefill then 3 decode steps (positions 11-13), a 16-token prefill, and the
Engine's greedy tokens from a 12-token prompt against the JAX Engine's.

Weights are drawn as wire planes with numpy (`wire_qtensor`), given their
matmul planes and fused by the JAX package (layout "t": its default
layouts; "il": under GHT_QP8=0, interleaved everywhere) and carried across
with `convert`.  The JAX side runs in the kernel-contract mode
(GHT_FAST_INTERPRET=1 and the llama interpret flags: the Pallas kernels in
interpret mode, K4 at D = 256 among them).  Every logits NMSE <= 5e-4, the
mul_mat budget of the reference's op tests: gelu's tanh differs by an ulp
between XLA and torch, which flips an int8 (K1) or bf16 (K6) activation
rounding now and then, so nothing here is bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.models import fuse as JF
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.quant.pack import drop_wire_planes as j_drop_wire
from ggml_hexagon_tpu.quant.policy import QuantPolicy
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine

from _torch_port import nmse, to_port, wire_qtensor
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.quant.pack import QTensor, drop_wire_planes
from ggml_hexagon_tpu_torch.runtime.engine import Engine

NMSE_MAX = 5e-4
D, NH, NKV, HD, NFF, VOCAB = 512, 4, 2, 256, 512, 384
WINDOW, ATTN_CAP, FINAL_CAP = 8, 5.0, 3.0
PROMPT11 = [5, 30, 61, 17, 2, 99, 240, 8, 71, 150, 33]
STEPS = [7, 11, 13]
MAX_SEQ = 32


def config(arch: str = "gemma2"):
    """The JAX config of the 2-layer model (gemma: no post-norms, window
    or caps)."""
    kw = dict(n_vocab=VOCAB, n_embd=D, n_layer=2, n_head=NH, n_head_kv=NKV,
              head_dim=HD, n_ff=NFF, rms_eps=1e-6, rope_theta=10000.0,
              arch=arch, rope_mode="neox", act="gelu",
              embd_scale=math.sqrt(D))
    if arch == "gemma2":
        kw.update(post_norms=True, attn_logit_softcap=ATTN_CAP,
                  final_logit_softcap=FINAL_CAP, swa_window=WINDOW,
                  swa_pattern=2)
    return JL.LlamaConfig(**kw)


def build_jax(layout: str, seed: int = 0, arch: str = "gemma2"):
    """(cfg, unfused, fused) JAX weights of the model on `layout` (call
    under GHT_QP8=0 for "il")."""
    cfg = config(arch)
    rng = np.random.default_rng(seed)
    policy = QuantPolicy("Q4_K_M", 2, n_gqa=NH // NKV, has_output=False)
    count = [0]

    def q(name, n, k):
        count[0] += 1
        w = wire_qtensor(policy.tensor_type(name, (n, k)), n, k,
                         seed=seed * 100 + count[0])
        return w.astype_device(layout=layout)

    def norm_w():
        return jnp.asarray(rng.random(D) + 0.5, jnp.float32)

    layers = []
    for il in range(2):
        p = f"blk.{il}."
        lw = {"attn_norm": norm_w(),
              "wq": q(p + "attn_q.weight", NH * HD, D),
              "wk": q(p + "attn_k.weight", NKV * HD, D),
              "wv": q(p + "attn_v.weight", NKV * HD, D),
              "wo": q(p + "attn_output.weight", D, NH * HD),
              "ffn_norm": norm_w(),
              "ffn_gate": q(p + "ffn_gate.weight", NFF, D),
              "ffn_up": q(p + "ffn_up.weight", NFF, D),
              "ffn_down": q(p + "ffn_down.weight", D, NFF)}
        if cfg.post_norms:
            lw["post_attn_norm"] = norm_w()
            lw["post_ffn_norm"] = norm_w()
        layers.append(lw)
    tok = q("token_embd.weight", VOCAB, D)   # wire and matmul planes
    weights = {"tok_embd": tok, "output_norm": norm_w(), "output": tok,
               "layers": layers}
    return cfg, weights, j_drop_wire(JF.fuse_weights(weights, cfg))


def reference(layout: str, kvs=("bf16",), arch: str = "gemma2",
              full: bool = True):
    """The JAX model's logits in the kernel-contract mode and the port's
    carried-across weights; without `full`, the 11-token prefill and the
    first decode step only."""
    out = {"layout": layout}
    with pytest.MonkeyPatch.context() as mp:
        if layout == "il":
            mp.setenv("GHT_QP8", "0")
        cfg, unfused, fused = build_jax(layout, arch=arch)
        out.update(cfg=cfg, unfused=unfused)
        rng = np.random.default_rng(1)
        out["prompt16"] = rng.integers(0, VOCAB, (1, 16)).astype(np.int32)
        out["prompt12"] = (np.arange(12, dtype=np.int32) * 29 + 3)[None] % VOCAB
        mp.setenv("GHT_FAST_INTERPRET", "1")
        mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
        mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
        for kv in kvs:
            kvd = jnp.bfloat16 if kv == "bf16" else kv
            r = out[kv] = {}
            if full:
                eng = JEngine(cfg, fused, max_seq=MAX_SEQ, kv_dtype=kvd)
                lg = [eng.prefill(out["prompt12"])]
                toks = []
                for _ in range(3):
                    toks.append(int(np.argmax(lg[-1][0])))
                    lg.append(eng.decode_one(np.array([toks[-1]])))
                r["engine_tokens"] = toks
            cache = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
            lp, cache = JL.forward(cfg, fused, jnp.asarray([PROMPT11], jnp.int32),
                                   cache, jnp.int32(0), logits_all=True)
            r["prefill11"] = np.asarray(lp)
            r["steps"] = []
            for i, tok in enumerate(STEPS if full else STEPS[:1]):
                ld, cache = JL.forward(cfg, fused, jnp.asarray([[tok]], jnp.int32),
                                       cache, jnp.int32(len(PROMPT11) + i))
                r["steps"].append(np.asarray(ld))
            if not full:
                continue
            c16 = JL.init_kv_cache(cfg, 1, MAX_SEQ, kvd)
            l16, _ = JL.forward(cfg, fused, jnp.asarray(out["prompt16"]), c16,
                                jnp.int32(0), logits_all=True)
            r["prefill16"] = np.asarray(l16)
    pcfg, pfused = to_port(cfg, fused)
    out["port_cfg"], out["port_fused"] = pcfg, drop_wire_planes(pfused)
    return out


def types(lw):
    return {k: (v.cfg.qtype.name, v.fl) for k, v in lw.items()
            if isinstance(v, QTensor)}


def _held(got, want, what):
    err = nmse(got, want)
    assert err <= NMSE_MAX, (what, err, float(np.abs(got - want).max()))


def check_prefill_and_decode(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    lp, cache = PL.forward(cfg, w, torch.tensor([PROMPT11]), cache, 0,
                           logits_all=True)
    _held(lp.numpy(), ref[kv]["prefill11"], "prefill T=11")
    for i, tok in enumerate(STEPS):
        ld, cache = PL.forward(cfg, w, torch.tensor([[tok]]), cache,
                               len(PROMPT11) + i)
        _held(ld.numpy(), ref[kv]["steps"][i], f"decode step {i}")


def check_prefill16(ref, kv):
    cfg, w = ref["port_cfg"], ref["port_fused"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, kv, device="cpu")
    l16, _ = PL.forward(cfg, w, torch.from_numpy(ref["prompt16"]).long(),
                        cache, 0, logits_all=True)
    _held(l16.numpy(), ref[kv]["prefill16"], "prefill T=16")


def check_engine_tokens(ref, kv):
    toks = ref[kv]["engine_tokens"]
    eng = Engine(ref["port_cfg"], ref["port_fused"], max_seq=MAX_SEQ,
                 kv_dtype=kv, device="cpu")
    mine = list(eng.generate(ref["prompt12"][0], n_predict=len(toks)))
    assert mine == toks


def check_window_and_caps_bend(ref):
    """The window masks and the caps bend at these positions: the port's
    decode step after the 11-token prefill moves without either."""
    from dataclasses import replace

    cfg, w = ref["port_cfg"], ref["port_fused"]

    def last(c):
        cache = PL.init_kv_cache(c, 1, MAX_SEQ, "bf16", device="cpu")
        _, cache = PL.forward(c, w, torch.tensor([PROMPT11]), cache, 0)
        ld, _ = PL.forward(c, w, torch.tensor([[STEPS[0]]]), cache,
                           len(PROMPT11))
        return ld.numpy()

    base = last(cfg)
    for what, c in (("window", replace(cfg, swa_window=0)),
                    ("attention cap", replace(cfg, attn_logit_softcap=0.0)),
                    ("final cap", replace(cfg, final_logit_softcap=0.0))):
        assert nmse(last(c), base) > 1e-5, what
