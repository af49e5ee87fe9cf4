"""Random Llama-3-8B, Mixtral-8x7B and Gemma-2-9B models with the exact
plane layout of a GGUF file of a given llama.cpp mixture (Q4_K_M, Q5_K_M, IQ4_XS, IQ3_XXS
made with an imatrix), drawn on
the device from a seeded torch.Generator, on the JAX package's default
plane layouts (layout "t") or on the interleaved layout everywhere (layout
"il", the JAX package under GHT_QP8=0).

Counterpart of bench.py:26-125 (`random_qtensor`, `host_concat`,
`build_8b`).  The wire planes are drawn as the bench draws them (uniform
packed bytes, f16-exact scales, 6-bit sub-scales), but with scales and
mins that centre the weights and give them a trained checkpoint's RMS
(`random_qtensor`), and the matmul planes are built on the device, which
takes seconds where the host
build of the reference takes minutes.  No real checkpoint is involved: the
bytes and the compute profile are those of a real file of that mixture.
The per-tensor types come from `QuantPolicy`, as the JAX loader takes them.

`write_gguf` writes such a model as a GGUF file of any ftype of
quant.policy.FTYPES (wire blocks, the `llama.*` metadata and a
tokenizer's fields; F16 writes random f16 weights, the input of the
quantizer), and `llama_bpe_vocab` makes the deterministic llama-bpe
vocabulary of Llama-3's size that it carries, so the loader, the
quantizer, the tokenizer and the serving path run from a file without a
real checkpoint.
"""
from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import torch

from .. import resolve_device
from ..quant.formats import GGMLType
from ..quant.pack import QCONFIGS, QTensor, drop_wire_planes, unpack_bits
from ..quant.policy import QuantPolicy
from .fuse import fuse_weights, permute_rope_neox
from ..ops.qmm_qp8 import _CODE_ALPHABETS, KVALUES_IQ4NL, decode_codes
from .llama import LlamaConfig

LLAMA3_8B = dict(n_vocab=128256, n_embd=4096, n_layer=32, n_head=32,
                 n_head_kv=8, n_ff=14336, rope_theta=500000.0,
                 n_ctx_train=8192)

#: meta-llama/Meta-Llama-3-70B config.json: 64 query and 8 KV heads of
#: 128, 80 layers (the JAX package's bench.py:76-79 writes the 8B's so)
LLAMA3_70B = dict(n_vocab=128256, n_embd=8192, n_layer=80, n_head=64,
                  n_head_kv=8, n_ff=28672, rope_theta=500000.0,
                  n_ctx_train=8192)

#: google/gemma-2-9b config.json: 16 query and 8 KV heads of 256, a gelu
#: (tanh) FFN, sandwich norms, a 4096-token window on the even layers,
#: logit soft-caps 50 (attention) and 30 (final), the embedding scaled by
#: sqrt(3584) and tied to the head (the registry's gemma2 entry)
GEMMA2_9B = dict(n_vocab=256000, n_embd=3584, n_layer=42, n_head=16,
                 n_head_kv=8, head_dim=256, n_ff=14336, rms_eps=1e-6,
                 rope_theta=10000.0, n_ctx_train=8192, arch="gemma2",
                 rope_mode="neox", act="gelu", post_norms=True,
                 attn_logit_softcap=50.0, final_logit_softcap=30.0,
                 swa_window=4096, swa_pattern=2,
                 embd_scale=3584 ** 0.5)

#: mistralai/Mixtral-8x7B-v0.1 config.json (rope "norm", which
#: permute_rope_neox turns into neox)
MIXTRAL_8X7B = dict(n_vocab=32000, n_embd=4096, n_layer=32, n_head=32,
                    n_head_kv=8, n_ff=14336, n_expert=8, n_expert_used=2,
                    rope_theta=1e6, rms_eps=1e-5, n_ctx_train=32768)


def _generator(device, seed: int):
    """A seeded generator on `device`, or None on the meta device, where
    tensors have shapes and no values (launches.launch_table's models)."""
    if torch.device(device).type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def random_qtensor(gen: torch.Generator, n: int, k: int, qtype: GGMLType,
                   device) -> QTensor:
    """Random wire planes (uniform packed bytes, f16-exact scales, 6-bit
    sub-scales; a signed type's q plane, Q8_0, is int8 in [-127, 127])
    whose weights are scaled like a trained checkpoint's: zero-mean, of RMS
    about 1/sqrt(k), so a unit-RMS input gives outputs of unit RMS.

    bench.py:26 draws its scales independently of the values, which makes
    every Q4_K/Q5_K weight positive (mean about 0.5, RMS about 0.6): at
    full width the attention logits then spread over ~1e4, the softmax is
    an argmax, and a rounding-level difference between two routes can
    switch the key a token attends to.  Here the sub-block mins centre the
    values (m = sc, dmin = d * qmax / 2; Q4_1 and Q5_1, whose wire holds
    the min itself, an f16-exact m = -d * qmax / 2) and d sets the RMS.

    The IQ4 types' codes index KVALUES_IQ4NL (-127..113, RMS about 67.4),
    so d is sized from that table's RMS; IQ4_XS draws its sub-scales over
    the wire's signed -32..31 (as int8, like the JAX package's unpacked
    wire), which centres its weights, and IQ4_NL draws the sign of d, as
    the reference quantizer's d takes the sign of the row's largest
    value.

    The coded types (i-quants below 4 bits, ternary) are drawn as the JAX
    loader holds them: int8 values of the expanded wire, each a sign times
    a magnitude of the type's alphabet (`_CODE_ALPHABETS`; ternary -1..2),
    with one scale d a group of gs, sized from the alphabet's RMS; the
    ternary types draw the sign of d, which centres their values."""
    cfg = QCONFIGS[qtype]
    n_pad = (n + 127) // 128 * 128

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                             generator=gen)

    def unif(shape):
        return torch.rand(shape, dtype=torch.float32, device=device,
                          generator=gen)

    u_rms = (1 / 3 + 0.05 + 0.05 ** 2) ** 0.5      # of U(0.05, 1.05)
    if cfg.code_map:
        cm = cfg.code_map
        if cm == "tern":
            vals, n_codes = (-1, 0, 1, 2), 4
        else:
            mags = _CODE_ALPHABETS[cm]
            vals, n_codes = mags, 2 * len(mags)
        # a uniform code: magnitude index and sign (bit 3), decoded
        r = ints(0, n_codes, (n_pad, k), torch.int32)
        if n_codes == 8:                           # 4-entry alphabets
            r = (r & 3) | ((r & 4) << 1)
        q = decode_codes(cm, r).to(torch.int8)
        del r
        q_rms = (sum(v * v for v in vals) / len(vals)) ** 0.5
        d0 = 1.0 / (k ** 0.5 * q_rms * u_rms)
        d = ((unif((n_pad, k // cfg.gs)) + 0.05) * d0).half().float()
        if cm == "tern":
            d = d * (ints(0, 2, d.shape, torch.int8) * 2 - 1).float()
        return QTensor(cfg, n, k, q, d)

    q = (ints(-127, 128, (n_pad, k), torch.int8) if cfg.signed
         else ints(0, 256, (n_pad, k * cfg.bits_lo // 8), torch.uint8))
    qh = (ints(0, 256, (n_pad, k * cfg.bits_hi // 8), torch.uint8)
          if cfg.bits_hi else None)
    groups = k // 256 if cfg.superblock else k // cfg.gs
    sc_lo = -32 if cfg.lut else 0                  # IQ4_XS: signed sub-scales
    if cfg.lut:                                    # RMS of the table's values
        q_rms = (sum(v * v for v in KVALUES_IQ4NL) / 16) ** 0.5
    else:
        n_q = 255 if cfg.signed else 2 ** (cfg.bits_lo + cfg.bits_hi)
        q_rms = ((n_q * n_q - 1) / 12) ** 0.5      # of the centred values
    # RMS of the sub-scales: U{0..63}, or U{-32..31} for IQ4_XS
    sc_rms = ((sum(s * s for s in range(sc_lo, sc_lo + 64)) / 64) ** 0.5
              if cfg.superblock else 1.0)
    d0 = 1.0 / (k ** 0.5 * q_rms * sc_rms * u_rms)
    d = ((unif((n_pad, groups)) + 0.05) * d0).half().float()
    sc = (ints(sc_lo, sc_lo + 64, (n_pad, k // cfg.gs), torch.int8)
          if cfg.superblock else None)
    if cfg.lut and not cfg.superblock:             # IQ4_NL: signed d
        d = d * (ints(0, 2, (n_pad, groups), torch.int8) * 2 - 1).float()
    dmin = m = None
    if cfg.asym == "minsb":
        dmin = (d * ((n_q - 1) / 2)).half().float()
        m = sc.to(torch.uint8)
    elif cfg.asym == "min":                        # Q4_1, Q5_1: f32 m plane
        m = (-d * ((n_q - 1) / 2)).half().float()
    return QTensor(cfg, n, k, q, d, qh, sc, dmin, m)


def concat_wire(parts: list) -> QTensor:
    """Row-concatenate same-type wire QTensors (bench.host_concat)."""
    p0 = parts[0]

    def cat(f):
        arrs = [getattr(p, f) for p in parts]
        return None if arrs[0] is None else torch.cat(arrs, dim=0)

    return QTensor(p0.cfg, sum(p.n for p in parts), p0.k, cat("q"), cat("d"),
                   cat("qh"), cat("sc"), cat("dmin"), cat("m"))


def _policy(cfg: LlamaConfig, ftype: str, has_imatrix: bool = False,
            tied: bool = False) -> QuantPolicy:
    return QuantPolicy(ftype, cfg.n_layer, n_gqa=cfg.n_head // cfg.n_head_kv,
                       n_expert=max(cfg.n_expert, 1), has_imatrix=has_imatrix,
                       has_output=not tied)


def build_model(cfg: LlamaConfig, seed: int = 0, device="cuda",
                ftype: str = "Q4_K_M", layout: str = "t",
                has_imatrix: bool = False, ffn_fused: bool = False,
                tied: bool = False, depth: int | None = None):
    """(cfg', weights) of a random dense model under llama.cpp's `ftype`
    per-tensor policy, every type taken from QuantPolicy, through the
    production load pipeline: NEOX rope permutation, projection fusion,
    wire-plane drop.  Q4_K_M: Q4_K everywhere but Q6_K attn_v/ffn_down in
    the _use_more_bits layers and a Q6_K head.  IQ4_XS (at n_gqa >= 4):
    IQ4_XS (interleaved planes only), but Q5_K attn_v and ffn_down in the
    first eighth of the layers, a Q6_K head.  IQ3_XXS with an imatrix (at
    n_gqa >= 4): IQ3_XXS gate/up/down, IQ2_S attn_q/attn_k, a Q4_K attn_v,
    an IQ3_S attn_output and embedding, a Q5_K head.  layout "t": t-planes
    for every type that has them, interleaved ones for the others (the JAX
    package's default, independent of GHT_QP8); "il": interleaved planes
    for every tensor.  has_imatrix: the mixture llama-quantize writes when
    given an importance matrix.  ffn_fused: the whole-FFN megakernel layout
    (fuse_weights(ffn_fused=True)) on the layers that take it.  tied: the
    head is the token embedding (gemma), its type the head's (Q4_K_M: Q6_K)
    and its matmul planes built beside the wire planes the gather reads.
    A post_norms config (gemma2) gets its post-attention and post-FFN norm
    weights.  depth: the first `depth` layers of the full-depth model only
    (their types those of the full model's file); the config returned
    says that many layers.  device "meta": shapes without values."""
    device = resolve_device(device)
    gen = _generator(device, seed)
    policy = _policy(cfg, ftype, has_imatrix, tied)
    d = cfg.n_embd

    def draw(name, n, k):
        return random_qtensor(gen, n, k, policy.tensor_type(name, (n, k)),
                              device)

    def t(qt):
        return qt.with_fast_planes(layout).without_wire()

    nq, nkv = cfg.n_head * cfg.hd, cfg.n_head_kv * cfg.hd
    layers = []
    for il in range(depth or cfg.n_layer):
        p = f"blk.{il}."
        gate = draw(p + "ffn_gate.weight", cfg.n_ff, d)
        up = draw(p + "ffn_up.weight", cfg.n_ff, d)
        qkv = [draw(p + "attn_q.weight", nq, d),
               draw(p + "attn_k.weight", nkv, d),
               draw(p + "attn_v.weight", nkv, d)]
        lw = {
            "attn_norm": torch.ones(d, dtype=torch.float32, device=device),
            "wo": t(draw(p + "attn_output.weight", d, nq)),
            "ffn_norm": torch.ones(d, dtype=torch.float32, device=device),
            "ffn_down": t(draw(p + "ffn_down.weight", d, cfg.n_ff)),
            "w_gateup": t(concat_wire([gate, up])),
        }
        if cfg.post_norms:
            lw["post_attn_norm"] = torch.ones(d, dtype=torch.float32,
                                              device=device)
            lw["post_ffn_norm"] = torch.ones(d, dtype=torch.float32,
                                             device=device)
        if all(w.cfg == qkv[0].cfg for w in qkv):
            lw["wqkv"] = t(concat_wire(qkv))
        else:
            # wire kept until fuse_weights has concatenated wq and wk: at
            # widths that pad the planes' lanes it rebuilds from the wire
            for key, w in zip(("wq", "wk", "wv"), qkv):
                lw[key] = w.with_fast_planes(layout)
        layers.append(lw)
        del gate, up, qkv
    # embeddings are gather-only: wire planes, no matmul planes
    tok_embd = draw("token_embd.weight", cfg.n_vocab, d)
    weights = {
        "tok_embd": tok_embd,
        "output_norm": torch.ones(d, dtype=torch.float32, device=device),
        "output": t(tok_embd if tied else draw("output.weight", cfg.n_vocab,
                                               d)),
        "layers": layers,
    }
    cfg = replace(cfg, n_layer=len(layers))
    weights, cfg = permute_rope_neox(weights, cfg)
    weights = drop_wire_planes(fuse_weights(weights, cfg, ffn_fused=ffn_fused))
    return cfg, weights


def build_8b(seed: int = 0, device="cuda", depth: int | None = None):
    """Llama-3-8B Q4_K_M, all 32 layers at full width (bench.py:76-79);
    depth, as for every build function here: the first `depth` layers
    only."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device,
                       depth=depth)


def build_8b_il(seed: int = 0, device="cuda", ffn_fused: bool = False,
                depth: int | None = None):
    """Llama-3-8B Q4_K_M, all 32 layers at full width, on the interleaved
    layout everywhere; with ffn_fused, every layer in the whole-FFN
    megakernel layout (K9 at decode)."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device,
                       layout="il", ffn_fused=ffn_fused, depth=depth)


def build_gemma2_9b(layout: str = "t", seed: int = 0, device="cuda"):
    """Gemma-2-9B Q4_K_M, all 42 layers at full width, the head tied to
    the Q6_K embedding, on the default layouts ("t") or interleaved
    everywhere ("il")."""
    return build_model(LlamaConfig(**GEMMA2_9B), seed=seed, device=device,
                       layout=layout, tied=True)


def build_8b_iq4xs(seed: int = 0, device="cuda", depth: int | None = None):
    """Llama-3-8B IQ4_XS, all 32 layers at full width."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device,
                       ftype="IQ4_XS", depth=depth)


def build_8b_iq3xxs(layout: str = "t", seed: int = 0, device="cuda",
                    depth: int | None = None):
    """Llama-3-8B IQ3_XXS (made with an imatrix), all 32 layers at full
    width, on the default layouts ("t") or interleaved everywhere ("il")."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device,
                       ftype="IQ3_XXS", layout=layout, has_imatrix=True,
                       depth=depth)


def build_moe_model(cfg: LlamaConfig, seed: int = 0, device="cuda",
                    ftype: str = "Q5_K_M", layout: str = "t",
                    has_imatrix: bool = False, depth: int | None = None):
    """(cfg', weights) of a random MoE model under llama.cpp's `ftype`
    per-tensor policy, through the production load pipeline.  At
    n_expert=8, Q5_K_M is Mixtral's mixture of the second slice (Q5_K
    attn_q/attn_output and expert gate/up stacks, Q8_0 attn_k/attn_v,
    ffn_down stacks Q6_K in the _use_more_bits layers and Q5_K elsewhere,
    Q6_K head, Q5_K embedding kept as wire, f32 router); IQ4_XS keeps Q8_0
    attn_k/attn_v, the Q5_K attn_output and the Q6_K head, with IQ4_XS
    attn_q, gate/up stacks and embedding, and down stacks Q5_K in the first
    eighth of the layers and IQ4_XS elsewhere; Q4_K_M has Q4_K attn_q,
    gate/up stacks and embedding, Q8_0 attn_k/attn_v, Q5_K attn_output, down
    stacks Q6_K in the _use_more_bits layers and Q4_K elsewhere, a Q6_K
    head; IQ3_XXS with an imatrix has IQ3_XXS expert stacks (down
    included), IQ2_S attn_q, Q8_0 attn_k/attn_v, Q5_K attn_output and head,
    an IQ3_S embedding.  layout and has_imatrix as in build_model.  Each
    tensor is drawn, given
    its matmul planes and stripped of its wire before the next is drawn, so
    the peak above the model is one tensor's transient (a full-width expert
    stack's int32 values are 1.9 GB).  depth and device "meta" as in
    build_model."""
    device = resolve_device(device)
    gen = _generator(device, seed)
    E, d, nff = cfg.n_expert, cfg.n_embd, cfg.n_ff_exp or cfg.n_ff
    policy = _policy(cfg, ftype, has_imatrix)

    def qt(name, n, k, wire=False):
        w = random_qtensor(gen, n, k, policy.tensor_type(name, (n, k)), device)
        return w if wire else w.with_fast_planes(layout).without_wire()

    def ones():
        return torch.ones(d, dtype=torch.float32, device=device)

    nq, nkv = cfg.n_head * cfg.hd, cfg.n_head_kv * cfg.hd
    layers = []
    for il in range(depth or cfg.n_layer):
        p = f"blk.{il}."
        layers.append({
            "attn_norm": ones(),
            "wq": qt(p + "attn_q.weight", nq, d),
            "wk": qt(p + "attn_k.weight", nkv, d),
            "wv": qt(p + "attn_v.weight", nkv, d),
            "wo": qt(p + "attn_output.weight", d, nq),
            "ffn_norm": ones(),
            # router logits of about unit spread on a unit-RMS input
            "ffn_gate_inp": torch.randn(E, d, generator=gen, device=device)
            * (1.0 / d ** 0.5),
            "ffn_gate_exps": qt(p + "ffn_gate_exps.weight", E * nff, d),
            "ffn_up_exps": qt(p + "ffn_up_exps.weight", E * nff, d),
            "ffn_down_exps": qt(p + "ffn_down_exps.weight", E * d, nff),
        })
    weights = {
        "tok_embd": qt("token_embd.weight", cfg.n_vocab, d, wire=True),
        "output_norm": ones(),
        "output": qt("output.weight", cfg.n_vocab, d),
        "layers": layers,
    }
    cfg = replace(cfg, n_layer=len(layers))
    weights, cfg = permute_rope_neox(weights, cfg)
    return cfg, drop_wire_planes(fuse_weights(weights, cfg))


def build_mixtral(seed: int = 0, device="cuda", depth: int | None = None):
    """Mixtral-8x7B Q5_K_M, all 32 layers at full width."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device, depth=depth)


def build_mixtral_iq4xs(seed: int = 0, device="cuda", depth: int | None = None):
    """Mixtral-8x7B IQ4_XS, all 32 layers at full width."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device, ftype="IQ4_XS", depth=depth)


def build_mixtral_iq3xxs(layout: str = "t", seed: int = 0, device="cuda",
                         depth: int | None = None):
    """Mixtral-8x7B IQ3_XXS (made with an imatrix), all 32 layers at full
    width, on the default layouts ("t") or interleaved everywhere ("il")."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device, ftype="IQ3_XXS", layout=layout,
                           has_imatrix=True, depth=depth)


def build_mixtral_q4km_il(seed: int = 0, device="cuda", depth: int | None = None):
    """Mixtral-8x7B Q4_K_M, all 32 layers at full width, on the interleaved
    layout everywhere."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device, ftype="Q4_K_M", layout="il",
                           depth=depth)


# ---------------------------------------------------------------------------
# a GGUF file of a random model (the loader's and the tokenizer's input)
# ---------------------------------------------------------------------------

#: llama.cpp's general.file_type of each ftype (llama.h, LLAMA_FTYPE_*)
FILE_TYPES = {"F16": 1, "Q4_0": 2, "Q4_1": 3, "Q8_0": 7, "Q5_0": 8,
              "Q5_1": 9, "Q2_K": 10, "Q3_K_S": 11, "Q3_K_M": 12,
              "Q3_K_L": 13, "Q4_K_S": 14, "Q4_K_M": 15, "Q5_K_S": 16,
              "Q5_K_M": 17, "Q6_K": 18, "IQ2_XXS": 19, "IQ2_XS": 20,
              "Q2_K_S": 21, "IQ3_XXS": 23, "IQ1_S": 24, "IQ4_NL": 25,
              "IQ3_S": 26, "IQ3_M": 27, "IQ2_S": 28, "IQ2_M": 29,
              "IQ4_XS": 30, "IQ1_M": 31, "BF16": 32, "TQ1_0": 36,
              "TQ2_0": 37}


def _f16_bytes(d):
    """f16-exact f32 values [...] -> their little-endian f16 bytes [n, 2]."""
    return d.reshape(-1, 1).to(torch.float16).view(torch.uint8)


def pack_k4_scales(ls, lm):
    """Eight 6-bit (scale, min) pairs a super-block, [nb, 8] each -> the 12
    bytes of block_q4_K.scales [nb, 12] (the inverse of
    quant.pack._unpack_k4_scales)."""
    ls, lm = ls.to(torch.int32), lm.to(torch.int32)
    sc = torch.zeros((ls.shape[0], 12), dtype=torch.int32, device=ls.device)
    sc[:, 0:4] = ls[:, 0:4]
    sc[:, 4:8] = lm[:, 0:4]
    for j in range(4, 8):
        sc[:, j + 4] = (ls[:, j] & 0xF) | ((lm[:, j] & 0xF) << 4)
        sc[:, j - 4] |= (ls[:, j] >> 4) << 6
        sc[:, j] |= (lm[:, j] >> 4) << 6
    return sc.to(torch.uint8)


#: the types wire_blocks encodes (write_gguf draws their planes)
WIRE_BLOCK_TYPES = (GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K)


def wire_blocks(qt: QTensor):
    """The GGUF wire bytes (uint8, flat) of a Q4_K, Q5_K or Q6_K wire-plane
    QTensor's n true rows: the inverse of quant.pack._wire_to_planes for
    those types (block_q4_K: d, dmin, 12 scale bytes, 128 nibble bytes;
    block_q5_K: the same with 32 high-bit bytes before the nibbles;
    block_q6_K: 128 low-nibble bytes, 64 high-bit bytes, 16 int8 scales,
    d)."""
    cfg, N, K = qt.cfg, qt.n, qt.k
    nb = N * K // 256
    q = unpack_bits(qt.q[:N], cfg.bits_lo, K).to(torch.int32)
    if cfg.bits_hi:
        q |= unpack_bits(qt.qh[:N], cfg.bits_hi, K).to(torch.int32) << cfg.bits_lo
    if cfg.qtype == GGMLType.Q4_K:
        l2 = q.reshape(nb, 4, 2, 32)
        qs = (l2[:, :, 0] | (l2[:, :, 1] << 4)).reshape(nb, 128)
        parts = [_f16_bytes(qt.d[:N]), _f16_bytes(qt.dmin[:N]),
                 pack_k4_scales(qt.sc[:N].reshape(nb, 8),
                                qt.m[:N].reshape(nb, 8)), qs.to(torch.uint8)]
    elif cfg.qtype == GGMLType.Q5_K:
        l2 = q.reshape(nb, 4, 2, 32)
        lo = l2 & 0xF
        ql = (lo[:, :, 0] | (lo[:, :, 1] << 4)).reshape(nb, 128)
        hb = (q.reshape(nb, 8, 32) >> 4) & 1
        qh = sum(hb[:, j] << j for j in range(8))
        parts = [_f16_bytes(qt.d[:N]), _f16_bytes(qt.dmin[:N]),
                 pack_k4_scales(qt.sc[:N].reshape(nb, 8),
                                qt.m[:N].reshape(nb, 8)),
                 qh.to(torch.uint8), ql.to(torch.uint8)]
    elif cfg.qtype == GGMLType.Q6_K:
        q6 = q.reshape(nb, 2, 4, 32)
        lo, hi = q6 & 0xF, q6 >> 4
        ql = torch.stack([lo[:, :, 0] | (lo[:, :, 2] << 4),
                          lo[:, :, 1] | (lo[:, :, 3] << 4)], dim=2)
        qh = (hi[:, :, 0] | (hi[:, :, 1] << 2) | (hi[:, :, 2] << 4)
              | (hi[:, :, 3] << 6))
        parts = [ql.reshape(nb, 128).to(torch.uint8),
                 qh.reshape(nb, 64).to(torch.uint8),
                 qt.sc[:N].reshape(nb, 16).to(torch.int8).view(torch.uint8),
                 _f16_bytes(qt.d[:N])]
    else:
        raise NotImplementedError(f"wire_blocks: {cfg.qtype.name}")
    return torch.cat(parts, dim=1).reshape(-1)


#: the pieces of the synthetic vocabulary's words: consonant-vowel syllables
_CONSONANTS = "bcdfghjklmnprstvwz"
_VOWELS = "aeiou"
_WORDS_EN = ("the of and to in is it that was for on are as with his they "
             "at be this have from or one had by word but not what all were "
             "we when your can said there use an each which she do how their "
             "if will up other about out many then them these so some her "
             "would make like him into time has look two more write go see "
             "number no way could people my than first water been call who "
             "oil its now find long down day did get come made may part "
             "hello world model token text file card").split()


def llama_bpe_vocab(n_vocab: int = 128256, n_words: int = 1500,
                    seed: int = 0) -> tuple[dict, list[str]]:
    """(GGUF tokenizer fields, words) of a deterministic byte-level BPE
    vocabulary of Llama-3's size and special ids, for the llama-bpe
    pre-tokenizer: the 256 byte tokens (GPT-2's byte-to-unicode map),
    merges that build every prefix of each word and of its space-led form
    ("Ġ" + word; `words`: a few English words and n_words pseudo-words of
    2-3 syllables drawn from `seed`) and of the 2- and 3-digit numbers,
    <|begin_of_text|> = 128000, <|end_of_text|> = 128001 (the EOS, as in
    the base model's file), <|start_header_id|> / <|end_header_id|> =
    128006 / 128007, <|eot_id|> = 128009, and CONTROL tokens named
    <|reserved_special_token_i|> filling every other id.  Each word and
    space-led word is one token, so a text of k words separated by single
    spaces encodes to k + 1 tokens (with the BOS)."""
    from ..tokenizer.bpe import bytes_to_unicode
    from ..tokenizer.vocab import TokenType

    b2u = bytes_to_unicode()
    rng = np.random.default_rng(seed)
    words = list(dict.fromkeys(_WORDS_EN))
    seen = set(words)
    while len(words) < len(_WORDS_EN) + n_words:
        n_syl = int(rng.integers(2, 4))
        w = "".join(_CONSONANTS[rng.integers(len(_CONSONANTS))]
                    + _VOWELS[rng.integers(len(_VOWELS))]
                    for _ in range(n_syl))
        if w not in seen:
            seen.add(w)
            words.append(w)
    tokens = [b2u[b] for b in range(256)]
    have = set(tokens)
    merges = []

    def chain(piece: str):
        for i in range(2, len(piece) + 1):
            if piece[:i] not in have:
                merges.append(f"{piece[:i - 1]} {piece[i - 1]}")
                tokens.append(piece[:i])
                have.add(piece[:i])

    for n in range(10, 1000):
        chain(str(n))
    for w in words:
        chain(w)
        chain(b2u[ord(" ")] + w)
    specials = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
                128009: "<|eot_id|>"}
    if len(tokens) >= min(specials):
        raise ValueError(f"{len(tokens)} normal tokens reach the special ids")
    types = [int(TokenType.NORMAL)] * len(tokens)
    k = 0
    for i in range(len(tokens), n_vocab):
        if i in specials:
            tokens.append(specials[i])
        else:
            tokens.append(f"<|reserved_special_token_{k}|>")
            k += 1
        types.append(int(TokenType.CONTROL))
    fields = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama-bpe",
              "tokenizer.ggml.tokens": tokens,
              "tokenizer.ggml.token_type": types,
              "tokenizer.ggml.merges": merges,
              "tokenizer.ggml.bos_token_id": 128000,
              "tokenizer.ggml.eos_token_id": 128001}
    return fields, words


def gguf_tensor_names(cfg: LlamaConfig) -> list[tuple[str, tuple[int, ...]]]:
    """(GGUF name, numpy shape) of every tensor of a dense llama model, in
    the order write_gguf draws and writes them (token_embd first)."""
    d, nq, nkv = cfg.n_embd, cfg.n_head * cfg.hd, cfg.n_head_kv * cfg.hd
    out = [("token_embd.weight", (cfg.n_vocab, d)),
           ("output_norm.weight", (d,)), ("output.weight", (cfg.n_vocab, d))]
    for il in range(cfg.n_layer):
        p = f"blk.{il}."
        out += [(p + "attn_norm.weight", (d,)), (p + "attn_q.weight", (nq, d)),
                (p + "attn_k.weight", (nkv, d)), (p + "attn_v.weight", (nkv, d)),
                (p + "attn_output.weight", (d, nq)),
                (p + "ffn_norm.weight", (d,)),
                (p + "ffn_gate.weight", (cfg.n_ff, d)),
                (p + "ffn_up.weight", (cfg.n_ff, d)),
                (p + "ffn_down.weight", (d, cfg.n_ff))]
    return out


def _file_policy(cfg: LlamaConfig, ftype: str, has_imatrix: bool):
    """The ftype's per-tensor type of a written file: the full-depth
    QuantPolicy's, and F32 for every vector (an F16 file's norms too)."""
    policy = _policy(cfg, ftype, has_imatrix)

    def ttype(name, shape):
        return (GGMLType.F32 if len(shape) == 1
                else policy.tensor_type(name, shape))

    return ttype


def gguf_data_bytes(cfg: LlamaConfig, ftype: str = "Q4_K_M",
                    has_imatrix: bool = False,
                    depth: int | None = None) -> int:
    """The tensor bytes of write_gguf's file (its header and alignment
    padding come on top)."""
    from ..quant.formats import row_size

    ttype = _file_policy(cfg, ftype, has_imatrix)
    names = gguf_tensor_names(replace(cfg, n_layer=depth or cfg.n_layer))
    return sum(row_size(ttype(n, sh), sh[-1]) * (int(np.prod(sh)) // sh[-1])
               for n, sh in names)


#: the f16 fields of a block that random_wire sets: (byte offset, value a
#: unit of the block's scale d); where the wire holds a min, the min that
#: centres the values (Q4_1, Q5_1: m = -d * qmax / 2; Q2_K: dmin = d * 3/2
#: beside sub-block mins equal to the sub-scales).  Every other type keeps
#: d alone at byte 0, but IQ1_M, whose d is the top nibbles of its four
#: scale words.
_SCALE_FIELDS = {
    GGMLType.Q4_1: ((0, 1.0), (2, -7.5)), GGMLType.Q5_1: ((0, 1.0), (2, -15.5)),
    GGMLType.Q2_K: ((80, 1.0), (82, 1.5)), GGMLType.Q3_K: ((108, 1.0),),
    GGMLType.TQ1_0: ((52, 1.0),), GGMLType.TQ2_0: ((64, 1.0),),
}

#: types whose scale takes a random sign (as random_qtensor draws them)
_SIGNED_D = (GGMLType.IQ4_NL, GGMLType.TQ1_0, GGMLType.TQ2_0)


def random_wire(gen: torch.Generator, n: int, k: int, qtype: GGMLType,
                device):
    """Random GGUF wire bytes (uint8, flat) of an [n, k] weight of any
    quantized type: uniform bytes, then every block's f16 scale fields set
    to finite values, drawn as random_qtensor draws d (uniform over [0.05,
    1.05] times a size that gives the weights an RMS of about 1/sqrt(k);
    the size from the dequantized RMS of the first rows at a unit scale)
    and, where the wire holds a min, the min that centres the values.
    Uniform bytes alone give NaN and inf scales."""
    from ..ops.qmatmul import dequantize
    from ..quant.formats import TYPE_TRAITS
    from ..quant.pack import pack_tensor

    tr = TYPE_TRAITS[qtype]
    nb = n * k // tr.block_size
    b = torch.randint(0, 256, (nb, tr.type_size), dtype=torch.uint8,
                      device=device, generator=gen)
    if qtype == GGMLType.Q2_K:
        b[:, 0:16] = (b[:, 0:16] & 0xF) * 17        # each min = its scale

    def put(u):
        if qtype == GGMLType.IQ1_M:
            d16 = u.half().view(torch.int16).to(torch.int32) & 0xFFFF
            for j in range(4):
                b[:, 49 + 2 * j] = ((b[:, 49 + 2 * j] & 0xF)
                                    | (((d16 >> (4 * j)) & 0xF) << 4)).to(torch.uint8)
            return
        for off, f in _SCALE_FIELDS.get(qtype, ((0, 1.0),)):
            b[:, off:off + 2] = (u * f).half().view(torch.uint8).reshape(nb, 2)

    put(torch.ones(nb, device=device))
    rows = min(n, 64)
    w = dequantize(pack_tensor(b[:rows * nb // n].reshape(-1), qtype,
                               (rows, k), n_align=1))
    rms = float(w.double().pow(2).mean().sqrt())
    u_rms = (1 / 3 + 0.05 + 0.05 ** 2) ** 0.5      # of U(0.05, 1.05)
    u = (torch.rand(nb, device=device, generator=gen) + 0.05) / (
        k ** 0.5 * rms * u_rms)
    if qtype in _SIGNED_D:
        u = u * (torch.randint(0, 2, (nb,), device=device, generator=gen)
                 * 2 - 1)
    put(u)
    return b.reshape(-1)


def draw_gguf_tensors(cfg: LlamaConfig, ftype: str = "Q4_K_M", seed: int = 0,
                      device="cuda", has_imatrix: bool = False,
                      depth: int | None = None):
    """Yield (GGUF name, tensor) for each tensor of a random dense model, in
    gguf_tensor_names' order, drawn on `device` from one generator seeded
    with `seed`, each of the ftype's per-tensor type (QuantPolicy at cfg's
    full depth, has_imatrix the mixture llama-quantize writes with an
    importance matrix; `depth`: the first layers only): a wire QTensor
    (random_qtensor) for the types wire_blocks encodes, the flat wire bytes
    (random_wire) for every other quantized type, an f16 matrix of RMS
    1/sqrt(k) for F16, a vector of ones for the norms.  The first item is
    the token embedding, so a caller re-draws it alone by taking one item."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ttype = _file_policy(cfg, ftype, has_imatrix)
    for name, shape in gguf_tensor_names(replace(cfg, n_layer=depth
                                                 or cfg.n_layer)):
        t = ttype(name, shape)
        if len(shape) == 1:
            yield name, torch.ones(shape, dtype=torch.float32, device=device)
        elif t in WIRE_BLOCK_TYPES:
            yield name, random_qtensor(gen, shape[0], shape[1], t, device)
        elif t in (GGMLType.F16, GGMLType.BF16, GGMLType.F32):
            w = torch.randn(shape, generator=gen, device=device) * shape[1] ** -0.5
            yield name, w.to({GGMLType.F16: torch.float16,
                              GGMLType.BF16: torch.bfloat16}.get(t, torch.float32))
        else:
            yield name, random_wire(gen, shape[0], shape[1], t, device)


class _Appender:
    """A file-like sink that appends to a bytearray."""

    def __init__(self, buf: bytearray):
        self.write = buf.extend


def write_gguf(target, cfg: LlamaConfig, ftype: str = "Q4_K_M",
               seed: int = 0, vocab_fields: dict | None = None,
               device="cuda", has_imatrix: bool = False,
               depth: int | None = None) -> dict:
    """Write a random dense llama model as a GGUF file: `target` is a path
    or a bytearray the file's bytes are appended to.  The tensors are
    draw_gguf_tensors' (under the GGUF names and the ftype's per-tensor
    types; the types wire_blocks encodes drawn as build_model draws their
    planes, the others as random wire bytes with finite centred scales),
    encoded on `device` and written in the file's "norm" rope order as
    drawn (the loader's fuse=True pipeline permutes them to NEOX); the
    metadata is general.* and llama.* of cfg (block_count: `depth` when
    given, the first layers of the full-depth file), and vocab_fields the
    tokenizer's (llama_bpe_vocab's fields, or none).  Returns {"bytes",
    "seconds"} of the write."""
    from ..gguf.writer import GGUFWriter

    if cfg.n_expert:
        raise NotImplementedError("write_gguf writes dense models")
    t0 = time.perf_counter()
    w = GGUFWriter()
    w.add("general.architecture", "llama")
    w.add("general.name", f"synthetic {depth or cfg.n_layer}-layer llama, "
                          f"seed {seed}")
    w.add("general.file_type", FILE_TYPES[ftype])
    for key, val in (("vocab_size", cfg.n_vocab),
                     ("context_length", cfg.n_ctx_train),
                     ("embedding_length", cfg.n_embd),
                     ("block_count", depth or cfg.n_layer),
                     ("feed_forward_length", cfg.n_ff),
                     ("rope.dimension_count", cfg.hd),
                     ("attention.head_count", cfg.n_head),
                     ("attention.head_count_kv", cfg.n_head_kv)):
        w.add(f"llama.{key}", int(val))
    w.add("llama.rope.freq_base", float(cfg.rope_theta))
    w.add("llama.attention.layer_norm_rms_epsilon", float(cfg.rms_eps))
    for key, val in (vocab_fields or {}).items():
        w.add(key, val)
    ttype = _file_policy(cfg, ftype, has_imatrix)
    shapes = dict(gguf_tensor_names(replace(cfg, n_layer=depth or cfg.n_layer)))
    for name, t in draw_gguf_tensors(cfg, ftype, seed, device, has_imatrix,
                                     depth):
        if isinstance(t, QTensor):
            raw = wire_blocks(t)
        elif t.dim() == 2:                      # an F16 matrix
            raw = t.contiguous().view(torch.uint8).reshape(-1)
        elif t.dtype == torch.uint8:            # random_wire's bytes
            raw = t
        else:                                   # a norm
            w.add_tensor(name, t.cpu().numpy())
            continue
        w.add_tensor(name, raw.cpu().numpy(), ttype(name, shapes[name]),
                     raw_ne=tuple(reversed(shapes[name])))
        del t, raw
    if isinstance(target, bytearray):
        start = len(target)
        w.write(_Appender(target))
        n = len(target) - start
    else:
        w.write_file(os.fspath(target))
        n = os.path.getsize(target)
    return {"bytes": n, "seconds": time.perf_counter() - t0}
