"""Random Llama-3-8B and Mixtral-8x7B models with the exact plane layout of
a GGUF file of a given llama.cpp mixture (Q4_K_M, Q5_K_M, IQ4_XS, IQ3_XXS
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
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..quant.formats import GGMLType
from ..quant.pack import QCONFIGS, QTensor, drop_wire_planes
from ..quant.policy import QuantPolicy
from .fuse import fuse_weights, permute_rope_neox
from ..ops.qmm_qp8 import _CODE_ALPHABETS, KVALUES_IQ4NL, decode_codes
from .llama import LlamaConfig

LLAMA3_8B = dict(n_vocab=128256, n_embd=4096, n_layer=32, n_head=32,
                 n_head_kv=8, n_ff=14336, rope_theta=500000.0,
                 n_ctx_train=8192)

#: mistralai/Mixtral-8x7B-v0.1 config.json (rope "norm", which
#: permute_rope_neox turns into neox)
MIXTRAL_8X7B = dict(n_vocab=32000, n_embd=4096, n_layer=32, n_head=32,
                    n_head_kv=8, n_ff=14336, n_expert=8, n_expert_used=2,
                    rope_theta=1e6, rms_eps=1e-5, n_ctx_train=32768)


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


def _policy(cfg: LlamaConfig, ftype: str,
            has_imatrix: bool = False) -> QuantPolicy:
    return QuantPolicy(ftype, cfg.n_layer, n_gqa=cfg.n_head // cfg.n_head_kv,
                       n_expert=max(cfg.n_expert, 1), has_imatrix=has_imatrix)


def build_model(cfg: LlamaConfig, seed: int = 0, device="cuda",
                ftype: str = "Q4_K_M", layout: str = "t",
                has_imatrix: bool = False, ffn_fused: bool = False):
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
    (fuse_weights(ffn_fused=True)) on the layers that take it."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    policy = _policy(cfg, ftype, has_imatrix)
    d = cfg.n_embd

    def draw(name, n, k):
        return random_qtensor(gen, n, k, policy.tensor_type(name, (n, k)),
                              device)

    def t(qt):
        return qt.with_fast_planes(layout).without_wire()

    nq, nkv = cfg.n_head * cfg.hd, cfg.n_head_kv * cfg.hd
    layers = []
    for il in range(cfg.n_layer):
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
        if all(w.cfg == qkv[0].cfg for w in qkv):
            lw["wqkv"] = t(concat_wire(qkv))
        else:
            # wire kept until fuse_weights has concatenated wq and wk: at
            # widths that pad the planes' lanes it rebuilds from the wire
            for key, w in zip(("wq", "wk", "wv"), qkv):
                lw[key] = w.with_fast_planes(layout)
        layers.append(lw)
        del gate, up, qkv
    weights = {
        # embeddings are gather-only: wire planes, no matmul planes
        "tok_embd": draw("token_embd.weight", cfg.n_vocab, d),
        "output_norm": torch.ones(d, dtype=torch.float32, device=device),
        "output": t(draw("output.weight", cfg.n_vocab, d)),
        "layers": layers,
    }
    weights, cfg = permute_rope_neox(weights, cfg)
    weights = drop_wire_planes(fuse_weights(weights, cfg, ffn_fused=ffn_fused))
    return cfg, weights


def build_8b(seed: int = 0, device="cuda"):
    """Llama-3-8B Q4_K_M, all 32 layers at full width (bench.py:76-79)."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device)


def build_8b_il(seed: int = 0, device="cuda", ffn_fused: bool = False):
    """Llama-3-8B Q4_K_M, all 32 layers at full width, on the interleaved
    layout everywhere; with ffn_fused, every layer in the whole-FFN
    megakernel layout (K9 at decode)."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device,
                       layout="il", ffn_fused=ffn_fused)


def build_8b_iq4xs(seed: int = 0, device="cuda"):
    """Llama-3-8B IQ4_XS, all 32 layers at full width."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device,
                       ftype="IQ4_XS")


def build_8b_iq3xxs(layout: str = "t", seed: int = 0, device="cuda"):
    """Llama-3-8B IQ3_XXS (made with an imatrix), all 32 layers at full
    width, on the default layouts ("t") or interleaved everywhere ("il")."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device,
                       ftype="IQ3_XXS", layout=layout, has_imatrix=True)


def build_moe_model(cfg: LlamaConfig, seed: int = 0, device="cuda",
                    ftype: str = "Q5_K_M", layout: str = "t",
                    has_imatrix: bool = False):
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
    stack's int32 values are 1.9 GB)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E, d, nff = cfg.n_expert, cfg.n_embd, cfg.n_ff_exp or cfg.n_ff
    policy = _policy(cfg, ftype, has_imatrix)

    def qt(name, n, k, wire=False):
        w = random_qtensor(gen, n, k, policy.tensor_type(name, (n, k)), device)
        return w if wire else w.with_fast_planes(layout).without_wire()

    def ones():
        return torch.ones(d, dtype=torch.float32, device=device)

    nq, nkv = cfg.n_head * cfg.hd, cfg.n_head_kv * cfg.hd
    layers = []
    for il in range(cfg.n_layer):
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
    weights, cfg = permute_rope_neox(weights, cfg)
    return cfg, drop_wire_planes(fuse_weights(weights, cfg))


def build_mixtral(seed: int = 0, device="cuda"):
    """Mixtral-8x7B Q5_K_M, all 32 layers at full width."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device)


def build_mixtral_iq4xs(seed: int = 0, device="cuda"):
    """Mixtral-8x7B IQ4_XS, all 32 layers at full width."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device, ftype="IQ4_XS")


def build_mixtral_iq3xxs(layout: str = "t", seed: int = 0, device="cuda"):
    """Mixtral-8x7B IQ3_XXS (made with an imatrix), all 32 layers at full
    width, on the default layouts ("t") or interleaved everywhere ("il")."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device, ftype="IQ3_XXS", layout=layout,
                           has_imatrix=True)


def build_mixtral_q4km_il(seed: int = 0, device="cuda"):
    """Mixtral-8x7B Q4_K_M, all 32 layers at full width, on the interleaved
    layout everywhere."""
    return build_moe_model(LlamaConfig(**MIXTRAL_8X7B), seed=seed,
                           device=device, ftype="Q4_K_M", layout="il")
