"""A random Llama-3-8B Q4_K_M model with the exact plane layout, drawn on
the device from a seeded torch.Generator.

Counterpart of bench.py:26-125 (`random_qtensor`, `host_concat`,
`build_8b`).  The wire planes are drawn with the bench's distributions
(uniform packed bytes, f16-exact scales, 6-bit sub-scales and mins) and the
t-planes are built on the device, which takes seconds where the host build
of the reference takes minutes.  No real checkpoint is involved: the bytes
and the compute profile are those of a real Q4_K_M file.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..quant.formats import GGMLType
from ..quant.pack import QCONFIGS, QTensor, drop_wire_planes
from ..quant.policy import FTYPES, QuantPolicy
from .fuse import fuse_weights, permute_rope_neox
from .llama import LlamaConfig

LLAMA3_8B = dict(n_vocab=128256, n_embd=4096, n_layer=32, n_head=32,
                 n_head_kv=8, n_ff=14336, rope_theta=500000.0,
                 n_ctx_train=8192)


def random_qtensor(gen: torch.Generator, n: int, k: int, qtype: GGMLType,
                   device) -> QTensor:
    """Random wire planes with realistic scale magnitudes (bench.py:26)."""
    cfg = QCONFIGS[qtype]
    n_pad = (n + 127) // 128 * 128

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                             generator=gen)

    def unif(shape):
        return torch.rand(shape, dtype=torch.float32, device=device,
                          generator=gen)

    q = ints(0, 256, (n_pad, k * cfg.bits_lo // 8), torch.uint8)
    qh = (ints(0, 256, (n_pad, k * cfg.bits_hi // 8), torch.uint8)
          if cfg.bits_hi else None)
    groups = k // 256 if cfg.superblock else k // cfg.gs
    d = (unif((n_pad, groups)) * 2e-3 + 1e-4).half().float()
    sc = ints(0, 64, (n_pad, k // cfg.gs), torch.int8) if cfg.superblock else None
    dmin = ((unif((n_pad, k // 256)) * 1e-3).half().float()
            if cfg.asym == "minsb" else None)
    m = (ints(0, 64, (n_pad, k // cfg.gs), torch.uint8)
         if cfg.asym == "minsb" else None)
    return QTensor(cfg, n, k, q, d, qh, sc, dmin, m)


def concat_wire(parts: list) -> QTensor:
    """Row-concatenate same-type wire QTensors (bench.host_concat)."""
    p0 = parts[0]

    def cat(f):
        arrs = [getattr(p, f) for p in parts]
        return None if arrs[0] is None else torch.cat(arrs, dim=0)

    return QTensor(p0.cfg, sum(p.n for p in parts), p0.k, cat("q"), cat("d"),
                   cat("qh"), cat("sc"), cat("dmin"), cat("m"))


def build_model(cfg: LlamaConfig, seed: int = 0, device="cuda"):
    """(cfg', weights) of a random model under the Q4_K_M per-tensor
    policy, through the production load pipeline: NEOX rope permutation,
    projection fusion, wire-plane drop."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    policy = QuantPolicy("Q4_K_M", cfg.n_layer)
    base = FTYPES["Q4_K_M"]
    d = cfg.n_embd

    def t(qt):
        return qt.with_t_planes().without_wire()

    layers = []
    for il in range(cfg.n_layer):
        t_v = policy.tensor_type(f"blk.{il}.attn_v.weight", (d, d))
        t_dn = policy.tensor_type(f"blk.{il}.ffn_down.weight", (d, cfg.n_ff))
        gate = random_qtensor(gen, cfg.n_ff, d, base, device)
        up = random_qtensor(gen, cfg.n_ff, d, base, device)
        qkv = [random_qtensor(gen, cfg.n_head * cfg.hd, d, base, device),
               random_qtensor(gen, cfg.n_head_kv * cfg.hd, d, base, device),
               random_qtensor(gen, cfg.n_head_kv * cfg.hd, d, t_v, device)]
        lw = {
            "attn_norm": torch.ones(d, dtype=torch.float32, device=device),
            "wo": t(random_qtensor(gen, d, cfg.n_head * cfg.hd, base, device)),
            "ffn_norm": torch.ones(d, dtype=torch.float32, device=device),
            "ffn_down": t(random_qtensor(gen, d, cfg.n_ff, t_dn, device)),
            "w_gateup": t(concat_wire([gate, up])),
        }
        if all(p.cfg == qkv[0].cfg for p in qkv):
            lw["wqkv"] = t(concat_wire(qkv))
        else:
            # wire kept until fuse_weights has concatenated wq and wk: at
            # widths that pad the planes' lanes it rebuilds from the wire
            for key, p in zip(("wq", "wk", "wv"), qkv):
                lw[key] = p.with_t_planes()
        layers.append(lw)
        del gate, up, qkv
    weights = {
        # embeddings are gather-only: wire planes, no t-planes
        "tok_embd": random_qtensor(gen, cfg.n_vocab, d, base, device),
        "output_norm": torch.ones(d, dtype=torch.float32, device=device),
        "output": t(random_qtensor(gen, cfg.n_vocab, d, GGMLType.Q6_K,
                                   device)),
        "layers": layers,
    }
    weights, cfg = permute_rope_neox(weights, cfg)
    weights = drop_wire_planes(fuse_weights(weights, cfg))
    return cfg, weights


def build_8b(seed: int = 0, device="cuda"):
    """Llama-3-8B, all 32 layers at full width (bench.py:76-79)."""
    return build_model(LlamaConfig(**LLAMA3_8B), seed=seed, device=device)
