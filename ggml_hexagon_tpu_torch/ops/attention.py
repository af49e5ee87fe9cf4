"""Prefill attention over the cache: the flash algorithm in plain PyTorch.

Counterpart of ggml_hexagon_tpu/ops/attention.py:136-199
(`flash_attention_cache`), which is a `lax.scan`, not a Pallas kernel: an
online softmax over KV chunks, so nothing O(T x S) materializes.  The
reference's numerics are kept (f32 scores, per-chunk running max and
denominator, int-quantized caches dequantized in-chunk by scaling scores
and probabilities).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_cache(qg, k, v, pos_b, T: int, scale: float,
                          swa: int = 0, logit_cap: float = 0.0,
                          chunk: int = 512, k_scale=None, v_scale=None):
    """qg [B, Hkv, G, T, D] grouped queries; k/v [B, Hkv, S, D]; pos_b
    scalar or [B] row offsets.  Token t of row b attends slot s iff
    s <= pos_b + t (and pos_b + t - s < swa when swa > 0).  k_scale /
    v_scale [B, S]: per-slot scales of an int-quantized cache.  Returns
    [B, Hkv, G, T, D] f32."""
    B, Hkv, G, T_, D = qg.shape
    S = k.shape[2]
    if S % chunk:
        raise ValueError(f"cache of {S} slots is not a multiple of chunk {chunk}")
    dev = qg.device
    quant = k_scale is not None
    qf = qg.to(torch.float32) * scale
    pos = torch.as_tensor(pos_b, dtype=torch.int32, device=dev).reshape(
        -1, 1, 1, 1, 1)
    t_idx = torch.arange(T, dtype=torch.int32, device=dev)[
        None, None, None, :, None]
    m_run = torch.full((B, Hkv, G, T), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, Hkv, G, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, T, D), dtype=torch.float32, device=dev)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bhgtd,bhsd->bhgts", qf, k[:, :, sl].to(torch.float32))
        if quant:
            s = s * k_scale[:, None, None, None, sl]
        if logit_cap:
            s = torch.tanh(s / logit_cap) * logit_cap
        s_idx = c * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)[
            None, None, None, None, :]
        allowed = s_idx <= (pos + t_idx)
        if swa:
            allowed = allowed & ((pos + t_idx) - s_idx < swa)
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        if quant:
            p = p * v_scale[:, None, None, None, sl]
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgts,bhsd->bhgtd", p, v[:, :, sl].to(torch.float32))
        m_run = m_new
    return acc / torch.clamp_min(l_run, 1e-30)[..., None]
