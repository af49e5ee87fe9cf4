"""Attention beyond the fused decode kernel: the dense oracle, the flash
algorithm in plain PyTorch, masked flash attention (K11) and
single-token GQA cache attention (K12).

Counterpart of ggml_hexagon_tpu/ops/attention.py:
- `dense_attention` and `flash_attention_scan` (:30-78), plain PyTorch
  oracles;
- `flash_attention_pallas` (:81-133, `_flash_kernel`): K11, the kernel in
  csrc/attention.cu (`flash_attn`) beside its plain twin;
- `flash_attention_cache` (:136-199), a `lax.scan` there, plain PyTorch
  here: the prefill's attention over the cache;
- `decode_attention_pallas` (:206-268, `_decode_attn_kernel`): K12, the
  kernel in csrc/attention.cu (`decode_attn_gqa`) beside its plain twin.
The reference's numerics are kept: f32 scores, an additive finite mask
value NEG_INF (a row with every slot masked averages v rather than giving
NaN), per-chunk running max and denominator, int-quantized caches
dequantized in-chunk by scaling scores and probabilities.
"""
from __future__ import annotations

import torch

from .. import kernels

NEG_INF = -1e30


def dense_attention(q, k, v, mask, scale: float):
    """Oracle: softmax(scale * q k^T + mask) v.  q [B,H,T,D], k/v
    [B,H,S,D], mask [..., T, S] additive.  Returns f32 [B,H,T,D]."""
    s = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32),
                     k.to(torch.float32))
    s = s * scale + mask
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", p.to(torch.float32),
                        v.to(torch.float32))


def flash_attention_scan(q, k, v, mask, scale: float, chunk: int = 512):
    """Online-softmax attention over KV chunks.  q [B,H,T,D]; k/v
    [B,H,S,D]; mask [B|1, 1|H, T, S] additive (broadcast).  Returns
    [B,H,T,D] f32; S must be a multiple of chunk (pad and mask)."""
    B, H, T, D = q.shape
    S = k.shape[2]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk {chunk}")
    dev = q.device
    qf = q.to(torch.float32) * scale
    mask = mask.to(torch.float32)
    m_run = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=dev)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bhtd,bhsd->bhts", qf,
                         k[:, :, sl].to(torch.float32)) + mask[..., sl]
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhts,bhsd->bhtd", p, v[:, :, sl].to(torch.float32))
        m_run = m_new
    return acc / torch.clamp_min(l_run, 1e-30)[..., None]


def flash_attn_plain(q, k, v, mask, scale: float, chunk: int = 256):
    """Plain K11: `_flash_kernel` runs, per (b, h), the scan's online
    softmax over KV chunks (f32 scores, output and running state)."""
    return flash_attention_scan(q, k, v, mask, scale, chunk)


def flash_attention_pallas(q, k, v, mask, scale: float, chunk: int = 256,
                           plain=False):
    """K11: masked flash attention.  q [B,H,T,D], k/v [B,H,S,D] (f32 or
    bf16), mask additive, broadcastable to [B,H,T,S] (read through its
    broadcast strides, never materialised).  Returns f32 [B,H,T,D].  CPU
    tensors (or plain=True) take the plain twin, CUDA tensors the
    kernel."""
    S = k.shape[2]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk {chunk}")
    if plain or not q.is_cuda:
        return flash_attn_plain(q, k, v, mask, scale, chunk)
    return kernels.flash_attn(q.contiguous(), k.contiguous(), v.contiguous(),
                              mask, float(scale))


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


def _pos_rows(pos_b, B: int, device):
    return torch.as_tensor(pos_b, dtype=torch.int32, device=device).reshape(
        -1).expand(B).contiguous()


def decode_attn_gqa_plain(qg, k, v, pos_b, scale: float, swa: int = 0,
                          logit_cap: float = 0.0):
    """Plain K12 (`_decode_attn_kernel`): q * scale, scores over every
    cache slot, the logit cap, slots idx <= pos (and pos - idx < swa)
    kept, softmax, weighted sum.  qg [B,Hkv,G,1,D], k/v [B,S,Hkv,D].
    Returns f32 [B,Hkv,G,1,D]."""
    B, Hkv, G, T, D = qg.shape
    S = k.shape[1]
    q = qg.reshape(B, Hkv, G, D).to(torch.float32) * scale
    s = torch.einsum("bhgd,bshd->bhgs", q, k.to(torch.float32))
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    pos = _pos_rows(pos_b, B, qg.device).to(torch.int64)[:, None, None, None]
    idx = torch.arange(S, device=qg.device)[None, None, None, :]
    ok = idx <= pos
    if swa:
        ok = ok & (pos - idx < swa)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    return out.reshape(B, Hkv, G, 1, D)


def decode_attention_pallas(qg, k, v, pos_b, scale: float, swa: int = 0,
                            logit_cap: float = 0.0, plain=False):
    """K12: fused single-token GQA cache attention.  qg [B,Hkv,G,1,D]; k/v
    [B,S,Hkv,D] in the cache layout (bf16 or f32); pos_b scalar or [B]:
    row b attends slots idx <= pos_b[b] (and pos_b[b] - idx < swa when
    swa > 0).  Returns f32 [B,Hkv,G,1,D].  CPU tensors (or plain=True)
    take the plain twin, CUDA tensors the kernel."""
    if qg.shape[3] != 1:
        raise ValueError(f"qg {tuple(qg.shape)}: one token a row")
    if plain or not qg.is_cuda:
        return decode_attn_gqa_plain(qg, k, v, pos_b, scale, swa, logit_cap)
    B = qg.shape[0]
    return kernels.decode_attn_gqa(qg, k.contiguous(), v.contiguous(),
                                   _pos_rows(pos_b, B, qg.device),
                                   float(scale), int(swa), float(logit_cap))
