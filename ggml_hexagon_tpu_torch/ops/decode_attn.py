"""Fused single-token decode attention: rope + GQA cache attention in one
launch (K4), beside its plain PyTorch version.

Counterpart of ggml_hexagon_tpu/ops/decode_attn.py.  The caches keep a
flat head dim [B, S, Hkv*D]; the kernel reads only slots < pos, adds the
fresh token's self-term, and returns the roped k row and the v row for the
caller to write into the cache (once per step for all layers).
"""
from __future__ import annotations

import torch

from .. import kernels

NEG_INF = -1e30


def _rope_neox(x, cos, sin, n_dims: int):
    """Rotate the first n_dims of x [B, H, D] by split-half pairing;
    cos/sin [B, 1, n_dims/2]."""
    half = n_dims // 2
    x1 = x[..., :half]
    x2 = x[..., half:n_dims]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if n_dims < x.shape[-1]:
        rot = torch.cat([rot, x[..., n_dims:]], dim=-1)
    return rot


def decode_attn_plain(qkv, k_cache, v_cache, pos, cos_sin, *, Hq, Hkv, D,
                      scale, swa=0, logit_cap=0.0, n_dims=0, k_scale=None,
                      v_scale=None):
    """Plain K4 (the `_kernel_single` math): direct softmax over slots
    < pos plus the fresh row's self-term.  pos int32 [B]; cos_sin [B,
    n_dims] f32 (cos ++ sin, mscale folded) or None for no rope."""
    B, S = k_cache.shape[:2]
    G = Hq // Hkv
    n_dims = n_dims or D
    qkv = qkv.to(torch.float32)
    q = qkv[:, :Hq * D].reshape(B, Hq, D)
    k = qkv[:, Hq * D:(Hq + Hkv) * D].reshape(B, Hkv, D)
    v = qkv[:, (Hq + Hkv) * D:].reshape(B, Hkv, D)
    if cos_sin is not None:
        cos = cos_sin[:, None, :n_dims // 2]
        sin = cos_sin[:, None, n_dims // 2:]
        q = _rope_neox(q, cos, sin, n_dims)
        k = _rope_neox(k, cos, sin, n_dims)
    qs = (q * scale).reshape(B, Hkv, G, D)
    kc = k_cache.reshape(B, S, Hkv, D).to(torch.float32)
    vc = v_cache.reshape(B, S, Hkv, D).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qs, kc)
    if k_scale is not None:
        s = s * k_scale[:, None, None, :]
    s_self = torch.einsum("bhgd,bhd->bhg", qs, k)[..., None]
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
        s_self = torch.tanh(s_self / logit_cap) * logit_cap
    idx = torch.arange(S, device=qkv.device)[None, :]
    posb = pos.to(torch.int64)[:, None]
    ok = idx < posb
    if swa:
        ok = ok & (posb - idx < swa)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.maximum(s.amax(dim=-1, keepdim=True), s_self)
    p = torch.exp(s - m)
    p_self = torch.exp(s_self - m)
    l = p.sum(dim=-1, keepdim=True) + p_self
    if v_scale is not None:
        p = p * v_scale[:, None, None, :]
    acc = torch.einsum("bhgs,bshd->bhgd", p, vc) + p_self * v[:, :, None, :]
    o = acc / torch.clamp_min(l, 1e-30)
    return (o.reshape(B, Hq * D), k.reshape(B, Hkv * D),
            v.reshape(B, Hkv * D))


def decode_attn(qkv, k_cache, v_cache, pos, cos_sin, **kw):
    """K4 wrapper: the kernel for CUDA tensors, the plain version for CPU."""
    if not qkv.is_cuda:
        return decode_attn_plain(qkv, k_cache, v_cache, pos, cos_sin, **kw)
    return kernels.decode_attn(qkv, k_cache, v_cache, pos, cos_sin, **kw)


def fused_decode_attention(qkv, k_cache, v_cache, pos, inv_freq, *,
                           k_scale=None, v_scale=None, cos_sin=None,
                           Hq: int, Hkv: int, D: int, scale: float,
                           mscale: float = 1.0, swa: int = 0,
                           logit_cap: float = 0.0, n_dims: int = 0,
                           plain: bool = False):
    """qkv [B, (Hq+2*Hkv)*D] f32 projection output (pre-rope); k_cache /
    v_cache [B, S, Hkv*D] holding slots < pos (bf16, or int8 with per-row
    f32 scales k_scale/v_scale [B, S]); pos scalar or [B]; inv_freq
    [n_dims/2] (None: no rope) from which cos_sin [B, n_dims] is derived
    when not given.  Returns (attn [B, Hq*D], k_roped [B, Hkv*D], v
    [B, Hkv*D]), all f32; the caller stores k_roped / v at slot pos."""
    B = qkv.shape[0]
    dev = qkv.device
    n_dims = n_dims or D
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(
        -1).expand(B).contiguous()
    if cos_sin is None and inv_freq is not None:
        ang = pos_b[:, None].to(torch.float32) * inv_freq.to(
            device=dev, dtype=torch.float32)[None, :]
        cos_sin = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1) * mscale
    fn = decode_attn_plain if plain else decode_attn
    return fn(qkv.to(torch.float32).contiguous(), k_cache, v_cache, pos_b,
              cos_sin, Hq=Hq, Hkv=Hkv, D=D, scale=scale, swa=swa,
              logit_cap=logit_cap, n_dims=n_dims, k_scale=k_scale,
              v_scale=v_scale)
