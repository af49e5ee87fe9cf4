"""KV-cache manipulation: the context shift.

Counterpart of ggml_hexagon_tpu/runtime/kv_ops.py:28-70 (the reference's
llama_kv_self_seq_add + build_kv_self_shift): the evicted slots are dropped,
the rest move down, and the cached K, stored rotated, is re-rotated by the
position delta (one incremental rotation, not a re-RoPE).  Truncation needs
no op here (masking hides slots beyond n_past); state save/load and the
self-extend re-rotation wait for a later slice.
"""
from __future__ import annotations

import torch

from ..models.llama import LlamaConfig, _kv_quantize, kv_bits
from ..ops.basic import apply_rope
from ..ops.decode_attn import pack_int4, unpack_int4


def kv_dequant(kv: dict, name: str):
    """A cache plane ("k" or "v") as f32 values [L, B, S, W]: bf16 as it
    is, q8_0 / q4_0 (packed 4-bit values unpacked) times the per-row scales
    k_d / v_d."""
    bits = kv_bits(kv)
    q = kv[name]
    if bits == 16:
        return q.to(torch.float32)
    if bits == 4:
        q = unpack_int4(q)
    return q.to(torch.float32) * kv[name + "_d"][..., None]


def kv_shift(cfg: LlamaConfig, kv: dict, n_keep: int, n_discard: int,
             n_past=None) -> dict:
    """Discard cache slots [n_keep, n_keep+n_discard) and move the rest
    down, IN PLACE on kv (bf16, q8_0 or q4_0; [L, B, S, Hkv*hd] values).

    K is re-rotated by -n_discard (the positions of the moved tokens
    decrease); a quantized K is dequantized, rotated in f32 and quantized
    again (a q4_0 cache unpacked and repacked), V and its scales move as
    they are.  Slots beyond S - n_discard keep stale data, masked off by
    attention; the caller rewinds n_past by n_discard (n_past is accepted
    for the JAX signature and not read).  Returns kv."""
    k, v = kv["k"], kv["v"]
    src = n_keep + n_discard
    bits = kv_bits(kv)
    H = max(cfg.n_head_kv_max, 1)
    D = cfg.hd
    if bits == 16:
        moved_k = k[:, :, src:].to(torch.float32)
    else:
        moved_k = kv_dequant({"k": k[:, :, src:],
                              "k_d": kv["k_d"][:, :, src:]}, "k")
    L, B, M = moved_k.shape[:3]
    delta = torch.full((1, M), -n_discard, dtype=torch.int32,
                       device=k.device)
    mk = apply_rope(moved_k.reshape(L * B, M, H, D), delta, cfg.rope_params)
    mk = mk.reshape(L, B, M, H * D)
    dst = slice(n_keep, n_keep + M)
    moved_v = v[:, :, src:].clone()  # source and destination overlap
    if bits == 16:
        k[:, :, dst] = mk.to(k.dtype)
        v[:, :, dst] = moved_v
        return kv
    kq, kd = _kv_quantize(mk, bits)
    if bits == 4:
        kq = pack_int4(kq)
    vd = kv["v_d"][:, :, src:].clone()
    k[:, :, dst] = kq.to(k.dtype)
    kv["k_d"][:, :, dst] = kd
    v[:, :, dst] = moved_v
    kv["v_d"][:, :, dst] = vd
    return kv
