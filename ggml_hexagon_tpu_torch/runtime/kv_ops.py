"""KV-cache manipulation: the context shift.

Counterpart of ggml_hexagon_tpu/runtime/kv_ops.py:28-141: the context
shift (the reference's llama_kv_self_seq_add + build_kv_self_shift: the
evicted slots are dropped, the rest move down, and the cached K, stored
rotated, is re-rotated by the position delta, one incremental rotation, not
a re-RoPE) and the engine's state files (save_state / load_state, the JAX
package's "GHTS" .npz, which either package loads).  Truncation needs no
op here (masking hides slots beyond n_past); the self-extend re-rotation
(kv_rerotate) waits for a later slice.
"""
from __future__ import annotations

import json
import os

import numpy as np
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


#: the config fields a state file carries and load_state checks
STATE_CFG = ("n_vocab", "n_embd", "n_layer", "n_head", "n_head_kv")


def save_state(engine, f) -> None:
    """Serialize an Engine's context state (the cache planes, n_past, the
    cached tokens, the config fingerprint) as the JAX package's "GHTS"
    .npz (ggml_hexagon_tpu/runtime/kv_ops.py:73-108): bf16 values and a
    q4_0 cache's 4-bit values (unpacked from pack_int4's bytes) widened to
    f32, q8_0's int8 values and the f32 scales as they are.  f: a path or
    a binary file."""
    bits = kv_bits(engine.kv)
    planes = {}
    for name, t in engine.kv.items():
        if bits == 4 and name in ("k", "v"):
            t = unpack_int4(t).to(torch.float32)
        elif t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        planes[name] = t.cpu().numpy()
    meta = {
        "magic": "GHTS",
        "version": 1,
        "n_past": engine.n_past,
        "batch": engine.batch,
        "max_seq": engine.max_seq,
        "cfg": {k: getattr(engine.cfg, k) for k in STATE_CFG},
        "cached_tokens": list(engine.cached_tokens),
        "plane_dtypes": {n: str(a.dtype) for n, a in planes.items()},
        "kv_quant": bits != 16,
        "kv_int4": bits == 4,
    }
    close = isinstance(f, (str, os.PathLike))
    fh = open(f, "wb") if close else f
    try:
        np.savez(fh, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8), **planes)
    finally:
        if close:
            fh.close()


def load_state(engine, f) -> None:
    """Restore a state written by save_state (of either package) into an
    Engine: the magic, the config fingerprint, the shape (batch, max_seq)
    and the cache type must match the engine's, else ValueError; the
    planes go back into the engine's cache layout (a q4_0 cache's values
    packed again)."""
    z = np.load(f, allow_pickle=False)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("magic") != "GHTS":
        raise ValueError("not a saved state file")
    for key, val in meta["cfg"].items():
        if getattr(engine.cfg, key) != val:
            raise ValueError(f"state/model mismatch: {key} {val} vs "
                             f"{getattr(engine.cfg, key)}")
    if meta["max_seq"] != engine.max_seq or meta["batch"] != engine.batch:
        raise ValueError("state shape mismatch (batch/max_seq)")
    bits = kv_bits(engine.kv)
    got = 4 if meta.get("kv_int4") else 8 if meta.get("kv_quant") else 16
    if got != bits:
        raise ValueError(f"state cache type mismatch: the file holds a "
                         f"{got}-bit cache, the engine a {bits}-bit one")
    for name, dst in engine.kv.items():
        a = torch.from_numpy(np.asarray(z[name]))
        if bits == 4 and name in ("k", "v"):
            a = pack_int4(a.to(torch.int8))
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"state plane {name} {tuple(a.shape)} vs "
                             f"{tuple(dst.shape)}")
        dst.copy_(a.to(dtype=dst.dtype))
    engine.n_past = int(meta["n_past"])
    engine.cached_tokens = [int(t) for t in meta.get("cached_tokens", [])]
