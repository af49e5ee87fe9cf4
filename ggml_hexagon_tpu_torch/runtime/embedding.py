"""Embedding extraction and pooling (the llama-embedding / retrieval
analog).

Counterpart of ggml_hexagon_tpu/runtime/embedding.py: the reference's
pooling modes (llama.h enum llama_pooling_type: none/mean/cls/last) over
a decoder's final normed hidden states, which the forward's
"output.weight" tap hands over (the tap route: norms in torch, every
projection raw through K1 at <= 8 tokens or K3 above).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import forward, init_kv_cache


def extract_embeddings(cfg, weights, token_lists, pooling: str = "mean",
                       normalize: bool = True, compute_dtype=torch.bfloat16,
                       device="cuda"):
    """Embed a list of token sequences -> [n, n_embd] (pooled) numpy, or a
    list of [T, n_embd] per-token states for pooling "none".

    pooling: 'mean' | 'cls' | 'last' | 'none'."""
    if pooling not in ("mean", "cls", "last", "none"):
        raise ValueError(f"unknown pooling {pooling!r}")
    dev = resolve_device(device)
    out = []
    for ids in token_lists:
        ids = torch.as_tensor(np.asarray(ids, np.int64)[None], device=dev)
        kv = init_kv_cache(cfg, 1, max(ids.shape[1], 8), "bf16", dev)
        states = {}

        def tap(name, x, **_kw):
            if name == "output.weight":
                states["h"] = x

        forward(cfg, weights, ids, kv, 0, logits_all=True,
                compute_dtype=compute_dtype, tap=tap)
        h = states["h"][0].to(torch.float32).cpu().numpy()  # [T, n_embd]
        if pooling == "none":
            out.append(h)
            continue
        if pooling == "mean":
            e = h.mean(axis=0)
        elif pooling == "cls":
            e = h[0]
        else:
            e = h[-1]
        if normalize:
            e = e / (np.linalg.norm(e) + 1e-12)
        out.append(e)
    return np.stack(out) if pooling != "none" else out
