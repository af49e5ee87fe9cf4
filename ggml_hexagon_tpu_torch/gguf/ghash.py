"""GGUF tensor/file hashing — the llama-gguf-hash analog.

The port's own copy of ggml_hexagon_tpu/gguf/ghash.py, over the port's
reader (host only; its digests equal the JAX package's).

Reference counterpart: examples/gguf-hash/gguf-hash.cpp — per-tensor and
whole-model digests used to verify downloads and dedup weight uploads
(the rpc backend's SET_TENSOR_HASH, ggml-rpc.cpp:97, hashes the same bytes).

Algorithms: sha256 / sha1 (stdlib), plus the reference's UUIDv5 model id
(sha1 over the UUID namespace + all tensor bytes, gguf-hash.cpp uuid mode).
"""
from __future__ import annotations

import hashlib
import uuid

from .reader import GGUFReader

# namespace used by the reference for model UUIDs (gguf-hash.cpp:
# UUID_NAMESPACE_LLAMA_CPP ef001206-dadc-5f6d-a15f-3359e577d4e5)
UUID_NAMESPACE_LLAMA_CPP = uuid.UUID("ef001206-dadc-5f6d-a15f-3359e577d4e5")


def hash_gguf(path: str, algos=("sha256",)) -> dict:
    """Per-tensor + whole-model digests.

    Returns {algo: {tensor_name: hex, "__model__": hex}} plus
    {"uuid": str} when "uuid" is requested."""
    out: dict = {a: {} for a in algos if a != "uuid"}
    with GGUFReader.open(path) as r:
        model_ctx = {a: hashlib.new(a) for a in algos if a != "uuid"}
        uuid_ctx = hashlib.sha1() if "uuid" in algos else None
        if uuid_ctx is not None:
            uuid_ctx.update(UUID_NAMESPACE_LLAMA_CPP.bytes)
        for name in r.tensors:
            data = bytes(r.tensor_bytes(name))
            for a, mctx in model_ctx.items():
                out[a][name] = hashlib.new(a, data).hexdigest()
                mctx.update(data)
            if uuid_ctx is not None:
                uuid_ctx.update(data)
        for a, mctx in model_ctx.items():
            out[a]["__model__"] = mctx.hexdigest()
        if uuid_ctx is not None:
            out["uuid"] = str(uuid.UUID(bytes=uuid_ctx.digest()[:16], version=5))
    return out
