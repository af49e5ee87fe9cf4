"""Legacy GGML/GGMF/GGJT model files -> GGUF.

The port's own copy of ggml_hexagon_tpu/gguf/legacy.py (numpy only; the
tensors go into the GGUF as the packed bytes they are, so its files are
byte-equal to the JAX package's).

Reference counterpart: convert_llama_ggml_to_gguf.py — the importer for
pre-GGUF llama checkpoints: magic 'lmgg' (bare GGML), 'fmgg' (GGMF v1),
'tjgg' (GGJT v1-3); 7×u32 llama hyperparameters, inline vocab
(len/bytes[/score]), tensor records (n_dims, name_len, dtype, dims, name,
[GGJT: 32-byte data alignment], raw data).

Conversion policy mirrors the reference (convert_llama_ggml_to_gguf.py:
168-178): quantization formats changed in GGJTv2 and again in GGJTv3, so
quantized tensors are only accepted from GGJTv3 files; older files must be
F16/F32.
"""
from __future__ import annotations

import struct

import numpy as np

from ..quant.formats import GGMLType, row_size
from .writer import GGUFWriter

_MAGICS = {b"lmgg": ("ggml", 0), b"fmgg": ("ggmf", 1), b"tjgg": ("ggjt", 2)}

# old llama.cpp tensor names -> GGUF convention
_NAME_MAP = {
    "tok_embeddings": "token_embd",
    "norm": "output_norm",
    "output": "output",
    "attention.wq": "attn_q",
    "attention.wk": "attn_k",
    "attention.wv": "attn_v",
    "attention.wo": "attn_output",
    "attention_norm": "attn_norm",
    "feed_forward.w1": "ffn_gate",
    "feed_forward.w2": "ffn_down",
    "feed_forward.w3": "ffn_up",
    "ffn_norm": "ffn_norm",
}


def _map_name(name: str) -> str:
    stem, _, suffix = name.rpartition(".")
    if stem.startswith("layers."):
        _, il, rest = stem.split(".", 2)
        mapped = _NAME_MAP.get(rest)
        if mapped is None:
            raise ValueError(f"unknown legacy tensor {name!r}")
        return f"blk.{il}.{mapped}.{suffix}"
    mapped = _NAME_MAP.get(stem)
    if mapped is None:
        raise ValueError(f"unknown legacy tensor {name!r}")
    return f"{mapped}.{suffix}"


def convert_ggml_to_gguf(src_path: str, out_path: str,
                         eps: float = 1e-5) -> str:
    """Read a legacy GGML-family llama file, emit GGUF."""
    data = np.fromfile(src_path, dtype=np.uint8)
    buf = data.tobytes()
    magic = buf[:4]
    if magic not in _MAGICS:
        raise ValueError(f"not a legacy GGML file (magic {magic!r})")
    kind, fmt = _MAGICS[magic]
    off = 4
    version = 0
    if fmt > 0:
        version = struct.unpack_from("<I", buf, off)[0]
        off += 4
        if kind == "ggmf" and version != 1:
            raise ValueError(f"unsupported GGMF version {version}")
        if kind == "ggjt" and not 1 <= version <= 3:
            raise ValueError(f"unsupported GGJT version {version}")
    n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, ftype = \
        struct.unpack_from("<7I", buf, off)
    off += 28
    quant_ok = kind == "ggjt" and version == 3
    # vocab (scores only in GGMF/GGJT)
    scores = []
    tokens = []
    has_scores = fmt > 0
    for _ in range(n_vocab):
        ln = struct.unpack_from("<I", buf, off)[0]
        off += 4
        tokens.append(buf[off:off + ln].decode("utf-8", errors="replace"))
        off += ln
        if has_scores:
            scores.append(struct.unpack_from("<f", buf, off)[0])
            off += 4
        else:
            scores.append(0.0)
    # tensors
    tensors = []
    n_ff = 0
    while off < len(buf):
        n_dims, name_len, dtype = struct.unpack_from("<3I", buf, off)
        off += 12
        dims = struct.unpack_from(f"<{n_dims}I", buf, off)
        off += 4 * n_dims
        name = buf[off:off + name_len].decode()
        off += name_len
        if kind == "ggjt":
            off = (off + 31) & ~31  # GGJT aligns tensor data to 32 bytes
        ttype = GGMLType(dtype)
        if ttype not in (GGMLType.F32, GGMLType.F16) and not quant_ok:
            raise ValueError(
                "quantization formats changed in GGJTv2/v3; only GGJTv3 "
                "quantized files are convertible (reference policy)")
        n_el = int(np.prod(dims))
        nbytes = row_size(ttype, dims[0]) * (n_el // dims[0])
        tensors.append((name, dims, ttype, off, nbytes))
        off += nbytes
        if name == "layers.0.feed_forward.w1.weight":
            n_ff = dims[1]
    if not n_ff:
        raise ValueError("missing layers.0.feed_forward.w1.weight")

    w = GGUFWriter()
    w.add("general.architecture", "llama")
    w.add("general.name", "legacy-ggml-import")
    w.add("llama.context_length", 2048)
    w.add("llama.embedding_length", n_embd)
    w.add("llama.block_count", n_layer)
    w.add("llama.feed_forward_length", int(n_ff))
    w.add("llama.rope.dimension_count", n_embd // n_head)
    w.add("llama.attention.head_count", n_head)
    w.add("llama.attention.layer_norm_rms_epsilon", eps)
    w.add("general.file_type", ftype)
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.scores", [float(s) for s in scores])
    w.add("tokenizer.ggml.token_type", [1] * n_vocab)
    for name, dims, ttype, start, nbytes in tensors:
        ne = tuple(dims)  # legacy dims are already ggml ne order
        w.add_tensor(_map_name(name), data[start:start + nbytes], ttype,
                     raw_ne=ne)
    w.write_file(out_path)
    return out_path
