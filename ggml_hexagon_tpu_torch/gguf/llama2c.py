"""llama2.c checkpoint -> GGUF converter
(examples/convert-llama2c-to-ggml/convert-llama2c-to-ggml.cpp).

The port's own copy of ggml_hexagon_tpu/gguf/llama2c.py (numpy only; it
writes F32 tensors, which the port's writer packs, so its files are
byte-equal to the JAX package's).

Checkpoint layout (Config struct + TransformerWeights, convert-...cpp:73):
  header: 7 x int32  dim, hidden_dim, n_layers, n_heads, n_kv_heads,
                     vocab_size (negative => separate classifier), seq_len
  f32 blobs in order: tok_emb [V,dim], rms_att [L,dim], wq [L,dim,dim],
  wk/wv [L, kv_dim, dim... stored as L*dim*dim/mq floats], wo, rms_ffn,
  w1 [L,ff,dim], w2 [L,dim,ff], w3 [L,ff,dim], rms_final [dim],
  freq_cis (skipped, :170), wcls [V,dim] when not shared.

llama2.c applies RoPE on adjacent pairs, which is exactly GGUF's "norm"
rope convention — so Q/K are stored unpermuted (unlike HF conversion).

Vocab sources (load_vocab, :530): a GGUF file carrying tokenizer.ggml.*,
or karpathy tokenizer.bin (u32 max_len, then per token f32 score,
u32 len, bytes; ids 0/1/2 = unk/bos/eos, whitespace escaped to U+2581).
"""
from __future__ import annotations

import re
import struct

import numpy as np

from ..quant.formats import GGMLType

UNKNOWN_TOKEN_ID, BOS_TOKEN_ID, EOS_TOKEN_ID = 0, 1, 2


def read_llama2c_checkpoint(path: str):
    """-> (config dict, weights dict of f32 arrays)."""
    with open(path, "rb") as f:
        dim, hidden, n_layers, n_heads, n_kv, vocab, seq_len = struct.unpack(
            "<7i", f.read(28))
        shared = vocab > 0
        vocab = abs(vocab)
        mq = 1 if (n_kv <= 0 or n_kv >= n_heads) else n_heads // n_kv
        kv_dim = dim // mq

        def blob(*shape):
            n = int(np.prod(shape))
            a = np.frombuffer(f.read(4 * n), "<f4", count=n)
            if a.size != n:
                raise ValueError("truncated llama2.c checkpoint")
            return a.reshape(shape).copy()

        w = {
            "tok_emb": blob(vocab, dim),
            "rms_att": blob(n_layers, dim),
            "wq": blob(n_layers, dim, dim),
            "wk": blob(n_layers, kv_dim, dim),
            "wv": blob(n_layers, kv_dim, dim),
            "wo": blob(n_layers, dim, dim),
            "rms_ffn": blob(n_layers, dim),
            "w1": blob(n_layers, hidden, dim),
            "w2": blob(n_layers, dim, hidden),
            "w3": blob(n_layers, hidden, dim),
            "rms_final": blob(dim),
        }
        f.seek(seq_len * (dim // n_heads) * 4, 1)  # skip freq_cis (:170)
        w["wcls"] = w["tok_emb"] if shared else blob(vocab, dim)
    cfg = {"dim": dim, "hidden_dim": hidden, "n_layers": n_layers,
           "n_heads": n_heads,
           "n_kv_heads": n_kv if 0 < n_kv < n_heads else n_heads,
           "vocab_size": vocab, "seq_len": seq_len, "shared": shared}
    return cfg, w


def _escape_whitespace(text: str) -> str:
    return text.replace(" ", "▁")


def read_llama2c_tokenizer(path: str, n_vocab: int):
    """karpathy tokenizer.bin -> (tokens, scores, token_types)."""
    tokens, scores, types = [""] * n_vocab, [0.0] * n_vocab, [1] * n_vocab
    with open(path, "rb") as f:
        struct.unpack("<i", f.read(4))  # max_token_length, unused
        for tid in range(n_vocab):
            score, = struct.unpack("<f", f.read(4))
            ln, = struct.unpack("<i", f.read(4))
            text = f.read(ln).decode("utf-8", errors="replace")
            ttype = 1  # NORMAL
            if tid == UNKNOWN_TOKEN_ID:
                text, ttype = "<unk>", 2
            elif tid == BOS_TOKEN_ID:
                text, ttype = "<s>", 3
            elif tid == EOS_TOKEN_ID:
                text, ttype = "</s>", 3
            elif not text:
                ttype = 3
            elif re.fullmatch(r"<0x[0-9A-Fa-f]{2}>", text):
                ttype = 6  # BYTE
            tokens[tid] = _escape_whitespace(text)
            scores[tid] = score
            types[tid] = ttype
    return tokens, scores, types


def _vocab_fields_from_gguf(path: str) -> dict:
    from .reader import GGUFReader

    with GGUFReader.open(path) as r:
        md = r.metadata
    keys = ["tokenizer.ggml.model", "tokenizer.ggml.tokens",
            "tokenizer.ggml.scores", "tokenizer.ggml.token_type",
            "tokenizer.ggml.bos_token_id", "tokenizer.ggml.eos_token_id",
            "tokenizer.ggml.unknown_token_id"]
    return {k: md[k] for k in keys if k in md}


def convert_llama2c(model_path: str, vocab_path: str, out_path: str,
                    qtype: GGMLType = GGMLType.F32) -> str:
    """llama2.c checkpoint + vocab (tokenizer.bin or GGUF) -> llama GGUF."""
    from .writer import GGUFWriter

    cfg, w = read_llama2c_checkpoint(model_path)
    magic = open(vocab_path, "rb").read(4)
    if magic == b"GGUF":
        tok_fields = _vocab_fields_from_gguf(vocab_path)
    else:
        tokens, scores, types = read_llama2c_tokenizer(
            vocab_path, cfg["vocab_size"])
        tok_fields = {
            "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": BOS_TOKEN_ID,
            "tokenizer.ggml.eos_token_id": EOS_TOKEN_ID,
            "tokenizer.ggml.unknown_token_id": UNKNOWN_TOKEN_ID,
        }

    g = GGUFWriter()
    g.add("general.architecture", "llama")
    g.add("general.name", "llama2c")
    g.add("llama.context_length", cfg["seq_len"])
    g.add("llama.embedding_length", cfg["dim"])
    g.add("llama.block_count", cfg["n_layers"])
    g.add("llama.feed_forward_length", cfg["hidden_dim"])
    g.add("llama.attention.head_count", cfg["n_heads"])
    g.add("llama.attention.head_count_kv", cfg["n_kv_heads"])
    g.add("llama.rope.dimension_count", cfg["dim"] // cfg["n_heads"])
    g.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    for k, v in tok_fields.items():
        g.add(k, v)

    def emit(name, arr):
        g.add_tensor(name, np.ascontiguousarray(arr, np.float32),
                     GGMLType.F32)

    emit("token_embd.weight", w["tok_emb"])
    emit("output_norm.weight", w["rms_final"])
    emit("output.weight", w["wcls"])
    for i in range(cfg["n_layers"]):
        p = f"blk.{i}."
        emit(p + "attn_norm.weight", w["rms_att"][i])
        emit(p + "attn_q.weight", w["wq"][i])
        emit(p + "attn_k.weight", w["wk"][i])
        emit(p + "attn_v.weight", w["wv"][i])
        emit(p + "attn_output.weight", w["wo"][i])
        emit(p + "ffn_norm.weight", w["rms_ffn"][i])
        emit(p + "ffn_gate.weight", w["w1"][i])
        emit(p + "ffn_down.weight", w["w2"][i])
        emit(p + "ffn_up.weight", w["w3"][i])
    g.write_file(out_path)
    return out_path
