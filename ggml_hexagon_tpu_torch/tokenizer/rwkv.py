"""RWKV world-vocab tokenizer — greedy longest-match byte trie.

The port's own copy of ggml_hexagon_tpu/tokenizer/rwkv.py (the port imports nothing of the JAX
package).

Reference: llm_tokenizer_rwkv (src/llama-vocab.cpp:1137): token texts are
stored escaped in the GGUF ("\\xNN", "\\t", "\\n", "\\r"); tokenization
walks a byte trie taking the longest matching token at each position and
falls back to the unknown token for unmatched bytes.
"""
from __future__ import annotations

from .vocab import BaseTokenizer, Vocab


def unescape_rwkv_token(text: str) -> bytes:
    """Reverse the RWKV vocab escaping (llama_unescape_rwkv_token)."""
    out = bytearray()
    i = 0
    data = text
    while i < len(data):
        c = data[i]
        if c == "\\" and i + 1 < len(data):
            n = data[i + 1]
            if n == "x" and i + 3 < len(data):
                out.append(int(data[i + 2 : i + 4], 16))
                i += 4
                continue
            if n == "t":
                out.append(9)
                i += 2
                continue
            if n == "n":
                out.append(10)
                i += 2
                continue
            if n == "r":
                out.append(13)
                i += 2
                continue
            if n == "\\":
                out.append(92)
                i += 2
                continue
        out.extend(c.encode("utf-8"))
        i += 1
    return bytes(out)


class RWKVTokenizer(BaseTokenizer):
    def __init__(self, vocab: Vocab):
        super().__init__(vocab)
        self.token_bytes: list[bytes] = [
            unescape_rwkv_token(t) for t in vocab.tokens
        ]
        # byte trie: nested dicts keyed by int byte; token id under the
        # sentinel key -1 (naive_trie analog)
        self.trie: dict = {}
        for tid, bs in enumerate(self.token_bytes):
            if not bs:
                continue
            node = self.trie
            for b in bs:
                node = node.setdefault(b, {})
            node[-1] = tid

    def _fragment(self, text: str, out: list[int], prev_special: bool):
        data = text.encode("utf-8")
        pos = 0
        n = len(data)
        while pos < n:
            node = self.trie.get(data[pos])
            if node is None:
                out.append(self.vocab.unk_id)
                pos += 1
                continue
            best_id, best_end = node.get(-1), pos + 1
            i = pos + 1
            while i < n and node is not None:
                node = node.get(data[i])
                i += 1
                if node is not None and -1 in node:
                    best_id, best_end = node[-1], i
            if best_id is None:  # prefix existed but no complete token
                out.append(self.vocab.unk_id)
                pos += 1
            else:
                out.append(best_id)
                pos = best_end

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        bs = bytearray()
        for tid in ids:
            if skip_special and self.vocab.is_control(tid):
                continue
            bs.extend(self.token_bytes[tid])
        return bs.decode("utf-8", errors="replace")
