"""Byte-level BPE tokenizer (GPT-2 family).

The port's own copy of ggml_hexagon_tpu/tokenizer/bpe.py (the port imports nothing of the JAX
package).

Mirrors the reference's llm_tokenizer_bpe (src/llama-vocab.cpp:276-607):
regex pre-tokenization (the full per-model regex-set table lives in
pretok.py, chosen by tokenizer.ggml.pre), GPT-2 byte->unicode mapping
applied per word (unicode.cpp:218), ignore_merges whole-word short-circuit
(llama3 family, llama-vocab.cpp:487), then lowest-rank-first pair merging
using tokenizer.ggml.merges, with single-byte fallback for unmergeable
symbols (llama-vocab.cpp:561-570).  Unknown pre-tokenizer names fall back
to the reference's 'default' regex set (same degraded-quality warning
path).
"""
from __future__ import annotations

from .pretok import compiled_set, regex_split
from .vocab import BaseTokenizer, Vocab


def bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_B2U = bytes_to_unicode()
_U2B = {v: k for k, v in _B2U.items()}


class BPETokenizer(BaseTokenizer):
    def __init__(self, vocab: Vocab):
        super().__init__(vocab)
        self.pats = compiled_set(vocab.pre)
        self.ranks = {tuple(m.split(" ", 1)): i for i, m in enumerate(vocab.merges)}

    def _bpe_word(self, word: str) -> list[str]:
        parts = list(word)
        if len(parts) < 2:
            return parts
        while True:
            best = None
            best_rank = None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                return parts
            parts = parts[:best] + [parts[best] + parts[best + 1]] + parts[best + 2 :]

    def _fragment(self, text: str, out: list[int], prev_special: bool):
        v = self.vocab
        for frag in regex_split(text, self.pats):
            mapped = "".join(_B2U[b] for b in frag.encode("utf-8"))
            if v.ignore_merges and mapped in v.by_text:
                out.append(v.by_text[mapped])
                continue
            for piece in self._bpe_word(mapped):
                tid = v.by_text.get(piece)
                if tid is not None:
                    out.append(tid)
                else:  # unmergeable: per-char byte fallback
                    for ch in piece:
                        t = v.by_text.get(ch)
                        if t is not None:
                            out.append(t)

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        v = self.vocab
        buf = bytearray()
        for tid in ids:
            if skip_special and (tid in (v.bos_id, v.eos_id) or v.is_control(tid)):
                continue
            for ch in v.tokens[tid]:
                b = _U2B.get(ch)
                if b is not None:
                    buf.append(b)
                else:
                    buf.extend(ch.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")
