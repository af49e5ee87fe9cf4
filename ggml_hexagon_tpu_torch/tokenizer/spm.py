"""SentencePiece-style tokenizer (greedy bigram merge by score).

The port's own copy of ggml_hexagon_tpu/tokenizer/spm.py (the port imports nothing of the JAX
package).

Behavior mirrors the reference's llm_tokenizer_spm (src/llama-vocab.cpp:107):
whitespace is escaped to U+2581, the text is split into UTF-8 characters,
and adjacent symbol pairs are repeatedly merged choosing the pair whose
concatenation exists in the vocab with the highest score (ties: leftmost).
Characters with no vocab entry fall back to <0xXX> byte tokens.
"""
from __future__ import annotations

import heapq

from .vocab import BaseTokenizer, Vocab

SPACE_ESC = "▁"


class SPMTokenizer(BaseTokenizer):
    def __init__(self, vocab: Vocab):
        super().__init__(vocab)
        self._byte_cache: dict[int, int] = {}

    def _byte_token(self, b: int) -> int:
        if b not in self._byte_cache:
            tid = self.vocab.by_text.get(f"<0x{b:02X}>")
            if tid is None:
                tid = self.vocab.unk_id
            self._byte_cache[b] = tid
        return self._byte_cache[b]

    def _fragment(self, text: str, out: list[int], prev_special: bool):
        """One raw-text fragment: space-prefixed only when the previous
        fragment was a special token (llama-vocab.cpp:2386-2394)."""
        if self.vocab.add_space_prefix and prev_special:
            text = " " + text
        text = text.replace(" ", SPACE_ESC)
        out.extend(self._tokenize_fragment(text))

    def _tokenize_fragment(self, text: str) -> list[int]:
        v = self.vocab
        # symbols as (start, length) over the char list
        syms = list(text)
        if not syms:
            return []
        prev = list(range(-1, len(syms) - 1))
        nxt = list(range(1, len(syms) + 1))
        alive = [True] * len(syms)

        def pair_rank(i: int):
            j = nxt[i]
            if j >= len(syms):
                return None
            merged = syms[i] + syms[j]
            tid = v.by_text.get(merged)
            if tid is None:
                return None
            return (-v.scores[tid], i, merged)

        heap = []
        for i in range(len(syms)):
            r = pair_rank(i)
            if r:
                heapq.heappush(heap, r)
        while heap:
            negscore, i, merged = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j >= len(syms) or not alive[j] or syms[i] + syms[j] != merged:
                continue
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < len(syms):
                prev[nxt[i]] = i
            for k in (prev[i], i):
                if k >= 0 and alive[k]:
                    r = pair_rank(k)
                    if r:
                        heapq.heappush(heap, r)
        out: list[int] = []
        i = 0
        while i < len(syms):
            if not alive[i]:
                i += 1
                continue
            tid = v.by_text.get(syms[i])
            if tid is not None:
                out.append(tid)
            else:
                for b in syms[i].encode("utf-8"):
                    out.append(self._byte_token(b))
            i = nxt[i]
        return out

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        v = self.vocab
        buf = bytearray()
        for tid in ids:
            if skip_special and (tid in (v.bos_id, v.eos_id) or v.is_control(tid)):
                continue
            t = v.tokens[tid]
            if v.is_byte(tid) and t.startswith("<0x"):
                buf.append(int(t[3:5], 16))
            else:
                buf.extend(t.replace(SPACE_ESC, " ").encode("utf-8"))
        s = buf.decode("utf-8", errors="replace")
        # SPM strips the synthetic leading space added at encode time
        if v.add_space_prefix and s.startswith(" "):
            s = s[1:]
        return s
