"""Unigram tokenizer (T5 family) — llm_tokenizer_ugm analog
(src/llama-vocab.cpp:733-1078).

The port's own copy of ggml_hexagon_tpu/tokenizer/ugm.py (the port imports nothing of the JAX
package).

Pipeline per the reference:
1. normalize(): per-prefix normalization via the precompiled_charsmap —
   an XOR-compressed compact double array (XCDA) mapping input prefixes to
   replacement strings (normalize_prefix, llama-vocab.cpp:1004-1073) —
   with user-defined tokens passed through verbatim; then space handling:
   escape to U+2581, optional prefix/suffix space, optional extra-space
   merging (normalize, llama-vocab.cpp:911-959).
2. Viterbi over UTF-8 BYTES of the normalized text using a prefix trie of
   all NORMAL|USER_DEFINED|UNUSED tokens; user-defined tokens score 0,
   normal tokens their log-prob score, unknown code points
   min_score - 10 with consecutive-unknown merging
   (tokenize, llama-vocab.cpp:817-898).
"""
from __future__ import annotations

import struct

from .vocab import BaseTokenizer, TokenType, Vocab

SPACE_ESC = "▁"
UNKNOWN_PENALTY = 10.0


class _Trie:
    """Byte-level prefix trie (the reference's naive_trie)."""

    __slots__ = ("children", "value")

    def __init__(self):
        self.children: dict[int, _Trie] = {}
        self.value: int | None = None

    def insert(self, data: bytes, value: int):
        node = self
        for b in data:
            node = node.children.setdefault(b, _Trie())
        node.value = value


class _XCDA:
    """XOR-compressed compact double array view (llama-vocab.cpp:960-1002).

    Bit layout per 32-bit entry: BASE in bits 10-30 (shifted left 4 more
    when bit 9 set), LCHECK in bits 0-7 (bit 31 participates in the lcheck
    comparison), LEAF in bit 8.
    """

    def __init__(self, blob: bytes):
        self.arr = struct.unpack(f"<{len(blob) // 4}I", blob[: len(blob) // 4 * 4])

    def base(self, i: int) -> int:
        p = self.arr[i]
        return (p >> 10) << ((p & (1 << 9)) >> 6)

    def lcheck(self, i: int) -> int:
        p = self.arr[i]
        return p & ((1 << 31) | 0xFF)

    def leaf(self, i: int) -> bool:
        return bool((self.arr[i] >> 8) & 1)

    def value(self, i: int) -> int:
        return self.arr[i] & ((1 << 31) - 1)


class UGMTokenizer(BaseTokenizer):
    def __init__(self, vocab: Vocab):
        super().__init__(vocab)
        # parse the precompiled charsmap: u32 xcda blob size, xcda entries,
        # then NUL-terminated replacement strings (llama-vocab.cpp:735-756)
        self.xcda = None
        self.replacements = b""
        if len(vocab.charsmap) >= 4:
            (xcda_size,) = struct.unpack_from("<I", vocab.charsmap, 0)
            if 4 + xcda_size <= len(vocab.charsmap):
                self.xcda = _XCDA(vocab.charsmap[4 : 4 + xcda_size])
                self.replacements = vocab.charsmap[4 + xcda_size :]

        self.trie = _Trie()
        self.user_trie = _Trie()
        min_score = float("inf")
        for tid, text in enumerate(vocab.tokens):
            tt = vocab.token_types[tid]
            if tt == TokenType.NORMAL:
                min_score = min(min_score, vocab.scores[tid])
            if tt in (TokenType.NORMAL, TokenType.USER_DEFINED,
                      TokenType.UNUSED):
                self.trie.insert(text.encode("utf-8"), tid)
            if tt == TokenType.USER_DEFINED:
                self.user_trie.insert(text.encode("utf-8"), tid)
        if min_score == float("inf"):
            min_score = -10.0
        self.unknown_score = min_score - UNKNOWN_PENALTY

    # -- normalization -------------------------------------------------------

    def _user_defined_prefix(self, data: bytes, off: int) -> int:
        """Longest user-defined token matching data[off:]; 0 if none."""
        node = self.user_trie
        best = 0
        i = off
        while i < len(data):
            node = node.children.get(data[i])
            if node is None:
                break
            i += 1
            if node.value is not None:
                best = i - off
        return best

    def _normalize_prefix(self, data: bytes, off: int):
        """-> (replacement bytes, consumed input bytes)
        (normalize_prefix, llama-vocab.cpp:1004-1073)."""
        n_user = self._user_defined_prefix(data, off)
        if n_user > 0:
            return data[off : off + n_user], n_user
        best_len = 0
        best_repl_off = 0
        if self.xcda is not None:
            try:
                node = self.xcda.base(0)
                for i in range(off, len(data)):
                    c = data[i]
                    if c == 0:
                        break
                    node ^= c
                    if self.xcda.lcheck(node) != c:
                        break
                    is_leaf = self.xcda.leaf(node)
                    node ^= self.xcda.base(node)
                    if is_leaf:
                        best_len = i - off + 1
                        best_repl_off = self.xcda.value(node)
            except IndexError:
                pass
        if best_len > 0 and best_repl_off < len(self.replacements):
            end = self.replacements.find(b"\0", best_repl_off)
            if end < 0:
                end = len(self.replacements)
            return self.replacements[best_repl_off:end], best_len
        # pass through one UTF-8 code point unmodified; invalid bytes
        # become U+FFFD (consuming one byte)
        b0 = data[off]
        ln = 1 if b0 < 0x80 else (2 if b0 < 0xE0 else (3 if b0 < 0xF0 else 4))
        if b0 < 0x80:
            return data[off : off + 1], 1
        seq = data[off : off + ln]
        if len(seq) == ln and all(0x80 <= b < 0xC0 for b in seq[1:]) and b0 >= 0xC2:
            return seq, ln
        return "�".encode("utf-8"), 1

    def _normalize(self, text: str) -> bytes:
        v = self.vocab
        space = SPACE_ESC.encode("utf-8")
        prepend = not v.treat_whitespace_as_suffix and v.add_space_prefix
        append = v.treat_whitespace_as_suffix and v.add_space_prefix
        merge = v.remove_extra_whitespaces
        data = text.encode("utf-8")
        out = bytearray()
        space_prepended = False
        in_word = False
        off = 0
        while off < len(data):
            repl, used = self._normalize_prefix(data, off)
            for c in repl:
                if c != 0x20:
                    if not in_word:
                        in_word = True
                        if (prepend and not space_prepended) or merge:
                            out += space
                            space_prepended = True
                    out.append(c)
                else:
                    in_word = False
                    if not merge:
                        out += space
            off += used
        if append:
            out += space
        return bytes(out)

    # -- Viterbi -------------------------------------------------------------

    def _fragment(self, text: str, out: list[int], prev_special: bool):
        v = self.vocab
        data = self._normalize(text)
        n = len(data)
        if n == 0:
            return
        NEG = float("-inf")
        best_score = [NEG] * (n + 1)
        best_tok = [v.unk_id] * (n + 1)
        best_src = [0] * (n + 1)
        best_score[0] = 0.0
        off = 0
        while off < n:
            cur = best_score[off]
            b0 = data[off]
            cp_len = 1 if b0 < 0x80 else (2 if b0 < 0xE0 else (3 if b0 < 0xF0 else 4))
            cp_len = min(cp_len, n - off)
            single_cp_found = False
            if cur != NEG:
                node = self.trie
                i = off
                while i < n:
                    node = node.children.get(data[i])
                    if node is None:
                        break
                    i += 1
                    if node.value is not None:
                        if i - off == cp_len:
                            single_cp_found = True
                        tid = node.value
                        sc = 0.0 if v.is_user_defined(tid) else v.scores[tid]
                        chall = cur + sc
                        if chall > best_score[i]:
                            best_score[i] = chall
                            best_tok[i] = tid
                            best_src[i] = off
                if not single_cp_found:
                    end = off + cp_len
                    chall = cur + self.unknown_score
                    if chall > best_score[end]:
                        best_score[end] = chall
                        best_tok[end] = v.unk_id
                        best_src[end] = off
            off += cp_len
        # backtrack, merging consecutive unknowns (llama-vocab.cpp:882-895)
        rev: list[int] = []
        pos = n
        prev_unk = False
        while pos > 0:
            tid = best_tok[pos]
            is_unk = tid == v.unk_id
            if not (prev_unk and is_unk):
                rev.append(tid)
            prev_unk = is_unk
            pos = best_src[pos]
        out.extend(reversed(rev))

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        v = self.vocab
        parts = []
        for tid in ids:
            if skip_special and (tid in (v.bos_id, v.eos_id) or v.is_control(tid)):
                continue
            parts.append(v.tokens[tid])
        s = "".join(parts).replace(SPACE_ESC, " ")
        return s[1:] if v.add_space_prefix and s.startswith(" ") else s
