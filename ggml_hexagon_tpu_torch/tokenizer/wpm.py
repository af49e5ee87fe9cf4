"""WordPiece tokenizer (BERT family) — llm_tokenizer_wpm analog
(src/llama-vocab.cpp:617-731).

The port's own copy of ggml_hexagon_tpu/tokenizer/wpm.py (the port imports nothing of the JAX
package).

The GGUF conversion stores WPM pieces in SentencePiece form: word-start
pieces carry a U+2581 prefix, continuation pieces are bare (the converter
rewrites "##x" -> "x" and "x" -> "▁x").  Tokenization is therefore:
NFD + per-codepoint lowercase, drop control chars, split into words on
whitespace and isolated punctuation/ASCII-symbol/CJK chars
(preprocess, llama-vocab.cpp:671-708), then greedy longest-match over
"▁" + word; a word with any unmatched position becomes [UNK]
(llama-vocab.cpp:641-668).
"""
from __future__ import annotations

import unicodedata

from .vocab import BaseTokenizer, Vocab

SPACE_ESC = "▁"


def _is_chinese_char(cp: int) -> bool:
    # is_chinese_char (llama-vocab.cpp:712-724), incl. the hf-rust 0x2B920
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WPMTokenizer(BaseTokenizer):
    def __init__(self, vocab: Vocab):
        super().__init__(vocab)
        self.max_len = max((len(t) for t in vocab.tokens), default=1)

    def _final_id(self):
        # reference appends [SEP] after the text (llama-vocab.cpp:2471)
        v = self.vocab
        return v.sep_id if v.sep_id >= 0 else v.eos_id

    def _preprocess(self, text: str) -> list[str]:
        """Per-codepoint base-letter NFD (the reference's unicode_ranges_nfd
        maps each cp to ONE cp — the base letter, dropping combining marks)
        + lowercase; split on whitespace; punctuation / ASCII symbols / CJK
        become single-char words."""
        words: list[str] = [""]
        for orig in text:
            ch = unicodedata.normalize("NFD", orig)[0]
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if ch.isspace():
                if words[-1]:
                    words.append("")
                continue
            if cp == 0 or cp == 0xFFFD or cat.startswith("C"):
                continue
            low = ch.lower()
            if (cat.startswith("P") or (cp < 0x7F and cat.startswith("S"))
                    or _is_chinese_char(cp)):
                if words[-1]:
                    words.append("")
                words[-1] = low
                words.append("")
            else:
                words[-1] += low
        if not words[-1]:
            words.pop()
        return words

    def _fragment(self, text: str, out: list[int], prev_special: bool):
        v = self.vocab
        for word in self._preprocess(text):
            if not word:
                continue
            word1 = SPACE_ESC + word
            n = len(word1)
            start_len = len(out)
            i = 0
            while i < n:
                match = False
                for j in range(min(n, i + self.max_len + 1), i, -1):
                    tid = v.by_text.get(word1[i:j])
                    if tid is not None:
                        out.append(tid)
                        match = True
                        i = j
                        break
                if not match:  # discard partial matches for this word
                    del out[start_len:]
                    break
            if len(out) == start_len:
                out.append(v.unk_id)

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        v = self.vocab
        parts = []
        for tid in ids:
            t = v.tokens[tid]
            if skip_special and (v.is_control(tid)
                                 or (t.startswith("[") and t.endswith("]"))):
                continue
            parts.append(t)
        s = "".join(parts).replace(SPACE_ESC, " ")
        return s[1:] if s.startswith(" ") else s
