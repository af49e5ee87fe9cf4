"""The port's tokenizer package against the JAX package's, family by family.

Each vocabulary is handcrafted as GGUF metadata (as tests/test_tokenizer.py
builds its vocabularies) and read by both packages' Vocab.from_gguf: SPM,
byte-level BPE under one pre-tokenizer name of each regex set (llama-bpe
for llama3), UGM, WPM and RWKV.  Encode (with and without special-token
parsing) and decode must give the JAX package's ids and text exactly, on a
corpus of accents, CJK, digits, emoji, contractions and whitespace runs
(code points of Unicode 15.0 or earlier).

The port's pre-tokenizer runs on the standard `re` with the Unicode classes
spelled out from `unicodedata` (Unicode 15.0 in Python 3.12), where the
JAX package uses the `regex` package: the classes must agree on every code
point assigned in Unicode 15.0 (the `regex` package's newer table may
assign more).
"""
import sys
import unicodedata

import pytest
import regex

from ggml_hexagon_tpu.tokenizer import Vocab as JVocab
from ggml_hexagon_tpu.tokenizer import build_tokenizer as j_build
from ggml_hexagon_tpu.tokenizer import pretok as JP
from ggml_hexagon_tpu_torch.tokenizer import Vocab as PVocab
from ggml_hexagon_tpu_torch.tokenizer import build_tokenizer as p_build
from ggml_hexagon_tpu_torch.tokenizer import pretok as PP
from ggml_hexagon_tpu_torch.tokenizer.bpe import bytes_to_unicode

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE = 1, 2, 3, 4, 6

CORPUS = [
    "Hello world! It's 2024, we've got 12345 apples & 3.14 pies.",
    "I'LL DON'T they're youre we'd SHE'S",
    "  multiple   spaces\n\n\tand tabs  \r\n trailing   ",
    "Café naïve résumé Ångström façade",
    "日本語のテキスト、中文字符。한국어 문장",
    "emoji 😀🎉 mixed👍🏽text ✓ ★",
    "x=3.14159; y==42 // comment <tag> $100 + 5^2 ~ |x|",
    "Ελληνικά русский עברית العربية हिन्दी",
    "<s> special </s> and <|user|> inline",
    "1234567 89 0 007 1,000,000",
    "",
]

WORDS = sorted({w for line in CORPUS for w in line.split()}
               | {"hello", "world", "the", "and"})


def _check(md):
    """Encode and decode every corpus line with both packages."""
    jt, pt = j_build(JVocab.from_gguf(md)), p_build(PVocab.from_gguf(md))
    for text in CORPUS:
        for special in (False, True):
            want = jt.encode(text, parse_special=special)
            got = pt.encode(text, parse_special=special)
            assert got == want, (text, special)
            assert pt.decode(got) == jt.decode(want)
            assert (pt.decode(got, skip_special=False)
                    == jt.decode(want, skip_special=False))
    return jt, pt


def spm_md():
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [UNKNOWN, CONTROL, CONTROL] + [BYTE] * 256
    scores = [0.0] * len(toks)
    pieces = set()
    for w in WORDS:
        for i in range(1, len(w) + 1):
            pieces.add(w[:i])
            pieces.add("▁" + w[:i])
    for i, p in enumerate(sorted(pieces)):
        toks.append(p)
        types.append(NORMAL)
        scores.append(-float(len(p) % 7) - 0.01 * i)
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types}


def bpe_md(pre):
    """Byte-level tokens, then merges building every prefix of each word
    and of its space-led form; <s>, </s> CONTROL, <|user|> USER_DEFINED."""
    b2u = bytes_to_unicode()
    toks = ["<s>", "</s>", "<|user|>"] + [b2u[b] for b in range(256)]
    types = [CONTROL, CONTROL, USER_DEFINED] + [NORMAL] * 256
    have = set(toks)
    merges = []
    for w in WORDS:
        for form in (w, " " + w):
            mapped = "".join(b2u[b] for b in form.encode("utf-8"))
            for i in range(2, len(mapped) + 1):
                if mapped[:i] not in have:
                    merges.append(f"{mapped[:i - 1]} {mapped[i - 1]}")
                    toks.append(mapped[:i])
                    types.append(NORMAL)
                    have.add(mapped[:i])
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": pre,
            "tokenizer.ggml.tokens": toks, "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.bos_token_id": 0,
            "tokenizer.ggml.eos_token_id": 1}


#: one pre-tokenizer name of each regex set (llama-bpe for llama3)
BPE_PRES = sorted({key: ("llama-bpe" if key == "llama3" else
                         next(p for p, k in JP.PRE_TO_SET.items() if k == key))
                   for key in JP.REGEX_SETS}.values())


def test_spm_matches_jax():
    jt, _ = _check(spm_md())
    assert len(jt.encode("hello world")) >= 3


@pytest.mark.parametrize("pre", BPE_PRES)
def test_bpe_matches_jax(pre):
    _check(bpe_md(pre))


def test_ugm_matches_jax():
    toks = ["<unk>", "<s>", "</s>", "▁"]
    scores = [0.0, 0.0, 0.0, -3.0]
    for w in WORDS:
        for piece in ("▁" + w, w, w[:2], w[2:]):
            if piece and piece not in toks:
                toks.append(piece)
                scores.append(-1.0 - len(toks) % 5)
    for ch in sorted({c for line in CORPUS for c in line}):
        if ch not in toks:
            toks.append(ch)
            scores.append(-8.0)
    md = {"tokenizer.ggml.model": "t5", "tokenizer.ggml.tokens": toks,
          "tokenizer.ggml.scores": scores,
          "tokenizer.ggml.token_type": [UNKNOWN, CONTROL, CONTROL]
          + [NORMAL] * (len(toks) - 3),
          "tokenizer.ggml.unknown_token_id": 0,
          "tokenizer.ggml.eos_token_id": 2}
    _check(md)


def test_wpm_matches_jax():
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    for w in WORDS:
        for piece in ("▁" + w.lower(), w.lower()[:3], w.lower()[3:]):
            if piece and piece not in toks:
                toks.append(piece)
    md = {"tokenizer.ggml.model": "bert", "tokenizer.ggml.tokens": toks,
          "tokenizer.ggml.token_type": [CONTROL] * 4
          + [NORMAL] * (len(toks) - 4),
          "tokenizer.ggml.unknown_token_id": 1,
          "tokenizer.ggml.bos_token_id": 2,
          "tokenizer.ggml.eos_token_id": 3,
          "tokenizer.ggml.seperator_token_id": 3}
    _check(md)


def test_rwkv_matches_jax():
    """World-vocab tokens stored escaped; greedy longest match over bytes."""
    def esc(bs: bytes) -> str:
        out = []
        for b in bs:
            if b == 9:
                out.append("\\t")
            elif b == 10:
                out.append("\\n")
            elif b == 13:
                out.append("\\r")
            elif b == 92:
                out.append("\\\\")
            elif b < 32 or b >= 127:
                out.append(f"\\x{b:02x}")
            else:
                out.append(chr(b))
        return "".join(out)

    toks = ["<unk>"] + [esc(bytes([b])) for b in range(1, 256)]
    for w in WORDS:
        for form in (w, " " + w):
            t = esc(form.encode("utf-8"))
            if t not in toks:
                toks.append(t)
    md = {"tokenizer.ggml.model": "rwkv", "tokenizer.ggml.tokens": toks,
          "tokenizer.ggml.token_type": [CONTROL] + [NORMAL] * (len(toks) - 1)}
    _check(md)


def _assigned_15():
    """Every code point Python 3.12's unicodedata (Unicode 15.0) assigns,
    surrogates left out, as one string."""
    assert unicodedata.unidata_version == "15.0.0"
    return "".join(chr(c) for c in range(sys.maxunicode + 1)
                   if unicodedata.category(chr(c)) not in ("Cn", "Cs"))


@pytest.mark.parametrize("cls", ["L", "N", "P", "S", "M", "s"])
def test_unicode_classes_match_regex_on_unicode_15(cls):
    """The port's spelled-out classes pick the `regex` package's code points
    among those assigned in Unicode 15.0."""
    text = _assigned_15()
    pat = r"\s" if cls == "s" else rf"\p{{{cls}}}"
    want = "".join(regex.findall(pat, text))
    import re

    got = "".join(re.findall(PP.translate(pat), text))
    assert got == want and len(want) > 0

