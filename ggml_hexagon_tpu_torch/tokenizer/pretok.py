"""BPE pre-tokenizer regex table + sequential fragment splitting.

The port's own copy of ggml_hexagon_tpu/tokenizer/pretok.py, on the
standard library's `re` instead of the `regex` package.  Port of the
reference's per-model regex sets (llm_tokenizer_bpe ctor,
llama-vocab.cpp:276-425) and the sequential split semantics of
unicode_regex_split (unicode.cpp:670): each regex in the list further
splits every current fragment; matches become fragments, as does the text
between matches.

`re` has no Unicode property classes, so the patterns keep `\\p{L}`,
`\\p{N}`, `\\p{P}`, `\\p{S}` and `\\p{M}` as written and `translate` turns
each into an explicit character class before compiling: the ranges of the
code points whose `unicodedata` general category starts with that letter,
built once (`_classes`).  The reference works around `std::regex` the same
way, with collapsed category classes.  `\\s` becomes the Unicode
White_Space set, as the `regex` package reads it (`re`'s own `\\s` also
takes U+001C-U+001F).  Python 3.12's `unicodedata` is Unicode 15.0; the
`regex` package may carry a newer table, so code points assigned after
15.0 (CJK extension I, new scripts' letters and digits) are unassigned here
and may split differently than under `regex`.

After splitting, words are byte->unicode mapped (unicode.cpp:218
unicode_byte_encoding_process) by the BPE tokenizer itself.
"""
from __future__ import annotations

import re as _re
import sys
import unicodedata

# ---------------------------------------------------------------------------
# regex sets, keyed by pre-type (llama-vocab.cpp:276-425)
# ---------------------------------------------------------------------------

_CONTRACT_CI = "(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
_GPT2_EXPR = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"
)
_LLAMA3_EXPR = (
    _CONTRACT_CI
    + r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    + r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)

REGEX_SETS: dict[str, list[str]] = {
    "llama3": [_LLAMA3_EXPR],
    "dbrx": [_LLAMA3_EXPR],  # same expr, separate pre-type in the reference
    "deepseek-llm": [
        "[\r\n]",
        # exact letter ranges extracted from llama-vocab.cpp (escape-encoded
        # so NFC normalization of this source file cannot corrupt them)
        "\\s?[A-Za-z\xb5\xc0-\xd6\xd8-\xf6\xf8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+",
        "\\s?[!-/:-~\uff01-\uff0f\uff1a-\uff5e\u2018-\u201f\u3000-\u3002]+",
        r"\s+$",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        r"\p{N}+",
    ],
    "deepseek3": [
        r"\p{N}{1,3}",
        "[\u4e00-\u9fa5\u3040-\u309f\u30a0-\u30ff]+",
        "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+"
        "|[^\r\n\\p{L}\\p{P}\\p{S}]?[\\p{L}\\p{M}]+"
        "| ?[\\p{P}\\p{S}]+[\r\n]*|\\s*[\r\n]+|\\s+(?!\\S)|\\s+",
    ],
    "deepseek-coder": [
        "[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        r"\p{N}",
    ],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        _GPT2_EXPR,
        "[0-9][0-9][0-9]",
    ],
    "starcoder": [r"\p{N}", _GPT2_EXPR],
    "gpt-2": [_GPT2_EXPR],
    "qwen2": [
        _CONTRACT_CI
        + r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
        + r"|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "poro": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "chatglm4": [_LLAMA3_EXPR],
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "tekken": [
        r"[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))*((?=[\p{L}])([^A-Z]))+"
        r"|[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))+((?=[\p{L}])([^A-Z]))*"
        r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "chameleon": [
        "<sentinel:[0-9]+>",
        "(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
        "([\\t\\n]|    |  )",
        r"\p{N}",
        r"[\p{P}!-/:-@\[-`{-~]",
        _GPT2_EXPR,
    ],
    "gpt-4o": [
        r"[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))*((?=[\p{L}])([^A-Z]))+"
        + _CONTRACT_CI + "?"
        + r"|[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))+((?=[\p{L}])([^A-Z]))*"
        + _CONTRACT_CI + "?"
        + r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "superbpe": [r"\p{N}+", r"(?=(\d{3})+(?!\d))"],
    "bailingmoe": [
        r"'(?:[sSdDmMtT]|[lL][lL]|[vV][eE]|[rR][eE])|[^\r\n\p{L}\p{N}]?\p{L}+"
        r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+",
    ],
    "default": [
        r"[\p{P}\$\+<=>\^~\|]+",
        _GPT2_EXPR,
        r"\p{N}+",
        "[0-9][0-9][0-9]",
    ],
}

# pre-type-name (tokenizer.ggml.pre) -> regex-set key
# (llama-vocab.cpp:1504-1642 pre_type selection)
PRE_TO_SET: dict[str, str] = {
    "default": "default",
    "llama3": "llama3", "llama-v3": "llama3", "llama-bpe": "llama3",
    "falcon3": "llama3",
    "deepseek-llm": "deepseek-llm",
    "deepseek-coder": "deepseek-coder",
    "deepseek-v3": "deepseek3",
    "falcon": "falcon",
    "mpt": "gpt-2", "olmo": "gpt-2", "jais": "gpt-2", "trillion": "gpt-2",
    "starcoder": "starcoder", "refact": "starcoder", "command-r": "starcoder",
    "smollm": "starcoder", "codeshell": "starcoder", "exaone": "starcoder",
    "minerva-7b": "starcoder",
    "gpt-2": "gpt-2", "phi-2": "gpt-2", "jina-es": "gpt-2", "jina-de": "gpt-2",
    "gigachat": "gpt-2", "jina-v1-en": "gpt-2", "jina-v2-es": "gpt-2",
    "jina-v2-de": "gpt-2", "jina-v2-code": "gpt-2", "roberta-bpe": "gpt-2",
    "qwen2": "qwen2", "deepseek-r1-qwen": "qwen2", "stablelm2": "qwen2",
    "megrez": "qwen2",
    "dbrx": "dbrx", "smaug-bpe": "dbrx",
    "poro-chat": "poro", "bloom": "poro", "gpt3-finnish": "poro",
    "chatglm-bpe": "chatglm4",
    "viking": "viking",
    "tekken": "tekken",
    "chameleon": "chameleon",
    "gpt-4o": "gpt-4o",
    "superbpe": "superbpe",
    "bailingmoe": "bailingmoe",
}

# pre types that disable space cleanup in detokenization
# (clean_spaces = false sites in llama-vocab.cpp:1504-1642)
NO_CLEAN_SPACES = {
    "deepseek-llm", "deepseek-coder", "deepseek-v3", "command-r", "qwen2",
    "deepseek-r1-qwen", "poro-chat", "viking", "tekken", "smollm",
    "chameleon", "gpt-4o", "superbpe", "trillion", "bailingmoe", "megrez",
}

# pre types where the whole word is first looked up in the vocab before
# any merges run (ignore_merges, llama-vocab.cpp:1512)
IGNORE_MERGES = {"llama3", "llama-v3", "llama-bpe", "falcon3"}


#: the Unicode White_Space code points (what `regex` reads as \s)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))

_CLASSES: dict[str, str] = {}


def _esc(c: int) -> str:
    return f"\\U{c:08x}"


def _class_body(spans) -> str:
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}"
                   for a, b in spans)


def _classes() -> dict[str, str]:
    """The body of a character class (ranges, no brackets) for each
    general-category letter L, N, P, S, M, and "s" for White_Space;
    built once from `unicodedata` (a scan of every code point)."""
    if _CLASSES:
        return _CLASSES
    spans: dict[str, list] = {k: [] for k in "LNPSM"}
    for c in range(sys.maxunicode + 1):
        k = unicodedata.category(chr(c))[0]
        if k in spans:
            sp = spans[k]
            if sp and sp[-1][1] == c - 1:
                sp[-1][1] = c
            else:
                sp.append([c, c])
    out = {k: _class_body(v) for k, v in spans.items()}
    out["s"] = _class_body(_WHITE_SPACE)
    _CLASSES.update(out)
    return _CLASSES


def translate(pattern: str) -> str:
    """A pattern of REGEX_SETS with its `\\p{X}`, `\\s` and `\\S` written
    as explicit character classes, for the standard `re`."""
    cls = _classes()
    out = []
    in_class = False
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt == "p" and pattern[i + 2:i + 3] == "{":
                end = pattern.index("}", i)
                body = cls[pattern[i + 3:end]]
                out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt == "s":
                out.append(cls["s"] if in_class else f"[{cls['s']}]")
            elif nxt == "S" and not in_class:
                out.append(f"[^{cls['s']}]")
            elif nxt == "S":
                raise ValueError(f"\\S inside a class: {pattern!r}")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            # a leading ^ belongs to the class's opening
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            i += 1
            continue
        if ch == "]" and in_class:
            in_class = False
        out.append(ch)
        i += 1
    return "".join(out)


_COMPILED: dict[str, list] = {}


def compiled_set(pre: str) -> list:
    key = PRE_TO_SET.get(pre, "default")
    if key not in _COMPILED:
        _COMPILED[key] = [_re.compile(translate(p)) for p in REGEX_SETS[key]]
    return _COMPILED[key]


def regex_split(text: str, patterns: list) -> list[str]:
    """Sequential fragment splitting (unicode_regex_split semantics):
    every regex splits every current fragment; matched and unmatched spans
    both remain fragments for the next regex."""
    frags = [text]
    for pat in patterns:
        out = []
        for f in frags:
            pos = 0
            for m in pat.finditer(f):
                if m.start() > pos:
                    out.append(f[pos : m.start()])
                # zero-width matches (pure-lookahead sets like superbpe's
                # digit grouper) stay as EMPTY fragments, exactly like the
                # reference splitter (unicode.cpp:670 keeps every match
                # span; empty words tokenize to nothing downstream)
                out.append(m.group())
                pos = m.end()
            if pos < len(f):
                out.append(f[pos:])
        frags = out
    return frags
