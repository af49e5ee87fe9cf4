"""Vocabulary loaded from GGUF metadata + special-token partitioning.

The port's own copy of ggml_hexagon_tpu/tokenizer/vocab.py (the port imports nothing of the JAX
package).

Mirrors the data model of the reference's llama_vocab (src/llama-vocab.cpp):
token texts + scores + type flags, special token ids, tokenizer-model
selection, per-model flag defaults (llama-vocab.cpp:1381-1675), the special
-tokens cache (llama-vocab.cpp:1999-2013), per-token LSTRIP/RSTRIP
attributes (llama-vocab.cpp:2034-2081), and tokenizer_st_partition
(llama-vocab.cpp:2193-2309) — the pass that splits raw text around special
-token literals BEFORE the family tokenizer runs, so chat-template markers
like <|start_header_id|> encode to their single control token instead of
being tokenized as plain text.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

_ASCII_WS = " \t\n\r\v\f"  # C isspace set (st_partition strips with isspace)


class TokenType(IntEnum):  # gguf token_type values
    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclass
class Vocab:
    tokens: list[str]
    scores: list[float]
    token_types: list[int]
    model: str = "llama"  # 'llama' (SPM) | 'gpt2' (BPE) | bert | t5 | rwkv
    pre: str = "default"  # BPE pre-tokenizer variant
    merges: list[str] = field(default_factory=list)
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    sep_id: int = -1
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    # detokenizer space cleanup (clean_spaces, llama-vocab.cpp:1504-1642)
    clean_spaces: bool = False
    # UGM flags (llama-vocab.cpp:1257-1264)
    remove_extra_whitespaces: bool = False
    treat_whitespace_as_suffix: bool = False
    # BPE: whole-word vocab hit short-circuits merging (llama3 family)
    ignore_merges: bool = False
    # UGM precompiled_charsmap normalization blob (XCDA + replacements)
    charsmap: bytes = b""
    by_text: dict = field(default_factory=dict)
    # per-token whitespace-strip attrs (reference LLAMA_TOKEN_ATTR_[LR]STRIP)
    lstrip_ids: set = field(default_factory=set)
    rstrip_ids: set = field(default_factory=set)
    # special-tokens cache: CONTROL|USER_DEFINED|UNKNOWN ids, longest first
    special_ids: list = field(default_factory=list)

    def __post_init__(self):
        if not self.by_text:
            self.by_text = {t: i for i, t in enumerate(self.tokens)}
        if not self.special_ids:
            special = (TokenType.CONTROL, TokenType.USER_DEFINED,
                       TokenType.UNKNOWN)
            ids = [i for i, tt in enumerate(self.token_types) if tt in special]
            ids.sort(key=lambda i: (-len(self.tokens[i]), i))
            self.special_ids = ids

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def is_control(self, tid: int) -> bool:
        return self.token_types[tid] == TokenType.CONTROL

    def is_byte(self, tid: int) -> bool:
        return self.token_types[tid] == TokenType.BYTE

    def is_user_defined(self, tid: int) -> bool:
        return self.token_types[tid] == TokenType.USER_DEFINED

    def is_unused(self, tid: int) -> bool:
        return self.token_types[tid] == TokenType.UNUSED

    def is_normal(self, tid: int) -> bool:
        return self.token_types[tid] == TokenType.NORMAL

    # -- special-token partitioning (tokenizer_st_partition) ----------------

    def partition_specials(self, text: str, parse_special: bool):
        """Split text around special-token literals -> [str | int] fragments.

        parse_special=False still partitions USER_DEFINED tokens (the HF
        pre-tokenization behavior the reference preserves,
        llama-vocab.cpp:2199-2205); CONTROL/UNKNOWN need parse_special.
        """
        frags: list = [text] if text else []
        for sid in self.special_ids:
            ttype = self.token_types[sid]
            if not parse_special and ttype in (TokenType.CONTROL,
                                               TokenType.UNKNOWN):
                continue
            st = self.tokens[sid]
            if not st:
                continue
            out: list = []
            for f in frags:
                if isinstance(f, int):
                    out.append(f)
                    continue
                rest = f
                while rest:
                    i = rest.find(st)
                    if i < 0:
                        out.append(rest)
                        break
                    left = rest[:i]
                    if sid in self.lstrip_ids:
                        left = left.rstrip(_ASCII_WS)
                    if left:
                        out.append(left)
                    out.append(sid)
                    rest = rest[i + len(st):]
                    if sid in self.rstrip_ids:
                        rest = rest.lstrip(_ASCII_WS)
            frags = out
        return frags

    @classmethod
    def from_gguf(cls, md: dict) -> "Vocab":
        tokens = md.get("tokenizer.ggml.tokens", [])
        n = len(tokens)
        model = md.get("tokenizer.ggml.model", "llama")
        pre = md.get("tokenizer.ggml.pre", "default") or "default"

        # per-model flag defaults (llama-vocab.cpp:1381-1675)
        if model in ("gpt2", "bpe"):
            from .pretok import IGNORE_MERGES, NO_CLEAN_SPACES

            defaults = dict(bos=11, eos=11, unk=-1, sep=-1, pad=-1,
                            add_bos=pre in IGNORE_MERGES,
                            add_eos=False, add_space_prefix=False,
                            clean_spaces=pre not in NO_CLEAN_SPACES,
                            ignore_merges=pre in IGNORE_MERGES)
        elif model in ("bert", "wpm"):
            # reference WPM appends [SEP] whenever add_special
            # (llama-vocab.cpp:2449-2473) -> model-default add_eos=True
            defaults = dict(bos=101, eos=102, unk=100, sep=102, pad=0,
                            add_bos=True, add_eos=True,
                            add_space_prefix=False, clean_spaces=True,
                            ignore_merges=False)
        elif model in ("t5", "ugm", "unigram"):
            defaults = dict(bos=-1, eos=1, unk=2, sep=-1, pad=0,
                            add_bos=False, add_eos=True,
                            add_space_prefix=True, clean_spaces=False,
                            ignore_merges=False)
        elif model == "rwkv":
            defaults = dict(bos=-1, eos=-1, unk=-1, sep=-1, pad=-1,
                            add_bos=False, add_eos=False,
                            add_space_prefix=False, clean_spaces=False,
                            ignore_merges=False)
        else:  # SPM
            defaults = dict(bos=1, eos=2, unk=0, sep=-1, pad=-1,
                            add_bos=True, add_eos=False,
                            add_space_prefix=True, clean_spaces=False,
                            ignore_merges=False)

        g = lambda key, d: md.get(f"tokenizer.ggml.{key}", d)
        charsmap = md.get("tokenizer.ggml.precompiled_charsmap", b"")
        if isinstance(charsmap, list):
            charsmap = bytes(x & 0xFF for x in charsmap)
        v = cls(
            tokens=tokens,
            scores=md.get("tokenizer.ggml.scores", [0.0] * n),
            token_types=md.get("tokenizer.ggml.token_type",
                               [TokenType.NORMAL] * n),
            model=model,
            pre=pre,
            merges=md.get("tokenizer.ggml.merges", []),
            bos_id=int(g("bos_token_id", defaults["bos"])),
            eos_id=int(g("eos_token_id", defaults["eos"])),
            unk_id=int(g("unknown_token_id", defaults["unk"])),
            sep_id=int(g("seperator_token_id", defaults["sep"])),
            pad_id=int(g("padding_token_id", defaults["pad"])),
            add_bos=bool(g("add_bos_token", defaults["add_bos"])),
            add_eos=bool(g("add_eos_token", defaults["add_eos"])),
            add_space_prefix=bool(g("add_space_prefix",
                                    defaults["add_space_prefix"])),
            clean_spaces=defaults["clean_spaces"],
            remove_extra_whitespaces=bool(
                g("remove_extra_whitespaces", False)),
            ignore_merges=defaults["ignore_merges"],
            charsmap=charsmap,
        )
        # per-token attribute special cases (llama-vocab.cpp:2034-2081)
        name = str(md.get("general.name", "")).lower()
        if any(p in pre for p in ("jina-v2-de", "jina-v2-es", "jina-v2-code")):
            if "<mask>" in v.by_text:
                v.lstrip_ids.add(v.by_text["<mask>"])
        elif "phi-3" in name or "phi3" in name:
            v.rstrip_ids.update(v.special_ids)
            for t in ("</s>",):
                if t in v.by_text:
                    v.rstrip_ids.add(v.by_text[t])
            for t in ("<unk>", "<s>", "<|endoftext|>"):
                if t in v.by_text:
                    v.rstrip_ids.discard(v.by_text[t])
        return v


class BaseTokenizer:
    """Shared encode loop: BOS/EOS policy + special-token partitioning +
    per-family fragment tokenization (llama_vocab::impl::tokenize,
    llama-vocab.cpp:2355-2550)."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    # family hook: tokenize one raw-text fragment into out
    def _fragment(self, text: str, out: list[int], prev_special: bool):
        raise NotImplementedError

    def _final_id(self):
        """Token appended when add_eos (WPM appends [SEP])."""
        return self.vocab.eos_id

    def encode(self, text: str, add_bos: bool | None = None,
               add_eos: bool | None = None,
               parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        ab = v.add_bos if add_bos is None else add_bos
        ae = v.add_eos if add_eos is None else add_eos
        if ab and v.bos_id >= 0:
            out.append(v.bos_id)
        prev_special = True  # SPM: space-prefix the first raw fragment
        for frag in self.vocab.partition_specials(text, parse_special):
            if isinstance(frag, int):
                out.append(frag)
                prev_special = True
            else:
                self._fragment(frag, out, prev_special)
                prev_special = False
        if ae:
            fid = self._final_id()
            if fid >= 0:
                out.append(fid)
        return out

    def decode(self, ids, skip_special: bool = True) -> str:
        raise NotImplementedError


def build_tokenizer(vocab: Vocab):
    from .bpe import BPETokenizer
    from .spm import SPMTokenizer
    from .ugm import UGMTokenizer
    from .wpm import WPMTokenizer

    if vocab.model in ("llama", "spm"):
        return SPMTokenizer(vocab)
    if vocab.model in ("gpt2", "bpe"):
        return BPETokenizer(vocab)
    if vocab.model in ("bert", "wpm"):
        return WPMTokenizer(vocab)
    if vocab.model in ("t5", "ugm", "unigram"):
        return UGMTokenizer(vocab)
    if vocab.model == "rwkv":
        from .rwkv import RWKVTokenizer

        return RWKVTokenizer(vocab)
    raise NotImplementedError(f"tokenizer model {vocab.model!r}")
