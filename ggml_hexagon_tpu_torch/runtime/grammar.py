"""GBNF grammar engine — parser + pushdown-automaton token constraints.

The port's own copy of ggml_hexagon_tpu/runtime/grammar.py (the port imports nothing of
the JAX package).

Same semantics as the reference (src/llama-grammar.cpp): a grammar is a set
of rules, each a list of alternates over char-range/rule-ref elements;
decoding state is a *set of stacks* whose tops are always character
expectations; sampling masks every token whose UTF-8 text cannot extend at
least one stack (llama_grammar_apply_impl), and EOS is legal only when some
stack has fully matched.  Repetitions desugar into recursive helper rules
exactly like the reference parser (parse_rule, llama-grammar.cpp:513).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np


@dataclass(frozen=True)
class Char:
    """Character expectation: set of inclusive codepoint ranges, maybe negated."""

    ranges: tuple[tuple[int, int], ...]
    negated: bool = False

    def matches(self, cp: int) -> bool:
        hit = any(lo <= cp <= hi for lo, hi in self.ranges)
        return (not hit) if self.negated else hit


@dataclass(frozen=True)
class RuleRef:
    rule: int


El = Union[Char, RuleRef]
Alt = tuple  # tuple[El, ...]


class GrammarParseError(ValueError):
    pass


class GBNFParser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rule_ids: dict[str, int] = {}
        self.rules: list[Optional[list[Alt]]] = []

    def _ws(self, newlines=True):
        t = self.text
        while self.pos < len(t):
            c = t[self.pos]
            if c == "#":
                while self.pos < len(t) and t[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            elif c == "\\" and newlines is False and self.pos + 1 < len(t) and t[self.pos + 1] == "\n":
                self.pos += 2
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        while (c := self._peek()) and (c.isalnum() or c in "-_"):
            self.pos += 1
        if start == self.pos:
            raise GrammarParseError(
                f"expected name at {start}: {self.text[start:start+20]!r}"
            )
        return self.text[start : self.pos]

    def _rule_id(self, name: str) -> int:
        if name not in self.rule_ids:
            self.rule_ids[name] = len(self.rules)
            self.rules.append(None)
        return self.rule_ids[name]

    def _new_rule(self, alts: list[Alt]) -> int:
        rid = len(self.rules)
        self.rules.append(alts)
        self.rule_ids[f"__anon_{rid}"] = rid
        return rid

    def _char(self) -> int:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self.text[self.pos]
        self.pos += 1
        simple = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91, "]": 93,
                  "^": 94, "-": 45, "/": 47}
        if e in simple:
            return simple[e]
        if e in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[e]
            v = int(self.text[self.pos : self.pos + n], 16)
            self.pos += n
            return v
        raise GrammarParseError(f"bad escape \\{e}")

    def parse(self) -> "Grammar":
        self._ws()
        while self.pos < len(self.text):
            name = self._name()
            self._ws()
            if self.text[self.pos : self.pos + 3] != "::=":
                raise GrammarParseError(f"expected ::= after {name!r}")
            self.pos += 3
            rid = self._rule_id(name)
            self.rules[rid] = self._alternates()
            self._ws()
        if "root" not in self.rule_ids:
            raise GrammarParseError("grammar has no root rule")
        for name, rid in self.rule_ids.items():
            if self.rules[rid] is None:
                raise GrammarParseError(f"rule {name!r} referenced but never defined")
        return Grammar(self.rules, self.rule_ids["root"])

    def _alternates(self) -> list[Alt]:
        alts = [self._sequence()]
        self._ws(newlines=False)
        while self._peek() == "|":
            self.pos += 1
            alts.append(self._sequence())
            self._ws(newlines=False)
        return alts

    def _sequence(self) -> Alt:
        out: list[El] = []
        self._ws(newlines=False)
        while True:
            c = self._peek()
            if c == '"':
                self.pos += 1
                lits: list[El] = []
                while self._peek() != '"':
                    if not self._peek():
                        raise GrammarParseError("unterminated string")
                    cp = self._char()
                    lits.append(Char(((cp, cp),)))
                self.pos += 1
                out.extend(self._maybe_rep(lits))
            elif c == "[":
                self.pos += 1
                negated = False
                if self._peek() == "^":
                    negated = True
                    self.pos += 1
                ranges = []
                while self._peek() != "]":
                    if not self._peek():
                        raise GrammarParseError("unterminated char class")
                    lo = self._char()
                    hi = lo
                    if self._peek() == "-" and self.text[self.pos + 1] != "]":
                        self.pos += 1
                        hi = self._char()
                    ranges.append((lo, hi))
                self.pos += 1
                out.extend(self._maybe_rep([Char(tuple(ranges), negated)]))
            elif c == "(":
                self.pos += 1
                alts = self._alternates()
                self._ws(newlines=False)
                if self._peek() != ")":
                    raise GrammarParseError("expected )")
                self.pos += 1
                rid = self._new_rule(alts)
                out.extend(self._maybe_rep([RuleRef(rid)]))
            elif c and (c.isalnum() or c in "-_"):
                name = self._name()
                rid = self._rule_id(name)
                out.extend(self._maybe_rep([RuleRef(rid)]))
            else:
                break
            self._ws(newlines=False)
        return tuple(out)

    def _maybe_rep(self, seq: list[El]) -> list[El]:
        """Handle *, +, ?, {n}, {n,}, {n,m} following `seq`.

        Desugars to recursive helper rules like the reference parser:
        S* -> R where R ::= S R | ε ; S{n,m} -> n copies + (m-n) optionals.
        """
        c = self._peek()
        if not c or c not in "*+?{":
            return seq
        self.pos += 1
        if c == "{":
            start = self.pos
            while self._peek() != "}":
                self.pos += 1
            body = self.text[start : self.pos]
            self.pos += 1
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s) if lo_s.strip() else 0
                hi = int(hi_s) if hi_s.strip() else -1
            else:
                lo = hi = int(body)
        elif c == "*":
            lo, hi = 0, -1
        elif c == "+":
            lo, hi = 1, -1
        else:  # ?
            lo, hi = 0, 1

        def star(sub: list[El]) -> El:
            rid = self._new_rule([])
            self.rules[rid] = [tuple(sub + [RuleRef(rid)]), tuple()]
            return RuleRef(rid)

        def opt(sub: list[El]) -> El:
            rid = self._new_rule([tuple(sub), tuple()])
            return RuleRef(rid)

        out: list[El] = []
        for _ in range(lo):
            out.extend(seq)
        if hi == -1:
            out.append(star(seq))
        else:
            for _ in range(hi - lo):
                out.append(opt(seq))
        return out


@dataclass
class Grammar:
    """Compiled grammar + PDA state (a set of stacks)."""

    rules: list[list[Alt]]
    root: int

    def __post_init__(self):
        # A stack is a tuple of El to consume, top LAST (the reference keeps
        # a vector of element pointers).  Stacks are kept normalized: the top
        # is always a Char expectation, or the stack is empty (match done).
        self.stacks: list[tuple] = self._expand((RuleRef(self.root),))

    def _expand(self, stack: tuple) -> list[tuple]:
        out: list[tuple] = []
        seen = set()

        def push(stack: tuple, depth: int):
            if depth > 256:
                # the reference rejects left-recursive grammars at parse time
                raise GrammarParseError("left-recursive grammar (expansion diverges)")
            if stack in seen:
                return
            seen.add(stack)
            if not stack or isinstance(stack[-1], Char):
                out.append(stack)
                return
            rest = stack[:-1]
            for alt in self.rules[stack[-1].rule]:
                push(rest + tuple(reversed(alt)), depth + 1)

        push(tuple(stack), 0)
        return out

    def copy(self) -> "Grammar":
        g = Grammar.__new__(Grammar)
        g.rules = self.rules
        g.root = self.root
        g.stacks = list(self.stacks)
        return g

    def accept_char(self, cp: int) -> bool:
        new: list[tuple] = []
        seen = set()
        for stack in self.stacks:
            if not stack:
                continue
            top = stack[-1]
            if top.matches(cp):
                for s in self._expand(stack[:-1]):
                    if s not in seen:
                        seen.add(s)
                        new.append(s)
        if not new:
            return False
        self.stacks = new
        return True

    def accept_text(self, text: str) -> bool:
        for ch in text:
            if not self.accept_char(ord(ch)):
                return False
        return True

    @property
    def can_end(self) -> bool:
        return any(len(s) == 0 for s in self.stacks)

    def text_is_acceptable(self, text: str) -> bool:
        g = self.copy()
        return g.accept_text(text)


class GrammarSampler:
    """Sampler-chain element applying grammar constraints to logits.

    Mirrors llama_sampler_grammar: apply() masks tokens whose text the PDA
    rejects; accept() advances the PDA with the chosen token's text.
    """

    name = "grammar"

    def __init__(self, grammar: Grammar, vocab_texts: list[str], eos_id: int,
                 lazy: bool = False, trigger_patterns: list | None = None,
                 trigger_tokens: list | None = None):
        self.grammar = grammar
        self.vocab_texts = vocab_texts
        self.eos_id = eos_id
        # lazy activation (llama_sampler_init_grammar_lazy_patterns,
        # include/llama.h:1298-1308; accept semantics
        # src/llama-grammar.cpp:1116-1160): while awaiting a trigger the
        # grammar is inert; a trigger TOKEN activates it feeding that
        # token's text, a trigger PATTERN full-matching the buffered output
        # activates it feeding from the first capture group
        import re

        self.lazy = lazy
        self.awaiting_trigger = lazy
        self.trigger_buffer = ""
        self.trigger_tokens = set(trigger_tokens or [])
        self.trigger_patterns = [re.compile(p, re.DOTALL)
                                 for p in (trigger_patterns or [])]

    @classmethod
    def from_vocab(cls, grammar: Grammar, vocab, **lazy_kw) -> "GrammarSampler":
        """Build using *surface* token texts: SPM space-escape undone, byte
        tokens as latin-1 chars, control tokens blanked (so they're masked).
        (The reference feeds decoded codepoints; partial-UTF8 accumulation
        across tokens is not yet modeled — ASCII-domain grammars exact.)"""
        texts = []
        for tid, t in enumerate(vocab.tokens):
            if vocab.is_byte(tid) and t.startswith("<0x"):
                texts.append(chr(int(t[3:5], 16)))
            elif vocab.is_control(tid):
                texts.append("")
            else:
                texts.append(t.replace("▁", " "))
        return cls(grammar, texts, vocab.eos_id, **lazy_kw)

    def reset(self):
        self.grammar = Grammar(self.grammar.rules, self.grammar.root)
        self.awaiting_trigger = self.lazy
        self.trigger_buffer = ""

    def apply(self, cand):
        """Mask every token whose text the PDA rejects (the reference
        validates the full candidate array, llama_grammar_apply_impl)."""
        if self.awaiting_trigger:  # inert until triggered (grammar.cpp:1121)
            return
        logits = cand.logits
        allowed_any = False
        for tid in range(logits.shape[0]):
            if not np.isfinite(logits[tid]):
                continue
            if tid == self.eos_id:
                if self.grammar.can_end:
                    allowed_any = True
                else:
                    logits[tid] = -np.inf
                continue
            text = self.vocab_texts[tid]
            if text and self.grammar.text_is_acceptable(text):
                allowed_any = True
            else:
                logits[tid] = -np.inf
        if not allowed_any:
            # dead end: force EOS (reference asserts; we fail soft)
            logits[:] = -np.inf
            logits[self.eos_id] = 0.0
        cand.probs = None

    def accept(self, token: int):
        if self.awaiting_trigger:
            piece = self.vocab_texts[token]
            if token in self.trigger_tokens:
                self.awaiting_trigger = False
                self.trigger_buffer = ""
                self.grammar.accept_text(piece)
                return
            self.trigger_buffer += piece
            for pat in self.trigger_patterns:
                m = pat.fullmatch(self.trigger_buffer)
                if m:
                    self.awaiting_trigger = False
                    start = m.start(1) if m.lastindex else 0
                    constrained = self.trigger_buffer[start:]
                    self.trigger_buffer = ""
                    self.grammar.accept_text(constrained)
                    return
            return
        if token == self.eos_id:
            return
        self.grammar.accept_text(self.vocab_texts[token])


def parse_gbnf(text: str) -> Grammar:
    return GBNFParser(text).parse()
