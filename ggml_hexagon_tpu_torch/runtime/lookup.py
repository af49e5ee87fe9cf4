"""n-gram lookup decoding — model-free speculation.

Counterpart of ggml_hexagon_tpu/runtime/lookup.py over the port's Engine.
The analog of common/ngram-cache.{h,cpp} + examples/lookup: drafts come
from n-gram statistics of the already-seen context (and optionally a static
corpus cache) instead of a draft model; the target verifies them in one
pass exactly like draft-model speculation.  Greedy output is therefore
token-identical to plain decoding, with speedups on repetitive text.
"""
from __future__ import annotations

from collections import Counter, defaultdict

from .engine import Engine
from .speculative import SpeculativeDecoder, SpecStats

NGRAM_MIN = 1
NGRAM_MAX = 4


class NgramCache:
    """n-gram -> next-token counts for n in [NGRAM_MIN, NGRAM_MAX]."""

    def __init__(self):
        self.maps = {n: defaultdict(Counter) for n in range(NGRAM_MIN, NGRAM_MAX + 1)}

    def update(self, tokens: list[int]):
        for n in self.maps:
            m = self.maps[n]
            for i in range(len(tokens) - n):
                m[tuple(tokens[i : i + n])][tokens[i + n]] += 1

    def update_tail(self, tokens: list[int], n_new: int):
        """Incremental update covering n-grams ending in the last n_new tokens."""
        start = max(0, len(tokens) - n_new - NGRAM_MAX)
        self.update(tokens[start:]) if start == 0 else None
        for n in self.maps:
            m = self.maps[n]
            lo = max(0, len(tokens) - n_new - n)
            for i in range(lo, len(tokens) - n):
                m[tuple(tokens[i : i + n])][tokens[i + n]] += 1

    def predict(self, context: list[int]) -> int | None:
        """Most-frequent continuation, longest matching n-gram first."""
        for n in range(NGRAM_MAX, NGRAM_MIN - 1, -1):
            if len(context) < n:
                continue
            key = tuple(context[-n:])
            counts = self.maps[n].get(key)
            if counts:
                return counts.most_common(1)[0][0]
        return None

    def merge(self, other: "NgramCache"):
        for n in self.maps:
            for key, counts in other.maps[n].items():
                self.maps[n][key].update(counts)


class LookupDecoder(SpeculativeDecoder):
    """Speculative decoding drafted by the n-gram cache (no draft model)."""

    def __init__(self, target: Engine, n_draft: int = 8,
                 static_cache: NgramCache | None = None):
        # no draft engine; bypass SpeculativeDecoder.__init__
        self.target = target
        self.draft = None
        self.n_draft = n_draft
        self.p_min = 0.0
        self.stats = SpecStats()
        self.cache = NgramCache()
        if static_cache is not None:
            self.cache.merge(static_cache)
        self._seen = 0

    def _draft_tokens(self, settled: list[int]) -> list[int]:
        self.cache.update_tail(settled, len(settled) - self._seen)
        self._seen = len(settled)
        out: list[int] = []
        ctx = list(settled)
        for _ in range(self.n_draft):
            nxt = self.cache.predict(ctx)
            if nxt is None:
                break
            out.append(nxt)
            ctx.append(nxt)
        return out
