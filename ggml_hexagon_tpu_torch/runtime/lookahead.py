"""Lookahead decoding — Jacobi-iteration n-gram harvesting, no draft model.

Reference counterpart: examples/lookahead/lookahead.cpp (W window slots,
N-token levels, G verification n-grams — the "Break the Sequential
Dependency of LLM Inference Using Lookahead Decoding" scheme): every step
runs one Jacobi fixed-point iteration over a W-token guess window, keeps the
last N-1 iterations as levels, harvests an N-gram per window slot, and
verifies pool n-grams that start at the current token via the normal
speculative accept loop.

Counterpart of ggml_hexagon_tpu/runtime/lookahead.py over the port's
Engine: the reference packs window + verification branches into one batch
with a hand-built attention mask (lookahead.cpp:200-280); here the Jacobi
window runs as a plain sequential continuation (one Engine.eval_tokens over
the window) followed by a KV rewind, so every pass runs the same kernels as
the speculative verify.  Verification rides SpeculativeDecoder.generate
unchanged.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from .engine import Engine
from .speculative import SpecStats, SpeculativeDecoder


class LookaheadDecoder(SpeculativeDecoder):
    """Draftless speculation from a Jacobi-refined n-gram pool."""

    def __init__(self, target: Engine, n_window: int = 8, n_level: int = 4,
                 n_draft: int = 8, pool_cap: int = 16):
        self.target = target
        self.draft = None
        self.n_draft = n_draft
        self.p_min = 0.0
        self.stats = SpecStats()
        self.W = n_window
        self.N = n_level          # n-gram length (levels kept = N-1)
        self.pool_cap = pool_cap  # max n-grams kept per first-token key
        self.levels: list[list[int]] = []
        self.pool: dict[int, list[tuple[int, ...]]] = defaultdict(list)

    def _seed_window(self, settled: list[int]):
        """Init guesses from the prompt tail (lookahead.cpp:156-160)."""
        tail = (settled * ((self.W // len(settled)) + 1))[-self.W:]
        self.levels = [list(tail) for _ in range(self.N - 1)]

    def _jacobi_step(self, settled: list[int]):
        """One fixed-point iteration: evaluate the current guess window as a
        continuation, argmax-refine every slot, harvest one n-gram per slot."""
        guesses = self.levels[-1]
        block = [settled[-1]] + guesses[:-1]
        logits = self.target.eval_tokens(block)          # [W, V]
        new = [int(np.argmax(logits[i])) for i in range(self.W)]
        self.target.truncate(self.target.n_past - len(block))  # rewind KV
        if len(self.levels) == self.N - 1:
            # N-gram per slot: the N-1 stored levels + this refinement
            # (lookahead.cpp: ngrams are N tokens deep across the levels)
            for j in range(self.W):
                gram = tuple(lvl[j] for lvl in self.levels) + (new[j],)
                bucket = self.pool[gram[0]]
                if gram[1:] not in bucket:
                    bucket.append(gram[1:])
                    if len(bucket) > self.pool_cap:
                        bucket.pop(0)
        self.levels.append(new)
        if len(self.levels) > self.N - 1:
            self.levels.pop(0)

    def _draft_tokens(self, settled: list[int]) -> list[int]:
        if not self.levels:
            self._seed_window(settled)
        self._jacobi_step(settled)
        cont = self.pool.get(settled[-1])
        if not cont:
            return []
        return list(cont[-1])[: self.n_draft]  # most recent harvest first
