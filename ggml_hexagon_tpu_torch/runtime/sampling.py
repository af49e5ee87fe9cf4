"""Sampler chain — host-side, NumPy.

The port's own copy of ggml_hexagon_tpu/runtime/sampling.py (the port imports nothing of the JAX
package).

Mirrors the reference's sampler architecture (src/llama-sampling.cpp: chain
of vtable objects over a token-data array; common/sampling.cpp:225 chain
order): each sampler transforms a candidate array (logits or probs) and the
chain ends in greedy or seeded-dist selection.  Samplers keep the same
semantics (top-k/top-p/min-p/typical/temp-ext/XTC/top-n-sigma/penalties/
mirostat) so sampling-dependent outputs are comparable with llama.cpp.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Candidates:
    """Token-data array: ids + logits (+ probs once computed)."""

    logits: np.ndarray  # [n_vocab] f32, -inf = masked out
    probs: Optional[np.ndarray] = None

    def softmax(self):
        l = self.logits - self.logits.max()
        e = np.exp(l, dtype=np.float64)
        self.probs = (e / e.sum()).astype(np.float32)
        return self.probs


class Sampler:
    name = "base"

    def apply(self, cand: Candidates) -> None:
        raise NotImplementedError

    def accept(self, token: int) -> None:
        pass

    def reset(self) -> None:
        pass


class LogitBias(Sampler):
    name = "logit-bias"

    def __init__(self, bias: dict[int, float]):
        self.bias = bias

    def apply(self, cand):
        for tid, b in self.bias.items():
            cand.logits[tid] += b


class Temp(Sampler):
    name = "temp"

    def __init__(self, t: float):
        self.t = t

    def apply(self, cand):
        if self.t > 0:
            cand.logits /= self.t


class TempExt(Sampler):
    """Dynamic temperature (entropy-scaled), llama-sampling.cpp temp_ext."""

    name = "temp-ext"

    def __init__(self, t: float, delta: float = 0.0, exponent: float = 1.0):
        self.t, self.delta, self.exponent = t, delta, exponent

    def apply(self, cand):
        if self.delta <= 0:
            if self.t > 0:
                cand.logits /= self.t
            return
        p = Candidates(cand.logits.copy()).softmax()
        live = p > 0
        ent = -(p[live] * np.log(p[live])).sum()
        max_ent = np.log(np.count_nonzero(live)) if np.count_nonzero(live) > 1 else 1.0
        norm_ent = ent / max_ent if max_ent > 0 else 0.0
        dyn_t = (self.t - self.delta) + 2 * self.delta * (norm_ent**self.exponent)
        if dyn_t > 0:
            cand.logits /= dyn_t


class TopK(Sampler):
    name = "top-k"

    def __init__(self, k: int):
        self.k = k

    def apply(self, cand):
        if self.k <= 0 or self.k >= cand.logits.size:
            return
        kth = np.partition(cand.logits, -self.k)[-self.k]
        cand.logits[cand.logits < kth] = -np.inf


class TopP(Sampler):
    name = "top-p"

    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, cand):
        if self.p >= 1.0:
            return
        probs = cand.softmax()
        order = np.argsort(-cand.logits, kind="stable")
        cum = np.cumsum(probs[order])
        keep_n = max(self.min_keep, int(np.searchsorted(cum, self.p) + 1))
        drop = order[keep_n:]
        cand.logits[drop] = -np.inf
        cand.probs = None


class MinP(Sampler):
    name = "min-p"

    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, cand):
        if self.p <= 0:
            return
        probs = cand.softmax()
        thresh = self.p * probs.max()
        mask = probs < thresh
        if (~mask).sum() < self.min_keep:
            order = np.argsort(-probs, kind="stable")
            mask = np.ones_like(mask)
            mask[order[: self.min_keep]] = False
        cand.logits[mask] = -np.inf
        cand.probs = None


class Typical(Sampler):
    name = "typical"

    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, cand):
        if self.p >= 1.0:
            return
        probs = cand.softmax().astype(np.float64)
        live = probs > 0
        ent = -(probs[live] * np.log(probs[live])).sum()
        shifted = np.where(live, np.abs(-np.log(np.where(live, probs, 1.0)) - ent), np.inf)
        order = np.argsort(shifted, kind="stable")
        cum = np.cumsum(probs[order])
        keep_n = max(self.min_keep, int(np.searchsorted(cum, self.p) + 1))
        drop = order[keep_n:]
        cand.logits[drop] = -np.inf
        cand.probs = None


class TopNSigma(Sampler):
    """Keep logits within n standard deviations of the max."""

    name = "top-n-sigma"

    def __init__(self, n: float):
        self.n = n

    def apply(self, cand):
        if self.n <= 0:
            return
        live = np.isfinite(cand.logits)
        l = cand.logits[live]
        cand.logits[cand.logits < l.max() - self.n * l.std()] = -np.inf


class XTC(Sampler):
    """Exclude-top-choices: with prob `p`, remove all but the last token
    whose prob exceeds `threshold` (llama-sampling.cpp xtc)."""

    name = "xtc"

    def __init__(self, p: float, threshold: float, seed: int = 0):
        self.p, self.threshold = p, threshold
        self.rng = np.random.default_rng(seed)

    def apply(self, cand):
        if self.p <= 0 or self.threshold > 0.5:
            return
        if self.rng.random() >= self.p:
            return
        probs = cand.softmax()
        above = np.flatnonzero(probs >= self.threshold)
        if above.size >= 2:
            order = above[np.argsort(-probs[above], kind="stable")]
            cand.logits[order[:-1]] = -np.inf
            cand.probs = None


class Penalties(Sampler):
    """repeat/freq/presence penalties over the last n accepted tokens."""

    name = "penalties"

    def __init__(self, last_n: int = 64, repeat: float = 1.0, freq: float = 0.0, presence: float = 0.0):
        self.last_n, self.repeat, self.freq, self.presence = last_n, repeat, freq, presence
        self.ring: list[int] = []

    def apply(self, cand):
        if self.repeat == 1.0 and self.freq == 0.0 and self.presence == 0.0:
            return
        if not self.ring:
            return
        counts: dict[int, int] = {}
        for t in self.ring[-self.last_n :]:
            counts[t] = counts.get(t, 0) + 1
        for t, c in counts.items():
            l = cand.logits[t]
            if self.repeat != 1.0:
                l = l / self.repeat if l > 0 else l * self.repeat
            cand.logits[t] = l - c * self.freq - (self.presence if c > 0 else 0.0)

    def accept(self, token):
        self.ring.append(token)
        if len(self.ring) > 4 * self.last_n:
            self.ring = self.ring[-self.last_n :]

    def reset(self):
        self.ring.clear()


class MirostatV2(Sampler):
    name = "mirostat-v2"

    def __init__(self, tau: float = 5.0, eta: float = 0.1, seed: int = 0):
        self.tau, self.eta = tau, eta
        self.mu = 2 * tau
        self.rng = np.random.default_rng(seed)
        self._last_surprise = 0.0

    def apply(self, cand):
        probs = cand.softmax()
        surprise = -np.log2(np.where(probs > 0, probs, 1e-30))
        mask = surprise > self.mu
        if mask.all():
            mask[np.argmax(probs)] = False
        cand.logits[mask] = -np.inf
        probs = cand.softmax()
        tid = int(self.rng.choice(probs.size, p=probs / probs.sum()))
        self._last_surprise = float(-np.log2(max(probs[tid], 1e-30)))
        self._selected = tid
        # mark the choice by masking everything else (chain tail picks it)
        keep = np.full(cand.logits.shape, -np.inf, dtype=np.float32)
        keep[tid] = 0.0
        cand.logits = keep
        cand.probs = None

    def accept(self, token):
        e = self._last_surprise - self.tau
        self.mu -= self.eta * e


class MirostatV1(Sampler):
    """Mirostat v1 (llama-sampling.cpp llama_sampler_mirostat_apply):
    estimate the Zipf exponent s_hat from the top-m probabilities, derive
    the top-k cut from the target surprise mu, then sample and update mu."""

    name = "mirostat"

    def __init__(self, n_vocab: int, tau: float = 5.0, eta: float = 0.1,
                 m: int = 100, seed: int = 0):
        self.n_vocab, self.tau, self.eta, self.m = n_vocab, tau, eta, m
        self.mu = 2 * tau
        self.rng = np.random.default_rng(seed)
        self._last_surprise = 0.0

    def apply(self, cand):
        probs = cand.softmax()
        order = np.argsort(-probs, kind="stable")
        p = probs[order]
        n = min(self.m - 1, p.size - 1)
        i = np.arange(n, dtype=np.float64)
        t_i = np.log((i + 2) / (i + 1))
        with np.errstate(divide="ignore", invalid="ignore"):
            b_i = np.log(np.maximum(p[:n], 1e-30) / np.maximum(p[1 : n + 1], 1e-30))
        s_hat = float(np.sum(t_i * b_i) / np.sum(t_i * t_i))
        eps_hat = s_hat - 1.0
        k = ((eps_hat * 2.0 ** self.mu) / (1 - self.n_vocab ** -eps_hat)) ** (1 / s_hat)
        k = max(int(k), 1)
        mask = np.full(probs.shape, -np.inf, dtype=np.float32)
        keep = order[:k]
        mask[keep] = cand.logits[keep]
        cand.logits = mask
        probs = cand.softmax().astype(np.float64)
        probs = probs / probs.sum()
        tid = int(self.rng.choice(probs.size, p=probs))
        self._last_surprise = float(-np.log2(max(probs[tid], 1e-30)))
        sel = np.full(cand.logits.shape, -np.inf, dtype=np.float32)
        sel[tid] = 0.0
        cand.logits = sel
        cand.probs = None

    def accept(self, token):
        self.mu -= self.eta * (self._last_surprise - self.tau)

    def reset(self):
        self.mu = 2 * self.tau


class Infill(Sampler):
    """Fill-in-middle sampler (llama-sampling.cpp llama_sampler_infill_apply):
    prefer EOG when its mass dominates, merge common-prefix token pieces,
    then keep only confident text tokens (p >= 0.2, then >= 1/(n_txt+1)).

    is_eog: token -> bool;  piece: token -> bytes;  eot_id: fallback token.
    """

    name = "infill"

    def __init__(self, is_eog, piece, eot_id: int, n_consider: int = 64):
        self.is_eog, self.piece, self.eot_id = is_eog, piece, eot_id
        self.n_consider = n_consider  # prefix-merge over the top-n only

    def apply(self, cand):
        probs = cand.softmax().astype(np.float64)
        eog = np.fromiter((self.is_eog(int(t)) for t in range(probs.size)),
                          dtype=bool, count=probs.size)
        p_eog = float(probs[eog].sum())
        p_txt = float(probs[~eog].sum())
        out = np.full(probs.shape, -np.inf, dtype=np.float32)
        if 3 * p_eog * probs.size > p_txt:  # EOG dominates -> keep only EOG
            out[eog] = cand.logits[eog]
            cand.logits = out
            cand.probs = None
            return
        # merge tokens whose piece is a prefix of another (top-n window)
        top = np.argsort(-probs, kind="stable")[: self.n_consider]
        pieces = {int(t): self.piece(int(t)) for t in top}
        p = probs.copy()
        alive = {int(t) for t in top if pieces[int(t)]}
        for t0 in list(alive):
            for t1 in list(alive):
                if t0 == t1 or t0 not in alive or t1 not in alive:
                    continue
                b0, b1 = pieces[t0], pieces[t1]
                if len(b0) <= len(b1) and b1[: len(b0)] == b0:
                    dst, src = (t1, t0) if p[t1] > p[t0] else (t0, t1)
                    p[dst] += p[src]
                    p[src] = 0.0
                    alive.discard(src)
        # threshold pass 1: drop non-EOG below 0.2
        keep = (p >= 0.2) | eog
        n_non_eog = int((keep & ~eog & (p > 0)).sum())
        if n_non_eog == 0:
            out[self.eot_id] = 0.0
            cand.logits = out
            cand.probs = None
            return
        p_kept = p * keep
        p_kept = p_kept / p_kept.sum()
        # threshold pass 2: drop non-EOG below 1/(n_non_eog+1)
        keep2 = (p_kept >= 1.0 / (n_non_eog + 1)) | (eog & keep)
        sel = keep & keep2 & (p > 0)
        if not sel.any():
            sel = keep
        with np.errstate(divide="ignore"):
            out[sel] = np.log(np.maximum(p[sel], 1e-30)).astype(np.float32)
        cand.logits = out
        cand.probs = None


class Dist(Sampler):
    """Final seeded categorical draw."""

    name = "dist"

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def apply(self, cand):
        pass  # selection happens in chain.sample

    def sample(self, cand: Candidates) -> int:
        probs = cand.softmax().astype(np.float64)
        probs = probs / probs.sum()
        return int(self.rng.choice(probs.size, p=probs))

    def reset(self):
        self.rng = np.random.default_rng(self.seed)


class Greedy(Sampler):
    name = "greedy"

    def apply(self, cand):
        pass

    def sample(self, cand: Candidates) -> int:
        return int(np.argmax(cand.logits))


@dataclass
class SamplerChain:
    """Ordered samplers; the last one must provide .sample()."""

    samplers: list = field(default_factory=list)
    n_sampled: int = 0

    def sample(self, logits: np.ndarray) -> int:
        cand = Candidates(np.asarray(logits, dtype=np.float32).copy())
        for s in self.samplers:
            s.apply(cand)
        tail = self.samplers[-1] if self.samplers else Greedy()
        token = tail.sample(cand) if hasattr(tail, "sample") else int(np.argmax(cand.logits))
        self.accept(token)
        self.n_sampled += 1
        return token

    def accept(self, token: int):
        for s in self.samplers:
            s.accept(token)

    def reset(self):
        for s in self.samplers:
            s.reset()
        self.n_sampled = 0


def make_chain(
    temp: float = 0.8,
    top_k: int = 40,
    top_p: float = 0.95,
    min_p: float = 0.05,
    typical_p: float = 1.0,
    penalty_last_n: int = 64,
    penalty_repeat: float = 1.0,
    penalty_freq: float = 0.0,
    penalty_present: float = 0.0,
    seed: int = 42,
    logit_bias: dict | None = None,
    mirostat: int = 0,
    mirostat_tau: float = 5.0,
    mirostat_eta: float = 0.1,
    n_vocab: int = 32000,
    grammar_sampler=None,
) -> SamplerChain:
    """Build the default chain in the reference's order (common/sampling.cpp:225).

    grammar_sampler: a runtime.grammar.GrammarSampler, applied before the
    chain (the reference's grammar-first mode)."""
    chain: list[Sampler] = []
    if grammar_sampler is not None:
        chain.append(grammar_sampler)
    if logit_bias:
        chain.append(LogitBias(logit_bias))
    chain.append(Penalties(penalty_last_n, penalty_repeat, penalty_freq, penalty_present))
    if temp <= 0:
        chain.append(Greedy())
        return SamplerChain(chain)
    if mirostat == 1:
        chain.append(Temp(temp))
        chain.append(MirostatV1(n_vocab=n_vocab, tau=mirostat_tau,
                                eta=mirostat_eta, seed=seed))
        chain.append(Dist(seed))
        return SamplerChain(chain)
    if mirostat == 2:
        chain.append(Temp(temp))
        chain.append(MirostatV2(mirostat_tau, mirostat_eta, seed))
        chain.append(Dist(seed))
        return SamplerChain(chain)
    if top_k > 0:
        chain.append(TopK(top_k))
    if typical_p < 1.0:
        chain.append(Typical(typical_p))
    if top_p < 1.0:
        chain.append(TopP(top_p))
    if min_p > 0:
        chain.append(MinP(min_p))
    chain.append(Temp(temp))
    chain.append(Dist(seed))
    return SamplerChain(chain)


def greedy_chain() -> SamplerChain:
    return SamplerChain([Greedy()])


class DRY(Sampler):
    """DRY (don't-repeat-yourself) sampler — penalizes tokens that would
    extend a sequence already seen in the recent context
    (llama-sampling.cpp llama_sampler_dry semantics, simplified matcher:
    exact suffix-extension search instead of the Z-array).

    penalty(tok) = multiplier * base^(match_len - allowed_length) applied
    when extending a repeat of length >= allowed_length.
    """

    name = "dry"

    def __init__(self, multiplier: float = 0.8, base: float = 1.75,
                 allowed_length: int = 2, penalty_last_n: int = 256,
                 breakers: tuple = ()):
        self.multiplier = multiplier
        self.base = base
        self.allowed_length = allowed_length
        self.penalty_last_n = penalty_last_n
        self.breakers = set(breakers)
        self.ring: list[int] = []

    def apply(self, cand):
        if self.multiplier <= 0 or len(self.ring) < self.allowed_length + 1:
            return
        ctx = self.ring[-self.penalty_last_n :]
        n = len(ctx)
        # longest suffix of ctx that also occurs earlier, per continuation
        penalties: dict[int, int] = {}
        max_check = min(n - 1, 64)
        for i in range(n - 1):  # position whose continuation we'd repeat
            # match length: longest common suffix of ctx[:i+1] and ctx
            l = 0
            while (l < max_check and i - l >= 0
                   and ctx[i - l] == ctx[n - 1 - l]
                   and ctx[i - l] not in self.breakers):
                l += 1
            if l >= self.allowed_length and i + 1 < n:
                nxt = ctx[i + 1]
                penalties[nxt] = max(penalties.get(nxt, 0), l)
        for tok, match_len in penalties.items():
            cand.logits[tok] -= self.multiplier * (
                self.base ** (match_len - self.allowed_length)
            )

    def accept(self, token):
        self.ring.append(token)
        if len(self.ring) > 4 * self.penalty_last_n:
            self.ring = self.ring[-self.penalty_last_n :]

    def reset(self):
        self.ring.clear()
