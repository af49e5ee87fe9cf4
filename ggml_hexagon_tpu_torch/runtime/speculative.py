"""Speculative decoding with a draft model.

Counterpart of ggml_hexagon_tpu/runtime/speculative.py over the port's
Engine (its verify is Engine.eval_tokens: K1 over the 1 + k rows of a
short block, K3 above 8).  Mirrors common/speculative.cpp (SURVEY §A.4): the draft engine keeps its own
context/KV; per round it greedily proposes up to n_draft tokens, stopping
early when its top probability drops below p_min; the target then scores the
whole draft in one forward pass and the longest agreeing prefix is accepted
(common_sampler_sample_and_accept_n semantics — the chain samples at every
position and acceptance requires agreement).  Both caches are rewound to the
accepted frontier (KV truncation replaces the reference's seq_rm surgery).

Compatibility gate mirrors common_speculative_are_compatible
(speculative.cpp:77-135): same vocab family, |vocab| diff <= 128, token
texts identical from a low id upward.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine import Engine
from .sampling import SamplerChain, greedy_chain


@dataclass
class SpecStats:
    n_rounds: int = 0
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def accept_rate(self) -> float:
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0


def check_compat(target: Engine, draft: Engine, start_id: int = 5, max_vocab_diff: int = 128):
    tv, dv = target.vocab, draft.vocab
    if tv is None or dv is None:
        return
    if abs(tv.n_tokens - dv.n_tokens) > max_vocab_diff:
        raise ValueError(
            f"draft vocab size {dv.n_tokens} too different from target {tv.n_tokens}"
        )
    n = min(tv.n_tokens, dv.n_tokens)
    for i in range(start_id, n):
        if tv.tokens[i] != dv.tokens[i]:
            raise ValueError(f"draft/target token text mismatch at id {i}")


class SpeculativeDecoder:
    def __init__(
        self,
        target: Engine,
        draft: Engine,
        n_draft: int = 16,
        p_min: float = 0.75,
        check_vocab: bool = True,
    ):
        if check_vocab:
            check_compat(target, draft)
        self.target = target
        self.draft = draft
        self.n_draft = n_draft
        self.p_min = p_min
        self.stats = SpecStats()

    def _draft_tokens(self, settled: list[int]) -> list[int]:
        """Greedy draft proposals continuing `settled`; early-stop on low
        confidence.  The draft context re-syncs via longest-prefix reuse
        (the reference's prompt-reuse + KV surgery, speculative.cpp:194)."""
        logits = self.draft.prefill(
            np.asarray(settled, np.int64)[None], reuse_cache=True
        )
        out = []
        for _ in range(self.n_draft):
            l = logits[0]
            e = np.exp(l - l.max())
            p = e / e.sum()
            top = int(np.argmax(p))
            if p[top] < self.p_min:
                break
            out.append(top)
            if len(out) < self.n_draft:
                logits = self.draft.decode_one(np.array([top]))
        return out

    def generate(
        self,
        prompt_ids,
        n_predict: int = 64,
        sampler: SamplerChain | None = None,
        stop_ids: set | None = None,
    ) -> list[int]:
        sampler = sampler or greedy_chain()
        stop_ids = stop_ids if stop_ids is not None else (
            {self.target.vocab.eos_id} if self.target.vocab else set()
        )
        prompt_ids = list(prompt_ids)
        t_logits = self.target.prefill(np.asarray(prompt_ids, np.int64)[None])
        out: list[int] = []
        cur = sampler.sample(t_logits[0])
        if cur in stop_ids:
            return out
        out.append(cur)

        while len(out) < n_predict:
            settled = prompt_ids + out
            draft = self._draft_tokens(settled)
            self.stats.n_rounds += 1
            self.stats.n_drafted += len(draft)
            # target scores [cur, draft...] in one pass
            block = [cur] + draft
            all_logits = self.target.eval_tokens(block)  # [len(block), V]
            accepted = []
            done = False
            for i, d in enumerate(draft):
                tok = sampler.sample(all_logits[i])
                if tok == d:
                    accepted.append(d)
                    if d in stop_ids or len(out) + len(accepted) >= n_predict:
                        done = True
                        break
                else:
                    accepted.append(tok)  # target's correction
                    done = tok in stop_ids
                    break
            else:
                # all draft tokens agreed: sample one more from the last logits
                tok = sampler.sample(all_logits[len(draft)])
                accepted.append(tok)
                done = tok in stop_ids
            self.stats.n_accepted += sum(
                1 for i, d in enumerate(draft) if i < len(accepted) and accepted[i] == d
            )
            # rewind the target past the unconfirmed speculation; the draft
            # re-syncs itself at the next round's reuse-prefill
            n_keep = self.target.n_past - len(block) + len(accepted)
            self.target.truncate(n_keep)
            for t in accepted:
                if t in stop_ids:
                    done = True
                    break
                out.append(t)
            if done:
                break
            cur = out[-1]
        return out[:n_predict]
