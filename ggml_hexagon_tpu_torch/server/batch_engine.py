"""Continuous-batching scheduler: the server's core.

Counterpart of ggml_hexagon_tpu/server/batch_engine.py.  A fixed pool of
slots, each an independent sequence with its own sampler state; every
scheduler tick either (a) processes pending prompt chunks, all slots with
outstanding prompt tokens advancing together in one [B, PROMPT_CHUNK]
forward, or (b) decodes one token for every generating slot in one [B, 1]
forward.  Rows sit at their own cache positions (the forward's per-row
offsets); idle rows are "parked": they feed a pad token at the reserved
last cache slot, which no live row attends, so the batch shape never
changes with the traffic.  On the card the prompt ticks run K3 on B *
PROMPT_CHUNK rows and the decode ticks K1/K2 at B rows and K4 with one
position a row.

Every device call of a scheduler tick runs in the caller's thread on the
current stream; the HTTP server takes `lock` around each (the kernels'
device counters, kernels._COUNTERS, are one buffer a device).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from functools import partial
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import (LlamaConfig, _check_fused, check_supported,
                            forward, init_kv_cache, kv_bits)
from ..ops.decode_attn import pack_int4, unpack_int4
from ..runtime.sampling import SamplerChain, greedy_chain

PROMPT_CHUNK = 128


class SlotState(Enum):
    IDLE = 0
    PROMPT = 1
    GENERATING = 2


@dataclass
class Slot:
    id: int
    state: SlotState = SlotState.IDLE
    prompt: list = field(default_factory=list)
    n_prompt_done: int = 0
    n_past: int = 0
    generated: list = field(default_factory=list)
    settled: list = field(default_factory=list)  # tokens whose rows are cached
    n_predict: int = 0
    sampler: Optional[SamplerChain] = None
    stop_ids: set = field(default_factory=set)
    stop_strings: list = field(default_factory=list)
    out_queue: Optional[queue.Queue] = None
    pending_logits: Optional[np.ndarray] = None
    # a speculative round emits every accepted token, each sampled exactly
    # once; the last one is carried here as the next round's `cur` instead
    # of being sampled again from pending_logits (which would advance a
    # stateful sampler twice for it)
    pending_tok: Optional[int] = None
    t_start: float = 0.0
    t_first_token: float = 0.0
    finish_reason: str = ""
    n_decoded: int = 0

    def reset(self):
        self.state = SlotState.IDLE
        self.prompt = []
        self.n_prompt_done = 0
        self.n_past = 0
        self.generated = []
        self.settled = []
        self.sampler = None
        self.pending_logits = None
        self.pending_tok = None
        self.t_first_token = 0.0
        self.finish_reason = ""
        self.n_decoded = 0

    def release(self):
        """Finish the request but keep the cache bookkeeping (settled
        tokens and n_past), so the next request on this slot can reuse the
        longest common token prefix without prefilling it again."""
        settled, n_past = self.settled, self.n_past
        self.reset()
        self.settled, self.n_past = settled, n_past


def load_fused(path, device):
    """(cfg, weights, vocab, metadata) of a GGUF file (a path, or a buffer
    holding its bytes) through the load pipeline the port's forward takes:
    the NEOX rope permutation, the projection fusion, the wire planes
    dropped (runtime/engine.Engine.from_gguf with fuse=True)."""
    from ..gguf.reader import GGUFReader
    from ..models.fuse import fuse_weights, permute_rope_neox
    from ..models.llama import load_llama_weights
    from ..quant.pack import drop_wire_planes
    from ..tokenizer import Vocab

    reader = (GGUFReader.open(path) if isinstance(path, (str, os.PathLike))
              else GGUFReader.from_buffer(path))
    with reader as r:
        cfg, weights = load_llama_weights(r, device)
        vocab = Vocab.from_gguf(r.metadata)
        md = dict(r.metadata)
    weights, cfg = permute_rope_neox(weights, cfg)
    weights = drop_wire_planes(fuse_weights(weights, cfg))
    return cfg, weights, vocab, md


class DraftModel:
    """Per-slot draft state for server-side speculative decoding: one small
    model, one batched KV cache with the target's slot layout; proposals
    run as k greedy [B, 1] forwards."""

    def __init__(self, cfg, weights, n_slots: int, max_seq: int,
                 compute_dtype=torch.bfloat16, kv_dtype="bf16",
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.weights = weights
        self.kv = init_kv_cache(cfg, n_slots, max_seq, kv_dtype, self.device)
        self.n_past = np.zeros(n_slots, np.int64)  # settled tokens in KV
        self.max_seq = max_seq
        self._fwd = partial(forward, cfg, compute_dtype=compute_dtype)

    @classmethod
    def from_gguf(cls, path, n_slots: int, max_seq: int, **kw):
        cfg, weights, _, _ = load_fused(
            path, resolve_device(kw.get("device", "cuda")))
        return cls(cfg, weights, n_slots, max_seq, **kw)

    def reset_slot(self, slot_id: int):
        self.n_past[slot_id] = 0


class BatchEngine:
    """Fixed-slot continuous-batching engine over one model."""

    def __init__(self, cfg: LlamaConfig, weights: dict, vocab=None,
                 n_slots: int = 4, max_seq: int = 1024, kv_dtype="bf16",
                 compute_dtype=torch.bfloat16,
                 draft: Optional[DraftModel] = None, n_draft: int = 8,
                 draft_p_min: float = 0.75, ctx_shift: bool = False,
                 n_keep: int = 0, device="cuda"):
        self.device = resolve_device(device)
        check_supported(cfg)
        for lw in weights.get("layers", []):
            _check_fused(lw)
        self.cfg = cfg
        self.weights = weights
        self.vocab = vocab
        self.metadata = {}
        self.n_slots = n_slots
        self.max_seq = max_seq  # last slot reserved for parked writes
        self.kv = init_kv_cache(cfg, n_slots, max_seq, kv_dtype, self.device)
        self.slots = [Slot(i) for i in range(n_slots)]
        self.park_pos = max_seq - 1
        self.draft = draft
        self.n_draft = n_draft
        self.draft_p_min = draft_p_min
        # a full slot shifts its context instead of finishing: n_keep
        # tokens stay, half of the rest is discarded
        self.ctx_shift = ctx_shift
        self.n_keep = n_keep
        self._fwd = partial(forward, cfg, compute_dtype=compute_dtype)
        self.lock = threading.Lock()
        self.pending: queue.Queue = queue.Queue()
        self.metrics = {
            "n_requests": 0, "n_tokens_generated": 0, "n_prompt_tokens": 0,
            "n_prompt_tokens_cached": 0,
            "t_decode": 0.0, "t_prompt": 0.0,
            "n_draft_proposed": 0, "n_draft_accepted": 0, "n_ctx_shifts": 0,
            "n_draft_rounds_decoupled": 0,
        }
        # time-to-first-token of the last 512 requests, in seconds
        self.ttft_samples = deque(maxlen=512)

    @classmethod
    def from_gguf(cls, path, **kw) -> "BatchEngine":
        """Load a GGUF file (a path, or a buffer holding its bytes) through
        the fused load pipeline; kw go to BatchEngine (n_slots, max_seq,
        kv_dtype, device, draft, ...)."""
        cfg, weights, vocab, md = load_fused(
            path, resolve_device(kw.get("device", "cuda")))
        eng = cls(cfg, weights, vocab, **kw)
        eng.metadata = md
        return eng

    def _t(self, a):
        """A host int32 array as an int64 tensor on the engine's device."""
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def _run(self, fwd, weights, kv, tokens, pos, **kw):
        """One forward of host tokens [B, T] at host row offsets pos [B];
        returns (logits on the host as numpy, the cache)."""
        logits, kv = fwd(weights, self._t(tokens), kv, self._t(pos), **kw)
        return logits.cpu().numpy(), kv

    # -- request API ---------------------------------------------------------

    def submit(self, prompt_ids: list[int], n_predict: int = 64,
               sampler: Optional[SamplerChain] = None,
               stop_ids: Optional[set] = None,
               stop_strings: Optional[list] = None,
               cache_prompt: bool = True) -> queue.Queue:
        """Enqueue a request; returns a queue yielding (token|None,
        finish_reason)."""
        q: queue.Queue = queue.Queue()
        req = dict(prompt=list(prompt_ids), n_predict=n_predict,
                   sampler=sampler or greedy_chain(),
                   stop_ids=stop_ids if stop_ids is not None
                   else ({self.vocab.eos_id} if self.vocab else set()),
                   stop_strings=stop_strings or [], out=q,
                   cache_prompt=cache_prompt)
        self.pending.put(req)
        self.metrics["n_requests"] += 1
        return q

    # -- cached-prompt prefix reuse ------------------------------------------

    @staticmethod
    def _lcp(a: list, b: list) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _reusable(self, slot: Slot, req: dict) -> int:
        """Tokens of the request's prompt already resident in the slot's KV
        rows: the longest common prefix with the slot's settled tokens,
        capped so that at least one prompt token is evaluated (the logits
        to sample come from the last prompt position)."""
        if not req.get("cache_prompt", True):
            return 0
        prompt = req["prompt"]
        resident = slot.settled[: slot.n_past]
        return max(0, min(self._lcp(resident, prompt),
                          len(prompt) - 1, slot.n_past))

    def _launch(self, slot: Slot, req: dict):
        reuse = self._reusable(slot, req)
        slot.reset()
        slot.state = SlotState.PROMPT
        slot.prompt = req["prompt"]
        slot.settled = list(req["prompt"])
        slot.n_past = reuse          # KV rows [0, reuse) stay live
        slot.n_prompt_done = reuse   # prefill only the tail
        slot.n_predict = req["n_predict"]
        slot.sampler = req["sampler"]
        slot.stop_ids = req["stop_ids"]
        slot.stop_strings = req["stop_strings"]
        slot.out_queue = req["out"]
        slot.t_start = time.perf_counter()
        self.metrics["n_prompt_tokens"] += len(slot.prompt)
        self.metrics["n_prompt_tokens_cached"] += reuse
        if self.draft is not None:
            # the draft's rows were fed the same settled tokens at the same
            # positions: its prefix up to `reuse` stays valid too
            self.draft.n_past[slot.id] = min(
                int(self.draft.n_past[slot.id]), reuse)

    # -- scheduler tick --------------------------------------------------------

    def has_work(self) -> bool:
        return not self.pending.empty() or any(
            s.state != SlotState.IDLE for s in self.slots)

    def step(self):
        """One scheduler tick.  Returns True if any work was done."""
        # each pending request goes to the idle slot whose resident tokens
        # share the longest prefix with its prompt
        idle = [s for s in self.slots if s.state == SlotState.IDLE]
        while idle:
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            best = max(idle, key=lambda s: self._reusable(s, req))
            idle.remove(best)
            self._launch(best, req)

        prompt_slots = [s for s in self.slots if s.state == SlotState.PROMPT]
        if prompt_slots:
            self._prompt_tick(prompt_slots)
            return True
        gen_slots = [s for s in self.slots if s.state == SlotState.GENERATING]
        if gen_slots:
            self._decode_tick(gen_slots)
            return True
        return False

    def _prompt_tick(self, prompt_slots: list[Slot]):
        t0 = time.perf_counter()
        B = self.n_slots
        chunk = min(PROMPT_CHUNK, self.max_seq - 1)
        tokens = np.zeros((B, chunk), dtype=np.int32)
        pos = np.full(B, self.park_pos, dtype=np.int32)
        idx = np.zeros(B, dtype=np.int32)
        active = []
        for s in prompt_slots:
            rest = s.prompt[s.n_prompt_done:]
            take = min(len(rest), chunk)
            tokens[s.id, :take] = rest[:take]
            pos[s.id] = s.n_past
            idx[s.id] = take - 1
            active.append((s, take))
        logits, self.kv = self._run(self._fwd, self.weights, self.kv, tokens,
                                    pos, logits_idx=self._t(idx))
        if self.draft is not None:
            # mirror the prompt into the draft cache
            d = self.draft
            _, d.kv = self._run(d._fwd, d.weights, d.kv, tokens, pos,
                                logits_idx=self._t(idx))
            for s, take in active:
                d.n_past[s.id] = s.n_past + take
        for s, take in active:
            s.n_prompt_done += take
            s.n_past += take
            if s.n_prompt_done >= len(s.prompt):
                s.state = SlotState.GENERATING
                s.pending_logits = logits[s.id]
        self.metrics["t_prompt"] += time.perf_counter() - t0

    def _decode_tick(self, gen_slots: list[Slot]):
        t0 = time.perf_counter()
        B = self.n_slots
        # sample on the host for every generating slot
        to_decode = []
        for s in gen_slots:
            if s.pending_tok is not None:
                # carried from the last speculative round: already sampled
                # and emitted there, fed now as this round's cur
                tok = s.pending_tok
                s.pending_tok = None
                to_decode.append((s, tok))
                continue
            tok = s.sampler.sample(s.pending_logits)
            if s.t_first_token == 0.0:
                s.t_first_token = time.perf_counter() - s.t_start
                self.ttft_samples.append(s.t_first_token)
            finished = self._emit(s, tok)
            if not finished:
                to_decode.append((s, tok))
        if not to_decode:
            self.metrics["t_decode"] += time.perf_counter() - t0
            return
        if self.draft is not None:
            self._spec_decode(to_decode)
            self.metrics["t_decode"] += time.perf_counter() - t0
            return
        tokens = np.zeros((B, 1), dtype=np.int32)
        pos = np.full(B, self.park_pos, dtype=np.int32)
        for s, tok in to_decode:
            tokens[s.id, 0] = tok
            pos[s.id] = s.n_past
        logits, self.kv = self._run(self._fwd, self.weights, self.kv, tokens,
                                    pos)
        for s, tok in to_decode:
            s.n_past += 1
            s.pending_logits = logits[s.id]
        self.metrics["t_decode"] += time.perf_counter() - t0

    # -- speculative decoding --------------------------------------------------

    @staticmethod
    def _spec_continue(n_alive: int, n_started: int) -> bool:
        """Keep batch-drafting while at least half the round's participants
        still want tokens: a minority of long-drafting slots must not hold
        the whole tick."""
        return 2 * n_alive >= n_started

    def _spec_decode(self, to_decode):
        """One speculative round for every decoding slot: the draft proposes
        up to n_draft greedy tokens a slot (stopped early below p_min), the
        target scores [cur] + draft in ONE [B, 1+k] forward, and each slot
        accepts its longest agreeing prefix."""
        B = self.n_slots
        d = self.draft
        k = self.n_draft
        # 1. draft catch-up: feed settled tokens the draft has not seen (the
        #    previous round's accepted and correction tokens)
        for _ in range(64):  # bounded; the lag is ~1-2 tokens a round
            lags = []
            for s, tok in to_decode:
                lag = len(s.settled) - int(d.n_past[s.id])
                if lag > 0:
                    lags.append((s, s.settled[int(d.n_past[s.id])]))
            if not lags:
                break
            tokens = np.zeros((B, 1), np.int32)
            pos = np.full(B, d.max_seq - 1, np.int32)
            for s, nxt in lags:
                tokens[s.id, 0] = nxt
                pos[s.id] = int(d.n_past[s.id])
            _, d.kv = self._run(d._fwd, d.weights, d.kv, tokens, pos)
            for s, _ in lags:
                d.n_past[s.id] += 1
        # 2. propose: k greedy draft steps, all slots batched; a slot stops
        #    early when the draft's confidence drops below p_min
        proposals = {s.id: [] for s, _ in to_decode}
        alive = {s.id for s, _ in to_decode}
        n_started = len(alive)
        # seed: the draft's next-token distribution after [..settled, cur]
        tokens = np.zeros((B, 1), np.int32)
        pos = np.full(B, d.max_seq - 1, np.int32)
        for s, tok in to_decode:
            tokens[s.id, 0] = tok
            pos[s.id] = int(d.n_past[s.id])
        d_logits, d.kv = self._run(d._fwd, d.weights, d.kv, tokens, pos)
        d_written = {s.id: 1 for s, _ in to_decode}  # cur row in draft KV
        for step in range(k):
            tokens = np.zeros((B, 1), np.int32)
            pos = np.full(B, d.max_seq - 1, np.int32)
            for s, _ in to_decode:
                if s.id not in alive:
                    continue
                row = d_logits[s.id]
                e = np.exp(row - row.max())
                p = e / e.sum()
                top = int(np.argmax(p))
                if p[top] < self.draft_p_min:
                    alive.discard(s.id)
                    continue
                proposals[s.id].append(top)
                tokens[s.id, 0] = top
                pos[s.id] = int(d.n_past[s.id]) + d_written[s.id]
            if not alive or step == k - 1:
                break
            if not self._spec_continue(len(alive), n_started):
                # each batched draft step costs a [B, 1] draft forward for
                # every slot: once most slots stopped, end the round
                self.metrics["n_draft_rounds_decoupled"] += 1
                break
            d_logits, d.kv = self._run(d._fwd, d.weights, d.kv, tokens, pos)
            for s, _ in to_decode:
                if s.id in alive:
                    d_written[s.id] += 1
        n_prop = max((len(v) for v in proposals.values()), default=0)
        self.metrics["n_draft_proposed"] += sum(map(len, proposals.values()))
        # 3. target verification: ONE [B, 1+n_prop] forward, all positions
        width = 1 + n_prop
        tokens = np.zeros((B, width), np.int32)
        pos = np.full(B, self.park_pos, np.int32)
        for s, tok in to_decode:
            row = [tok] + proposals[s.id]
            tokens[s.id, :len(row)] = row
            pos[s.id] = s.n_past
        logits, self.kv = self._run(self._fwd, self.weights, self.kv, tokens,
                                    pos, logits_all=True)
        # 4. accept the longest agreeing prefix a slot.  Each position is
        #    sampled exactly once (sample, accept into the sampler, stop at
        #    the first disagreement); every accepted token is emitted now,
        #    and the last one carries over as the next round's cur through
        #    pending_tok
        for s, tok in to_decode:
            prop = proposals[s.id]
            accepted = []
            for i, dtok in enumerate(prop):
                t_tok = s.sampler.sample(logits[s.id, i])
                if t_tok == dtok:
                    accepted.append(dtok)
                else:
                    accepted.append(t_tok)  # the target's correction
                    break
            else:
                accepted.append(s.sampler.sample(logits[s.id, len(prop)]))
            n_agree = sum(1 for i, dtok in enumerate(prop)
                          if i < len(accepted) and accepted[i] == dtok)
            self.metrics["n_draft_accepted"] += n_agree
            # rows beyond the accepted frontier are stale: masking hides
            # them and later writes overwrite them
            s.n_past += len(accepted)
            s.pending_logits = logits[s.id, len(accepted) - 1]
            # the draft's rows for cur and the agreeing prefix are already
            # right: advance its frontier, so catch-up feeds only the
            # correction token
            d.n_past[s.id] += 1 + min(n_agree,
                                      max(d_written.get(s.id, 1) - 1, 0))
            for j, a in enumerate(accepted):
                if self._emit(s, a) or s.state != SlotState.GENERATING:
                    break
                if j == len(accepted) - 1:
                    s.pending_tok = a

    def _emit(self, s: Slot, tok: int) -> bool:
        """Deliver a sampled token; returns True when the slot finished."""
        if tok in s.stop_ids:
            return self._finish(s, "stop")
        s.generated.append(tok)
        s.settled.append(tok)
        s.n_decoded += 1
        self.metrics["n_tokens_generated"] += 1
        s.out_queue.put((tok, None))
        if s.stop_strings and self.vocab:
            text = "".join(self.vocab.tokens[t] for t in s.generated[-8:])
            if any(ss in text for ss in s.stop_strings):
                return self._finish(s, "stop_string")
        if s.n_decoded >= s.n_predict:
            return self._finish(s, "length")
        spec_room = 1 + (self.n_draft if self.draft is not None else 0)
        if s.n_past + spec_room >= self.max_seq - 1:
            if self.ctx_shift:
                # discard half the evictable prefix, positions re-rotated
                n_keep = min(self.n_keep, s.n_past - 2)
                n_discard = max((s.n_past - n_keep) // 2, 1)
                self.shift_slot(s.id, n_keep, n_discard)
                self.metrics["n_ctx_shifts"] += 1
                return False
            return self._finish(s, "context_full")
        return False

    def shift_slot(self, slot_id: int, n_keep: int, n_discard: int):
        """Context shift of one slot's rows of the shared cache: copied out,
        shifted with the K re-rotation (runtime/kv_ops.kv_shift) and
        written back; the other slots are untouched."""
        from ..runtime.kv_ops import kv_shift

        s = self.slots[slot_id]
        sub = {name: arr[:, slot_id:slot_id + 1].clone()
               for name, arr in self.kv.items()}
        sub = kv_shift(self.cfg, sub, n_keep, n_discard, s.n_past)
        for name, arr in sub.items():
            self.kv[name][:, slot_id:slot_id + 1] = arr
        s.n_past -= n_discard
        # the settled-token list mirrors the cache content
        s.settled = s.settled[:n_keep] + s.settled[n_keep + n_discard:]
        if self.draft is not None:
            # the draft's cache is invalid from n_keep on: refeed the
            # post-shift history in chunked prefill forwards now, not one
            # token a forward in the speculative catch-up
            self.draft.reset_slot(slot_id)
            self._draft_refeed(slot_id, s.settled[: s.n_past])

    def _draft_refeed(self, slot_id: int, toks: list):
        """Prefill one slot's draft cache with `toks` again in [B, chunk]
        forwards (the other rows parked); leaves draft.n_past = len(toks)."""
        d = self.draft
        B = self.n_slots
        chunk = min(PROMPT_CHUNK, d.max_seq - 1)
        done = 0
        while done < len(toks):
            take = min(chunk, len(toks) - done)
            tokens = np.zeros((B, chunk), np.int32)
            pos = np.full(B, d.max_seq - 1, np.int32)
            idx = np.zeros(B, np.int32)
            tokens[slot_id, :take] = toks[done:done + take]
            pos[slot_id] = done
            idx[slot_id] = take - 1
            _, d.kv = self._run(d._fwd, d.weights, d.kv, tokens, pos,
                                logits_idx=self._t(idx))
            done += take
        d.n_past[slot_id] = len(toks)

    def _finish(self, s: Slot, reason: str) -> bool:
        s.finish_reason = reason
        s.out_queue.put((None, reason))
        s.release()  # keep settled/n_past: the rows stay reusable
        return True

    # -- slot state save/restore -------------------------------------------------

    def save_slot(self, slot_id: int, path):
        """Persist a slot's KV rows and bookkeeping (llama-server
        /slots/{id}?action=save) in the JAX package's format: every cache
        plane [L, S, ...], f32 for the float planes (bf16 values, the k_d /
        v_d scales of a quantized cache), int8 for quantized values (a
        q4_0 cache unpacked), so a file of either package restores in the
        other."""
        s = self.slots[slot_id]
        planes = {}
        for name, arr in self.kv.items():
            a = arr[:, slot_id]
            if a.is_floating_point():
                planes[name] = a.to(torch.float32).cpu().numpy()
            elif a.dtype == torch.uint8:  # packed 4-bit values
                planes[name] = unpack_int4(a).cpu().numpy()
            else:
                planes[name] = a.cpu().numpy().astype(np.int8)
        # the slot's tokens (the cached rows are the first n_past): settled
        # is prompt + generated while a request runs and survives its end,
        # where the JAX package's prompt + generated is empty after release
        np.savez(path, n_past=np.int64(s.n_past),
                 prompt=np.asarray(s.settled, np.int64), **planes)

    def erase_slot(self, slot_id: int) -> int:
        """Drop a slot's cached tokens (/slots/{id}?action=erase); returns
        the number of erased cache tokens."""
        s = self.slots[slot_id]
        if s.state != SlotState.IDLE:
            raise RuntimeError(f"slot {slot_id} busy")
        n = s.n_past
        s.reset()
        return n

    def restore_slot(self, slot_id: int, path):
        z = np.load(path)
        s = self.slots[slot_id]
        if s.state != SlotState.IDLE:
            raise RuntimeError(f"slot {slot_id} busy")
        missing = [n for n in self.kv if n not in z]
        if missing:
            raise ValueError(
                f"slot file {path} lacks cache planes {missing} required by "
                "this engine's kv_dtype (saved with a different cache type?)")
        bits = kv_bits(self.kv)
        for name, dst in self.kv.items():
            a = torch.from_numpy(np.asarray(z[name]))
            if bits == 4 and name in ("k", "v"):
                a = pack_int4(a.to(torch.int8))
            dst[:, slot_id] = a.to(device=dst.device, dtype=dst.dtype)
        s.n_past = int(z["n_past"])
        s.prompt = z["prompt"].astype(int).tolist()
        s.n_prompt_done = len(s.prompt)
        # restored rows are reusable by the next request on this slot
        s.settled = list(s.prompt[: s.n_past])

    # -- blocking convenience ----------------------------------------------------

    def run_until_idle(self, max_ticks: int = 100000):
        for _ in range(max_ticks):
            if not self.has_work():
                return
            self.step()
        raise RuntimeError("scheduler did not drain")

    def complete(self, prompt_ids, **kw) -> list[int]:
        """Synchronous single-request helper."""
        q = self.submit(prompt_ids, **kw)
        self.run_until_idle()
        out = []
        while True:
            tok, fin = q.get_nowait()
            if tok is None:
                break
            out.append(tok)
        return out
