"""Inference engine: bucketed prefill and greedy decode over the port's
Llama forward.

Counterpart of ggml_hexagon_tpu/runtime/engine.py:25-120, 223-289, 338-378:
it owns the KV cache, feeds prompts in bucket-sized chunks (8/32/128/512),
decodes one token per step, and generates greedily.  Self-extend, LoRA,
the tokenizer and GGUF loading wait for later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import LlamaConfig, forward, init_kv_cache

PREFILL_BUCKETS = (8, 32, 128, 512)


class ContextOverflowError(RuntimeError):
    """The request does not fit the context window."""


@dataclass
class PerfCounters:
    """llama_perf_context-style counters (t_* in seconds, host clock
    around work that ends in a device synchronisation)."""

    t_prefill: float = 0.0
    t_decode: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0


class Engine:
    def __init__(self, cfg: LlamaConfig, weights: dict, max_seq: int = 2048,
                 batch: int = 1, kv_dtype="bf16", device="cuda",
                 compute_dtype=torch.bfloat16, plain: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg.resolve_rope_factors(max_seq)
        self.weights = weights
        self.max_seq = max_seq
        self.batch = batch
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        self.plain = plain
        self.kv = init_kv_cache(self.cfg, batch, max_seq, kv_dtype,
                                self.device)
        self.n_past = 0
        self.perf = PerfCounters()

    def reset(self):
        self.kv = init_kv_cache(self.cfg, self.batch, self.max_seq,
                                self.kv_dtype, self.device)
        self.n_past = 0

    def _fwd(self, tokens, logits_all: bool):
        return forward(self.cfg, self.weights, tokens, self.kv, self.n_past,
                       logits_all=logits_all,
                       compute_dtype=self.compute_dtype, plain=self.plain)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _chunks(self, n: int):
        """Split n prompt tokens into bucket-sized chunks (take, bucket);
        the padded tail never exceeds cache space."""
        out = []
        left = n
        past = self.n_past
        while left > 0:
            space = self.max_seq - past
            b = next((b for b in PREFILL_BUCKETS if b >= min(left, space)),
                     None)
            if b is None or b > space:
                b = next((bb for bb in reversed(PREFILL_BUCKETS)
                          if bb <= space), space)
            take = min(left, b)
            out.append((take, b))
            left -= take
            past += take
        return out

    def prefill(self, ids) -> np.ndarray:
        """Feed prompt tokens [B, T]; returns logits at the last true
        position [B, V]."""
        ids = np.atleast_2d(np.asarray(ids, dtype=np.int64))
        B, T = ids.shape
        if B != self.batch:
            raise ValueError(f"engine batch {self.batch} vs prompt batch {B}")
        if self.n_past + T > self.max_seq:
            raise ContextOverflowError(
                f"prompt needs {self.n_past + T} slots, window {self.max_seq}")
        t0 = time.perf_counter()
        logits = None
        off = 0
        for take, bucket in self._chunks(T):
            chunk = ids[:, off:off + take]
            if take < bucket:  # pad the tail chunk; its cache slots stay masked
                chunk = np.pad(chunk, ((0, 0), (0, bucket - take)))
            out, self.kv = self._fwd(torch.from_numpy(chunk).to(self.device),
                                     logits_all=True)
            logits = out[:, take - 1, :]
            self.n_past += take
            off += take
        logits = logits.cpu().numpy()
        self._sync()
        self.perf.t_prefill += time.perf_counter() - t0
        self.perf.n_prefill += T
        return logits

    def decode_one(self, tokens) -> np.ndarray:
        """One decode step for [B] tokens -> last-position logits [B, V]."""
        if self.n_past + 1 > self.max_seq:
            raise ContextOverflowError(f"window {self.max_seq} is full")
        t0 = time.perf_counter()
        tok = torch.as_tensor(np.asarray(tokens, dtype=np.int64).reshape(
            self.batch, 1), device=self.device)
        logits, self.kv = self._fwd(tok, logits_all=False)
        self.n_past += 1
        out = logits.cpu().numpy()
        self._sync()
        self.perf.t_decode += time.perf_counter() - t0
        self.perf.n_decode += 1
        return out

    def generate(self, prompt_ids, n_predict: int = 64,
                 stop_ids: set | None = None) -> Iterator[int]:
        """Greedy generation for batch=1."""
        if self.batch != 1:
            raise ValueError(f"generate runs batch 1, the engine has {self.batch}")
        stop_ids = stop_ids or set()
        logits = self.prefill(np.asarray(prompt_ids)[None, :])
        for _ in range(n_predict):
            tok = int(np.argmax(logits[0]))
            if tok in stop_ids:
                return
            yield tok
            logits = self.decode_one(np.array([tok]))
