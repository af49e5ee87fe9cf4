"""Inference engine: GGUF loading, bucketed prefill, host-sampled and
on-device-sampled decode over the port's Llama forward.

Counterpart of ggml_hexagon_tpu/runtime/engine.py:25-120, 223-289,
338-446: it loads a GGUF file (`from_gguf`: the weights, the config from
the architecture registry and the vocabulary), owns the KV cache, feeds
prompts in bucket-sized chunks (8/32/128/512) with longest-prefix reuse of
the cached tokens, decodes one token per step, and generates from token
ids (`generate`, the host sampler chain), from text (`generate_text`,
through the tokenizer) or with the sampling on the device
(`generate_ondevice`, one device-to-host copy of the tokens at the end).
Context shifting, state save/load, self-extend, LoRA, embedding input and
whole-block scoring (`eval_tokens`) wait for later slices.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..gguf.reader import GGUFReader
from ..models.llama import (LlamaConfig, _check_fused, check_supported,
                            forward, init_kv_cache, load_llama_weights)
from ..tokenizer import Vocab, build_tokenizer
from .device_sampling import DeviceSamplerParams, sample_logits
from .sampling import SamplerChain, greedy_chain

PREFILL_BUCKETS = (8, 32, 128, 512)


class ContextOverflowError(RuntimeError):
    """The request does not fit the context window."""


@dataclass
class PerfCounters:
    """llama_perf_context-style counters (t_* in seconds, host clock
    around work that ends in a device synchronisation)."""

    t_load: float = 0.0
    t_prefill: float = 0.0
    t_decode: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0

    def report(self) -> str:
        pp = self.n_prefill / self.t_prefill if self.t_prefill else 0.0
        tg = self.n_decode / self.t_decode if self.t_decode else 0.0
        return (f"load {self.t_load * 1e3:.0f} ms | "
                f"prefill {self.n_prefill} tok {pp:.1f} t/s | "
                f"decode {self.n_decode} tok {tg:.1f} t/s")


class Engine:
    def __init__(self, cfg: LlamaConfig, weights: dict,
                 vocab: Optional[Vocab] = None, max_seq: int = 2048,
                 batch: int = 1, kv_dtype="bf16", device="cuda",
                 compute_dtype=torch.bfloat16, plain: bool = False):
        self.device = resolve_device(device)
        check_supported(cfg)
        for lw in weights.get("layers", []):
            _check_fused(lw)
        self.cfg = cfg.resolve_rope_factors(max_seq)
        self.weights = weights
        self.vocab = vocab
        self.tokenizer = (build_tokenizer(vocab) if vocab and vocab.tokens
                          else None)
        self.max_seq = max_seq
        self.batch = batch
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        self.plain = plain
        self.kv = init_kv_cache(self.cfg, batch, max_seq, kv_dtype,
                                self.device)
        self.n_past = 0
        self.cached_tokens: list[int] = []  # prompt cache (batch 1 reuse)
        self.perf = PerfCounters()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_gguf(cls, path, fuse: bool = False, **kw) -> "Engine":
        """Load a GGUF file: `path` names it (read through mmap), or is a
        buffer holding its bytes (GGUFReader.from_buffer).  fuse=True runs
        the load pipeline the port's forward takes: the NEOX rope
        permutation and the projection fusion (models/fuse.py); then the
        matmul weights drop their wire planes.  The forward runs fused
        layers only, so a dense model loaded with fuse=False raises here.
        kw go to Engine (max_seq, batch, kv_dtype, device, ...);
        perf.t_load is the whole load, device work included."""
        from ..models.fuse import fuse_weights, permute_rope_neox
        from ..quant.pack import drop_wire_planes

        device = resolve_device(kw.get("device", "cuda"))
        t0 = time.perf_counter()
        reader = (GGUFReader.open(path) if isinstance(path, (str, os.PathLike))
                  else GGUFReader.from_buffer(path))
        with reader as r:
            cfg, weights = load_llama_weights(r, device)
            vocab = Vocab.from_gguf(r.metadata)
        if fuse:
            weights, cfg = permute_rope_neox(weights, cfg)
            weights = fuse_weights(weights, cfg)
        weights = drop_wire_planes(weights)
        eng = cls(cfg, weights, vocab, **kw)
        eng._sync()
        eng.perf.t_load = time.perf_counter() - t0
        return eng

    # -- KV management ---------------------------------------------------------

    def reset(self):
        self.kv = init_kv_cache(self.cfg, self.batch, self.max_seq,
                                self.kv_dtype, self.device)
        self.n_past = 0
        self.cached_tokens = []

    def truncate(self, n: int):
        """Keep only the first n positions: masking hides slots >= n_past,
        so rewinding the counter suffices."""
        if not 0 <= n <= self.n_past:
            raise ValueError(f"truncate to {n} of {self.n_past} positions")
        self.n_past = n
        self.cached_tokens = self.cached_tokens[:n]

    # -- decoding ------------------------------------------------------------

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

    def _prefill(self, ids, reuse_cache: bool = False):
        """prefill on the device: logits [B, V] f32 at the last true
        position, as a device tensor (no host copy)."""
        ids = np.atleast_2d(np.asarray(ids, dtype=np.int64))
        B, T = ids.shape
        if reuse_cache and B == 1 and self.n_past == len(self.cached_tokens):
            common = 0
            for a, b in zip(self.cached_tokens, ids[0].tolist()):
                if a != b:
                    break
                common += 1
            common = min(common, T - 1)  # evaluate >= 1 token for logits
            if common > 0:
                self.truncate(common)
                ids = ids[:, common:]
                B, T = ids.shape
        if B != self.batch:
            raise ValueError(f"engine batch {self.batch} vs prompt batch {B}")
        if self.n_past + T > self.max_seq:
            raise ContextOverflowError(
                f"prompt needs {self.n_past + T} slots, window {self.max_seq}")
        if B == 1:
            self.cached_tokens = (self.cached_tokens[:self.n_past]
                                  + ids[0].tolist())
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
        self.perf.n_prefill += T
        return logits

    def prefill(self, ids, reuse_cache: bool = False) -> np.ndarray:
        """Feed prompt tokens [B, T]; returns logits at the last true
        position [B, V].  reuse_cache (batch 1): longest-common-prefix
        reuse against the tokens already in the cache, so only the unseen
        tail is evaluated."""
        t0 = time.perf_counter()
        logits = self._prefill(ids, reuse_cache).cpu().numpy()
        self._sync()
        self.perf.t_prefill += time.perf_counter() - t0
        return logits

    def _decode(self, tok):
        """One decode step for a [B, 1] token tensor on the device ->
        last-position logits [B, V] on the device."""
        if self.n_past + 1 > self.max_seq:
            raise ContextOverflowError(f"window {self.max_seq} is full")
        logits, self.kv = self._fwd(tok, logits_all=False)
        self.n_past += 1
        return logits

    def decode_one(self, tokens) -> np.ndarray:
        """One decode step for [B] tokens -> last-position logits [B, V]."""
        t0 = time.perf_counter()
        ids = np.asarray(tokens, dtype=np.int64).reshape(self.batch, 1)
        out = self._decode(torch.from_numpy(ids).to(self.device)).cpu().numpy()
        if self.batch == 1:
            self.cached_tokens.append(int(ids[0, 0]))
        self._sync()
        self.perf.t_decode += time.perf_counter() - t0
        self.perf.n_decode += 1
        return out

    def generate(self, prompt_ids, n_predict: int = 64,
                 sampler: Optional[SamplerChain] = None,
                 stop_ids: Optional[set] = None,
                 reuse_cache: bool = False) -> Iterator[int]:
        """Greedy or sampled generation for batch 1, the sampler chain on
        the host (greedy_chain by default); stops before a token of
        stop_ids (default: the vocabulary's EOS, none without a
        vocabulary).  reuse_cache: longest-prefix KV reuse."""
        if self.batch != 1:
            raise ValueError(f"generate runs batch 1, the engine has {self.batch}")
        sampler = sampler or greedy_chain()
        if stop_ids is None:
            stop_ids = {self.vocab.eos_id} if self.vocab else set()
        logits = self.prefill(np.asarray(prompt_ids, dtype=np.int64)[None, :],
                              reuse_cache=reuse_cache)
        for _ in range(n_predict):
            tok = sampler.sample(logits[0])
            if tok in stop_ids:
                return
            yield tok
            logits = self.decode_one(np.array([tok]))

    def generate_text(self, prompt: str, n_predict: int = 64,
                      sampler: Optional[SamplerChain] = None) -> str:
        """Encode prompt, generate, decode the generated tokens."""
        if self.tokenizer is None:
            raise ValueError("the model has no tokenizer vocabulary")
        ids = self.tokenizer.encode(prompt)
        return self.tokenizer.decode(list(self.generate(ids, n_predict,
                                                        sampler)))

    def generate_ondevice(self, prompt_ids, n_predict: int = 64,
                          params: Optional[DeviceSamplerParams] = None,
                          seed: int = 0, stop_at_eos: bool = True):
        """The whole generation with the sampling on the device: each
        sampled token goes back into the next step as a device tensor, and
        the EOS mask stays there, so the decode loop copies nothing to the
        host; the tokens come back once at the end.  Returns the n_predict
        tokens of each row ([n] for batch 1, a list of rows otherwise),
        cut before the first EOS when stop_at_eos (a finished row keeps
        feeding EOS).  seed seeds a torch.Generator on the device."""
        params = params or DeviceSamplerParams()
        eos = self.vocab.eos_id if (self.vocab and stop_at_eos) else -1
        prompt = np.atleast_2d(np.asarray(prompt_ids, dtype=np.int64))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        tok = sample_logits(self._prefill(prompt), gen, params)
        self._sync()  # a wait, no copy: the prefill's time is its own
        t1 = time.perf_counter()
        self.perf.t_prefill += t1 - t0
        done = tok == eos
        toks = [tok]
        for _ in range(n_predict - 1):
            nxt = sample_logits(self._decode(tok[:, None]), gen, params)
            if eos >= 0:
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done = done | (nxt == eos)
            toks.append(nxt)
            tok = nxt
        out = torch.stack(toks, dim=1).cpu().numpy()  # [B, n]
        self.perf.t_decode += time.perf_counter() - t1
        self.perf.n_decode += n_predict - 1
        if self.batch == 1:
            self.cached_tokens += out[0, :-1].tolist()
        rows = list(out)
        if eos >= 0:
            rows = [r[:np.flatnonzero(r == eos)[0]] if (r == eos).any() else r
                    for r in rows]
        return rows if self.batch > 1 else rows[0]
