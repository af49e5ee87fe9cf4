"""On-device sampling: torch transforms of the host sampler semantics.

Counterpart of ggml_hexagon_tpu/runtime/device_sampling.py.  The common
chain (temp / top-k / top-p / min-p -> categorical) runs on the logits'
device, so the decode loop of Engine.generate_ondevice feeds each sampled
token back as a device tensor and reads the tokens once at the end;
mirostat, DRY and the other samplers run on the host (runtime/sampling.py,
Engine.generate).

The draw is Gumbel-max (argmax of logits / temp plus Gumbel noise), the
method of jax.random.categorical, from an explicit torch.Generator on the
logits' device.  The two frameworks' generators give different bits from
one seed: a seed fixes the port's tokens, not JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DeviceSamplerParams:
    temp: float = 0.0  # <= 0 -> greedy
    top_k: int = 0  # 0 -> off
    top_p: float = 1.0
    min_p: float = 0.0


def filter_logits(logits, p: DeviceSamplerParams):
    """logits [B, V] -> f32 logits with the tokens that top-k, top-p and
    min-p cut set to -inf.  top-k keeps every tie of the k-th value (a
    logit below it is cut); top-p keeps the tokens up to and including the
    one whose cumulative probability crosses p; then min-p."""
    ninf = torch.tensor(float("-inf"), device=logits.device)
    lf = logits.to(torch.float32)
    if p.top_k and p.top_k < lf.shape[-1]:
        kth = torch.topk(lf, p.top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, ninf, lf)
    if p.top_p < 1.0:
        sorted_l = torch.sort(lf, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < p.top_p
        kth_idx = keep_sorted.sum(dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_l, -1, kth_idx)
        lf = torch.where(lf < cutoff, ninf, lf)
    if p.min_p > 0.0:
        probs = torch.softmax(lf, dim=-1)
        thresh = p.min_p * probs.amax(dim=-1, keepdim=True)
        lf = torch.where(probs < thresh, ninf, lf)
    return lf


def sample_logits(logits, generator: torch.Generator | None,
                  p: DeviceSamplerParams):
    """logits [B, V] -> tokens [B] int64 on the logits' device (the host
    chain's semantics); generator: a torch.Generator on that device (unused
    when temp <= 0, which takes the first largest logit)."""
    if p.temp <= 0:
        return torch.argmax(logits, dim=-1)
    lf = filter_logits(logits, p)
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(lf / p.temp + gumbel, dim=-1)
