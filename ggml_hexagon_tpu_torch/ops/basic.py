"""Elementwise / normalization / rotary ops in plain PyTorch.

Counterpart of ggml_hexagon_tpu/ops/basic.py:22-193, same semantics:
- rms_norm: ggml RMS_NORM (f32 accumulation, eps inside the sqrt)
- rope: ggml ROPE modes NORM (adjacent pairs) and NEOX (split halves),
  with linear frequency scaling and YaRN
- softmax_ext: fused scale + mask + softmax (ggml SOFT_MAX_EXT)
- gelu, relu and act_f32: the gated FFN's activations (ggml LLM_FFN_GELU,
  LLM_FFN_RELU), the model's and the kernels' forms
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def rms_norm(x, weight, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * weight, computed in f32, cast back."""
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.to(torch.float32)).to(x.dtype)


def silu(x):
    """x * sigmoid(x), the sigmoid in f32 and cast to x's dtype first."""
    return x * torch.sigmoid(x.to(torch.float32)).to(x.dtype)


#: sqrt(2 / pi), the tanh form's constant (as the f32 value both packages
#: round it to)
GELU_C = 0.7978845608028654


def gelu(x):
    """The tanh form of GELU in f32, cast back to x's dtype (jax.nn.gelu
    with approximate=True: x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3)))))."""
    xf = x.to(torch.float32)
    inner = GELU_C * (xf + 0.044715 * (xf * xf * xf))
    return (xf * (0.5 * (1.0 + torch.tanh(inner)))).to(x.dtype)


def relu(x):
    """max(x, 0) in x's dtype."""
    return torch.clamp_min(x, 0)


def act(name: str, x):
    """The model's gated-FFN activation `name` (silu, gelu or relu) on x."""
    fns = {"silu": silu, "gelu": gelu, "relu": relu}
    if name not in fns:
        raise NotImplementedError(f"act {name!r}")
    return fns[name](x)


def act_f32(name: str, x):
    """The fused kernels' activation on f32 x, in their order of operations
    (ggml_hexagon_tpu/ops/qmm_qp8.py `_apply_act_f32`, qmm_fast.py
    `_apply_act`, ffn_fused.py `_act`): x * sigmoid(x);
    0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x))); max(x, 0)."""
    if name == "silu":
        return x * torch.sigmoid(x)
    if name == "gelu":
        t = torch.tanh(GELU_C * (x + 0.044715 * x * x * x))
        return 0.5 * x * (1.0 + t)
    if name == "relu":
        return torch.clamp_min(x, 0.0)
    raise NotImplementedError(f"act {name!r}")


@dataclass(frozen=True)
class RopeParams:
    """Mirrors the ggml_rope_ext parameter block (ggml.h:1438-1468)."""

    n_dims: int
    mode: str = "norm"  # 'norm' (adjacent pairs) | 'neox' (split halves)
    freq_base: float = 10000.0
    freq_scale: float = 1.0
    ext_factor: float = 0.0  # YaRN extrapolation mix (0 = off)
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    n_ctx_orig: int = 0
    freq_factors: tuple = ()
    sections: tuple = ()


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float,
                   base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (
        2 * math.log(base))


def rope_freqs(params: RopeParams, device=None):
    """(inv_freq [n_dims/2] f32, mscale): the rotation of pair j at
    position p is p * inv_freq[j]."""
    half = params.n_dims // 2
    j = torch.arange(half, dtype=torch.float32, device=device)
    theta = params.freq_base ** (-2.0 * j / params.n_dims)
    if params.freq_factors:
        theta = theta / torch.tensor(params.freq_factors, dtype=torch.float32,
                                     device=device)[:half]
    if params.ext_factor != 0.0 and params.n_ctx_orig > 0:
        lo = math.floor(_yarn_corr_dim(params.n_dims, params.n_ctx_orig,
                                       params.beta_fast, params.freq_base))
        hi = math.ceil(_yarn_corr_dim(params.n_dims, params.n_ctx_orig,
                                      params.beta_slow, params.freq_base))
        y = (2 * j / 2.0 - lo) / max(0.001, hi - lo)
        ramp = (1.0 - torch.clamp(y, 0.0, 1.0)) * params.ext_factor
        theta_interp = params.freq_scale * theta
        inv_freq = theta_interp * (1 - ramp) + theta * ramp
        mscale = params.attn_factor * (
            1.0 + 0.1 * math.log(1.0 / params.freq_scale)
            if params.freq_scale < 1.0 else 1.0)
    else:
        inv_freq = params.freq_scale * theta
        mscale = params.attn_factor
    return inv_freq, mscale


def apply_rope(x, positions, params: RopeParams):
    """Rotate x [..., T, n_head, head_dim] by positions [..., T] (modes
    'norm' and 'neox'; dims beyond n_dims pass through unrotated)."""
    if params.mode not in ("norm", "neox"):
        raise NotImplementedError(f"rope mode {params.mode!r}")
    n_dims = params.n_dims
    inv_freq, mscale = rope_freqs(params, x.device)
    pos = positions.to(torch.float32)[..., :, None]
    angles = pos * inv_freq[None, :]                     # [..., T, half]
    cos = (torch.cos(angles) * mscale)[..., :, None, :]
    sin = (torch.sin(angles) * mscale)[..., :, None, :]
    xf = x.to(torch.float32)
    rot, rest = xf[..., :n_dims], xf[..., n_dims:]
    if params.mode == "neox":
        x1 = rot[..., : n_dims // 2]
        x2 = rot[..., n_dims // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:
        x1 = rot[..., 0::2]
        x2 = rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(rot.shape)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out.to(x.dtype)


def softmax_ext(scores, mask=None, scale: float = 1.0,
                logit_cap: float = 0.0):
    """Fused scale + (optional tanh soft-cap) + mask + softmax, in f32."""
    s = scores.to(torch.float32) * scale
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    if mask is not None:
        s = s + mask.to(torch.float32)
    return torch.softmax(s, dim=-1)
