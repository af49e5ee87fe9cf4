"""LLaMA model: config, KV cache, and the forward step in PyTorch.

Counterpart of the llama branches of ggml_hexagon_tpu/models/llama.py
(:33-169, 352-541, 741-799, 899-1326).  The forward takes the JAX
package's decode fast paths on every device: the dual QKV projection (K2)
for mixed-type layers, the fused decode attention (K4) with one bulk KV
write after the layer loop, wo with the residual added in the kernel (K1),
and the fused act+down with residual (K1).  Whether a projection runs its
CUDA kernel or its plain version is decided by the wrappers (CUDA or CPU
tensor), or by `plain=True`, which runs the plain versions everywhere.

The residual stream is kept in compute_dtype (bf16) at the same places as
the reference, so the int8 activation rounding sees the same inputs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from .. import resolve_device
from ..ops.attention import flash_attention_cache
from ..ops.basic import (RopeParams, apply_rope, rms_norm, rope_freqs, silu,
                         softmax_ext)
from ..ops.decode_attn import fused_decode_attention
from ..ops.qmatmul import dequantize, take_rows_wire
from ..ops.qmm_qp8 import (QP8_MAX_DECODE, qp8_matmul, qp8_matmul_act,
                           qp8_matmul_dual, qp8_matmul_normed, qp8_matmul_res,
                           supports_qp8_dual)
from ..quant.pack import QTensor


@dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's LlamaConfig fields (so configs carry across as
    dataclasses.asdict); the port's forward runs the llama subset and
    raises on the others."""

    n_vocab: int
    n_embd: int
    n_layer: int
    n_head: int
    n_head_kv: int
    n_ff: int
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_mode: str = "norm"
    rope_freq_scale: float = 1.0
    rope_ext_factor: float = 0.0
    rope_attn_factor: float = 1.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    n_ctx_train: int = 2048
    head_dim: int = 0
    arch: str = "llama"
    attn_bias: bool = False
    act: str = "silu"
    embd_scale: float = 1.0
    norm_plus_one: bool = False
    post_norms: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    swa_window: int = 0
    swa_pattern: int = 1
    attn_scale: float = 0.0
    n_expert: int = 0
    n_expert_used: int = 0
    n_ff_exp: int = 0
    norm_topk_prob: bool = True
    norm_type: str = "rms"
    rope_n_dims: int = 0
    pos_embd: bool = False
    parallel_residual: bool = False
    shared_ffn_norm: bool = False
    logit_scale: float = 1.0
    pre_norms: bool = True
    alibi_max_bias: float = 0.0
    clamp_qkv: float = 0.0
    residual_scale: float = 1.0
    rope_theta_swa: float = 0.0
    rope_freq_scale_swa: float = 1.0
    rope_swa_only: bool = False
    moe_gating: str = "softmax"
    moe_jitter_eps: float = 0.0
    swin_norm: bool = False
    norm_qk_type: str = ""
    n_head_arr: tuple = ()
    n_head_kv_arr: tuple = ()
    rope_sections: tuple = ()
    rope_ff: tuple = ()
    rope_ff_long: tuple = ()

    def resolve_rope_factors(self, n_ctx: int) -> "LlamaConfig":
        if self.rope_ff_long and n_ctx > self.n_ctx_train:
            return replace(self, rope_ff=self.rope_ff_long)
        return self

    def nh(self, il: int) -> int:
        return self.n_head_arr[il] if self.n_head_arr else self.n_head

    def nhkv(self, il: int) -> int:
        return self.n_head_kv_arr[il] if self.n_head_kv_arr else self.n_head_kv

    @property
    def n_head_kv_max(self) -> int:
        return max(self.n_head_kv_arr) if self.n_head_kv_arr else self.n_head_kv

    @property
    def hd(self) -> int:
        return self.head_dim or self.n_embd // self.n_head

    @property
    def rope_params(self) -> RopeParams:
        return RopeParams(
            n_dims=self.rope_n_dims or self.hd, mode=self.rope_mode,
            freq_base=self.rope_theta, freq_scale=self.rope_freq_scale,
            ext_factor=self.rope_ext_factor,
            attn_factor=self.rope_attn_factor,
            beta_fast=self.rope_beta_fast, beta_slow=self.rope_beta_slow,
            n_ctx_orig=self.n_ctx_train, freq_factors=self.rope_ff,
            sections=self.rope_sections)


#: config fields whose non-default values take branches the port's forward
#: does not have yet (other architectures)
_LLAMA_ONLY = dict(
    act="silu", attn_bias=False, embd_scale=1.0, norm_plus_one=False, post_norms=False,
    attn_logit_softcap=0.0, final_logit_softcap=0.0, swa_window=0,
    n_expert=0, norm_type="rms", pos_embd=False, parallel_residual=False,
    logit_scale=1.0, pre_norms=True, alibi_max_bias=0.0, clamp_qkv=0.0,
    residual_scale=1.0, swin_norm=False, n_head_arr=(), n_head_kv_arr=(),
    rope_sections=())


def check_supported(cfg: LlamaConfig):
    bad = [k for k, v in _LLAMA_ONLY.items() if getattr(cfg, k) != v]
    if bad or cfg.rope_mode not in ("norm", "neox", "none"):
        raise NotImplementedError(
            f"config {cfg.arch}: {bad or cfg.rope_mode} take branches of the "
            "JAX forward that the port does not have yet")


def embed(tok_embd: QTensor, ids, dtype=torch.bfloat16):
    """Row gather + dequant from the quantized embedding's wire planes."""
    flat = ids.reshape(-1).to(tok_embd.device)
    rows = dequantize(take_rows_wire(tok_embd, flat), dtype)
    return rows.reshape(*ids.shape, tok_embd.k)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                  dtype="bf16", device="cuda"):
    """KV cache stored flat as [L, B, S, Hkv*hd]: bf16, or "q8_0" (int8
    values + f32 per-row scales [L, B, S])."""
    device = resolve_device(device)
    shape = (cfg.n_layer, batch, max_seq, max(cfg.n_head_kv_max, 1) * cfg.hd)
    if dtype == "q8_0":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_d": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_d": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    if dtype in ("bf16", torch.bfloat16):
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    raise ValueError(f"kv dtype {dtype!r}: expected 'bf16' or 'q8_0'")


def _kv_quantize(x):
    """[..., W] -> (int8 values, f32 per-row scales [...])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    d = amax / 127.0
    one = torch.ones_like(d)
    inv = torch.where(d > 0, one / torch.where(d == 0, one, d),
                      torch.zeros_like(d))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127.0, 127.0)
    return q.to(torch.int8), d


FLASH_THRESHOLD = 512  # cache sizes from here up take the flash path
FLASH_CHUNK = 128


def _attention(cfg, q, k_all, v_all, pos_start: int, T: int, scale: float,
               k_scale=None, v_scale=None):
    """Causal GQA attention over the cache: q [B, T, nh, hd]; k_all/v_all
    [B, S, Hkv, hd] (int8 with per-slot scales [B, S] when quantized)."""
    B, _, n_head, hd = q.shape
    S, n_kv = k_all.shape[1], k_all.shape[2]
    group = n_head // n_kv
    qg = q.permute(0, 2, 1, 3).reshape(B, n_kv, group, T, hd)
    k = k_all.permute(0, 2, 1, 3)
    v = v_all.permute(0, 2, 1, 3)
    if S >= FLASH_THRESHOLD and S % FLASH_CHUNK == 0:
        out = flash_attention_cache(qg, k, v, pos_start, T, scale,
                                    chunk=FLASH_CHUNK, k_scale=k_scale,
                                    v_scale=v_scale)
        return (out.reshape(B, n_head, T, hd).permute(0, 2, 1, 3)
                .reshape(B, T, n_head * hd))
    if k_scale is not None:  # dense path: dequantize the (small) cache
        k = k.to(torch.float32) * k_scale[:, None, :, None]
        v = v.to(torch.float32) * v_scale[:, None, :, None]
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg.to(torch.float32),
                          k.to(torch.float32))
    dev = q.device
    s_idx = torch.arange(S, device=dev)[None, :]
    t_idx = torch.arange(T, device=dev)[:, None]
    allowed = s_idx <= pos_start + t_idx
    mask = torch.where(allowed, 0.0, -math.inf).to(torch.float32)
    probs = softmax_ext(scores, mask, scale=scale).to(v.dtype)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs.to(torch.float32),
                       v.to(torch.float32))
    return (out.reshape(B, n_head, T, hd).permute(0, 2, 1, 3)
            .reshape(B, T, n_head * hd))


def _check_fused(lw: dict):
    """The layer layouts fuse_weights produces for the t-plane types: the
    only ones this forward runs (the reference's unfused branches wait)."""
    attn = "wqkv" in lw or ("wqk" in lw and "attn_norm_il_v" in lw)
    if not (attn and "attn_norm_il" in lw and "w_gateup_il" in lw
            and "ffn_norm_il" in lw):
        raise NotImplementedError(
            "forward runs fused t-plane weights (models.fuse.fuse_weights); "
            f"this layer has {sorted(lw)}")


def _ffn(cfg, lw, h, cd, plain=False):
    """Gated FFN on the residual h, RMSNorm folded into the gate_up matmul
    (the reference's `w_gateup_il` branch).  Returns the new residual: on
    the decode path the act+down kernel adds h itself."""
    gu2 = qp8_matmul_normed(h, lw["w_gateup_il"], lw["ffn_norm_il"],
                            cfg.rms_eps, plain=plain)
    dn = lw["ffn_down"]
    if math.prod(gu2.shape[:-1]) <= QP8_MAX_DECODE:
        return qp8_matmul_act(gu2, dn, cfg.act, res=h, plain=plain).to(cd)
    ng = dn.k
    gu = silu(gu2[..., :ng].to(cd)) * gu2[..., ng:].to(cd)
    return h + qp8_matmul(gu, dn, plain=plain).to(cd)


def forward(cfg: LlamaConfig, weights: dict, tokens, kv_cache: dict,
            pos_start: int, logits_all: bool = False,
            compute_dtype=torch.bfloat16, plain: bool = False):
    """One decoder step over T new tokens [B, T] at cache offset pos_start.
    Returns (logits, kv_cache): logits [B, T, n_vocab] if logits_all else
    [B, n_vocab] (last position), f32.  The cache is updated IN PLACE (the
    returned dict is the one passed in)."""
    check_supported(cfg)
    B, T = tokens.shape
    cd = compute_dtype
    dev = tokens.device
    pos_start = int(pos_start)
    eps = cfg.rms_eps
    rope = cfg.rope_params
    positions = pos_start + torch.arange(T, device=dev)[None, :]
    h = embed(weights["tok_embd"], tokens, cd)
    scale = cfg.attn_scale or 1.0 / float(math.sqrt(cfg.hd))
    quant_kv = "k_d" in kv_cache
    fused_kv = []
    for il, lw in enumerate(weights["layers"]):
        _check_fused(lw)
        nh, nhkv = cfg.nh(il), cfg.nhkv(il)
        nq, nk = nh * cfg.hd, nhkv * cfg.hd
        wn = lw["attn_norm_il"]
        use_fused = (T == 1 and cfg.rope_mode in ("neox", "none")
                     and nh % nhkv == 0 and cfg.hd % 128 == 0)
        flat_qkv = q = k = v = None
        if "wqkv" in lw:
            qkv = qp8_matmul_normed(h, lw["wqkv"], wn, eps, plain=plain)
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
        elif (use_fused and B <= QP8_MAX_DECODE
              and supports_qp8_dual(lw["wqk"], lw["wv"])):
            flat_qkv = qp8_matmul_dual(h[:, 0], lw["wqk"], lw["wv"], wn, eps,
                                       plain=plain)
        else:
            qk = qp8_matmul_normed(h, lw["wqk"], wn, eps, plain=plain)
            v = qp8_matmul_normed(h, lw["wv"], lw["attn_norm_il_v"], eps,
                                  plain=plain)
            q, k = qk[..., :nq], qk[..., nq:]
        if use_fused:
            if flat_qkv is None:
                flat_qkv = torch.cat([q[:, 0], k[:, 0], v[:, 0]], dim=-1)
            invf = None
            ms = 1.0
            if cfg.rope_mode != "none":
                invf, ms = rope_freqs(rope, dev)
            attn, k_r, v_r = fused_decode_attention(
                flat_qkv, kv_cache["k"][il], kv_cache["v"][il], pos_start,
                invf, k_scale=kv_cache["k_d"][il] if quant_kv else None,
                v_scale=kv_cache["v_d"][il] if quant_kv else None,
                Hq=nh, Hkv=nhkv, D=cfg.hd, scale=float(scale),
                mscale=float(ms), n_dims=cfg.rope_n_dims or cfg.hd,
                plain=plain)
            fused_kv.append((il, k_r, v_r))
            attn = attn[:, None, :].to(cd)
        else:
            q = q.reshape(B, T, nh, cfg.hd)
            k = k.reshape(B, T, nhkv, cfg.hd)
            v = v.reshape(B, T, nhkv, cfg.hd)
            if cfg.rope_mode != "none":
                qk = apply_rope(torch.cat([q, k], dim=2), positions, rope)
                q, k = qk[:, :, :nh], qk[:, :, nh:]
            sl = slice(pos_start, pos_start + T)
            S = kv_cache["k"].shape[2]
            if quant_kv:
                kq, kd = _kv_quantize(k.reshape(B, T, -1))
                vq, vd = _kv_quantize(v.reshape(B, T, -1))
                kv_cache["k"][il, :, sl] = kq
                kv_cache["v"][il, :, sl] = vq
                kv_cache["k_d"][il, :, sl] = kd
                kv_cache["v_d"][il, :, sl] = vd
                k_sc, v_sc = kv_cache["k_d"][il], kv_cache["v_d"][il]
            else:
                kv_cache["k"][il, :, sl] = k.reshape(B, T, -1).to(
                    kv_cache["k"].dtype)
                kv_cache["v"][il, :, sl] = v.reshape(B, T, -1).to(
                    kv_cache["v"].dtype)
                k_sc = v_sc = None
            k_full = kv_cache["k"][il].reshape(B, S, nhkv, cfg.hd)
            v_full = kv_cache["v"][il].reshape(B, S, nhkv, cfg.hd)
            attn = _attention(cfg, q, k_full, v_full, pos_start, T, scale,
                              k_scale=k_sc, v_scale=v_sc).to(cd)
        if T == 1 and B <= QP8_MAX_DECODE:
            h = qp8_matmul_res(attn, lw["wo"], h, plain=plain).to(cd)
        else:
            h = h + qp8_matmul(attn, lw["wo"], plain=plain).to(cd)
        h = _ffn(cfg, lw, h, cd, plain)

    if fused_kv:
        # one cache write for all fused layers (the rows never touched the
        # cache inside the layer loop)
        ils = torch.tensor([i for i, _, _ in fused_kv], device=dev)
        ks = torch.stack([kr for _, kr, _ in fused_kv])   # [F, B, HD] f32
        vs = torch.stack([vr for _, _, vr in fused_kv])
        planes = [("k", ks), ("v", vs)]
        if quant_kv:
            kq, kd = _kv_quantize(ks)
            vq, vd = _kv_quantize(vs)
            planes = [("k", kq), ("v", vq), ("k_d", kd), ("v_d", vd)]
        for name, rows in planes:
            dst = kv_cache[name]
            dst[ils, :, pos_start] = rows.to(dst.dtype)
    h = rms_norm(h, weights["output_norm"], eps)
    if not logits_all:
        h = h[:, -1, :]
    logits = qp8_matmul(h, weights["output"], plain=plain)
    return logits.to(torch.float32), kv_cache
