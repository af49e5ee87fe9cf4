"""LLaMA model: config, KV cache, and the forward step in PyTorch.

Counterpart of the llama branches of ggml_hexagon_tpu/models/llama.py
(:33-169, 342-349, 352-541, 565-799, 850-881, 899-1326).  The forward takes
the JAX package's decode fast paths on every device: the dual QKV
projection where wqk and wv share a layout (K2 on t-planes, K7 on
interleaved ones), else one fused norm+matmul each (K1 on t-planes, K6's
normed mode on interleaved ones);
the fused decode attention (K4) with one bulk KV write after the layer
loop; wo with the residual added in the kernel (K1, or K6's residual
mode); and the fused act+down with residual (K1, or K6's act mode).  A
layer carrying the megakernel layout ("ffp", models/fuse.py) runs wo, the
ffn norm, gate_up, silu(gate)*up and down with both residuals as one K9
launch at decode (ops/ffn_fused.py); elsewhere it runs the split path with
its wo and down outputs un-permuted from the il32 row order.
Layers whose Q and K types differ (Mixtral: Q5_K or IQ4_XS wq, Q8_0 wk/wv)
run the unfused branch: the RMSNorm in torch, then each projection through
`matmul` (K1/K3 on t-planes, K6 on interleaved planes).  MoE layers route
each token to its top-k experts: gathered-expert GEMVs at <= 8 rows (K5 on
t-stacks, K8 on interleaved ones), every expert through `matmul` above.
Whether a projection runs its CUDA kernel or its plain version is decided
by the wrappers (CUDA or CPU tensor), or by `plain=True`, which runs the
plain versions everywhere.

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
from ..ops.decode_attn import fused_decode_attention, pack_int4, unpack_int4
from ..ops.ffn_fused import ffn_fused
from ..ops.qmatmul import dequantize, qmatmul, qmatmul_normed, take_rows_wire
from ..ops.qmm_fast import (qmatmul_fast, qmatmul_fast_act,
                            qmatmul_fast_dual, qmatmul_fast_indirect,
                            qmatmul_fast_res, supports_dual,
                            supports_fused_epilogue, supports_indirect,
                            uninterleave_cols)
from ..ops.qmm_qp8 import QP8_MAX_DECODE
from ..quant.pack import QTensor

#: set to a list to record the MoE routing of each _moe_ffn call, in layer
#: order: (router probabilities [B, T, E] f32, top-k ids [B, T, k]), as
#: device tensors (no host synchronisation); None records nothing
MOE_ROUTING = None

#: set to a callable hook(il, h_in, h_out) -> h, called after each layer
#: of forward with the residual stream before and after the layer; what it
#: returns continues as the residual (chip_smoke.py feeds two routes the
#: same input to each layer this way); None calls nothing
LAYER_HOOK = None


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
    norm_type="rms", pos_embd=False, parallel_residual=False,
    logit_scale=1.0, pre_norms=True, alibi_max_bias=0.0, clamp_qkv=0.0,
    residual_scale=1.0, swin_norm=False, n_head_arr=(), n_head_kv_arr=(),
    rope_sections=())


def check_supported(cfg: LlamaConfig):
    bad = [k for k, v in _LLAMA_ONLY.items() if getattr(cfg, k) != v]
    if cfg.n_expert and cfg.moe_gating != "softmax":
        bad.append("moe_gating")
    if bad or cfg.rope_mode not in ("norm", "neox", "none"):
        raise NotImplementedError(
            f"config {cfg.arch}: {bad or cfg.rope_mode} take branches of the "
            "JAX forward that the port does not have yet")


def load_llama_weights(reader, device="cuda", dtype=torch.bfloat16):
    """(cfg, weights) of any registry architecture from a GGUFReader, on
    `device` (ggml_hexagon_tpu/models/llama.py:176-324).

    Tensor names follow the GGUF convention.  Optional per-arch tensors
    (QKV biases, post-norms, QK norms, stacked MoE experts) load when
    present, the stacked experts [E, n, k] as one [(E*n), k] tensor; the
    output head falls back to the tied token embedding.  A quantized
    tensor's raw bytes go to the device once and unpack there
    (quant.pack.pack_tensor), then take matmul planes on the layout
    `use_qp8_layout` picks, as QTensor.with_fast_planes builds them; norms
    and vectors become f32 tensors, other dense tensors `dtype`.  The
    forward runs the llama subset of the configs this returns
    (check_supported)."""
    import numpy as np

    from ..quant.formats import GGMLType
    from ..quant.pack import QCONFIGS, pack_tensor
    from .registry import config_from_gguf

    device = resolve_device(device)
    cfg = config_from_gguf(reader.metadata)
    # longrope / llama3 frequency factors (stored on blk.0 in GGUF)
    ff = {}
    for fld, tn in (("rope_ff", "blk.0.rope_freqs.weight"),
                    ("rope_ff", "blk.0.rope_factors_short.weight"),
                    ("rope_ff_long", "blk.0.rope_factors_long.weight")):
        if tn in reader.tensors and not ff.get(fld):
            ff[fld] = tuple(float(x) for x in reader.tensor_f32(tn))
    if ff:
        cfg = replace(cfg, **ff)
    dense = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)

    def get(name, as_vec=False):
        t = reader.tensors[name]
        if as_vec or (t.ggml_type in dense and len(t.ne) == 1):
            return torch.from_numpy(np.asarray(reader.tensor_f32(name),
                                               np.float32)).to(device)
        if t.ggml_type in QCONFIGS and t.ne[0] % 256 == 0:
            shape = t.shape
            if len(shape) == 3:  # stacked experts [E, n, k] -> [(E*n), k]
                shape = (shape[0] * shape[1], shape[2])
            if len(shape) == 2:
                raw = torch.from_numpy(reader.tensor_bytes(name).copy())
                qt = pack_tensor(raw.to(device), t.ggml_type, shape)
                return qt.with_fast_planes()
        # dense fallback (f16/f32 2-D/3-D, or K not chunk-aligned)
        arr = reader.tensor_f32(name)
        if arr.ndim == 3:
            arr = arr.reshape(arr.shape[0] * arr.shape[1], arr.shape[2])
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                              dtype=dtype)

    def opt(name, as_vec=False):
        return get(name, as_vec) if name in reader.tensors else None

    layers = []
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        lw = {}
        if p + "attn_output.weight" in reader.tensors:
            lw["wo"] = get(p + "attn_output.weight")
        if p + "attn_norm.weight" in reader.tensors:
            lw["attn_norm"] = get(p + "attn_norm.weight", as_vec=True)
        if p + "attn_qkv.weight" in reader.tensors:  # fused QKV
            lw["wqkv"] = get(p + "attn_qkv.weight")
        elif p + "attn_q.weight" in reader.tensors:
            lw["wq"] = get(p + "attn_q.weight")
            lw["wk"] = get(p + "attn_k.weight")
            lw["wv"] = get(p + "attn_v.weight")
        # else: an attention-free layer (deci)
        if p + "ffn_norm.weight" in reader.tensors:
            lw["ffn_norm"] = get(p + "ffn_norm.weight", as_vec=True)
        for key, name in _OPTIONAL_LAYER_VECTORS:
            a = opt(p + name, as_vec=True)
            if a is not None:
                lw[key] = a
        if cfg.n_expert and p + "ffn_gate_inp.weight" in reader.tensors:
            # an MoE layer (leading dense layers of deepseek-class models
            # fall through to the dense branch)
            for key in ("ffn_gate_inp", "ffn_gate_exps", "ffn_up_exps",
                        "ffn_down_exps"):
                lw[key] = get(p + key + ".weight")
            for sh in ("ffn_gate_inp_shexp", "ffn_gate_shexp",
                       "ffn_up_shexp", "ffn_down_shexp"):
                a = opt(p + sh + ".weight")
                if a is not None:
                    lw[sh] = a
        if p + "ffn_up.weight" in reader.tensors:
            # a dense FFN (also beside MoE for arctic)
            g = opt(p + "ffn_gate.weight")
            up = get(p + "ffn_up.weight")
            if g is not None:  # gated (SwiGLU-class)
                lw["ffn_gate"] = g
                lw["ffn_up"] = up
            else:
                rows = up.n if isinstance(up, QTensor) else up.shape[0]
                if cfg.n_ff and rows == 2 * cfg.n_ff:
                    lw["w_gateup"] = up  # fused SWIGLU gate_up
                else:
                    lw["ffn_up"] = up
            lw["ffn_down"] = get(p + "ffn_down.weight")
        layers.append(lw)
    weights = {
        "tok_embd": get("token_embd.weight"),
        "output_norm": opt("output_norm.weight", as_vec=True),
        "output": get("output.weight") if "output.weight" in reader.tensors
        else get("token_embd.weight"),
        "layers": layers,
    }
    for key, name in (("output_norm_b", "output_norm.bias"),
                      ("output_b", "output.bias"),
                      ("pos_embd", "position_embd.weight"),
                      ("tok_norm", "token_embd_norm.weight"),
                      ("tok_norm_b", "token_embd_norm.bias")):
        a = opt(name, as_vec=(key != "pos_embd"))
        if a is not None:
            weights[key] = a
    return cfg, weights


#: the optional per-layer vectors of load_llama_weights: (key, GGUF name)
_OPTIONAL_LAYER_VECTORS = (
    ("bqkv", "attn_qkv.bias"), ("bq", "attn_q.bias"), ("bk", "attn_k.bias"),
    ("bv", "attn_v.bias"),
    ("attn_q_norm", "attn_q_norm.weight"),
    ("attn_k_norm", "attn_k_norm.weight"),
    ("attn_q_norm_b", "attn_q_norm.bias"),
    ("attn_k_norm_b", "attn_k_norm.bias"),
    ("post_attn_norm", "post_attention_norm.weight"),
    ("post_ffn_norm", "post_ffw_norm.weight"),
    # grok names its pre-residual norms differently
    ("post_attn_norm", "attn_output_norm.weight"),
    ("post_ffn_norm", "layer_output_norm.weight"),
    ("ffn_norm_exps", "ffn_norm_exps.weight"),  # arctic MoE-branch norm
    ("attn_norm_b", "attn_norm.bias"), ("ffn_norm_b", "ffn_norm.bias"),
    ("bo", "attn_output.bias"), ("ffn_up_b", "ffn_up.bias"),
    ("ffn_down_b", "ffn_down.bias"),
    # bitnet: pre-projection RMS sub-norms + per-tensor quant scales
    ("attn_sub_norm", "attn_sub_norm.weight"),
    ("ffn_sub_norm", "ffn_sub_norm.weight"),
    ("wq_scale", "attn_q.scale"), ("wk_scale", "attn_k.scale"),
    ("wv_scale", "attn_v.scale"), ("wo_scale", "attn_output.scale"),
    ("ffn_gate_scale", "ffn_gate.scale"), ("ffn_up_scale", "ffn_up.scale"),
    ("ffn_down_scale", "ffn_down.scale"))


def matmul(x, w, plain=False):
    """QTensor -> the quantized-matmul dispatcher; a dense array (the MoE
    router) -> a plain f32 product x @ w.T."""
    if isinstance(w, QTensor):
        return qmatmul(x, w, plain=plain)
    return torch.matmul(x.to(w.dtype), w.t()).to(torch.float32)


def embed(tok_embd: QTensor, ids, dtype=torch.bfloat16):
    """Row gather + dequant from the quantized embedding's wire planes."""
    flat = ids.reshape(-1).to(tok_embd.device)
    rows = dequantize(take_rows_wire(tok_embd, flat), dtype)
    return rows.reshape(*ids.shape, tok_embd.k)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                  dtype="bf16", device="cuda"):
    """KV cache stored flat as [L, B, S, Hkv*hd]: bf16; "q8_0": int8 values
    with f32 per-row scales k_d / v_d [L, B, S]; "q4_0": 4-bit values packed
    two a byte, uint8 [L, B, S, Hkv*hd/2], with the same f32 per-row scales
    (half of q8_0's bytes).  The q4_0 nibble order: dim 2i sits in the low
    nibble of byte i and dim 2i+1 in the high nibble, each a two's-complement
    value in [-7, 7] (ops/decode_attn.pack_int4); K4's plain twin, its CUDA
    kernel (csrc/decode_attn.cu) and the cache writes of `forward` keep it."""
    device = resolve_device(device)
    shape = (cfg.n_layer, batch, max_seq, max(cfg.n_head_kv_max, 1) * cfg.hd)
    if dtype in ("q8_0", "q4_0"):
        vshape = shape if dtype == "q8_0" else shape[:-1] + (shape[-1] // 2,)
        vdt = torch.int8 if dtype == "q8_0" else torch.uint8
        return {"k": torch.zeros(vshape, dtype=vdt, device=device),
                "k_d": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v": torch.zeros(vshape, dtype=vdt, device=device),
                "v_d": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    if dtype in ("bf16", torch.bfloat16):
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    raise ValueError(f"kv dtype {dtype!r}: expected 'bf16', 'q8_0' or 'q4_0'")


def kv_bits(kv_cache: dict) -> int:
    """16 for a bf16 cache, 8 for q8_0, 4 for q4_0 (packed uint8 values)."""
    if "k_d" not in kv_cache:
        return 16
    return 4 if kv_cache["k"].dtype == torch.uint8 else 8


def _kv_quantize(x, bits: int = 8):
    """[..., W] -> (int8 values in [-qmax, qmax], f32 per-row scales
    [...]); qmax 127, or 7 for bits=4 (the values then go through
    pack_int4 into the cache)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    qmax = 7.0 if bits == 4 else 127.0
    d = amax / qmax
    one = torch.ones_like(d)
    inv = torch.where(d > 0, one / torch.where(d == 0, one, d),
                      torch.zeros_like(d))
    q = torch.clamp(torch.round(xf * inv[..., None]), -qmax, qmax)
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
    """The layer layouts this forward runs, as fuse_weights leaves them:
    attention fused with its norm planes (wqkv, or wqk + wv) or unfused
    (wq, wk, wv); the dense FFN fused (w_gateup_il), with or without the
    megakernel layout (the marker "ffp"), or an MoE FFN (router and stacked
    experts).  The reference's other branches wait."""
    attn = ("attn_norm_il" in lw and ("wqkv" in lw or (
        "wqk" in lw and "attn_norm_il_v" in lw))) or (
        "attn_norm" in lw and all(k in lw for k in ("wq", "wk", "wv")))
    ffn = ("w_gateup_il" in lw and "ffn_norm_il" in lw) or (
        "ffn_norm" in lw and "ffn_gate_inp" in lw
        and "ffn_norm_exps" not in lw
        and all(k in lw for k in ("ffn_gate_exps", "ffn_up_exps",
                                  "ffn_down_exps")))
    if "ffp" in lw:  # the megakernel layout: a dense fused FFN only
        ffn = ffn and "w_gateup_il" in lw
    if not (attn and ffn):
        raise NotImplementedError(
            "forward runs fused weights (models.fuse.fuse_weights) or "
            f"unfused attention with an MoE FFN; this layer has {sorted(lw)}")


def qtensor_rows(qt, start: int, n: int):
    """Row-slice a QTensor (one expert of a stacked MoE weight) without a
    copy: wire planes and interleaved planes slice their rows, t-planes
    their lanes (a view keeping the full planes' row pitch, which K1 and
    K3 take as it is)."""
    if not isinstance(qt, QTensor):
        return qt[start:start + n]

    def gw(a):
        return None if a is None else a[start:start + n]

    def gf(a):
        if a is None:
            return None
        return a[:, start:start + n] if qt.fl == "t" else a[start:start + n]

    return QTensor(qt.cfg, n, qt.k, gw(qt.q), gw(qt.d), gw(qt.qh), gw(qt.sc),
                   gw(qt.dmin), gw(qt.m), gf(qt.fq), gf(qt.fs), gf(qt.fb),
                   fl=qt.fl)


def _moe_indirect(cfg, lw, f, topv, topi, cd, plain=False):
    """Gathered top-k expert FFN (MUL_MAT_ID): only the selected experts'
    planes are read (K5 on t-stacks, K8 on interleaved ones, stack by
    stack), so decode cost scales with n_expert_used."""
    B, T, d = f.shape
    Kc = cfg.n_expert_used
    n_ff_e = cfg.n_ff_exp or cfg.n_ff
    P = B * T * Kc
    ids = topi.reshape(P)
    xp = torch.repeat_interleave(f.reshape(B * T, d).to(torch.float32), Kc,
                                 dim=0)
    g = qmatmul_fast_indirect(xp, lw["ffn_gate_exps"], ids, n_ff_e,
                              plain=plain)
    u = qmatmul_fast_indirect(xp, lw["ffn_up_exps"], ids, n_ff_e, plain=plain)
    gu = silu(g.to(cd)) * u.to(cd)
    dly = qmatmul_fast_indirect(gu.to(torch.float32), lw["ffn_down_exps"],
                                ids, d, plain=plain)
    return torch.sum(dly.reshape(B, T, Kc, d)
                     * topv[..., None].to(torch.float32), dim=2)


def _moe_ffn(cfg, lw, f, cd, plain=False):
    """Mixture-of-experts FFN on the normed input f [B, T, d]: router
    softmax -> top-k -> renorm; the gathered path (K5/K8) at <= 8 rows, else
    the dense all-experts evaluation (every expert computed, unselected
    ones weighted 0), as the JAX package does."""
    if cfg.moe_gating != "softmax":
        raise NotImplementedError(f"moe_gating {cfg.moe_gating!r}")
    E, K = cfg.n_expert, cfg.n_expert_used
    n_ff = cfg.n_ff_exp or cfg.n_ff
    router = matmul(f, lw["ffn_gate_inp"], plain).to(torch.float32)
    probs = torch.softmax(router, dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)
    if MOE_ROUTING is not None:
        MOE_ROUTING.append((probs, topi))
    if cfg.norm_topk_prob:
        topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    if (math.prod(f.shape[:-1]) <= QP8_MAX_DECODE
            and _supports_moe_indirect(cfg, lw)):
        out = _moe_indirect(cfg, lw, f, topv, topi, cd, plain)
        return out.to(cd) + _shared_expert_out(cfg, lw, f, cd, plain)
    onehot = torch.nn.functional.one_hot(topi, E).to(torch.float32)
    w_tok = torch.einsum("btk,btke->bte", topv, onehot)
    d = cfg.n_embd
    out = 0.0
    for e in range(E):
        gate_e = qtensor_rows(lw["ffn_gate_exps"], e * n_ff, n_ff)
        up_e = qtensor_rows(lw["ffn_up_exps"], e * n_ff, n_ff)
        down_e = qtensor_rows(lw["ffn_down_exps"], e * d, d)
        g = silu(matmul(f, gate_e, plain).to(cd))
        u = matmul(f, up_e, plain).to(cd)
        dly = matmul(g * u, down_e, plain).to(torch.float32)
        out = out + dly * w_tok[..., e:e + 1]
    out = out + _shared_expert_out(cfg, lw, f, cd, plain)
    return out.to(cd)


def _shared_expert_out(cfg, lw, f, cd, plain=False):
    """Shared-expert branch (deepseek/qwen2moe), added to the routed sum."""
    if "ffn_gate_shexp" not in lw:
        return torch.zeros((), dtype=cd, device=f.device)
    g = silu(matmul(f, lw["ffn_gate_shexp"], plain).to(cd))
    u = matmul(f, lw["ffn_up_shexp"], plain).to(cd)
    sh = matmul(g * u, lw["ffn_down_shexp"], plain).to(torch.float32)
    if "ffn_gate_inp_shexp" in lw:  # qwen2moe: sigmoid-gated shared expert
        sh = torch.sigmoid(
            matmul(f, lw["ffn_gate_inp_shexp"], plain).to(torch.float32)) * sh
    return sh.to(cd)


def _supports_moe_indirect(cfg, lw) -> bool:
    """The gathered path applies to every expert stack of the layer (each
    stack on its own layout: K5 for t-planes, K8 for interleaved ones)."""
    n_ff_e = cfg.n_ff_exp or cfg.n_ff
    return (supports_indirect(lw.get("ffn_gate_exps"), n_ff_e)
            and supports_indirect(lw.get("ffn_up_exps"), n_ff_e)
            and supports_indirect(lw.get("ffn_down_exps"), cfg.n_embd))


def _ffn(cfg, lw, h, cd, plain=False):
    """Gated FFN on the residual h, RMSNorm folded into the gate_up matmul
    (the reference's `w_gateup_il` branch).  Returns the new residual: on
    the decode path the act+down kernel adds h itself.  The gate_up output
    is in ffn_down's column order (natural for t-planes, interleaved for
    the interleaved layout): the act-mul at prefill runs on it as it is
    and the down projection takes it pre-interleaved.  A megakernel-layout
    layer ("ffp") never takes the act mode: its down output comes in the
    il32 row order and is un-permuted before the residual is added."""
    gu2 = qmatmul_normed(h, lw["w_gateup_il"], lw["ffn_norm_il"],
                         cfg.rms_eps, plain=plain)
    dn = lw["ffn_down"]
    ffp = "ffp" in lw
    if not ffp and math.prod(gu2.shape[:-1]) <= QP8_MAX_DECODE:
        return qmatmul_fast_act(gu2, dn, cfg.act, res=h, plain=plain).to(cd)
    ng = dn.k
    gu = silu(gu2[..., :ng].to(cd)) * gu2[..., ng:].to(cd)
    y = qmatmul_fast(gu, dn, plain=plain, pre_interleaved=True)
    if ffp:
        y = uninterleave_cols(y, 32)
    return h + y.to(cd)


def _ffn_out(cfg, lw, h, cd, plain=False):
    """FFN dispatch (MoE or dense) on the residual h; returns the new
    residual."""
    if "ffn_gate_inp" in lw:
        f = rms_norm(h, lw["ffn_norm"], cfg.rms_eps)
        return h + _moe_ffn(cfg, lw, f, cd, plain)
    return _ffn(cfg, lw, h, cd, plain)


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
    bits = kv_bits(kv_cache)
    fused_kv = []
    for il, lw in enumerate(weights["layers"]):
        _check_fused(lw)
        h_in = h
        nh, nhkv = cfg.nh(il), cfg.nhkv(il)
        nq, nk = nh * cfg.hd, nhkv * cfg.hd
        wn = lw.get("attn_norm_il")
        use_fused = (T == 1 and cfg.rope_mode in ("neox", "none")
                     and nh % nhkv == 0 and cfg.hd % 128 == 0)
        flat_qkv = q = k = v = None
        if "wq" in lw:  # unfused: mixed layouts (Mixtral's Q8_0 wk/wv)
            a = rms_norm(h, lw["attn_norm"], eps)
            q = matmul(a, lw["wq"], plain)
            k = matmul(a, lw["wk"], plain)
            v = matmul(a, lw["wv"], plain)
        elif "wqkv" in lw:
            qkv = qmatmul_normed(h, lw["wqkv"], wn, eps, plain=plain)
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
        elif (use_fused and B <= QP8_MAX_DECODE
              and supports_dual(lw["wqk"], lw["wv"])):
            # one launch whose output is the flat q++k++v row (K2 or K7)
            flat_qkv = qmatmul_fast_dual(h[:, 0], lw["wqk"], lw["wv"], wn,
                                         lw["attn_norm_il_v"], eps,
                                         plain=plain)
        else:  # mixed layouts (IQ4_XS wqk, Q5_K wv): one normed call each
            qk = qmatmul_normed(h, lw["wqk"], wn, eps, plain=plain)
            v = qmatmul_normed(h, lw["wv"], lw["attn_norm_il_v"], eps,
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
                kq, kd = _kv_quantize(k.reshape(B, T, -1), bits)
                vq, vd = _kv_quantize(v.reshape(B, T, -1), bits)
                if bits == 4:
                    kq, vq = pack_int4(kq), pack_int4(vq)
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
            k_full, v_full = kv_cache["k"][il], kv_cache["v"][il]
            if bits == 4:  # the int8 path's values
                k_full, v_full = unpack_int4(k_full), unpack_int4(v_full)
            k_full = k_full.reshape(B, S, nhkv, cfg.hd)
            v_full = v_full.reshape(B, S, nhkv, cfg.hd)
            attn = _attention(cfg, q, k_full, v_full, pos_start, T, scale,
                              k_scale=k_sc, v_scale=v_sc).to(cd)
        ffp = "ffp" in lw
        if ffp and T == 1 and B <= QP8_MAX_DECODE:
            # the whole FFN with both residuals in one launch (K9)
            h = ffn_fused(attn[:, 0], h[:, 0], lw["wo"], lw["w_gateup_il"],
                          lw["ffn_down"], lw["ffn_norm_il"], eps, act=cfg.act,
                          out_dtype=cd, plain=plain)[:, None]
        else:
            if (T == 1 and B <= QP8_MAX_DECODE and not ffp
                    and supports_fused_epilogue(lw["wo"])):
                h = qmatmul_fast_res(attn, lw["wo"], h, plain=plain).to(cd)
            else:
                y = matmul(attn, lw["wo"], plain)
                if ffp:  # wo's rows in the il32 order
                    y = uninterleave_cols(y, 32)
                h = h + y.to(cd)
            h = _ffn_out(cfg, lw, h, cd, plain)
        if LAYER_HOOK is not None:
            h = LAYER_HOOK(il, h_in, h)

    if fused_kv:
        # one cache write for all fused layers (the rows never touched the
        # cache inside the layer loop)
        ils = torch.tensor([i for i, _, _ in fused_kv], device=dev)
        ks = torch.stack([kr for _, kr, _ in fused_kv])   # [F, B, HD] f32
        vs = torch.stack([vr for _, _, vr in fused_kv])
        planes = [("k", ks), ("v", vs)]
        if quant_kv:
            kq, kd = _kv_quantize(ks, bits)
            vq, vd = _kv_quantize(vs, bits)
            if bits == 4:
                kq, vq = pack_int4(kq), pack_int4(vq)
            planes = [("k", kq), ("v", vq), ("k_d", kd), ("v_d", vd)]
        for name, rows in planes:
            dst = kv_cache[name]
            dst[ils, :, pos_start] = rows.to(dst.dtype)
    h = rms_norm(h, weights["output_norm"], eps)
    if not logits_all:
        h = h[:, -1, :]
    logits = matmul(h, weights["output"], plain)
    return logits.to(torch.float32), kv_cache
