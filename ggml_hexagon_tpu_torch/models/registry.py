"""Architecture registry — per-arch config construction from GGUF metadata.

The port's own copy of ggml_hexagon_tpu/models/registry.py (the port imports nothing of the JAX
package).

The analog of the reference's llama_arch registry (src/llama-arch.cpp: 64
architectures with per-arch KV keys and tensor-name tables).  Each entry
maps GGUF metadata to the feature-flagged LlamaConfig that drives forward()
(the variation points of the llm_build_* builders).
"""
from __future__ import annotations

import math
from typing import Callable

from .llama import LlamaConfig


def _base(md: dict, arch: str, **overrides) -> LlamaConfig:
    g = lambda k, d=None: md.get(f"{arch}.{k}", d)

    def scalar_or_arr(v):
        """deci/openelm store per-layer head/ffn counts as GGUF arrays."""
        if isinstance(v, (list, tuple)):
            return int(max(v)), tuple(int(x) for x in v)
        return int(v), ()

    n_head, n_head_arr = scalar_or_arr(g("attention.head_count"))
    n_head_kv, n_head_kv_arr = scalar_or_arr(g("attention.head_count_kv", n_head))
    n_ff, _ = scalar_or_arr(g("feed_forward_length"))
    scaling = g("rope.scaling.type", "none") or "none"
    freq_scale = 1.0
    ext_factor = 0.0
    if scaling in ("linear", "yarn") and g("rope.scaling.factor"):
        freq_scale = 1.0 / float(g("rope.scaling.factor"))
        if scaling == "yarn":
            ext_factor = 1.0
    n_vocab = md.get(f"{arch}.vocab_size") or len(md.get("tokenizer.ggml.tokens", [])) or 32000
    kw = dict(
        n_vocab=int(n_vocab),
        n_embd=int(g("embedding_length")),
        n_layer=int(g("block_count")),
        n_head=n_head,
        n_head_arr=n_head_arr,
        n_head_kv=n_head_kv,
        n_head_kv_arr=n_head_kv_arr,
        n_ff=n_ff,
        rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(g("rope.freq_base", 10000.0)),
        rope_freq_scale=freq_scale,
        rope_ext_factor=ext_factor,
        # longrope/yarn attn magnitude correction (phi3 converter writes
        # sqrt(1+log(scale)/log(orig_ctx)) as rope.scaling.attn_factor)
        rope_attn_factor=float(g("rope.scaling.attn_factor", 1.0)),
        # n_ctx_orig_yarn: original_context_length wins (llama.cpp hparams)
        n_ctx_train=int(g("rope.scaling.original_context_length", 0)
                        or g("context_length", 2048)),
        head_dim=int(g("attention.key_length", 0)),
        n_expert=int(g("expert_count", 0)),
        n_expert_used=int(g("expert_used_count", 0)),
        n_ff_exp=int(g("expert_feed_forward_length", 0)),
        arch=arch,
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def _llama(md):
    return _base(md, "llama")


def _qwen2(md):
    return _base(md, "qwen2", attn_bias=True, rope_mode="neox")


def _qwen2moe(md):
    return _base(md, "qwen2moe", attn_bias=True, rope_mode="neox",
                 norm_topk_prob=False)


def _gemma(md):
    # note: GGUF gemma norms are stored as (w+1) by conversion, so runtime
    # uses plain RMSNorm (convert_hf_to_gguf GemmaModel.modify_tensors)
    cfg = _base(md, "gemma", rope_mode="neox", act="gelu")
    return LlamaConfig(**{**cfg.__dict__, "embd_scale": math.sqrt(cfg.n_embd)})


def _gemma2(md):
    g = lambda k, d=None: md.get(f"gemma2.{k}", d)
    cfg = _base(
        md, "gemma2", rope_mode="neox", act="gelu",
        post_norms=True,
        attn_logit_softcap=float(g("attn_logit_softcapping", 50.0)),
        final_logit_softcap=float(g("final_logit_softcapping", 30.0)),
        swa_window=int(g("attention.sliding_window", 4096)),
        swa_pattern=2,  # every other layer is SWA
    )
    return LlamaConfig(**{**cfg.__dict__, "embd_scale": math.sqrt(cfg.n_embd)})


def _mixtral_or_llama(md):
    # llama arch with expert_count > 0 == mixtral-style MoE
    return _base(md, "llama")


def _phi3(md):
    return _base(md, "phi3", rope_mode="neox")


def _mistral(md):
    return _base(md, "llama")


def _ln_eps(md, arch):
    return float(md.get(f"{arch}.attention.layer_norm_epsilon", 1e-5))


def _gpt2(md):
    # reference: llm_build_gpt2 — LayerNorm, learned positions, fused QKV,
    # gelu FFN without gate, biases everywhere, tied lm_head, no RoPE
    return _base(md, "gpt2", norm_type="layer", rms_eps=_ln_eps(md, "gpt2"),
                 rope_mode="none", pos_embd=True, attn_bias=True, act="gelu")


def _gptneox(md):
    # reference: llm_build_gptneox — LN, partial rotary (rotary_pct),
    # parallel residual (use_parallel_residual), fused QKV with bias
    return _base(
        md, "gptneox", norm_type="layer", rms_eps=_ln_eps(md, "gptneox"),
        rope_mode="neox", attn_bias=True, act="gelu",
        rope_n_dims=int(md.get("gptneox.rope.dimension_count", 0)),
        parallel_residual=bool(md.get("gptneox.use_parallel_residual", True)),
    )


def _falcon(md):
    # reference: llm_build_falcon — single input LN shared by attn+FFN,
    # parallel residual, MQA/GQA fused QKV without bias, gelu no-gate
    return _base(md, "falcon", norm_type="layer", rms_eps=_ln_eps(md, "falcon"),
                 rope_mode="neox", act="gelu",
                 parallel_residual=True, shared_ffn_norm=True)


def _phi2(md):
    # reference: llm_build_phi2 — LN, partial rotary, parallel residual with
    # shared norm, separate QKV with bias, lm_head bias
    return _base(md, "phi2", norm_type="layer", rms_eps=_ln_eps(md, "phi2"),
                 rope_mode="neox", attn_bias=True, act="gelu",
                 rope_n_dims=int(md.get("phi2.rope.dimension_count", 0)),
                 parallel_residual=True, shared_ffn_norm=True)


def _starcoder2(md):
    # reference: llm_build_starcoder2 — LN with bias, full NEOX rope,
    # gelu no-gate FFN with biases, sequential residual
    return _base(md, "starcoder2", norm_type="layer",
                 rms_eps=_ln_eps(md, "starcoder2"),
                 rope_mode="neox", attn_bias=True, act="gelu")


def _command_r(md):
    # reference: llm_build_command_r — LayerNorm (no bias), parallel residual
    # with shared attn_norm, NORM rope, optional per-head QK LayerNorms,
    # tied embeddings, final logit scaling (command-r.logit_scale)
    return _base(md, "command-r", norm_type="layer",
                 rms_eps=_ln_eps(md, "command-r"),
                 parallel_residual=True, shared_ffn_norm=True,
                 logit_scale=float(md.get("command-r.logit_scale", 1.0)))


def _stablelm(md):
    # reference: llm_build_stablelm — LayerNorm with bias, partial NEOX
    # rotary (rope.dimension_count), SwiGLU FFN, optional QKV biases
    return _base(md, "stablelm", norm_type="layer",
                 rms_eps=_ln_eps(md, "stablelm"), rope_mode="neox",
                 rope_n_dims=int(md.get("stablelm.rope.dimension_count", 0)))


def _olmo2(md):
    # reference: llm_build_olmo2 — no pre-norms; RMS post-norms inside the
    # residual; flat QK RMS norms before reshape; NEOX rope
    return _base(md, "olmo2", rope_mode="neox",
                 pre_norms=False, post_norms=True)


def _internlm2(md):
    # reference: llm_build_internlm2 — llama graph (NORM rope, SwiGLU)
    return _base(md, "internlm2")


def _mpt(md):
    # reference: llm_build_mpt — LN, fused QKV (optionally clamped), ALiBi
    # (no rope), optional flat QK LayerNorms, gelu no-gate FFN
    return _base(md, "mpt", norm_type="layer", rms_eps=_ln_eps(md, "mpt"),
                 rope_mode="none", act="gelu",
                 alibi_max_bias=float(md.get("mpt.attention.max_alibi_bias", 0.0)),
                 clamp_qkv=float(md.get("mpt.attention.clamp_kqv", 0.0)))


def _bloom(md):
    # reference: llm_build_bloom — embedding LayerNorm, ALiBi (f_max_alibi_bias
    # fixed at 8, llama-model.cpp load_hparams), LN, gelu no-gate FFN
    return _base(md, "bloom", norm_type="layer", rms_eps=_ln_eps(md, "bloom"),
                 rope_mode="none", act="gelu", alibi_max_bias=8.0)


def _starcoder(md):
    # reference: llm_build_starcoder — gpt2-class graph with MQA:
    # LN, learned positions, fused QKV + bias, gelu no-gate FFN, no rope
    return _base(md, "starcoder", norm_type="layer",
                 rms_eps=_ln_eps(md, "starcoder"),
                 rope_mode="none", pos_embd=True, attn_bias=True, act="gelu")


def _olmo(md):
    # reference: llm_build_olmo — llama graph with non-parametric LayerNorm
    # (NULL norm weights), optional QKV clamp, NORM rope, SwiGLU
    return _base(md, "olmo", norm_type="layer",
                 rms_eps=float(md.get("olmo.attention.layer_norm_epsilon", 1e-5)),
                 clamp_qkv=float(md.get("olmo.attention.clamp_kqv", 0.0)))


def _granite(md, arch="granite"):
    # reference: llm_build_granite — llama graph + four scales
    # (GGUF keys per GraniteModel.set_gguf_parameters)
    ls = float(md.get(f"{arch}.logit_scale", 0.0))
    return _base(md, arch,
                 attn_scale=float(md.get(f"{arch}.attention.scale", 0.0)),
                 embd_scale=float(md.get(f"{arch}.embedding_scale", 1.0)),
                 residual_scale=float(md.get(f"{arch}.residual_scale", 1.0)),
                 logit_scale=(1.0 / ls) if ls else 1.0)


def _granitemoe(md):
    return _granite(md, "granitemoe")


def _nemotron(md):
    # reference: llm_build_nemotron — LN (layernorm1p baked at convert),
    # partial NEOX rope, relu^2 no-gate FFN
    return _base(md, "nemotron", norm_type="layer",
                 rms_eps=_ln_eps(md, "nemotron"), rope_mode="neox",
                 act="relu2",
                 rope_n_dims=int(md.get("nemotron.rope.dimension_count", 0)))


def _olmoe(md):
    # reference: llm_build_olmoe — RMS norms, flat QK RMS norms, NEOX rope,
    # MoE with norm_topk=false
    return _base(md, "olmoe", rope_mode="neox", norm_topk_prob=False,
                 rms_eps=float(md.get("olmoe.attention.layer_norm_rms_epsilon", 1e-5)))


def _dbrx(md):
    # reference: llm_build_dbrx — LN (no bias), fused clamped QKV, NEOX rope,
    # MoE with norm_topk=true
    return _base(md, "dbrx", norm_type="layer", rms_eps=1e-5,
                 rope_mode="neox",
                 clamp_qkv=float(md.get("dbrx.attention.clamp_kqv", 0.0)))


def _gemma3(md):
    # reference: llm_build_gemma3 — gemma2 sandwich norms + per-head QK RMS
    # norms before rope + per-layer rope base (SWA layers: theta 10000,
    # scale 1; pattern 5 local : 1 global, llama-model.cpp n_swa_pattern=6)
    g = lambda k, d=None: md.get(f"gemma3.{k}", d)
    cfg = _base(
        md, "gemma3", rope_mode="neox", act="gelu", post_norms=True,
        swa_window=int(g("attention.sliding_window", 1024)),
        swa_pattern=6, rope_theta_swa=10000.0, rope_freq_scale_swa=1.0,
        attn_scale=float(g("attention.scale", 0.0)),
    )
    return LlamaConfig(**{**cfg.__dict__, "embd_scale": math.sqrt(cfg.n_embd)})


def _cohere2(md):
    # reference: llm_build_cohere2 — command-r graph (parallel residual,
    # shared LN) + SWA pattern 3:1 with rope applied only on SWA layers
    return _base(md, "cohere2", norm_type="layer",
                 rms_eps=_ln_eps(md, "cohere2"),
                 parallel_residual=True, shared_ffn_norm=True,
                 logit_scale=float(md.get("cohere2.logit_scale", 1.0)),
                 swa_window=int(md.get("cohere2.attention.sliding_window", 4096)),
                 swa_pattern=4, rope_swa_only=True)


def _qwen3(md):
    # qwen2 graph + per-head QK RMS norms, no attention bias
    return _base(md, "qwen3", rope_mode="neox")


def _qwen3moe(md):
    return _base(md, "qwen3moe", rope_mode="neox",
                 norm_topk_prob=bool(md.get("qwen3moe.norm_topk_prob", True)))


def _chatglm(md):
    # reference: llm_build_chatglm — RMS norms, partial NORM-mode rope,
    # fused SWIGLU gate_up, optional QKV bias
    return _base(md, "chatglm",
                 rope_n_dims=int(md.get("chatglm.rope.dimension_count", 0)))


def _phimoe(md):
    # reference: PHIMOE dispatches llm_build_phi3 with MoE (norm_topk=true);
    # we keep HF-faithful LayerNorm+bias and sparsemixer inference routing
    return _base(md, "phimoe", norm_type="layer", rope_mode="neox",
                 moe_gating="sparsemixer",
                 moe_jitter_eps=float(md.get("phimoe.router_jitter_noise", 0.0)))


def _minicpm(md):
    # reference: MINICPM dispatches llm_build_llama with granite-style
    # scales (MiniCPMModel.set_gguf_parameters formulas)
    ls = float(md.get("minicpm.logit_scale", 0.0))
    return _base(md, "minicpm",
                 embd_scale=float(md.get("minicpm.embedding_scale", 1.0)),
                 residual_scale=float(md.get("minicpm.residual_scale", 1.0)),
                 logit_scale=(1.0 / ls) if ls else 1.0)


def _exaone(md):
    # reference: llm_build_exaone — llama graph with NEOX rope
    return _base(md, "exaone", rope_mode="neox",
                 rope_n_dims=int(md.get("exaone.rope.dimension_count", 0)))


def _deepseek(md):
    # reference: llm_build_deepseek — llama graph + MoE (norm_topk=false)
    # with unsigned shared experts and leading dense layers
    return _base(md, "deepseek", norm_topk_prob=False)


def _baichuan(md):
    # reference: llm_build_baichuan — RMS + SwiGLU; 7B uses NORM rope,
    # 13B (n_layer 40) uses ALiBi (f_max_alibi_bias = 8)
    n_layer = int(md.get("baichuan.block_count", 32))
    if n_layer >= 40:
        return _base(md, "baichuan", rope_mode="none", alibi_max_bias=8.0)
    return _base(md, "baichuan")


def _xverse(md):
    # reference: llm_build_xverse — the llama graph
    return _base(md, "xverse")


def _orion(md):
    # reference: llm_build_orion — LayerNorm + bias, NORM rope, SwiGLU
    return _base(md, "orion", norm_type="layer", rms_eps=_ln_eps(md, "orion"))


def _qwen(md):
    # reference: llm_build_qwen — RMS, fused QKV + bias, NEOX rope, SwiGLU
    return _base(md, "qwen", rope_mode="neox", attn_bias=True)


def _jais(md):
    # reference: llm_build_jais — LN + bias, fused QKV, ALiBi, SwiGLU,
    # kq_scale = 1/n_embd_head (muP; tensor scales baked at convert)
    n_embd = int(md.get("jais.embedding_length"))
    n_head = int(md.get("jais.attention.head_count"))
    return _base(md, "jais", norm_type="layer", rms_eps=_ln_eps(md, "jais"),
                 rope_mode="none", attn_bias=True,
                 alibi_max_bias=float(md.get("jais.attention.max_alibi_bias", 8.0)),
                 attn_scale=1.0 / (n_embd // n_head))


def _grok(md):
    # reference: llm_build_grok — RMS norms, NEOX rope, kq_scale = 1.0,
    # pre-residual attn_output_norm/layer_output_norm, gelu MoE
    # (norm_topk=true), embeddings x78.38367176906169, logits
    # x0.5773502691896257 (src/llama-model.cpp:4883-5043)
    return _base(md, "grok", rope_mode="neox", act="gelu", attn_scale=1.0,
                 post_norms=True, embd_scale=78.38367176906169,
                 logit_scale=0.5773502691896257)


def _plamo(md):
    # reference: llm_build_plamo — RMS, NORM rope over the full head dim,
    # parallel residual with the FFN reading the attn_norm output
    return _base(md, "plamo", parallel_residual=True, shared_ffn_norm=True)


def _codeshell(md):
    # reference: llm_build_codeshell — LN + bias, fused QKV + bias, partial
    # NEOX rope (rope.dimension_count), gelu no-gate FFN
    return _base(md, "codeshell", norm_type="layer",
                 rms_eps=_ln_eps(md, "codeshell"), rope_mode="neox",
                 attn_bias=True, act="gelu",
                 rope_n_dims=int(md.get("codeshell.rope.dimension_count", 0)))


def _refact(md):
    # reference: llm_build_refact — RMS + SwiGLU, no rope, ALiBi with
    # f_max_alibi_bias hardcoded to 8 (load_hparams :638-639)
    return _base(md, "refact", rope_mode="none", alibi_max_bias=8.0)


def _chameleon(md):
    # reference: llm_build_chameleon — llama graph + per-head LayerNorm QK
    # norms with [hd, n_head] distinct weights; swin_norm moves attn_norm/
    # ffn_norm to the block OUTPUT pre-residual (llama-model.cpp:11405-11560)
    swin = bool(md.get("chameleon.swin_norm", False))
    return _base(md, "chameleon", norm_qk_type="layer",
                 swin_norm=swin, pre_norms=not swin)


def _arctic(md):
    # reference: llm_build_arctic — llama graph where EVERY layer has a dense
    # residual MLP plus an MoE branch over ffn_norm_exps(layer input),
    # norm_topk=true (llama-model.cpp:9201-9320)
    return _base(md, "arctic")


def _deci(md):
    # reference: llm_build_deci — llama graph with per-layer head counts;
    # n_head==0 -> attention-free layer, n_head_kv==0 -> "linear attention"
    # (wo only) for Llama-3_1-Nemotron-51B (llama-model.cpp:4360-4530)
    return _base(md, "deci")


def _openelm(md):
    # reference: llm_build_openelm — per-layer n_head/n_head_kv arrays,
    # fused QKV, per-head RMS QK norms, partial NEOX rope, SwiGLU, tied head
    head_dim = int(md.get("openelm.attention.key_length", 0))
    return _base(md, "openelm", rope_mode="neox", head_dim=head_dim,
                 rope_n_dims=int(md.get("openelm.rope.dimension_count", 0)))


def _bailingmoe(md):
    # reference: llm_build_bailingmoe — llama MoE graph whose effective head
    # dim is n_rot (rope.dimension_count), kq_scale = 1/sqrt(n_rot), silu
    # experts + unconditional shared expert, expert_weights_norm from GGUF
    # (llama-model.cpp:11906-12040)
    return _base(md, "bailingmoe",
                 head_dim=int(md.get("bailingmoe.rope.dimension_count", 0)),
                 norm_topk_prob=bool(md.get("bailingmoe.expert_weights_norm", False)))


def _bitnet(md):
    # reference: llm_build_bitnet — llama graph + per-tensor quant scale
    # scalars (attn_q.scale ...), RMS sub-norms before wo / ffn_down, NEOX
    # rope, tied lm_head (llama-model.cpp:9731-9895)
    return _base(md, "bitnet", rope_mode="neox")


def _qwen2vl(md):
    # reference: llm_build_qwen2vl — qwen2 graph with M-RoPE
    # (ggml_rope_multi + rope_sections, llama-model.cpp:6179-6297)
    return _base(md, "qwen2vl", attn_bias=True, rope_mode="mrope",
                 rope_sections=tuple(int(x) for x in
                                     md.get("qwen2vl.rope.dimension_sections",
                                            ())))


ARCHS: dict[str, Callable[[dict], LlamaConfig]] = {
    "llama": _mixtral_or_llama,
    "mistral": _mistral,
    "qwen2": _qwen2,
    "qwen2moe": _qwen2moe,
    "gemma": _gemma,
    "gemma2": _gemma2,
    "phi3": _phi3,
    "gpt2": _gpt2,
    "gptneox": _gptneox,
    "falcon": _falcon,
    "phi2": _phi2,
    "starcoder2": _starcoder2,
    "command-r": _command_r,
    "stablelm": _stablelm,
    "olmo2": _olmo2,
    "internlm2": _internlm2,
    "mpt": _mpt,
    "bloom": _bloom,
    "starcoder": _starcoder,
    "olmo": _olmo,
    "granite": _granite,
    "granitemoe": _granitemoe,
    "nemotron": _nemotron,
    "olmoe": _olmoe,
    "dbrx": _dbrx,
    "gemma3": _gemma3,
    "cohere2": _cohere2,
    "qwen3": _qwen3,
    "qwen3moe": _qwen3moe,
    "chatglm": _chatglm,
    "phimoe": _phimoe,
    "minicpm": _minicpm,
    "exaone": _exaone,
    "deepseek": _deepseek,
    "baichuan": _baichuan,
    "xverse": _xverse,
    "orion": _orion,
    "qwen": _qwen,
    "jais": _jais,
    "grok": _grok,
    "plamo": _plamo,
    "codeshell": _codeshell,
    "refact": _refact,
    "chameleon": _chameleon,
    "arctic": _arctic,
    "deci": _deci,
    "openelm": _openelm,
    "bailingmoe": _bailingmoe,
    "bitnet": _bitnet,
    "qwen2vl": _qwen2vl,
}


def config_from_gguf(md: dict) -> LlamaConfig:
    arch = md.get("general.architecture", "llama")
    if arch not in ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} not yet supported; available: {sorted(ARCHS)}"
        )
    return ARCHS[arch](md)
