"""Weight-fusion transforms: fewer launches per decode step.

Counterpart of ggml_hexagon_tpu/models/fuse.py:25-209, 212-307, 310-342:

- fuse_weights concatenates Q/K/V (or Q/K when V has another qtype, the
  Q4_K_M shape) and gate/up along the planes' output-feature axis (lanes
  of the t-layout, rows of the interleaved one); layers whose Q and K
  types differ (Mixtral's Q5_K wq, Q8_0 wk) stay unfused, and MoE layers
  have no gate/up to fuse;
- attach_norm_planes records the RMS-norm weights the fused norm+matmul
  kernels take, interleaved like the matmul's columns (raw for t-planes,
  which have no column interleave);
- interleave_gateup_rows turns w_gateup into w_gateup_il, which routes
  decode through the fused act+down kernel: its rows permuted per half
  into ffn_down's interleaved column order, or renamed only when ffn_down
  has t-planes (natural column order);
- attach_ffn_fused_layout prepares the whole-FFN megakernel (K9,
  ops/ffn_fused.py): the output rows of wo and ffn_down permuted by
  interleave_perm(d, 32) and the marker key "ffp" (value None) on each
  layer that qualifies; fuse_weights applies it last when asked
  (ffn_fused=True), where the JAX package reads GHT_FFN_FUSED=1;
- permute_rope_neox converts an adjacent-pair ("norm") rope model to
  split-half pairing by permuting the Q/K output rows once.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..ops.ffn_fused import supports_ffn_fused
from ..ops.qmm_fast import interleave_perm, supports_fused_epilogue
from ..quant.pack import QTensor


def _concat_qtensors(parts: list) -> QTensor | None:
    """Row-concatenate same-type tensors with unpadded rows, or None.
    Wire planes concatenate; matmul planes concatenate on their
    output-feature axis when unpadded, else are rebuilt from the
    concatenated wire (per-part padding would land mid-tensor) on the
    interleaved layout, whatever the parts' layout: the JAX package
    rebuilds from a device-resident wire, which picks the interleaved
    layout (`_build_planes_auto` takes t-planes from host arrays only)."""
    p0 = parts[0]
    for p in parts:
        if (not isinstance(p, QTensor) or p.cfg != p0.cfg or p.k != p0.k
                or p.fl != p0.fl or p.n != p.n_pad):
            return None
    fax = 1 if p0.fl == "t" else 0

    def cat(field, dim=0):
        arrs = [getattr(p, field) for p in parts]
        if any(a is None for a in arrs):
            return None
        return torch.cat(arrs, dim=dim)

    planes_unpadded = all(p.fq is not None and p.fq.shape[fax] == p.n
                          for p in parts)
    n = sum(p.n for p in parts)
    if all(p.q is not None for p in parts):
        fused = QTensor(p0.cfg, n, p0.k, cat("q"), cat("d"), cat("qh"),
                        cat("sc"), cat("dmin"), cat("m"))
        if any(p.fq is not None for p in parts):
            if planes_unpadded:
                fused = QTensor(fused.cfg, n, p0.k, fused.q, fused.d,
                                fused.qh, fused.sc, fused.dmin, fused.m,
                                cat("fq", fax), cat("fs", fax),
                                cat("fb", fax), fl=p0.fl)
            else:
                fused = fused.with_fast_planes("il")
        return fused
    if planes_unpadded:
        return QTensor(p0.cfg, n, p0.k, fq=cat("fq", fax), fs=cat("fs", fax),
                       fb=cat("fb", fax), fl=p0.fl)
    return None


def _norm_il(wn, qt: QTensor, plus_one: bool):
    """The f32 norm weight of a fused norm+matmul launch, in qt's column
    order: new column j <- original (j % G)*gs + j//G on the interleaved
    layout, raw on the t-layout (gemma-class +1 applied)."""
    w = wn.to(torch.float32)
    if plus_one:
        w = 1.0 + w
    if qt.fl == "t":
        return w
    G = qt.k // qt.cfg.gs
    return w.reshape(G, qt.cfg.gs).transpose(0, 1).reshape(qt.k).contiguous()


def attach_norm_planes(weights: dict, cfg) -> dict:
    """Attach attn_norm_il / attn_norm_il_v / ffn_norm_il per layer where
    the forward folds the pre-matmul RMSNorm into the qmm kernel; each is
    in the column order of the tensor it feeds (wv has its own, since the
    interleave depends on the tensor's layout and group size)."""
    if (cfg.norm_type != "rms" or cfg.swin_norm or not cfg.pre_norms
            or cfg.parallel_residual):
        return weights
    plus_one = cfg.norm_plus_one
    out = dict(weights)
    out["layers"] = []
    for lw in weights["layers"]:
        new = dict(lw)
        wq = lw.get("wqkv")
        if (isinstance(wq, QTensor) and wq.fq is not None
                and lw.get("attn_norm") is not None
                and "attn_norm_b" not in lw and "bqkv" not in lw):
            new["attn_norm_il"] = _norm_il(lw["attn_norm"], wq, plus_one)
        wqk, wv = lw.get("wqk"), lw.get("wv")
        if (isinstance(wqk, QTensor) and wqk.fq is not None
                and isinstance(wv, QTensor) and wv.fq is not None
                and lw.get("attn_norm") is not None
                and "attn_norm_b" not in lw):
            new["attn_norm_il"] = _norm_il(lw["attn_norm"], wqk, plus_one)
            new["attn_norm_il_v"] = _norm_il(lw["attn_norm"], wv, plus_one)
        gu = lw.get("w_gateup")
        if (isinstance(gu, QTensor) and gu.fq is not None
                and lw.get("ffn_norm") is not None
                and "ffn_norm_b" not in lw and "ffn_gate_inp" not in lw):
            new["ffn_norm_il"] = _norm_il(lw["ffn_norm"], gu, plus_one)
        out["layers"].append(new)
    return out


def _rope_perm(n_heads: int, hd: int, n_dims: int):
    """Row permutation from adjacent-pair to split-half rope layout: per
    head, new dim j reads old dim 2j (j < half) or 2(j-half)+1."""
    half = n_dims // 2
    pd = torch.arange(hd)
    pd[:half] = 2 * torch.arange(half)
    pd[half:n_dims] = 2 * torch.arange(half) + 1
    return (torch.arange(n_heads)[:, None] * hd + pd[None, :]).reshape(-1)


def _take_rows(w, perm):
    if isinstance(w, QTensor):
        return w.take_rows(perm)
    return w[perm.to(w.device)]


def permute_rope_neox(weights: dict, cfg):
    """Permute Q/K projection output rows so a "norm"-rope model runs with
    NEOX pairing (q.k dot products are unchanged).  Returns (weights',
    cfg'); a no-op for models that do not qualify."""
    if cfg.rope_mode != "norm" or cfg.rope_sections:
        return weights, cfg
    hd = cfg.hd
    n_dims = cfg.rope_n_dims or hd
    if n_dims % 2 or n_dims > hd:
        return weights, cfg
    out = dict(weights)
    out["layers"] = []
    for il, lw in enumerate(weights["layers"]):
        new = dict(lw)
        nh, nhkv = cfg.nh(il), cfg.nhkv(il)
        has_attn = ("wq" in lw or "wqkv" in lw or "wqk" in lw) and nhkv > 0
        if has_attn:
            pq = _rope_perm(nh, hd, n_dims)
            pk = _rope_perm(nhkv, hd, n_dims)
            if "wqkv" in lw:
                nq, nk = nh * hd, nhkv * hd
                perm = torch.cat([pq, nq + pk, nq + nk + torch.arange(nk)])
                new["wqkv"] = _take_rows(lw["wqkv"], perm)
            else:
                new["wq"] = _take_rows(lw["wq"], pq)
                new["wk"] = _take_rows(lw["wk"], pk)
        out["layers"].append(new)
    return out, replace(cfg, rope_mode="neox")


def interleave_gateup_rows(weights: dict, cfg) -> dict:
    """Replace w_gateup with w_gateup_il where ffn_down takes the fused
    act+down epilogue (supports_fused_epilogue): on the interleaved layout
    the gate_up output rows are permuted, per half, into ffn_down's
    interleaved column order, so the raw gate_up output feeds the fused
    kernel with no relayout (act-mul commutes with the permutation applied
    to both halves); the t-layout consumes it in natural order, so only
    the name changes."""
    if cfg.act not in ("silu", "gelu", "relu"):
        return weights
    out = dict(weights)
    out["layers"] = []
    for lw in weights["layers"]:
        new = dict(lw)
        gu, dn = lw.get("w_gateup"), lw.get("ffn_down")
        if (isinstance(gu, QTensor) and gu.fq is not None
                and isinstance(dn, QTensor) and supports_fused_epilogue(dn)
                and gu.n == 2 * dn.k):
            if dn.fl == "t":
                new["w_gateup_il"] = gu
            else:
                perm = interleave_perm(dn.k, dn.cfg.gs)
                new["w_gateup_il"] = gu.take_rows(torch.cat([perm,
                                                             dn.k + perm]))
            del new["w_gateup"]
        out["layers"].append(new)
    return out


#: layer keys that keep a layer off the megakernel (the JAX list, fuse.py:
#: 291-297): LoRA, scales, biases, sub-norms, control vectors, MoE
_NOT_FFP = ("wo_lora", "wo_scale", "bo", "attn_sub_norm", "ffn_down_lora",
            "ffn_down_b", "ffn_down_scale", "ffn_sub_norm", "cvec",
            "ffn_gate_inp")


def attach_ffn_fused_layout(weights: dict, cfg) -> dict:
    """Prepare the layers that qualify for the whole-FFN megakernel (K9):
    their wo and ffn_down output rows permuted by interleave_perm(d, 32),
    so the hidden state streams through the kernel in the il32 order that
    gate_up's planes consume, and the marker key "ffp" set (value None).
    The rows are permuted in place of the old ones (no copy kept); the
    prefill and fallback paths un-permute the projections' outputs
    (models/llama.py).  A layer qualifies with interleaved wo, w_gateup_il
    and ffn_down that `supports_ffn_fused` takes, an ffn_norm_il, and none
    of the _NOT_FFP keys; the config must be a pre-norm RMS model without
    post-norms, sandwich norms, a parallel residual or a residual scale."""
    if (cfg.norm_type != "rms" or cfg.act not in ("silu", "gelu", "relu")
            or cfg.post_norms or cfg.swin_norm or cfg.parallel_residual
            or cfg.residual_scale != 1.0 or not cfg.pre_norms):
        return weights
    d = cfg.n_embd
    out = dict(weights)
    out["layers"] = []
    for lw in weights["layers"]:
        new = dict(lw)
        wo, gu, dn = lw.get("wo"), lw.get("w_gateup_il"), lw.get("ffn_down")
        if (all(isinstance(t, QTensor) and t.fl == "il" for t in (wo, gu, dn))
                and "ffn_norm_il" in lw
                and not any(k in lw for k in _NOT_FFP)
                and supports_ffn_fused(wo, gu, dn, d, dn.k)):
            perm = interleave_perm(d, 32)
            new["wo"] = wo.take_rows(perm)
            new["ffn_down"] = dn.take_rows(perm)
            new["ffp"] = None
        out["layers"].append(new)
    return out


def fuse_weights(weights: dict, cfg, ffn_fused: bool = False) -> dict:
    """wqkv / wqk / w_gateup fused where possible, plus the norm weights
    for in-kernel norm+matmul fusion; with ffn_fused, the megakernel
    layout on the layers that take it (attach_ffn_fused_layout)."""
    out = dict(weights)
    out["layers"] = []
    for lw in weights["layers"]:
        new = dict(lw)
        if (not cfg.attn_bias and "attn_q_norm" not in lw
                and all(isinstance(lw.get(k), QTensor)
                        for k in ("wq", "wk", "wv"))):
            fused = _concat_qtensors([lw["wq"], lw["wk"], lw["wv"]])
            if fused is not None:
                new["wqkv"] = fused
                del new["wq"], new["wk"], new["wv"]
            else:
                fused2 = _concat_qtensors([lw["wq"], lw["wk"]])
                if fused2 is not None:
                    new["wqk"] = fused2
                    del new["wq"], new["wk"]
        if all(isinstance(lw.get(k), QTensor) for k in ("ffn_gate", "ffn_up")):
            fused = _concat_qtensors([lw["ffn_gate"], lw["ffn_up"]])
            if fused is not None:
                new["w_gateup"] = fused
                del new["ffn_gate"], new["ffn_up"]
        out["layers"].append(new)
    out = interleave_gateup_rows(attach_norm_planes(out, cfg), cfg)
    return attach_ffn_fused_layout(out, cfg) if ffn_fused else out
