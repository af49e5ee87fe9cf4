"""Weight-fusion transforms: fewer launches per decode step.

Counterpart of ggml_hexagon_tpu/models/fuse.py:25-209, 212-250, 310-342 for
the transposed qp8 layout, the only layout the port has:

- fuse_weights concatenates Q/K/V (or Q/K when V has another qtype, the
  Q4_K_M shape) and gate/up along the planes' output-feature axis;
- attach_norm_planes records the RMS-norm weights the fused norm+matmul
  kernels take (raw: the t-layout has no column interleave);
- interleave_gateup_rows renames w_gateup to w_gateup_il, which routes
  decode through the fused act+down kernel (natural column order);
- permute_rope_neox converts an adjacent-pair ("norm") rope model to
  split-half pairing by permuting the Q/K output rows once.

The whole-FFN megakernel layout (attach_ffn_fused_layout) is off by default
in the JAX package and waits for its kernel (K9).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..quant.pack import QTensor


def _concat_qtensors(parts: list) -> QTensor | None:
    """Row-concatenate same-type tensors with unpadded rows, or None.
    Wire planes concatenate; t-planes concatenate when unpadded, else are
    rebuilt from the concatenated wire (per-part lane padding would land
    mid-tensor)."""
    p0 = parts[0]
    for p in parts:
        if (not isinstance(p, QTensor) or p.cfg != p0.cfg or p.k != p0.k
                or p.fl != p0.fl or p.n != p.n_pad):
            return None

    def cat(field, dim=0):
        arrs = [getattr(p, field) for p in parts]
        if any(a is None for a in arrs):
            return None
        return torch.cat(arrs, dim=dim)

    planes_unpadded = all(p.fq is not None and p.fq.shape[1] == p.n
                          for p in parts)
    n = sum(p.n for p in parts)
    if all(p.q is not None for p in parts):
        fused = QTensor(p0.cfg, n, p0.k, cat("q"), cat("d"), cat("qh"),
                        cat("sc"), cat("dmin"), cat("m"))
        if any(p.fq is not None for p in parts):
            if planes_unpadded:
                fused = QTensor(fused.cfg, n, p0.k, fused.q, fused.d,
                                fused.qh, fused.sc, fused.dmin, fused.m,
                                cat("fq", 1), cat("fs", 1), cat("fb", 1),
                                fl=p0.fl)
            else:
                fused = fused.with_t_planes()
        return fused
    if planes_unpadded:
        return QTensor(p0.cfg, n, p0.k, fq=cat("fq", 1), fs=cat("fs", 1),
                       fb=cat("fb", 1), fl=p0.fl)
    return None


def _norm_w(wn, plus_one: bool):
    """The effective f32 norm weight for a fused norm+matmul launch."""
    w = wn.to(torch.float32)
    return 1.0 + w if plus_one else w


def attach_norm_planes(weights: dict, cfg) -> dict:
    """Attach attn_norm_il / attn_norm_il_v / ffn_norm_il per layer where
    the forward folds the pre-matmul RMSNorm into the qmm kernel."""
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
            new["attn_norm_il"] = _norm_w(lw["attn_norm"], plus_one)
        wqk, wv = lw.get("wqk"), lw.get("wv")
        if (isinstance(wqk, QTensor) and wqk.fq is not None
                and isinstance(wv, QTensor) and wv.fq is not None
                and lw.get("attn_norm") is not None
                and "attn_norm_b" not in lw):
            new["attn_norm_il"] = _norm_w(lw["attn_norm"], plus_one)
            new["attn_norm_il_v"] = _norm_w(lw["attn_norm"], plus_one)
        gu = lw.get("w_gateup")
        if (isinstance(gu, QTensor) and gu.fq is not None
                and lw.get("ffn_norm") is not None
                and "ffn_norm_b" not in lw and "ffn_gate_inp" not in lw):
            new["ffn_norm_il"] = _norm_w(lw["ffn_norm"], plus_one)
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
    """Rename w_gateup to w_gateup_il where ffn_down takes the fused
    act+down epilogue; the t-layout consumes the gate_up output in natural
    column order, so no rows move."""
    if cfg.act not in ("silu", "gelu", "relu"):
        return weights
    out = dict(weights)
    out["layers"] = []
    for lw in weights["layers"]:
        new = dict(lw)
        gu, dn = lw.get("w_gateup"), lw.get("ffn_down")
        if (isinstance(gu, QTensor) and gu.fq is not None
                and isinstance(dn, QTensor) and dn.fq is not None
                and dn.fl == "t" and gu.n == 2 * dn.k):
            new["w_gateup_il"] = gu
            del new["w_gateup"]
        out["layers"].append(new)
    return out


def fuse_weights(weights: dict, cfg) -> dict:
    """wqkv / wqk / w_gateup fused where possible, plus the norm weights
    for in-kernel norm+matmul fusion."""
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
    return interleave_gateup_rows(attach_norm_planes(out, cfg), cfg)
