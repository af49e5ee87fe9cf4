"""Planar quantized tensors holding torch planes.

The port's counterpart of ggml_hexagon_tpu/quant/pack.py:46-238.  A weight
[N, K] is a QTensor of separately stored planes:

  wire planes (row-planar, output features on axis 0):
    q    uint8 [n_pad, K*bits_lo/8]  base bits (int8 [n_pad, K] when signed)
    qh   uint8 [n_pad, K*bits_hi/8]  optional high bits
    d    f32   [n_pad, K/gs] or [n_pad, K/256]  scale
    sc   int8  [n_pad, K/gs]  super-block sub-scales (K-quants)
    dmin f32   [n_pad, K/256] asymmetric super-block min scale
    m    u8/f32 [n_pad, K/gs] asymmetric min
  transposed qp8 planes (fl == "t", output features on axis 1):
    fq   uint8 [K*(bits_lo+bits_hi)/8, n2]
    fs   bf16  [K/gs, n2]  per-group scales
    fb   bf16  [K/gs, n2]  affine bias, or None
  interleaved planes (fl == "il", output features on axis 0; column j
  holds original column (j % G)*gs + j//G):
    fq   int8  [n2, K]    values, the byte family (Q8_0, the IQ4 LUT
                          types, and every type of more than 4 bits)
         uint8 [n2, K/2]  packed values, the nibble family (Q4_0, Q4_1,
                          Q4_K): byte b holds column b in its low nibble
                          and column b + K/2 in its high nibble
    fs   bf16  [n2, G]  per-group scales
    fb   bf16  [n2, G]  affine bias of the asymmetric types (Q4_1, Q5_1,
                        Q2_K, Q4_K, Q5_K), or None; the symmetric-offset
                        types (Q4_0, Q5_0, Q3_K, Q6_K) derive it as
                        offset * fs

Element s*(K/per) + j of a b-bit row-planar plane sits in byte j at shift
b*s (per = 8/b).  The t-planes are built by ops/qmm_qp8.build_t_planes,
the interleaved ones by ops/qmm_fast.build_fast_planes; use_qp8_layout
picks between them as the JAX package does, GHT_QP8 included.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import torch

from .formats import GGMLType


@dataclass(frozen=True)
class QConfig:
    """Static per-type kernel configuration."""

    qtype: GGMLType
    bits_lo: int  # 2, 4, or 8
    bits_hi: int  # 0, 1, or 2
    gs: int  # scale group size (16 or 32)
    superblock: bool  # True: scale = f32(d[per-256]) * sc[per-gs]
    asym: str  # 'none' | 'min' (direct f16 m) | 'minsb' (dmin*m6)
    offset: int  # symmetric zero offset: x = scale*(q + offset)
    signed: bool = False  # q plane stored as signed int8 (Q8_0)
    lut: bool = False  # 4-bit codes index the IQ4 non-linear value table
    expand: bool = False  # codebook/ternary: expanded to int8+scale at load
    code_map: str = ""  # '' | 'iq2' | 'iq3xxs' | 'iq3s' | 'iq1' | 'tern'


QCONFIGS: dict[GGMLType, QConfig] = {
    GGMLType.Q4_0: QConfig(GGMLType.Q4_0, 4, 0, 32, False, "none", -8),
    GGMLType.Q4_1: QConfig(GGMLType.Q4_1, 4, 0, 32, False, "min", 0),
    GGMLType.Q5_0: QConfig(GGMLType.Q5_0, 4, 1, 32, False, "none", -16),
    GGMLType.Q5_1: QConfig(GGMLType.Q5_1, 4, 1, 32, False, "min", 0),
    GGMLType.Q8_0: QConfig(GGMLType.Q8_0, 8, 0, 32, False, "none", 0, signed=True),
    GGMLType.Q2_K: QConfig(GGMLType.Q2_K, 2, 0, 16, True, "minsb", 0),
    GGMLType.Q3_K: QConfig(GGMLType.Q3_K, 2, 1, 16, True, "none", -4),
    GGMLType.Q4_K: QConfig(GGMLType.Q4_K, 4, 0, 32, True, "minsb", 0),
    GGMLType.Q5_K: QConfig(GGMLType.Q5_K, 4, 1, 32, True, "minsb", 0),
    GGMLType.Q6_K: QConfig(GGMLType.Q6_K, 4, 2, 16, True, "none", -32),
    GGMLType.IQ4_NL: QConfig(GGMLType.IQ4_NL, 4, 0, 32, False, "none", 0, lut=True),
    GGMLType.IQ4_XS: QConfig(GGMLType.IQ4_XS, 4, 0, 32, True, "none", 0, lut=True),
    GGMLType.IQ2_XXS: QConfig(GGMLType.IQ2_XXS, 8, 0, 32, False, "none", 0, signed=True, expand=True, code_map="iq2"),
    GGMLType.IQ2_XS: QConfig(GGMLType.IQ2_XS, 8, 0, 16, False, "none", 0, signed=True, expand=True, code_map="iq2"),
    GGMLType.IQ2_S: QConfig(GGMLType.IQ2_S, 8, 0, 16, False, "none", 0, signed=True, expand=True, code_map="iq2"),
    GGMLType.IQ3_XXS: QConfig(GGMLType.IQ3_XXS, 8, 0, 32, False, "none", 0, signed=True, expand=True, code_map="iq3xxs"),
    GGMLType.IQ3_S: QConfig(GGMLType.IQ3_S, 8, 0, 32, False, "none", 0, signed=True, expand=True, code_map="iq3s"),
    GGMLType.IQ1_S: QConfig(GGMLType.IQ1_S, 8, 0, 32, False, "none", 0, signed=True, expand=True, code_map="iq1"),
    GGMLType.IQ1_M: QConfig(GGMLType.IQ1_M, 8, 0, 16, False, "none", 0, signed=True, expand=True, code_map="iq1"),
    GGMLType.TQ1_0: QConfig(GGMLType.TQ1_0, 8, 0, 256, False, "none", 0, signed=True, expand=True, code_map="tern"),
    GGMLType.TQ2_0: QConfig(GGMLType.TQ2_0, 8, 0, 256, False, "none", 0, signed=True, expand=True, code_map="tern"),
}


@dataclass
class QTensor:
    """Planar quantized tensor. Logical value: [n, k] f32."""

    cfg: QConfig
    n: int  # true output-feature count (rows may be padded beyond)
    k: int
    q: Any = None
    d: Any = None
    qh: Any = None
    sc: Any = None
    dmin: Any = None
    m: Any = None
    fq: Any = None
    fs: Any = None
    fb: Any = None
    fl: str = "t"
    # the interleaved planes padded to a multiple of 8 groups (a QTensor),
    # made by the first K6/K8 launch on planes whose group count is not one
    # (kernels.padded_il_planes); no constructor argument, so copies and
    # dataclasses.replace start without it
    fpad: Any = field(default=None, init=False, repr=False, compare=False)

    @property
    def n_pad(self) -> int:
        if self.q is not None:
            return self.q.shape[0]
        return self.fq.shape[1 if self.fl == "t" else 0]

    @property
    def device(self) -> torch.device:
        return (self.q if self.q is not None else self.fq).device

    def with_fast_planes(self, layout: str | None = None) -> "QTensor":
        """Copy carrying matmul planes built from the wire planes (no-op
        when planes exist or the type has neither layout).  layout "t"
        takes the t-layout where the type has one and the interleaved one
        elsewhere, "il" the interleaved layout, None what use_qp8_layout
        says (ggml_hexagon_tpu/quant/pack.py:275-290)."""
        if self.fq is not None:
            return self
        if layout is None:
            layout = "t" if use_qp8_layout(self.cfg, self.k) else "il"
        fq = None
        if layout == "t":
            from ..ops.qmm_qp8 import build_t_planes

            fq, fs, fb = build_t_planes(self)
            fl = "t"
        if fq is None:
            from ..ops.qmm_fast import build_fast_planes

            fq, fs, fb = build_fast_planes(self)
            fl = "il"
        if fq is None:
            return self
        return QTensor(self.cfg, self.n, self.k, self.q, self.d, self.qh,
                       self.sc, self.dmin, self.m, fq, fs, fb, fl=fl)

    def take_rows(self, perm) -> "QTensor":
        """Reorder the n output-feature rows by `perm` (a permutation of
        range(n)).  Wire planes and interleaved planes gather on axis 0,
        t-planes on axis 1; padding rows beyond n stay in place."""
        perm = torch.as_tensor(perm, dtype=torch.long).reshape(-1)
        if perm.numel() != self.n:
            raise ValueError(f"take_rows: {perm.numel()} indices for n={self.n}")

        def g(a, axis=0):
            if a is None:
                return None
            full = torch.cat([perm.to(a.device),
                              torch.arange(perm.numel(), a.shape[axis],
                                           device=a.device)])
            return a.index_select(axis, full).contiguous()

        fax = 1 if self.fl == "t" else 0
        return QTensor(self.cfg, self.n, self.k, g(self.q), g(self.d),
                       g(self.qh), g(self.sc), g(self.dmin), g(self.m),
                       g(self.fq, fax), g(self.fs, fax), g(self.fb, fax),
                       fl=self.fl)

    def without_wire(self) -> "QTensor":
        """Drop the wire planes (keeps the matmul planes)."""
        if self.fq is None:
            return self
        return QTensor(self.cfg, self.n, self.k, fq=self.fq, fs=self.fs,
                       fb=self.fb, fl=self.fl)


def use_qp8_layout(cfg: QConfig, k: int) -> bool:
    """True when (cfg, K) takes the transposed qp8 planes, False for the
    interleaved layout (ggml_hexagon_tpu/quant/pack.py:245-272): every
    type with a t-layout takes it, so only Q8_0 and the IQ4 LUT types (and
    widths without a t-layout) keep the interleaved route; GHT_QP8=0 (or
    empty) forces the interleaved layout everywhere."""
    if os.environ.get("GHT_QP8", "1") in ("", "0"):
        return False
    from ..ops.qmm_qp8 import supports_qp8

    return supports_qp8(cfg, k)


#: per-layer matmul keys whose wire planes are dead weight once the matmul
#: planes exist (embeddings keep wire: the token gather dequantizes rows)
_DROPPABLE_KEYS = {"wq", "wk", "wv", "wo", "wqkv", "wqk", "ffn_gate",
                   "ffn_up", "ffn_down", "w_gateup", "w_gateup_il",
                   "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps",
                   "ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"}


def drop_wire_planes(weights: dict) -> dict:
    """Strip redundant wire planes from a model's matmul weights.

    Unlike the JAX package (ggml_hexagon_tpu/quant/pack.py:216-221), the
    MoE expert stacks (`*_exps`) lose their wire planes too.  The JAX
    package keeps them because its prefill above 512 rows dequantizes the
    wire; the port's expert slices run on the t-planes at any batch, and
    its Engine never feeds more than 512 rows.  Kept, they would add
    about 33 GB to a Mixtral-8x7B on the card
    (0.72-0.83 bytes a weight over 45 G expert weights)."""
    out = dict(weights)
    if isinstance(out.get("output"), QTensor):
        out["output"] = out["output"].without_wire()
    layers = []
    for lw in weights.get("layers", []):
        new = dict(lw)
        for key in _DROPPABLE_KEYS:
            v = new.get(key)
            if isinstance(v, QTensor):
                new[key] = v.without_wire()
        layers.append(new)
    out["layers"] = layers
    return out
