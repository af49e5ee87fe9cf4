"""Planar quantized tensors holding torch planes, and the repack of GGUF
wire bytes into them.

The port's counterpart of ggml_hexagon_tpu/quant/pack.py:46-238 and
:293-534 (`_pack_bits`, `unpack_bits`, `_wire_to_planes`, `pack_tensor`,
written in torch, so the wire bytes unpack on whatever device they lie
on: the loader moves a file's raw bytes to the card once and unpacks them
there).  A weight
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

import numpy as np
import torch

from .formats import QK_K, TYPE_TRAITS, GGMLType, row_size


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


# ---------------------------------------------------------------------------
# GGUF wire bytes -> planes (ggml_hexagon_tpu/quant/pack.py:293-534)
# ---------------------------------------------------------------------------

def _pack_bits(q, bits: int):
    """[N, K] ints -> row-planar packed bytes [N, K*bits/8] uint8.

    Byte j holds elements {s*(K/per) + j : s in [0, per)} at shifts b*s."""
    N, K = q.shape
    per = 8 // bits
    qc = q.reshape(N, per, K // per).to(torch.uint8)
    out = torch.zeros((N, K // per), dtype=torch.uint8, device=q.device)
    for s in range(per):
        out |= qc[:, s, :] << (bits * s)
    return out


def unpack_bits(packed, bits: int, K: int):
    """Inverse of _pack_bits -> [N, K] uint8."""
    per = 8 // bits
    mask = (1 << bits) - 1
    return torch.cat([(packed >> (bits * s)) & mask for s in range(per)],
                     dim=1)


def _f16(b, shape):
    """Little-endian f16 byte pairs [..., 2] -> f16 of `shape`."""
    return b.contiguous().view(torch.float16).reshape(shape)


def _nibbles(qs, dim: int):
    """The low nibbles, then the high ones, along `dim`."""
    return torch.cat([qs & 0xF, qs >> 4], dim=dim)


def _unpack_k4_scales(sc):
    """12 packed bytes of block_q4_K.scales [nb, 12] -> (sc6 [nb, 8], m6
    [nb, 8]) int32 (ggml_hexagon_tpu/quant/ref_numpy.py:604-616)."""
    sc = sc.to(torch.int32)
    d6, m6 = [], []
    for j in range(8):
        if j < 4:
            d6.append(sc[:, j] & 63)
            m6.append(sc[:, j + 4] & 63)
        else:
            d6.append((sc[:, j + 4] & 0xF) | ((sc[:, j - 4] >> 6) << 4))
            m6.append((sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4))
    return torch.stack(d6, dim=1), torch.stack(m6, dim=1)


def _wire_to_planes(buf, qtype: GGMLType, N: int, K: int) -> dict:
    """Decode wire bytes (uint8, flat) into {q: [N, K] ints, d, sc, dmin,
    m} (group-major), in the dtypes the JAX package's numpy decode gives."""
    ts = TYPE_TRAITS[qtype].type_size
    u8 = torch.uint8
    if qtype in (GGMLType.Q4_0, GGMLType.IQ4_NL):
        b = buf.reshape(N, K // 32, 18)
        return dict(q=_nibbles(b[:, :, 2:], 2).reshape(N, K),
                    d=_f16(b[:, :, :2], (N, K // 32)))
    if qtype == GGMLType.Q4_1:
        b = buf.reshape(N, K // 32, 20)
        return dict(q=_nibbles(b[:, :, 4:], 2).reshape(N, K),
                    d=_f16(b[:, :, 0:2], (N, K // 32)),
                    m=_f16(b[:, :, 2:4], (N, K // 32)))
    if qtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        hdr = 2 if qtype == GGMLType.Q5_0 else 4
        b = buf.reshape(N, K // 32, hdr + 4 + 16)
        out = dict(d=_f16(b[:, :, 0:2], (N, K // 32)))
        if qtype == GGMLType.Q5_1:
            out["m"] = _f16(b[:, :, 2:4], (N, K // 32))
        qh = (b[:, :, hdr:hdr + 4].contiguous().view(torch.int32)
              .to(torch.int64))                       # [N, K/32, 1]
        qs = b[:, :, hdr + 4:]
        j = torch.arange(16, device=buf.device)
        lo5 = (qs & 0xF) | (((qh >> j) & 1) << 4).to(u8)
        hi5 = (qs >> 4) | (((qh >> (j + 16)) & 1) << 4).to(u8)
        out["q"] = torch.cat([lo5, hi5], dim=2).reshape(N, K)
        return out
    if qtype == GGMLType.Q8_0:
        b = buf.reshape(N, K // 32, 34)
        return dict(q=b[:, :, 2:].contiguous().view(torch.int8).reshape(N, K),
                    d=_f16(b[:, :, :2], (N, K // 32)))
    nb = N * K // QK_K
    if qtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        b = buf.reshape(nb, ts)
        sc6, m6 = _unpack_k4_scales(b[:, 4:16])
        if qtype == GGMLType.Q4_K:
            qs = b[:, 16:].reshape(nb, 4, 32)
            q = torch.stack([qs & 0xF, qs >> 4], dim=2).reshape(nb, 256)
        else:
            qh = b[:, 16:48]
            ql = b[:, 48:].reshape(nb, 4, 32)
            parts = []
            for c in range(4):
                parts.append((ql[:, c] & 0xF) | (((qh >> (2 * c)) & 1) << 4))
                parts.append((ql[:, c] >> 4) | (((qh >> (2 * c + 1)) & 1) << 4))
            q = torch.stack(parts, dim=1).reshape(nb, 256)
        return dict(q=q.reshape(N, K), d=_f16(b[:, 0:2], (N, K // 256)),
                    sc=sc6.reshape(N, K // 32),
                    dmin=_f16(b[:, 2:4], (N, K // 256)),
                    m=m6.reshape(N, K // 32))
    if qtype == GGMLType.Q6_K:
        b = buf.reshape(nb, ts)
        ql = b[:, 0:128].reshape(nb, 2, 2, 32)
        qh = b[:, 128:192].reshape(nb, 2, 32)
        q = torch.stack([(ql[:, :, 0] & 0xF) | (((qh >> 0) & 3) << 4),
                         (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4),
                         (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4),
                         (ql[:, :, 1] >> 4) | (((qh >> 6) & 3) << 4)], dim=2)
        return dict(q=q.reshape(N, K), d=_f16(b[:, 208:210], (N, K // 256)),
                    sc=b[:, 192:208].contiguous().view(torch.int8)
                    .reshape(N, K // 16))
    if qtype == GGMLType.Q2_K:
        b = buf.reshape(nb, ts)
        scb = b[:, 0:16]
        qs = b[:, 16:80].reshape(nb, 2, 1, 32)
        sh = torch.arange(0, 8, 2, device=buf.device, dtype=u8).reshape(1, 1, 4, 1)
        q = (qs >> sh) & 3
        return dict(q=q.reshape(N, K), d=_f16(b[:, 80:82], (N, K // 256)),
                    sc=(scb & 0xF).view(torch.int8).reshape(N, K // 16),
                    dmin=_f16(b[:, 82:84], (N, K // 256)),
                    m=(scb >> 4).reshape(N, K // 16))
    if qtype == GGMLType.Q3_K:
        b = buf.reshape(nb, ts)
        hmask = b[:, 0:32].reshape(nb, 1, 1, 32)
        qs = b[:, 32:96].reshape(nb, 2, 1, 32)
        scb = b[:, 96:108].to(torch.int32)
        sc6 = []
        for j in range(16):
            lo = (scb[:, j] & 0xF) if j < 8 else (scb[:, j - 8] >> 4)
            hi = (scb[:, 8 + j % 4] >> (2 * (j // 4))) & 3
            sc6.append((lo | (hi << 4)) - 32)
        sc6 = torch.stack(sc6, dim=1).to(torch.int8)
        dev = buf.device
        sh = torch.arange(0, 8, 2, device=dev, dtype=u8).reshape(1, 1, 4, 1)
        hsh = (4 * torch.arange(2, device=dev).reshape(1, 2, 1, 1)
               + torch.arange(4, device=dev).reshape(1, 1, 4, 1)).to(u8)
        # q3 = lo2 | (hbit << 2): value = q3 - 4 (the offset is in QConfig)
        q = ((qs >> sh) & 3) | (((hmask >> hsh) & 1) << 2)
        return dict(q=q.reshape(N, K), d=_f16(b[:, 108:110], (N, K // 256)),
                    sc=sc6.reshape(N, K // 16))
    if qtype == GGMLType.IQ4_XS:
        b = buf.reshape(nb, ts)
        scales_h = b[:, 2:4].contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        scales_l = b[:, 4:8].to(torch.int32)
        ib = torch.arange(8, device=buf.device)
        ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF) | (
            ((scales_h >> (2 * ib)) & 3) << 4)
        return dict(q=_nibbles(b[:, 8:].reshape(nb, 8, 16), 2).reshape(N, K),
                    d=_f16(b[:, 0:2], (N, K // 256)),
                    sc=(ls - 32).to(torch.int8).reshape(N, K // 32))
    raise NotImplementedError(f"pack: {qtype.name}")


def _pad_rows(a, N: int, n_align: int):
    if a is None:
        return None
    npad = (N + n_align - 1) // n_align * n_align
    a = a.contiguous()
    if npad == N:
        return a
    out = torch.zeros((npad,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[:N] = a
    return out


def pack_tensor(wire, qtype: GGMLType, shape: tuple[int, int],
                n_align: int = 128) -> QTensor:
    """Repack the wire bytes of a [N, K] weight (a uint8 tensor on any
    device, or a numpy array) into a wire-plane QTensor on the same
    device, rows zero-padded to a multiple of n_align; the planes are
    byte-equal to the JAX package's (q, qh uint8 or int8; d, dmin f32; sc
    and m in the dtypes its decode gives them).  The i-quants below 4 bits
    and the ternary types (QConfig.expand) need the expansion of the JAX
    package's quant/iquants, which the port does not have yet."""
    if shape[1] % 256:
        raise ValueError(f"K={shape[1]} must be a multiple of 256 (chunk size)")
    return _repack(wire, qtype, shape, n_align)


def _repack(wire, qtype: GGMLType, shape: tuple[int, int], n_align: int):
    """pack_tensor without its K % 256 check: any K of whole blocks (the
    dense dequant of GGUFReader.tensor_f32 takes such rows too)."""
    if not isinstance(wire, torch.Tensor):
        wire = torch.from_numpy(np.array(wire, np.uint8).reshape(-1))
    cfg = QCONFIGS[qtype]
    N, K = shape
    if wire.numel() != row_size(qtype, K) * N:
        raise ValueError(f"{qtype.name} {shape}: {wire.numel()} wire bytes")
    if cfg.expand:
        raise NotImplementedError(
            f"pack_tensor: {qtype.name} expands through quant/iquants "
            "(expand_to_planes), not ported yet (ROADMAP.md queue 1, item 7)")
    planes = _wire_to_planes(wire.reshape(-1).to(torch.uint8), qtype, N, K)
    q_int = planes["q"]
    qh = None
    if cfg.signed:
        q_lo = q_int.to(torch.int8)
    else:
        q_lo = _pack_bits(q_int & ((1 << cfg.bits_lo) - 1), cfg.bits_lo)
        if cfg.bits_hi:
            qh = _pack_bits((q_int >> cfg.bits_lo) & ((1 << cfg.bits_hi) - 1),
                            cfg.bits_hi)
    m = planes.get("m")
    if m is not None and cfg.asym == "min":
        m = m.to(torch.float32)

    def f32(a):
        return None if a is None else a.to(torch.float32)

    pad = lambda a: _pad_rows(a, N, n_align)
    return QTensor(cfg, N, K, q=pad(q_lo), d=pad(f32(planes["d"])), qh=pad(qh),
                   sc=pad(planes.get("sc")), dmin=pad(f32(planes.get("dmin"))),
                   m=pad(m))
