"""The exact kernel launches of one forward of a fused model, derived from
its layers.

`launch_table` walks a model's layers as models/llama.forward dispatches
them (the same predicates: supports_dual, supports_fused_epilogue,
_supports_moe_indirect, the K6 blocking's K split) and counts, under the
keys of kernels.LAUNCHES, the kernels a decode step, an 8-token prefill
bucket and a 512-token prefill chunk launch (the Engine's prefill takes
the head's logits on every row of a chunk), the gelu and relu branches and
K4 at a head width of 256 under their suffixed keys; beside them the
chunk's K6 GEMM launches under the keys of kernels.GEMM_LAUNCHES.  What it
reads of a layer
is the config, each tensor's type (its QConfig) and its plane layout, so a
model built on the meta device (no data) gives the tables of the full-size
one.  chip_smoke.py holds each configuration's serving run to them.
"""
from __future__ import annotations

from ..kernels import act_key, gemm_key
from ..ops.qmm_fast import (_family, _is_packed, _padded_rows, _pick_blocks,
                            supports_dual, supports_fused_epilogue)
from ..ops.qmm_qp8 import QP8_MAX_DECODE
from .llama import _supports_moe_indirect, qtensor_rows


class _Count:
    """One unit's launches: LAUNCHES keys and K6 GEMM keys."""

    def __init__(self, act: str):
        self.launches: dict = {}
        self.gemm: dict = {}
        self.act = act

    def add(self, table: dict, key: str, n: int = 1):
        table[key] = table.get(key, 0) + n

    def proj(self, qt, rows: int, mode: str):
        """One projection of `rows` rows on qt; mode raw, normed, res, act
        (act(gate) * up) or pre_il (the act product, interleaved)."""
        act = self.act if mode == "act" else ""
        coded = "_coded" if qt.cfg.code_map else ""
        if qt.fl == "t":
            kind = "qp8_gemv" if rows <= QP8_MAX_DECODE else "qp8_gemm"
            self.add(self.launches, act_key(kind + coded, act))
            return
        fam = "fast_" + _family(qt.cfg)
        if mode == "normed":
            # a blocking that splits K takes the norm apart (plain K6)
            _, nkj = _pick_blocks(_padded_rows(rows), qt.k,
                                  _is_packed(qt.cfg), qt.cfg.gs)
            if nkj > 1:
                mode = "raw"
        suffix = {"normed": "_normed", "res": "_res", "act": "_act"}
        self.add(self.launches, act_key(fam + suffix.get(mode, ""), act))
        if rows > QP8_MAX_DECODE:
            self.add(self.gemm, gemm_key(qt))

    def indirect(self, qt):
        """One gathered-expert GEMV over stacked planes (K5 or K8)."""
        if qt.fl == "t":
            self.add(self.launches, "qp8_indirect"
                     + ("_coded" if qt.cfg.code_map else ""))
        else:
            fam = _family(qt.cfg)
            self.add(self.launches, "fast_indirect"
                     + ("" if fam == "byte" else "_" + fam))


def _unit(cfg, weights, rows: int, step: bool, kv_bits: int) -> _Count:
    c = _Count(cfg.act)
    for il, lw in enumerate(weights["layers"]):
        nh, nhkv = cfg.nh(il), cfg.nhkv(il)
        use_fused = (step and cfg.rope_mode in ("neox", "none")
                     and nh % nhkv == 0 and cfg.hd % 128 == 0)
        if "wq" in lw:
            for w in ("wq", "wk", "wv"):
                c.proj(lw[w], rows, "raw")
        elif "wqkv" in lw:
            c.proj(lw["wqkv"], rows, "normed")
        elif (use_fused and rows <= QP8_MAX_DECODE
              and supports_dual(lw["wqk"], lw["wv"])):
            qa, qb = lw["wqk"], lw["wv"]
            coded = "_coded" if (qa.cfg.code_map or qb.cfg.code_map) else ""
            c.add(c.launches, ("qp8_dual" if qa.fl == "t" else "fast_dual")
                  + coded)
        else:
            c.proj(lw["wqk"], rows, "normed")
            c.proj(lw["wv"], rows, "normed")
        if use_fused:
            c.add(c.launches, ("decode_attn_q4" if kv_bits == 4
                               else "decode_attn")
                  + ("_d256" if cfg.hd == 256 else ""))
        ffp = "ffp" in lw
        if ffp and step:
            c.add(c.launches, act_key("ffn_fused_" + _family(
                lw["ffn_down"].cfg), cfg.act))
            continue
        if (step and not ffp and not cfg.post_norms
                and supports_fused_epilogue(lw["wo"])):
            c.proj(lw["wo"], rows, "res")
        else:
            c.proj(lw["wo"], rows, "raw")
        if "ffn_gate_inp" in lw:
            _moe(c, cfg, lw, rows)
        else:
            c.proj(lw["w_gateup_il"], rows, "normed")
            c.proj(lw["ffn_down"], rows,
                   "act" if not ffp and rows <= QP8_MAX_DECODE else "pre_il")
    c.proj(weights["output"], rows, "raw")
    return c


def _moe(c: _Count, cfg, lw, rows: int):
    """The MoE FFN: the gathered GEMVs (K5 or K8) a stack at <= 8 rows,
    else every expert's gate, up and down (and the shared experts)."""
    stacks = ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
    if rows <= QP8_MAX_DECODE and _supports_moe_indirect(cfg, lw):
        for key in stacks:
            c.indirect(lw[key])
    else:
        n_ff, d = cfg.n_ff_exp or cfg.n_ff, cfg.n_embd
        for e in range(cfg.n_expert):
            for key, n in zip(stacks, (n_ff, n_ff, d)):
                c.proj(qtensor_rows(lw[key], e * n, n), rows, "raw")
    for key in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp",
                "ffn_gate_inp_shexp"):
        if key in lw:
            c.proj(lw[key], rows, "raw")


def launch_table(cfg, weights, kv_bits: int = 16) -> dict:
    """{"step", "bucket8", "chunk": LAUNCHES counts of one forward of that
    unit (the decode step at one row, kv_bits the cache's: 4 counts K4
    under decode_attn_q4), "gemm": the chunk's K6 GEMM launches
    (GEMM_LAUNCHES keys)} of a fused model (cfg, weights), every count
    non-zero."""
    out = {}
    for unit, rows in (("step", 1), ("bucket8", 8), ("chunk", 512)):
        c = _unit(cfg, weights, rows, unit == "step", kv_bits)
        out[unit] = c.launches
        if unit == "chunk":
            out["gemm"] = c.gemm
    return out
