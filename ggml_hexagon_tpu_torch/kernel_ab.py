"""In-call A/B of the port's kernels against an earlier tree's sources, on
one card, in the order parent, change, change, parent.

    for f in fast_il.cu il_gemv.cuh act.cuh; do
      git show 9c55e72:ggml_hexagon_tpu_torch/csrc/$f > DIR/$f; done
    git show 3b0f551:ggml_hexagon_tpu_torch/csrc/qp8_gemm.cu > DIR/qp8_gemm.cu
    git show 3b0f551:ggml_hexagon_tpu_torch/csrc/decode_attn.cu > DIR/decode_attn.cu
    git show c8a736e:ggml_hexagon_tpu_torch/csrc/qp8_gemv.cu > DIR/qp8_gemv.cu
    git show 3d188dc:ggml_hexagon_tpu_torch/csrc/qmm_wire.cu > DIR/qmm_wire.cu
    git show e176e56:ggml_hexagon_tpu_torch/csrc/attention.cu > DIR/attention.cu
    git show 1c6f8f0:ggml_hexagon_tpu_torch/csrc/ffn_fused.cu > DIR/ffn_fused.cu
    python3 -m ggml_hexagon_tpu_torch.kernel_ab --parent DIR

Each part runs when DIR holds its parent source; the parents are built
with this tree's nvcc flags and headers.

  fast_il.cu (9c55e72, the last tree whose K6 built a block's activation
      through one of three whole template instances, one an act; its
      il_gemv.cuh and act.cuh beside it, since a parent builds against the
      headers of its own directory first; a parent's fast_il_run must take
      the act id): K6 in the act mode's gelu on Gemma-2-9B's down shapes
      (Q4_K nibble and Q6_K byte planes, 3584 x 14336, no residual, B = 1
      and 8); and K6 on the launch mixes of the
      decode steps of Llama-3-8B IQ4_XS (byte planes: normed, res, act), Q4_K_M
      il (nibble planes normed, res, act; Q6_K byte planes with the derived
      bias, act and the head) and IQ3_XXS il (coded planes: normed, res,
      act), and of Mixtral-8x7B Q4_K_M il (nibble wq, Q5_K wo with a stored
      bias, res) and IQ3_XXS il (coded wq); K6 on the 8-token prefill
      bucket's mixes (B = 8) of Llama-3-8B Q4_K_M il and IQ4_XS; K8 at P = 2
      on the Mixtral-8x7B IQ4_XS (byte), Q4_K_M il (nibble, and Q6_K byte
      with the derived bias) and IQ3_XXS il (coded) steps (one random expert
      stack a type, launches counted per layer type).  Then the floor for
      identical code:
      K6 nibble res and plain at 4096 x 4096, B = 1, through a second build
      of each source (P, C, P2, C2 in rotation), the two builds run one
      after the other and timed: nvcc's wall seconds and the sum of
      ptxas's compile times over the kernels.
  qp8_gemv.cu (c8a736e, the last tree whose K1, K2 and K5 ran a
      one-block activation pre-pass, a GEMV reading the planes with 4-byte
      loads and a finalize pass for K splits, three launches a call):
      K1 on the launch mix of a Llama-3-8B Q4_K_M decode step (B = 1) and
      of its 8-token prefill bucket (B = 8), K2 on that step's mixed-type
      QKV, K1 coded and K2 coded on a Llama-3-8B IQ3_XXS step, K5 on a
      Mixtral-8x7B Q5_K_M step and K5 coded on a Mixtral-8x7B IQ3_XXS step
      (P = 2, one random expert stack a type, launches counted per layer
      type), each unit also summed.
  qp8_gemm.cu and decode_attn.cu (3b0f551, the last tree before K3 and K4
      were redesigned): every K3 launch of the Llama-3-8B Q4_K_M prefill
      chunk at M = 512, 128 and 32, the coded launches of Llama-3-8B
      IQ3_XXS at M = 512, one Mixtral-8x7B expert's lane slice of stacked
      Q5_K / Q6_K planes at M = 128 and 512; K4 at pos 0, 1, 700 and 1023,
      bf16 and int8 caches, B = 1 and 4.
  qmm_wire.cu (3d188dc, the last tree whose K10 ran one WMMA block a 64 x
      64 output tile above 8 rows and in f32, and whose bf16 GEMV at B <= 8
      is this tree's): K10 on the Llama-3-8B wq, gate and down (Q4_K, Q4_K,
      Q6_K) at B = 512 (the b512 unit), one type of each of the 12 plane
      families at 4096 x 4096 and B = 512, the wq in f32 at B = 8 and 512
      (against the WMMA kernel), and, level, the 8B's wq, gate, down and
      head at B = 1 and 8 (the bf16 GEMV against the parent's GEMV).
  attention.cu (e176e56, the last tree whose K12 ran a kernel and a merge
      kernel, its partials in device memory): K12 at the decode step at pos
      700 (B=1, Hkv=8, G=4, S=1024, bf16 cache) and at pos 8191 of an
      8192-slot cache; and, level, K11 at the conformance prefill (B=1,
      H=32, T=512, S=1024, D=128, a causal [1,1,T,S] mask with a dead tail),
      f32 and bf16.
  ffn_fused.cu (1c6f8f0, the last tree whose K9 ran one warp a weight row
      between three grid barriers, a template instance a row count): K9 on
      a Llama-3-8B Q4_K_M il ffn layer (d = 4096, n_ff = 14336) with its
      Q4_K down and with its Q6_K down, at B = 1 and 8, the parent called
      through its own C entry with its scratch; beside each row, in the
      same process, the split path's three K6 launches on the same planes
      un-permuted (wo residual mode, gate_up normed, down act mode, as
      chip_smoke.k9_row times them), the unit's yardstick.

Times are device times of a CUDA-graph replay after an L2 flush (median
of iterations), as chip_smoke.py takes them (K1/K2/K5, K6 and K8 rows also
the host microseconds a wrapper call takes to enqueue); each row also
prints the bf16 `torch.matmul` (weight dequantized beforehand), `torch.bmm`
(K5, K8: the selected experts dequantized beforehand), SDPA (K4, bf16) or
the split path (K9) yardstick and the bound, and each unit its sums (K10: `torch.matmul` on the
weight dequantized beforehand, bf16, or f32 for f32 compute; K11 and K12:
SDPA in the inputs' type).
Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import kernels
from .models.llama import qtensor_rows
from .models.llama import LlamaConfig
from .models.synth import (GEMMA2_9B, MIXTRAL_8X7B, _policy, build_8b, build_8b_il,
                           build_8b_iq3xxs, build_8b_iq4xs, random_qtensor)
from .ops import decode_attn as PD
from .ops import attention as PA
from .ops import qmatmul as PQ
from .ops import qmm_fast as PF
from .ops import qmm_qp8 as P
from .ops.basic import rope_freqs
from .quant.formats import GGMLType

HBM_BPS = 3.35e12
BF16_OPS = 989e12    # K3, K4, K6/K8 and K10 (bf16 mma at every B)
F32_OPS = 67e12      # K10's f32 GEMV (f32 FMAs)
TF32_OPS = 495e12    # K11 and K10's f32 GEMM: TF32 mma, times its products
                     # a multiply-add
NMSE_F32 = 1e-10     # K10 in f32 against its plain twin (chip_smoke.py's
                     # NMSE_K10_F32)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the parents' C entries: K3 and K4 of 3b0f551; K6 and K8 bind as this
#: tree's (K6's with the act id after `mode`, so a K6 parent must be a tree
#: that has it)
_PARENT_ARGS = {
    "qp8_gemm_run": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _I] + [_P] * 3,
    "decode_attn_run": [_P] * 7 + [_I] * 5 + [_F, _I, _F, _I] + [_P] * 4,
    "fast_il_run": kernels._ARGTYPES["fast_il_run"],
    "fast_indirect_run": kernels._ARGTYPES["fast_indirect_run"],
    # c8a736e's K1/K2 and K5: the pre-pass scratch x8, xs and the partials
    # of its K splits
    "qp8_gemv_run": [_P, _P, _I, _F, _I, _I] + [_P, _P, _P] + [_I] * 5
    + [_F, _I] + [_P, _P, _P] + [_I] * 5 + [_F, _I]
    + [_P, _P, _P, _I, _P, _P, _I, _P],
    "qp8_indirect_run": [_P, _I, _I, _P, _I, _I, _P, _P, _P] + [_I] * 4
    + [_F, _I, _P, _P, _P, _I, _P, _P],
    # the WMMA K10 of 3d188dc (above 8 rows and in f32)
    "qmm_wire_run": [_I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                     _P, _P],
    # 3d188dc's bf16 GEMV at B <= 8 (no compute-type argument)
    "qmm_wire_gemv_run": [_I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                          _I, _I, _I, _P, _P, _P, _P],
    # K11 of e176e56: this tree's C entry; its K12 with the partials
    # scratch of its merge kernel
    "flash_attn_run": kernels._ARGTYPES["flash_attn_run"],
    "decode_attn_gqa_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F,
                            _I, _P, _P, _P],
    # K9 of 1c6f8f0 (its scratch h2, gu, xd and the down bias's sums xsg)
    "ffn_fused_run": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I] + [_P] * 9
    + [_I, _I, _F, _P, _P, _P, _P, _P, _P],
}
_PARENT_FNS = {"qp8_gemm": ["qp8_gemm_run"], "decode_attn": ["decode_attn_run"],
               "fast_il": ["fast_il_run", "fast_indirect_run"],
               "qp8_gemv": ["qp8_gemv_run", "qp8_indirect_run"],
               "qmm_wire": ["qmm_wire_run", "qmm_wire_gemv_run"],
               "attention": ["flash_attn_run", "decode_attn_gqa_run"],
               "ffn_fused": ["ffn_fused_run"]}
_FLUSH = None


def _time_ms(fn, iters=10):
    """Device ms of fn: one CUDA-graph capture, replays after an L2 flush,
    the median of CUDA-event times."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _host_us(fn, calls=100):
    """Host microseconds a call of fn takes to enqueue its work (the
    wrapper, its allocations and launches; no synchronisation inside the
    timed calls), the median of three runs."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(runs))


def _build_parent(directory: str) -> dict:
    """The parent sources found in `directory`, built in parallel and
    loaded: C entry name -> function (the library as `lib:<name>`)."""
    fns = {}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in _PARENT_FNS:
        src = f"{directory}/{name}.cu"
        if os.path.exists(src):
            out = kernels.BUILD_DIR / f"parent_{name}.so"
            procs[name] = (out, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                 "-o", str(out), src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.ght_error_string.argtypes = [ctypes.c_int]
        lib.ght_error_string.restype = ctypes.c_char_p
        for entry in _PARENT_FNS[name]:
            if not hasattr(lib, entry):
                raise RuntimeError(f"the parent {name}.cu has no {entry}: "
                                   "not the tree this part is held against")
            fn = getattr(lib, entry)
            fn.argtypes = _PARENT_ARGS[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        fns[f"lib:{name}"] = lib
    return fns


def _parent_ksb(ncols: int, qts) -> int:
    """c8a736e's K splits of K1/K2/K5 (kernels._pick_ksb there)."""
    blocks = ncols // 128
    chunks = []
    for qt in qts:
        bl, bh = P._pack_bits(qt.cfg)
        chunks.append(qt.k * (bh or bl) // 8 // qt.cfg.gs)
    return max(1, min(-(-264 // blocks), min(chunks) // 8))


def _nmse(got, want):
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def k12_sdpa(qg, kc, vc, pos: int, swa: int, scale: float):
    """K12's one-call PyTorch yardstick on a row at position pos (B = 1):
    SDPA on bf16 q and the live slice of the cache, the G query heads of a
    KV head as enable_gqa groups them; chip_smoke.py and kernel_ab time
    this same call on their inputs."""
    B, Hkv, G, _, D = qg.shape
    lo = max(0, pos - swa + 1) if swa else 0
    q4 = qg.reshape(B, Hkv * G, 1, D).to(torch.bfloat16)
    k4, v4 = (c[:, lo:pos + 1].transpose(1, 2) for c in (kc, vc))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, scale=scale, enable_gqa=True)


class AB:
    def __init__(self, parent_dir: str, dev):
        self.dev = dev
        self.parent_dir = parent_dir
        self.par = _build_parent(parent_dir)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(1234)
        self.units: dict = {}

    def _as_parent(self, fn, name="fast_il"):
        """fn() with this tree's library `name` swapped for the parent's,
        whose entries fn reaches keep their C signatures (K6's and K8's;
        K11's)."""
        mine = kernels._LIBS[name]
        kernels._LIBS[name] = self.par[f"lib:{name}"]
        try:
            return fn()
        finally:
            kernels._LIBS[name] = mine

    def parent_k12(self, qg, kc, vc, pos, scale):
        """e176e56's K12 (a kernel over the splits, their partials in
        device memory, and a merge kernel), its splits _pick_nsplit's at
        its 64 slots a split."""
        B, Hkv, G, _, D = qg.shape
        S = kc.shape[1]
        ns = kernels._pick_nsplit(B * Hkv, S, min_slots=64)
        dev = self.dev
        part = torch.empty((B, Hkv, ns, G, D + 2), dtype=torch.float32,
                           device=dev)
        out = torch.empty((B, Hkv, G, 1, D), dtype=torch.float32, device=dev)
        rc = self.par["decode_attn_gqa_run"](
            qg.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(), B,
            Hkv, G, S, ns, float(scale), 0, 0.0,
            int(kc.dtype == torch.bfloat16), part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent decode_attn_gqa_run: CUDA error {rc}")
        return out

    def parent_k9(self, x_a, xg_a, h_il, wn, wo, gu, dn, eps):
        """1c6f8f0's K9 (one warp a weight row, three grid barriers) on the
        arguments kernels.ffn_fused takes, with its scratch."""
        B, d = x_a.shape
        n_ff, dev = dn.k, self.dev
        _, G, _, _, _ = kernels._il_plane_args(wo)
        _, Gc, _, off, cm = kernels._il_plane_args(dn)
        bias = dn.fb is not None or off != 0.0
        h2 = torch.empty((B, d), dtype=torch.float32, device=dev)
        gus = torch.empty((B, 2 * n_ff), dtype=torch.float32, device=dev)
        xd = torch.empty((B, n_ff), dtype=torch.bfloat16, device=dev)
        xsg = (torch.empty((B, Gc), dtype=torch.float32, device=dev) if bias
               else None)
        out = torch.empty((B, d), dtype=torch.float32, device=dev)
        p = kernels._ptr
        rc = self.par["ffn_fused_run"](
            p(x_a), p(xg_a), p(h_il), p(wn), float(eps), B, d, n_ff, G, Gc,
            p(wo.fq), p(wo.fs), p(wo.fb), p(gu.fq), p(gu.fs), p(gu.fb),
            p(dn.fq), p(dn.fs), p(dn.fb), kernels._FAMILY_ID[PF._family(dn.cfg)],
            cm, off, p(h2), p(gus), p(xd), p(xsg), p(out),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent ffn_fused_run: CUDA error {rc}")
        return out

    def k9(self, unit, cfg, lw, B, count):
        """One K9 row on a layer of the 8B Q4_K_M il ffn model, P C C P
        against 1c6f8f0's K9, beside the split path's three K6 launches on
        the same planes un-permuted (the unit's yardstick), and its bound
        (the three plane sets and the inputs read once, the output written
        once; the products and bias dots at the bf16 peak)."""
        from .ops import ffn_fused as PFF

        dev, gen = self.dev, self.gen
        d, wo, gu, wn, dn = (cfg.n_embd, lw["wo"], lw["w_gateup_il"],
                             lw["ffn_norm_il"], lw["ffn_down"])
        G, gs, n_ff = wo.fs.shape[1], wo.cfg.gs, dn.k
        attn = torch.randn(B, d, generator=gen, device=dev).to(torch.bfloat16).float()
        h = torch.randn(B, d, generator=gen, device=dev).to(torch.bfloat16).float()
        x_a = PF._interleave_x(attn, G, gs).to(torch.bfloat16).contiguous()
        xg_a = PF._sums_natural(attn, G).contiguous()
        h_il = PF._interleave_x(h, G, gs).contiguous()
        args = (x_a, xg_a, h_il, wn, wo, gu, dn, cfg.rms_eps)
        new = lambda: kernels.ffn_fused(*args)  # noqa: E731
        old = lambda: self.parent_k9(*args)  # noqa: E731
        want = PFF.ffn_fused_plain(*args)
        got = new()
        e_new, e_old = _nmse(got, want), _nmse(old(), want)
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        # the split path: the same rows of the same planes, un-permuted
        inv = torch.argsort(PF.interleave_perm(d, 32))
        wo_n, dn_n = wo.take_rows(inv), dn.take_rows(inv)
        k6_wo, k6_gu, k6_dn = (PF._k6(q, False) for q in (wo_n, gu, dn_n))
        x = attn.to(torch.bfloat16)
        h1 = k6_wo(x, wo_n, res=h)
        gu2 = k6_gu(h1.to(torch.bfloat16), gu, wn=wn, eps=cfg.rms_eps)
        x1, x2 = h1.to(torch.bfloat16), gu2.to(torch.bfloat16)
        xg = PF.group_sums(dn_n, gu2, "act")
        split = _time_ms(lambda: (k6_wo(x, wo_n, res=h),
                                  k6_gu(x1, gu, wn=wn, eps=cfg.rms_eps),
                                  k6_dn(x2, dn_n, act="silu", res=h1, xg=xg)))
        byts = sum(t_.numel() * t_.element_size() for q in (wo, gu, dn)
                   for t_ in (q.fq, q.fs, q.fb) if t_ is not None)
        byts += sum(t_.numel() * t_.element_size() for t_ in (x_a, xg_a, h_il, wn, got))
        ops = sum(2 * B * q.k * q.fq.shape[0]
                  + (2 * B * q.fs.shape[1] * q.fq.shape[0]
                     if PF._needs_xg(q.cfg, q.fb) else 0) for q in (wo, gu, dn))
        bound = max(byts / HBM_BPS, ops / BF16_OPS) * 1e3
        Kd, Gc = dn.k, dn.fs.shape[1]
        plan = kernels.pick_ffn(d, G, n_ff, Kd, Gc, PF._is_packed(dn.cfg),
                                dn.fb is not None, PF._needs_xg(dn.cfg, dn.fb), B,
                                torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"K9 {unit} B={B} down {dn.cfg.qtype.name} {plan} nmse={e_new:.2e} "
              f"(parent {e_old:.2e}) P={t[0]:.4f} C={t[1]:.4f} C={t[2]:.4f} "
              f"P={t[3]:.4f} ms split={split:.4f} bound={bound:.4f} x{count} "
              f"host us/call P={_host_us(old):.1f} C={_host_us(new):.1f}",
              flush=True)
        self._unit(unit, count, t, split, bound)
        return e_new

    def _unit(self, unit, count, t, lib, bound):
        u = self.units.setdefault(unit, [0.0, 0.0, 0.0, 0.0, 0])
        u[0] += count * (t[0] + t[3]) / 2
        u[1] += count * (t[1] + t[2]) / 2
        u[2] += count * lib
        u[3] += count * bound
        u[4] += count

    def k6(self, unit, name, qt, mode, B, count):
        """One K6 row at B <= 8 (mode plain, pre_il, normed, res, act: silu
        with a residual, act_gelu / act_relu: that act without one) on the
        group sums the entry would hand it; its P C C P times join the
        unit's sums count times."""
        K, dev, gen = qt.k, self.dev, self.gen
        act = mode[4:] if mode.startswith("act_") else "silu"
        mode = "act" if mode.startswith("act") else mode
        x = torch.randn(B, 2 * K if mode == "act" else K, generator=gen,
                        device=dev).to(torch.bfloat16)
        kw = {}
        if mode == "normed":
            kw = dict(wn=torch.rand(K, device=dev, generator=gen) + 0.5,
                      eps=1e-5)
        elif mode == "res" or (mode == "act" and act == "silu"):
            kw = dict(res=torch.randn(B, qt.n, generator=gen, device=dev))
        elif mode == "pre_il":
            kw = dict(pre_il=True)
        if mode == "act":
            kw["act"] = act
        _, nkj = PF._pick_blocks(PF._padded_rows(B), K, PF._is_packed(qt.cfg),
                                 qt.cfg.gs)
        kw["xg"] = PF.group_sums(qt, x, mode, kw.get("wn"), nkj, act)
        kern = PF._k6(qt, False)
        new = lambda: kern(x, qt, **kw)  # noqa: E731
        old = lambda: self._as_parent(new)  # noqa: E731
        want = PF._k6(qt, True)(x, qt, **kw)
        got = new()
        e_new, e_old = _nmse(got, want), _nmse(old(), want)
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        deq = PF.dequantize_fast(qt, torch.bfloat16).t().contiguous()
        xl = x[:, :K]
        lib = _time_ms(lambda: torch.matmul(xl, deq))
        del deq
        n2 = qt.fq.shape[0]
        ops = 2 * B * K * n2
        byts = sum(t_.numel() * t_.element_size() for t_ in
                   (qt.fq, qt.fs, qt.fb, x, got, kw.get("wn"), kw.get("res"),
                    kw["xg"]) if t_ is not None)
        bound = max(byts / HBM_BPS, ops / BF16_OPS) * 1e3
        plan = kernels._il_plan(qt, B, n2 // kernels.IL_ROWS, 1,
                                2 if mode == "act" else 1 if mode == "normed"
                                else 0, dev)
        print(f"K6 {unit} {mode} {act if mode == 'act' else ''} {name} "
              f"{qt.cfg.qtype.name} {qt.n}x{K} B={B} "
              f"{PF._family(qt.cfg)} {plan} nmse={e_new:.2e} (parent "
              f"{e_old:.2e}) P={t[0]:.4f} C={t[1]:.4f} C={t[2]:.4f} "
              f"P={t[3]:.4f} ms matmul={lib:.4f} bound={bound:.4f} x{count} "
              f"host us/call P={_host_us(old):.1f} C={_host_us(new):.1f}",
              flush=True)
        self._unit(unit, count, t, lib, bound)
        return e_new

    def k8(self, unit, name, stack, npe, count):
        """One K8 row at P=2 (ids 5, 2), P C C P, against the bf16 bmm on
        the two experts dequantized beforehand."""
        dev, gen = self.dev, self.gen
        ids = torch.tensor([5, 2], dtype=torch.int32, device=dev)
        x = torch.randn(2, stack.k, generator=gen, device=dev).to(torch.bfloat16)
        xg = (PF._sums_natural(x, stack.fs.shape[1])
              if PF._needs_xg(stack.cfg, stack.fb) else None)
        new = lambda: PF.fast_indirect(x, stack, ids, npe, xg)  # noqa: E731
        old = lambda: self._as_parent(new)  # noqa: E731
        want = PF.fast_indirect_plain(x, stack, ids, npe, xg)
        got = new()
        e_new, e_old = _nmse(got, want), _nmse(old(), want)
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        wsel = torch.stack([PF.dequantize_fast(qtensor_rows(stack, e * npe, npe),
                                               torch.bfloat16).t()
                            for e in (5, 2)]).contiguous()
        xb = x[:, None, :]
        lib = _time_ms(lambda: torch.bmm(xb, wsel))
        del wsel
        one = qtensor_rows(stack, 0, npe)
        byts = 2 * sum(t_.numel() * t_.element_size()
                       for t_ in (one.fq, one.fs, one.fb) if t_ is not None)
        byts += sum(t_.numel() * t_.element_size()
                    for t_ in (x, got, ids, xg) if t_ is not None)
        bound = byts / HBM_BPS * 1e3
        plan = kernels._il_plan(stack, 1, npe // kernels.IL_ROWS, 2, 0, dev)
        print(f"K8 {unit} {name} {stack.cfg.qtype.name} {npe}x{stack.k} P=2 "
              f"{plan} nmse={e_new:.2e} (parent {e_old:.2e}) P={t[0]:.4f} "
              f"C={t[1]:.4f} C={t[2]:.4f} P={t[3]:.4f} ms bmm={lib:.4f} "
              f"bound={bound:.4f} x{count} host us/call "
              f"P={_host_us(old):.1f} C={_host_us(new):.1f}", flush=True)
        self._unit(unit, count, t, lib, bound)
        return e_new

    def parent_gemm(self, x, qt):
        fq, fs, fb, n2, ld, bl, bh, gs, off, cm = kernels._plane_args(qt)
        M, K = x.shape
        xg = torch.empty((M, K // gs), dtype=torch.float32, device=self.dev)
        out = torch.empty((M, n2), dtype=torch.float32, device=self.dev)
        rc = self.par["qp8_gemm_run"](
            x.data_ptr(), fq, fs, fb, n2, ld, bl, bh, gs, off, cm, M, K,
            xg.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent qp8_gemm_run: CUDA error {rc}")
        return out

    def parent_attn(self, qkv, kc, vc, pos, cs, *, Hq, Hkv, D, scale,
                    k_scale=None, v_scale=None):
        B, S = kc.shape[:2]
        dev = self.dev
        out = torch.empty((B, Hq * D), device=dev)
        k_r = torch.empty((B, Hkv * D), device=dev)
        v_r = torch.empty((B, Hkv * D), device=dev)
        rc = self.par["decode_attn_run"](
            qkv.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            kernels._ptr(k_scale), kernels._ptr(v_scale), pos.data_ptr(),
            cs.data_ptr(), B, Hq, Hkv, S, D, float(scale), 0, 0.0,
            int(k_scale is not None), out.data_ptr(), k_r.data_ptr(),
            v_r.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent decode_attn_run: CUDA error {rc}")
        return out, k_r, v_r

    def k3(self, unit, name, qt, count, M=512):
        """One K3 row; its P C C P times join the unit's sums count times."""
        x = torch.randn(M, qt.k, generator=self.gen,
                        device=self.dev).to(torch.bfloat16)
        want = P.qp8_gemm_plain(x, qt)
        e_new = _nmse(P.qp8_gemm(x, qt), want)
        e_old = _nmse(self.parent_gemm(x, qt), want)
        new = lambda: P.qp8_gemm(x, qt)  # noqa: E731
        old = lambda: self.parent_gemm(x, qt)  # noqa: E731
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        deq = P.dequantize_qp8(qt, torch.bfloat16).t().contiguous()
        lib = _time_ms(lambda: torch.matmul(x, deq))
        del deq
        n2 = qt.fq.shape[1]
        ops = 2 * M * qt.k * n2
        byts = sum(t_.numel() * t_.element_size()
                   for t_ in (qt.fq, qt.fs, qt.fb, x) if t_ is not None)
        byts += M * n2 * 4
        bound = max(byts / HBM_BPS, ops / BF16_OPS) * 1e3
        print(f"K3 {unit} {name} {qt.cfg.qtype.name} {qt.n}x{qt.k} M={M} "
              f"splits={kernels._gemm_splits(M, n2, qt.k, self.dev)} "
              f"nmse={e_new:.2e} (parent {e_old:.2e}) P={t[0]:.4f} "
              f"C={t[1]:.4f} C={t[2]:.4f} P={t[3]:.4f} ms matmul={lib:.4f} "
              f"bound={bound:.4f} x{count}", flush=True)
        self._unit(unit, count, t, lib, bound)
        return e_new

    def parent_gemv(self, x, qts, wn=None, eps=None, act="", res=None):
        """c8a736e's K1 (one plane set) or K2 (two) on the arguments
        kernels._gemv_launch would pass, with its scratch."""
        B, K = x.shape[0], qts[0].k
        mode = 2 if act else 1 if eps is not None else 0
        a = kernels._plane_args(qts[0])
        b = (kernels._plane_args(qts[1]) if len(qts) > 1
             else [None, None, None, 0, 0, 0, 0, 0, 0.0, 0])
        ncols = a[3] + b[3]
        ksb = _parent_ksb(ncols, qts)
        dev = self.dev
        x8 = torch.empty((B, K), dtype=torch.int8, device=dev)
        xs = torch.empty((B, K // 256), dtype=torch.float32, device=dev)
        out = torch.empty((B, ncols), dtype=torch.float32, device=dev)
        ws = (torch.empty((ksb, B, ncols), dtype=torch.float32, device=dev)
              if ksb > 1 else None)
        rc = self.par["qp8_gemv_run"](
            x.data_ptr(), kernels._ptr(wn), mode,
            0.0 if eps is None else float(eps), B, K, *a, *b, x8.data_ptr(),
            xs.data_ptr(), kernels._ptr(ws), ksb, out.data_ptr(),
            kernels._ptr(res), 0 if res is None else res.shape[1],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent qp8_gemv_run: CUDA error {rc}")
        return out

    def parent_indirect(self, x, qt, ids, npe):
        """c8a736e's K5 with its scratch."""
        fq, fs, fb, n2, ld, bl, bh, gs, off, cm = kernels._plane_args(qt)
        Pn, K = x.shape
        ksb = _parent_ksb(Pn * npe, [qt])
        dev = self.dev
        x8 = torch.empty((Pn, K), dtype=torch.int8, device=dev)
        xs = torch.empty((Pn, K // 256), dtype=torch.float32, device=dev)
        out = torch.empty((Pn, npe), dtype=torch.float32, device=dev)
        ws = (torch.empty((ksb, Pn, npe), dtype=torch.float32, device=dev)
              if ksb > 1 else None)
        rc = self.par["qp8_indirect_run"](
            x.data_ptr(), Pn, K, ids.data_ptr(), npe, n2 // npe, fq, fs, fb,
            ld, bl, bh, gs, off, cm, x8.data_ptr(), xs.data_ptr(),
            kernels._ptr(ws), ksb, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent qp8_indirect_run: CUDA error {rc}")
        return out

    def gemv(self, unit, name, qts, mode, B, count):
        """One K1 (one plane set; mode raw, normed, res, or act with a
        residual) or K2 row (two plane sets, normed), P C C P, against the
        bf16 matmul on the weights dequantized beforehand."""
        K, dev, gen = qts[0].k, self.dev, self.gen
        x = torch.randn(B, 2 * K if mode == "act" else K, generator=gen,
                        device=dev)
        kw = {}
        if mode == "normed":
            kw = dict(wn=torch.rand(K, device=dev, generator=gen) + 0.5,
                      eps=1e-5)
        elif mode in ("res", "act"):
            kw = dict(res=torch.randn(B, qts[0].n, generator=gen, device=dev))
            if mode == "act":
                kw["act"] = "silu"
        if len(qts) == 2:
            new = lambda: P.qp8_dual(x, *qts, **kw)  # noqa: E731
            want = P.qp8_dual_plain(x, *qts, **kw)
        else:
            new = lambda: P.qp8_gemv(x, qts[0], **kw)  # noqa: E731
            want = P.qp8_gemv_plain(x, qts[0], **kw)
        old = lambda: self.parent_gemv(x, qts, **kw)  # noqa: E731
        got = new()
        e_new, e_old = _nmse(got, want), _nmse(old(), want)
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        deq = torch.cat([P.dequantize_qp8(q, torch.bfloat16).t() for q in qts],
                        1).contiguous()
        xl = x[:, :K].to(torch.bfloat16)
        lib = _time_ms(lambda: torch.matmul(xl, deq))
        del deq
        byts = sum(t_.numel() * t_.element_size() for q in qts
                   for t_ in (q.fq, q.fs, q.fb) if t_ is not None)
        byts += sum(t_.numel() * t_.element_size() for t_ in
                    (x, got, kw.get("wn"), kw.get("res")) if t_ is not None)
        bound = byts / HBM_BPS * 1e3
        plan = kernels._gemv_plan(qts, [q.fq.shape[1] for q in qts], B, 1, dev)
        what = "K2" if len(qts) == 2 else "K1"
        print(f"{what} {unit} {mode} {name} "
              f"{'+'.join(q.cfg.qtype.name for q in qts)} "
              f"{'+'.join(str(q.n) for q in qts)}x{K} B={B} {plan} "
              f"nmse={e_new:.2e} (parent {e_old:.2e}) P={t[0]:.4f} "
              f"C={t[1]:.4f} C={t[2]:.4f} P={t[3]:.4f} ms matmul={lib:.4f} "
              f"bound={bound:.4f} x{count} host us/call "
              f"P={_host_us(old):.1f} C={_host_us(new):.1f}", flush=True)
        self._unit(unit, count, t, lib, bound)
        return e_new

    def k5(self, unit, name, stack, npe, count):
        """One K5 row at P=2 (ids 5, 2), P C C P, against the bf16 bmm on
        the two experts dequantized beforehand."""
        dev, gen = self.dev, self.gen
        ids = torch.tensor([5, 2], dtype=torch.int32, device=dev)
        x = torch.randn(2, stack.k, generator=gen, device=dev)
        new = lambda: P.qp8_indirect(x, stack, ids, npe)  # noqa: E731
        old = lambda: self.parent_indirect(x, stack, ids, npe)  # noqa: E731
        want = P.qp8_indirect_plain(x, stack, ids, npe)
        got = new()
        e_new, e_old = _nmse(got, want), _nmse(old(), want)
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        wsel = torch.stack([P.dequantize_qp8(qtensor_rows(stack, e * npe, npe),
                                             torch.bfloat16).t()
                            for e in (5, 2)]).contiguous()
        xb = x.to(torch.bfloat16)[:, None, :]
        lib = _time_ms(lambda: torch.bmm(xb, wsel))
        del wsel
        one = qtensor_rows(stack, 0, npe)
        byts = 2 * sum(t_.numel() * t_.element_size()
                       for t_ in (one.fq, one.fs, one.fb) if t_ is not None)
        byts += (x.numel() + got.numel()) * 4 + ids.numel() * 4
        bound = byts / HBM_BPS * 1e3
        plan = kernels._gemv_plan([stack], [npe], 1, 2, dev)
        print(f"K5 {unit} {name} {stack.cfg.qtype.name} {npe}x{stack.k} P=2 "
              f"{plan} nmse={e_new:.2e} (parent {e_old:.2e}) P={t[0]:.4f} "
              f"C={t[1]:.4f} C={t[2]:.4f} P={t[3]:.4f} ms bmm={lib:.4f} "
              f"bound={bound:.4f} x{count} host us/call "
              f"P={_host_us(old):.1f} C={_host_us(new):.1f}", flush=True)
        self._unit(unit, count, t, lib, bound)
        return e_new

    def parent_wire(self, x, qt, planes, cd):
        """The parent's K10 on the arguments kernels.qmm_wire takes: its
        bf16 GEMV at B <= 8, else its WMMA kernel (one block a 64 x 64
        output tile)."""
        q = planes[0]
        B, n_pad = x.shape[0], q.shape[0]
        out = torch.empty((B, n_pad), dtype=torch.float32, device=self.dev)
        cfg = qt.cfg
        args = [kernels.wire_family(cfg)]
        tail = [x.data_ptr(), B, qt.k, *[kernels._ptr(t) for t in planes],
                n_pad, cfg.gs, float(cfg.offset)]
        stream = torch.cuda.current_stream().cuda_stream
        if cd == torch.bfloat16 and B <= kernels.WIRE_GEMV_ROWS:
            plan = kernels.pick_wire_gemv(
                qt.k, cfg.bits_lo, cfg.bits_hi, cfg.superblock, cfg.asym,
                cfg.gs, n_pad // kernels.WIRE_ROWS, B,
                kernels._sm_count(torch.cuda.current_device()))
            ws = (torch.empty((plan.ks, B, n_pad), dtype=torch.float32,
                              device=self.dev) if plan.ks > 1 else None)
            counters = kernels._gemv_counters(self.dev,
                                              n_pad // kernels.WIRE_ROWS)
            rc = self.par["qmm_wire_gemv_run"](
                *args, *tail, plan.ks, plan.ns, plan.nbx, kernels._ptr(ws),
                counters.data_ptr(), out.data_ptr(), stream)
        else:
            rc = self.par["qmm_wire_run"](*args, int(cd == torch.float32),
                                          *tail, out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"parent K10: CUDA error {rc}")
        return out

    def k10(self, unit, name, qt, B, count, cd=torch.bfloat16):
        """One K10 row, P C C P: the GEMV (B <= 8) or the wgmma GEMM
        against the parent's K10 on the same arguments."""
        x = torch.randn(B, qt.k, generator=self.gen, device=self.dev)
        planes = PQ._wire_planes(qt)
        new = lambda: kernels.qmm_wire(x, qt.cfg, planes, qt.k, cd)  # noqa: E731
        old = lambda: self.parent_wire(x, qt, planes, cd)  # noqa: E731
        want = PQ.qmm_wire_plain(x, qt, cd)
        e_new, e_old = _nmse(new(), want), _nmse(old(), want)
        del want
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        deq = PQ.dequantize(qt, cd)
        xc = x.to(cd)
        lib = _time_ms(lambda: torch.matmul(xc, deq.t()))
        del deq
        n_pad = planes[0].shape[0]
        byts = sum(t_.numel() * t_.element_size() for t_ in planes
                   if t_ is not None) + x.numel() * 4 + B * n_pad * 4
        ops = 2 * B * n_pad * qt.k
        f32 = cd == torch.float32
        gemv = B <= kernels.WIRE_GEMV_ROWS
        peak = (BF16_OPS if not f32 else F32_OPS if gemv else TF32_OPS / 3)
        bound = max(byts / HBM_BPS, ops / peak) * 1e3
        cfg = qt.cfg
        geo = (qt.k, cfg.bits_lo, cfg.bits_hi, cfg.superblock, cfg.asym,
               cfg.gs)
        sms = kernels._sm_count(torch.cuda.current_device())
        plan = (kernels.pick_wire_gemv(*geo, n_pad // kernels.WIRE_ROWS, B,
                                       sms, f32) if gemv
                else kernels.pick_wire_gemm(*geo, n_pad, B, sms, f32))
        print(f"K10 {unit} {name} {qt.cfg.qtype.name} {qt.n}x{qt.k} B={B} "
              f"{str(cd)[6:]} {plan} nmse={e_new:.2e} (parent {e_old:.2e}) "
              f"P={t[0]:.4f} C={t[1]:.4f} C={t[2]:.4f} P={t[3]:.4f} ms "
              f"matmul={lib:.4f} bound={bound:.4f} x{count}", flush=True)
        self._unit(unit, count, t, lib, bound)
        return e_new

    def k11(self, unit, dtype, B=1, H=32, T=512, S=1024, D=128, dead=64):
        """K11 at the conformance prefill, P C C P; the bound at the TF32
        peak times the products (three for f32 inputs, two for bf16)."""
        g = self.gen
        q, k, v = (torch.randn(B, H, n, D, generator=g, device=self.dev)
                   .to(dtype) for n in (T, S, S))
        t_ = torch.arange(T, device=self.dev)[:, None]
        sl = torch.arange(S, device=self.dev)[None, :]
        mask = torch.where(sl <= S - dead - T + t_, 0.0, -1e30)
        mask[:, S - dead:] = -1e30
        mask = mask[None, None].contiguous()
        scale = D ** -0.5
        new = lambda: kernels.flash_attn(q, k, v, mask, scale)  # noqa: E731
        old = lambda: self._as_parent(new, "attention")  # noqa: E731
        want = PA.flash_attn_plain(q, k, v, mask, scale)
        e_new = float((new() - want).abs().max())
        e_old = float((old() - want).abs().max())
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        m_lib = mask.to(dtype)
        lib = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m_lib, scale=scale))
        byts = sum(t_.numel() * t_.element_size() for t_ in (q, k, v, mask)) \
            + B * H * T * D * 4
        products = 2 if dtype == torch.bfloat16 else 3
        ops = 4 * B * H * T * S * D * products
        bound = max(byts / HBM_BPS, ops / TF32_OPS) * 1e3
        print(f"K11 {unit} B={B} H={H} T={T} S={S} D={D} {str(dtype)[6:]} "
              f"max|d|={e_new:.2e} (parent {e_old:.2e}) P={t[0]:.4f} "
              f"C={t[1]:.4f} C={t[2]:.4f} P={t[3]:.4f} ms sdpa={lib:.4f} "
              f"bound={bound:.4f}", flush=True)
        self._unit(unit, 1, t, lib, bound)
        return max(e_new, 0.0)

    def k12(self, unit, pos=700, Hkv=8, G=4, S=1024, D=128):
        """K12 at a decode step (B = 1, bf16 cache), P C C P, against SDPA
        on the same inputs (k12_sdpa, as chip_smoke.py times it)."""
        g = self.gen
        qg = torch.randn(1, Hkv, G, 1, D, generator=g, device=self.dev)
        kc, vc = (torch.randn(1, S, Hkv, D, generator=g, device=self.dev)
                  .to(torch.bfloat16) for _ in range(2))
        posb = torch.tensor([pos], dtype=torch.int32, device=self.dev)
        scale = D ** -0.5
        new = lambda: kernels.decode_attn_gqa(qg, kc, vc, posb, scale)  # noqa: E731
        old = lambda: self.parent_k12(qg, kc, vc, posb, scale)  # noqa: E731
        want = PA.decode_attn_gqa_plain(qg, kc, vc, posb, scale)
        e_new = float((new() - want).abs().max())
        e_old = float((old() - want).abs().max())
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        lib = _time_ms(k12_sdpa(qg, kc, vc, pos, 0, scale))
        byts = (qg.numel() * 4 + 4 + Hkv * G * D * 4
                + 2 * (pos + 1) * Hkv * D * 2)
        bound = max(byts / HBM_BPS, 4 * (pos + 1) * Hkv * G * D / BF16_OPS) * 1e3
        old_ns = kernels._pick_nsplit(Hkv, S, min_slots=64)
        print(f"K12 {unit} pos={pos} S={S} max|d|={e_new:.2e} (parent "
              f"{e_old:.2e}) splits={old_ns} -> "
              f"{kernels.pick_gqa_splits(1, Hkv, S, kernels._sm_count(0))} "
              f"P={t[0]:.5f} C={t[1]:.5f} C={t[2]:.5f} P={t[3]:.5f} ms "
              f"sdpa={lib:.5f} bound={bound:.5f}", flush=True)
        self._unit(unit, 1, t, lib, bound)
        return max(e_new, e_old)

    def k4(self, cfg, quant, B, pos, layers):
        """One K4 row at S=1024; a step is `layers` launches."""
        Hq, Hkv, D, S = cfg.n_head, cfg.n_head_kv, cfg.hd, 1024
        dev, gen = self.dev, self.gen
        qkv = torch.randn(B, (Hq + 2 * Hkv) * D, generator=gen, device=dev)
        if quant:
            kc = torch.randint(-127, 128, (B, S, Hkv * D), device=dev,
                               dtype=torch.int8, generator=gen)
            vc = torch.randint(-127, 128, (B, S, Hkv * D), device=dev,
                               dtype=torch.int8, generator=gen)
            ks = torch.rand(B, S, device=dev, generator=gen) * 0.02
            vs = torch.rand(B, S, device=dev, generator=gen) * 0.02
        else:
            kc = torch.randn(B, S, Hkv * D, generator=gen,
                             device=dev).to(torch.bfloat16)
            vc = torch.randn(B, S, Hkv * D, generator=gen,
                             device=dev).to(torch.bfloat16)
            ks = vs = None
        rows = [pos, max(0, pos - 3), max(0, pos - 40), pos // 2][:B]
        posb = torch.tensor(rows, dtype=torch.int32, device=dev)
        inv, mscale = rope_freqs(cfg.rope_params, dev)
        ang = posb[:, None].float() * inv[None]
        cs = (torch.cat([torch.cos(ang), torch.sin(ang)], 1)
              * mscale).contiguous()
        kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5, k_scale=ks,
                  v_scale=vs)
        want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
        err = max(float((g - w).abs().max()) for g, w in
                  zip(PD.decode_attn(qkv, kc, vc, posb, cs, **kw), want))
        new = lambda: PD.decode_attn(qkv, kc, vc, posb, cs, **kw)  # noqa: E731
        old = lambda: self.parent_attn(qkv, kc, vc, posb, cs, **kw)  # noqa: E731
        t = [_time_ms(old), _time_ms(new), _time_ms(new), _time_ms(old)]
        lib = None
        if not quant:
            q4 = qkv[:, :Hq * D].reshape(B, Hq, 1, D).to(torch.bfloat16)
            k4 = kc[:, :pos + 1].reshape(B, pos + 1, Hkv, D).transpose(1, 2)
            v4 = vc[:, :pos + 1].reshape(B, pos + 1, Hkv, D).transpose(1, 2)
            lib = _time_ms(lambda: torch.nn.functional.
                           scaled_dot_product_attention(q4, k4, v4,
                                                        enable_gqa=True))
        live = int(posb.sum())
        byts = (qkv.numel() * 4 + cs.numel() * 4 + (B * Hq * D + 2 * B * Hkv * D) * 4
                + 2 * live * Hkv * D * (1 if quant else 2)
                + (2 * live * 4 if quant else 0))
        ops = 4 * int((posb + 1).sum()) * Hq * D
        bound = max(byts / HBM_BPS, ops / BF16_OPS) * 1e3
        print(f"K4 {'int8' if quant else 'bf16'} B={B} pos={pos} "
              f"max|d|={err:.2e} P={t[0]:.5f} C={t[1]:.5f} C={t[2]:.5f} "
              f"P={t[3]:.5f} ms sdpa={'n/a' if lib is None else f'{lib:.5f}'} "
              f"bound={bound:.5f}; step of {layers}: "
              f"P={layers * (t[0] + t[3]) / 2:.4f} "
              f"C={layers * (t[1] + t[2]) / 2:.4f}"
              + ("" if lib is None else f" sdpa={layers * lib:.4f}") + " ms",
              flush=True)
        return err


def builds_control(ab, dev):
    """K6 nibble res and plain at 4096 x 4096 (B = 1) through the parent's
    fast_il.cu and this tree's, each built twice (P, P2, C, C2), in
    rotation over three turns: two builds of one source, loaded apart, can
    time a few % apart, the floor of a K6 A/B's verdict."""
    srcs = {"P2": f"{ab.parent_dir}/fast_il.cu",
            "C2": str(kernels.CSRC / "fast_il.cu")}
    libs = {"P": ab.par["lib:fast_il"], "C": kernels._LIBS["fast_il"]}
    for k, src in srcs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(kernels.BUILD_DIR / f"again_{k}_fast_il.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = proc.stdout
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {srcs[k]}:\n{log}")
        ptxas = sum(float(line.split("=")[1].split()[0])
                    for line in log.splitlines() if "Compile time =" in line)
        regs = [line.split("Used ")[1].split()[0]
                for line in log.splitlines() if "Used " in line]
        spill = sum(", 0 bytes spill stores" not in line
                    for line in log.splitlines() if "spill stores" in line)
        print(f"fast_il.cu build {k} ({src}), alone: "
              f"{time.perf_counter() - t0:.1f} s, ptxas {ptxas / 1e3:.1f} s "
              f"summed over its kernels; registers {'/'.join(regs)}; "
              f"{spill} kernels spill", flush=True)
        lib = ctypes.CDLL(str(kernels.BUILD_DIR / f"again_{k}_fast_il.so"))
        lib.fast_il_run.argtypes = kernels._ARGTYPES["fast_il_run"]
        lib.fast_il_run.restype = ctypes.c_int
        lib.ght_error_string.argtypes = [ctypes.c_int]
        lib.ght_error_string.restype = ctypes.c_char_p
        libs[k] = lib
    mine = kernels._LIBS["fast_il"]
    qt = random_qtensor(ab.gen, 4096, 4096, GGMLType.Q4_K, dev).with_fast_planes(
        "il").without_wire()
    x = torch.randn(1, 4096, generator=ab.gen, device=dev).to(torch.bfloat16)
    try:
        for mode in ("res", "plain"):
            kw = ({"res": torch.randn(1, 4096, generator=ab.gen, device=dev)}
                  if mode == "res" else {})
            kw["xg"] = PF.group_sums(qt, x, mode)
            kern = PF._k6(qt, False)

            def run(k):
                kernels._LIBS["fast_il"] = libs[k]
                return kern(x, qt, **kw)

            want = run("P")
            if any(not torch.equal(run(k), want) for k in libs):
                raise AssertionError("two builds of K6 disagree")
            times = {k: [] for k in ("P", "P2", "C", "C2")}
            for turn in range(3):
                for k in (("P", "C", "P2", "C2") if turn % 2 == 0
                          else ("C2", "P2", "C", "P")):
                    times[k].append(_time_ms(lambda k=k: run(k), 50))
            print(f"K6 builds control Q4_K {mode} 4096x4096 B=1 ms: " + " ".join(
                f"{k}=" + "/".join(f"{t:.4f}" for t in v)
                for k, v in times.items()), flush=True)
    finally:
        kernels._LIBS["fast_il"] = mine


def run_il(ab, dev) -> bool:
    """K6 (B = 1 and 8) in the gelu act mode on Gemma-2-9B's downs; K6 (B
    <= 8) on the decode steps of the interleaved Llama-3-8B cells and on
    two 8-token buckets, K6 and K8 on the interleaved Mixtral-8x7B steps
    (random stacks of each policy type)."""
    ok = True

    def k6(unit, rows):
        nonlocal ok
        for name, qt, mode, count, B in rows:
            ok &= ab.k6(unit, name, qt, mode, B, count) <= 1e-6

    # Gemma-2-9B's downs in the gelu act mode (no residual: post-norms), a
    # random plane set of each down type, counted by its layers
    gcfg = LlamaConfig(**GEMMA2_9B)
    policy = _policy(gcfg, "Q4_K_M", False)
    shape = (gcfg.n_embd, gcfg.n_ff)
    downs = [policy.tensor_type(f"blk.{il}.ffn_down.weight", shape)
             for il in range(gcfg.n_layer)]
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    for q in sorted(set(downs), key=lambda q: q.name):
        qt = random_qtensor(g, *shape, q, dev).with_fast_planes(
            "il").without_wire()
        for B in (1, 8):
            k6(f"Gemma-2-9B-{'step' if B == 1 else 'bucket8'}-K6-gelu",
               [(f"down_{q.name.lower()}", qt, "act_gelu", downs.count(q), B)])
        del qt
    torch.cuda.empty_cache()

    cfg, w = build_8b_iq4xs(seed=0, device=dev)
    layers = w["layers"]
    lw = next(lw for lw in layers if lw["ffn_down"].fl == "il")
    n_l, n_dn = len(layers), sum(lw["ffn_down"].fl == "il" for lw in layers)
    k6("8B-IQ4_XS-step-K6-byte-normed",
       [("wqk", lw["wqk"], "normed", n_l, 1),
        ("gate_up", lw["w_gateup_il"], "normed", n_l, 1)])
    k6("8B-IQ4_XS-step-K6-byte-res", [("wo", lw["wo"], "res", n_l, 1)])
    k6("8B-IQ4_XS-step-K6-byte-act", [("down", lw["ffn_down"], "act", n_dn, 1)])
    k6("8B-IQ4_XS-bucket8-K6",
       [("wqk", lw["wqk"], "normed", n_l, 8),
        ("gate_up", lw["w_gateup_il"], "normed", n_l, 8),
        ("wo", lw["wo"], "plain", n_l, 8),
        ("down", lw["ffn_down"], "act", n_dn, 8)])
    del w, layers, lw
    torch.cuda.empty_cache()

    cfg, w = build_8b_il(seed=0, device=dev)
    layers = w["layers"]
    full = next(lw for lw in layers if "wqkv" in lw)
    mixed = next(lw for lw in layers if "wqk" in lw)
    n_full = sum("wqkv" in lw for lw in layers)
    n_mixed = n_l - n_full
    dn = {q: next(lw["ffn_down"] for lw in layers
                  if lw["ffn_down"].cfg.qtype.name == q) for q in ("Q4_K", "Q6_K")}
    n6 = sum(lw["ffn_down"].cfg.qtype.name == "Q6_K" for lw in layers)
    step = "8B-Q4_K_M-il-step"
    k6(f"{step}-K6-nibble-normed",
       [("wqkv", full["wqkv"], "normed", n_full, 1),
        ("gate_up", full["w_gateup_il"], "normed", n_l, 1)])
    k6(f"{step}-K6-nibble-res", [("wo", full["wo"], "res", n_l, 1)])
    k6(f"{step}-K6-nibble-act", [("down_q4k", dn["Q4_K"], "act", n_l - n6, 1)])
    k6(f"{step}-K6-byte-derived-act", [("down_q6k", dn["Q6_K"], "act", n6, 1)])
    k6(f"{step}-K6-byte-derived-head", [("head_q6k", w["output"], "plain", 1, 1)])
    k6("8B-Q4_K_M-il-bucket8-K6",
       [("wqkv", full["wqkv"], "normed", n_full, 8),
        ("wqk", mixed["wqk"], "normed", n_mixed, 8),
        ("wv_q6k", mixed["wv"], "normed", n_mixed, 8),
        ("gate_up", full["w_gateup_il"], "normed", n_l, 8),
        ("wo", full["wo"], "plain", n_l, 8),
        ("down_q4k", dn["Q4_K"], "act", n_l - n6, 8),
        ("down_q6k", dn["Q6_K"], "act", n6, 8),
        ("head_q6k", w["output"], "plain", 1, 8)])
    del w, layers, full, mixed, dn
    torch.cuda.empty_cache()

    cfg, w = build_8b_iq3xxs("il", seed=0, device=dev)
    lw = w["layers"][0]
    step = "8B-IQ3_XXS-il-step"
    k6(f"{step}-K6-coded-normed", [("gate_up", lw["w_gateup_il"], "normed", n_l, 1)])
    k6(f"{step}-K6-coded-res", [("wo", lw["wo"], "res", n_l, 1)])
    k6(f"{step}-K6-coded-act", [("down", lw["ffn_down"], "act", n_l, 1)])
    del w, lw
    torch.cuda.empty_cache()

    # the Mixtral-8x7B steps: one random plane set or expert stack of each
    # policy type on the cell's layout (IQ4_XS: the default, where Q5_K
    # down stacks take K5; the others interleaved everywhere), counted by
    # the layers of that type (gate and up stacks: two launches a layer)
    mcfg = LlamaConfig(**MIXTRAL_8X7B)
    E, d, nff, n_l = mcfg.n_expert, mcfg.n_embd, mcfg.n_ff, mcfg.n_layer
    nkv = mcfg.n_head_kv * mcfg.hd
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    for ftype, imat, layout, tag, attn in (
            ("IQ4_XS", False, None, "IQ4_XS",
             (("attn_q", d, "plain", n_l), ("attn_k", nkv, "plain", 2 * n_l))),
            ("Q4_K_M", False, "il", "Q4_K_M-il",
             (("attn_q", d, "plain", n_l), ("attn_output", d, "res", n_l))),
            ("IQ3_XXS", True, "il", "IQ3_XXS-il",
             (("attn_q", d, "plain", n_l),))):
        policy = _policy(mcfg, ftype, imat)
        step = f"Mixtral-{tag}-step"
        for name, n, mode, count in attn:
            qt = random_qtensor(g, n, d, policy.tensor_type(
                f"blk.0.{name}.weight", (n, d)), dev).with_fast_planes(
                    layout).without_wire()
            fam = PF._family(qt.cfg) + ("-stored" if qt.fb is not None else "")
            k6(f"{step}-K6-{fam}-{mode}", [(name, qt, mode, count, 1)])
            del qt
        gate = policy.tensor_type("blk.0.ffn_gate_exps.weight", (E * nff, d))
        downs = [policy.tensor_type(f"blk.{il}.ffn_down_exps.weight",
                                    (E * d, nff)) for il in range(n_l)]
        for name, n, k, qtype, count in (
                [("gate_up", nff, d, gate, 2 * n_l)]
                + [(f"down_{q.name.lower()}", d, nff, q, downs.count(q))
                   for q in sorted(set(downs), key=lambda q: q.name)]):
            stack = random_qtensor(g, E * n, k, qtype, dev).with_fast_planes(
                layout).without_wire()
            if stack.fl == "il":  # t-plane stacks are K5's
                fam = PF._family(stack.cfg) + ("-derived" if PF._offset_bias(
                    stack.cfg, stack.fb) else "")
                ok &= ab.k8(f"{step}-K8-{fam}", name, stack, n, count) <= 1e-6
            del stack
            torch.cuda.empty_cache()
    return ok


def run_k3k4(ab, dev) -> bool:
    """K3 on the 8B chunk mixes and Mixtral expert slices, K4 at the 8B
    decode step's shapes."""
    ok = True
    cfg, w = build_8b(seed=0, device=dev)
    layers = w["layers"]
    full = next(lw for lw in layers if "wqkv" in lw)
    mixed = next(lw for lw in layers if "wqk" in lw)
    n_full = sum("wqkv" in lw for lw in layers)
    n_l = len(layers)
    dn = {q: next(lw["ffn_down"] for lw in layers
                  if lw["ffn_down"].cfg.qtype.name == q) for q in ("Q4_K", "Q6_K")}
    n_q6 = sum(lw["ffn_down"].cfg.qtype.name == "Q6_K" for lw in layers)
    rows = (("wqkv", full["wqkv"], n_full), ("wqk", mixed["wqk"], n_l - n_full),
            ("wv", mixed["wv"], n_l - n_full), ("wo", full["wo"], n_l),
            ("gate_up", full["w_gateup_il"], n_l),
            ("down_q4k", dn["Q4_K"], n_l - n_q6), ("down_q6k", dn["Q6_K"], n_q6),
            ("head_q6k", w["output"], 1))
    for M in (512, 128, 32):
        for name, qt, count in rows:
            ok &= ab.k3(f"8B-Q4_K_M-M{M}", name, qt, count, M=M) <= 1e-6
    del w, layers, full, mixed, dn, rows
    torch.cuda.empty_cache()
    for quant in (False, True):
        for B in (1, 4):
            for pos in (0, 1, 700, 1023):
                ok &= ab.k4(cfg, quant, B, pos, n_l) <= 1e-4

    cfg, w = build_8b_iq3xxs("t", seed=0, device=dev)
    lw = w["layers"][0]
    for name in ("wqk", "wo", "w_gateup_il", "ffn_down"):
        ok &= ab.k3("8B-IQ3_XXS-coded-M512", name, lw[name], n_l) <= 1e-6
    del w, lw
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for name, n, k, qtype in (("gate_up", 28672, 4096, GGMLType.Q5_K),
                              ("down", 4096, 14336, GGMLType.Q6_K)):
        stack = random_qtensor(g, 8 * n, k, qtype, dev).with_fast_planes(
            "t").without_wire()
        expert = qtensor_rows(stack, 2 * n, n)
        for M in (128, 512):
            ok &= ab.k3(f"Mixtral-expert-{name}-M{M}", name, expert, 1,
                        M=M) <= 1e-6
        del stack, expert
        torch.cuda.empty_cache()
    return ok


def run_gemv(ab, dev) -> bool:
    """K1/K2 on the 8B step and bucket-8 mixes (Q4_K_M, IQ3_XXS coded), K5
    on a Mixtral Q5_K_M and an IQ3_XXS step."""
    ok = True
    cfg, w = build_8b(seed=0, device=dev)
    layers = w["layers"]
    full = next(lw for lw in layers if "wqkv" in lw)
    mixed = next(lw for lw in layers if "wqk" in lw)
    n_l = len(layers)
    n_full = sum("wqkv" in lw for lw in layers)
    dn = {q: next(lw["ffn_down"] for lw in layers
                  if lw["ffn_down"].cfg.qtype.name == q) for q in ("Q4_K", "Q6_K")}
    n6 = sum(lw["ffn_down"].cfg.qtype.name == "Q6_K" for lw in layers)
    step = (("wqkv", full["wqkv"], "normed", n_full),
            ("wo", full["wo"], "res", n_l),
            ("gate_up", full["w_gateup_il"], "normed", n_l),
            ("down_q4k", dn["Q4_K"], "act", n_l - n6),
            ("down_q6k", dn["Q6_K"], "act", n6),
            ("head_q6k", w["output"], "raw", 1))
    for name, qt, mode, count in step:
        ok &= ab.gemv("8B-Q4_K_M-step-K1", name, [qt], mode, 1, count) <= 1e-6
    ok &= ab.gemv("8B-Q4_K_M-step-K2", "wqk+wv", [mixed["wqk"], mixed["wv"]],
                  "normed", 1, n_l - n_full) <= 1e-6
    for name, qt, mode, count in step + (
            ("wqk", mixed["wqk"], "normed", n_l - n_full),
            ("wv", mixed["wv"], "normed", n_l - n_full)):
        ok &= ab.gemv("8B-Q4_K_M-bucket8-K1", name, [qt], mode, 8,
                      count) <= 1e-6
    del w, layers, full, mixed, dn, step
    torch.cuda.empty_cache()

    cfg, w = build_8b_iq3xxs("t", seed=0, device=dev)
    lw = w["layers"][0]
    for name, mode in (("wo", "res"), ("w_gateup_il", "normed"),
                       ("ffn_down", "act")):
        ok &= ab.gemv("8B-IQ3_XXS-step-K1coded", name, [lw[name]], mode, 1,
                      n_l) <= 1e-6
    ok &= ab.gemv("8B-IQ3_XXS-step-K2coded", "wqk+wv", [lw["wqk"], lw["wv"]],
                  "normed", 1, n_l) <= 1e-6
    del w, lw
    torch.cuda.empty_cache()

    # the Mixtral-8x7B steps: one random stack of each type, counted by the
    # layers of that type (gate and up stacks: two launches a layer)
    mcfg = LlamaConfig(**MIXTRAL_8X7B)
    E, d, nff, n_l = mcfg.n_expert, mcfg.n_embd, mcfg.n_ff, mcfg.n_layer
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for ftype, imat, unit in (("Q5_K_M", False, "Mixtral-Q5_K_M-step-K5"),
                              ("IQ3_XXS", True, "Mixtral-IQ3_XXS-step-K5coded")):
        policy = _policy(mcfg, ftype, imat)
        gate = policy.tensor_type("blk.0.ffn_gate_exps.weight", (E * nff, d))
        downs = [policy.tensor_type(f"blk.{il}.ffn_down_exps.weight",
                                    (E * d, nff)) for il in range(n_l)]
        for name, n, k, qtype, count in (
                [("gate_up", nff, d, gate, 2 * n_l)]
                + [(f"down_{q.name.lower()}", d, nff, q, downs.count(q))
                   for q in sorted(set(downs), key=lambda q: q.name)]):
            stack = random_qtensor(g, E * n, k, qtype, dev).with_fast_planes(
                "t").without_wire()
            ok &= ab.k5(unit, name, stack, n, count) <= 1e-6
            del stack
            torch.cuda.empty_cache()
    return ok


def run_wire(ab, dev) -> bool:
    """K10: the 8B's wq, gate and down at B = 512 (the b512 unit), one type
    of each of the 12 plane families at 4096 x 4096 and B = 512, the wq in
    f32 at B = 8 and 512; level, the 8B's shapes at B = 1 and 8 (the bf16
    GEMV)."""
    from .quant.pack import QCONFIGS

    ok = True
    g = torch.Generator(device=dev)
    g.manual_seed(77)
    shapes = (("wq", 4096, 4096, GGMLType.Q4_K), ("gate", 14336, 4096, GGMLType.Q4_K),
              ("down", 4096, 14336, GGMLType.Q6_K), ("head", 128256, 4096, GGMLType.Q6_K))
    qts = {name: random_qtensor(g, n, k, qtype, dev) for name, n, k, qtype in shapes}
    for name in ("wq", "gate", "down"):
        ok &= ab.k10("8B-K10-B512", name, qts[name], 512, 1) <= 1e-6
    ok &= ab.k10("K10-f32-B8", "wq", qts["wq"], 8, 1,
                 torch.float32) <= NMSE_F32
    ok &= ab.k10("K10-f32-B512", "wq", qts["wq"], 512, 1,
                 torch.float32) <= NMSE_F32
    for B in (1, 8):
        for name in qts:
            ok &= ab.k10(f"8B-K10-B{B}-level", name, qts[name], B, 1) <= 1e-6
    del qts
    torch.cuda.empty_cache()
    seen = set()
    for qtype in sorted(QCONFIGS, key=int):
        fam = kernels.wire_family(QCONFIGS[qtype])
        if fam in seen:
            continue
        seen.add(fam)
        qt = random_qtensor(g, 4096, 4096, qtype, dev)
        ok &= ab.k10(f"K10-{qtype.name}-4096-B512", "type", qt, 512, 1) <= 1e-6
        del qt
    return ok


def run_attention(ab, dev) -> bool:
    """K12 at pos 700 and at the end of an 8192-slot cache; K11 f32 and
    bf16, level."""
    ok = ab.k12("K12-pos700") <= 1e-4
    ok &= ab.k12("K12-S8192-pos8191", pos=8191, S=8192) <= 1e-4
    for dtype in (torch.float32, torch.bfloat16):
        ok &= ab.k11(f"K11-{str(dtype)[6:]}-level", dtype) <= 1e-4
    return ok


def run_k9(ab, dev) -> bool:
    """K9 on the 8B Q4_K_M il ffn layers (a Q4_K-down and a Q6_K-down
    layer, each unit counted over its layers of the step), B = 1 and 8."""
    ok = True
    cfg, w = build_8b_il(seed=0, device=dev, ffn_fused=True)
    layers = w["layers"]
    for q in ("Q4_K", "Q6_K"):
        lws = [lw for lw in layers if lw["ffn_down"].cfg.qtype.name == q]
        for B in (1, 8):
            ok &= ab.k9(f"8B-Q4_K_M-il-ffn-K9-{q}-down-B{B}", cfg, lws[0], B,
                        len(lws)) <= 1e-6
    del w, layers
    torch.cuda.empty_cache()
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the parent's fast_il.cu, "
                         "qp8_gemm.cu and decode_attn.cu, qp8_gemv.cu, "
                         "qmm_wire.cu, attention.cu, or ffn_fused.cu, or "
                         "any of these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels.build_all()
    ab = AB(args.parent, dev)
    if not any(k.startswith("lib:") for k in ab.par):
        print(f"kernel_ab: no parent source in {args.parent}", file=sys.stderr)
        return 2
    ok = True
    if "lib:fast_il" in ab.par:
        ok &= run_il(ab, dev)
        builds_control(ab, dev)
    if "lib:qp8_gemm" in ab.par and "lib:decode_attn" in ab.par:
        ok &= run_k3k4(ab, dev)
    if "lib:qp8_gemv" in ab.par:
        ok &= run_gemv(ab, dev)
    if "lib:qmm_wire" in ab.par:
        ok &= run_wire(ab, dev)
    if "lib:attention" in ab.par:
        ok &= run_attention(ab, dev)
    if "lib:ffn_fused" in ab.par:
        ok &= run_k9(ab, dev)
    for unit, (p, c, lib, bound, n) in ab.units.items():
        vs = f" ({c / lib:.2f}x)" if lib else ""
        share = f", {bound / c:.0%} of it" if bound and c else ""
        print(f"UNIT {unit}: {n} launches, parent {p:.3f} ms, change "
              f"{c:.3f} ms ({p / c:.2f}x faster), yardstick {lib:.3f} "
              f"ms{vs}, bound {bound:.4f} ms{share}", flush=True)
    print("ALL HELD" if ok else "FAILURES", flush=True)
    return 0 if ok else 1




if __name__ == "__main__":
    sys.exit(main())
