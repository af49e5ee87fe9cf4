"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ggml_hexagon_tpu_torch/csrc;
2. Llama-3-8B Q4_K_M (the first slice's path): holds K1 (qp8 decode GEMV),
   K2 (dual QKV GEMV), K3 (qp8 prefill GEMM: wgmma on weights decoded in
   registers, x by TMA; at M = 512 and at the 32- and 128-token buckets)
   and K4 (fused decode attention, the live slots split over blocks and
   merged; at pos 0, 1, 700 and 1023) against their plain PyTorch
   versions at the main path's shapes, timing kernel, plain version and a
   one-call PyTorch yardstick
   with CUDA events; builds the random model at full width and depth on
   the card and serves greedy requests through Engine (bf16 and q8_0 KV),
   the launch counters zeroed just before and read just after; profiles a
   prefill and decode steps; compares kernels and plain versions end to
   end;
3. Mixtral-8x7B Q5_K_M (the second slice's path), after the 8B model is
   freed: the same phases at full width and depth, with K5 (gathered-expert
   GEMV), K6 (interleaved Q8_0 matmul) and K1/K3 on Q5_K held against
   their plain versions, exact launch counts per decode step and prefill
   chunk, and the end-to-end comparison checking the expert routing of
   both runs layer by layer;
4. Llama-3-8B IQ4_XS (the third slice's path), after Mixtral is freed: the
   same phases, with K6's normed, residual and act modes (and its plain
   mode at prefill) held against their plain versions and the launch
   counts held to LAUNCH_TABLES;
5. Mixtral-8x7B IQ4_XS, after the 8B IQ4_XS is freed: the same phases,
   with K8 (gathered experts on interleaved stacks) and K6's plain mode on
   IQ4_XS held against their plain versions; its decode steps run K8 on
   the IQ4_XS stacks and K5 on the Q5_K down stacks of layers 0-3;
6. Llama-3-8B Q4_K_M on the interleaved layout everywhere (the JAX
   package's GHT_QP8=0 route; the fourth slice's path), after Mixtral
   IQ4_XS is freed: the same phases, with K6 on nibble planes in every mode,
   K6 on Q6_K byte planes with the derived bias (act mode, the head) and K7
   (the dual wqk + wv projection) held against their plain versions; no
   t-plane kernel launches;
7. Mixtral-8x7B Q4_K_M on the interleaved layout everywhere: the same
   phases, with K8 on the Q4_K (nibble) stacks and on the Q6_K stacks with
   the derived bias, K6 on nibble planes (wq) and on Q5_K planes with a
   stored bias (wo, residual mode) held against their plain versions;
8. Llama-3-8B IQ3_XXS (made with an imatrix; the fifth slice's path, the
   coded i-quants), on the default layouts: the same phases, with the
   code-map branch of K2 (a coded IQ2_S wqk beside a Q4_K wv), of K1 (res,
   normed, act) and of K3 held against their plain versions, and iq1 and
   ternary (which no served configuration uses) on one K1, K3 and K6 shape
   each;
9. Llama-3-8B IQ3_XXS on the interleaved layout everywhere: K7 with a coded
   part and K6 on coded nibble planes in every mode;
10. Mixtral-8x7B IQ3_XXS on the interleaved layout everywhere: K8 on the
   coded expert stacks and K6's coded plain mode;
11. Mixtral-8x7B IQ3_XXS on the default layouts: K5 on the coded stacks, K1
   and K3 on coded t-planes;
12. Llama-3-8B Q4_K_M on the interleaved layout with the whole-FFN
   megakernel layout (the JAX package's GHT_FFN_FUSED=1; the sixth slice's
   path): each decode layer's wo + residual, RMSNorm, gate_up, silu*up and
   down + residual as one K9 launch, held against its plain version at the
   main path's shapes (Q4_K and Q6_K down, B = 1 and 3) and at one
   full-width shape of each other down branch (Q5_K, Q4_0, IQ3_XXS), timed
   beside the three K6 launches of the split path on the same layer; K9
   is one cooperative launch of persistent blocks (csrc/ffn_fused.cu, the
   fifteenth slice: K6's streaming block over the three phases, one ring
   whose producer streams the next phase's weights across each boundary,
   the phases meeting at device counters), and the profiled decode steps
   hold it to exactly one ffn_kernel a K9 call, with no memset kernel;
13. the conformance entry points (the seventh slice's path; no model; run
   first, right after the build: late in a process that has run the
   cells' long profiles the tracer was seen to record none of the K12
   kernels of its short window, which a fresh process records, and short
   launches there time slow):
   qmatmul(backend="pallas") (K10, the wire-plane dequant x matmul) on the
   Llama-3-8B shapes (Q4_K wq and gate, Q6_K down and head; B = 1, 8, 512)
   and on all 21 wire types at 4096 x 4096 (B = 1, 8; the wq in f32
   compute at B = 8 and 512), flash_attention_pallas (K11) at the 512-token
   prefill (B=1, H=32, T=512, S=1024, D=128, a causal [1,1,T,S] mask with
   a dead tail; f32 and bf16) and decode_attention_pallas (K12) at the
   decode step (Hkv=8, G=4, S=1024, bf16 cache, B=1 at pos 700 and B=4 at
   spread positions; plain, swa=256, logit_cap=30): driven once with the
   counters zeroed before and read after, each launch count exact, then
   each output held against its plain twin and timed.  K10 at B <= 8 is
   the streaming GEMV of the twelfth slice (bf16 mma, or f32 multiply-adds
   since the thirteenth), above 8 rows the wgmma GEMM of the thirteenth
   (csrc/qmm_wire_gemm.cu: weights decoded in registers, bf16, or f32 as
   three TF32 products); K11 is the TF32 tensor-core flash attention of
   the twelfth slice.  K10 in f32 is held to NMSE_K10_F32, and one- and
   two-TF32-product controls on the same inputs must miss that limit.
   K10 is reported as five units (the 8B's shapes at B
   = 1, 8 and 512 in bf16, its wq in f32 at B = 8 and 512), K11 as two
   (f32 and bf16 inputs), each with the launches its cases made in the
   drive.

14. Llama-3-8B Q4_K_M from a GGUF file (the loading and text-serving
   path; right after the conformance phase): write_gguf writes the
   full-size model (random centred Q4_K/Q6_K blocks, the 8B's llama.*
   metadata and a synthetic llama-bpe vocabulary of 128256 tokens,
   models/synth.py) into
   a temporary directory (or a bytearray when it lacks room), removed
   after; Engine.from_gguf(fuse=True) loads it (the raw bytes unpacked on
   the card by pack_tensor, held byte-equal to the CPU's on a Q4_K and a
   Q6_K tensor; the token embedding's planes equal to the draw); requests
   from text (prompts of 512, 128 and 7 tokens that round-trip through the
   tokenizer) through generate with the greedy chain under bf16, q8_0 and
   q4_0 KV, each prefill and decode step held to the 8B's launch table
   (under q4_0 one decode_attn_q4 launch a layer a step); generate_ondevice
   held to the host greedy tokens at temp 0 and to its seed at temp 0.8,
   top-k 40, top-p 0.95, with no device-to-host copy added by its decode
   steps (profiler); K4 over a q4_0 cache held against its plain twin at
   pos 700, B = 1 and 8, timed beside SDPA on the cache dequantized to
   bf16.

K6 above 8 rows is its own kernel, the wgmma GEMM of csrc/fast_il_gemm.cu
(the ninth slice): every configuration whose prefill chunk runs it holds
it against its plain version at M = 32, 128 and 512 on the chunk's shapes,
and once at M = 1024 (outside the served path); its launches are counted
apart by family and bias (kernels.GEMM_LAUNCHES, exact per chunk:
GEMM_TABLES), and one report each (fast_byte_gemm, ..._derived,
..._stored, fast_nibble_gemm_stored, fast_coded_gemm) sums one 512-token
chunk of each configuration that runs it, logged per configuration too.

Ternary planes whose group count is not a multiple of 8 (TQ1_0 and TQ2_0 at
K = 1024, G = 4, and K = 11008, G = 43) run K6 and K8 on planes padded to 8
groups (kernels.padded_il_planes, once a tensor): held against their plain
versions at B = 1 and 512 and in K8 with the iq1 and ternary shapes (phase
8).  Near the end, before the kernels line, one line a configuration sums
its requests' TTFT and decode rate and its profiled prefill and decode
step (host and device ms, the device's idle share).

K6 at B <= 8 and K8 are one launch a call (csrc/fast_il.cu il_gemv_kernel,
the eleventh slice), and so is K7 (csrc/fast_dual.cu il_dual_kernel, the
same body over two plane sets): every configuration's profiled decode
steps hold them to exactly one il_gemv_kernel a K6/K8 call and one
il_dual_kernel a K7 call of the step's table, with no pre-pass kernel; the
8B IQ4_XS and Q4_K_M il configurations also sum their 8-token bucket's K6
mix at B = 8.  K12 is one launch a call too (a cluster a row and KV head,
merged through distributed shared memory): the conformance phase profiles
its cases once more and holds them to exactly one K12 kernel each.

Any failure raises: the script exits non-zero and prints no result.  The
last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their times and bounds.  Card rates for the bounds: the H100
SXM data sheet (3.35 TB/s HBM3, 989 TFLOP/s bf16, 1979 TOP/s int8, 495
TFLOP/s TF32 dense, 67 TFLOP/s f32).
"""
import gc
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

HBM_BPS = 3.35e12
BF16_OPS = 989e12
INT8_OPS = 1979e12
F32_OPS = 67e12      # float32 outside the tensor cores (K10's f32 GEMV)
TF32_OPS = 495e12    # TF32 tensor cores (K11: three products a multiply-add
                     # for f32 inputs, two for bf16; K10's f32 GEMM three)
NMSE_LOGITS = 5e-4   # logits, kernels vs plain versions, end to end
NMSE_KERNEL = 1e-6   # K1-K3, K5, K6 vs plain: same integer/f32/bf16
                     # products, f32 sums in another order
NMSE_K10_F32 = 1e-10  # K10 in f32 vs plain: f32 products (the GEMV's
                      # fmaf; the GEMM's three TF32 products, about 2^-21
                      # relative), f32 sums in another order; a kernel of
                      # one or two TF32 products misses it (tf32_controls)
ATTN_MAX_ABS = 1e-4  # K4 vs plain: f32 throughout, another order and expf
FLIP_MARGIN = 1e-3   # a routing flip between kernel and plain runs must be
                     # a near-tie: top-k-th minus next probability below this

#: the port's kernel sources and the TPU kernels they replace
SRC_GEMV = "ggml_hexagon_tpu_torch/csrc/qp8_gemv.cu"
SRC_GEMM = "ggml_hexagon_tpu_torch/csrc/qp8_gemm.cu"
SRC_IL = "ggml_hexagon_tpu_torch/csrc/fast_il.cu"
SRC_DUAL = "ggml_hexagon_tpu_torch/csrc/fast_dual.cu"
SRC_IL_GEMM = "ggml_hexagon_tpu_torch/csrc/fast_il_gemm.cu"
K6_BYTE = "ggml_hexagon_tpu/ops/qmm_fast.py:510"
K6_NIBBLE = "ggml_hexagon_tpu/ops/qmm_fast.py:497"
K7_DUAL = "ggml_hexagon_tpu/ops/qmm_fast.py:872"
K8_GATHER = "ggml_hexagon_tpu/ops/qmm_fast.py:1259"
SRC_FFN = "ggml_hexagon_tpu_torch/csrc/ffn_fused.cu"
K9_FFN = "ggml_hexagon_tpu/ops/ffn_fused.py:93"
SRC_WIRE = "ggml_hexagon_tpu_torch/csrc/qmm_wire.cu"
SRC_WIRE_GEMM = "ggml_hexagon_tpu_torch/csrc/qmm_wire_gemm.cu"
SRC_ATTN = "ggml_hexagon_tpu_torch/csrc/attention.cu"
K10_WIRE = "ggml_hexagon_tpu/ops/qmatmul.py:203"
K11_FLASH = "ggml_hexagon_tpu/ops/attention.py:81"
K12_GQA = "ggml_hexagon_tpu/ops/attention.py:206"


def log(*a):
    print(*a, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase(name, dev):
    """Start a phase: reset the peak-memory counter."""
    log(f"== {name}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return time.perf_counter()


def phase_end(name, dev, t0):
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured (CPU)")
    log(f"   {name}: {time.perf_counter() - t0:.1f} s, peak device memory "
        f"{peak}")


def bound_ms(nbytes, ops, peak):
    return max(nbytes / HBM_BPS, ops / peak) * 1e3, (
        "bytes" if nbytes / HBM_BPS >= ops / peak else "operations")


def nmse(got, want):
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).mean() / ((want ** 2).mean() + 1e-30))


_FLUSH = None


def _flush_l2():
    """Overwrite the 50 MB L2: the main path streams each weight from HBM
    once per step, so a kernel is timed with a cold cache."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
    _FLUSH.zero_()


def _median_event_ms(run, iters):
    times = []
    for _ in range(iters):
        _flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_ms(fn, iters=20):
    """Device time of fn: captured once in a CUDA graph and replayed, so
    the host's launch overhead is not in the number; median over
    iterations, each after an L2 flush, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _median_event_ms(graph.replay, iters)
    del graph
    return ms


def time_plain_ms(fn, iters=3):
    """Plain versions: CUDA events around the eager call (they run for
    milliseconds; they repeat the kernel's arithmetic, no yardstick)."""
    fn()
    return _median_event_ms(fn, iters)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def plane_bytes(qt):
    return nbytes(qt.fq, qt.fs, qt.fb)


def held(what, got, want, limit=NMSE_KERNEL):
    """Kernel against plain version: (max |d|, NMSE), or raise past
    limit or on a non-finite output."""
    torch.cuda.synchronize()
    err, e2 = float((got - want).abs().max()), nmse(got, want)
    if not (e2 <= limit and torch.isfinite(got).all()):
        raise AssertionError(f"{what}: nmse {e2}")
    return err, e2


def deq_t(qt):
    """bf16 [K, n2] weight in natural order (the yardstick's operand)."""
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    return PF.dequantize_fast(qt, torch.bfloat16).t().contiguous()


def bias_ops(qt, rows):
    """Operations of the group-bias dot on `rows` activation rows."""
    return 2 * rows * qt.fs.shape[1] * qt.fs.shape[0] if (
        qt.fb is not None or qt.cfg.offset) else 0


class KernelReport:
    """Per-kernel sums over the main path's launch mix (counts x shape)."""

    def __init__(self, name, route, source, replaces, per):
        self.d = dict(name=name, route=route, source=source,
                      replaces=replaces, launches=0, max_abs_err=0.0, ms=0.0,
                      plain_ms=0.0, bound_ms=0.0, bound_by="bytes",
                      library_ms=None, per=per)
        self.bytes_ms = self.ops_ms = 0.0
        self.launches = None  # set where the unit counts its own launches

    def add(self, count, err, ms, plain, nbytes_, ops, peak, lib=None):
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], err)
        d["ms"] += count * ms
        d["plain_ms"] += count * plain
        self.bytes_ms += count * nbytes_ / HBM_BPS * 1e3
        self.ops_ms += count * ops / peak * 1e3
        d["bound_ms"] = max(self.bytes_ms, self.ops_ms)
        d["bound_by"] = "bytes" if self.bytes_ms >= self.ops_ms else "operations"
        if lib is not None:
            d["library_ms"] = (d["library_ms"] or 0.0) + count * lib


def check_kernels(dev, weights, cfg):
    """Each kernel against its plain version at the main path's shapes."""
    from ggml_hexagon_tpu_torch.ops import decode_attn as PD
    from ggml_hexagon_tpu_torch.ops.basic import rope_freqs

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    layers = weights["layers"]
    full = next(lw for lw in layers if "wqkv" in lw)
    mixed = next(lw for lw in layers if "wqk" in lw)
    n_full = sum("wqkv" in lw for lw in layers)
    n_mixed = len(layers) - n_full
    dn_q4 = next(lw["ffn_down"] for lw in layers
                 if lw["ffn_down"].cfg.qtype.name == "Q4_K")
    dn_q6 = next(lw["ffn_down"] for lw in layers
                 if lw["ffn_down"].cfg.qtype.name == "Q6_K")
    n_dn_q6 = sum(lw["ffn_down"].cfg.qtype.name == "Q6_K" for lw in layers)
    head = weights["output"]
    K1 = KernelReport("qp8_gemv", "cuda", SRC_GEMV,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
                      "one decode step (B=1): 113 launches")
    K2 = KernelReport("qp8_dual", "cuda", SRC_GEMV,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:475",
                      "one decode step (B=1): 16 launches")
    K3 = KernelReport("qp8_gemm", "cuda", SRC_GEMM,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:529",
                      "one 512-token prefill chunk: 145 launches")
    K4 = KernelReport("decode_attn", "cuda", "ggml_hexagon_tpu_torch/csrc/decode_attn.cu",
                      "ggml_hexagon_tpu/ops/decode_attn.py:177",
                      "one decode step at pos 700 of 1024 (B=1): 32 launches")

    log(f"K1 qp8_gemv (kernel vs plain, NMSE <= {NMSE_KERNEL}; times are "
        "medians, L2 flushed)")
    for name, qt, mode, per_step in (
            ("wqkv", full["wqkv"], "normed", n_full),
            ("wo", full["wo"], "res", len(layers)),
            ("gate_up", full["w_gateup_il"], "normed", len(layers)),
            ("down_q4k", dn_q4, "act", len(layers) - n_dn_q6),
            ("down_q6k", dn_q6, "act", n_dn_q6), ("head_q6k", head, "raw", 1)):
        for B in (1, 8):
            k1_row(dev, gen, cfg, K1 if B == 1 else None, name, qt, mode, B,
                   per_step)
    log(f"K2 qp8_dual (NMSE <= {NMSE_KERNEL})")
    for B in (1, 4):
        dual_row(dev, gen, cfg, K2 if B == 1 else None, mixed["wqk"],
                 mixed["wv"], B, n_mixed)
    log(f"K3 qp8_gemm (M=512, NMSE <= {NMSE_KERNEL})")
    for name, qt, count in (
            ("wqkv", full["wqkv"], n_full), ("wqk", mixed["wqk"], n_mixed),
            ("wv", mixed["wv"], n_mixed), ("wo", full["wo"], len(layers)),
            ("gate_up", full["w_gateup_il"], len(layers)),
            ("down_q4k", dn_q4, len(layers) - n_dn_q6),
            ("down_q6k", dn_q6, n_dn_q6), ("head_q6k", head, 1)):
        k3_row(dev, gen, K3, name, qt, count)
    log(f"K3 qp8_gemm at the 32- and 128-token prefill buckets (NMSE <= "
        f"{NMSE_KERNEL})")
    for M in (32, 128):
        for name, qt in (("gate_up", full["w_gateup_il"]), ("down_q4k", dn_q4),
                         ("down_q6k", dn_q6)):
            k3_row(dev, gen, None, name, qt, 0, M=M)

    log(f"K4 decode_attn (S=1024, max|d| <= {ATTN_MAX_ABS})")
    Hq, Hkv, D, S = cfg.n_head, cfg.n_head_kv, cfg.hd, 1024
    for quant in (False, True):
        for B in (1, 4):
            for pos in (0, 1, 700, S - 1):
                qkv = randn(B, (Hq + 2 * Hkv) * D)
                if quant:
                    kc = torch.randint(-127, 128, (B, S, Hkv * D), device=dev,
                                       dtype=torch.int8, generator=gen)
                    vc = torch.randint(-127, 128, (B, S, Hkv * D), device=dev,
                                       dtype=torch.int8, generator=gen)
                    ks = torch.rand(B, S, device=dev, generator=gen) * 0.02
                    vs = torch.rand(B, S, device=dev, generator=gen) * 0.02
                else:
                    kc = randn(B, S, Hkv * D).to(torch.bfloat16)
                    vc = randn(B, S, Hkv * D).to(torch.bfloat16)
                    ks = vs = None
                posb = torch.full((B,), pos, dtype=torch.int32, device=dev)
                inv, ms_ = rope_freqs(cfg.rope_params, dev)
                ang = posb[:, None].float() * inv[None]
                cs = (torch.cat([torch.cos(ang), torch.sin(ang)], 1) * ms_).contiguous()
                kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5, k_scale=ks,
                          v_scale=vs)
                got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
                want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                e2 = nmse(torch.cat(got, 1), torch.cat(want, 1))
                if not err <= ATTN_MAX_ABS:
                    raise AssertionError(f"K4 quant={quant} B={B} pos={pos}: {err}")
                ms = time_ms(lambda: PD.decode_attn(qkv, kc, vc, posb, cs, **kw))
                pms = time_plain_ms(
                    lambda: PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw))
                lib = None
                if not quant:
                    q4 = qkv[:, :Hq * D].reshape(B, Hq, 1, D).to(torch.bfloat16)
                    k4 = kc[:, :pos + 1].reshape(B, pos + 1, Hkv, D).transpose(1, 2)
                    v4 = vc[:, :pos + 1].reshape(B, pos + 1, Hkv, D).transpose(1, 2)
                    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, enable_gqa=True))
                elt = 1 if quant else 2
                byts = (nbytes(qkv, cs, *got) + 2 * B * pos * Hkv * D * elt
                        + (2 * B * pos * 4 if quant else 0))
                ops = 4 * B * (pos + 1) * Hq * D
                bms, by = bound_ms(byts, ops, BF16_OPS)
                log(f"  {'int8' if quant else 'bf16'} B={B} pos={pos:4d} "
                    f"max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms "
                    f"plain={pms:.3f}ms sdpa={'n/a' if lib is None else f'{lib:.4f}ms'} "
                    f"bound={bms:.5f}ms ({by})")
                if B == 1 and pos == 700 and not quant:
                    K4.add(len(layers), err, ms, pms, byts, ops, BF16_OPS, lib)
    return [K1, K2, K3, K4]


#: (KV type, prompt tokens, tokens generated), each on a fresh Engine
REQUESTS = [("bf16", 512, 32), ("bf16", 128, 32), ("bf16", 7, 16),
            ("q8_0", 512, 32)]


#: exact launches of each configuration per unit: "step" a decode step,
#: "bucket8" the 8-token prefill chunk, "chunk" a 128- or 512-token chunk.
#: Derived from the JAX dispatch (llama.py:620-799, 1022-1068, 1196-1213;
#: qmm_fast.py supports_dual, supports_fused_epilogue, supports_indirect)
#: under each configuration's QuantPolicy.
LAUNCH_TABLES = {
    # wqkv (16 layers) or wqk + wv through K2 (16), wo+res, gate_up, act +
    # down, the head: all t-planes (K1 at <= 8 rows, K3 above)
    "Llama-3-8B Q4_K_M": {
        "step": dict(qp8_gemv=113, qp8_dual=16, decode_attn=32),
        "bucket8": dict(qp8_gemv=145),
        "chunk": dict(qp8_gemm=145),
    },
    # wq, wo and the head on Q5_K/Q6_K t-planes; wk, wv on Q8_0 interleaved
    # planes (K6); the experts gathered at <= 8 rows (K5: gate, up, down),
    # else every expert's gate, up and down through K3
    "Mixtral-8x7B Q5_K_M": {
        "step": dict(qp8_gemv=65, qp8_indirect=96, fast_byte=64,
                     decode_attn=32),
        "bucket8": dict(qp8_gemv=65, qp8_indirect=96, fast_byte=64),
        "chunk": dict(qp8_gemm=833, fast_byte=64),
    },
    # wqk IQ4_XS il + wv Q5_K t (no dual on mixed layouts): 32 K6 normed +
    # 32 K1 normed; wo IQ4_XS il: 32 K6 res; gate_up IQ4_XS il: 32 K6
    # normed; down Q5_K t in layers 0-3 (K1 act) and IQ4_XS il in 4-31 (K6
    # act); the Q6_K head on K1
    "Llama-3-8B IQ4_XS": {
        "step": dict(fast_byte_normed=64, fast_byte_res=32, fast_byte_act=28,
                     qp8_gemv=37, decode_attn=32),
        "bucket8": dict(fast_byte_normed=64, fast_byte=32, fast_byte_act=28,
                        qp8_gemv=37),
        "chunk": dict(fast_byte_normed=64, fast_byte=60, qp8_gemm=37),
    },
    # wq IQ4_XS, wk/wv Q8_0, all il and unfused: 96 K6; wo Q5_K and the
    # head on K1/K3; gate/up IQ4_XS stacks (K8) and down stacks Q5_K in
    # layers 0-3 (K5) and IQ4_XS in 4-31 (K8) gathered at <= 8 rows, every
    # expert's gate, up and down through K6 / K3 above
    "Mixtral-8x7B IQ4_XS": {
        "step": dict(fast_byte=96, fast_indirect=92, qp8_indirect=4,
                     qp8_gemv=33, decode_attn=32),
        "bucket8": dict(fast_byte=96, fast_indirect=92, qp8_indirect=4,
                        qp8_gemv=33),
        "chunk": dict(fast_byte=832, qp8_gemm=65),
    },
    # the interleaved layout everywhere: wqkv (16 layers, Q4_K) and gate_up
    # through K6 nibble normed, wqk Q4_K + wv Q6_K through K7 (16), wo
    # through K6 nibble res; down Q4_K (16) K6 nibble act, Q6_K (16) K6
    # byte act with the derived bias; the Q6_K head K6 byte.  At prefill no
    # dual: wqk K6 nibble normed and wv K6 byte normed, wo K6 nibble; at the
    # 8-bucket the act modes, above it down pre-interleaved through K6
    "Llama-3-8B Q4_K_M il": {
        "step": dict(fast_nibble_normed=48, fast_nibble_res=32,
                     fast_nibble_act=16, fast_byte_act=16, fast_byte=1,
                     fast_dual=16, decode_attn=32),
        "bucket8": dict(fast_nibble_normed=64, fast_byte_normed=16,
                        fast_nibble=32, fast_nibble_act=16, fast_byte_act=16,
                        fast_byte=1),
        "chunk": dict(fast_nibble_normed=64, fast_byte_normed=16,
                      fast_nibble=48, fast_byte=17),
    },
    # wq Q4_K K6 nibble, wk/wv Q8_0 and the Q6_K head K6 byte, wo Q5_K K6
    # byte res (stored bias; plain mode above one token); gate/up Q4_K
    # stacks and down stacks Q4_K (16 layers) through K8 nibble, Q6_K (16)
    # through K8 byte, at <= 8 rows; every expert's gate, up and down through
    # K6 above
    "Mixtral-8x7B Q4_K_M il": {
        "step": dict(fast_nibble=32, fast_byte=65, fast_byte_res=32,
                     fast_indirect_nibble=80, fast_indirect=16,
                     decode_attn=32),
        "bucket8": dict(fast_nibble=32, fast_byte=97,
                        fast_indirect_nibble=80, fast_indirect=16),
        "chunk": dict(fast_nibble=672, fast_byte=225),
    },
    # the coded i-quants (IQ3_XXS with an imatrix) on t-planes: IQ2_S wqk +
    # Q4_K wv through K2 at decode (at prefill one normed K1/K3 each), IQ3_S
    # wo (K1 res), IQ3_XXS gate_up (normed) and down (act), all coded; the
    # Q5_K head on K1 (K3 above the 8-bucket)
    "Llama-3-8B IQ3_XXS": {
        "step": dict(qp8_dual_coded=32, qp8_gemv_coded=96, qp8_gemv=1,
                     decode_attn=32),
        "bucket8": dict(qp8_gemv_coded=128, qp8_gemv=33),
        "chunk": dict(qp8_gemm_coded=128, qp8_gemm=33),
    },
    # the same on interleaved planes: K7 on the coded wqk + the Q4_K nibble
    # wv, K6 coded res / normed / act; at prefill wqk K6 coded normed, wv K6
    # nibble normed, wo K6 coded, down K6 coded act (8-bucket) or
    # pre-interleaved (chunk); the Q5_K head K6 byte with its stored bias
    "Llama-3-8B IQ3_XXS il": {
        "step": dict(fast_dual_coded=32, fast_coded_res=32,
                     fast_coded_normed=32, fast_coded_act=32, fast_byte=1,
                     decode_attn=32),
        "bucket8": dict(fast_coded_normed=64, fast_nibble_normed=32,
                        fast_coded=32, fast_coded_act=32, fast_byte=1),
        "chunk": dict(fast_coded_normed=64, fast_nibble_normed=32,
                      fast_coded=64, fast_byte=1),
    },
    # IQ2_S wq K6 coded, Q8_0 wk/wv and the Q5_K head K6 byte, Q5_K wo K6
    # byte res (plain mode above one token); the IQ3_XXS stacks through K8
    # coded at <= 8 rows, every expert's gate, up and down through K6 coded
    # above
    "Mixtral-8x7B IQ3_XXS il": {
        "step": dict(fast_coded=32, fast_byte=65, fast_byte_res=32,
                     fast_indirect_coded=96, decode_attn=32),
        "bucket8": dict(fast_coded=32, fast_byte=97, fast_indirect_coded=96),
        "chunk": dict(fast_coded=800, fast_byte=97),
    },
    # IQ2_S wq on coded t-planes (K1 / K3), Q8_0 wk/wv K6 byte, Q5_K wo and
    # head K1 / K3; the IQ3_XXS stacks through K5 coded at <= 8 rows, every
    # expert through K3 coded above
    "Mixtral-8x7B IQ3_XXS": {
        "step": dict(qp8_gemv_coded=32, qp8_gemv=33, fast_byte=64,
                     qp8_indirect_coded=96, decode_attn=32),
        "bucket8": dict(qp8_gemv_coded=32, qp8_gemv=33, fast_byte=64,
                        qp8_indirect_coded=96),
        "chunk": dict(qp8_gemm_coded=800, qp8_gemm=33, fast_byte=64),
    },
    # the interleaved layout with the megakernel layout on every layer: at
    # decode one K9 a layer (down Q4_K in 16 layers, Q6_K in 16) after wqkv
    # (K6 nibble normed, 16) or wqk + wv (K7, 16) and K4; the Q6_K head K6
    # byte.  At prefill no K9 and no act mode, at any bucket: wo K6 nibble
    # (its output un-permuted), gate_up K6 nibble normed, down K6
    # pre-interleaved (nibble 16, byte 16)
    "Llama-3-8B Q4_K_M il ffn": {
        "step": dict(ffn_fused_nibble=16, ffn_fused_byte=16,
                     fast_nibble_normed=16, fast_dual=16, fast_byte=1,
                     decode_attn=32),
        "bucket8": dict(fast_nibble_normed=64, fast_byte_normed=16,
                        fast_nibble=48, fast_byte=17),
        "chunk": dict(fast_nibble_normed=64, fast_byte_normed=16,
                      fast_nibble=48, fast_byte=17),
    },
}


#: exact K6 GEMM launches (kernels.GEMM_LAUNCHES) of each configuration's
#: 128- or 512-token prefill chunk, from its "chunk" entry above: the K6
#: launches of more than 8 rows by family and bias (the prefill takes the
#: head's logits on every row of the chunk); none at decode or the
#: 8-bucket
GEMM_TABLES = {
    "Mixtral-8x7B Q5_K_M": dict(fast_byte_gemm=64),            # wk, wv Q8_0
    "Llama-3-8B IQ4_XS": dict(fast_byte_gemm=124),             # IQ4_XS
    "Mixtral-8x7B IQ4_XS": dict(fast_byte_gemm=832),           # and Q8_0
    # wqkv, wqk, gate_up, wo, down Q4_K; wv, down and the head Q6_K
    "Llama-3-8B Q4_K_M il": dict(fast_nibble_gemm_stored=112,
                                 fast_byte_gemm_derived=33),
    # wq and the Q4_K experts; wk, wv Q8_0; wo Q5_K; the Q6_K down experts
    # and head
    "Mixtral-8x7B Q4_K_M il": dict(fast_nibble_gemm_stored=672,
                                   fast_byte_gemm=64,
                                   fast_byte_gemm_stored=32,
                                   fast_byte_gemm_derived=129),
    # wqk, gate_up, wo, down; wv Q4_K; the Q5_K head
    "Llama-3-8B IQ3_XXS il": dict(fast_coded_gemm=128,
                                  fast_nibble_gemm_stored=32,
                                  fast_byte_gemm_stored=1),
    # wq and the experts; wk, wv Q8_0; wo and the head Q5_K
    "Mixtral-8x7B IQ3_XXS il": dict(fast_coded_gemm=800, fast_byte_gemm=64,
                                    fast_byte_gemm_stored=33),
    "Mixtral-8x7B IQ3_XXS": dict(fast_byte_gemm=64),           # wk, wv Q8_0
    "Llama-3-8B Q4_K_M il ffn": dict(fast_nibble_gemm_stored=112,
                                     fast_byte_gemm_derived=33),
}


def want_launches(table, rows, step):
    """The exact launches of one forward over `rows` tokens (a decode step
    when `step`), all kernels, from a LAUNCH_TABLES entry."""
    from ggml_hexagon_tpu_torch import kernels

    unit = "step" if step else ("bucket8" if rows <= 8 else "chunk")
    c = dict.fromkeys(kernels.LAUNCHES, 0)
    c.update(table[unit])
    return c


def serve(dev, cfg, weights, name):
    """The main path: greedy requests through Engine, each prefill chunk
    and decode step held to its exact launch counts (the LAUNCH_TABLES
    entry of configuration `name`, and its GEMM_TABLES entry for K6's GEMM);
    returns the launch counts of the whole run (K6's GEMM under its
    GEMM_LAUNCHES keys), zeroed just before it, after checking that every
    kernel of the tables ran."""
    table = LAUNCH_TABLES[name]
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.runtime.engine import PREFILL_BUCKETS, Engine

    rng = np.random.default_rng(0)
    gemm_table = GEMM_TABLES.get(name, {})
    kernels.reset_launches()
    for kv, n_prompt, n_gen in REQUESTS:
        eng = Engine(cfg, weights, max_seq=1024, kv_dtype=kv, device=dev)
        prompt = rng.integers(0, cfg.n_vocab, n_prompt)
        before = dict(kernels.LAUNCHES)
        gemm_before = dict(kernels.GEMM_LAUNCHES)
        sync(dev)
        t0 = time.perf_counter()
        logits = eng.prefill(prompt[None])
        ttft = time.perf_counter() - t0
        pre = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if logits.shape != (1, cfg.n_vocab) or not np.isfinite(logits).all():
            raise AssertionError(f"prefill logits {logits.shape} not finite")
        bucket = next(b for b in PREFILL_BUCKETS if b >= n_prompt)
        want_pre = want_launches(table, bucket, step=False)
        if pre != want_pre:
            raise AssertionError(f"prefill launches {pre} != {want_pre}")
        gemm = {k: v - gemm_before[k] for k, v in kernels.GEMM_LAUNCHES.items()}
        want_gemm = dict.fromkeys(gemm, 0)
        if bucket > 8:
            want_gemm.update(gemm_table)
        if gemm != want_gemm:
            raise AssertionError(f"prefill K6 GEMM launches {gemm} != {want_gemm}")
        toks = [int(np.argmax(logits[0]))]
        mid = dict(kernels.LAUNCHES)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_gen - 1):
            lg = eng.decode_one(np.array([toks[-1]]))
            if not np.isfinite(lg).all():
                raise AssertionError("decode logits not finite")
            toks.append(int(np.argmax(lg[0])))
        dt = time.perf_counter() - t0
        dec = {k: kernels.LAUNCHES[k] - mid[k] for k in mid}
        if any(kernels.GEMM_LAUNCHES[k] != v + gemm[k]
               for k, v in gemm_before.items()):
            raise AssertionError("K6's GEMM launched at decode")
        steps = n_gen - 1
        want_dec = {k: v * steps for k, v in
                    want_launches(table, 1, step=True).items()}
        if dec != want_dec:
            raise AssertionError(f"decode launches {dec} != {want_dec}")
        per = {k: v // steps for k, v in dec.items() if v}
        SUMMARY.setdefault(name, {})[f"{kv} p{n_prompt}"] = (
            f"TTFT {ttft * 1e3:.1f} ms, {steps / dt:.2f} tok/s")
        log(f"  request kv={kv} prompt={n_prompt} gen={n_gen}: "
            f"TTFT {ttft * 1e3:.1f} ms, decode {steps / dt:.2f} tok/s "
            f"({dt / steps * 1e3:.2f} ms/step), prefill launches "
            f"{ {k: v for k, v in pre.items() if v} }, launches per decode "
            f"step {per}, tokens {toks[:8]}...")
        del eng
    counts = {**kernels.LAUNCHES, **kernels.GEMM_LAUNCHES}
    missing = [k for unit in (*table.values(), gemm_table) for k in unit
               if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts


def _device_ms(avgs, n):
    """Device (kernel) time per call from a profiler run of n calls (its
    key_averages), and the top kernels by device time; (None, []) when the
    trace holds none.  The schedule's ProfilerStep ranges are left out:
    their device time spans a whole step, idle gaps included."""
    rows = []
    for e in avgs:
        if e.key.startswith("ProfilerStep"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / n / 1e3, e.count // n, e.key))
    if not rows:
        return None, []
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:8]


#: the pre-pass kernels K7 launched before its one-launch redesign (the
#: interleave or the norm, and the group sums): none may appear
IL_PREPASS = ("interleave_kernel", "normed_kernel", "group_sums_kernel")


def window_kernels(events, names, n):
    """Device records of the kernels `names` (substrings of their names)
    in the last n ProfilerStep ranges of a profiler window (its events()):
    a kernel counts where it starts inside one of those steps, each of
    which waits for its kernels (the logits come back to the host), so a
    record of the warm-up step traced before them is left out."""
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name.startswith("ProfilerStep") and "CPU" in str(e.device_type))[-n:]
    if len(steps) != n:
        raise AssertionError(f"the profiler window holds {len(steps)} steps, not {n}")
    seen = dict.fromkeys(names, 0)
    for e in events:
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = e.time_range.start
        if not any(lo <= t <= hi for lo, hi in steps):
            continue
        for name in names:
            if name in e.name:
                seen[name] += 1
    return seen


def il_kernel_counts(events, table, n):
    """In a profiler window of n decode steps (its events(), after a
    warm-up step traced and dropped): the il_gemv_kernel, il_dual_kernel
    and ffn_kernel records inside the steps (window_kernels), and whether
    they are exactly one a K6 (B <= 8) or K8 call, one a K7 call and one a
    K9 call of the step's table (`fast_*`, `fast_dual*`, `ffn_fused_*`
    keys), with no pre-pass kernel and, in a step that runs K9, no memset
    (K9 resets its counters on the card).  More raises at once: a launch
    the path should not make shows in every window.  Fewer is a window
    whose tracer lost records (CUPTI drops a few of a long window now and
    then), to be traced again."""
    step = table["step"]
    k7 = sum(v for k, v in step.items() if k.startswith("fast_dual"))
    il = sum(v for k, v in step.items() if k.startswith("fast_")) - k7
    k9 = sum(v for k, v in step.items() if k.startswith("ffn_fused"))
    seen = window_kernels(events, ("il_gemv_kernel", "il_dual_kernel", "ffn_kernel",
                                   "Memset") + IL_PREPASS, n)
    pre = sum(seen[k] for k in IL_PREPASS) + (seen["Memset"] if k9 else 0)
    want = (f"want {il * n} il_gemv_kernel, {k7 * n} il_dual_kernel, "
            f"{k9 * n} ffn_kernel and no pre-pass kernel"
            + (" or memset" if k9 else ""))
    if (seen["il_gemv_kernel"] > il * n or seen["il_dual_kernel"] > k7 * n
            or seen["ffn_kernel"] > k9 * n or pre):
        raise AssertionError(f"{n} decode steps: kernels {seen}, {want}")
    return seen, (seen["il_gemv_kernel"] == il * n
                  and seen["il_dual_kernel"] == k7 * n
                  and seen["ffn_kernel"] == k9 * n), want


def profile_path(dev, cfg, weights, table, name, kvs=("bf16", "q8_0")):
    """Where the time goes: host time vs device kernel time of a 512-token
    prefill and of decode steps at pos ~512 (torch.profiler, CUPTI), and
    the decode steps' K6/K8 kernels held to one launch a call (table: the
    configuration's LAUNCH_TABLES entry), for each KV type of kvs; both
    into SUMMARY[name]."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from ggml_hexagon_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(2).integers(0, cfg.n_vocab, 512)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for kv in kvs:
        eng = Engine(cfg, weights, max_seq=1024, kv_dtype=kv, device=dev)
        eng.prefill(prompt[None])          # warm
        eng.reset()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits = eng.prefill(prompt[None])
            host = (time.perf_counter() - t0) * 1e3
        dev_ms, top = _device_ms(prof.key_averages(), 1)
        pre_txt = (f"prefill 512 host/device {host:.2f}/"
                   f"{'not measured' if dev_ms is None else f'{dev_ms:.2f}'} ms")
        log(f"  kv={kv} prefill 512: host {host:.2f} ms, device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.2f} ms'}")
        for ms, cnt, key in top[:5]:
            log(f"      {ms:8.3f} ms  x{cnt:<4d} {key[:90]}")
        tok = int(np.argmax(logits[0]))
        for _ in range(3):                  # warm
            tok = int(np.argmax(eng.decode_one(np.array([tok]))[0]))
        # each window traces one more step first and drops it (the tracer
        # can lose a window's first records); the counts must be exact in
        # one of three windows
        n = 5
        for attempt in range(3):
            got = []
            torch.cuda.synchronize()
            with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=n),
                         on_trace_ready=lambda p: got.append((p.key_averages(),
                                                           p.events()))) as prof:
                tok = int(np.argmax(eng.decode_one(np.array([tok]))[0]))
                torch.cuda.synchronize()
                prof.step()
                t0 = time.perf_counter()
                for i in range(n):
                    tok = int(np.argmax(eng.decode_one(np.array([tok]))[0]))
                    if i == n - 1:
                        host = (time.perf_counter() - t0) * 1e3 / n
                    prof.step()
            if len(got) != 1:
                raise AssertionError(f"the decode profile gave {len(got)} windows")
            dev_ms, top = _device_ms(got[0][0], n)
            if dev_ms is None:
                break
            seen, exact, want = il_kernel_counts(got[0][1], table, n)
            if exact:
                break
            log(f"  kv={kv} decode window {attempt + 1}: tracer lost records "
                f"({seen}, {want}); tracing again")
        else:
            raise AssertionError(f"{n} decode steps, three windows: kernels "
                                 f"{seen}, {want}")
        if dev_ms is not None:
            log(f"  kv={kv} decode, per step: {seen['il_gemv_kernel'] // n} "
                f"il_gemv_kernel (one a K6/K8 call), "
                f"{seen['il_dual_kernel'] // n} il_dual_kernel (one a K7 "
                f"call), {seen['ffn_kernel'] // n} ffn_kernel (one a K9 "
                f"call), no pre-pass kernel, {seen['Memset'] // n} memsets")
        idle = "not measured" if dev_ms is None else f"{1 - dev_ms / host:.1%}"
        SUMMARY.setdefault(name, {})[f"{kv} profile"] = (
            f"{pre_txt}; decode step host/device {host:.3f}/"
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f}'} ms, "
            f"idle {idle}")
        log(f"  kv={kv} decode step at pos ~{eng.n_past}: host {host:.2f} ms, "
            f"device {'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, "
            f"device idle share {idle}")
        for ms, cnt, key in top:
            log(f"      {ms:8.4f} ms  x{cnt:<4d} {key[:90]}")
        del eng


def _routing_flips(ra, rb, k):
    """(layer, (b, t), experts a, experts b, margin a, margin b) for every
    token whose top-k experts differ between two runs; the margin is the
    k-th minus the (k+1)-th router probability of that run."""
    flips = []
    for il, ((pa, ia), (pb, ib)) in enumerate(zip(ra, rb)):
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        for idx in diff.nonzero().tolist():
            sa = pa[tuple(idx)].sort(descending=True).values
            sb = pb[tuple(idx)].sort(descending=True).values
            flips.append((il, tuple(idx), ia[tuple(idx)].tolist(),
                          ib[tuple(idx)].tolist(), float(sa[k - 1] - sa[k]),
                          float(sb[k - 1] - sb[k])))
    return flips


def compare_plain(dev, cfg, weights, n_prompt=128, n_steps=4):
    """Kernels against plain versions end to end on the card: a prefill of
    n_prompt tokens and n_steps decode steps through two engines in
    lockstep.  Before each decode step the plain engine takes a copy of the
    kernel engine's cache, and inside each step every layer of the plain
    run starts from the kernel run's input to that layer
    (llama.LAYER_HOOK).  So each layer runs on the same input in both
    routes, and what the layers add to the residual stream (all layers'
    outputs of the step, one NMSE) agrees to NMSE_LOGITS, as do the logits
    of the head on the same final state; the worst single layer is
    reported.  Free-running, the two routes part by the
    int8 and bf16 rounding of the activations, which many layers amplify
    (PERF.md); that NMSE is reported for the prefill, not held, beside the
    plain route against itself with one bf16 ulp moved.  MoE models
    record the routing of both runs: a token routed differently must be a
    near-tie, its margin (the k-th minus the (k+1)-th router probability)
    below FLIP_MARGIN in both runs; its layer is then held on the other
    tokens."""
    from ggml_hexagon_tpu_torch.models import llama as L
    from ggml_hexagon_tpu_torch.runtime.engine import Engine

    moe = "ffn_gate_inp" in weights["layers"][0]
    prompt = np.random.default_rng(1).integers(0, cfg.n_vocab, n_prompt)

    def run(eng, feed, force=None, bump=False):
        """-> (logits, routing per layer, (h_in, h_out) per layer); with
        `force`, each layer's output is replaced by force's; with `bump`,
        one element of the first token's residual after layer 0 moves by
        one bf16 ulp."""
        routes = [] if moe else None
        layers = []

        def hook(il, h_in, h_out):
            layers.append((h_in, h_out))
            if bump and il == 0:
                h_out = h_out.clone()
                bits = h_out[0, 0, 7:8].view(torch.int16)
                h_out[0, 0, 7:8] = (bits + 1).view(torch.bfloat16)
            return h_out if force is None else force[il][1]

        L.MOE_ROUTING, L.LAYER_HOOK = routes, hook
        try:
            out = feed(eng)
        finally:
            L.MOE_ROUTING = L.LAYER_HOOK = None
        return out, [(p.float().cpu(), t.cpu()) for p, t in routes or []], layers

    def engine(kv, plain):
        return Engine(cfg, weights, max_seq=1024, kv_dtype=kv, device=dev,
                      plain=plain)

    for kv in ("bf16", "q8_0"):
        ek, ep = engine(kv, False), engine(kv, True)
        tok = None
        for i in range(n_steps + 1):
            if i == 0:
                def feed(eng):
                    return eng.prefill(prompt[None])
            else:
                ep.kv = {k: v.clone() for k, v in ek.kv.items()}

                def feed(eng, t=tok):
                    return eng.decode_one(np.array([t]))
            a, ra, lk = run(ek, feed)
            b, rb, lp = run(ep, feed, force=lk)
            tok = int(np.argmax(a[0]))
            flips = _routing_flips(ra, rb, cfg.n_expert_used) if moe else []
            for il, where, ea, eb, ma, mb in flips:
                log(f"  kv={kv} step {i}: routing flip layer {il} token "
                    f"{where}: kernel {ea} plain {eb}, margin kernel {ma:.3e} "
                    f"plain {mb:.3e}")
                if not max(ma, mb) < FLIP_MARGIN:
                    raise AssertionError(
                        f"routing flip at layer {il} token {where} with margin "
                        f"{max(ma, mb):.3e} >= {FLIP_MARGIN}")
            errs, num, den = [], 0.0, 0.0
            for il, ((ki, ko), (_, po)) in enumerate(zip(lk, lp)):
                keep = torch.ones(ko.shape[:-1], dtype=torch.bool,
                                  device=ko.device)
                for _, where, *_ in (f for f in flips if f[0] == il):
                    keep[where] = False
                dk = (ko.double() - ki.double())[keep]
                dp = (po.double() - ki.double())[keep]
                num += float(((dp - dk) ** 2).sum())
                den += float((dk ** 2).sum())
                errs.append(nmse(dp, dk))
            e_layers = num / den
            worst = int(np.argmax(errs))
            e = nmse(torch.from_numpy(a), torch.from_numpy(b))
            noise = (f", router noise max |dp| "
                     f"{max(float((pa - pb).abs().max()) for (pa, _), (pb, _) in zip(ra, rb)):.1e}"
                     if moe else "")
            log(f"  kv={kv} step {i}: layer outputs nmse kernel vs plain "
                f"{e_layers:.3e} (per layer: worst {errs[worst]:.3e} at layer "
                f"{worst}, median {float(np.median(errs)):.3e}){noise}; "
                f"logits nmse {e:.3e}, max|d| {float(np.abs(a - b).max()):.3e}"
                f" (|logits| max {np.abs(b).max():.3e})")
            if not (e_layers <= NMSE_LOGITS and e <= NMSE_LOGITS):
                raise AssertionError(f"kernel vs plain nmse: layer outputs "
                                     f"{e_layers}, logits {e}")
            if i == 0:
                free, _, _ = run(engine(kv, True), feed)
                ctl, _, _ = run(engine(kv, True), feed, bump=True)
                log(f"  kv={kv} step 0 free-running (each route on its own "
                    f"layers' outputs): logits nmse kernel vs plain "
                    f"{nmse(torch.from_numpy(a), torch.from_numpy(free)):.3e}; "
                    f"plain vs plain with one bf16 ulp moved after layer 0 "
                    f"{nmse(torch.from_numpy(free), torch.from_numpy(ctl)):.3e} "
                    "(reported, not held)")
        del ek, ep


def check_kernels_moe(dev, weights, cfg):
    """K5, K6 and Q5_K K1/K3 against their plain versions at the Mixtral
    shapes of the main path; returns the K5 and K6 reports and logs the
    Mixtral sums of K1 per decode step and K3 per 512-token chunk."""
    from ggml_hexagon_tpu_torch.models.llama import qtensor_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    layers = weights["layers"]
    n_l, E = len(layers), cfg.n_expert
    nff, d = cfg.n_ff, cfg.n_embd

    def dn(lw):
        return lw["ffn_down_exps"].cfg.qtype.name

    lw6 = next(lw for lw in layers if dn(lw) == "Q6_K")
    lw5 = next((lw for lw in layers if dn(lw) == "Q5_K"), lw6)
    n_q6 = sum(dn(lw) == "Q6_K" for lw in layers)
    K5 = KernelReport("qp8_indirect", "cuda", SRC_GEMV,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:1022",
                      f"one Mixtral decode step (B=1, P=2): {3 * n_l} launches")
    K6 = KernelReport("fast_byte", "cuda", SRC_IL, K6_BYTE,
                      f"one Mixtral decode step (B=1): {2 * n_l} launches")
    M1 = KernelReport("qp8_gemv", "cuda", "", "", "Mixtral decode step")
    M3 = KernelReport("qp8_gemm", "cuda", "", "", "Mixtral 512-token chunk")

    log(f"K5 qp8_indirect (kernel vs plain, NMSE <= {NMSE_KERNEL})")
    for name, qt, npe, per_step in (
            ("gate_up_q5k", lw5["ffn_gate_exps"], nff, 2 * n_l),
            ("down_q5k", lw5["ffn_down_exps"], d, n_l - n_q6),
            ("down_q6k", lw6["ffn_down_exps"], d, n_q6)):
        gather_rows(dev, gen, K5, name, qt, npe, per_step, 7)

    log(f"K6 fast_byte (NMSE <= {NMSE_KERNEL}; its GEMM above 8 rows, at "
        "1024 rows outside the served path)")
    for name, qt in (("wk", layers[0]["wk"]), ("wv", layers[0]["wv"])):
        for B in (1, 8, 32, 128, 512):
            k6_row(dev, gen, cfg, K6 if B == 1 else None, name, qt, "plain",
                   B, n_l)
    k6_row(dev, gen, cfg, None, "wk", layers[0]["wk"], "plain", 1024, 0)

    log(f"K1 / K3 on the Mixtral shapes (NMSE <= {NMSE_KERNEL})")
    lw0 = layers[0]
    for name, qt, mode, per_step in (("wq", lw0["wq"], "raw", n_l),
                                     ("wo", lw0["wo"], "res", n_l),
                                     ("head_q6k", weights["output"], "raw", 1)):
        for B in (1, 8):
            k1_row(dev, gen, cfg, M1 if B == 1 else None, name, qt, mode, B,
                   per_step)
    for name, qt, count in (
            ("wq", lw0["wq"], n_l), ("wo", lw0["wo"], n_l),
            ("gate_up_e", qtensor_rows(lw5["ffn_gate_exps"], 0, nff), 2 * E * n_l),
            ("down_q5k_e", qtensor_rows(lw5["ffn_down_exps"], 0, d), E * (n_l - n_q6)),
            ("down_q6k_e", qtensor_rows(lw6["ffn_down_exps"], 0, d), E * n_q6),
            ("head_q6k", weights["output"], 1)):
        k3_row(dev, gen, M3, name, qt, count)
    for r, unit in ((M1, f"decode step ({2 * n_l + 1} launches)"),
                    (M3, f"512-token chunk ({2 * n_l + 3 * E * n_l + 1} launches)")):
        d_ = r.d
        log(f"  Mixtral {d_['name']} per {unit}: kernel {d_['ms']:.4f} ms, "
            f"bound {d_['bound_ms']:.4f} ms ({d_['bound_by']}), plain "
            f"{d_['plain_ms']:.3f} ms, bf16 yardstick {d_['library_ms']:.4f} ms, "
            f"max|d| {d_['max_abs_err']:.3e}")
    return [K5, K6]


#: K6's GEMM (B > 8, csrc/fast_il_gemm.cu) by family and bias, the
#: kernels.GEMM_LAUNCHES key: its reports sum one 512-token chunk of each
#: configuration that runs it (k6_row at B = 512), GEMM_CELL the chunk of
#: the configuration being checked
GEMM_REPORTS: dict = {}
GEMM_CELL: dict = {}


def gemm_add(qt, count, err, ms, pms, byts, ops, lib):
    """A K6 GEMM row at B = 512, count launches of the chunk: into its
    family's report and the current configuration's chunk sums."""
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    key = kernels.gemm_key(qt)
    if key not in GEMM_REPORTS:
        GEMM_REPORTS[key] = KernelReport(
            key, "cuda", SRC_IL_GEMM,
            K6_BYTE if PF._family(qt.cfg) == "byte" else K6_NIBBLE,
            "one 512-token chunk of each configuration that runs it")
    GEMM_REPORTS[key].add(count, err, ms, pms, byts, ops, BF16_OPS, lib)
    cell = GEMM_CELL.setdefault(key, [0, 0.0, 0.0, 0.0, 0.0])
    for i, v in enumerate((count, count * ms, count * pms, count * lib,
                           count * bound_ms(byts, ops, BF16_OPS)[0])):
        cell[i] += v


def log_gemm_cell(name):
    """The K6 GEMM launches of one 512-token chunk of configuration
    `name`, by family, then their sum; GEMM_CELL emptied."""
    if not GEMM_CELL:
        return
    tot = [0, 0.0, 0.0, 0.0, 0.0]
    for key, (n, ms, pms, lib, bms) in sorted(GEMM_CELL.items()):
        log(f"  K6 GEMM, {name} 512-token chunk, {key}: {n} launches, kernel "
            f"{ms:.3f} ms, plain {pms:.1f} ms, bf16 yardstick {lib:.3f} ms, "
            f"bound {bms:.3f} ms")
        tot = [a + b for a, b in zip(tot, (n, ms, pms, lib, bms))]
    log(f"  K6 GEMM, {name} 512-token chunk, all: {tot[0]} launches, kernel "
        f"{tot[1]:.3f} ms, bf16 yardstick {tot[3]:.3f} ms "
        f"({tot[1] / tot[3]:.2f}x), bound {tot[4]:.3f} ms")
    GEMM_CELL.clear()


#: K6 rows at B = 8 of the configuration being checked, times their
#: launches in its 8-token prefill bucket: [launches, kernel ms, bf16
#: yardstick ms, bound ms]
BUCKET8_CELL = [0, 0.0, 0.0, 0.0]


def log_bucket8_cell(name):
    """The K6 mix of one 8-token bucket of configuration `name`; emptied."""
    n, ms, lib, bms = BUCKET8_CELL
    if n:
        log(f"  K6 at B = 8, {name} 8-token bucket: {n} launches, kernel "
            f"{ms:.3f} ms, bf16 yardstick {lib:.3f} ms ({ms / lib:.2f}x), "
            f"bound {bms:.3f} ms ({bms / ms:.0%} of it)")
    BUCKET8_CELL[:] = [0, 0.0, 0.0, 0.0]


def k6_row(dev, gen, cfg, rep, name, qt, mode, B, count, bucket=0):
    """One K6 call on interleaved planes of any family (byte, nibble or
    coded), with or without a group bias (mode: plain, pre_il, normed, res,
    act with a residual): kernel vs plain version on the group sums the
    entry would hand it, kernel / plain / yardstick times and the bound;
    added to rep (when given) count times, at B = 512 (K6's GEMM on the
    512-token chunk) to its family's GEMM report count times, and at B = 8
    to the 8-token bucket's sum `bucket` times."""
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    K = qt.k
    kw = {}
    x = torch.randn(B, 2 * K if mode == "act" else K, generator=gen,
                    device=dev).to(torch.bfloat16)
    if mode == "normed":
        kw = dict(wn=torch.rand(K, device=dev, generator=gen) + 0.5,
                  eps=cfg.rms_eps)
    elif mode in ("res", "act"):
        kw = dict(res=torch.randn(B, qt.n, generator=gen, device=dev))
    if mode == "act":
        kw["act"] = "silu"
    elif mode == "pre_il":
        kw = dict(pre_il=True)
    _, nkj = PF._pick_blocks(PF._padded_rows(B), K, PF._is_packed(qt.cfg),
                             qt.cfg.gs)
    kw["xg"] = PF.group_sums(qt, x, mode, kw.get("wn"), nkj)
    kern, plain = PF._k6(qt, False), PF._k6(qt, True)
    got = kern(x, qt, **kw)
    err, e2 = held(f"K6 {mode} {name} B={B}", got, plain(x, qt, **kw))
    iters = 10 if B > 8 else 20
    ms = time_ms(lambda: kern(x, qt, **kw), iters=iters)
    pms = time_plain_ms(lambda: plain(x, qt, **kw))
    deq = deq_t(qt)
    xl = x[:, :K]
    lib = time_ms(lambda: torch.matmul(xl, deq), iters=iters)
    del deq
    peak = BF16_OPS  # bf16 mma at any B (il_gemv_kernel, fast_il_gemm.cu)
    byts = plane_bytes(qt) + nbytes(x, got, kw.get("wn"), kw.get("res"),
                                    kw["xg"])
    ops = 2 * B * K * qt.fq.shape[0] + bias_ops(qt, B)
    bms, by = bound_ms(byts, ops, peak)
    xg_mode = PF._xg_mode(qt, nkj)
    log(f"  {mode:6s} {name:10s} {qt.cfg.qtype.name} {qt.n}x{K} B={B:3d} "
        f"{PF._family(qt.cfg)} bias-sums={xg_mode} "
        f"max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms plain={pms:.3f}ms "
        f"bf16-matmul={lib:.4f}ms bound={bms:.4f}ms ({by}) "
        f"{bms / ms:.0%} of bound")
    if rep is not None:
        rep.add(count, err, ms, pms, byts, ops, peak, lib)
    if B == 512 and count:
        gemm_add(qt, count, err, ms, pms, byts, ops, lib)
    if B == 8 and bucket:
        for i, v in enumerate((bucket, bucket * ms, bucket * lib, bucket * bms)):
            BUCKET8_CELL[i] += v


def gather_rows(dev, gen, rep, name, qt, npe, per_step, seed):
    """The gathered-expert GEMV on stacked planes, K8 on interleaved ones
    (any family) or K5 on t-planes, at P=2, P=2 with a duplicate id and
    P=16: kernel vs plain version, times, bound; the P=2 row added to rep
    per_step times."""
    from ggml_hexagon_tpu_torch.models.llama import qtensor_rows
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
    from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P

    t = qt.fl == "t"
    E = (qt.fq.shape[1] if t else qt.fq.shape[0]) // npe
    rng = np.random.default_rng(seed)
    id_sets = [("P2", [5, 2]), ("P2_dup", [3, 3]),
               ("P16", [int(e) for _ in range(8)
                        for e in rng.permutation(E)[:2]])]
    bias = qt.fb is not None or bool(qt.cfg.offset)
    peak = INT8_OPS if t else BF16_OPS  # K8: il_gemv_kernel's bf16 mma
    for label, id_list in id_sets:
        ids = torch.tensor(id_list, dtype=torch.int32, device=dev)
        x = torch.randn(len(id_list), qt.k, generator=gen, device=dev)
        if t:
            args = (x, qt, ids, npe)
            kern, plain = P.qp8_indirect, P.qp8_indirect_plain
        else:
            x = x.to(torch.bfloat16)
            xg = PF._sums_natural(x, qt.fs.shape[1]) if bias else None
            args = (x, qt, ids, npe, xg)
            kern, plain = PF.fast_indirect, PF.fast_indirect_plain
        got = kern(*args)
        err, e2 = held(f"{'K5' if t else 'K8'} {name} {label}", got,
                       plain(*args))
        ms = time_ms(lambda: kern(*args))
        pms = time_plain_ms(lambda: plain(*args))
        uniq = sorted(set(id_list))
        w_e = {e: deq_t(qtensor_rows(qt, e * npe, npe)) for e in uniq}
        wsel = torch.stack([w_e[e] for e in id_list])   # [P, K, npe]
        xb = x.to(torch.bfloat16)[:, None, :]
        lib = time_ms(lambda: torch.bmm(xb, wsel))
        del w_e, wsel
        one = qtensor_rows(qt, 0, npe)
        byts = len(uniq) * plane_bytes(one) + nbytes(*args[:1], ids, got,
                                                     *args[4:])
        ops = 2 * len(id_list) * qt.k * npe + bias_ops(one, len(id_list))
        bms, by = bound_ms(byts, ops, peak)
        log(f"  {name:8s} {qt.cfg.qtype.name}/{qt.fl} {E}x{npe}x{qt.k} "
            f"{label:6s} max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms "
            f"plain={pms:.3f}ms bf16-bmm={lib:.4f}ms bound={bms:.4f}ms "
            f"({by}) {bms / ms:.0%} of bound")
        if label == "P2" and rep is not None:
            rep.add(per_step, err, ms, pms, byts, ops, peak, lib)


def dual_row(dev, gen, cfg, rep, qa, qb, B, count):
    """The decode QKV's dual projection on a normed pair, K7 on interleaved
    planes (each part with its own norm weight) or K2 on t-planes (one
    shared): kernel vs plain version, times against a bf16 matmul on both
    weights at once, the bound."""
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
    from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P

    K = qa.k
    x = torch.randn(B, K, generator=gen, device=dev)
    if qa.fl == "t":
        kw = dict(wn=torch.rand(K, device=dev, generator=gen) + 0.5,
                  eps=cfg.rms_eps)
        kern, plain, peak, what = P.qp8_dual, P.qp8_dual_plain, INT8_OPS, "K2"
    else:
        x = x.to(torch.bfloat16)
        kw = dict(wn_a=torch.rand(K, device=dev, generator=gen) + 0.5,
                  wn_b=torch.rand(K, device=dev, generator=gen) + 0.5,
                  eps=cfg.rms_eps)
        kw["xg_a"] = PF.group_sums(qa, x, "normed", kw["wn_a"])
        kw["xg_b"] = PF.group_sums(qb, x, "normed", kw["wn_b"])
        kern, plain, peak, what = PF.fast_dual, PF.fast_dual_plain, BF16_OPS, "K7"
    got = kern(x, qa, qb, **kw)
    err, e2 = held(f"{what} B={B}", got, plain(x, qa, qb, **kw))
    ms = time_ms(lambda: kern(x, qa, qb, **kw))
    pms = time_plain_ms(lambda: plain(x, qa, qb, **kw))
    deq = torch.cat([deq_t(qa), deq_t(qb)], dim=1)
    xl = x.to(torch.bfloat16)
    lib = time_ms(lambda: torch.matmul(xl, deq))
    del deq
    byts = plane_bytes(qa) + plane_bytes(qb) + nbytes(
        x, got, *(v for v in kw.values() if isinstance(v, torch.Tensor)))
    ops = (2 * B * K * (qa.n_pad + qb.n_pad) + bias_ops(qa, B)
           + bias_ops(qb, B))
    bms, by = bound_ms(byts, ops, peak)
    log(f"  {what} wqk+wv {qa.cfg.qtype.name}+{qb.cfg.qtype.name} "
        f"{qa.n}+{qb.n}x{K} B={B} max|d|={err:.3e} nmse={e2:.2e} "
        f"kernel={ms:.4f}ms plain={pms:.3f}ms bf16-matmul={lib:.4f}ms "
        f"bound={bms:.4f}ms ({by}) {bms / ms:.0%} of bound")
    if rep is not None:
        rep.add(count, err, ms, pms, byts, ops, peak, lib)


def k1_row(dev, gen, cfg, rep, name, qt, mode, B, count):
    """One K1 call on t-planes (mode raw, normed, res, or act with a
    residual): kernel vs plain version, kernel / plain / yardstick times and
    the bound; added to rep (when given) count times."""
    from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P

    x = torch.randn(B, 2 * qt.k if mode == "act" else qt.k, generator=gen,
                    device=dev)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(qt.k, device=dev, generator=gen) + 0.5,
                  eps=cfg.rms_eps)
    elif mode in ("res", "act"):
        kw = dict(res=torch.randn(B, qt.n, generator=gen, device=dev))
    if mode == "act":
        kw["act"] = "silu"
    got = P.qp8_gemv(x, qt, **kw)
    err, e2 = held(f"K1 {mode} {name} B={B}", got, P.qp8_gemv_plain(x, qt, **kw))
    ms = time_ms(lambda: P.qp8_gemv(x, qt, **kw))
    pms = time_plain_ms(lambda: P.qp8_gemv_plain(x, qt, **kw))
    deq = deq_t(qt)
    xl = x[:, :qt.k].to(torch.bfloat16)
    lib = time_ms(lambda: torch.matmul(xl, deq))
    del deq
    byts = plane_bytes(qt) + nbytes(x, got, kw.get("wn"), kw.get("res"))
    ops = 2 * B * qt.k * qt.fq.shape[1]
    bms, by = bound_ms(byts, ops, INT8_OPS)
    log(f"  K1 {mode:6s} {name:9s} {qt.cfg.qtype.name} {qt.n}x{qt.k} B={B} "
        f"max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms plain={pms:.3f}ms "
        f"bf16-matmul={lib:.4f}ms bound={bms:.4f}ms ({by}) "
        f"{bms / ms:.0%} of bound")
    if rep is not None:
        rep.add(count, err, ms, pms, byts, ops, INT8_OPS, lib)


def k3_row(dev, gen, rep, name, qt, count, M=512):
    """One K3 call on t-planes at M rows: kernel vs plain version, times,
    bound; added to rep (when given) count times."""
    from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P

    x = torch.randn(M, qt.k, generator=gen, device=dev).to(torch.bfloat16)
    got = P.qp8_gemm(x, qt)
    err, e2 = held(f"K3 {name}", got, P.qp8_gemm_plain(x, qt))
    ms = time_ms(lambda: P.qp8_gemm(x, qt), iters=5)
    pms = time_plain_ms(lambda: P.qp8_gemm_plain(x, qt))
    deq = deq_t(qt)
    lib = time_ms(lambda: torch.matmul(x, deq), iters=5)
    del deq
    byts = plane_bytes(qt) + nbytes(x, got)
    ops = 2 * M * qt.k * qt.fq.shape[1]
    bms, by = bound_ms(byts, ops, BF16_OPS)
    log(f"  K3 {name:10s} {qt.cfg.qtype.name} {qt.n}x{qt.k} M={M} "
        f"max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms plain={pms:.3f}ms "
        f"bf16-matmul={lib:.4f}ms bound={bms:.4f}ms ({by}) "
        f"{bms / ms:.0%} of bound {ops / ms / 1e9:.1f} TFLOP/s")
    if rep is not None:
        rep.add(count, err, ms, pms, byts, ops, BF16_OPS, lib)


def check_codes_alone(dev, cfg):
    """iq1 (IQ1_S) and ternary (TQ2_0), which no served configuration
    uses: one K1, one K3 and one K6 shape each against their plain
    versions (4096 x 4096, B=1 / M=512 / B=1); and ternary planes whose
    group count is not a multiple of 8 (TQ1_0 and TQ2_0 at K = 1024, G = 4,
    and K = 11008, G = 43; 4096 rows), which K6 and K8 take padded to 8
    groups: K6 at B = 1 and 512 and K8 (8 experts of 512 rows)."""
    from ggml_hexagon_tpu_torch.models.synth import random_qtensor
    from ggml_hexagon_tpu_torch.quant.formats import GGMLType

    gen = torch.Generator(device=dev)
    gen.manual_seed(97)
    log(f"iq1 and ternary alone (kernel vs plain, NMSE <= {NMSE_KERNEL})")
    for qtype in (GGMLType.IQ1_S, GGMLType.TQ2_0):
        qt = random_qtensor(gen, 4096, 4096, qtype, dev)
        t, il = (qt.with_fast_planes(fl).without_wire() for fl in ("t", "il"))
        del qt
        k1_row(dev, gen, cfg, None, "alone", t, "raw", 1, 0)
        k3_row(dev, gen, None, "alone", t, 0)
        k6_row(dev, gen, cfg, None, "alone", il, "plain", 1, 0)
    for qtype in (GGMLType.TQ1_0, GGMLType.TQ2_0):
        for K in (1024, 11008):
            il = random_qtensor(gen, 4096, K, qtype, dev).with_fast_planes(
                "il").without_wire()
            if il.fl != "il" or il.fs.shape[1] % 8 == 0:
                raise AssertionError(f"{qtype.name} K={K}: planes "
                                     f"{il.fl} G={il.fs.shape[1]}")
            for B in (1, 512):
                k6_row(dev, gen, cfg, None, "G%8", il, "plain", B, 0)
            gather_rows(dev, gen, None, "G%8", il, 512, 0, K)


def check_kernels_coded(dev, weights, cfg):
    """The code-map branch of every kernel against its plain version at the
    shapes of the IQ3_XXS configuration's main path: K2 (coded wqk + Q4_K
    wv), K1 (res, normed, act) and K3 on t-planes (Llama-3-8B IQ3_XXS), K7
    and K6 in every mode on coded nibble planes (Llama-3-8B IQ3_XXS il), K8
    and K6's plain mode (Mixtral-8x7B IQ3_XXS il), K5, K1 and K3 (Mixtral
    IQ3_XXS); the first also holds iq1 and ternary alone.  Returns the
    reports of what the configuration's decode step runs (K3: a 512-token
    chunk)."""
    from ggml_hexagon_tpu_torch.models.llama import qtensor_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(8642)
    layers = weights["layers"]
    n_l = len(layers)
    lw = layers[0]
    E, nff, d = cfg.n_expert, cfg.n_ff_exp or cfg.n_ff, cfg.n_embd

    def report(key, src, replaces, unit):
        return KernelReport(key, "cuda", src, replaces, unit)

    if not E and lw["wqk"].fl == "t":
        unit = "one 8B IQ3_XXS decode step (B=1)"
        K1 = report("qp8_gemv_coded", SRC_GEMV, "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
                    f"{unit}: {3 * n_l} launches (res, normed, act)")
        K2 = report("qp8_dual_coded", SRC_GEMV, "ggml_hexagon_tpu/ops/qmm_qp8.py:475",
                    f"{unit}: {n_l} launches (IQ2_S wqk + Q4_K wv)")
        K3 = report("qp8_gemm_coded", SRC_GEMM, "ggml_hexagon_tpu/ops/qmm_qp8.py:529",
                    f"one 8B IQ3_XXS 512-token chunk: {4 * n_l} launches")
        log(f"K2 / K1 / K3 on coded t-planes, 8B IQ3_XXS shapes (NMSE <= {NMSE_KERNEL})")
        for B in (1, 4):
            dual_row(dev, gen, cfg, K2 if B == 1 else None, lw["wqk"], lw["wv"],
                     B, n_l)
        for B in (1, 8):
            for name, qt, mode in (("wo", lw["wo"], "res"),
                                   ("gate_up", lw["w_gateup_il"], "normed"),
                                   ("down", lw["ffn_down"], "act")):
                k1_row(dev, gen, cfg, K1 if B == 1 else None, name, qt, mode, B,
                       n_l)
        for name in ("wqk", "wo", "w_gateup_il", "ffn_down"):
            k3_row(dev, gen, K3, name, lw[name], n_l)
        check_codes_alone(dev, cfg)
        return [K1, K2, K3]

    if not E:
        unit = "one 8B IQ3_XXS il decode step (B=1)"
        KD = report("fast_dual_coded", SRC_DUAL, K7_DUAL,
                    f"{unit}: {n_l} launches (coded wqk + Q4_K nibble wv)")
        KN = report("fast_coded_normed", SRC_IL, K6_NIBBLE, f"{unit}: {n_l} launches")
        KR = report("fast_coded_res", SRC_IL, K6_NIBBLE, f"{unit}: {n_l} launches")
        KA = report("fast_coded_act", SRC_IL, K6_NIBBLE, f"{unit}: {n_l} launches")
        log(f"K7 / K6 on coded nibble planes, 8B IQ3_XXS il shapes (NMSE <= {NMSE_KERNEL})")
        for B in (1, 4, 8):
            dual_row(dev, gen, cfg, KD if B == 1 else None, lw["wqk"], lw["wv"],
                     B, n_l)
        for B in (1, 8, 32, 128, 512):
            k6_row(dev, gen, cfg, KN if B == 1 else None, "gate_up",
                   lw["w_gateup_il"], "normed", B, n_l)
        for B in (1, 8):
            k6_row(dev, gen, cfg, KR if B == 1 else None, "wo", lw["wo"], "res",
                   B, n_l)
            k6_row(dev, gen, cfg, KA if B == 1 else None, "down", lw["ffn_down"],
                   "act", B, n_l)
        for B in (32, 128, 512):  # the prefill's other launches (wv: Q4_K)
            k6_row(dev, gen, cfg, None, "wqk", lw["wqk"], "normed", B, n_l)
            k6_row(dev, gen, cfg, None, "wv", lw["wv"], "normed", B, n_l)
            k6_row(dev, gen, cfg, None, "wo", lw["wo"], "plain", B, n_l)
            k6_row(dev, gen, cfg, None, "down", lw["ffn_down"], "pre_il", B, n_l)
            k6_row(dev, gen, cfg, None, "head_q5k", weights["output"], "plain", B, 1)
        k6_row(dev, gen, cfg, None, "gate_up", lw["w_gateup_il"], "normed", 1024, 0)
        return [KD, KN, KR, KA]

    stacks = (("gate_up", lw["ffn_gate_exps"], nff, 2 * n_l),
              ("down", lw["ffn_down_exps"], d, n_l))
    if lw["ffn_gate_exps"].fl == "il":
        unit = "one Mixtral IQ3_XXS il decode step (B=1"
        K8 = report("fast_indirect_coded", SRC_IL, K8_GATHER,
                    f"{unit}, P=2): {3 * n_l} launches")
        KP = report("fast_coded", SRC_IL, K6_NIBBLE,
                    f"{unit}): {n_l} launches (IQ2_S wq)")
        log(f"K8 / K6 on coded nibble planes, Mixtral IQ3_XXS il shapes (NMSE <= {NMSE_KERNEL})")
        for name, qt, npe, per_step in stacks:
            gather_rows(dev, gen, K8, name, qt, npe, per_step, 14)
        for B in (1, 8, 32, 128, 512):
            k6_row(dev, gen, cfg, KP if B == 1 else None, "wq", lw["wq"], "plain",
                   B, n_l)
        for B in (32, 128, 512):  # wk, wv (Q8_0), wo and head (Q5_K), experts
            for name in ("wk", "wv", "wo"):
                k6_row(dev, gen, cfg, None, name, lw[name], "plain", B, n_l)
            k6_row(dev, gen, cfg, None, "head_q5k", weights["output"], "plain", B, 1)
            k6_row(dev, gen, cfg, None, "gate_e",
                   qtensor_rows(lw["ffn_gate_exps"], 0, nff), "plain", B, 2 * E * n_l)
            k6_row(dev, gen, cfg, None, "down_e",
                   qtensor_rows(lw["ffn_down_exps"], 0, d), "plain", B, E * n_l)
        k6_row(dev, gen, cfg, None, "wq", lw["wq"], "plain", 1024, 0)
        return [K8, KP]

    K5 = report("qp8_indirect_coded", SRC_GEMV, "ggml_hexagon_tpu/ops/qmm_qp8.py:1022",
                f"one Mixtral IQ3_XXS decode step (B=1, P=2): {3 * n_l} launches")
    log(f"K5 / K1 / K3 on coded t-planes, Mixtral IQ3_XXS shapes (NMSE <= {NMSE_KERNEL})")
    for name, qt, npe, per_step in stacks:
        gather_rows(dev, gen, K5, name, qt, npe, per_step, 15)
    for B in (1, 8):
        k1_row(dev, gen, cfg, None, "wq", lw["wq"], "raw", B, n_l)
    for B in (32, 128, 512):  # wk, wv: Q8_0 byte planes, K6
        for name in ("wk", "wv"):
            k6_row(dev, gen, cfg, None, name, lw[name], "plain", B, n_l)
    for name, qt, count in (
            ("wq", lw["wq"], n_l),
            ("gate_e", qtensor_rows(lw["ffn_gate_exps"], 0, nff), 2 * E * n_l),
            ("down_e", qtensor_rows(lw["ffn_down_exps"], 0, d), E * n_l)):
        k3_row(dev, gen, None, name, qt, count)
    return [K5]


def check_kernels_il(dev, weights, cfg):
    """K6's normed, act and residual modes (8B IQ4_XS) or K8 and K6's plain
    mode on IQ4_XS (Mixtral IQ4_XS) against their plain versions at the
    configuration's main-path shapes; returns the reports of the modes and
    of K8 that this configuration's path runs."""
    from ggml_hexagon_tpu_torch.models.llama import qtensor_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    layers = weights["layers"]
    n_l = len(layers)
    moe = "ffn_gate_inp" in layers[0]

    def report(key, unit):
        return KernelReport(key, "cuda", SRC_IL, K6_BYTE, unit)

    def row(rep, name, qt, mode, B, count, bucket=0):
        k6_row(dev, gen, cfg, rep, name, qt, mode, B, count, bucket)

    if not moe:
        lw_il = next(lw for lw in layers if lw["ffn_down"].fl == "il")
        n_dn = sum(lw["ffn_down"].fl == "il" for lw in layers)
        KN = report("fast_byte_normed", f"one 8B IQ4_XS decode step (B=1): {2 * n_l} launches")
        KR = report("fast_byte_res", f"one 8B IQ4_XS decode step (B=1): {n_l} launches")
        KA = report("fast_byte_act", f"one 8B IQ4_XS decode step (B=1): {n_dn} launches")
        log(f"K6 modes on the 8B IQ4_XS shapes (kernel vs plain, NMSE <= {NMSE_KERNEL})")
        for B in (1, 8, 32, 128, 512):
            for name, qt in (("wqk", lw_il["wqk"]), ("gate_up", lw_il["w_gateup_il"])):
                row(KN if B == 1 else None, name, qt, "normed", B, n_l, n_l)
        for B in (1, 8):
            row(KR if B == 1 else None, "wo", lw_il["wo"], "res", B, n_l)
            row(KA if B == 1 else None, "down", lw_il["ffn_down"], "act", B, n_dn, n_dn)
        row(None, "wo", lw_il["wo"], "plain", 8, n_l, n_l)  # the bucket's wo
        for B in (32, 128, 512):  # the prefill's plain launches
            row(None, "wo", lw_il["wo"], "plain", B, n_l)
            row(None, "down", lw_il["ffn_down"], "pre_il", B, n_dn)
        row(None, "gate_up", lw_il["w_gateup_il"], "normed", 1024, 0)
        return [KN, KR, KA]

    E, nff, d = cfg.n_expert, cfg.n_ff_exp or cfg.n_ff, cfg.n_embd
    lw_il = next(lw for lw in layers if lw["ffn_down_exps"].fl == "il")
    n_dn = sum(lw["ffn_down_exps"].fl == "il" for lw in layers)
    K8 = KernelReport("fast_indirect", "cuda", SRC_IL, K8_GATHER,
                      f"one Mixtral IQ4_XS decode step (B=1, P=2): "
                      f"{2 * n_l + n_dn} launches")
    log(f"K8 fast_indirect (kernel vs plain, NMSE <= {NMSE_KERNEL})")
    gather_rows(dev, gen, K8, "gate_up", lw_il["ffn_gate_exps"], nff, 2 * n_l, 9)
    gather_rows(dev, gen, K8, "down", lw_il["ffn_down_exps"], d, n_dn, 10)
    log(f"K6 plain mode on the Mixtral IQ4_XS shapes (NMSE <= {NMSE_KERNEL})")
    for B in (1, 8, 32, 128, 512):
        row(None, "wq", layers[0]["wq"], "plain", B, n_l)
    for B in (32, 128, 512):  # wk, wv (Q8_0) and the dense prefill's experts
        for name in ("wk", "wv"):
            row(None, name, layers[0][name], "plain", B, n_l)
        row(None, "gate_e", qtensor_rows(lw_il["ffn_gate_exps"], 0, nff),
            "plain", B, 2 * E * n_l)
        row(None, "down_e", qtensor_rows(lw_il["ffn_down_exps"], 0, d),
            "plain", B, E * n_dn)
    row(None, "wq", layers[0]["wq"], "plain", 1024, 0)
    return [K8]


def il_8b_chunk(weights):
    """The Llama-3-8B Q4_K_M il layers' planes (a wqkv layer, a wqk + wv
    layer, a Q4_K and a Q6_K down, the wqkv and Q6_K-down layer counts)
    and the K6 launches of its prefill chunk, (name, planes, mode, count),
    the head's included, with or without the megakernel layout (the
    prefill runs no K9)."""
    layers = weights["layers"]
    n_l = len(layers)
    full = next(lw for lw in layers if "wqkv" in lw)
    mixed = next(lw for lw in layers if "wqk" in lw)
    n_full = sum("wqkv" in lw for lw in layers)

    def dn(t):
        return next(lw["ffn_down"] for lw in layers
                    if lw["ffn_down"].cfg.qtype.name == t)

    dn4, dn6 = dn("Q4_K"), dn("Q6_K")
    n6 = sum(lw["ffn_down"].cfg.qtype.name == "Q6_K" for lw in layers)
    chunk = [("wqkv", full["wqkv"], "normed", n_full),
             ("wqk", mixed["wqk"], "normed", n_l - n_full),
             ("wv_q6k", mixed["wv"], "normed", n_l - n_full),
             ("gate_up", full["w_gateup_il"], "normed", n_l),
             ("wo", full["wo"], "plain", n_l),
             ("down_q4k", dn4, "pre_il", n_l - n6),
             ("down_q6k", dn6, "pre_il", n6),
             ("head_q6k", weights["output"], "plain", 1)]
    return full, mixed, dn4, dn6, n_full, n6, chunk


def check_kernels_nibble(dev, weights, cfg):
    """The interleaved-everywhere route: K6 on nibble planes in every mode,
    K6 on Q6_K byte planes with the derived bias and K7 (8B Q4_K_M il), or
    K8 on nibble stacks and on Q6_K stacks with the derived bias, K6 on
    nibble planes and on Q5_K planes with a stored bias (Mixtral Q4_K_M
    il), against their plain versions at the configuration's main-path
    shapes; returns the reports of what its decode step runs."""
    from ggml_hexagon_tpu_torch.models.llama import qtensor_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    layers = weights["layers"]
    n_l = len(layers)

    def report(key, replaces, unit):
        return KernelReport(key, "cuda", SRC_IL, replaces, unit)

    def row(rep, name, qt, mode, B, count, bucket=0):
        k6_row(dev, gen, cfg, rep, name, qt, mode, B, count, bucket)

    if "ffn_gate_inp" not in layers[0]:
        full, mixed, dn4, dn6, n_full, n6, chunk = il_8b_chunk(weights)
        n_mixed = n_l - n_full
        unit = "one 8B Q4_K_M il decode step (B=1)"
        KN = report("fast_nibble_normed", K6_NIBBLE, f"{unit}: {n_full + n_l} launches")
        KR = report("fast_nibble_res", K6_NIBBLE, f"{unit}: {n_l} launches")
        KA = report("fast_nibble_act", K6_NIBBLE, f"{unit}: {n_l - n6} launches")
        BA = report("fast_byte_act", K6_BYTE,
                    f"{unit}: {n6} launches (Q6_K, derived bias)")
        BP = report("fast_byte", K6_BYTE, f"{unit}: 1 launch (Q6_K head, derived bias)")
        KD = KernelReport("fast_dual", "cuda", SRC_DUAL, K7_DUAL,
                          f"{unit}: {n_mixed} launches")
        log(f"K6 on the 8B Q4_K_M il shapes (kernel vs plain, NMSE <= {NMSE_KERNEL})")
        for B in (1, 8):
            row(KN if B == 1 else None, "wqkv", full["wqkv"], "normed", B, n_full, n_full)
            row(KN if B == 1 else None, "gate_up", full["w_gateup_il"], "normed", B, n_l, n_l)
            row(KR if B == 1 else None, "wo", full["wo"], "res", B, n_l)
            row(KA if B == 1 else None, "down_q4k", dn4, "act", B, n_l - n6, n_l - n6)
            row(BA if B == 1 else None, "down_q6k", dn6, "act", B, n6, n6)
        row(BP, "head_q6k", weights["output"], "plain", 1, 1)
        # the rest of the 8-token bucket's K6 mix: no dual, wo plain
        for name, qt, mode, count in (("wqk", mixed["wqk"], "normed", n_mixed),
                                      ("wv_q6k", mixed["wv"], "normed", n_mixed),
                                      ("wo", full["wo"], "plain", n_l),
                                      ("head_q6k", weights["output"], "plain", 1)):
            row(None, name, qt, mode, 8, count, count)
        for B in (32, 128, 512):  # the prefill chunk's launches
            for name, qt, mode, count in chunk:
                row(None, name, qt, mode, B, count)
        row(None, "gate_up", full["w_gateup_il"], "normed", 1024, 0)
        log(f"K7 fast_dual (NMSE <= {NMSE_KERNEL})")
        for B in (1, 4, 8):
            dual_row(dev, gen, cfg, KD if B == 1 else None, mixed["wqk"],
                     mixed["wv"], B, n_mixed)
        return [KN, KR, KA, BA, BP, KD]

    E, nff, d = cfg.n_expert, cfg.n_ff_exp or cfg.n_ff, cfg.n_embd

    def stack(t):
        return next(lw for lw in layers
                    if lw["ffn_down_exps"].cfg.qtype.name == t)

    lw4, lw6 = stack("Q4_K"), stack("Q6_K")
    n6 = sum(lw["ffn_down_exps"].cfg.qtype.name == "Q6_K" for lw in layers)
    unit = "one Mixtral Q4_K_M il decode step (B=1"
    KP = report("fast_nibble", K6_NIBBLE, f"{unit}): {n_l} launches (wq)")
    KR = report("fast_byte_res", K6_BYTE, f"{unit}): {n_l} launches (Q5_K wo, stored bias)")
    I4 = report("fast_indirect_nibble", K8_GATHER,
                f"{unit}, P=2): {3 * n_l - n6} launches")
    I6 = report("fast_indirect", K8_GATHER,
                f"{unit}, P=2): {n6} launches (Q6_K, derived bias)")
    log(f"K8 on the Mixtral Q4_K_M il stacks (kernel vs plain, NMSE <= {NMSE_KERNEL})")
    gather_rows(dev, gen, I4, "gate_up", lw4["ffn_gate_exps"], nff, 2 * n_l, 11)
    gather_rows(dev, gen, I4, "down_q4k", lw4["ffn_down_exps"], d, n_l - n6, 12)
    gather_rows(dev, gen, I6, "down_q6k", lw6["ffn_down_exps"], d, n6, 13)
    log(f"K6 on the Mixtral Q4_K_M il shapes (NMSE <= {NMSE_KERNEL})")
    for B in (1, 8, 32, 128, 512):
        row(KP if B == 1 else None, "wq", layers[0]["wq"], "plain", B, n_l)
    for B in (1, 8):
        row(KR if B == 1 else None, "wo_q5k", layers[0]["wo"], "res", B, n_l)
    row(None, "head_q6k", weights["output"], "plain", 1, 1)
    row(None, "wq", layers[0]["wq"], "plain", 1024, 0)
    for B in (32, 128, 512):  # the prefill's wk, wv, wo, head and experts
        for name in ("wk", "wv"):
            row(None, name, layers[0][name], "plain", B, n_l)
        row(None, "wo_q5k", layers[0]["wo"], "plain", B, n_l)
        row(None, "head_q6k", weights["output"], "plain", B, 1)
        row(None, "gate_e", qtensor_rows(lw4["ffn_gate_exps"], 0, nff),
            "plain", B, 2 * E * n_l)
        row(None, "down_q4k_e", qtensor_rows(lw4["ffn_down_exps"], 0, d),
            "plain", B, E * (n_l - n6))
        row(None, "down_q6k_e", qtensor_rows(lw6["ffn_down_exps"], 0, d),
            "plain", B, E * n6)
    return [KP, KR, I4, I6]


def k9_row(dev, gen, cfg, rep, name, lw, dn, B, count):
    """One K9 call on a layer's planes in the megakernel layout (dn: the
    layer's own down planes, or another type's drawn at the same shape):
    kernel vs plain version on the same inputs, kernel and plain times and
    the bound; with `rep`, the three K6 launches of the split path on the
    same planes un-permuted (wo residual mode, gate_up normed, down act),
    timed in the same way, and count times into rep."""
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.ops import ffn_fused as PFF
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    d, wo, gu, wn = cfg.n_embd, lw["wo"], lw["w_gateup_il"], lw["ffn_norm_il"]
    G, gs, n_ff = wo.fs.shape[1], wo.cfg.gs, dn.k
    attn = torch.randn(B, d, generator=gen, device=dev).to(torch.bfloat16).float()
    h = torch.randn(B, d, generator=gen, device=dev).to(torch.bfloat16).float()
    x_a = PF._interleave_x(attn, G, gs).to(torch.bfloat16).contiguous()
    xg_a = PF._sums_natural(attn, G).contiguous()
    h_il = PF._interleave_x(h, G, gs).contiguous()
    args = (x_a, xg_a, h_il, wn, wo, gu, dn, cfg.rms_eps)
    got = kernels.ffn_fused(*args)
    err, e2 = held(f"K9 {name} B={B}", got, PFF.ffn_fused_plain(*args))
    ms = time_ms(lambda: kernels.ffn_fused(*args))
    pms = time_plain_ms(lambda: PFF.ffn_fused_plain(*args))
    planes = plane_bytes(wo) + plane_bytes(gu) + plane_bytes(dn)
    byts = planes + nbytes(x_a, xg_a, h_il, wn, got)
    ops = (2 * B * (d * d + 2 * n_ff * d + n_ff * d) + bias_ops(wo, B)
           + bias_ops(gu, B) + bias_ops(dn, B))
    bms, by = bound_ms(byts, ops, BF16_OPS)
    line = (f"  K9 {name:9s} down {dn.cfg.qtype.name} {PF._family(dn.cfg)} "
            f"B={B} max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms "
            f"plain={pms:.3f}ms bound={bms:.4f}ms ({by}) {bms / ms:.0%} of "
            f"bound; planes {planes / 1e6:.2f} MB")
    if rep is None:
        log(line)
        return
    # the split path: the same rows of the same planes, un-permuted
    inv = torch.argsort(PF.interleave_perm(d, 32))
    wo_n, dn_n = wo.take_rows(inv), dn.take_rows(inv)
    k6_wo, k6_gu, k6_dn = PF._k6(wo_n, False), PF._k6(gu, False), PF._k6(dn_n, False)
    x = attn.to(torch.bfloat16)
    h1 = k6_wo(x, wo_n, res=h)
    x1 = h1.to(torch.bfloat16)
    gu2 = k6_gu(x1, gu, wn=wn, eps=cfg.rms_eps)
    x2 = gu2.to(torch.bfloat16)
    xg = PF.group_sums(dn_n, gu2, "act")

    def split():
        k6_wo(x, wo_n, res=h)
        k6_gu(x1, gu, wn=wn, eps=cfg.rms_eps)
        k6_dn(x2, dn_n, act="silu", res=h1, xg=xg)

    sms = time_ms(split)
    log(f"{line}; split path (K6 res + normed + act) {sms:.4f}ms")
    rep.add(count, err, ms, pms, byts, ops, BF16_OPS)
    rep.d["split_ms"] += count * sms


def check_kernels_ffn(dev, weights, cfg):
    """K9 against its plain version at the 8B Q4_K_M il ffn main path's
    shapes (a Q4_K-down and a Q6_K-down layer, B = 1 and 3), timed at B = 1
    beside the split path's three K6 launches; then one full-width shape of
    each down branch the cell does not serve: Q5_K (byte, stored fb), Q4_0
    (nibble, derived -8), IQ3_XXS (coded), drawn on the card; returns the
    reports of what its decode step runs."""
    from ggml_hexagon_tpu_torch.models.synth import random_qtensor
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
    from ggml_hexagon_tpu_torch.quant.formats import GGMLType

    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    layers = weights["layers"]
    if not all("ffp" in lw for lw in layers):
        raise AssertionError("a layer lacks the megakernel layout")

    def layer(t):
        return next(lw for lw in layers if lw["ffn_down"].cfg.qtype.name == t)

    lw4, lw6 = layer("Q4_K"), layer("Q6_K")
    n6 = sum(lw["ffn_down"].cfg.qtype.name == "Q6_K" for lw in layers)
    unit = "one 8B Q4_K_M il ffn decode step (B=1)"
    KN = KernelReport("ffn_fused_nibble", "cuda", SRC_FFN, K9_FFN,
                      f"{unit}: {len(layers) - n6} launches (Q4_K down)")
    KB = KernelReport("ffn_fused_byte", "cuda", SRC_FFN, K9_FFN,
                      f"{unit}: {n6} launches (Q6_K down, derived bias)")
    for r in (KN, KB):
        r.d["split_ms"] = 0.0
    log(f"K9 on the 8B Q4_K_M il ffn shapes (kernel vs plain, NMSE <= "
        f"{NMSE_KERNEL})")
    for B in (1, 3):
        k9_row(dev, gen, cfg, KN if B == 1 else None, "down_q4k", lw4,
               lw4["ffn_down"], B, len(layers) - n6)
        k9_row(dev, gen, cfg, KB if B == 1 else None, "down_q6k", lw6,
               lw6["ffn_down"], B, n6)
    log(f"K6's GEMM on the cell's 512-token chunk (the prefill runs no K9; "
        f"NMSE <= {NMSE_KERNEL})")
    for name, qt, mode, count in il_8b_chunk(weights)[-1]:
        k6_row(dev, gen, cfg, None, name, qt, mode, 512, count)
    log("K9's other down branches at full width (drawn on the card)")
    perm = PF.interleave_perm(cfg.n_embd, 32)
    for qtype in (GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.IQ3_XXS):
        dn = random_qtensor(gen, cfg.n_embd, cfg.n_ff, qtype, dev)
        dn = dn.with_fast_planes("il").without_wire().take_rows(perm)
        for B in (1, 3):
            k9_row(dev, gen, cfg, None, qtype.name.lower(), lw4, dn, B, 0)
        del dn
    return [KN, KB]


def wire_bytes(qt):
    return nbytes(qt.q, qt.qh, qt.d, qt.sc, qt.dmin, qt.m)


def tf32(v):
    """v rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits, ties
    away from zero."""
    b = v.contiguous().view(torch.int32)
    r = torch.where((b & 0x7F800000) == 0x7F800000, b, (b + 0x1000) & ~0x1FFF)
    return r.view(torch.float32)


def tf32_controls(x, qt, want):
    """NMSE against want (K10's plain f32 product of x and qt) of the same
    product with fewer TF32 products than the kernel's three: one,
    rna(x) . rna(w), and two, adding rna(x) . rna(w - rna(w)).  Each must
    exceed NMSE_K10_F32, or that limit would pass such a kernel."""
    from ggml_hexagon_tpu_torch.ops import qmatmul as PQ

    w = PQ._dequant_expr(qt, torch.float32)[:want.shape[-1]]
    xb, wb = tf32(x), tf32(w)
    one = xb @ wb.t()
    two = one + xb @ tf32(w - wb).t()
    return nmse(one, want), nmse(two, want)


def conformance_cases(dev, gen):
    """The inputs of the conformance phase, drawn on the card: a list of
    (kernel, label, report unit or None, entry, plain, bound (bytes, ops,
    peak), yardstick or None, NMSE limit (K10) or None, TF32 controls (K10
    in f32) or None)."""
    from ggml_hexagon_tpu_torch.kernel_ab import k12_sdpa
    from ggml_hexagon_tpu_torch.models.synth import random_qtensor
    from ggml_hexagon_tpu_torch.ops import attention as PA
    from ggml_hexagon_tpu_torch.ops import qmatmul as PQ
    from ggml_hexagon_tpu_torch.quant.formats import GGMLType
    from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS

    cases = []

    def k10(label, qt, B, unit, cd=torch.bfloat16):
        x = torch.randn(B, qt.k, generator=gen, device=dev)
        entry = partial(PQ.qmatmul, x, qt, compute_dtype=cd, backend="pallas")
        plain = partial(PQ.qmatmul_pallas, x, qt, compute_dtype=cd, plain=True)
        byts = wire_bytes(qt) + nbytes(x) + B * qt.n_pad * 4
        ops = 2 * B * qt.n_pad * qt.k
        # bf16 mma at every B; f32: FMAs at B <= 8, three TF32 products a
        # multiply-add above
        if cd == torch.bfloat16:
            peak = BF16_OPS
        elif B <= 8:
            peak = F32_OPS
        else:
            ops, peak = 3 * ops, TF32_OPS

        def lib():
            # one matmul in the compute type on the weight dequantized
            # beforehand (f32 in full f32: TF32 is off)
            deq = PQ.dequantize(qt, cd)
            xc = x.to(cd)
            return time_ms(lambda: torch.matmul(xc, deq.t()), iters=10)

        f32 = cd == torch.float32
        cases.append(("K10", f"{label} {qt.cfg.qtype.name} {qt.n}x{qt.k} "
                      f"B={B} {str(cd)[6:]}", unit, entry, plain,
                      (byts, ops, peak), lib,
                      NMSE_K10_F32 if f32 else NMSE_KERNEL,
                      partial(tf32_controls, x, qt) if f32 else None))

    shapes = (("wq", 4096, 4096, GGMLType.Q4_K, (1, 8, 512)),
              ("gate", 14336, 4096, GGMLType.Q4_K, (1, 8, 512)),
              ("down", 4096, 14336, GGMLType.Q6_K, (1, 8, 512)),
              ("head", 128256, 4096, GGMLType.Q6_K, (1, 8)))
    wq = None
    for label, n, k, qtype, batches in shapes:
        qt = random_qtensor(gen, n, k, qtype, dev)
        if wq is None:
            wq = qt
        for B in batches:
            k10(label, qt, B, f"b{B}")
    k10("wq", wq, 8, "f32_b8", torch.float32)
    k10("wq", wq, 512, "f32_b512", torch.float32)
    for qtype in sorted(QCONFIGS, key=int):
        qt = random_qtensor(gen, 4096, 4096, qtype, dev)
        for B in (1, 8):
            k10("type", qt, B, None)

    B, H, T, S, D = 1, 32, 512, 1024, 128
    t = torch.arange(T, device=dev)[:, None]
    sl = torch.arange(S, device=dev)[None, :]
    dead = 64
    mask = torch.where(sl <= S - dead - T + t, 0.0, -1e30)
    mask[:, S - dead:] = -1e30
    mask = mask[None, None].contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        q, kk, vv = (torch.randn(B, H, n_, D, generator=gen, device=dev).to(dtype)
                     for n_ in (T, S, S))
        entry = partial(PA.flash_attention_pallas, q, kk, vv, mask, D ** -0.5)
        plain = partial(PA.flash_attention_pallas, q, kk, vv, mask, D ** -0.5,
                        plain=True)
        byts = nbytes(q, kk, vv, mask) + B * H * T * D * 4
        ops = 4 * B * H * T * S * D
        m_lib = mask.to(dtype)
        lib = partial(time_ms, lambda q=q, kk=kk, vv=vv, m_lib=m_lib:
                      torch.nn.functional.scaled_dot_product_attention(
                          q, kk, vv, attn_mask=m_lib, scale=D ** -0.5))
        products = 2 if dtype == torch.bfloat16 else 3
        cases.append(("K11", f"B={B} H={H} T={T} S={S} D={D} "
                      f"{str(dtype)[6:]}", str(dtype)[6:], entry, plain,
                      (byts, ops * products, TF32_OPS), lib, None, None))

    Hkv, G = 8, 4
    for pos in ([700], [700, 3, 1023, 400]):
        Bq = len(pos)
        qg = torch.randn(Bq, Hkv, G, 1, D, generator=gen, device=dev)
        kc, vc = (torch.randn(Bq, S, Hkv, D, generator=gen,
                              device=dev).to(torch.bfloat16) for _ in range(2))
        posb = torch.tensor(pos, dtype=torch.int32, device=dev)
        for swa, cap in ((0, 0.0), (256, 0.0), (0, 30.0)):
            entry = partial(PA.decode_attention_pallas, qg, kc, vc, posb,
                            D ** -0.5, swa=swa, logit_cap=cap)
            plain = partial(PA.decode_attention_pallas, qg, kc, vc, posb,
                            D ** -0.5, swa=swa, logit_cap=cap, plain=True)
            live = [min(p, S - 1) + 1 - (max(0, p - swa + 1) if swa else 0)
                    for p in pos]
            byts = (nbytes(qg, posb) + Bq * Hkv * G * D * 4
                    + 2 * sum(live) * Hkv * D * 2)
            ops = 4 * sum(live) * Hkv * G * D
            lib = None
            if Bq == 1:
                # the yardstick kernel_ab times too: SDPA on bf16 q and the
                # live slice
                lib = partial(time_ms, k12_sdpa(qg, kc, vc, pos[0], swa,
                                                D ** -0.5))
            cases.append(("K12", f"B={Bq} pos={pos} swa={swa} cap={cap}",
                          "step" if Bq == 1 and not swa and not cap else None,
                          entry, plain, (byts, ops, BF16_OPS), lib, None,
                          None))
    return cases


def k12_kernel_counts(entries):
    """The K12 kernels (csrc/attention.cu decode_gqa*) the profiler sees
    over one call of each entry: exactly one a call.  As in profile_path,
    each window traces a warm-up round of the calls first and counts only
    kernels inside the window's own step (window_kernels): a fresh
    tracer can miss the first records of a window, all of them in a round
    this short.  More raises at once (a merge kernel, or any second
    launch); fewer is a window whose tracer lost records, traced again,
    up to three windows."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        got = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.append(p.events())) as prof:
            for _round in range(2):
                for entry in entries:
                    entry()
                torch.cuda.synchronize()
                prof.step()
        if len(got) != 1:
            raise AssertionError(f"the K12 profile gave {len(got)} windows")
        seen = window_kernels(got[0], ("decode_gqa",), 1)["decode_gqa"]
        if seen > len(entries):
            raise AssertionError(f"{seen} K12 kernels for {len(entries)} "
                                 "calls: one a call wanted")
        if seen == len(entries):
            return seen
    raise AssertionError(f"{seen} K12 kernels for {len(entries)} calls, "
                         "three windows")


def run_conformance(dev):
    """The conformance entry points (K10-K12), which no configuration
    serves: each case driven once through its entry point with the
    counters zeroed before and read after (the counts exact), then each
    output held against its plain twin and timed.  Returns (kernel
    reports, the drive's launch counts)."""
    from ggml_hexagon_tpu_torch import kernels

    name = "conformance entry points (K10-K12)"
    t_ph = phase(name, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    cases = conformance_cases(dev, gen)
    keys = {"K10": "qmm_wire", "K11": "flash_attn", "K12": "decode_attn_gqa"}
    sync(dev)
    kernels.reset_launches()
    outs, unit_launches = [], {}
    for kern, _, unit, entry, *_ in cases:
        before = kernels.LAUNCHES[keys[kern]]
        outs.append(entry())
        unit_launches[kern, unit] = (unit_launches.get((kern, unit), 0)
                                     + kernels.LAUNCHES[keys[kern]] - before)
    sync(dev)
    counts = dict(kernels.LAUNCHES)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for kern, *_ in cases:
        want[keys[kern]] += 1
    if counts != want:
        raise AssertionError(f"conformance launches {counts} != {want}")
    log(f"main-path launches ({name}): "
        f"{ {k: v for k, v in counts.items() if v} }")
    k12 = [entry for kern, _, _, entry, *_ in cases if kern == "K12"]
    log(f"  K12: {k12_kernel_counts(k12)} decode_gqa kernels in the profiler "
        f"for {len(k12)} calls (one a call, no merge kernel)")
    eight = "the 8B's Q4_K wq and gate, Q6_K down and head"
    prefill = "one 512-token prefill attention (B=1, H=32, T=512, S=1024, D=128)"
    reps = {
        ("K10", "b1"): KernelReport("qmm_wire_b1", "cuda", SRC_WIRE, K10_WIRE,
                                    f"{eight} at B=1, bf16 compute (the "
                                    "streaming GEMV): one launch each"),
        ("K10", "b8"): KernelReport("qmm_wire_b8", "cuda", SRC_WIRE, K10_WIRE,
                                    f"{eight} at B=8, bf16 compute (the "
                                    "streaming GEMV): one launch each"),
        ("K10", "b512"): KernelReport("qmm_wire_b512", "cuda", SRC_WIRE_GEMM,
                                      K10_WIRE, "the 8B's wq, gate and down "
                                      "at B=512, bf16 compute (the wgmma "
                                      "GEMM): one launch each"),
        ("K10", "f32_b8"): KernelReport("qmm_wire_f32_b8", "cuda", SRC_WIRE,
                                        K10_WIRE, "the 8B's Q4_K wq at B=8, "
                                        "f32 compute (the f32 GEMV): one "
                                        "launch"),
        ("K10", "f32_b512"): KernelReport("qmm_wire_f32_b512", "cuda",
                                          SRC_WIRE_GEMM, K10_WIRE,
                                          "the 8B's Q4_K wq at B=512, f32 "
                                          "compute (the GEMM, three TF32 "
                                          "products): one launch"),
        ("K11", "float32"): KernelReport("flash_attn_f32", "cuda", SRC_ATTN,
                                         K11_FLASH, f"{prefill}, f32: one "
                                         "launch"),
        ("K11", "bfloat16"): KernelReport("flash_attn_bf16", "cuda", SRC_ATTN,
                                          K11_FLASH, f"{prefill}, bf16 q, k, "
                                          "v: one launch"),
        ("K12", "step"): KernelReport("decode_attn_gqa", "cuda", SRC_ATTN,
                                      K12_GQA, "one decode-step attention at "
                                      "pos 700 (B=1, Hkv=8, G=4, S=1024, "
                                      "bf16 cache): one launch")}
    log(f"K10 NMSE <= {NMSE_KERNEL} (f32 compute: {NMSE_K10_F32}), K11/K12 "
        f"max|d| <= {ATTN_MAX_ABS} against the plain twins; times are "
        "medians, L2 flushed")
    for (kern, label, unit, entry, plain, (byts, ops, peak), lib, limit,
         control), got in zip(cases, outs):
        want_ = plain()
        if kern == "K10":
            err, e2 = held(f"K10 {label}", got, want_, limit)
            if control is not None:
                c1, c2 = control(want_)
                log(f"  K10 {label}: TF32 controls nmse one product "
                    f"{c1:.2e}, two {c2:.2e} (limit {limit})")
                if not min(c1, c2) > limit:
                    raise AssertionError(f"K10 {label}: a TF32 control "
                                         f"passes the f32 limit {limit}")
        else:
            torch.cuda.synchronize()
            err, e2 = float((got - want_).abs().max()), nmse(got, want_)
            if not (err <= ATTN_MAX_ABS and torch.isfinite(got).all()):
                raise AssertionError(f"{kern} {label}: max|d| {err}")
        del want_
        ms = time_ms(entry, iters=10)
        pms = time_plain_ms(plain)
        lms = lib() if lib is not None else None
        bms, by = bound_ms(byts, ops, peak)
        log(f"  {kern} {label}: max|d|={err:.3e} nmse={e2:.2e} "
            f"kernel={ms:.4f}ms plain={pms:.3f}ms library="
            f"{'n/a' if lms is None else f'{lms:.4f}ms'} bound={bms:.4f}ms "
            f"({by}) {bms / ms:.0%} of bound")
        if (kern, unit) in reps:
            reps[kern, unit].add(1, err, ms, pms, byts, ops, peak, lms)
    for key, rep in reps.items():
        # a unit's launches: those its cases made in the drive above
        rep.launches = unit_launches[key]
    del cases, outs
    phase_end(name, dev, t_ph)
    gc.collect()
    torch.cuda.empty_cache()
    return list(reps.values()), counts


#: the load phase's requests from text: (KV type, prompt tokens, tokens
#: generated), on one loaded model
LOAD_REQUESTS = [("bf16", 512, 32), ("q8_0", 512, 32), ("q4_0", 512, 32),
                 ("q4_0", 128, 32), ("q4_0", 7, 16)]
SRC_K4 = "ggml_hexagon_tpu_torch/csrc/decode_attn.cu"
K4_ATTN = "ggml_hexagon_tpu/ops/decode_attn.py:177"


def load_prompts(tok, words):
    """Texts whose encodings are 512, 128 and 7 tokens (the BOS and one
    token a word of the synthetic vocabulary), each checked to round-trip
    through the tokenizer; -> {tokens: (text, ids)}."""
    out = {}
    for n in (512, 128, 7):
        text = " ".join(words[(7 * i) % len(words)] for i in range(n - 1))
        ids = tok.encode(text)
        if len(ids) != n or tok.decode(ids) != text:
            raise AssertionError(f"prompt of {n} tokens: {len(ids)} tokens, "
                                 f"round trip {tok.decode(ids) == text}")
        out[n] = (text, ids)
    return out


def held_pack(dev, reader, name):
    """pack_tensor on the card byte-equal to the plain CPU call on one
    tensor of the file; -> its type's name."""
    from ggml_hexagon_tpu_torch.quant.pack import pack_tensor

    t = reader.tensors[name]
    raw = reader.tensor_bytes(name).copy()
    want = pack_tensor(raw, t.ggml_type, t.shape)
    got = pack_tensor(torch.from_numpy(raw).to(dev), t.ggml_type, t.shape)
    for f in ("q", "qh", "d", "sc", "dmin", "m"):
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None) or (a is not None and not (
                a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b))):
            raise AssertionError(f"pack_tensor {name} {f}: card != CPU")
    return t.ggml_type.name


def d2h_copies(fn):
    """Device-to-host memcpy records in a profiler run of fn, or None when
    the trace holds no device record at all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if "CUDA" in str(getattr(e, "device_type", ""))]
    if not dev_events:
        return None
    return sum("Memcpy DtoH" in e.name for e in dev_events)


def k4_q4_rows(dev, cfg, rep):
    """K4 over a q4_0 cache against its plain twin at the 8B's shapes (S =
    1024, pos 700, B = 1 and 8), timed beside SDPA on the cache
    dequantized to bf16 beforehand; B = 1 goes into `rep` (32 launches a
    step)."""
    from ggml_hexagon_tpu_torch.ops import decode_attn as PD
    from ggml_hexagon_tpu_torch.ops.basic import rope_freqs

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    Hq, Hkv, D, S, pos = cfg.n_head, cfg.n_head_kv, cfg.hd, 1024, 700
    for B in (1, 8):
        qkv = torch.randn(B, (Hq + 2 * Hkv) * D, generator=gen, device=dev)
        kq, vq = (torch.randint(-7, 8, (B, S, Hkv * D), device=dev,
                                dtype=torch.int8, generator=gen)
                  for _ in range(2))
        kc, vc = PD.pack_int4(kq), PD.pack_int4(vq)
        ks = torch.rand(B, S, device=dev, generator=gen) * 0.02
        vs = torch.rand(B, S, device=dev, generator=gen) * 0.02
        posb = torch.full((B,), pos, dtype=torch.int32, device=dev)
        inv, ms_ = rope_freqs(cfg.rope_params, dev)
        ang = posb[:, None].float() * inv[None]
        cs = (torch.cat([torch.cos(ang), torch.sin(ang)], 1) * ms_).contiguous()
        kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5, k_scale=ks,
                  v_scale=vs, kv_bits=4)
        got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
        want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        e2 = nmse(torch.cat(got, 1), torch.cat(want, 1))
        if not (err <= ATTN_MAX_ABS and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"K4 q4_0 B={B} pos={pos}: {err}")
        ms = time_ms(lambda: PD.decode_attn(qkv, kc, vc, posb, cs, **kw))
        pms = time_plain_ms(
            lambda: PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw))
        # the yardstick: SDPA on the live cache dequantized to bf16 beforehand
        q4 = qkv[:, :Hq * D].reshape(B, Hq, 1, D).to(torch.bfloat16)
        k4 = (kq[:, :pos + 1].float() * ks[:, :pos + 1, None]).to(
            torch.bfloat16).reshape(B, pos + 1, Hkv, D).transpose(1, 2)
        v4 = (vq[:, :pos + 1].float() * vs[:, :pos + 1, None]).to(
            torch.bfloat16).reshape(B, pos + 1, Hkv, D).transpose(1, 2)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True))
        byts = (nbytes(qkv, cs, *got) + 2 * B * pos * Hkv * D // 2
                + 2 * B * pos * 4)
        ops = 4 * B * (pos + 1) * Hq * D
        bms, by = bound_ms(byts, ops, BF16_OPS)
        log(f"  q4_0 B={B} pos={pos}: max|d|={err:.3e} nmse={e2:.2e} "
            f"kernel={ms:.4f}ms plain={pms:.3f}ms sdpa(bf16 dequantized "
            f"cache)={lib:.4f}ms bound={bms:.5f}ms ({by})")
        if B == 1:
            rep.add(cfg.n_layer, err, ms, pms, byts, ops, BF16_OPS, lib)


def run_load(dev):
    """Llama-3-8B Q4_K_M from a GGUF file, served from text: the file
    (random centred blocks of the Q4_K_M mixture, the 8B's llama.*
    metadata, a synthetic llama-bpe vocabulary of 128256 tokens) written
    into a temporary directory, or into a bytearray when its filesystem
    lacks room, loaded through Engine.from_gguf(fuse=True), pack_tensor
    held on the card against the CPU, requests from text under bf16, q8_0
    and q4_0 KV held to the 8B's launch table (one decode_attn_q4 a layer
    a step under q4_0), generate_ondevice held to the host's greedy
    tokens and to its seed with no device-to-host copy in its decode loop,
    and K4 over a q4_0 cache held against its plain twin.  Returns (kernel
    reports, the requests' launch counts)."""
    import shutil
    import tempfile

    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig
    from ggml_hexagon_tpu_torch.models.synth import (LLAMA3_8B,
                                                     draw_gguf_tensors,
                                                     gguf_data_bytes,
                                                     llama_bpe_vocab,
                                                     write_gguf)
    from ggml_hexagon_tpu_torch.runtime.device_sampling import DeviceSamplerParams
    from ggml_hexagon_tpu_torch.runtime.engine import PREFILL_BUCKETS, Engine
    from ggml_hexagon_tpu_torch.runtime.sampling import greedy_chain

    name = "Llama-3-8B Q4_K_M from a GGUF file"
    t_ph = phase(name, dev)
    cfg = LlamaConfig(**LLAMA3_8B)
    fields, words = llama_bpe_vocab()
    need = gguf_data_bytes(cfg, "Q4_K_M")
    tmp = tempfile.mkdtemp(prefix="ght_gguf_")
    try:
        free = shutil.disk_usage(tmp).free
        if free > need + 2 ** 30:
            src = os.path.join(tmp, "llama-3-8b-q4_k_m-synthetic.gguf")
            where = f"a file in {tmp}"
        else:
            src = bytearray()
            where = "a bytearray (GGUFReader.from_buffer)"
        info = write_gguf(src, cfg, "Q4_K_M", seed=0, vocab_fields=fields,
                          device=dev)
        log(f"wrote {info['bytes']} bytes ({info['bytes'] / 1e9:.3f} GB) into "
            f"{where} in {info['seconds']:.1f} s; the temporary filesystem "
            f"had {free} bytes free")
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        eng = Engine.from_gguf(src, fuse=True, max_seq=1024, device=dev)
        log(f"Engine.from_gguf(fuse=True): t_load {eng.perf.t_load:.2f} s, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
            f"{eng.cfg.n_layer} layers, rope {eng.cfg.rope_mode}, vocab "
            f"{eng.vocab.n_tokens} ({eng.vocab.model}/{eng.vocab.pre}, bos "
            f"{eng.vocab.bos_id}, eos {eng.vocab.eos_id})")
        reader = (GGUFReader.open(src) if isinstance(src, str)
                  else GGUFReader.from_buffer(src))
        with reader:
            packed = [held_pack(dev, reader, n) for n in
                      ("blk.0.attn_q.weight", "blk.0.attn_v.weight")]
        log(f"pack_tensor on the card byte-equal to the CPU on {packed}")
        _, drawn = next(draw_gguf_tensors(cfg, "Q4_K_M", 0, dev))
        te = eng.weights["tok_embd"]
        for f in ("q", "d", "sc", "dmin", "m"):
            if not torch.equal(getattr(te, f)[:te.n].to(torch.float32),
                               getattr(drawn, f)[:te.n].to(torch.float32)):
                raise AssertionError(f"tok_embd {f}: loaded != drawn")
        log("the loaded tok_embd wire planes equal the draw")
        del drawn, te
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"removed {tmp}")
    del src
    gc.collect()
    tok = eng.tokenizer
    prompts = load_prompts(tok, words)
    log(f"prompts of {sorted(prompts)} tokens round-trip through the "
        "tokenizer")
    table = LAUNCH_TABLES["Llama-3-8B Q4_K_M"]
    engines = {kv: Engine(eng.cfg, eng.weights, eng.vocab, max_seq=1024,
                          kv_dtype=kv, device=dev)
               for kv in ("bf16", "q8_0", "q4_0")}
    del eng

    def want(kv, rows, step):
        c = want_launches(table, rows, step)
        if kv == "q4_0":
            c["decode_attn_q4"], c["decode_attn"] = c["decode_attn"], 0
        return c

    kernels.reset_launches()
    greedy = {}
    for kv, n_prompt, n_gen in LOAD_REQUESTS:
        e = engines[kv]
        e.reset()
        text, ids = prompts[n_prompt]
        before = dict(kernels.LAUNCHES)
        sync(dev)
        t0 = time.perf_counter()
        it = e.generate(ids, n_gen, sampler=greedy_chain())
        toks = [next(it)]
        ttft = time.perf_counter() - t0
        pre = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        bucket = next(b for b in PREFILL_BUCKETS if b >= n_prompt)
        if pre != want(kv, bucket, False):
            raise AssertionError(f"prefill launches {pre} != "
                                 f"{want(kv, bucket, False)}")
        mid, n0 = dict(kernels.LAUNCHES), e.perf.n_decode
        t0 = time.perf_counter()
        toks += list(it)
        dt = time.perf_counter() - t0
        steps = e.perf.n_decode - n0
        dec = {k: kernels.LAUNCHES[k] - mid[k] for k in mid}
        want_dec = {k: v * steps for k, v in want(kv, 1, True).items()}
        if dec != want_dec or steps < 1:
            raise AssertionError(f"decode launches {dec} != {want_dec}")
        out = tok.decode(toks)
        greedy.setdefault((kv, n_prompt), toks)
        per = {k: v // steps for k, v in dec.items() if v}
        SUMMARY.setdefault(name, {})[f"{kv} p{n_prompt}"] = (
            f"TTFT {ttft * 1e3:.1f} ms, {steps / dt:.2f} tok/s")
        log(f"  request kv={kv} prompt={n_prompt} gen={n_gen}: TTFT "
            f"{ttft * 1e3:.1f} ms, decode {steps / dt:.2f} tok/s "
            f"({dt / steps * 1e3:.2f} ms/step), {len(toks)} tokens, launches "
            f"per decode step {per}, text {out[:60]!r}")
    counts = dict(kernels.LAUNCHES)
    missing = [k for k in ("qp8_gemv", "qp8_dual", "qp8_gemm", "decode_attn",
                           "decode_attn_q4") if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"main-path launches ({name}): { {k: v for k, v in counts.items() if v} }")

    # generate_ondevice: greedy equals the host chain; a seeded draw repeats
    e = engines["bf16"]
    _, ids = prompts[512]
    e.reset()
    dev_greedy = list(e.generate_ondevice(ids, 32))
    if dev_greedy != greedy[("bf16", 512)]:
        raise AssertionError(f"generate_ondevice(temp=0) {dev_greedy} != host "
                             f"greedy {greedy[('bf16', 512)]}")
    p = DeviceSamplerParams(temp=0.8, top_k=40, top_p=0.95)
    runs = []
    for _ in range(2):
        e.reset()
        sync(dev)
        t0 = time.perf_counter()
        runs.append(list(e.generate_ondevice(ids, 32, p, seed=1234)))
        dt = time.perf_counter() - t0
    if len(runs[0]) != 32 or runs[0] != runs[1]:
        raise AssertionError(f"seeded generate_ondevice: {runs}")
    log(f"generate_ondevice: temp=0 gives the host greedy tokens; temp=0.8 "
        f"top_k=40 top_p=0.95 seed 1234 runs to 32 tokens and repeats "
        f"({dt * 1e3:.1f} ms for prefill + 31 steps): "
        f"{[int(t) for t in runs[0][:8]]}...")
    for attempt in range(3):
        e.reset()
        c1 = d2h_copies(lambda: e.generate_ondevice(ids[:7], 1, p, seed=1))
        e.reset()
        c8 = d2h_copies(lambda: e.generate_ondevice(ids[:7], 8, p, seed=1))
        if c1 and c8:
            break
        log(f"  the profiler recorded no device-to-host copy (window "
            f"{attempt + 1}: {c1}, {c8}); tracing again")
    else:
        raise AssertionError("the profiler saw no device record in three windows")
    if c8 != c1:
        raise AssertionError(f"generate_ondevice: {c8} device-to-host copies "
                             f"over 7 decode steps against {c1} with none")
    log(f"generate_ondevice: {c1} device-to-host copy with no decode step, "
        f"{c8} with 7 (the tokens read once at the end; none in the loop)")
    log("where the time goes under q4_0 KV (profiler; after the counts were "
        "read)")
    profile_path(dev, e.cfg, e.weights, table, name, kvs=("q4_0",))
    del engines, e
    gc.collect()
    torch.cuda.empty_cache()

    log(f"K4 decode_attn over a q4_0 cache (S=1024, max|d| <= {ATTN_MAX_ABS})")
    rep = KernelReport("decode_attn_q4", "cuda", SRC_K4, K4_ATTN,
                       "one decode step at pos 700 of 1024 (B=1), q4_0 KV: "
                       "32 launches")
    k4_q4_rows(dev, cfg, rep)
    phase_end(name, dev, t_ph)
    return [rep], counts


def build_phase(name, builder, dev):
    """Build a configuration on the card and print its layout."""
    t0 = time.perf_counter()
    cfg, weights = builder(seed=0, device=dev)
    torch.cuda.synchronize()
    types = {}
    for lw in weights["layers"]:
        for key, v in lw.items():
            if hasattr(v, "fq"):
                types.setdefault(key, set()).add(f"{v.cfg.qtype.name}/{v.fl}")
    log(f"{name} (random planes, seed 0): built on the card in "
        f"{time.perf_counter() - t0:.1f} s; matmul planes "
        f"{plane_gb(weights):.3f} GB; {cfg.n_layer} layers"
        + (f", {cfg.n_expert} experts, top-{cfg.n_expert_used}"
           if cfg.n_expert else "")
        + f"; per-tensor types { {k: sorted(v) for k, v in types.items()} }, "
        f"head {weights['output'].cfg.qtype.name}/{weights['output'].fl}, "
        f"embedding {weights['tok_embd'].cfg.qtype.name} (wire); resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, weights


def run_phase(name, builder, check, dev):
    """One configuration: build, kernel checks (`check`), serving held to
    its launch table, profile, end-to-end comparison; the model is freed
    after.  Returns (kernel reports, the main path's launch counts)."""
    t_ph = phase(name, dev)
    cfg, weights = build_phase(name, builder, dev)
    reports = check(dev, weights, cfg)
    log_gemm_cell(name)
    log_bucket8_cell(name)
    log("serving (launch counters zeroed before, read after)")
    counts = serve(dev, cfg, weights, name)
    log(f"main-path launches ({name}): {counts}")
    log("where the time goes (profiler; after the counts were read)")
    profile_path(dev, cfg, weights, LAUNCH_TABLES[name], name)
    log(f"kernel vs plain versions, end to end (logits NMSE <= {NMSE_LOGITS}"
        + (f"; routing flips must have margin < {FLIP_MARGIN})" if cfg.n_expert
           else ")"))
    compare_plain(dev, cfg, weights)
    phase_end(name, dev, t_ph)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return reports, counts


#: per configuration, its requests' TTFT and decode rate and its profiled
#: prefill and decode step (host and device ms, the device's idle share),
#: printed together near the end of the output
SUMMARY: dict = {}


def log_summary():
    """The cells' end-to-end figures, one line each, late in the output."""
    log("cells (host clock; device time from the profiler):")
    for name, rows in SUMMARY.items():
        log(f"  {name}: " + " | ".join(f"{k}: {v}" for k, v in rows.items()))


def plane_gb(weights):
    qts = [v for lw in weights["layers"] for v in lw.values() if hasattr(v, "fq")]
    return sum(plane_bytes(v) for v in qts + [weights["output"]]) / 1e9


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.models.synth import (build_8b, build_8b_il,
                                                     build_8b_iq3xxs,
                                                     build_8b_iq4xs,
                                                     build_mixtral,
                                                     build_mixtral_iq3xxs,
                                                     build_mixtral_iq4xs,
                                                     build_mixtral_q4km_il)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    compiling = kernels.build_all()
    log(f"kernel build: {compiling:.1f} s compiling, "
        f"{time.perf_counter() - t0:.1f} s to loaded")

    # the conformance phase first (see the module's docstring, 13.)
    reports, counts = run_conformance(dev)
    runs = [counts]
    reps, counts = run_load(dev)
    reports += reps
    runs.append(counts)
    for name, builder, check in (
            ("Llama-3-8B Q4_K_M", build_8b, check_kernels),
            ("Mixtral-8x7B Q5_K_M", build_mixtral, check_kernels_moe),
            ("Llama-3-8B IQ4_XS", build_8b_iq4xs, check_kernels_il),
            ("Mixtral-8x7B IQ4_XS", build_mixtral_iq4xs, check_kernels_il),
            ("Llama-3-8B Q4_K_M il", build_8b_il, check_kernels_nibble),
            ("Mixtral-8x7B Q4_K_M il", build_mixtral_q4km_il,
             check_kernels_nibble),
            ("Llama-3-8B IQ3_XXS", partial(build_8b_iq3xxs, "t"),
             check_kernels_coded),
            ("Llama-3-8B IQ3_XXS il", partial(build_8b_iq3xxs, "il"),
             check_kernels_coded),
            ("Mixtral-8x7B IQ3_XXS il", partial(build_mixtral_iq3xxs, "il"),
             check_kernels_coded),
            ("Mixtral-8x7B IQ3_XXS", partial(build_mixtral_iq3xxs, "t"),
             check_kernels_coded),
            ("Llama-3-8B Q4_K_M il ffn", partial(build_8b_il, ffn_fused=True),
             check_kernels_ffn)):
        reps, counts = run_phase(name, builder, check, dev)
        reports += reps
        runs.append(counts)

    reports += list(GEMM_REPORTS.values())
    for r in reports:
        r.d["launches"] = (r.launches if r.launches is not None
                           else sum(c.get(r.d["name"], 0) for c in runs))
        if r.d["launches"] == 0:
            raise AssertionError(f"{r.d['name']} never launched on the main path")
    log(f"whole run {time.perf_counter() - t_all:.1f} s")
    log_summary()
    log(json.dumps({"kernels": [r.d for r in reports]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
