"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--depth N]

Phases 2-12 run their configuration's first PHASE_DEPTH (8) layers, at
full width, the types those layers have in the full-depth file (--depth
0: every layer; a depth from 1 to 7, or past the configurations' 32
layers, is refused: the short cuts lack down types that the phases'
checks look for); each phase's launches are
held to the table models/launches.launch_table derives from its built
layers (at full depth the tables these phases were held to by hand,
which tests/test_torch_launch_tables.py keeps).  Phases 13-17 run at
full depth; phase 18 writes the 8B's first QUANT_DEPTH (2) layers and
phase 19 the 70B's first LLAMA70_DEPTH (8) of 80.

1. builds the port's CUDA kernels from ggml_hexagon_tpu_torch/csrc;
2. Llama-3-8B Q4_K_M (the first slice's path): holds K1 (qp8 decode GEMV),
   K2 (dual QKV GEMV), K3 (qp8 prefill GEMM: wgmma on weights decoded in
   registers, x by TMA; at M = 512 and at the 32- and 128-token buckets)
   and K4 (fused decode attention, the live slots split over blocks and
   merged; at pos 0, 1, 700 and 1023) against their plain PyTorch
   versions at the main path's shapes, timing kernel, plain version and a
   one-call PyTorch yardstick
   with CUDA events; builds the random model at full width on
   the card and serves greedy requests through Engine (bf16 and q8_0 KV),
   the launch counters zeroed just before and read just after; profiles a
   prefill and decode steps; compares kernels and plain versions end to
   end;
3. Mixtral-8x7B Q5_K_M (the second slice's path), after the 8B model is
   freed: the same phases at full width, with K5 (gathered-expert
   GEMV), K6 (interleaved Q8_0 matmul) and K1/K3 on Q5_K held against
   their plain versions, exact launch counts per decode step and prefill
   chunk, and the end-to-end comparison checking the expert routing of
   both runs layer by layer;
4. Llama-3-8B IQ4_XS (the third slice's path), after Mixtral is freed: the
   same phases, with K6's normed, residual and act modes (and its plain
   mode at prefill) held against their plain versions and the launch
   counts held to its table;
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
15. the continuous-batching server on the same file (run_serve, right
   after the load phase; the file is written once for both):
   BatchEngine.from_gguf (4 slots, max_seq 2048, bf16 KV) serves six
   requests at once, prompts of 7 to 1000 tokens, 32 greedy tokens each:
   every prompt tick (K3 on 4 x 128 rows; the head K1 on the slots'
   picked rows) and decode tick (K1/K2 at 4 rows, K4 with a position a
   row, idle rows parked at the last slot) held to its exact launches;
   each request alone on a fresh engine of the same shape, bit for bit;
   each request against Engine alone (B=1, the prompt in the server's
   128-token chunks): prefill logits within NMSE_LOGITS, every step's
   logits within ROUTE_NMSE, greedy tokens equal up to the first step
   whose top-2 gap is under GREEDY_GAP in either run (a token that differs
   before it must be a near-tie within twice the step's max |difference|);
   a seventh request extending a served one reuses all but one resident
   token and gives a cold run's tokens; four requests under q8_0 and q4_0
   KV, every tick held; speculative decoding with a draft sharing the
   target's weights (n_draft 4, p_min 0) against the non-speculative
   tokens, its acceptance at least SPEC_ACCEPT_MIN; the context shift (a
   200-token prompt and 100 tokens in 256 slots); a q4_0 slot saved,
   erased and restored into another slot; the HTTP server on loopback
   (four concurrent /completion, one as SSE, and /v1/chat/completions;
   /health, /slots, /metrics), its texts equal to engine.complete; K4 at
   the tick's shape (rows at 0, 31, 700 and one parked at 2047) against
   its plain twin; two decode ticks profiled (four live slots; one live
   and three parked).
16. the command-line tools on the same file (run_cli, right after the
   serving phase; the model loaded once and handed to the CLI with
   cli.preload, every subcommand through cli.main in-process): perplexity
   over three 512-token chunks of the synthetic vocabulary's words (145 K3
   launches a chunk, the head's among them, no K1), one chunk against the
   plain forward (logits NMSE <= NMSE_LOGITS, |d ln PPL| <= 1e-2) and
   profiled; K3 on the head (Q6_K 128256 x 4096) at M = 512 against its
   plain twin, its own row of the kernels line; imatrix on one chunk (the
   forward's tap route, 145 K3; 225 entries against the plain tap route);
   generate greedy with a prompt cache written and reused, save-load-state
   bit-equal, the draft model (the same file), lookup and lookahead, each
   the decoder's text and held to the Engine's greedy tokens by
   greedy_held, speculation with p_min 0 accepting at least
   SPEC_ACCEPT_MIN, q8_0 and q4_0 caches; embedding of three prompts and
   POST /v1/embeddings over loopback equal to extract_embeddings;
   eval-callback on 7 tokens (the tap route at K1's shapes: 145 K1, every
   tensor in the JAX forward's tap order); bench -p 512 -n 128.
17. Gemma-2-9B Q4_K_M (the nineteenth slice's path; right after the CLI
   phase, at full width and depth, 42 layers; models/synth.build_gemma2_9b
   with the file's Q4_K_M types, the head tied to the Q6_K embedding,
   256000 x 3584): K1 with the downs in its gelu act mode without a
   residual (the sandwich post-norms keep it out; wo raw), K2 on the Q4_K
   wqk + Q6_K wv pair at hd 256, K3 (the head at M = 512 among them) and
   K4 at a head width of 256 with the window and the logit cap 50 held
   against their plain versions; K4 at D = 256 under bf16, q8_0 and q4_0
   KV at pos 700 beside SDPA, and the window masking at pos 4700 of an
   8192-slot cache (the slots below it overwritten, no bit moving); the
   branches no served configuration launches driven alone with the
   counters zeroed, then held and timed: K6's gelu act mode at the down
   shape on interleaved planes, K1's and K6's relu (and, in phase 12,
   K9's gelu and relu at the 8B widths: no Gemma width takes K9).  The
   requests' launches exact, the gelu and D = 256 branches under their
   suffixed keys; the end-to-end comparison at 42 layers.
18. the quantizer (after phase 12, run_quantize): write_gguf writes the
   8B at full width, its first QUANT_DEPTH layers, as an f16 file; cli.main(["quantize", ..., "Q4_0"])
   quantizes it through the port's own native library (quantize.cpp built
   with g++ at first use; Q4_0 everywhere, a Q6_K head), its rate logged
   beside the host's core count; every tensor held byte-equal to the
   port's numpy encoder on sampled rows (a K-quant row apart at a
   tie-break held to the quality bound of tests/test_native.py), and the
   native Q4_0 / Q4_K / Q6_K encoders on one full-width tensor (4096 x
   14336) against numpy; the file loads through Engine.from_gguf(fuse=True)
   (pack_tensor on the card byte-equal to the CPU), K1 and K3 on its Q4_0
   t-planes (the first configuration that serves Q4_0) are held against
   their plain versions, greedy requests run with their launch table
   exact, and the kernels against the plain forward end to end;
19. Llama-3-70B IQ3_XXS (imatrix) from a GGUF file at full width
   (run_70b_iq3xxs): write_gguf writes the first LLAMA70_DEPTH layers of
   the 80-layer file with the full-depth policy's types (IQ2_S attn_q and
   attn_k, Q4_K attn_v, IQ3_S attn_output and token_embd, IQ3_XXS FFN, a
   Q5_K head; random wire bytes with finite, centred scales, 3.8 GB);
   Engine.from_gguf(fuse=True) expands the i-quants on the card
   (quant.pack.expand_wire, timed), held byte-equal to the numpy copy
   (quant.iquants.expand_to_planes) on four tensors; K2 (coded IQ2_S wqk +
   Q4_K wv, 9216 + 1024 x 8192), K1 (coded wo, gate_up at K = 8192, down
   at K = 28672; the Q5_K head, 128256 x 8192), K3 at M = 512 and K4 with
   64 query heads over 8 KV heads held against their plain versions; a
   512-token prompt and decode steps with the launch table exact, one
   decode step profiled, the kernels against the plain forward end to end.

K6 above 8 rows is its own kernel, the wgmma GEMM of csrc/fast_il_gemm.cu
(the ninth slice): every configuration whose prefill chunk runs it holds
it against its plain version at M = 32, 128 and 512 on the chunk's shapes,
and once at M = 1024 (outside the served path); its launches are counted
apart by family and bias (kernels.GEMM_LAUNCHES, exact per chunk:
its table's "gemm"), and one report each (fast_byte_gemm, ..._derived,
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
import argparse
import gc
import json
import os
import shutil
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
SRC_K4 = "ggml_hexagon_tpu_torch/csrc/decode_attn.cu"
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
    """Start a phase: log the device memory still in use (what an earlier
    phase left alive counts in this one's peak), reset the peak counter."""
    log(f"== {name}")
    if dev.type == "cuda":
        gc.collect()
        log(f"   device memory in use at the start: "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats(dev)
    return time.perf_counter()


def phase_end(name, dev, t0):
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured (CPU)")
    log(f"   {name}: {time.perf_counter() - t0:.1f} s, peak device memory "
        f"{peak}")


def mem_mark(dev, what):
    """Log the device memory in use and the phase's peak so far."""
    log(f"   device memory after {what}: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB in use, peak "
        f"so far {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


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
    from ggml_hexagon_tpu_torch.models.launches import launch_table
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
    t = launch_table(cfg, weights)
    K1 = KernelReport("qp8_gemv", "cuda", SRC_GEMV,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
                      f"one decode step (B=1): {t['step']['qp8_gemv']} launches")
    K2 = KernelReport("qp8_dual", "cuda", SRC_GEMV,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:475",
                      f"one decode step (B=1): {t['step']['qp8_dual']} launches")
    K3 = KernelReport("qp8_gemm", "cuda", SRC_GEMM,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:529",
                      f"one 512-token prefill chunk: {t['chunk']['qp8_gemm']} "
                      "launches")
    K4 = KernelReport("decode_attn", "cuda", SRC_K4,
                      "ggml_hexagon_tpu/ops/decode_attn.py:177",
                      f"one decode step at pos 700 of 1024 (B=1): "
                      f"{t['step']['decode_attn']} launches")

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


def want_launches(table, rows, step):
    """The exact launches of one forward over `rows` tokens (a decode step
    when `step`), all kernels, from a launch_table."""
    from ggml_hexagon_tpu_torch import kernels

    unit = "step" if step else ("bucket8" if rows <= 8 else "chunk")
    c = dict.fromkeys(kernels.LAUNCHES, 0)
    c.update(table[unit])
    return c


def serve(dev, cfg, weights, name, requests=None):
    """The main path: greedy requests through Engine, each prefill chunk
    and decode step held to its exact launch counts (the configuration's
    launch_table: the units' LAUNCHES, the chunk's K6 GEMM launches);
    returns the launch counts of the whole run (K6's GEMM under its
    GEMM_LAUNCHES keys), zeroed just before it, after checking that every
    kernel of the table ran."""
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.models.launches import launch_table
    from ggml_hexagon_tpu_torch.runtime.engine import PREFILL_BUCKETS, Engine

    table = launch_table(cfg, weights)
    rng = np.random.default_rng(0)
    gemm_table = table["gemm"]
    kernels.reset_launches()
    for kv, n_prompt, n_gen in requests or REQUESTS:
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
    missing = [k for unit in (table["step"], table["bucket8"], table["chunk"],
                              gemm_table)
               for k in unit if counts[k] == 0]
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
    configuration's launch_table), for each KV type of kvs; both
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


def act_mode(mode):
    """(act, with a residual) of a row's act mode: "act" silu with the
    residual (the llama down), "act_gelu" gelu without it (Gemma-2's),
    "act_gelu_res", "act_relu"; (None, ...) for the other modes."""
    if not mode.startswith("act"):
        return None, mode == "res"
    parts = mode.split("_")
    return (parts[1] if len(parts) > 1 else "silu"), (
        mode == "act" or parts[-1] == "res")


def k6_row(dev, gen, cfg, rep, name, qt, mode, B, count, bucket=0):
    """One K6 call on interleaved planes of any family (byte, nibble or
    coded), with or without a group bias (mode: plain, pre_il, normed, res,
    or an act mode, act_mode's): kernel vs plain version on the group sums the
    entry would hand it, kernel / plain / yardstick times and the bound;
    added to rep (when given) count times, at B = 512 (K6's GEMM on the
    512-token chunk) to its family's GEMM report count times, and at B = 8
    to the 8-token bucket's sum `bucket` times."""
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    K = qt.k
    kw = {}
    act, with_res = act_mode(mode)
    x = torch.randn(B, 2 * K if act else K, generator=gen,
                    device=dev).to(torch.bfloat16)
    if mode == "normed":
        kw = dict(wn=torch.rand(K, device=dev, generator=gen) + 0.5,
                  eps=cfg.rms_eps)
    elif with_res:
        kw = dict(res=torch.randn(B, qt.n, generator=gen, device=dev))
    if act:
        kw["act"] = act
    elif mode == "pre_il":
        kw = dict(pre_il=True)
    _, nkj = PF._pick_blocks(PF._padded_rows(B), K, PF._is_packed(qt.cfg),
                             qt.cfg.gs)
    kw["xg"] = PF.group_sums(qt, x, "act" if act else mode, kw.get("wn"), nkj,
                             act=act or "silu")
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
    ops = 2 * B * K * qt.n + bias_ops(qt, B)
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
    """One K1 call on t-planes (mode raw, normed, res, or an act mode,
    act_mode's): kernel vs plain version, kernel / plain / yardstick times
    and the bound; added to rep (when given) count times."""
    from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P

    act, with_res = act_mode(mode)
    x = torch.randn(B, 2 * qt.k if act else qt.k, generator=gen, device=dev)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(qt.k, device=dev, generator=gen) + 0.5,
                  eps=cfg.rms_eps)
    elif with_res:
        kw = dict(res=torch.randn(B, qt.n, generator=gen, device=dev))
    if act:
        kw["act"] = act
    got = P.qp8_gemv(x, qt, **kw)
    err, e2 = held(f"K1 {mode} {name} B={B}", got, P.qp8_gemv_plain(x, qt, **kw))
    ms = time_ms(lambda: P.qp8_gemv(x, qt, **kw))
    pms = time_plain_ms(lambda: P.qp8_gemv_plain(x, qt, **kw))
    deq = deq_t(qt)
    xl = x[:, :qt.k].to(torch.bfloat16)
    lib = time_ms(lambda: torch.matmul(xl, deq))
    del deq
    byts = plane_bytes(qt) + nbytes(x, got, kw.get("wn"), kw.get("res"))
    ops = 2 * B * qt.k * qt.n
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
    ops = 2 * M * qt.k * qt.n
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


def k9_inputs(dev, gen, cfg, lw, dn, B):
    """(attn, h, the kernel's arguments but the act) of a K9 call at B rows
    on a layer's planes in the megakernel layout."""
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    wo = lw["wo"]
    G, gs, d = wo.fs.shape[1], wo.cfg.gs, cfg.n_embd
    attn = torch.randn(B, d, generator=gen, device=dev).to(torch.bfloat16).float()
    h = torch.randn(B, d, generator=gen, device=dev).to(torch.bfloat16).float()
    x_a = PF._interleave_x(attn, G, gs).to(torch.bfloat16).contiguous()
    xg_a = PF._sums_natural(attn, G).contiguous()
    h_il = PF._interleave_x(h, G, gs).contiguous()
    return attn, h, (x_a, xg_a, h_il, lw["ffn_norm_il"], wo, lw["w_gateup_il"],
                     dn, cfg.rms_eps)


def drive_branches(what, calls, want):
    """Kernel branches that no served configuration launches, driven alone
    (the conformance phase's way): the counters zeroed, each call once,
    then LAUNCHES read and held to `want` ({key: launches})."""
    from ggml_hexagon_tpu_torch import kernels

    kernels.reset_launches()
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if got != want:
        raise AssertionError(f"{what}: branch launches {got} != {want}")
    log(f"{what}: driven alone with the counters zeroed: {got}")
    return got


def k9_row(dev, gen, cfg, rep, name, lw, dn, B, count, act="silu"):
    """One K9 call on a layer's planes in the megakernel layout (dn: the
    layer's own down planes, or another type's drawn at the same shape),
    phase B's act `act`: kernel vs plain version on the same inputs,
    kernel and plain times and the bound; with `rep`, count times into rep,
    and for silu the three K6 launches of the split path on the same
    planes un-permuted (wo residual mode, gate_up normed, down act), timed
    in the same way."""
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.ops import ffn_fused as PFF
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF

    d, wo, gu, wn = cfg.n_embd, lw["wo"], lw["w_gateup_il"], lw["ffn_norm_il"]
    n_ff = dn.k
    attn, h, args = k9_inputs(dev, gen, cfg, lw, dn, B)
    x_a, xg_a, h_il = args[:3]
    args = args + (act,)
    got = kernels.ffn_fused(*args)
    err, e2 = held(f"K9 {act} {name} B={B}", got, PFF.ffn_fused_plain(*args))
    ms = time_ms(lambda: kernels.ffn_fused(*args))
    pms = time_plain_ms(lambda: PFF.ffn_fused_plain(*args))
    planes = plane_bytes(wo) + plane_bytes(gu) + plane_bytes(dn)
    byts = planes + nbytes(x_a, xg_a, h_il, wn, got)
    ops = (2 * B * (d * d + 2 * n_ff * d + n_ff * d) + bias_ops(wo, B)
           + bias_ops(gu, B) + bias_ops(dn, B))
    bms, by = bound_ms(byts, ops, BF16_OPS)
    line = (f"  K9 {act} {name:9s} down {dn.cfg.qtype.name} {PF._family(dn.cfg)} "
            f"B={B} max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms "
            f"plain={pms:.3f}ms bound={bms:.4f}ms ({by}) {bms / ms:.0%} of "
            f"bound; planes {planes / 1e6:.2f} MB")
    if rep is None or act != "silu":
        log(line)
        if rep is not None:
            rep.add(count, err, ms, pms, byts, ops, BF16_OPS)
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
    # phase B's gelu and relu instances: no configuration runs K9 with
    # them (Gemma-2's post-norms and G = 3584 / 32 = 112 keep it off K9,
    # in both packages), so they are driven alone at the 8B widths
    from ggml_hexagon_tpu_torch import kernels

    KG = KernelReport("ffn_fused_gelu", "cuda", SRC_FFN, K9_FFN,
                      "its drive at the 8B il widths (B=1): a Q4_K and a "
                      "Q6_K down, gelu")
    KR = KernelReport("ffn_fused_relu", "cuda", SRC_FFN, K9_FFN,
                      "its drive at the 8B il widths (B=1): a Q4_K down, relu")
    cases = (("gelu", "down_q4k", lw4, KG), ("gelu", "down_q6k", lw6, KG),
             ("relu", "down_q4k", lw4, KR))
    got = drive_branches(
        "K9 gelu and relu", [partial(kernels.ffn_fused, *k9_inputs(
            dev, gen, cfg, lw, lw["ffn_down"], 1)[2], act)
            for act, _, lw, _ in cases],
        {"ffn_fused_nibble_gelu": 1, "ffn_fused_byte_gelu": 1,
         "ffn_fused_nibble_relu": 1})
    KG.launches = got["ffn_fused_nibble_gelu"] + got["ffn_fused_byte_gelu"]
    KR.launches = got["ffn_fused_nibble_relu"]
    log(f"K9 gelu and relu (kernel vs plain, NMSE <= {NMSE_KERNEL})")
    for act, name, lw, rep in cases:
        for B in (1, 8):
            k9_row(dev, gen, cfg, rep if B == 1 else None, name, lw,
                   lw["ffn_down"], B, 1, act=act)
    return [KN, KB, KG, KR]


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


def k4_rows(dev, cfg, rep):
    """K4 at cfg's heads against its plain twin (Gemma-2: D = 256, 16 query
    and 8 KV heads, its logit cap 50 and the even layers' window 4096;
    Llama-3-70B: D = 128, 64 query heads over 8 KV heads): bf16, q8_0 and
    q4_0 caches at pos 700 of 1024 (B = 1 and 4), timed beside SDPA (no
    cap: SDPA has none) on the live cache, dequantized to bf16 beforehand
    where quantized; with a window, then the window masking, at pos 4700
    of an 8192-slot bf16 cache: 4095 live slots (the bytes counted), and
    the slots below them overwritten without a bit moving.  B = 1 at pos
    700, bf16, goes into `rep` (a launch a layer a step)."""
    from ggml_hexagon_tpu_torch.ops import decode_attn as PD
    from ggml_hexagon_tpu_torch.ops.basic import rope_freqs

    gen = torch.Generator(device=dev)
    gen.manual_seed(2560)
    Hq, Hkv, D = cfg.n_head, cfg.n_head_kv, cfg.hd
    swa, cap = cfg.swa_window, cfg.attn_logit_softcap
    cases = [(kv, B, 1024, 700) for kv in ("bf16", "q8_0", "q4_0")
             for B in (1, 4)] + ([("bf16", 1, 8192, 4700)] if swa else [])
    for kv, B, S, pos in cases:
        qkv = torch.randn(B, (Hq + 2 * Hkv) * D, generator=gen, device=dev)
        kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=cfg.attn_scale or D ** -0.5,
                  swa=swa, logit_cap=cap)
        if kv == "bf16":
            kc, vc = (torch.randn(B, S, Hkv * D, generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
            kd = vd = None
        else:
            qmax = 127 if kv == "q8_0" else 7
            kq, vq = (torch.randint(-qmax, qmax + 1, (B, S, Hkv * D),
                                    device=dev, dtype=torch.int8,
                                    generator=gen) for _ in range(2))
            kd, vd = (torch.rand(B, S, device=dev, generator=gen) * 2.0 / qmax
                      for _ in range(2))
            kc, vc = ((PD.pack_int4(kq), PD.pack_int4(vq)) if kv == "q4_0"
                      else (kq, vq))
            kw.update(k_scale=kd, v_scale=vd,
                      kv_bits=4 if kv == "q4_0" else 0)
        posb = torch.full((B,), pos, dtype=torch.int32, device=dev)
        inv, ms_ = rope_freqs(cfg.rope_params, dev)
        ang = posb[:, None].float() * inv[None]
        cs = (torch.cat([torch.cos(ang), torch.sin(ang)], 1) * ms_).contiguous()
        got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
        want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        e2 = nmse(torch.cat(got, 1), torch.cat(want, 1))
        if not (err <= ATTN_MAX_ABS and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"K4 D={D} {kv} B={B} pos={pos}: {err}")
        lo = max(0, pos - swa + 1) if swa else 0
        if lo:  # the window masks: what lies below it moves no bit
            kc2, vc2 = kc.clone(), vc.clone()
            kc2[:, :lo] = kc[:, lo:2 * lo].flip(1)
            vc2[:, :lo] = vc[:, lo:2 * lo].flip(1)
            again = PD.decode_attn(qkv, kc2, vc2, posb, cs, **kw)
            if not torch.equal(again[0], got[0]):
                raise AssertionError(f"K4 D={D} pos={pos}: slots below the "
                                     "window moved the output")
            del kc2, vc2
        ms = time_ms(lambda: PD.decode_attn(qkv, kc, vc, posb, cs, **kw))
        pms = time_plain_ms(
            lambda: PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw))
        live = pos - lo
        q4 = qkv[:, :Hq * D].reshape(B, Hq, 1, D).to(torch.bfloat16)
        if kv == "bf16":
            k4, v4 = kc[:, lo:pos + 1], vc[:, lo:pos + 1]
        else:
            k4 = (kq[:, lo:pos + 1].float() * kd[:, lo:pos + 1, None]).to(
                torch.bfloat16)
            v4 = (vq[:, lo:pos + 1].float() * vd[:, lo:pos + 1, None]).to(
                torch.bfloat16)
        k4 = k4.reshape(B, live + 1, Hkv, D).transpose(1, 2)
        v4 = v4.reshape(B, live + 1, Hkv, D).transpose(1, 2)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True))
        elt = {"bf16": 2.0, "q8_0": 1.0, "q4_0": 0.5}[kv]
        byts = (nbytes(qkv, cs, *got) + int(2 * B * live * Hkv * D * elt)
                + (2 * B * live * 4 if kv != "bf16" else 0))
        ops = 4 * B * (live + 1) * Hq * D
        bms, by = bound_ms(byts, ops, BF16_OPS)
        log(f"  D={D} G={Hq // Hkv} {kv} B={B} pos={pos} of {S} (live "
            f"{live}, window {swa}, cap {cap}): max|d|={err:.3e} nmse={e2:.2e} "
            f"kernel={ms:.4f}ms plain={pms:.3f}ms sdpa={lib:.4f}ms "
            f"bound={bms:.5f}ms ({by})")
        if kv == "bf16" and B == 1 and pos == 700:
            rep.add(cfg.n_layer, err, ms, pms, byts, ops, BF16_OPS, lib)
        del kc, vc, got, want


def check_kernels_gemma2(dev, weights, cfg):
    """The Gemma-2-9B Q4_K_M main path's kernels against their plain
    versions at its shapes: K1 (wqkv and gate_up normed, wo raw, the
    post-norms keeping the residual out; the downs in the gelu act mode
    without a residual; the tied Q6_K head, 256000 x 3584), K2 (Q4_K wqk +
    Q6_K wv at hd 256), K3 at M = 512, K4 at D = 256 (k4_rows); then
    the branches its t-planes do not take, driven alone: K6's gelu act mode
    at its down shape on interleaved planes (a Q4_K nibble and a Q6_K byte
    down, drawn on the card), and relu on K1 and K6."""
    from ggml_hexagon_tpu_torch.models.launches import launch_table
    from ggml_hexagon_tpu_torch.models.synth import random_qtensor
    from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
    from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P
    from ggml_hexagon_tpu_torch.quant.formats import GGMLType

    gen = torch.Generator(device=dev)
    gen.manual_seed(1919)
    layers = weights["layers"]
    L = len(layers)
    full = next(lw for lw in layers if "wqkv" in lw)
    mixed = next(lw for lw in layers if "wqk" in lw)
    n_full = sum("wqkv" in lw for lw in layers)
    n_mixed = L - n_full

    def down(t):
        return next(lw["ffn_down"] for lw in layers
                    if lw["ffn_down"].cfg.qtype.name == t)

    dn_q4, dn_q6 = down("Q4_K"), down("Q6_K")
    n6 = sum(lw["ffn_down"].cfg.qtype.name == "Q6_K" for lw in layers)
    head = weights["output"]
    t = launch_table(cfg, weights)
    unit = "one Gemma-2-9B decode step (B=1)"
    KG = KernelReport("qp8_gemv_gelu", "cuda", SRC_GEMV,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
                      f"{unit}: {t['step']['qp8_gemv_gelu']} "
                      "launches (the downs, act gelu, no residual)")
    K4 = KernelReport("decode_attn_d256", "cuda", SRC_K4,
                      "ggml_hexagon_tpu/ops/decode_attn.py:177",
                      f"{unit} at pos 700 of 1024: {L} launches (D = 256, "
                      f"window {cfg.swa_window} on the even layers, cap "
                      f"{cfg.attn_logit_softcap})")
    log(f"K1 qp8_gemv on the Gemma-2-9B shapes (kernel vs plain, NMSE <= "
        f"{NMSE_KERNEL}; times are medians, L2 flushed)")
    for name, qt, mode, per_step, rep in (
            ("wqkv", full["wqkv"], "normed", n_full, None),
            ("wo", full["wo"], "raw", L, None),
            ("gate_up", full["w_gateup_il"], "normed", L, None),
            ("down_q4k", dn_q4, "act_gelu", L - n6, KG),
            ("down_q6k", dn_q6, "act_gelu", n6, KG),
            ("head_q6k", head, "raw", 1, None)):
        for B in (1, 8):
            k1_row(dev, gen, cfg, rep if B == 1 else None, name, qt, mode, B,
                   per_step)
    log(f"K2 qp8_dual at hd 256 (NMSE <= {NMSE_KERNEL})")
    for B in (1, 4):
        dual_row(dev, gen, cfg, None, mixed["wqk"], mixed["wv"], B, n_mixed)
    log(f"K3 qp8_gemm (M=512, NMSE <= {NMSE_KERNEL})")
    for name, qt in (("wqkv", full["wqkv"]), ("wqk", mixed["wqk"]),
                     ("wv", mixed["wv"]), ("wo", full["wo"]),
                     ("gate_up", full["w_gateup_il"]), ("down_q4k", dn_q4),
                     ("down_q6k", dn_q6), ("head_q6k", head)):
        k3_row(dev, gen, None, name, qt, 0)
    log(f"K4 decode_attn at D = 256 (max|d| <= {ATTN_MAX_ABS})")
    k4_rows(dev, cfg, K4)
    # the branches the t-planes do not take
    il = {name: random_qtensor(gen, cfg.n_embd, cfg.n_ff, qtype, dev)
          .with_fast_planes("il").without_wire()
          for name, qtype in (("down_q4k", GGMLType.Q4_K),
                              ("down_q6k", GGMLType.Q6_K))}
    KF = KernelReport("fast_gelu", "cuda", SRC_IL, K6_NIBBLE,
                      "its drive at Gemma-2-9B's down shape on interleaved "
                      "planes (B=1): a Q4_K nibble and a Q6_K byte down, "
                      "gelu, no residual")
    K1R = KernelReport("qp8_gemv_relu", "cuda", SRC_GEMV,
                       "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
                       "its drive at Gemma-2-9B's Q4_K down shape (B=1): relu")
    K6R = KernelReport("fast_relu", "cuda", SRC_IL, K6_NIBBLE,
                       "its drive at Gemma-2-9B's Q4_K down shape on "
                       "interleaved planes (B=1): relu")
    x2 = torch.randn(1, 2 * cfg.n_ff, generator=gen, device=dev)
    got = drive_branches(
        "K1 relu, K6 gelu and relu",
        [partial(PF.qmatmul_fast_act, x2, il["down_q4k"], "gelu"),
         partial(PF.qmatmul_fast_act, x2, il["down_q6k"], "gelu"),
         partial(P.qp8_matmul_act, x2, dn_q4, "relu"),
         partial(PF.qmatmul_fast_act, x2, il["down_q4k"], "relu")],
        {"fast_nibble_act_gelu": 1, "fast_byte_act_gelu": 1,
         "qp8_gemv_relu": 1, "fast_nibble_act_relu": 1})
    KF.launches = got["fast_nibble_act_gelu"] + got["fast_byte_act_gelu"]
    K1R.launches = got["qp8_gemv_relu"]
    K6R.launches = got["fast_nibble_act_relu"]
    log(f"K6 gelu and relu at the down shape, interleaved planes (NMSE <= "
        f"{NMSE_KERNEL})")
    for name, qt in il.items():
        for B in (1, 8):
            k6_row(dev, gen, cfg, KF if B == 1 else None, name, qt,
                   "act_gelu", B, 1)
    k6_row(dev, gen, cfg, K6R, "down_q4k", il["down_q4k"], "act_relu", 1, 1)
    log(f"K1 relu (NMSE <= {NMSE_KERNEL})")
    k1_row(dev, gen, cfg, K1R, "down_q4k", dn_q4, "act_relu", 1, 1)
    del il
    return [KG, K4, KF, K1R, K6R]


def write_synth_gguf(dev, cfg, ftype, fname, fields, has_imatrix=False,
                     depth=None, need_path=False):
    """A random model of cfg's shapes and ftype's mixture (synth.write_gguf,
    seed 0, the vocabulary's fields) written into a new temporary
    directory, or into a bytearray when its filesystem lacks room (unless
    need_path: then that raises).  Returns (the path or the buffer, the
    directory to remove after)."""
    import tempfile

    from ggml_hexagon_tpu_torch.models.synth import gguf_data_bytes, write_gguf

    need = gguf_data_bytes(cfg, ftype, has_imatrix, depth)
    tmp = tempfile.mkdtemp(prefix="ght_gguf_")
    free = shutil.disk_usage(tmp).free
    if free > need + 2 ** 30:
        src = os.path.join(tmp, fname)
        where = f"a file in {tmp}"
    elif need_path:
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError(f"{fname}: {need} bytes, the temporary "
                             f"filesystem has {free} free")
    else:
        src = bytearray()
        where = "a bytearray (GGUFReader.from_buffer)"
    try:
        info = write_gguf(src, cfg, ftype, seed=0, vocab_fields=fields,
                          device=dev, has_imatrix=has_imatrix, depth=depth)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    log(f"wrote {info['bytes']} bytes ({info['bytes'] / 1e9:.3f} GB) into "
        f"{where} in {info['seconds']:.1f} s; the temporary filesystem "
        f"had {free} bytes free")
    return src, tmp


def write_8b_gguf(dev):
    """The full-size Llama-3-8B Q4_K_M file that the load and serving phases
    read (random centred blocks of the Q4_K_M mixture, the 8B's llama.*
    metadata, a synthetic llama-bpe vocabulary of 128256 tokens), written
    once (write_synth_gguf).  Returns (the path or the buffer, the
    directory to remove after, the vocabulary's words)."""
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig
    from ggml_hexagon_tpu_torch.models.synth import LLAMA3_8B, llama_bpe_vocab

    fields, words = llama_bpe_vocab()
    src, tmp = write_synth_gguf(dev, LlamaConfig(**LLAMA3_8B), "Q4_K_M",
                                "llama-3-8b-q4_k_m-synthetic.gguf", fields)
    return src, tmp, words


def run_load(dev, src, words):
    """Llama-3-8B Q4_K_M from a GGUF file (write_8b_gguf's), served from
    text: loaded through Engine.from_gguf(fuse=True), pack_tensor
    held on the card against the CPU, requests from text under bf16, q8_0
    and q4_0 KV held to the 8B's launch table (one decode_attn_q4 a layer
    a step under q4_0), generate_ondevice held to the host's greedy
    tokens and to its seed with no device-to-host copy in its decode loop,
    and K4 over a q4_0 cache held against its plain twin.  Returns (kernel
    reports, the requests' launch counts)."""
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
    from ggml_hexagon_tpu_torch.models.launches import launch_table
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig
    from ggml_hexagon_tpu_torch.models.synth import LLAMA3_8B, draw_gguf_tensors
    from ggml_hexagon_tpu_torch.runtime.device_sampling import DeviceSamplerParams
    from ggml_hexagon_tpu_torch.runtime.engine import PREFILL_BUCKETS, Engine
    from ggml_hexagon_tpu_torch.runtime.sampling import greedy_chain

    name = "Llama-3-8B Q4_K_M from a GGUF file"
    t_ph = phase(name, dev)
    cfg = LlamaConfig(**LLAMA3_8B)
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
    gc.collect()
    tok = eng.tokenizer
    prompts = load_prompts(tok, words)
    log(f"prompts of {sorted(prompts)} tokens round-trip through the "
        "tokenizer")
    tables = {kv: launch_table(eng.cfg, eng.weights,
                               4 if kv == "q4_0" else 16)
              for kv in ("bf16", "q8_0", "q4_0")}
    engines = {kv: Engine(eng.cfg, eng.weights, eng.vocab, max_seq=1024,
                          kv_dtype=kv, device=dev)
               for kv in ("bf16", "q8_0", "q4_0")}
    del eng

    def want(kv, rows, step):
        return want_launches(tables[kv], rows, step)

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
    profile_path(dev, e.cfg, e.weights, tables["q4_0"], name, kvs=("q4_0",))
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


#: the serving phase's traffic: prompt lengths (random ids below the
#: vocabulary's specials) submitted at once, more than the slots, each
#: SERVE_GEN greedy tokens with no stop id
SERVE_PROMPTS = (7, 64, 128, 300, 512, 1000)
SERVE_GEN = 32
SERVE_SLOTS = 4
SERVE_SEQ = 2048
#: greedy comparisons between two routes run up to the first step whose
#: top-2 logit gap is under this in either run
GREEDY_GAP = 1e-2
#: logits of two routes of one request (the server's B = 4 ticks and the
#: Engine's B = 1 steps, a speculative verify and a decode tick, a reused
#: prefix and a cold prompt): other kernels at other shapes, NMSE ~1.2e-3
#: at the first decode step on the 8B; a wrong route (a position, a slot,
#: an accepted draft token) is far above it
ROUTE_NMSE = 1e-2
#: the 8B's speculative acceptance with a draft that shares the target's
#: weights (greedy, n_draft 4, p_min 0): 35.2% measured; a floor well above
#: a draft whose tokens the verify no longer takes
SPEC_ACCEPT_MIN = 0.20


class RecSampler:
    """Greedy (or `inner`), recording the logits of every sample and the
    time of each: what the server's slot sampled from."""

    def __init__(self, inner=None):
        from ggml_hexagon_tpu_torch.runtime.sampling import greedy_chain

        self.inner = inner or greedy_chain()
        self.logits, self.times = [], []

    def sample(self, logits):
        self.logits.append(np.array(logits, np.float32))
        self.times.append(time.perf_counter())
        return self.inner.sample(logits)


def _gap(row):
    top = np.partition(row, -2)[-2:]
    return float(abs(top[1] - top[0]))


def greedy_held(what, got, want):
    """Two greedy runs of one request, (tokens, sampled logits) each, over
    two routes: every step's logits within ROUTE_NMSE, and the same tokens
    up to the first step whose top-2 gap is under GREEDY_GAP in either run;
    a token that differs before it must be a near-tie that the measured
    difference explains (a top-2 gap of either run within twice the step's
    max |difference|), and ends the comparison.  Returns (steps compared,
    the largest NMSE over them, why it stopped: "" when it ran to the end,
    else "near-tie at step i (gap g)" or "tokens differ at step i, a
    near-tie (gap g, max|d| d)")."""
    (gt, gl), (wt, wl) = got, want
    n = min(len(gt), len(wt))
    worst = 0.0
    for i in range(n):
        a, b = torch.from_numpy(gl[i]), torch.from_numpy(wl[i])
        e = nmse(a, b)
        if not e <= ROUTE_NMSE:
            raise AssertionError(f"{what}: step {i} logits NMSE {e:.2e} > "
                                 f"{ROUTE_NMSE}")
        worst = max(worst, e)
        gap = min(_gap(gl[i]), _gap(wl[i]))
        if gap < GREEDY_GAP:
            return i, worst, f"near-tie at step {i} (gap {gap:.4f})"
        if gt[i] != wt[i]:
            d = float((a - b).abs().max())
            if gap > 2 * d:
                raise AssertionError(
                    f"{what}: token {i} {gt[i]} != {wt[i]} (gaps "
                    f"{_gap(gl[i]):.4f} / {_gap(wl[i]):.4f}, max|d| {d:.4f}, "
                    f"logits NMSE {e:.2e})")
            return i, worst, (f"tokens differ at step {i}, a near-tie (gap "
                              f"{gap:.4f}, max|d| {d:.4f})")
    if len(gt) != len(wt):
        raise AssertionError(f"{what}: {len(gt)} tokens != {len(wt)}")
    return n, worst, ""


def forced_held(what, cfg, weights, dev, prompt, got):
    """A greedy decoder's run, (tokens, sampled logits), held against one
    teacher-forced forward of the prompt and its own tokens (chunk_logits:
    every row's logits, K3 and _attention): each step's logits within
    ROUTE_NMSE of that forward's row, and each token that row's argmax
    wherever the row's top-2 gap exceeds twice the step's max |difference|.
    The reference follows the decoder's tokens, so every step is checked,
    past a near-tie too.  Returns (steps, the largest NMSE, the steps whose
    token was a near-tie of the reference)."""
    from ggml_hexagon_tpu_torch.runtime import evaluate as PE

    toks, lg = got
    if len(lg) < len(toks):
        raise AssertionError(f"{what}: {len(lg)} logits for {len(toks)} "
                             "tokens")
    seq = list(prompt) + list(toks[:-1])
    ref = PE.chunk_logits(cfg, weights, seq, device=dev)[len(prompt) - 1:]
    ref = ref.float().cpu()
    worst, ties = 0.0, []
    for i, t in enumerate(toks):
        a, b = torch.from_numpy(lg[i]), ref[i]
        e = nmse(a, b)
        if not e <= ROUTE_NMSE:
            raise AssertionError(f"{what}: step {i} logits NMSE {e:.2e} > "
                                 f"{ROUTE_NMSE} against the forced forward")
        worst = max(worst, e)
        want = int(torch.argmax(b))
        if t != want:
            d = float((a - b).abs().max())
            gap = _gap(b.numpy())
            if gap > 2 * d:
                raise AssertionError(
                    f"{what}: token {i} {t} != {want}, the forced forward's "
                    f"argmax (gap {gap:.4f}, max|d| {d:.4f})")
            ties.append(i)
    return len(toks), worst, ties


def serve_want(table, step, n_fwd=1):
    """Exact launches of n_fwd server forwards of the 8B Q4_K_M (table: its
    launch_table under the cache's kv_bits): a decode tick is the table's
    step at B = n_slots rows; a
    prompt tick its chunk at SERVE_SLOTS x 128 = 512 rows, except the
    head, which logits_idx runs on the slots' picked rows only (K1 at 4
    rows where the Engine's chunk runs K3 on every row)."""
    c = want_launches(table, 1 if step else SERVE_SLOTS * 128, step)
    if not step:
        c["qp8_gemm"] -= 1
        c["qp8_gemv"] += 1
    return {k: v * n_fwd for k, v in c.items()}


def held_ticks(be, kv, log_ticks):
    """Wrap be's ticks so that each is held to its exact launches
    (serve_want times the forwards the tick ran); log_ticks collects
    (kind, forwards, seconds)."""
    from ggml_hexagon_tpu_torch import kernels

    from ggml_hexagon_tpu_torch.models.launches import launch_table

    fwd = be._fwd
    n = [0]
    table = launch_table(be.cfg, be.weights, 4 if kv == "q4_0" else 16)

    def counting(*a, **k):
        n[0] += 1
        return fwd(*a, **k)

    be._fwd = counting

    def wrap(tick, step):
        def run(slots):
            before = dict(kernels.LAUNCHES)
            n[0] = 0
            t0 = time.perf_counter()
            tick(slots)
            dt = time.perf_counter() - t0
            got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            want = serve_want(table, step, n[0])
            if got != want:
                raise AssertionError(
                    f"{'decode' if step else 'prompt'} tick launches "
                    f"{ {k: v for k, v in got.items() if v} } != "
                    f"{ {k: v for k, v in want.items() if v} }")
            log_ticks.append(("decode" if step else "prompt", n[0], dt))
        return run

    be._prompt_tick = wrap(be._prompt_tick, False)
    be._decode_tick = wrap(be._decode_tick, True)


def engine_alone(eng, prompt, n):
    """The request through Engine alone (B=1), its prompt in the server's
    128-token chunks (the Engine's 8-token bucket runs the decode GEMVs,
    whose int8 activations the server's prompt ticks never see):
    (tokens, sampled logits)."""
    from ggml_hexagon_tpu_torch.server.batch_engine import PROMPT_CHUNK

    eng.reset()
    c = PROMPT_CHUNK
    eng._chunks = lambda t: [(min(c, t - i), c) for i in range(0, t, c)]
    rec = RecSampler()
    toks = list(eng.generate(prompt, n, sampler=rec, stop_ids=set()))
    return toks, rec.logits


def k4_serving_rows(dev, cfg):
    """K4 at the serving tick's shape against its plain twin: B = 4 rows at
    positions 0, 31 and 700 and one parked at S-1 = 2047 (which reads the
    whole prefix), bf16, int8 and int4 caches of S = 2048; -> ms a launch
    by cache type."""
    from ggml_hexagon_tpu_torch.ops import decode_attn as PD
    from ggml_hexagon_tpu_torch.ops.basic import rope_freqs

    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    Hq, Hkv, D, S, B = cfg.n_head, cfg.n_head_kv, cfg.hd, SERVE_SEQ, 4
    posb = torch.tensor([0, 31, 700, S - 1], dtype=torch.int32, device=dev)
    inv, ms_ = rope_freqs(cfg.rope_params, dev)
    ang = posb[:, None].float() * inv[None]
    cs = (torch.cat([torch.cos(ang), torch.sin(ang)], 1) * ms_).contiguous()
    qkv = torch.randn(B, (Hq + 2 * Hkv) * D, generator=gen, device=dev)
    out = {}
    for kind in ("bf16", "int8", "int4"):
        kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5)
        if kind == "bf16":
            kc, vc = (torch.randn(B, S, Hkv * D, generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
        else:
            qmax = 127 if kind == "int8" else 7
            kq, vq = (torch.randint(-qmax, qmax + 1, (B, S, Hkv * D),
                                    device=dev, dtype=torch.int8,
                                    generator=gen) for _ in range(2))
            kc, vc = ((kq, vq) if kind == "int8"
                      else (PD.pack_int4(kq), PD.pack_int4(vq)))
            kw.update(k_scale=torch.rand(B, S, device=dev, generator=gen) * 0.02,
                      v_scale=torch.rand(B, S, device=dev, generator=gen) * 0.02,
                      kv_bits=4 if kind == "int4" else 0)
        got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
        want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not (err <= ATTN_MAX_ABS and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"K4 {kind} B=4 S={S} pos {posb.tolist()}: "
                                 f"max|d| {err}")
        out[kind] = time_ms(lambda: PD.decode_attn(qkv, kc, vc, posb, cs, **kw))
        log(f"  K4 {kind} B=4 S={S} pos {posb.tolist()} (row 3 parked): "
            f"max|d|={err:.3e} kernel={out[kind]:.4f} ms a launch")
    return out


def profile_tick(dev, be, label):
    """One decode tick of be (its slots already generating) under the
    profiler: host ms, device ms, idle share, top device items and K4's
    device time a launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.step()
        host = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_ms, top = _device_ms(avgs, 1)
    _, k4 = _device_ms([e for e in avgs if "decode_attn" in e.key], 1)
    n_k4 = sum(cnt for _, cnt, _ in k4)
    k4_txt = ("not measured" if not n_k4 else
              f"{sum(ms for ms, _, _ in k4) / n_k4:.4f} ms a launch over "
              f"{n_k4} launches")
    idle = "not measured" if dev_ms is None else f"{1 - dev_ms / host:.1%}"
    log(f"  decode tick, {label}: host {host:.2f} ms, device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, idle "
        f"share {idle}; K4 {k4_txt}")
    for ms, cnt, key in top[:6]:
        log(f"      {ms:8.4f} ms  x{cnt:<4d} {key[:90]}")
    return host, dev_ms, idle


def run_serve(dev, src, smi):
    """The continuous-batching server on the full-size 8B Q4_K_M from
    write_8b_gguf's file: BatchEngine.from_gguf (n_slots 4, max_seq 2048,
    bf16 KV) serves six requests at once (prompts of 7 to 1000 tokens, 32
    greedy tokens each), every prompt tick (K3 on 4 x 128 rows, K1 on the
    head's picked rows) and decode tick (K1/K2 at 4 rows, K4 with a
    position a row, idle rows parked at the last slot) held to its exact
    launches; each request alone on a fresh engine of that shape (bit for
    bit) and against Engine alone (prefill logits NMSE <= NMSE_LOGITS,
    greedy_held); prefix reuse; four requests under q8_0 and q4_0 KV;
    speculative decoding with a draft sharing the weights; the context
    shift; a q4_0 slot saved, erased and
    restored into another slot; the HTTP server over loopback; K4 at the
    tick's shape against its plain twin; two decode ticks profiled.  smi:
    the card's name and power limit, logged beside the numbers.  Returns
    the bf16 traffic's launch counts (zeroed before, read
    after)."""
    import shutil
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.runtime.engine import Engine
    from ggml_hexagon_tpu_torch.server.batch_engine import (BatchEngine,
                                                            DraftModel)
    from ggml_hexagon_tpu_torch.server.http_server import (InferenceServer,
                                                           make_handler)

    name = "Llama-3-8B Q4_K_M served (BatchEngine, 4 slots)"
    t_ph = phase(name, dev)
    t0 = time.perf_counter()
    be = BatchEngine.from_gguf(src, n_slots=SERVE_SLOTS, max_seq=SERVE_SEQ,
                               kv_dtype="bf16", device=dev)
    torch.cuda.synchronize()
    log(f"BatchEngine.from_gguf: {time.perf_counter() - t0:.2f} s, "
        f"{be.cfg.n_layer} layers, {be.n_slots} slots of {be.max_seq}; "
        f"card {smi}")
    cfg, weights, vocab = be.cfg, be.weights, be.vocab

    def fresh(kv="bf16", max_seq=SERVE_SEQ, **kw):
        return BatchEngine(cfg, weights, vocab, n_slots=SERVE_SLOTS,
                           max_seq=max_seq, kv_dtype=kv, device=dev, **kw)

    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 128000, n).tolist() for n in SERVE_PROMPTS]

    def submit_all(e, ps, n, recs):
        return [e.submit(p, n_predict=n, sampler=r, stop_ids=set())
                for p, r in zip(ps, recs)]

    def drain(q):
        out = []
        while True:
            tok, fin = q.get_nowait()
            if tok is None:
                return out, fin
            out.append(tok)

    # 1-2. the traffic, every tick held to its launches
    ticks = []
    held_ticks(be, "bf16", ticks)
    recs = [RecSampler() for _ in prompts]
    kernels.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    queues = submit_all(be, prompts, SERVE_GEN, recs)
    be.run_until_idle()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    outs = [drain(q) for q in queues]
    for (toks, fin), r in zip(outs, recs):
        if len(toks) != SERVE_GEN or fin != "length":
            raise AssertionError(f"request ended {fin} after {len(toks)}")
        if not all(np.isfinite(lg).all() for lg in r.logits):
            raise AssertionError("logits not finite")
    for k in ("qp8_gemv", "qp8_dual", "qp8_gemm", "decode_attn"):
        if counts[k] == 0:
            raise AssertionError(f"{k} never launched on the serving path")
    m = be.metrics
    n_pt = sum(1 for k, _, _ in ticks if k == "prompt")
    n_dt = sum(1 for k, _, _ in ticks if k == "decode")
    ttft = sorted(be.ttft_samples)
    p50 = ttft[len(ttft) // 2] * 1e3
    agg = m["n_tokens_generated"] / m["t_decode"]
    per_req = [(SERVE_GEN - 1) / (r.times[-1] - r.times[0]) for r in recs]
    pt_ms = np.median([dt for k, _, dt in ticks if k == "prompt"]) * 1e3
    dt_ms = np.median([dt for k, _, dt in ticks if k == "decode"]) * 1e3
    log(f"six requests on {SERVE_SLOTS} slots: {n_pt} prompt ticks (median "
        f"{pt_ms:.1f} ms), {n_dt} decode ticks (median {dt_ms:.2f} ms), every "
        f"tick's launches exact; wall {wall:.2f} s; TTFT p50 {p50:.1f} ms "
        f"(samples {[round(t * 1e3, 1) for t in be.ttft_samples]}); decode "
        f"{agg:.2f} tok/s aggregate (n_tokens_generated / t_decode); per "
        f"request {[round(x, 2) for x in per_req]} tok/s; card {smi}")
    log(f"  serving launches: { {k: v for k, v in counts.items() if v} }")
    SUMMARY.setdefault(name, {})["bf16 6 requests"] = (
        f"TTFT p50 {p50:.1f} ms, decode {agg:.2f} tok/s aggregate, prompt "
        f"tick {pt_ms:.1f} ms, decode tick {dt_ms:.2f} ms")

    # 3. each request alone on a fresh engine of the same shape (the same
    #    kernels at the same shapes: bit for bit), and against Engine alone
    for i, (p, (toks, _), r) in enumerate(zip(prompts, outs, recs)):
        solo, rs = fresh(), RecSampler()
        if (solo.complete(p, n_predict=SERVE_GEN, sampler=rs, stop_ids=set())
                != toks or not all(np.array_equal(a, b)
                                   for a, b in zip(rs.logits, r.logits))):
            raise AssertionError(f"request {i}: batched != alone")
        del solo
    log(f"  each request alone on a fresh {SERVE_SLOTS}-slot engine: the "
        f"same tokens and logits, bit for bit")
    eng = Engine(cfg, weights, vocab, max_seq=SERVE_SEQ, kv_dtype="bf16",
                 device=dev)
    for i, (p, (toks, _), r) in enumerate(zip(prompts, outs, recs)):
        want = engine_alone(eng, p, SERVE_GEN)
        e = nmse(torch.from_numpy(r.logits[0]), torch.from_numpy(want[1][0]))
        if e > NMSE_LOGITS:
            raise AssertionError(f"request {i}: prefill logits NMSE {e:.2e}")
        n, worst, tie = greedy_held(f"request {i} vs Engine",
                                    (toks, r.logits), want)
        log(f"  request {i} (prompt {len(p)}): prefill logits NMSE {e:.2e} "
            f"against Engine alone; greedy tokens equal over {n} steps, "
            f"logits NMSE <= {worst:.2e}" + (f" ({tie})" if tie else ""))
    del eng

    # 4. prefix reuse: a seventh request extends a served request's prompt
    #    and output (the first whose rows are still resident: the six
    #    requests took the slots in turn)
    idx = next(i for i, p in enumerate(prompts) if any(
        s.settled[:len(p)] == p and s.n_past >= len(p) for s in be.slots))
    p7 = prompts[idx] + outs[idx][0] + rng.integers(0, 128000, 5).tolist()
    cached0 = be.metrics["n_prompt_tokens_cached"]
    r7 = RecSampler()
    q7 = be.submit(p7, n_predict=16, sampler=r7, stop_ids=set())
    be.run_until_idle()
    t7, _ = drain(q7)
    reused = be.metrics["n_prompt_tokens_cached"] - cached0
    resident = len(prompts[idx]) + SERVE_GEN
    if reused != resident - 1:
        raise AssertionError(f"prefix reuse {reused} != {resident - 1}")
    cold = fresh()
    rc = RecSampler()
    tc = cold.complete(p7, n_predict=16, sampler=rc, stop_ids=set())
    n, worst, tie = greedy_held("prefix reuse vs cold", (t7, r7.logits),
                                (tc, rc.logits))
    log(f"  prefix reuse: a request extending request {idx}'s prompt and "
        f"output reused {reused} of {resident} resident tokens; its tokens "
        f"equal a cold run's over {n} steps, logits NMSE <= {worst:.2e}"
        + (f" ({tie})" if tie else ""))
    del cold

    # 5. q8_0 and q4_0 KV: four requests each, every tick held
    for kv in ("q8_0", "q4_0"):
        e = fresh(kv)
        tk = []
        held_ticks(e, kv, tk)
        rs = [RecSampler() for _ in range(4)]
        qs = submit_all(e, prompts[:4], 16, rs)
        e.run_until_idle()
        got = [drain(q) for q in qs]
        if any(len(t) != 16 for t, _ in got) or not all(
                np.isfinite(lg).all() for r in rs for lg in r.logits):
            raise AssertionError(f"{kv}: {[len(t) for t, _ in got]} tokens")
        log(f"  {kv} KV: four requests, {len(tk)} ticks with exact launches, "
            f"decode {e.metrics['n_tokens_generated'] / e.metrics['t_decode']:.2f}"
            f" tok/s aggregate")
        del e

    # 6. speculative decoding, the draft sharing the target's weights
    draft = DraftModel(cfg, weights, SERVE_SLOTS, SERVE_SEQ, device=dev)
    e = fresh(draft=draft, n_draft=4, draft_p_min=0.0)
    rs = [RecSampler() for _ in range(4)]
    qs = submit_all(e, prompts[:4], SERVE_GEN, rs)
    e.run_until_idle()
    for i, (q, r) in enumerate(zip(qs, rs)):
        toks, _ = drain(q)
        n, worst, tie = greedy_held(f"speculative request {i}",
                                    (toks, r.logits),
                                    (outs[i][0], recs[i].logits))
        log(f"  speculative request {i}: tokens equal the non-speculative "
            f"run's over {n} steps, logits NMSE <= {worst:.2e}"
            + (f" ({tie})" if tie else ""))
    sm = e.metrics
    rate = sm["n_draft_accepted"] / max(1, sm["n_draft_proposed"])
    log(f"  speculative: {sm['n_draft_proposed']} proposed, "
        f"{sm['n_draft_accepted']} accepted ({rate:.1%}), "
        f"{sm['n_draft_rounds_decoupled']} rounds decoupled, "
        f"{sm['n_tokens_generated'] / sm['t_decode']:.2f} tok/s aggregate")
    if not rate >= SPEC_ACCEPT_MIN:
        raise AssertionError(f"speculative acceptance {rate:.1%} < "
                             f"{SPEC_ACCEPT_MIN:.0%}")
    del e, draft

    # 7. the context shift
    e = fresh(max_seq=256, ctx_shift=True, n_keep=16)
    r = RecSampler()
    q = e.submit(prompts[4][:200], n_predict=100, sampler=r, stop_ids=set())
    e.run_until_idle()
    toks, fin = drain(q)
    if not (e.metrics["n_ctx_shifts"] >= 1 and fin == "length"
            and len(toks) == 100
            and all(np.isfinite(lg).all() for lg in r.logits)):
        raise AssertionError(f"context shift: {e.metrics['n_ctx_shifts']} "
                             f"shifts, {fin} after {len(toks)}")
    log(f"  context shift: a 200-token prompt and 100 tokens in a 256-slot "
        f"window, {e.metrics['n_ctx_shifts']} shifts, finish {fin}, every "
        f"logit finite")
    del e

    # 8. a q4_0 slot saved, erased and restored into another slot
    tmp = tempfile.mkdtemp(prefix="ght_slot_")
    try:
        e = fresh("q4_0")
        p = prompts[1]
        out1 = e.complete(p, n_predict=8, stop_ids=set())
        sid = next(s.id for s in e.slots if s.n_past > 0)
        path = os.path.join(tmp, "slot.npz")
        e.save_slot(sid, path)
        saved = {n: a[:, sid].clone() for n, a in e.kv.items()}
        p2 = p + out1 + [11, 12, 13]
        want = e.complete(p2, n_predict=8, stop_ids=set())
        e.erase_slot(sid)
        other = (sid + 2) % SERVE_SLOTS
        e.restore_slot(other, path)
        for n, a in saved.items():
            if not torch.equal(e.kv[n][:, other], a):
                raise AssertionError(f"restored plane {n} != saved")
        got = e.complete(p2, n_predict=8, stop_ids=set())
        if got != want or e.slots[other].n_past == 0:
            raise AssertionError(f"restored slot: {got} != {want}")
        log(f"  q4_0 slot {sid} saved ({os.path.getsize(path)} bytes), erased "
            f"and restored into slot {other}: every plane equal, the next "
            f"request continues as on the unsaved slot ({got})")
        del e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 9. the HTTP server over loopback
    e = fresh()
    srv = InferenceServer(e, model_path="llama-3-8b-q4_k_m-synthetic.gguf")
    srv.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [{"prompt": prompts[i][:64], "n_predict": 16, "temperature": 0,
               "cache_prompt": False, "stream": i == 0} for i in range(4)]
    results = {}

    def post(i, path, body):
        req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw = resp.read().decode()
        if body.get("stream"):
            ev = [ln[6:] for ln in raw.split("\n\n") if ln.startswith("data: ")]
            if ev[-1] != "[DONE]":
                raise AssertionError("SSE stream without [DONE]")
            results[i] = "".join(json.loads(x)["content"] for x in ev[:-1])
        else:
            results[i] = json.loads(raw)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, "/completion", b))
                   for i, b in enumerate(bodies)]
        threads.append(threading.Thread(target=post, args=(
            4, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "hello"}],
             "max_tokens": 8, "temperature": 0})))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        http_s = time.perf_counter() - t0
        gets = {pth: urllib.request.urlopen(url + pth, timeout=30).read().decode()
                for pth in ("/health", "/slots", "/metrics")}
    finally:
        httpd.shutdown()
        srv.stop()
    if len(results) != 5:
        raise AssertionError(f"HTTP: {len(results)} of 5 answers")
    tok = srv.tokenizer
    for i, b in enumerate(bodies):
        with e.lock:
            ids = e.complete(b["prompt"], n_predict=16, cache_prompt=False)
        want = "".join(tok.decode([t], skip_special=False) for t in ids)
        text = results[i] if b["stream"] else results[i]["content"]
        if text != want:
            raise AssertionError(f"HTTP request {i}: {text!r} != {want!r}")
    chat = results[4]
    if chat["object"] != "chat.completion":
        raise AssertionError(f"chat: {chat}")
    if (json.loads(gets["/health"]) != {"status": "ok"}
            or len(json.loads(gets["/slots"])) != SERVE_SLOTS
            or "ghtpu_ttft_p50_ms" not in gets["/metrics"]):
        raise AssertionError(f"GET endpoints: {gets}")
    log(f"  HTTP on {url}: four concurrent /completion (one SSE) and one "
        f"/v1/chat/completions in {http_s:.2f} s, texts equal "
        f"engine.complete; /health, /slots, /metrics answered "
        f"({gets['/metrics'].splitlines()[4]})")
    del e, srv

    # 10. K4 at the tick's shape, two decode ticks profiled
    k4_serving_rows(dev, cfg)
    for label, n_live in (("four live slots", 4), ("one live, three parked", 1)):
        e = fresh()
        for p in prompts[:n_live]:
            e.submit(p[:300], n_predict=8, stop_ids=set())
        while any(s.state.name != "GENERATING" for s in e.slots[:n_live]):
            e.step()
        e.step()  # warm
        host, dev_ms, idle = profile_tick(dev, e, label)
        SUMMARY[name][f"tick {label}"] = (
            f"host {host:.2f} ms, device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, "
            f"idle {idle}")
        e.run_until_idle()
        del e
    del be
    gc.collect()
    torch.cuda.empty_cache()
    phase_end(name, dev, t_ph)
    return counts


#: the CLI phase: perplexity chunks of CLI_CTX tokens, the CLI_CHUNKS of
#: them, and the tap route's names a layer (then the head's input)
CLI_CTX = 512
CLI_CHUNKS = 3
CLI_MODEL = "llama-3-8b-q4_k_m-synthetic.gguf"
TAP_NAMES = ("attn_q.weight", "attn_k.weight", "attn_v.weight",
             "attn_output.weight", "ffn_gate.weight", "ffn_up.weight",
             "ffn_down.weight", "l_out")
K3_HEAD = "ggml_hexagon_tpu/ops/qmm_qp8.py:529"


def cli_call(argv, want_rc=0):
    """cli.main(argv) in-process: (stdout, stderr, seconds); raises unless
    it returns want_rc."""
    import contextlib
    import io

    from ggml_hexagon_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    if rc != want_rc:
        raise AssertionError(f"cli {argv[:1]} returned {rc}: "
                             f"{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), dt


def launches_held(what, fn, want, shapes=None):
    """fn(), its kernel launches (the counters zeroed just before, read
    just after) held to want (name -> count, every other kernel 0) and,
    given shapes, K3's launches by weight (kernels.GEMM_SHAPES) to it."""
    from ggml_hexagon_tpu_torch import kernels

    kernels.reset_launches()
    sync(torch.device("cuda"))
    out = fn()
    sync(torch.device("cuda"))
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if got != want:
        raise AssertionError(f"{what} launches {got} != {want}")
    if shapes is not None and kernels.GEMM_SHAPES != shapes:
        raise AssertionError(f"{what}: K3 launches by weight "
                             f"{kernels.GEMM_SHAPES} != {shapes}")
    return out


def k3_shapes(weights, n):
    """K3's launches by weight ("NxK", kernels.GEMM_SHAPES) of n forwards
    above 8 rows with every row's logits: each layer's projections and the
    head, once a forward."""
    want = {}
    for qt in [lw[w] for lw in weights["layers"]
               for w in ("wqkv", "wqk", "wq", "wk", "wv", "wo",
                         "w_gateup_il", "ffn_down") if w in lw] + [
                   weights["output"]]:
        key = f"{qt.n}x{qt.k}"
        want[key] = want.get(key, 0) + n
    return want


def run_cli(dev, src, smi, words, tmp):
    """The command-line tools on the full-size 8B Q4_K_M of write_8b_gguf
    (its path, or its buffer: the model is loaded once and handed to the
    CLI with cli.preload either way, and every subcommand runs in-process
    through cli.main): perplexity over CLI_CHUNKS chunks of 512 tokens (K3
    on every projection and on the head, launches exact), one chunk held
    against the plain forward; imatrix on one chunk (the tap route, 225
    entries held against the plain tap route); generate greedy with a
    prompt cache written and reused, save-load-state, the draft model (the
    same file), lookup and lookahead held to the Engine's greedy tokens,
    q8_0 and q4_0 caches; embedding and POST /v1/embeddings against
    extract_embeddings; eval-callback on 7 tokens (the tap route at K1's
    shapes); bench -p 512 -n 128.  Returns (the K3-head report, the
    perplexity run's launches)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from ggml_hexagon_tpu_torch import cli, kernels
    from ggml_hexagon_tpu_torch.runtime import evaluate as PE
    from ggml_hexagon_tpu_torch.runtime.embedding import extract_embeddings
    from ggml_hexagon_tpu_torch.runtime.engine import Engine
    from ggml_hexagon_tpu_torch.runtime.lookahead import LookaheadDecoder
    from ggml_hexagon_tpu_torch.runtime.lookup import LookupDecoder
    from ggml_hexagon_tpu_torch.runtime.speculative import SpeculativeDecoder
    from ggml_hexagon_tpu_torch.server.batch_engine import (BatchEngine,
                                                            load_fused)
    from ggml_hexagon_tpu_torch.server.http_server import (InferenceServer,
                                                           make_handler)
    from ggml_hexagon_tpu_torch.tokenizer import build_tokenizer

    name = "Llama-3-8B Q4_K_M command-line tools"
    t_ph = phase(name, dev)
    t0 = time.perf_counter()
    cfg, weights, vocab, md = load_fused(src, dev)
    sync(dev)
    cli.preload(CLI_MODEL, cfg, weights, vocab, md)
    log(f"loaded once ({time.perf_counter() - t0:.2f} s) from "
        f"{'a file' if isinstance(src, str) else 'a bytearray'} and handed "
        f"to the CLI as -m {CLI_MODEL} (cli.preload); card {smi}")
    tok = build_tokenizer(vocab)
    m = ["-m", CLI_MODEL, "--device", dev.type]
    rng = np.random.default_rng(23)

    def text(n):
        return " ".join(words[i] for i in rng.integers(0, len(words), n))

    def path(name_):
        return os.path.join(tmp, name_)

    # 1. perplexity: CLI_CHUNKS chunks, each held to 145 K3 launches
    corpus = text(CLI_CHUNKS * CLI_CTX)
    with open(path("corpus.txt"), "w") as fh:
        fh.write(corpus)
    ids = tok.encode(corpus, add_bos=False)
    if len(ids) != CLI_CHUNKS * CLI_CTX:
        raise AssertionError(f"corpus: {len(ids)} tokens")
    ppl_launches = {"qp8_gemm": 145 * CLI_CHUNKS}
    ppl_shapes = k3_shapes(weights, CLI_CHUNKS)
    head = f"{cfg.n_vocab}x{cfg.n_embd}"
    out, err, dt = launches_held("perplexity", lambda: cli_call(
        ["perplexity", *m, "-f", path("corpus.txt"), "-c", str(CLI_CTX)]),
        ppl_launches, ppl_shapes)
    head_launches = kernels.GEMM_SHAPES[head]
    res = json.loads(out)
    if not (np.isfinite(res["ppl"]) and res["tokens"]
            == CLI_CHUNKS * (CLI_CTX - 1 - CLI_CTX // 2)):
        raise AssertionError(f"perplexity: {res}")
    log(f"  perplexity, {CLI_CHUNKS} chunks of {CLI_CTX}: {res} in "
        f"{dt:.2f} s; launches exact ({ppl_launches}: 145 K3 a chunk, no "
        f"K1), by weight {kernels.GEMM_SHAPES} ({head_launches} on the head "
        f"{head} at M = {CLI_CTX}); card {smi}")
    stream = [vocab.bos_id] + ids
    chunk = [vocab.bos_id] + stream[1:CLI_CTX]
    lk = PE.chunk_logits(cfg, weights, chunk, device=dev)
    lp_ = PE.chunk_logits(cfg, weights, chunk, device=dev, plain=True)
    e2 = nmse(lk, lp_)
    nxt = torch.tensor(chunk[1:], device=dev)

    def ln_ppl(lg):
        lsm = torch.log_softmax(lg, dim=-1)[:-1].gather(1, nxt[:, None])[:, 0]
        return float(-lsm[CLI_CTX // 2:].double().mean())

    d_ln = abs(ln_ppl(lk) - ln_ppl(lp_))
    if not (e2 <= NMSE_LOGITS and d_ln <= 1e-2
            and torch.isfinite(lk).all()):
        raise AssertionError(f"perplexity chunk vs plain: logits NMSE {e2}, "
                             f"|d ln PPL| {d_ln}")
    del lp_
    from torch.profiler import ProfilerActivity, profile

    PE.chunk_logits(cfg, weights, chunk, device=dev)  # warm
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PE.chunk_logits(cfg, weights, chunk, device=dev)
        sync(dev)
        host = (time.perf_counter() - t0) * 1e3
    dev_ms, top = _device_ms(prof.key_averages(), 1)
    dtxt = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
    idle = "not measured" if dev_ms is None else f"{1 - dev_ms / host:.1%}"
    # the same forward unprofiled (the profiler's tracing costs host time):
    # wall on the host and the span of CUDA events around it, median of 3
    walls, spans = [], []
    for _ in range(3):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync(dev)
        t0 = time.perf_counter()
        ev0.record()
        PE.chunk_logits(cfg, weights, chunk, device=dev)
        ev1.record()
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(ev0.elapsed_time(ev1))
    wall, span = float(np.median(walls)), float(np.median(spans))
    # bench pp512's call on the same tokens: Engine.prefill (every row's
    # logits too) into a cache of 512 + 128 + 8 slots, which takes the
    # dense attention where the chunk's 512 slots take the flash-chunked one
    pe = Engine(cfg, weights, vocab, max_seq=CLI_CTX + 136, device=dev)
    pwalls = []
    for _ in range(4):
        pe.reset()
        sync(dev)
        t0 = time.perf_counter()
        pe.prefill(np.asarray(chunk, np.int64)[None])
        sync(dev)
        pwalls.append((time.perf_counter() - t0) * 1e3)
    pwall = float(np.median(pwalls[1:]))
    del pe
    log(f"  one chunk against the plain forward: logits NMSE {e2:.2e} (<= "
        f"{NMSE_LOGITS}), |d ln PPL| {d_ln:.2e} (<= 1e-2); the chunk's "
        f"forward under the profiler: host {host:.2f} ms, device busy "
        f"{dtxt}, idle share {idle}; unprofiled: wall {wall:.2f} ms, event "
        f"span {span:.2f} ms (median of 3); bench's Engine.prefill on the "
        f"same {CLI_CTX} tokens {pwall:.2f} ms (median of 3 after a warm-up); "
        f"card {smi}")
    for ms, cnt, key in top[:4]:
        log(f"      {ms:8.4f} ms  x{cnt:<4d} {key[:90]}")
    SUMMARY.setdefault(name, {})["perplexity chunk (512 tokens)"] = (
        f"profiled: host {host:.2f} ms, device busy {dtxt}, idle {idle}; "
        f"unprofiled: wall {wall:.2f} ms, event span {span:.2f} ms, "
        f"Engine.prefill {pwall:.2f} ms; "
        f"{CLI_CHUNKS} chunks through the CLI {dt:.2f} s")
    rep = KernelReport("qp8_gemm_head", "cuda", SRC_GEMM, K3_HEAD,
                       f"the head (Q6_K 128256 x 4096) of one {CLI_CTX}-token "
                       "perplexity chunk under logits_all: 1 launch")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    log(f"K3 on the head at M = {CLI_CTX} (NMSE <= {NMSE_KERNEL})")
    k3_row(dev, gen, rep, "head", weights["output"], 1, M=CLI_CTX)
    rep.launches = head_launches

    mem_mark(dev, "perplexity")

    # 2. imatrix on one chunk: 225 entries against the plain tap route
    with open(path("chunk.txt"), "w") as fh:
        fh.write(" ".join(corpus.split(" ")[:CLI_CTX]))
    out, err, dt = launches_held("imatrix", lambda: cli_call(
        ["imatrix", *m, "-f", path("chunk.txt"), "-o", path("imatrix.npz"),
         "-c", str(CLI_CTX)]), {"qp8_gemm": 145}, k3_shapes(weights, 1))
    z = np.load(path("imatrix.npz"))
    col = PE.IMatrixCollector(cfg, weights, device=dev, plain=True)
    col.process_chunk(ids[:CLI_CTX])
    plain = col.result()
    worst = 0.0
    for k, v in plain.items():
        e = nmse(torch.from_numpy(z[k]), torch.from_numpy(v))
        worst = max(worst, e)
        if not (e <= NMSE_LOGITS and int(z[f"__count__{k}"]) == CLI_CTX):
            raise AssertionError(f"imatrix {k}: NMSE {e}")
    if sorted(plain) != sorted(n for n in z.files
                               if not n.startswith("__count__")) \
            or len(plain) != 7 * cfg.n_layer + 1:
        raise AssertionError(f"imatrix: {len(plain)} entries")
    log(f"  imatrix, one chunk (the tap route: 145 K3, by weight as in "
        f"perplexity): {len(plain)} entries "
        f"in {dt:.2f} s, each within NMSE {worst:.2e} of the plain tap route "
        f"(<= {NMSE_LOGITS}), counts exact")

    mem_mark(dev, "imatrix")

    # 3. generate
    prompt = text(23)
    pids = tok.encode(prompt)
    n_gen = 24
    g = ["generate", *m, "-p", prompt, "-n", str(n_gen), "--temp", "0",
         "-c", "1024"]
    def eng(**kw):
        return Engine(cfg, weights, vocab, max_seq=1024, device=dev, **kw)

    first, err1, dt1 = cli_call(g + ["--prompt-cache", path("session.bin")])
    e = eng()
    e.load_state(path("session.bin"))
    n_cached = e.n_past
    # the reused run prefills the last prompt token alone (K1) where the
    # first prefilled the prompt (K3): its tokens are the library's
    # reuse_cache run's, not the first run's
    want_txt = tok.decode(list(e.generate(pids, n_gen,
                                          reuse_cache=True))) + "\n"
    again, err2, dt2 = cli_call(g + ["--prompt-cache", path("session.bin")])
    if (again != want_txt or f"restored prompt cache ({n_cached} tokens)"
            not in err2 or "prefill 1 tok" not in err2):
        raise AssertionError(f"prompt cache: {again!r} vs {want_txt!r}")
    log(f"  generate greedy, {len(pids)}-token prompt, {n_gen} tokens: "
        f"{dt1:.2f} s; with the prompt cache reused {dt2:.2f} s "
        f"({err2.splitlines()[1]}; {err2.splitlines()[-1]}), the text of "
        f"Engine.load_state + generate(reuse_cache=True)")
    out, _, dt = cli_call(["save-load-state", *m, "-p", prompt, "-n", "16",
                           "-c", "1024", "-o", path("state.bin")])
    if not out.endswith("state round-trip OK\n"):
        raise AssertionError(f"save-load-state: {out}")
    log(f"  save-load-state: 16 greedy tokens after a reload, bit-equal "
        f"({dt:.2f} s, {os.path.getsize(path('state.bin'))} bytes)")

    base = eng()
    rec = RecSampler()
    btoks = list(base.generate(pids, n_gen, sampler=rec))
    want_run = (btoks, rec.logits)
    for flag, mk in (
            ("-md", lambda: SpeculativeDecoder(eng(), eng())),
            ("--lookup", lambda: LookupDecoder(eng())),
            ("--lookahead", lambda: LookaheadDecoder(eng()))):
        argv = g + ([flag, CLI_MODEL] if flag == "-md" else [flag])
        out, err, dt = cli_call(argv)
        dec = mk()
        rec = RecSampler()
        toks = dec.generate(pids, n_gen, sampler=rec)
        if out != tok.decode(toks) + "\n":
            raise AssertionError(f"generate {flag}: the CLI printed another "
                                 "text than the decoder's")
        steps, worst, why = greedy_held(f"generate {flag}",
                                        (toks, rec.logits[:len(toks)]),
                                        want_run)
        n_f, w_f, ties = forced_held(f"generate {flag}", cfg, weights, dev,
                                     pids, (toks, rec.logits))
        log(f"  generate {flag}: {err.splitlines()[1]}; {dt:.2f} s; the "
            f"Engine's greedy tokens held for {steps} steps (logits NMSE <= "
            f"{worst:.2e}){'; ' + why if why else ''}; teacher-forced: all "
            f"{n_f} tokens held (logits NMSE <= {w_f:.2e}, near-ties at "
            f"steps {ties})")
    spec = SpeculativeDecoder(eng(), eng(), n_draft=4, p_min=0.0)
    rec = RecSampler()
    toks = spec.generate(pids, n_gen, sampler=rec)
    steps, worst, why = greedy_held("speculative (n_draft 4, p_min 0)",
                                    (toks, rec.logits[:len(toks)]), want_run)
    n_f, w_f, ties = forced_held("speculative (n_draft 4, p_min 0)", cfg,
                                 weights, dev, pids, (toks, rec.logits))
    rate = spec.stats.accept_rate
    if rate < SPEC_ACCEPT_MIN:
        raise AssertionError(f"speculative acceptance {rate:.1%}")
    log(f"  speculative, the same model as draft (n_draft 4, p_min 0): "
        f"{spec.stats.n_accepted}/{spec.stats.n_drafted} accepted "
        f"({rate:.1%}, >= {SPEC_ACCEPT_MIN:.0%}) in {spec.stats.n_rounds} "
        f"verify rounds; held for {steps} steps (NMSE <= {worst:.2e})"
        f"{'; ' + why if why else ''}; teacher-forced: all {n_f} tokens "
        f"held (logits NMSE <= {w_f:.2e}, near-ties at steps {ties})")
    for kv in ("q8_0", "q4_0"):
        out, _, dt = cli_call(g + ["--cache-type", kv])
        e = eng(kv_dtype=kv)
        want_txt = tok.decode(list(e.generate(pids, n_gen))) + "\n"
        if out != want_txt:
            raise AssertionError(f"generate --cache-type {kv}")
        log(f"  generate --cache-type {kv}: {dt:.2f} s, the Engine's text")
    del base, e

    mem_mark(dev, "generate")

    # 4. embedding: the CLI and POST /v1/embeddings against the function
    texts = [text(n) for n in (9, 30, 100)]
    out, _, dt = cli_call(["embedding", *m, *sum((["-p", t] for t in texts),
                                                 []), "--n-print", "8"])
    emb = extract_embeddings(cfg, weights, [tok.encode(t) for t in texts],
                             device=dev)
    if out != "".join(" ".join(f"{v:.6f}" for v in row[:8]) + " ...\n"
                      for row in emb):
        raise AssertionError("embedding: the CLI printed other rows")
    be = BatchEngine(cfg, weights, vocab, n_slots=1, max_seq=256, device=dev)
    be.metadata = md
    srv = InferenceServer(be, model_path=CLI_MODEL)
    srv.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(
            url + "/v1/embeddings", json.dumps({"input": texts}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = json.loads(resp.read())
    finally:
        httpd.shutdown()
        srv.stop()
    rows = np.asarray([d["embedding"] for d in body["data"]], np.float32)
    want_rows = extract_embeddings(
        cfg, weights, [srv.tokenizer.encode(t, parse_special=True)
                       for t in texts], device=dev)
    if not np.array_equal(rows, want_rows):
        raise AssertionError("POST /v1/embeddings != extract_embeddings")
    log(f"  embedding of three prompts ({[len(tok.encode(t)) for t in texts]} "
        f"tokens): the CLI's rows ({dt:.2f} s) and POST /v1/embeddings over "
        f"{url} equal extract_embeddings")
    del be, srv

    mem_mark(dev, "embedding")

    # 5. eval-callback on 7 tokens: the tap route at K1's shapes
    p7 = text(6)
    if len(tok.encode(p7)) != 7:
        raise AssertionError("eval-callback prompt")
    out, _, dt = launches_held("eval-callback", lambda: cli_call(
        ["eval-callback", *m, "-p", p7]), {"qp8_gemv": 145})
    names = [ln.split()[0] for ln in out.splitlines()[:-1]]
    want_names = [f"blk.{il}.{n}" for il in range(cfg.n_layer)
                  for n in TAP_NAMES] + ["output.weight"]
    if names != want_names:
        raise AssertionError(f"eval-callback: {len(names)} names")
    log(f"  eval-callback, 7 tokens: {len(names)} tensors in the JAX "
        f"forward's tap order ({dt:.2f} s); launches exact (145 K1: every "
        "projection raw, no K2, no K4)")

    mem_mark(dev, "eval-callback")

    # 6. bench
    out, _, dt = cli_call(["bench", *m, "-p", "512", "-n", "128"])
    rows = [[c.strip() for c in r.strip("|").split("|")]
            for r in out.splitlines() if r.startswith(f"| {CLI_MODEL} |")]
    if [r[1] for r in rows] != ["pp512", "tg128"]:
        raise AssertionError(f"bench: {out}")
    for _, test, rate in rows:
        log(f"  bench {test}: {rate} t/s ({dt:.1f} s for the sweep); card "
            f"{smi}")
    SUMMARY[name]["bench"] = ", ".join(f"{t} {r} t/s" for _, t, r in rows)
    mem_mark(dev, "bench")
    del weights
    cli._MODELS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    phase_end(name, dev, t_ph)
    return [rep], ppl_launches


#: the quantize phase (run_quantize): the 8B's first QUANT_DEPTH layers at
#: full width as an f16 file, quantized to QUANT_FTYPE through the CLI
QUANT_DEPTH = 2
QUANT_FTYPE = "Q4_0"
QUANT_SAMPLE_ROWS = 8   # rows of each tensor held to the numpy encoder
QUANT_REQUESTS = [("bf16", 512, 16), ("bf16", 128, 16), ("bf16", 7, 8)]
#: the 70B phase (run_70b_iq3xxs): the first layers of the 80-layer file
LLAMA70_DEPTH = 8
LLAMA70_REQUESTS = [("bf16", 512, 16), ("bf16", 7, 8)]
SRC_NATIVE = "ggml_hexagon_tpu_torch/native/quantize.cpp"


def encoder_quality(what, x, got, want, qtype):
    """The native encoder's blocks against numpy's on the same f32 values,
    held to tests/test_native.py's bound: the two round trips' RMSE within
    0.5% of each other, their cross difference under 5% of the values'
    spread (tie-breaks of the scale searches only).  -> (RMSE native,
    RMSE numpy, cross)."""
    from ggml_hexagon_tpu_torch.quant import ref_numpy as R

    x = x.reshape(-1)
    da = R.dequantize(got.reshape(-1), qtype, x.size)
    db = R.dequantize(want.reshape(-1), qtype, x.size)
    ea = float(np.sqrt(np.mean((da - x) ** 2, dtype=np.float64)))
    eb = float(np.sqrt(np.mean((db - x) ** 2, dtype=np.float64)))
    cross = float(np.sqrt(np.mean((da - db) ** 2, dtype=np.float64))
                  / np.std(x, dtype=np.float64))
    if not (abs(ea - eb) / eb < 0.005 and cross < 0.05):
        raise AssertionError(f"{what} {qtype.name}: native RMSE {ea}, numpy "
                             f"{eb}, cross {cross}")
    return ea, eb, cross


def numpy_encode(x, qtype, threads=None):
    """The numpy encoder (quant.ref_numpy) on the rows of x [N, K], split
    over the host's cores by rows (whole blocks: the bytes of the whole)."""
    from concurrent.futures import ThreadPoolExecutor

    from ggml_hexagon_tpu_torch.quant import ref_numpy as R

    parts = np.array_split(x, threads or os.cpu_count() or 4)
    with ThreadPoolExecutor(len(parts)) as ex:
        return np.concatenate(list(ex.map(
            lambda c: R.quantize(np.ascontiguousarray(c).reshape(-1), qtype),
            parts)))


def held_quantized_rows(src, out):
    """Every tensor of the quantized file against the port's numpy encoder
    on the f16 file's values: QUANT_SAMPLE_ROWS rows of each matrix (the
    first, the last and random ones), byte-equal; a K-quant row that
    differs (a tie-break of the native scale search) must meet
    encoder_quality.  The norms' F32 bytes equal the source's."""
    from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
    from ggml_hexagon_tpu_torch.quant import ref_numpy as R
    from ggml_hexagon_tpu_torch.quant.formats import GGMLType, row_size

    rng = np.random.default_rng(5)
    seen, ties = {}, 0
    with GGUFReader.open(src) as fr, GGUFReader.open(out) as qr:
        for name, t in qr.tensors.items():
            f = fr.tensors[name]
            if len(t.shape) == 1:
                if not (t.ggml_type == f.ggml_type == GGMLType.F32 and
                        np.array_equal(qr.tensor_bytes(name), fr.tensor_bytes(name))):
                    raise AssertionError(f"{name}: {t.ggml_type.name} != source")
                seen["F32"] = seen.get("F32", 0) + 1
                continue
            N, K = t.shape
            rows = np.unique(np.r_[0, N - 1, rng.integers(0, N, QUANT_SAMPLE_ROWS - 2)])
            x = fr.tensor_bytes(name).view(np.float16).reshape(N, K)[rows].astype(np.float32)
            got = qr.tensor_bytes(name).reshape(N, row_size(t.ggml_type, K))[rows]
            want = R.quantize(x.reshape(-1), t.ggml_type).reshape(len(rows), -1)
            diff = (got != want).any(axis=1)
            if diff.any():
                if t.ggml_type not in (GGMLType.Q4_K, GGMLType.Q6_K):
                    raise AssertionError(f"{name} {t.ggml_type.name}: rows "
                                         f"{rows[diff]} differ from numpy")
                encoder_quality(name, x[diff], got[diff], want[diff], t.ggml_type)
                ties += int(diff.sum())
            seen[t.ggml_type.name] = seen.get(t.ggml_type.name, 0) + 1
    log(f"the quantized file against the numpy encoder, {QUANT_SAMPLE_ROWS} "
        f"rows a matrix: byte-equal for every tensor ({seen}); K-quant rows "
        f"apart at a tie-break (held to the quality bound): {ties}")


def held_native_kquants(src):
    """The native Q4_0, Q4_K and Q6_K encoders on one full-width tensor of
    the f16 file (blk.0.ffn_down, 4096 x 14336) against the numpy
    encoder: Q4_0 byte-equal, the K-quants within encoder_quality; both
    rates logged (numpy over the host's cores)."""
    from ggml_hexagon_tpu_torch import native
    from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
    from ggml_hexagon_tpu_torch.quant.formats import GGMLType

    with GGUFReader.open(src) as r:
        x = r.tensor_f32("blk.0.ffn_down.weight")
    for qtype in (GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q6_K):
        t0 = time.perf_counter()
        got = native.quantize_native(x.reshape(-1), int(qtype))
        tn = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = numpy_encode(x, qtype)
        tp = time.perf_counter() - t0
        if qtype == GGMLType.Q4_0:
            if not np.array_equal(got, want):
                raise AssertionError("native Q4_0 != numpy on blk.0.ffn_down")
            q = "byte-equal"
        else:
            ea, eb, cross = encoder_quality("blk.0.ffn_down", x, got, want, qtype)
            q = (f"RMSE native {ea:.4e} numpy {eb:.4e}, cross {cross:.2e}, "
                 f"{int((got != want).sum())} bytes apart")
        log(f"  {qtype.name} on {x.shape[0]}x{x.shape[1]}: native "
            f"{x.size / tn / 1e6:.1f} M weights/s, numpy "
            f"{x.size / tp / 1e6:.2f} M weights/s ({os.cpu_count()} cores); {q}")


def check_kernels_q4_0(dev, weights, cfg):
    """K1 and K3 on the Q4_0 t-planes of the quantized 8B (the first
    configuration that serves Q4_0 planes) and on its Q6_K head, against
    their plain versions at the main path's shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4040)
    layers = weights["layers"]
    lw, n_l, head = layers[0], len(layers), weights["output"]
    K1 = KernelReport("qp8_gemv_q4_0", "cuda", SRC_GEMV,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
                      f"one decode step of the quantized 8B Q4_0 file (B=1, "
                      f"{n_l} layers): {4 * n_l} Q4_0 launches + the Q6_K head")
    K3 = KernelReport("qp8_gemm_q4_0", "cuda", SRC_GEMM,
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:529",
                      f"one 512-token chunk of the quantized 8B Q4_0 file: "
                      f"{4 * n_l} Q4_0 launches + the Q6_K head")
    log(f"K1 / K3 on the quantized file's Q4_0 t-planes (NMSE <= {NMSE_KERNEL})")
    for B in (1, 8):
        for name, qt, mode, count in (
                ("wqkv", lw["wqkv"], "normed", n_l), ("wo", lw["wo"], "res", n_l),
                ("gate_up", lw["w_gateup_il"], "normed", n_l),
                ("down", lw["ffn_down"], "act", n_l), ("head_q6k", head, "raw", 1)):
            k1_row(dev, gen, cfg, K1 if B == 1 else None, name, qt, mode, B, count)
    for name, qt, count in (("wqkv", lw["wqkv"], n_l), ("wo", lw["wo"], n_l),
                            ("gate_up", lw["w_gateup_il"], n_l),
                            ("down", lw["ffn_down"], n_l), ("head_q6k", head, 1)):
        k3_row(dev, gen, K3, name, qt, count)
    return {"qp8_gemv": K1, "qp8_gemm": K3}


def layout_log(name, cfg, weights):
    """The per-tensor types and layouts of a built or loaded model."""
    types = {}
    for lw in weights["layers"]:
        for key, v in lw.items():
            if hasattr(v, "fq"):
                types.setdefault(key, set()).add(f"{v.cfg.qtype.name}/{v.fl}")
    log(f"{name}: {cfg.n_layer} layers, {cfg.n_head} / {cfg.n_head_kv} heads "
        f"of {cfg.hd}"
        + (f", {cfg.n_expert} experts, top-{cfg.n_expert_used}"
           if cfg.n_expert else "")
        + f"; matmul planes {plane_gb(weights):.3f} GB; per-tensor "
        f"types { {k: sorted(v) for k, v in types.items()} }, head "
        f"{weights['output'].cfg.qtype.name}/{weights['output'].fl}, "
        f"embedding {weights['tok_embd'].cfg.qtype.name} (wire)")


def run_quantize(dev):
    """The quantizer's path at the 8B's full width: write_gguf writes the
    first QUANT_DEPTH layers as an f16 file (random weights of RMS
    1/sqrt(k)), `cli.main(["quantize", f16, out, "Q4_0"])` quantizes it
    through the port's own native library (Q4_0 everywhere, a Q6_K head),
    every tensor is held to the numpy encoder on sampled rows and the
    native K-quant encoders on one full-width tensor; the file loads with
    Engine.from_gguf(fuse=True) (pack_tensor on the card byte-equal to the
    CPU), K1 and K3 on its Q4_0 planes are held against their plain
    versions, greedy requests run with the launch table exact, and the
    kernels against the plain forward (compare_plain: each plain layer fed
    the kernel run's input, the layers' outputs and the logits).  Returns
    (kernel reports, the requests' launch counts)."""
    from ggml_hexagon_tpu_torch import cli, native
    from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
    from ggml_hexagon_tpu_torch.models.launches import launch_table
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig
    from ggml_hexagon_tpu_torch.models.synth import LLAMA3_8B, llama_bpe_vocab
    from ggml_hexagon_tpu_torch.runtime.engine import Engine

    name = f"Llama-3-8B {QUANT_FTYPE} quantized by the port"
    t_ph = phase(name, dev)
    fields, _ = llama_bpe_vocab()
    src, tmp = write_synth_gguf(dev, LlamaConfig(**LLAMA3_8B), "F16",
                                "llama-3-8b-f16-synthetic.gguf", fields,
                                depth=QUANT_DEPTH, need_path=True)
    try:
        out = os.path.join(tmp, f"llama-3-8b-{QUANT_FTYPE.lower()}.gguf")
        t0 = time.perf_counter()
        native.load()
        log(f"native encoder library {native.lib_path().name} (g++ -O3): "
            f"built and loaded in {time.perf_counter() - t0:.1f} s")
        with GGUFReader.open(src) as r:
            n_w = sum(t.n_elements for t in r.tensors.values())
        t0 = time.perf_counter()
        rc = cli.main(["quantize", src, out, QUANT_FTYPE])
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli quantize exited {rc}")
        log(f"cli quantize {QUANT_FTYPE}: {n_w} weights in {dt:.1f} s, "
            f"{n_w / dt / 1e6:.1f} M weights/s on {os.cpu_count()} host cores "
            f"(the file's read and write included); {os.path.getsize(out)} "
            f"bytes")
        held_quantized_rows(src, out)
        held_native_kquants(src)
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        eng = Engine.from_gguf(out, fuse=True, max_seq=1024, device=dev)
        log(f"Engine.from_gguf(fuse=True): t_load {eng.perf.t_load:.2f} s, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        with GGUFReader.open(out) as r:
            packed = [held_pack(dev, r, n) for n in
                      ("blk.0.attn_q.weight", "blk.1.ffn_down.weight")]
        log(f"pack_tensor on the card byte-equal to the CPU on {packed}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg, weights = eng.cfg, eng.weights
    del eng
    layout_log(name, cfg, weights)
    log(f"launch table: {launch_table(cfg, weights)}")
    reps = check_kernels_q4_0(dev, weights, cfg)
    log("serving (launch counters zeroed before, read after)")
    counts = serve(dev, cfg, weights, name, QUANT_REQUESTS)
    log(f"main-path launches ({name}): {counts}")
    for key, rep in reps.items():
        rep.launches = counts[key]
    log(f"kernel vs plain versions, end to end (each plain layer fed the "
        f"kernel run's input; the layers' outputs and the logits NMSE <= "
        f"{NMSE_LOGITS})")
    compare_plain(dev, cfg, weights)
    phase_end(name, dev, t_ph)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return list(reps.values()), counts


def held_expansion(dev, reader, weights):
    """The card's i-quant expansion (quant.pack.expand_wire) byte-equal to
    the numpy copy (quant.iquants.expand_to_planes) on the file's bytes:
    blk.0's IQ2_S attn_q and IQ3_S attn_output whole, the first 2048 rows
    of its IQ3_XXS ffn_down; and the loaded IQ3_S token embedding's first
    4096 rows (its wire planes as the loader expanded them)."""
    from ggml_hexagon_tpu_torch.quant import iquants
    from ggml_hexagon_tpu_torch.quant.formats import row_size
    from ggml_hexagon_tpu_torch.quant.pack import expand_wire

    te = weights["tok_embd"]
    for tname, rows in (("blk.0.attn_q.weight", None),
                        ("blk.0.attn_output.weight", None),
                        ("blk.0.ffn_down.weight", 2048),
                        ("token_embd.weight", 4096)):
        t = reader.tensors[tname]
        N, K = t.shape
        rows = min(rows or N, N)
        raw = reader.tensor_bytes(tname)[:rows * row_size(t.ggml_type, K)].copy()
        t0 = time.perf_counter()
        wq, wd = iquants.expand_to_planes(raw, t.ggml_type, rows, K)
        tn = time.perf_counter() - t0
        if tname == "token_embd.weight":
            gq, gd, tc = te.q[:rows], te.d[:rows], float("nan")
        else:
            wire = torch.from_numpy(raw).to(dev)
            sync(dev)
            t0 = time.perf_counter()
            gq, gd = expand_wire(wire, t.ggml_type, rows, K)
            sync(dev)
            tc = time.perf_counter() - t0
        if not (gq.dtype == torch.int8 and gd.dtype == torch.float32
                and np.array_equal(gq.cpu().numpy(), wq)
                and gd.cpu().numpy().tobytes() == wd.tobytes()):
            raise AssertionError(f"{tname}: the card's expansion != numpy's")
        log(f"  {tname} {t.ggml_type.name} {rows}x{K}: q, d byte-equal to "
            f"numpy expand_to_planes ({tn:.2f} s on the host; on the card "
            + ("at load" if tc != tc else f"{tc * 1e3:.1f} ms") + ")")


def check_kernels_70b(dev, weights, cfg):
    """The 70B's kernels against their plain versions at its widths: K2 on
    the coded IQ2_S wqk (9216 x 8192) + Q4_K wv (1024 x 8192), K1 coded
    (the IQ3_S wo res, the IQ3_XXS gate_up normed at K = 8192, the IQ3_XXS
    down act at K = 28672), K1 on the Q5_K head (128256 x 8192), K3 at M =
    512 on every tensor, K4 with 64 query heads over 8 KV heads."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7070)
    layers = weights["layers"]
    lw, n_l, head = layers[0], len(layers), weights["output"]
    unit = f"one Llama-3-70B IQ3_XXS decode step (B=1, {n_l} layers)"
    chunk = f"one Llama-3-70B IQ3_XXS 512-token chunk ({n_l} layers)"
    reps = {
        "qp8_gemv_coded": KernelReport(
            "qp8_gemv_coded_70b", "cuda", SRC_GEMV,
            "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
            f"{unit}: {3 * n_l} launches (res, normed, act)"),
        "qp8_gemv": KernelReport(
            "qp8_gemv_70b_head", "cuda", SRC_GEMV,
            "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
            f"{unit}: the Q5_K head, 1 launch"),
        "qp8_dual_coded": KernelReport(
            "qp8_dual_coded_70b", "cuda", SRC_GEMV,
            "ggml_hexagon_tpu/ops/qmm_qp8.py:475",
            f"{unit}: {n_l} launches (IQ2_S wqk + Q4_K wv)"),
        "qp8_gemm_coded": KernelReport(
            "qp8_gemm_coded_70b", "cuda", SRC_GEMM,
            "ggml_hexagon_tpu/ops/qmm_qp8.py:529", f"{chunk}: {4 * n_l} launches"),
        "qp8_gemm": KernelReport(
            "qp8_gemm_70b", "cuda", SRC_GEMM, "ggml_hexagon_tpu/ops/qmm_qp8.py:529",
            f"{chunk}: {n_l + 1} launches (Q4_K wv, the Q5_K head)"),
        "decode_attn": KernelReport(
            "decode_attn_g8", "cuda", SRC_K4, "ggml_hexagon_tpu/ops/decode_attn.py:177",
            f"{unit} at pos 700 of 1024, bf16 KV, 64 query heads over 8 KV "
            f"heads: {n_l} launches")}
    log(f"K2 / K1 / K3 / K4 at the 70B's widths (NMSE <= {NMSE_KERNEL})")
    for B in (1, 4):
        dual_row(dev, gen, cfg, reps["qp8_dual_coded"] if B == 1 else None,
                 lw["wqk"], lw["wv"], B, n_l)
    for B in (1, 8):
        for name, qt, mode in (("wo", lw["wo"], "res"),
                               ("gate_up", lw["w_gateup_il"], "normed"),
                               ("down", lw["ffn_down"], "act")):
            k1_row(dev, gen, cfg, reps["qp8_gemv_coded"] if B == 1 else None,
                   name, qt, mode, B, n_l)
        k1_row(dev, gen, cfg, reps["qp8_gemv"] if B == 1 else None, "head_q5k",
               head, "raw", B, 1)
    for name in ("wqk", "wo", "w_gateup_il", "ffn_down"):
        k3_row(dev, gen, reps["qp8_gemm_coded"], name, lw[name], n_l)
    k3_row(dev, gen, reps["qp8_gemm"], "wv", lw["wv"], n_l)
    k3_row(dev, gen, reps["qp8_gemm"], "head_q5k", head, 1)
    log(f"K4 decode_attn, G = {cfg.n_head // cfg.n_head_kv} (max|d| <= {ATTN_MAX_ABS})")
    k4_rows(dev, cfg, reps["decode_attn"])
    return reps


def run_70b_iq3xxs(dev):
    """Llama-3-70B IQ3_XXS (made with an imatrix) from a GGUF file at full
    width: write_gguf writes the first LLAMA70_DEPTH layers of the
    80-layer file (the full-depth policy's types: IQ2_S attn_q/attn_k, Q4_K
    attn_v, IQ3_S attn_output and token_embd, IQ3_XXS FFN, a Q5_K head;
    random wire bytes with finite centred scales, the Q4_K and Q5_K ones
    drawn as planes), Engine.from_gguf(fuse=True) loads it with the
    i-quants expanded on the card (held byte-equal to the numpy copy on
    four tensors), the kernels at the 70B's widths are held against their
    plain versions, a 512-token prompt and decode steps run with the
    launch table exact, one decode step is profiled, and the kernels
    against the plain forward (compare_plain).  Returns (kernel reports,
    the requests' launch counts)."""
    from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
    from ggml_hexagon_tpu_torch.models.launches import launch_table
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig
    from ggml_hexagon_tpu_torch.models.synth import LLAMA3_70B, llama_bpe_vocab
    from ggml_hexagon_tpu_torch.quant import pack
    from ggml_hexagon_tpu_torch.runtime.engine import Engine

    name = "Llama-3-70B IQ3_XXS from a GGUF file"
    t_ph = phase(name, dev)
    fields, _ = llama_bpe_vocab()
    src, tmp = write_synth_gguf(dev, LlamaConfig(**LLAMA3_70B), "IQ3_XXS",
                                "llama-3-70b-iq3_xxs-synthetic.gguf", fields,
                                has_imatrix=True, depth=LLAMA70_DEPTH)
    expand, spent = pack.expand_wire, []

    def timed_expand(*a, **k):
        sync(dev)
        t0 = time.perf_counter()
        out = expand(*a, **k)
        sync(dev)
        spent.append(time.perf_counter() - t0)
        return out

    try:
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        pack.expand_wire = timed_expand
        try:
            eng = Engine.from_gguf(src, fuse=True, max_seq=1024, device=dev)
        finally:
            pack.expand_wire = expand
        log(f"Engine.from_gguf(fuse=True): t_load {eng.perf.t_load:.2f} s "
            f"(the expansion on the card {sum(spent):.2f} s over "
            f"{len(spent)} tensors, each timed between two syncs), peak "
            f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        reader = (GGUFReader.open(src) if isinstance(src, str)
                  else GGUFReader.from_buffer(src))
        with reader:
            held_expansion(dev, reader, eng.weights)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del src
    cfg, weights = eng.cfg, eng.weights
    del eng
    layout_log(name, cfg, weights)
    table = launch_table(cfg, weights)
    log(f"launch table: {table}")
    reps = check_kernels_70b(dev, weights, cfg)
    log("serving (launch counters zeroed before, read after)")
    counts = serve(dev, cfg, weights, name, LLAMA70_REQUESTS)
    log(f"main-path launches ({name}): {counts}")
    for key, rep in reps.items():
        rep.launches = counts[key]
    log("where the time goes (profiler; after the counts were read)")
    profile_path(dev, cfg, weights, table, name, kvs=("bf16",))
    log(f"kernel vs plain versions, end to end (each plain layer fed the "
        f"kernel run's input; the layers' outputs and the logits NMSE <= "
        f"{NMSE_LOGITS})")
    compare_plain(dev, cfg, weights)
    phase_end(name, dev, t_ph)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return list(reps.values()), counts


def build_phase(name, builder, dev):
    """Build a configuration on the card and print its layout."""
    t0 = time.perf_counter()
    cfg, weights = builder(seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"{name} (random planes, seed 0): built on the card in "
        f"{time.perf_counter() - t0:.1f} s; resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    layout_log(name, cfg, weights)
    return cfg, weights


def run_phase(name, builder, check, dev):
    """One configuration: build, kernel checks (`check`), serving held to
    its launch table, profile, end-to-end comparison; the model is freed
    after.  Returns (kernel reports, the main path's launch counts)."""
    from ggml_hexagon_tpu_torch.models.launches import launch_table

    t_ph = phase(name, dev)
    cfg, weights = build_phase(name, builder, dev)
    table = launch_table(cfg, weights)
    log(f"launch table ({cfg.n_layer} layers, derived from the built "
        f"layers): {table}")
    reports = check(dev, weights, cfg)
    log_gemm_cell(name)
    log_bucket8_cell(name)
    log("serving (launch counters zeroed before, read after)")
    counts = serve(dev, cfg, weights, name)
    log(f"main-path launches ({name}): {counts}")
    log("where the time goes (profiler; after the counts were read)")
    profile_path(dev, cfg, weights, table, name)
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


#: the depth of the synthetic configurations' phases (phases 2-12): their
#: first layers, the types those layers have in the full-depth file; their
#: launch tables are derived from the built layers (launch_table).  The
#: loading, serving and CLI phases and Gemma-2-9B run at full depth.
#: --depth takes PHASE_DEPTH to FULL_DEPTH (the configurations' 32 layers),
#: or 0 for every layer: a shorter cut is refused, as the first layers of
#: the 8B's file hold Q6_K downs only (layers 0-3), where the checks look
#: for a Q4_K down as well (tests/test_torch_launch_tables.py holds that
#: the first PHASE_DEPTH layers hold every tensor type of each full file)
PHASE_DEPTH = 8
FULL_DEPTH = 32


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--depth", type=int, default=PHASE_DEPTH,
                        help=f"layers of phases 2-12, {PHASE_DEPTH} to "
                        f"{FULL_DEPTH} (0: every layer)")
    args = parser.parse_args()
    if not (args.depth == 0 or PHASE_DEPTH <= args.depth <= FULL_DEPTH):
        parser.error(f"--depth {args.depth}: give {PHASE_DEPTH} to "
                     f"{FULL_DEPTH}, or 0 for every layer (a shorter cut "
                     "lacks down types that the phases' checks look for)")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.models.synth import (build_8b, build_8b_il,
                                                     build_8b_iq3xxs,
                                                     build_8b_iq4xs,
                                                     build_gemma2_9b,
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
    src, tmp, words = write_8b_gguf(dev)
    try:
        reps, counts = run_load(dev, src, words)
        reports += reps
        runs.append(counts)
        runs.append(run_serve(dev, src, smi))
        reps, counts = run_cli(dev, src, smi, words, tmp)
        reports += reps
        runs.append(counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"removed {tmp}")
    del src
    # Gemma-2-9B at full width and depth (42 layers)
    reps, counts = run_phase("Gemma-2-9B Q4_K_M", build_gemma2_9b,
                             check_kernels_gemma2, dev)
    reports += reps
    runs.append(counts)
    depth = args.depth or None
    log(f"phases 2-12 at depth {depth or 'full'}")
    for name, build, check in (
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
        reps, counts = run_phase(name, partial(build, depth=depth), check,
                                 dev)
        reports += reps
        runs.append(counts)

    # the quantizer's path, then the 70B IQ3_XXS from a file
    for run in (run_quantize, run_70b_iq3xxs):
        reps, counts = run(dev)
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
