"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ggml_hexagon_tpu_torch/csrc;
2. holds each kernel (K1 qp8 decode GEMV, K2 dual QKV GEMV, K3 qp8 prefill
   GEMM, K4 fused decode attention) against its plain PyTorch version at
   the Llama-3-8B Q4_K_M shapes of the main path, and times kernel, plain
   version and a one-call PyTorch yardstick with CUDA events;
3. builds a random Llama-3-8B Q4_K_M model at full width and depth on the
   card and serves greedy requests through Engine (bf16 and q8_0 KV),
   with the launch counters zeroed just before and read just after, so
   the counts show the path went through the kernels;
4. runs one prefill + 4 decode steps through the kernels and through the
   plain versions and compares the logits.

Any failure raises: the script exits non-zero and prints no result.  The
last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their times and bounds.  Card rates for the bounds: the H100
SXM data sheet (3.35 TB/s HBM3, 989 TFLOP/s bf16, 1979 TOP/s int8 dense).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BPS = 3.35e12
BF16_OPS = 989e12
INT8_OPS = 1979e12
NMSE_LOGITS = 5e-4   # logits, kernels vs plain versions, end to end
NMSE_KERNEL = 1e-6   # K1-K3 vs plain: same integer/bf16 products, f32 order
ATTN_MAX_ABS = 1e-4  # K4 vs plain: f32 throughout, another order and expf


def log(*a):
    print(*a, flush=True)


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


class KernelReport:
    """Per-kernel sums over the main path's launch mix (counts x shape)."""

    def __init__(self, name, route, source, replaces, per):
        self.d = dict(name=name, route=route, source=source,
                      replaces=replaces, launches=0, max_abs_err=0.0, ms=0.0,
                      plain_ms=0.0, bound_ms=0.0, bound_by="bytes",
                      library_ms=None, per=per)
        self.bytes_ms = self.ops_ms = 0.0

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
    from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P
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
    wn = full["attn_norm_il"]
    eps = cfg.rms_eps
    K1 = KernelReport("qp8_gemv", "cuda", "ggml_hexagon_tpu_torch/csrc/qp8_gemv.cu",
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:426",
                      "one decode step (B=1): 113 launches")
    K2 = KernelReport("qp8_dual", "cuda", "ggml_hexagon_tpu_torch/csrc/qp8_gemv.cu",
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:475",
                      "one decode step (B=1): 16 launches")
    K3 = KernelReport("qp8_gemm", "cuda", "ggml_hexagon_tpu_torch/csrc/qp8_gemm.cu",
                      "ggml_hexagon_tpu/ops/qmm_qp8.py:529",
                      "one 512-token prefill chunk: 145 launches")
    K4 = KernelReport("decode_attn", "cuda", "ggml_hexagon_tpu_torch/csrc/decode_attn.cu",
                      "ggml_hexagon_tpu/ops/decode_attn.py:177",
                      "one decode step at pos 700 of 1024 (B=1): 32 launches")

    def deq_bf16(qt):
        return P.dequantize_qp8(qt, torch.bfloat16).t().contiguous()  # [K, n2]

    # ---- K1: (name, qt, mode, launches per decode step at B=1)
    k1_cases = [("wqkv", full["wqkv"], "normed", n_full),
                ("wo", full["wo"], "res", len(layers)),
                ("gate_up", full["w_gateup_il"], "normed", len(layers)),
                ("down_q4k", dn_q4, "act", len(layers) - n_dn_q6),
                ("down_q6k", dn_q6, "act", n_dn_q6),
                ("head_q6k", head, "raw", 1)]
    log(f"K1 qp8_gemv (kernel vs plain, NMSE <= {NMSE_KERNEL}; times are "
        "medians, L2 flushed)")
    for name, qt, mode, per_step in k1_cases:
        deq = deq_bf16(qt)
        for B in (1, 8):
            x = randn(B, 2 * qt.k if mode == "act" else qt.k)
            kw = {}
            if mode == "normed":
                kw = dict(wn=wn, eps=eps)
            elif mode == "res":
                kw = dict(res=randn(B, qt.n))
            elif mode == "act":
                kw = dict(act="silu", res=randn(B, qt.n))
            got = P.qp8_gemv(x, qt, **kw)
            want = P.qp8_gemv_plain(x, qt, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            e2 = nmse(got, want)
            if not (e2 <= NMSE_KERNEL and torch.isfinite(got).all()):
                raise AssertionError(f"K1 {name} B={B} {mode}: nmse {e2}")
            ms = time_ms(lambda: P.qp8_gemv(x, qt, **kw))
            pms = time_plain_ms(lambda: P.qp8_gemv_plain(x, qt, **kw))
            xl = x[:, :qt.k].to(torch.bfloat16)
            lib = time_ms(lambda: torch.matmul(xl, deq))
            byts = plane_bytes(qt) + nbytes(x, got) + (
                nbytes(kw["res"]) if "res" in kw else 0)
            ops = 2 * B * qt.k * qt.fq.shape[1]
            bms, by = bound_ms(byts, ops, INT8_OPS)
            log(f"  {name:9s} {qt.cfg.qtype.name} {qt.n}x{qt.k} B={B} {mode:6s} "
                f"max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms "
                f"plain={pms:.3f}ms bf16-matmul={lib:.4f}ms bound={bms:.4f}ms "
                f"({by}) {bms / ms:.0%} of bound")
            if B == 1:
                K1.add(per_step, err, ms, pms, byts, ops, INT8_OPS, lib)
        del deq

    log(f"K2 qp8_dual (NMSE <= {NMSE_KERNEL})")
    wqk, wv = mixed["wqk"], mixed["wv"]
    deq = torch.cat([deq_bf16(wqk), deq_bf16(wv)], dim=1)
    for B in (1, 4):
        x = randn(B, wqk.k)
        wn2 = mixed["attn_norm_il"]
        got = P.qp8_dual(x, wqk, wv, wn=wn2, eps=eps)
        want = P.qp8_dual_plain(x, wqk, wv, wn=wn2, eps=eps)
        torch.cuda.synchronize()
        err, e2 = float((got - want).abs().max()), nmse(got, want)
        if not e2 <= NMSE_KERNEL:
            raise AssertionError(f"K2 B={B}: nmse {e2}")
        ms = time_ms(lambda: P.qp8_dual(x, wqk, wv, wn=wn2, eps=eps))
        pms = time_plain_ms(
            lambda: P.qp8_dual_plain(x, wqk, wv, wn=wn2, eps=eps))
        xl = x.to(torch.bfloat16)
        lib = time_ms(lambda: torch.matmul(xl, deq))
        byts = plane_bytes(wqk) + plane_bytes(wv) + nbytes(x, got)
        ops = 2 * B * wqk.k * got.shape[1]
        bms, by = bound_ms(byts, ops, INT8_OPS)
        log(f"  wqk+wv {wqk.n}+{wv.n}x{wqk.k} B={B} max|d|={err:.3e} "
            f"nmse={e2:.2e} kernel={ms:.4f}ms plain={pms:.3f}ms "
            f"bf16-matmul={lib:.4f}ms bound={bms:.4f}ms ({by}) "
            f"{bms / ms:.0%} of bound")
        if B == 1:
            K2.add(n_mixed, err, ms, pms, byts, ops, INT8_OPS, lib)
    del deq

    log(f"K3 qp8_gemm (M=512, NMSE <= {NMSE_KERNEL})")
    M = 512
    k3_cases = [("wqkv", full["wqkv"], n_full),
                ("wqk", mixed["wqk"], n_mixed), ("wv", mixed["wv"], n_mixed),
                ("wo", full["wo"], len(layers)),
                ("gate_up", full["w_gateup_il"], len(layers)),
                ("down_q4k", dn_q4, len(layers) - n_dn_q6),
                ("down_q6k", dn_q6, n_dn_q6), ("head_q6k", head, 1)]
    for name, qt, count in k3_cases:
        x = randn(M, qt.k).to(torch.bfloat16)
        got = P.qp8_gemm(x, qt)
        want = P.qp8_gemm_plain(x, qt)
        torch.cuda.synchronize()
        err, e2 = float((got - want).abs().max()), nmse(got, want)
        if not (e2 <= NMSE_KERNEL and torch.isfinite(got).all()):
            raise AssertionError(f"K3 {name}: nmse {e2}")
        ms = time_ms(lambda: P.qp8_gemm(x, qt), iters=10)
        pms = time_plain_ms(lambda: P.qp8_gemm_plain(x, qt))
        deq = deq_bf16(qt)
        lib = time_ms(lambda: torch.matmul(x, deq), iters=10)
        del deq
        byts = plane_bytes(qt) + nbytes(x, got)
        ops = 2 * M * qt.k * qt.fq.shape[1]
        bms, by = bound_ms(byts, ops, BF16_OPS)
        log(f"  {name:9s} {qt.cfg.qtype.name} {qt.n}x{qt.k} M={M} "
            f"max|d|={err:.3e} nmse={e2:.2e} kernel={ms:.4f}ms "
            f"plain={pms:.3f}ms bf16-matmul={lib:.4f}ms bound={bms:.4f}ms "
            f"({by}) {bms / ms:.0%} of bound "
            f"{ops / ms / 1e9:.1f} TFLOP/s")
        K3.add(count, err, ms, pms, byts, ops, BF16_OPS, lib)

    log(f"K4 decode_attn (S=1024, max|d| <= {ATTN_MAX_ABS})")
    Hq, Hkv, D, S = cfg.n_head, cfg.n_head_kv, cfg.hd, 1024
    for quant in (False, True):
        for B in (1, 4):
            for pos in (0, 1, 700):
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


def serve(dev, cfg, weights):
    """The main path: greedy requests through Engine; returns the launch
    counts of the whole run."""
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.runtime.engine import Engine

    rng = np.random.default_rng(0)
    requests = [("bf16", 512, 32), ("bf16", 128, 32), ("bf16", 7, 16),
                ("q8_0", 512, 32)]
    n_layer = cfg.n_layer
    n_mixed = sum("wqk" in lw for lw in weights["layers"])
    kernels.reset_launches()
    total = dict(kernels.LAUNCHES)
    for kv, n_prompt, n_gen in requests:
        eng = Engine(cfg, weights, max_seq=1024, kv_dtype=kv, device=dev)
        prompt = rng.integers(0, cfg.n_vocab, n_prompt)
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = eng.prefill(prompt[None])
        ttft = time.perf_counter() - t0
        pre = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if logits.shape != (1, cfg.n_vocab) or not np.isfinite(logits).all():
            raise AssertionError(f"prefill logits {logits.shape} not finite")
        toks = [int(np.argmax(logits[0]))]
        mid = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_gen - 1):
            lg = eng.decode_one(np.array([toks[-1]]))
            if not np.isfinite(lg).all():
                raise AssertionError("decode logits not finite")
            toks.append(int(np.argmax(lg[0])))
        dt = time.perf_counter() - t0
        dec = {k: kernels.LAUNCHES[k] - mid[k] for k in mid}
        steps = n_gen - 1
        # K1 per step: wqkv of the all-Q4_K layers, wo, gate_up, down, head
        want_dec = {"qp8_gemv": (4 * n_layer - n_mixed + 1) * steps,
                    "qp8_dual": n_mixed * steps, "decode_attn": n_layer * steps,
                    "qp8_gemm": 0}
        if dec != want_dec:
            raise AssertionError(f"decode launches {dec} != {want_dec}")
        n_proj = 4 * n_layer + n_mixed + 1  # per prefill chunk
        k_pre = "qp8_gemv" if n_prompt <= 8 else "qp8_gemm"
        if pre[k_pre] != n_proj or pre["decode_attn"] or pre["qp8_dual"]:
            raise AssertionError(f"prefill launches {pre}")
        log(f"  request kv={kv} prompt={n_prompt} gen={n_gen}: "
            f"TTFT {ttft * 1e3:.1f} ms, decode {steps / dt:.2f} tok/s "
            f"({dt / steps * 1e3:.2f} ms/step), prefill launches {pre}, "
            f"decode launches {dec} ({dec['qp8_gemv'] // steps}/"
            f"{dec['qp8_dual'] // steps}/{dec['decode_attn'] // steps} "
            f"K1/K2/K4 per step), tokens {toks[:8]}...")
        del eng
    counts = {k: kernels.LAUNCHES[k] - total[k] for k in total}
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts


def _device_ms(prof, n):
    """Device (kernel) time per call from a profiler run of n calls, and
    the top kernels by device time; (None, []) when the trace holds none."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / n / 1e3, e.count // n, e.key))
    if not rows:
        return None, []
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:8]


def profile_path(dev, cfg, weights):
    """Where the time goes: host time vs device kernel time of a 512-token
    prefill and of decode steps at pos ~512 (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    from ggml_hexagon_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(2).integers(0, cfg.n_vocab, 512)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for kv in ("bf16", "q8_0"):
        eng = Engine(cfg, weights, max_seq=1024, kv_dtype=kv, device=dev)
        eng.prefill(prompt[None])          # warm
        eng.reset()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits = eng.prefill(prompt[None])
            host = (time.perf_counter() - t0) * 1e3
        dev_ms, top = _device_ms(prof, 1)
        log(f"  kv={kv} prefill 512: host {host:.2f} ms, device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.2f} ms'}")
        for ms, cnt, key in top[:5]:
            log(f"      {ms:8.3f} ms  x{cnt:<4d} {key[:90]}")
        tok = int(np.argmax(logits[0]))
        for _ in range(3):                  # warm
            tok = int(np.argmax(eng.decode_one(np.array([tok]))[0]))
        n = 5
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                tok = int(np.argmax(eng.decode_one(np.array([tok]))[0]))
            host = (time.perf_counter() - t0) * 1e3 / n
        dev_ms, top = _device_ms(prof, n)
        idle = "not measured" if dev_ms is None else f"{1 - dev_ms / host:.1%}"
        log(f"  kv={kv} decode step at pos ~{eng.n_past}: host {host:.2f} ms, "
            f"device {'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, "
            f"device idle share {idle}")
        for ms, cnt, key in top:
            log(f"      {ms:8.4f} ms  x{cnt:<4d} {key[:90]}")
        del eng


def compare_plain(dev, cfg, weights):
    """One 128-token prefill + 4 decode steps through the kernels and
    through the plain versions, on the card."""
    from ggml_hexagon_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(1).integers(0, cfg.n_vocab, 128)
    for kv in ("bf16", "q8_0"):
        outs = []
        toks = None
        for plain in (False, True):
            eng = Engine(cfg, weights, max_seq=1024, kv_dtype=kv, device=dev,
                         plain=plain)
            lg = [eng.prefill(prompt[None])]
            if toks is None:
                toks = []
                for _ in range(4):
                    toks.append(int(np.argmax(lg[-1][0])))
                    lg.append(eng.decode_one(np.array([toks[-1]])))
            else:
                for t in toks:
                    lg.append(eng.decode_one(np.array([t])))
            outs.append(lg)
            del eng
        for i, (a, b) in enumerate(zip(*outs)):
            e = nmse(torch.from_numpy(a), torch.from_numpy(b))
            d = float(np.abs(a - b).max())
            log(f"  kv={kv} step {i}: logits nmse kernel vs plain {e:.3e}, "
                f"max|d| {d:.3e} (|logits| max {np.abs(b).max():.3e})")
            if not e <= NMSE_LOGITS:
                raise AssertionError(f"kernel vs plain logits nmse {e}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.models.synth import build_8b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    compiling = kernels.build_all()
    log(f"kernel build: {compiling:.1f} s compiling, "
        f"{time.perf_counter() - t0:.1f} s to loaded")
    t0 = time.perf_counter()
    cfg, weights = build_8b(seed=0, device=dev)
    torch.cuda.synchronize()
    wbytes = sum(plane_bytes(v) for lw in weights["layers"] for v in lw.values()
                 if hasattr(v, "fq")) + plane_bytes(weights["output"])
    log(f"Llama-3-8B Q4_K_M (random planes, seed 0): built on the card in "
        f"{time.perf_counter() - t0:.1f} s; matmul planes {wbytes / 1e9:.3f} GB; "
        f"layers with wqkv {sum('wqkv' in lw for lw in weights['layers'])}, "
        f"wqk+wv {sum('wqk' in lw for lw in weights['layers'])}")
    reports = check_kernels(dev, weights, cfg)
    log("serving (launch counters zeroed before, read after)")
    counts = serve(dev, cfg, weights)
    log(f"main-path launches: {counts}")
    for r in reports:
        r.d["launches"] = counts[r.d["name"]]
    log("where the time goes (profiler; after the counts were read)")
    profile_path(dev, cfg, weights)
    log(f"kernel vs plain versions, end to end (logits NMSE <= {NMSE_LOGITS})")
    compare_plain(dev, cfg, weights)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(json.dumps({"kernels": [r.d for r in reports]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
