"""In-call A/B of K3 (qp8 prefill GEMM) and K4 (fused decode attention):
this tree's kernels against an earlier tree's sources, on one card, in
the order parent, change, change, parent.

    git show <commit>:ggml_hexagon_tpu_torch/csrc/qp8_gemm.cu > DIR/qp8_gemm.cu
    git show <commit>:ggml_hexagon_tpu_torch/csrc/decode_attn.cu > DIR/decode_attn.cu
    python3 -m ggml_hexagon_tpu_torch.kernel_ab --parent DIR

The parent files must have the C entries of 3b0f551 (the last tree before
K3 and K4 were redesigned); they are built with this tree's nvcc flags
and headers.  Shapes: every K3 launch of the Llama-3-8B Q4_K_M prefill
chunk at M = 512, 128 and 32, the coded launches of Llama-3-8B IQ3_XXS
at M = 512, one Mixtral-8x7B expert's lane slice of stacked Q5_K / Q6_K
planes at M = 128 and 512; K4 at pos 0, 1, 700 and 1023, bf16 and int8
caches, B = 1 and 4.  Times are device times of a CUDA-graph replay after
an L2 flush (median of iterations), as chip_smoke.py takes them; each
row also prints the bf16 `torch.matmul` (K3, weight dequantized
beforehand) or SDPA (K4, bf16) yardstick and the bound.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import kernels
from .models.llama import qtensor_rows
from .models.synth import build_8b, build_8b_iq3xxs, random_qtensor
from .ops import decode_attn as PD
from .ops import qmm_qp8 as P
from .ops.basic import rope_freqs
from .quant.formats import GGMLType

HBM_BPS = 3.35e12
BF16_OPS = 989e12
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the parent's C entries (3b0f551)
_PARENT_ARGS = {
    "qp8_gemm_run": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _I] + [_P] * 3,
    "decode_attn_run": [_P] * 7 + [_I] * 5 + [_F, _I, _F, _I] + [_P] * 4,
}
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


def _build_parent(directory: str) -> dict:
    libs = {}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("qp8_gemm", "decode_attn"):
        out = kernels.BUILD_DIR / f"parent_{name}.so"
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                        str(kernels.CSRC), "-o", str(out),
                        f"{directory}/{name}.cu"], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, f"{name}_run")
        fn.argtypes = _PARENT_ARGS[f"{name}_run"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _nmse(got, want):
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


class AB:
    def __init__(self, parent_dir: str, dev):
        self.dev = dev
        self.par = _build_parent(parent_dir)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(1234)
        self.units: dict = {}

    def parent_gemm(self, x, qt):
        fq, fs, fb, n2, ld, bl, bh, gs, off, cm = kernels._plane_args(qt)
        M, K = x.shape
        xg = torch.empty((M, K // gs), dtype=torch.float32, device=self.dev)
        out = torch.empty((M, n2), dtype=torch.float32, device=self.dev)
        rc = self.par["qp8_gemm"](
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
        rc = self.par["decode_attn"](
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
        u = self.units.setdefault(unit, [0.0, 0.0, 0.0, 0.0, 0])
        u[0] += count * (t[0] + t[3]) / 2
        u[1] += count * (t[1] + t[2]) / 2
        u[2] += count * lib
        u[3] += count * bound
        u[4] += count
        return e_new

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the parent's qp8_gemm.cu and "
                         "decode_attn.cu")
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

    for unit, (p, c, lib, bound, n) in ab.units.items():
        print(f"UNIT {unit}: {n} launches, parent {p:.3f} ms, change "
              f"{c:.3f} ms, bf16 matmul {lib:.3f} ms ({c / lib:.2f}x), "
              f"bound {bound:.4f} ms", flush=True)
    print("ALL HELD" if ok else "FAILURES", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
