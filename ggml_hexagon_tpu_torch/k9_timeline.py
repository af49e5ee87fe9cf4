"""Where K9's time goes, phase by phase, on one card:

    python3 -m ggml_hexagon_tpu_torch.k9_timeline

Builds csrc/ffn_fused.cu once more with a %globaltimer stamp, taken by each
block's first consumer thread, at ten points of the kernel (start, phase
A's activation built, A's tiles done, B's counter acquired, B's activation
built, B's pairs done, C's counter acquired, C's activation built, C's
tiles done, end), and, as ablations, once more for each phase with its
activation build taken out (the results are then wrong; only the times
count).  On a Llama-3-8B Q4_K_M il ffn layer (random planes, seed 0) with
its Q4_K down and with its Q6_K down, at B = 1, it prints for each build
the stamps' median and largest over the blocks that reach them, in us
from the first start, for a launch after an L2 flush and for the second
of two launches in a row (the code then in L2, as in a decode step), with
the build's time a launch and a second launch (CUDA events over a graph
replay after an L2 flush, as chip_smoke.py times); then the split path's
three K6 launches on the same planes, one and two in a row.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import kernels
from .kernel_ab import _time_ms
from .models.synth import build_8b_il
from .ops import qmm_fast as PF

#: the stamps, in kernel order, and the source line each follows
STAMPS = (
    ("start", "  Ring rg{0, 0, 0};\n  int rb_lo, nrbt;\n"),
    ("A built", "  if (tid == 0) mbar_arrive(ready);\n"),
    ("A tiles", None),
    ("B acq", "    acquire_tiles(L.phase, L.pa.ntiles, tid);\n"),
    ("B built", "            reinterpret_cast<float*>(ar + L.part_b), tid);\n"
                "    consumers_sync();\n"),
    ("B pairs", None),
    ("C acq", "    acquire_tiles(L.phase + 1, L.pb.ntiles / 2, tid);\n"),
    ("C built", "                                 reinterpret_cast<uint16_t*>"
                "(ar + L.xgp_c), tid);\n    consumers_sync();\n"),
    ("C tiles", "                         nullptr);\n"),
    ("end", None),
)
#: the stamps placed before a line instead
BEFORE = {"A tiles": "  release_tiles(L.phase, done, tid);\n",
          "B pairs": "    release_tiles(L.phase + 1, done, tid);\n",
          "end": "  // the last block to finish"}
#: each phase's activation build, taken out by its ablation
BUILDS = {
    "A": "    build_a(L.pa, rb_lo, nrbt, act, reinterpret_cast<uint16_t*>(ar + L.xgp_a), tid);\n",
    "B": "    build_b(L.pb, L, L.pa.out, act, reinterpret_cast<uint16_t*>(ar + L.xgp_b),\n"
         "            reinterpret_cast<float*>(ar + L.part_b), tid);\n",
    "C": "    build_c<GW, FAM != FAM_BYTE>(L.pc, L, rb_lo, nrbt, act,\n"
         "                                 reinterpret_cast<uint16_t*>(ar + L.xgp_c), tid);\n",
}


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"csrc/ffn_fused.cu no longer holds {old!r} once")
    return src.replace(old, new)


def stamped_source(ablate: str = "") -> str:
    """csrc/ffn_fused.cu with the stamps (g_ts [blocks][10], read back by
    the C entry ffn_ts) and, with `ablate` ("A", "B" or "C"), that phase's
    activation build taken out."""
    n = len(STAMPS)
    s = (kernels.CSRC / "ffn_fused.cu").read_text()
    s = _replace(s, "namespace {\n\n", "namespace {\n\n"
                 f"__device__ unsigned long long g_ts[1024 * {n}];\n"
                 "#define STAMP(k) if (tid == 0) { unsigned long long t_; "
                 "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
                 f"g_ts[blk * {n} + (k)] = t_; }}\n\n")
    for k, (name, after) in enumerate(STAMPS):
        if after is not None:
            s = _replace(s, after, after + f"    STAMP({k});\n")
        else:
            s = _replace(s, BEFORE[name], f"  STAMP({k});\n" + BEFORE[name])
    s = _replace(s, 'extern "C" {\n', 'extern "C" {\n\nint ffn_ts(void* dst) '
                 "{ return (int)cudaMemcpyFromSymbol(dst, g_ts, sizeof(g_ts)); }\n")
    if ablate:
        s = _replace(s, BUILDS[ablate], "")
    return s


def _build(variants: dict) -> dict:
    """Each variant's source built with the package's flags, in parallel,
    and loaded with ffn_fused_run's binding."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        path = kernels.BUILD_DIR / f"k9_timeline_{name}.cu"
        path.write_text(src)
        out = path.with_suffix(".so")
        procs[name] = (out, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
             str(out), str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} timeline build:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.ffn_fused_run.argtypes = kernels._ARGTYPES["ffn_fused_run"]
        lib.ffn_fused_run.restype = ctypes.c_int
        lib.ght_error_string.argtypes = [ctypes.c_int]
        lib.ght_error_string.restype = ctypes.c_char_p
        lib.ffn_ts.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def _stamps(lib, run, blocks: int, flush) -> np.ndarray:
    """The stamps of the last launch `run` makes after an L2 flush, in us
    from the first block's start (-1 where a block did not pass)."""
    for _ in range(4):
        flush.zero_()
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    buf = np.zeros(1024 * len(STAMPS), dtype=np.uint64)
    if lib.ffn_ts(buf.ctypes.data) != 0:
        raise RuntimeError("ffn_ts failed")
    ts = buf.reshape(1024, len(STAMPS))[:blocks].astype(np.int64)
    t0 = ts[:, 0].min()
    return np.where(ts >= t0, (ts - t0) / 1e3, -1.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("k9_timeline: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels.build_all()
    libs = _build({"stamped": stamped_source(),
                   **{f"no_build_{p}": stamped_source(p) for p in BUILDS}})
    cfg, w = build_8b_il(seed=0, device=dev, ffn_fused=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mine = kernels._LIBS["ffn_fused"]
    try:
        for q in ("Q4_K", "Q6_K"):
            lw = next(lw for lw in w["layers"] if lw["ffn_down"].cfg.qtype.name == q)
            d, wo, gu, wn, dn = (cfg.n_embd, lw["wo"], lw["w_gateup_il"],
                                 lw["ffn_norm_il"], lw["ffn_down"])
            G, gs = wo.fs.shape[1], wo.cfg.gs
            attn = torch.randn(1, d, generator=gen, device=dev).to(torch.bfloat16).float()
            h = torch.randn(1, d, generator=gen, device=dev).to(torch.bfloat16).float()
            args = (PF._interleave_x(attn, G, gs).to(torch.bfloat16).contiguous(),
                    PF._sums_natural(attn, G).contiguous(),
                    PF._interleave_x(h, G, gs).contiguous(), wn, wo, gu, dn, cfg.rms_eps)
            plan = kernels.pick_ffn(d, G, dn.k, dn.k, dn.fs.shape[1],
                                    PF._is_packed(dn.cfg), dn.fb is not None,
                                    PF._needs_xg(dn.cfg, dn.fb), 1, sms)
            print(f"== {q} down, B=1, {plan}; stamps in us, median/largest "
                  "over the blocks", flush=True)
            one = lambda: kernels.ffn_fused(*args)  # noqa: E731
            two = lambda: (kernels.ffn_fused(*args), kernels.ffn_fused(*args))  # noqa: E731
            for name, lib in libs.items():
                kernels._LIBS["ffn_fused"] = lib
                t1, t2 = _time_ms(one, 20), _time_ms(two, 20)
                for label, run in (("first", one), ("second", two)):
                    ts = _stamps(lib, run, plan.blocks, flush)
                    cells = [f"{n} " + ("-" if (c := ts[:, k][ts[:, k] >= 0]).size == 0
                                        else f"{np.median(c):.1f}/{c.max():.1f}")
                             for k, (n, _) in enumerate(STAMPS)]
                    print(f"  {name:11s} {label:6s} | " + " | ".join(cells), flush=True)
                print(f"  {name:11s} {t1:.4f} ms a launch, second of two "
                      f"{t2 - t1:.4f} ms", flush=True)
            kernels._LIBS["ffn_fused"] = mine
            # the split path: the same rows of the same planes, un-permuted
            inv = torch.argsort(PF.interleave_perm(d, 32))
            wo_n, dn_n = wo.take_rows(inv), dn.take_rows(inv)
            k6_wo, k6_gu, k6_dn = (PF._k6(x, False) for x in (wo_n, gu, dn_n))
            x = attn.to(torch.bfloat16)
            h1 = k6_wo(x, wo_n, res=h)
            gu2 = k6_gu(h1.to(torch.bfloat16), gu, wn=wn, eps=cfg.rms_eps)
            x1, x2 = h1.to(torch.bfloat16), gu2.to(torch.bfloat16)
            xg = PF.group_sums(dn_n, gu2, "act")

            def split():
                k6_wo(x, wo_n, res=h)
                k6_gu(x1, gu, wn=wn, eps=cfg.rms_eps)
                k6_dn(x2, dn_n, act="silu", res=h1, xg=xg)

            t1 = _time_ms(split, 20)
            t2 = _time_ms(lambda: (split(), split()), 20)
            print(f"  split path  {t1:.4f} ms a launch triple, second of two "
                  f"{t2 - t1:.4f} ms", flush=True)
    finally:
        kernels._LIBS["ffn_fused"] = mine
    return 0


if __name__ == "__main__":
    sys.exit(main())
