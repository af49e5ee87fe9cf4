"""K10 in f32 against its plain twin, and what fewer TF32 products would
give, on one card:

    python3 -m ggml_hexagon_tpu_torch.k10_f32_nmse

For every wire type at 1000 x 4096 and four wider shapes (the 8B's 4096 x
4096 wq, 192 x 11008, 256 x 14336), at B = 1, 8 (the f32 GEMV) and 9, 100,
512, 513 (the GEMM, three TF32 products), it prints the kernel's NMSE
against qmm_wire_plain in f32, and on the same inputs the NMSE of one TF32
product, rna(x) . rna(w), of two, adding rna(x) . rna(w - rna(w)), and of
the three products summed by an f32 matmul.  The last lines give the
largest kernel NMSE of each route and the smallest of each control: the
gap that chip_smoke.py's NMSE_K10_F32 sits in.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from .models.synth import random_qtensor
from .ops import qmatmul as PQ
from .quant.formats import GGMLType
from .quant.pack import QCONFIGS


def nmse(got, want):
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).mean() / ((want ** 2).mean() + 1e-30))


def tf32(v):
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero."""
    b = v.contiguous().view(torch.int32)
    r = torch.where((b & 0x7F800000) == 0x7F800000, b, (b + 0x1000) & ~0x1FFF)
    return r.view(torch.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("k10_f32_nmse: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    shapes = [(1000, 4096, t) for t in sorted(QCONFIGS, key=int)]
    shapes += [(4096, 4096, GGMLType.Q4_K), (192, 11008, GGMLType.Q6_K),
               (256, 14336, GGMLType.Q4_K), (256, 14336, GGMLType.Q8_0)]
    worst = {"gemv": (0.0, None), "gemm": (0.0, None)}
    least = [1.0, 1.0]
    for n, k, qtype in shapes:
        g = torch.Generator(device=dev)
        g.manual_seed(n + k + int(qtype))
        qt = random_qtensor(g, n, k, qtype, dev)
        w = PQ._dequant_expr(qt, torch.float32)[:n]
        wb = tf32(w)
        ws = tf32(w - wb)
        for B in (1, 8, 9, 100, 512, 513):
            x = torch.randn(B, k, generator=g, device=dev)
            got = PQ.qmatmul_pallas(x, qt, compute_dtype=torch.float32)
            want = PQ.qmatmul_pallas(x, qt, compute_dtype=torch.float32,
                                     plain=True)
            xb = tf32(x)
            one = xb @ wb.t()
            two = one + xb @ ws.t()
            three = two + tf32(x - xb) @ wb.t()
            e, e1, e2, e3 = (nmse(v, want) for v in (got, one, two, three))
            route = "gemv" if B <= 8 else "gemm"
            if e > worst[route][0]:
                worst[route] = (e, f"{qtype.name} {n}x{k} B={B}")
            least = [min(least[0], e1), min(least[1], e2)]
            print(f"{qtype.name:8s} {n}x{k} B={B:3d} kernel={e:.3e} "
                  f"one={e1:.3e} two={e2:.3e} three_f32={e3:.3e}", flush=True)
    for route, (e, where) in worst.items():
        print(f"largest kernel NMSE, {route}: {e:.3e} ({where})")
    print(f"smallest control NMSE: one product {least[0]:.3e}, two "
          f"{least[1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
