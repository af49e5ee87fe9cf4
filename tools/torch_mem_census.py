"""Which device tensors outlive chip_smoke.py's phases on the full-size
Llama-3-8B Q4_K_M GGUF file: builds the kernels, writes the file
(chip_smoke.write_8b_gguf), then runs run_load, run_serve and run_cli in
turn, and after each prints a census of the live CUDA tensors (the device
memory allocated, the largest tensors with their shape, dtype, size and
the types of what refers to them).  Each phase logs its own start and
peak memory.  Needs one card; about six minutes.

    python3 tools/torch_mem_census.py
"""
import gc
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from ggml_hexagon_tpu_torch import kernels  # noqa: E402


def describe(o):
    """A short name for an object that refers to a tensor."""
    if isinstance(o, dict):
        return f"dict{list(o)[:6]}"
    if isinstance(o, (list, tuple)):
        return f"{type(o).__name__}[{len(o)}]"
    if hasattr(o, "f_code"):
        return f"frame {o.f_code.co_name}:{o.f_lineno}"
    return type(o).__name__


def census(label, top=6):
    """Log the live CUDA tensors, the largest `top` with two levels of
    referrers."""
    gc.collect()
    ts = [o for o in gc.get_objects()
          if isinstance(o, torch.Tensor) and o.is_cuda]
    tot = sum(t.untyped_storage().nbytes() for t in ts)
    C.log(f"CENSUS {label}: allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, {len(ts)} live "
          f"cuda tensors ({tot / 2**30:.2f} GiB of storage)")
    ts.sort(key=lambda t: -t.untyped_storage().nbytes())
    for t in ts[:top]:
        refs = [r for r in gc.get_referrers(t) if r is not ts]
        C.log(f"   {tuple(t.shape)} {t.dtype} "
              f"{t.untyped_storage().nbytes() / 2**20:.1f} MiB <- "
              f"{[describe(r) for r in refs[:4]]}")
        for r in refs[:2]:
            up = [describe(x) for x in gc.get_referrers(r)
                  if x is not refs and x is not ts][:4]
            C.log(f"        {describe(r)} <- {up}")


def main():
    if not torch.cuda.is_available():
        print("torch_mem_census: no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    C.log(smi)
    C.log(f"build {kernels.build_all():.1f} s")
    src, tmp, words = C.write_8b_gguf(dev)
    try:
        census("before run_load")
        C.run_load(dev, src, words)
        census("after run_load")
        C.run_serve(dev, src, smi)
        census("after run_serve")
        reps, counts = C.run_cli(dev, src, smi, words, tmp)
        C.log(reps[0].d, counts)
        del reps
        census("after run_cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    C.log_summary()


if __name__ == "__main__":
    main()
