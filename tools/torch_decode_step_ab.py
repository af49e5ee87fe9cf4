"""The port's Engine under two forwards in one process: the package's
models/llama.forward (A) against the forward of another llama.py (B,
--alt FILE: the file of another commit, unpacked with git archive), on the
random full-size Llama-3-8B Q4_K_M (models/synth.build_8b), B = 1, bf16
KV, max_seq 2048.  Rounds run A B B A ...; each round resets the Engine,
prefills a 1000-token prompt (timed) and then times STEPS decode steps
(Engine.decode_one: wall ms a step, the device synced at its end).
Prints each side's median prefill and decode ms, the card's name and power
limit, and the two sides' logits NMSE.  Needs one card.

    python3 tools/torch_decode_step_ab.py --alt DIR/ggml_hexagon_tpu_torch/models/llama.py
"""
import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_alt(path):
    """The llama.py at path as a module of this package (its relative
    imports resolve here, so both sides share ops and kernels)."""
    name = "ggml_hexagon_tpu_torch.models._alt_llama"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alt", required=True, help="the other llama.py")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_decode_step_ab: no CUDA device")
    from ggml_hexagon_tpu_torch import kernels
    from ggml_hexagon_tpu_torch.models import llama
    from ggml_hexagon_tpu_torch.models.synth import build_8b
    from ggml_hexagon_tpu_torch.runtime import engine as E

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kernels.build_all()
    alt = load_alt(args.alt)
    cfg, weights = build_8b(device="cuda")
    eng = E.Engine(cfg, weights, max_seq=2048, kv_dtype="bf16", device="cuda")
    prompt = np.random.default_rng(0).integers(0, 128000, 1000).tolist()
    fwds = {"A": llama.forward, "B": alt.forward}
    times = {k: ([], []) for k in fwds}
    logits = {}
    order = "ABBA" * ((args.rounds + 3) // 4)
    for side in "AB" + order[:args.rounds]:  # one warm-up round a side
        E.forward = fwds[side]
        eng.reset()
        t0 = time.perf_counter()
        out = eng.prefill([prompt])
        pre = (time.perf_counter() - t0) * 1e3
        tok = int(out[0].argmax())
        steps = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            out = eng.decode_one([tok])
            steps.append((time.perf_counter() - t0) * 1e3)
            tok = int(out[0].argmax())
        if side not in logits:
            logits[side] = out
            continue
        times[side][0].append(pre)
        times[side][1].extend(steps)
    E.forward = llama.forward
    a, b = (torch.from_numpy(logits[k]) for k in "AB")
    e = float(((a - b) ** 2).mean() / (b ** 2).mean().clamp_min(1e-30))
    print(f"card: {smi}")
    for side, (pre, dec) in times.items():
        print(f"{side} ({'package' if side == 'A' else args.alt}): prefill "
              f"of 1000 tokens median {np.median(pre):.2f} ms over "
              f"{len(pre)} rounds; decode step median {np.median(dec):.3f} "
              f"ms, p10 {np.percentile(dec, 10):.3f}, p90 "
              f"{np.percentile(dec, 90):.3f} over {len(dec)} steps")
    print(f"logits of the warm-up rounds' last step: NMSE {e:.3e}")


if __name__ == "__main__":
    main()
