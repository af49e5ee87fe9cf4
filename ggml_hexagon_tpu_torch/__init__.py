"""ggml_hexagon_tpu_torch: the PyTorch/CUDA port of ggml_hexagon_tpu.

The JAX package beside it is the reference.  This package imports neither
jax nor anything of ggml_hexagon_tpu; its hand-written CUDA kernels (csrc/,
built and bound by kernels.py) run on an NVIDIA Hopper card, and each has a
plain PyTorch version that the CPU tests hold against the JAX package.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to "cuda"
    and raise here when no card is present: the CPU runs only when the
    caller asks for it (device="cpu", as the tests do)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return device
