"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the small adapter from a JAX QTensor to the numpy leaf dict that
ggml_hexagon_tpu_torch.convert takes, and tiny quantized fixtures."""
import dataclasses

import numpy as np

from ggml_hexagon_tpu.quant.pack import QTensor as JQTensor

PLANES = ("q", "d", "qh", "sc", "dmin", "m", "fq", "fs", "fb")


def _np(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def jax_qt_leaf(qt: JQTensor) -> dict:
    """JAX QTensor -> {"qtype", "n", "k", "fl", planes...} of numpy."""
    leaf = {"qtype": int(qt.cfg.qtype), "n": qt.n, "k": qt.k, "fl": qt.fl}
    leaf.update({f: _np(getattr(qt, f)) for f in PLANES})
    return leaf


def jax_tree_to_numpy(tree):
    """The JAX weights tree with QTensor leaves as dicts, arrays as numpy."""
    if tree is None:
        return None
    if isinstance(tree, JQTensor):
        return jax_qt_leaf(tree)
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return _np(tree)


def to_port(cfg, tree, device="cpu"):
    """Carry a JAX (cfg, weights) across into the port."""
    from ggml_hexagon_tpu_torch.convert import convert

    return convert(dataclasses.asdict(cfg), jax_tree_to_numpy(tree), device)


def port_qt(qt: JQTensor, device="cpu"):
    from ggml_hexagon_tpu_torch.convert import qtensor_from_numpy

    return qtensor_from_numpy(jax_qt_leaf(qt), device)


def nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / (np.mean(want ** 2) + 1e-30))
