"""Carry the JAX package's parameters across into the port.

Input: the LlamaConfig as `dataclasses.asdict`, and a nested dict
mirroring the JAX weights tree, given as numpy.  Each QTensor leaf is a
dict {"qtype", "n", "k", "fl", "q", "d", "qh", "sc", "dmin", "m", "fq",
"fs", "fb"} (planes may be None); bf16 planes (fs, fb) cross as np.uint16
bit patterns.  Every other array leaf becomes a tensor of its own dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.llama import LlamaConfig
from .quant.formats import GGMLType
from .quant.pack import QCONFIGS, QTensor

_WIRE = ("q", "d", "qh", "sc", "dmin", "m", "fq")
_BF16 = ("fs", "fb")


def _tensor(a, device):
    device = resolve_device(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def qtensor_from_numpy(leaf: dict, device="cuda") -> QTensor:
    qtype = leaf["qtype"]
    qtype = GGMLType[qtype] if isinstance(qtype, str) else GGMLType(qtype)
    planes = {}
    for f in _WIRE:
        a = leaf.get(f)
        planes[f] = None if a is None else _tensor(a, device)
    for f in _BF16:
        a = leaf.get(f)
        if a is not None:
            if a.dtype != np.uint16:
                raise ValueError(f"{f}: bf16 planes cross as np.uint16 bits")
            planes[f] = _tensor(a.view(np.int16), device).view(torch.bfloat16)
        else:
            planes[f] = None
    return QTensor(QCONFIGS[qtype], int(leaf["n"]), int(leaf["k"]),
                   fl=leaf.get("fl", "t"), **planes)


def convert_weights(tree, device="cuda"):
    """Nested dict / list of numpy leaves -> the port's weights tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if "qtype" in tree:
            return qtensor_from_numpy(tree, device)
        return {k: convert_weights(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_weights(v, device) for v in tree]
    return _tensor(np.asarray(tree), device)


def config_from_dict(d: dict) -> LlamaConfig:
    fields = LlamaConfig.__dataclass_fields__
    return LlamaConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items() if k in fields})


def convert(cfg_dict: dict, tree: dict, device="cuda"):
    """-> (LlamaConfig, weights) on `device`."""
    return config_from_dict(cfg_dict), convert_weights(tree, device)
