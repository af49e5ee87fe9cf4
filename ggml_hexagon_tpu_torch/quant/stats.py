"""Quantization round-trip error statistics — the llama-quantize-stats analog
(the port's own copy of ggml_hexagon_tpu/quant/stats.py).

Reference counterpart: examples/quantize-stats/quantize-stats.cpp — for each
model tensor and each candidate quant type, quantize -> dequantize and report
the error distribution vs the f32 original (total/max error, RMSE), used to
compare formats before committing to an ftype.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .formats import GGMLType
from . import ref_numpy


@dataclass
class ErrorStats:
    name: str
    qtype: str
    n: int
    rmse: float
    max_err: float
    mean_abs: float


def tensor_stats(x: np.ndarray, qtype: GGMLType) -> tuple[float, float, float]:
    """Round-trip x through qtype; returns (rmse, max_err, mean_abs_err)."""
    flat = np.ascontiguousarray(x, np.float32).reshape(-1)
    buf = ref_numpy.quantize(flat, qtype)
    back = ref_numpy.dequantize(np.frombuffer(bytes(buf), np.uint8), qtype,
                                flat.size)
    err = back.astype(np.float64) - flat.astype(np.float64)
    return (float(np.sqrt(np.mean(err * err))), float(np.abs(err).max()),
            float(np.abs(err).mean()))


def quantize_stats(reader, qtypes, include: str | None = None,
                   exclude: str | None = None,
                   per_layer: bool = True) -> list[ErrorStats]:
    """Round-trip every 2-D weight tensor through each qtype.

    include/exclude are substring filters on tensor names (the reference's
    -l/--include-layers analogs).  Tensors whose row length doesn't fit the
    type's block size are skipped, mirroring the reference's
    layer-is-quantizable gate."""
    from .formats import TYPE_TRAITS

    rows: list[ErrorStats] = []
    agg: dict[str, list] = {}
    for name, t in reader.tensors.items():
        if len(t.ne) < 2:
            continue
        if include and include not in name:
            continue
        if exclude and exclude in name:
            continue
        x = reader.tensor_f32(name)
        for qt in qtypes:
            qt = GGMLType[qt] if isinstance(qt, str) else qt
            if qt not in TYPE_TRAITS or t.ne[0] % TYPE_TRAITS[qt].block_size:
                continue
            try:
                rmse, mx, ma = tensor_stats(x, qt)
            except (KeyError, NotImplementedError):
                continue
            if per_layer:
                rows.append(ErrorStats(name, qt.name, x.size, rmse, mx, ma))
            agg.setdefault(qt.name, []).append((x.size, rmse, mx, ma))
    for qt, vals in agg.items():
        n = sum(v[0] for v in vals)
        rmse = float(np.sqrt(sum(v[0] * v[1] ** 2 for v in vals) / n))
        rows.append(ErrorStats("__total__", qt, n, rmse,
                               max(v[2] for v in vals),
                               float(sum(v[0] * v[3] for v in vals) / n)))
    return rows
