"""GGUF v3 writer (quantized model files, synthetic models, test fixtures).

The port's own copy of ggml_hexagon_tpu/gguf/writer.py (the port imports
nothing of the JAX package).  Tensors arrive packed, or as f32/f16 data
that add_tensor encodes with quant.ref_numpy's encoders.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

from ..quant.formats import GGMLType, row_size
from .reader import DEFAULT_ALIGNMENT, GGUF_MAGIC, GGUFValueType, _SCALAR_FMT


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _infer_type(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


def _pack_value(v: Any, vt: GGUFValueType) -> bytes:
    if vt == GGUFValueType.STRING:
        return _pack_string(v)
    if vt == GGUFValueType.ARRAY:
        if len(v) == 0:
            # empty arrays default to int32 element type
            return struct.pack("<IQ", GGUFValueType.INT32, 0)
        elem_t = _infer_type(v[0])
        out = struct.pack("<IQ", elem_t, len(v))
        if elem_t == GGUFValueType.STRING:
            return out + b"".join(_pack_string(s) for s in v)
        fmt, _ = _SCALAR_FMT[elem_t]
        return out + b"".join(struct.pack(fmt, x) for x in v)
    fmt, _ = _SCALAR_FMT[vt]
    return struct.pack(fmt, v)


class GGUFWriter:
    def __init__(self, alignment: int = DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.kv: dict[str, tuple[GGUFValueType, Any]] = {}
        self.tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self.kv[key] = (vtype or _infer_type(value), value)

    def add_tensor(
        self,
        name: str,
        data: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw_ne: tuple[int, ...] | None = None,
    ):
        """Add a tensor.  `data` is either an f32/f16 ndarray (quantized here
        to ggml_type, F32 or F16 by its dtype when none is given) or
        pre-packed uint8 bytes with explicit raw_ne."""
        if data.dtype == np.uint8 and raw_ne is not None:
            if ggml_type is None:
                raise ValueError(f"{name}: packed bytes need their ggml_type")
            self.tensors.append((name, tuple(raw_ne), ggml_type, data.reshape(-1)))
            return
        ggml_type = ggml_type or (GGMLType.F16 if data.dtype == np.float16 else GGMLType.F32)
        from ..quant import ref_numpy

        if ggml_type not in ref_numpy.QUANTIZE:
            raise NotImplementedError(f"{name}: no encoder for {ggml_type.name}")
        ne = tuple(reversed(data.shape))  # numpy C-order -> ggml ne order
        packed = ref_numpy.quantize(np.ascontiguousarray(data, np.float32).reshape(-1), ggml_type)
        self.tensors.append((name, ne, ggml_type, packed))

    def write(self, f: BinaryIO):
        if self.alignment != DEFAULT_ALIGNMENT:
            self.add("general.alignment", self.alignment, GGUFValueType.UINT32)
        header = bytearray()
        header += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self.tensors), len(self.kv))
        for key, (vt, v) in self.kv.items():
            header += _pack_string(key) + struct.pack("<I", vt) + _pack_value(v, vt)
        offset = 0
        offsets = []
        for name, ne, ttype, packed in self.tensors:
            offsets.append(offset)
            n_el = int(np.prod(ne))
            nbytes = row_size(ttype, ne[0]) * (n_el // ne[0])
            if packed.size != nbytes:
                raise ValueError(f"{name}: packed {packed.size} != expected {nbytes}")
            offset += (nbytes + self.alignment - 1) // self.alignment * self.alignment
            header += _pack_string(name)
            header += struct.pack("<I", len(ne))
            for d in ne:
                header += struct.pack("<Q", d)
            header += struct.pack("<IQ", ttype, offsets[-1])
        f.write(header)
        pos = len(header)
        pad = (-pos) % self.alignment
        f.write(b"\x00" * pad)
        for (name, ne, ttype, packed), off in zip(self.tensors, offsets):
            f.write(packed.tobytes())
            pad = (-packed.size) % self.alignment
            f.write(b"\x00" * pad)

    def write_file(self, path: str):
        with open(path, "wb") as f:
            self.write(f)
