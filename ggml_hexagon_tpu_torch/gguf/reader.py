"""GGUF file reader — mmap-based, zero-copy tensor access.

The port's own copy of ggml_hexagon_tpu/gguf/reader.py (the port imports nothing of the JAX
package).

Implements the public GGUF v2/v3 spec (the format written by
the reference's ggml/src/gguf.cpp and gguf-py): little-endian header, typed
KV metadata store, tensor directory, aligned data section.  Tensor payloads
are exposed as zero-copy numpy views over the mmap (the analog of the
reference's mmap weight loading, src/llama-mmap.cpp:286).
"""
from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any

import numpy as np

from ..quant.formats import GGMLType, TYPE_TRAITS, row_size

GGUF_MAGIC = 0x46554747  # 'GGUF' little-endian
DEFAULT_ALIGNMENT = 32


class GGUFValueType(IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<?", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}


class GGUFFormatError(ValueError):
    pass


@dataclass
class GGUFTensorInfo:
    name: str
    ne: tuple[int, ...]  # ggml order: ne[0] = innermost (row length)
    ggml_type: GGMLType
    offset: int  # relative to data section start

    @property
    def shape(self) -> tuple[int, ...]:
        """numpy C-order shape (reverse of ne)."""
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        # per GGUF spec: rows are padded per-row only at block granularity;
        # ne[0] must be a multiple of block_size for quantized types.
        return row_size(self.ggml_type, self.ne[0]) * self.n_elements // self.ne[0]


class _Cursor:
    def __init__(self, buf, offset: int = 0):
        self.buf = buf
        self.pos = offset

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise GGUFFormatError(
                f"unexpected EOF: need {n} bytes at {self.pos}, file has {len(self.buf)}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def scalar(self, vt: GGUFValueType):
        fmt, size = _SCALAR_FMT[vt]
        return struct.unpack(fmt, self.read(size))[0]

    def string(self, version: int) -> str:
        n = self.u64() if version >= 2 else self.u32()
        if n > 1 << 32:
            raise GGUFFormatError(f"implausible string length {n}")
        return bytes(self.read(n)).decode("utf-8", errors="replace")

    def value(self, vt: GGUFValueType, version: int):
        if vt == GGUFValueType.STRING:
            return self.string(version)
        if vt == GGUFValueType.ARRAY:
            elem_t = GGUFValueType(self.u32())
            n = self.u64() if version >= 2 else self.u32()
            if elem_t == GGUFValueType.ARRAY:
                raise GGUFFormatError("nested arrays not allowed by spec")
            if elem_t == GGUFValueType.STRING:
                return [self.string(version) for _ in range(n)]
            fmt, size = _SCALAR_FMT[elem_t]
            if n * size > len(self.buf):
                raise GGUFFormatError(f"array of {n} x {size}B exceeds file size")
            raw = self.read(n * size)
            return np.frombuffer(raw, dtype=np.dtype(fmt)).tolist()
        return self.scalar(vt)


@dataclass
class GGUFReader:
    """Parsed GGUF file.  metadata: key -> python value; tensors by name."""

    path: str | None
    version: int
    metadata: dict[str, Any]
    tensors: dict[str, GGUFTensorInfo]
    alignment: int
    data_offset: int
    _buf: Any = field(repr=False, default=None)
    _mm: Any = field(repr=False, default=None)

    @classmethod
    def open(cls, path: str | os.PathLike) -> "GGUFReader":
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        f.close()
        reader = cls.from_buffer(mm, path=str(path))
        reader._mm = mm
        return reader

    @classmethod
    def from_buffer(cls, buf, path: str | None = None) -> "GGUFReader":
        c = _Cursor(buf)
        magic = c.u32()
        if magic != GGUF_MAGIC:
            raise GGUFFormatError(f"bad magic 0x{magic:08x} (want GGUF)")
        version = c.u32()
        if version not in (2, 3):
            raise GGUFFormatError(f"unsupported GGUF version {version}")
        n_tensors = c.u64()
        n_kv = c.u64()
        if n_tensors > 1 << 24 or n_kv > 1 << 24:
            raise GGUFFormatError(f"implausible counts: {n_tensors} tensors, {n_kv} kv")
        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = c.string(version)
            vt = GGUFValueType(c.u32())
            metadata[key] = c.value(vt, version)
        alignment = int(metadata.get("general.alignment", DEFAULT_ALIGNMENT))
        if alignment <= 0 or alignment & (alignment - 1):
            raise GGUFFormatError(f"alignment {alignment} not a power of two")
        tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = c.string(version)
            if name in tensors:
                raise GGUFFormatError(f"duplicate tensor name {name!r}")
            n_dims = c.u32()
            if n_dims > 4:
                raise GGUFFormatError(f"tensor {name!r}: {n_dims} dims > 4")
            ne = tuple(c.u64() for _ in range(n_dims))
            try:
                ttype = GGMLType(c.u32())
            except ValueError as e:
                raise GGUFFormatError(f"tensor {name!r}: unknown type") from e
            offset = c.u64()
            if offset % alignment:
                raise GGUFFormatError(f"tensor {name!r}: offset {offset} unaligned")
            if ne and TYPE_TRAITS[ttype].block_size > 1 and ne[0] % TYPE_TRAITS[ttype].block_size:
                raise GGUFFormatError(
                    f"tensor {name!r}: ne[0]={ne[0]} not a multiple of "
                    f"{ttype.name} block size {TYPE_TRAITS[ttype].block_size}"
                )
            tensors[name] = GGUFTensorInfo(name, ne, ttype, offset)
        data_offset = (c.pos + alignment - 1) // alignment * alignment
        # validate payload bounds
        for t in tensors.values():
            end = data_offset + t.offset + t.n_bytes
            if end > len(buf):
                raise GGUFFormatError(
                    f"tensor {t.name!r}: data [{t.offset}, +{t.n_bytes}) exceeds file"
                )
        return cls(
            path=path,
            version=version,
            metadata=metadata,
            tensors=tensors,
            alignment=alignment,
            data_offset=data_offset,
            _buf=buf,
        )

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's packed payload."""
        t = self.tensors[name]
        start = self.data_offset + t.offset
        return np.frombuffer(self._buf, dtype=np.uint8, count=t.n_bytes, offset=start)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantize a tensor to f32 in its numpy (C-order) shape, on the
        CPU through quant.ref_numpy's decoders (every type of the JAX
        package's ref_numpy.dequantize, the i-quants and ternary among
        them)."""
        from ..quant import ref_numpy

        t = self.tensors[name]
        flat = ref_numpy.dequantize(self.tensor_bytes(name), t.ggml_type,
                                    t.n_elements)
        return flat.reshape(t.shape)

    def close(self):
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # zero-copy views still alive; GC unmaps when they die
            self._mm = None
        self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
