"""GGUF split-file support (examples/gguf-split analog).

The port's own copy of ggml_hexagon_tpu/gguf/split.py, over the port's
reader and writer (host only; its shards and merges are byte-equal to the
JAX package's).

Shards a GGUF into `-%05d-of-%05d.gguf` pieces and reads them back as one
logical model (llama_model_load_from_splits, llama.h:440).  Split metadata
keys follow the reference convention (split.no / split.count /
split.tensors.count).
"""
from __future__ import annotations

import os
import re

from .reader import GGUFReader
from .writer import GGUFWriter

SPLIT_RE = re.compile(r"-(\d{5})-of-(\d{5})\.gguf$")


def split_path(base: str, i: int, n: int) -> str:
    return f"{base}-{i+1:05d}-of-{n:05d}.gguf"


def split_gguf(src_path: str, out_base: str, max_tensors: int = 128,
               max_bytes: int | None = None) -> list[str]:
    """Shard by tensor count (or payload bytes).  First shard carries all
    model metadata; every shard carries split bookkeeping keys."""
    with GGUFReader.open(src_path) as r:
        items = list(r.tensors.values())
        groups: list[list] = [[]]
        size = 0
        for t in items:
            cur = groups[-1]
            over_count = len(cur) >= max_tensors
            over_bytes = max_bytes is not None and cur and size + t.n_bytes > max_bytes
            if cur and (over_count or over_bytes):
                groups.append([])
                size = 0
            groups[-1].append(t)
            size += t.n_bytes
        n = len(groups)
        paths = []
        for i, group in enumerate(groups):
            w = GGUFWriter()
            if i == 0:
                for k, v in r.metadata.items():
                    w.add(k, v)
            w.add("split.no", i)
            w.add("split.count", n)
            w.add("split.tensors.count", len(r.tensors))
            for t in group:
                import numpy as np

                w.add_tensor(t.name, np.asarray(r.tensor_bytes(t.name)),
                             t.ggml_type, raw_ne=t.ne)
            p = split_path(out_base, i, n)
            w.write_file(p)
            paths.append(p)
        return paths


class SplitReader:
    """Presents N split files as one GGUFReader-compatible object."""

    def __init__(self, readers: list[GGUFReader]):
        self.readers = readers
        self.metadata = {}
        self.tensors = {}
        self._where = {}
        for r in readers:
            for k, v in r.metadata.items():
                if not k.startswith("split."):
                    self.metadata.setdefault(k, v)
            for name, t in r.tensors.items():
                if name in self.tensors:
                    raise ValueError(f"duplicate tensor {name!r} across splits")
                self.tensors[name] = t
                self._where[name] = r
        expect = readers[0].metadata.get("split.tensors.count")
        if expect is not None and int(expect) != len(self.tensors):
            raise ValueError(
                f"split set incomplete: {len(self.tensors)} tensors, expected {expect}"
            )

    @classmethod
    def open(cls, first_path: str) -> "SplitReader":
        m = SPLIT_RE.search(first_path)
        if not m:
            raise ValueError(f"{first_path} is not a -NNNNN-of-NNNNN.gguf split")
        n = int(m.group(2))
        base = first_path[: m.start()]
        return cls([GGUFReader.open(split_path(base, i, n)) for i in range(n)])

    def tensor_bytes(self, name):
        return self._where[name].tensor_bytes(name)

    def tensor_f32(self, name):
        return self._where[name].tensor_f32(name)

    def close(self):
        for r in self.readers:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *e):
        self.close()


def merge_gguf(first_path: str, out_path: str) -> str:
    """Merge `-%05d-of-%05d.gguf` shards back into one file
    (gguf-split --merge analog; split bookkeeping keys are dropped)."""
    import numpy as np

    sr = SplitReader.open(first_path)
    try:
        w = GGUFWriter()
        for k, v in sr.readers[0].metadata.items():
            if not k.startswith("split."):
                w.add(k, v)
        for r in sr.readers:
            for t in r.tensors.values():
                w.add_tensor(t.name, np.asarray(r.tensor_bytes(t.name)),
                             t.ggml_type, raw_ne=t.ne)
        w.write_file(out_path)
    finally:
        sr.close()
    return out_path
