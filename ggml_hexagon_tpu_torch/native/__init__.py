"""The native (C++) encoders: Q4_0, Q8_0, Q4_K and Q6_K, multithreaded.

The port's own copy of ggml_hexagon_tpu/native (quantize.cpp beside this
file, bound with ctypes).  The library builds with g++ -O3 at first use
into ggml_hexagon_tpu_torch/_build/, keyed by the hash of its source, and
never loads the JAX package's library.  A failed build raises: the native
K-quant encoders differ from the numpy ones at tie-breaks, so a silent
fallback would make the bytes of a quantized file depend on whether g++
ran.  Types the library lacks return None from quantize_native, and the
caller routes them to quant.ref_numpy (quant.policy.quantize_model does).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "quantize.cpp"
BUILD_DIR = _HERE.parent / "_build"

NATIVE_QTYPES = {2, 8, 12, 14}  # Q4_0, Q8_0, Q4_K, Q6_K

_LIB = None
_LOCK = threading.Lock()


def lib_path() -> Path:
    """The library's path in _build/, named by its source's hash."""
    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libquantize-{h}.so"


def build() -> Path:
    """Compile quantize.cpp (g++ -O3) unless this source's library exists;
    raises RuntimeError when g++ fails or is missing."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native encoder build: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native encoder build failed ({' '.join(cmd)}):\n"
                           f"{r.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders leave one library
    return out


def load() -> ctypes.CDLL:
    """The bound library, built first if needed (raises if it cannot be)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.ggtpu_quantize.restype = ctypes.c_int
            lib.ggtpu_quantize.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            _LIB = lib
    return _LIB


def quantize_native(x: np.ndarray, qtype: int,
                    quant_weights: np.ndarray | None = None,
                    n_threads: int = 0) -> np.ndarray | None:
    """Encode flat f32 `x` to `qtype`'s blocks on the host's cores; None
    for a type the library lacks (the caller takes the numpy encoder)."""
    if int(qtype) not in NATIVE_QTYPES:
        return None
    from ..quant.formats import GGMLType, row_size

    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    out = np.empty(row_size(GGMLType(int(qtype)), x.size), dtype=np.uint8)
    qw = None
    if quant_weights is not None:
        qw = np.ascontiguousarray(quant_weights, np.float32).reshape(-1)
        if qw.size != x.size:
            raise ValueError(f"quant_weights: {qw.size} values for {x.size}")
    rc = lib.ggtpu_quantize(
        int(qtype), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), x.size,
        qw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if qw is not None
        else None, n_threads if n_threads > 0 else (os.cpu_count() or 4))
    if rc != 0:
        raise RuntimeError(f"native encoder: {GGMLType(int(qtype)).name} "
                           f"returned {rc}")
    return out
