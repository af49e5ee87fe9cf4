"""Build and bind the port's CUDA kernels; count their launches.

Each source under csrc/ compiles with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
one nvcc process per source, all started together, into `_build/` beside
this file (listed in .gitignore); a library is keyed by the hash of its
source, so an edited kernel rebuilds and an unchanged one does not.

Launches go to PyTorch's current stream and never synchronise; each C entry
returns cudaGetLastError() after every launch and the binding raises on a
non-zero code.  LAUNCHES counts, per kernel, the wrapper calls that launched
it: a caller zeroes the counts (reset_launches) before a run and reads them
after, to show the run went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

#: library name -> source file
SOURCES = {
    "qp8_gemv": "qp8_gemv.cu",      # K1 and K2
    "qp8_gemm": "qp8_gemm.cu",      # K3
    "decode_attn": "decode_attn.cu",  # K4
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: launches per kernel (K1 qp8_gemv, K2 qp8_dual, K3 qp8_gemm, K4 decode_attn)
LAUNCHES = {"qp8_gemv": 0, "qp8_dual": 0, "qp8_gemm": 0, "decode_attn": 0}

_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_ARGTYPES = {
    "qp8_gemv_run": [_P, _P, _I, _F, _I, _I,
                     _P, _P, _P, _I, _I, _I, _I, _F,
                     _P, _P, _P, _I, _I, _I, _I, _F,
                     _P, _P, _P, _I, _P, _P, _I, _P],
    "qp8_gemm_run": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P],
    "decode_attn_run": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                        _I, _F, _I, _P, _P, _P, _P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> float:
    """Compile every missing library in parallel and load them all.
    Returns the seconds spent compiling (0.0 when all were built)."""
    if len(_LIBS) == len(SOURCES):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, path)
    seconds = time.perf_counter() - t0 if todo else 0.0
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in SOURCES:
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.ght_error_string.argtypes = [ctypes.c_int]
        lib.ght_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return seconds


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def _check(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.ght_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _need(t, dtype, what: str, ndim: int | None = None):
    if t is None:
        return
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.dim()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: expected 16-byte alignment")


def _plane_args(qt):
    from .ops.qmm_qp8 import _offset_bias_t, _pack_bits

    _need(qt.fq, torch.uint8, "fq", 2)
    _need(qt.fs, torch.bfloat16, "fs", 2)
    _need(qt.fb, torch.bfloat16, "fb", 2)
    bl, bh = _pack_bits(qt.cfg)
    n2 = qt.fq.shape[1]
    if n2 % 128 or qt.fs.shape != (qt.k // qt.cfg.gs, n2):
        raise ValueError(f"t-planes of shape {tuple(qt.fq.shape)} / "
                         f"{tuple(qt.fs.shape)} do not fit K={qt.k}")
    return [_ptr(qt.fq), _ptr(qt.fs), _ptr(qt.fb), n2, bl, bh, qt.cfg.gs,
            _offset_bias_t(qt.cfg, qt.fb)]


def _pick_ksb(ncols: int, qts) -> int:
    """K splits across blocks: enough blocks to cover the card twice, while
    every warp keeps at least one chunk of group rows."""
    from .ops.qmm_qp8 import _pack_bits

    blocks = ncols // 128
    chunks = []
    for qt in qts:
        bl, bh = _pack_bits(qt.cfg)
        units = qt.k * (bh or bl) // 8
        chunks.append(units // qt.cfg.gs)
    target = -(-264 // blocks)
    return max(1, min(target, min(chunks) // 8))


def _gemv_launch(kind: str, x, qts, wn, eps, act, res):
    if act not in ("", "silu"):
        raise NotImplementedError(f"act {act!r}: K1 takes silu only")
    K = qts[0].k
    B = x.shape[0]
    width = 2 * K if act else K
    _need(x, torch.float32, "x", 2)
    if x.shape[1] != width or not 1 <= B <= 8:
        raise ValueError(f"x of shape {tuple(x.shape)}: expected [B<=8, {width}]")
    _need(wn, torch.float32, "wn", 1)
    _need(res, torch.float32, "res", 2)
    mode = 2 if act else (1 if eps is not None else 0)
    a = _plane_args(qts[0])
    b = _plane_args(qts[1]) if len(qts) > 1 else [None, None, None, 0, 0, 0, 0, 0.0]
    ncols = a[3] + b[3]
    ksb = _pick_ksb(ncols, qts)
    dev = x.device
    x8 = torch.empty((B, K), dtype=torch.int8, device=dev)
    xs = torch.empty((B, K // 256), dtype=torch.float32, device=dev)
    out = torch.empty((B, ncols), dtype=torch.float32, device=dev)
    ws = (torch.empty((ksb, B, ncols), dtype=torch.float32, device=dev)
          if ksb > 1 else None)
    n_res = 0 if res is None else res.shape[1]
    lib = _lib("qp8_gemv")
    rc = lib.qp8_gemv_run(
        _ptr(x), _ptr(wn), mode, 0.0 if eps is None else float(eps), B, K,
        *a, *b, _ptr(x8), _ptr(xs), _ptr(ws), ksb, _ptr(out), _ptr(res),
        n_res, _stream(dev))
    _check(lib, rc, kind)
    LAUNCHES[kind] += 1
    return out


def qp8_gemv(x, qt, wn=None, eps=None, act: str = "", res=None):
    """K1 on the card: x f32 [B<=8, K] (or [B, 2K] with act) -> [B, n2]."""
    return _gemv_launch("qp8_gemv", x, [qt], wn, eps, act, res)


def qp8_dual(x, qt_a, qt_b, wn=None, eps=None):
    """K2 on the card: -> [B, n2_a + n2_b]."""
    return _gemv_launch("qp8_dual", x, [qt_a, qt_b], wn, eps, "", None)


def qp8_gemm(x, qt):
    """K3 on the card: x bf16 [M, K] -> [M, n2] f32."""
    _need(x, torch.bfloat16, "x", 2)
    M, K = x.shape
    if K != qt.k:
        raise ValueError(f"x K={K} vs weight K={qt.k}")
    a = _plane_args(qt)
    fq, fs, fb, n2, bl, bh, gs, off = a
    dev = x.device
    xg = torch.empty((M, K // gs), dtype=torch.float32, device=dev)
    out = torch.empty((M, n2), dtype=torch.float32, device=dev)
    lib = _lib("qp8_gemm")
    rc = lib.qp8_gemm_run(_ptr(x), fq, fs, fb, n2, bl, bh, gs, off, M, K,
                          _ptr(xg), _ptr(out), _stream(dev))
    _check(lib, rc, "qp8_gemm")
    LAUNCHES["qp8_gemm"] += 1
    return out


def decode_attn(qkv, k_cache, v_cache, pos, cos_sin, *, Hq, Hkv, D, scale,
                swa=0, logit_cap=0.0, n_dims=0, k_scale=None, v_scale=None):
    """K4 on the card -> (attn [B, Hq*D], k_row [B, Hkv*D], v_row) f32."""
    if D != 128:
        raise ValueError(f"head_dim {D}: the kernel takes 128")
    quant = k_scale is not None
    _need(qkv, torch.float32, "qkv", 2)
    cdt = torch.int8 if quant else torch.bfloat16
    _need(k_cache, cdt, "k_cache", 3)
    _need(v_cache, cdt, "v_cache", 3)
    _need(k_scale, torch.float32, "k_scale", 2)
    _need(v_scale, torch.float32, "v_scale", 2)
    _need(pos, torch.int32, "pos", 1)
    _need(cos_sin, torch.float32, "cos_sin", 2)
    B, S = k_cache.shape[:2]
    if k_cache.shape[2] != Hkv * D or qkv.shape != (B, (Hq + 2 * Hkv) * D):
        raise ValueError("qkv / cache shapes do not match the head counts")
    dev = qkv.device
    out = torch.empty((B, Hq * D), dtype=torch.float32, device=dev)
    k_r = torch.empty((B, Hkv * D), dtype=torch.float32, device=dev)
    v_r = torch.empty((B, Hkv * D), dtype=torch.float32, device=dev)
    lib = _lib("decode_attn")
    rc = lib.decode_attn_run(
        _ptr(qkv), _ptr(k_cache), _ptr(v_cache), _ptr(k_scale),
        _ptr(v_scale), _ptr(pos), _ptr(cos_sin), B, Hq, Hkv, S,
        n_dims or D, float(scale), int(swa), float(logit_cap), int(quant),
        _ptr(out), _ptr(k_r), _ptr(v_r), _stream(dev))
    _check(lib, rc, "decode_attn")
    LAUNCHES["decode_attn"] += 1
    return out, k_r, v_r
