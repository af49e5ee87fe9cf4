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
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

#: library name -> source file
SOURCES = {
    "qp8_gemv": "qp8_gemv.cu",      # K1, K2 and K5
    "qp8_gemm": "qp8_gemm.cu",      # K3
    "decode_attn": "decode_attn.cu",  # K4
    "fast_il": "fast_il.cu",        # K6 at B <= 8 (every family and
                                    # mode) and K8
    "fast_dual": "fast_dual.cu",    # K7
    "fast_il_gemm": "fast_il_gemm.cu",  # K6 above 8 rows (the prefill GEMM)
    "ffn_fused": "ffn_fused.cu",    # K9
    "qmm_wire": "qmm_wire.cu",      # K10 at B <= 8 (the streaming GEMV)
    "qmm_wire_gemm": "qmm_wire_gemm.cu",  # K10 above 8 rows (the wgmma GEMM)
    "attention": "attention.cu",    # K11 and K12
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: launches per kernel (K1 qp8_gemv, K2 qp8_dual, K3 qp8_gemm, K4
#: decode_attn, and decode_attn_q4 over a q4_0 cache, K5 qp8_indirect, each
#: of K1-K3 and K5 with a *_coded key for launches on coded planes (K2:
#: either part coded); K6 by family, byte, nibble or
#: coded planes, and mode: fast_byte / fast_nibble / fast_coded (plain,
#: natural or pre-interleaved input), *_normed, *_res, *_act (with or
#: without a residual), a launch on planes with a group bias under the same
#: key; K7 fast_dual, fast_dual_coded (either part coded); K8 by family:
#: fast_indirect (byte), fast_indirect_nibble, fast_indirect_coded; K9 by
#: the family of its down planes: ffn_fused_byte, ffn_fused_nibble,
#: ffn_fused_coded; K10 qmm_wire, K11 flash_attn, K12 decode_attn_gqa)
LAUNCHES = {"qp8_gemv": 0, "qp8_dual": 0, "qp8_gemm": 0, "decode_attn": 0,
            "decode_attn_q4": 0,
            "qp8_indirect": 0, "qp8_gemv_coded": 0, "qp8_dual_coded": 0,
            "qp8_gemm_coded": 0, "qp8_indirect_coded": 0,
            "fast_byte": 0, "fast_byte_normed": 0,
            "fast_byte_res": 0, "fast_byte_act": 0, "fast_nibble": 0,
            "fast_nibble_normed": 0, "fast_nibble_res": 0,
            "fast_nibble_act": 0, "fast_coded": 0, "fast_coded_normed": 0,
            "fast_coded_res": 0, "fast_coded_act": 0, "fast_dual": 0,
            "fast_dual_coded": 0, "fast_indirect": 0,
            "fast_indirect_nibble": 0, "fast_indirect_coded": 0,
            "ffn_fused_byte": 0, "ffn_fused_nibble": 0, "ffn_fused_coded": 0,
            "qmm_wire": 0, "flash_attn": 0, "decode_attn_gqa": 0}

#: K6's GEMM launches (B > 8), apart from LAUNCHES, which counts each of
#: them under its family-and-mode key as well: by family and group bias
#: (none, derived as off * fs, or a stored fb)
GEMM_LAUNCHES = {"fast_byte_gemm": 0, "fast_byte_gemm_derived": 0,
                 "fast_byte_gemm_stored": 0, "fast_nibble_gemm_derived": 0,
                 "fast_nibble_gemm_stored": 0, "fast_coded_gemm": 0}

#: the C entries' code-map ids (0: uncoded planes); csrc/codes.cuh
CODE_MAPS = {"": 0, "iq2": 1, "iq3xxs": 2, "iq3s": 3, "iq1": 4, "tern": 5}

_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_L = ctypes.c_longlong

_ARGTYPES = {
    "qp8_gemv_run": [_P, _P, _I, _F, _I, _I,
                     _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                     _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                     _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "qp8_indirect_run": [_P, _I, _I, _P, _I, _I,
                         _P, _P, _P, _I, _I, _I, _I, _F, _I,
                         _I, _I, _I, _I, _P, _P, _P, _P],
    "qp8_gemm_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                     _P, _I, _P, _P, _P],
    "fast_il_run": [_I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _F, _P, _I,
                    _P, _F, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "fast_il_gemm_run": [_I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _F, _P,
                         _I, _P, _F, _I, _P, _I, _P, _P, _I, _P, _P, _P],
    "fast_dual_run": [_I, _F, _I] + [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _F, _P, _I, _I, _I, _I, _P] * 2
    + [_P, _P, _P],
    "fast_indirect_run": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F,
                          _P, _I, _I, _I, _P, _P, _P, _P],
    "ffn_fused_run": [_I, _I, _I, _F] + [_P] * 4 + [_I] + [_P] * 9 + [_I] * 5
    + [_F] + [_I] * 7 + [_P] * 8,
    "decode_attn_run": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                        _I, _F, _I, _I, _P, _P, _P, _P, _P],
    "qmm_wire_gemv_run": [_I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                          _F, _I, _I, _I, _P, _P, _P, _P],
    "qmm_wire_gemm_run": [_I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                          _F, _I, _I, _P, _P, _P, _P, _P],
    "flash_attn_run": [_P, _P, _P, _P, _L, _L, _L, _L, _I, _I, _I, _I, _I,
                       _F, _I, _P, _P],
    "decode_attn_gqa_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F,
                            _I, _P, _P],
}


def reset_launches():
    for counts in (LAUNCHES, GEMM_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    # the shared headers are part of every source
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
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


def _need(t, dtype, what: str, ndim: int | None = None,
          contiguous: bool = True):
    if t is None:
        return
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.dim()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: expected 16-byte alignment")


def _plane_args(qt):
    """Pointer and geometry arguments of a t-plane set (its code-map id
    last).  The planes may be a lane slice of wider planes (an expert of a
    stacked MoE tensor, models.llama.qtensor_rows): rows then keep the full
    planes' pitch, passed as ld, and no copy is made."""
    from .ops.qmm_qp8 import _offset_bias_t, _pack_bits

    if qt.fl != "t":
        raise ValueError(f"planes of layout {qt.fl!r}: K1-K3 and K5 take t")
    planes = [("fq", qt.fq, torch.uint8), ("fs", qt.fs, torch.bfloat16),
              ("fb", qt.fb, torch.bfloat16)]
    ld = qt.fq.stride(0)
    for what, t, dtype in planes:
        if t is None:
            continue
        _need(t, dtype, what, 2, contiguous=False)
        if t.stride(1) != 1 or t.stride(0) != ld:
            raise ValueError(f"{what}: expected unit lane stride and the "
                             f"row pitch {ld} of fq, got {t.stride()}")
    bl, bh = _pack_bits(qt.cfg)
    n2 = qt.fq.shape[1]
    if n2 % 128 or qt.fs.shape != (qt.k // qt.cfg.gs, n2):
        raise ValueError(f"t-planes of shape {tuple(qt.fq.shape)} / "
                         f"{tuple(qt.fs.shape)} do not fit K={qt.k}")
    return [_ptr(qt.fq), _ptr(qt.fs), _ptr(qt.fb), n2, ld, bl, bh, qt.cfg.gs,
            _offset_bias_t(qt.cfg, qt.fb), CODE_MAPS[qt.cfg.code_map]]


#: shared memory a block may take, and an SM's (each resident block also
#: holds 1 KB of it)
SMEM_BLOCK = 232448
SMEM_SM = 233472
#: K1/K2/K5 (csrc/qp8_gemv.cu): consumer threads a block, group sums a
#: segment slot, most groups a unit row serves, a block's fixed cost in
#: plane bytes (prologue, ramp, sums) for the picker
_GEMV_NCT = 128
_GEMV_GPS = 16
_GEMV_MAXE = 8
_GEMV_BLOCK_COST = 16384


def _a128(v: int) -> int:
    return (v + 127) & ~127


def gemv_cols_per_thread(nb: int) -> int:
    """Columns of a thread's register tile at nb rows (C x nb partials)."""
    return 8 if nb <= 4 else 4


def _gemv_nbp(nb: int) -> int:
    return 1 if nb <= 1 else 2 if nb <= 2 else 4 if nb <= 4 else 8


class GemvGeo(NamedTuple):
    """A t-plane set as K1/K2/K5 stream it: U unit rows a shift slice (of
    the plane with the fewest bits), nl low parts (U rows apart) paired with
    a unit row, E groups a unit row serves, gs, nchunks = U / gs unit
    chunks (a ring stage each), bh high bits, fb a stored bias plane."""
    U: int
    nl: int
    E: int
    gs: int
    nchunks: int
    bh: int
    fb: bool

    @property
    def items(self) -> int:
        """A stage's items of a team: its E groups, or one for both groups
        of the 4+0 planes (a byte's two nibbles)."""
        return 1 if self.E == 2 and not self.bh else self.E


def gemv_geo(qt) -> GemvGeo:
    from .ops.qmm_qp8 import _pack_bits

    bl, bh = _pack_bits(qt.cfg)
    K, gs = qt.k, qt.cfg.gs
    U = K * (bh or bl) // 8
    return GemvGeo(U, bl // bh if bh else 1, K // U, gs, U // gs, bh,
                   qt.fb is not None)


def gemv_stage(geo: GemvGeo, cols: int) -> tuple[int, int]:
    """(bytes a ring stage takes, bytes its copies bring) for tiles of
    `cols` lanes: lo [nl][gs][cols], hi [gs][cols], fs and fb [E][cols]
    bf16, each part 128-aligned (csrc/qp8_gemv.cu stage_of)."""
    lo = geo.nl * geo.gs * cols
    hi = geo.gs * cols if geo.bh else 0
    sc = geo.E * cols * 2
    nbytes = _a128(lo + hi) + _a128(sc) + (_a128(sc) if geo.fb else 0)
    return nbytes, lo + hi + sc + (sc if geo.fb else 0)


def gemv_slots(geo: GemvGeo, ks: int) -> int:
    """Activation segments a block of ks splits may need: per group row,
    those a range of its unit rows touches."""
    su = -(-geo.nchunks // ks) * geo.gs
    return geo.E * (-(-su // 256) + 1)


def gemv_smem(nb: int, sb: int, ns: int, slots: int) -> int:
    """Shared memory of a block (csrc/qp8_gemv.cu layout_of): the ring of
    ns stages of sb bytes (at least the teams' sums), the int8 activation,
    segment scales and group sums of its slots, tables and mbarriers."""
    nbp = _gemv_nbp(nb)
    red = _GEMV_NCT * gemv_cols_per_thread(nb) * nb * 4
    x8 = _a128(max(ns * sb, red))
    xs = x8 + slots * 64 * nbp * 4
    gsum = xs + _a128(slots * nbp * 4)
    tab = gsum + slots * _GEMV_GPS * nbp * 4
    flag = tab + 4 * (2 * _GEMV_MAXE + 2) + 32 * nbp + 4 * nbp
    return _a128(flag + 16) + 16 * ns


class GemvPlan(NamedTuple):
    """A K1/K2/K5 launch: cols lanes a column tile, ks splits of K, ns ring
    stages, nteam teams at work, smem bytes a block, per_sm blocks an SM."""
    cols: int
    ks: int
    ns: int
    nteam: int
    smem: int
    per_sm: int


@functools.lru_cache(maxsize=None)
def pick_gemv(geos: tuple, n2s: tuple, nb: int, rows_z: int,
              sms: int) -> GemvPlan:
    """Tile, ring and K splits of a K1/K2/K5 launch from its shapes and the
    card's SM count: 256-lane tiles where they fill the card twice over,
    or at 8 columns a thread where every plane has 16 of them, else 128-lane
    tiles (four teams a block or more); the splits (whole unit chunks, two
    or more a split) that finish the
    waves of blocks soonest, two blocks an SM where the ring and the
    activation fit (one where they do not), counting each block's fixed
    cost; the deepest ring that fits, up to 16 stages or the block's chunks;
    every team at work unless a round's groups would outgrow the ring."""
    c = gemv_cols_per_thread(nb)
    wide = sum(n // 256 for n in n2s) * rows_z  # 256-lane tiles
    cols = 256 if all(n % 256 == 0 for n in n2s) and (
        wide >= 2 * sms or c == 8 and min(n2s) >= 4096) else 128
    teams = _GEMV_NCT * c // cols
    tiles = sum(n // cols for n in n2s) * rows_z
    stages = [gemv_stage(g, cols) for g in geos]
    sb = max(b for b, _ in stages)
    tx = max(t for _, t in stages)
    items = min(g.items for g in geos)
    best = None
    nch = min(g.nchunks for g in geos)
    for ks in range(1, max(1, nch // 2) + 1):  # two chunks a split or more
        per = max(-(-g.nchunks // ks) for g in geos)
        slots = max(gemv_slots(g, ks) for g in geos)
        for per_sm in (2, 1):
            budget = min(SMEM_BLOCK, SMEM_SM // per_sm - 1024)
            ns = min(16, per)
            while ns > 1 and gemv_smem(nb, sb, ns, slots) > budget:
                ns -= 1
            if gemv_smem(nb, sb, ns, slots) <= budget and ns >= min(2, per):
                break
        else:
            continue
        nteam = teams if per <= ns else min(teams, (ns - 1) * items)
        busy = min(nteam, per * items)  # teams with work in the block
        waves = -(-tiles * ks // (sms * per_sm))
        cost = waves * (per * tx * teams / busy + _GEMV_BLOCK_COST)
        if best is None or cost < best[0]:
            best = (cost, GemvPlan(cols, ks, ns, nteam,
                                   gemv_smem(nb, sb, ns, slots), per_sm))
        if tiles * ks >= 4 * sms * per_sm:
            break
    if best is None:
        raise ValueError(f"no K1/K2/K5 plan fits shared memory for planes "
                         f"{geos} at {nb} rows")
    return best[1]


#: per device, the int32 tile counters of the split sums of K1/K2/K5, K6
#: (B <= 8), K8, K9 (and its phase counters) and K10: zero between calls
#: (each call's last blocks reset theirs), so one buffer a device serves
#: every call on its stream, as the built libraries do.
#: Made at the device's first call, which must come before any CUDA-graph
#: capture (a capture's allocations belong to the graph's pool).
_COUNTERS: dict[int, torch.Tensor] = {}


def _gemv_counters(dev, need: int):
    """The device's tile counters, at least `need` of them."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _COUNTERS:
        _COUNTERS[index] = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    if need > _COUNTERS[index].numel():
        raise ValueError(f"{need} column tiles: more than the "
                         f"{_COUNTERS[index].numel()} split counters")
    return _COUNTERS[index]


def _gemv_plan(qts, n2s, nb, rows_z, dev) -> GemvPlan:
    sms = _sm_count(dev.index if dev.index is not None else
                    torch.cuda.current_device())
    return pick_gemv(tuple(gemv_geo(qt) for qt in qts), tuple(n2s), nb,
                     rows_z, sms)


#: K6 at B <= 8 and K8 (csrc/fast_il.cu il_gemv_kernel): weight rows a
#: tile; for the picker, in plane bytes of one SM's stream, a block's fixed
#: cost (barriers, the tail) and a split tile's (the partials' fence, the
#: counter's round trip, the last block's sum), and the weight of an
#: activation byte (built from L2, latency-bound)
IL_ROWS = 64
_IL_BLOCK_COST = 32768
_IL_SPLIT_COST = 65536
_IL_ACT_WEIGHT = 4


class IlGeo(NamedTuple):
    """Interleaved planes as K6 (B <= 8) and K8 stream them (csrc/fast_il.cu
    il_geo): GW residues (groups) a residue block, nrb blocks (the last
    one ragged when GW does not divide G); nper weight
    periods (gs, or gs/2 on packed planes), NP of them a stage, spr stages a
    residue block, nst stages in all; wb bytes of a stage's weight box (GW x
    NP x IL_ROWS), fsb of a scale box (GW x IL_ROWS bf16)."""
    GW: int
    NP: int
    nper: int
    spr: int
    nrb: int
    nst: int
    wb: int
    fsb: int


def il_geo(K: int, G: int, packed: bool, gw_max: int = 128) -> IlGeo:
    """The stages of K6's (B <= 8), K7's and K8's planes: residue blocks of
    128 groups from G = 128 up (the last one ragged where 128 does not
    divide G, its columns past G read as zeros), else of 64 or 32 dividing
    G, else of 16 (ragged where 16 does not divide G), at most gw_max (K7's
    common width, dual_width); ValueError where the kernel takes none (G
    not a multiple of 8, or gs not of 8, 16 on packed planes)."""
    gs = K // G if G >= 1 and K % G == 0 else 0
    if not gs or G % 8 or gs % (16 if packed else 8):
        raise ValueError(f"K6/K8 take G a multiple of 8 and K/G a multiple "
                         f"of {16 if packed else 8}: K={K}, G={G}")
    GW = min(gw_max,
             128 if G >= 128 else next((w for w in (64, 32) if G % w == 0), 16))
    nper = gs // 2 if packed else gs
    NP = min(256 // GW, nper)
    if nper % NP:
        raise ValueError(f"K6/K8: {nper} periods are not whole stages of {NP}")
    nrb, spr = -(-G // GW), nper // NP
    return IlGeo(GW, NP, nper, spr, nrb, nrb * spr, GW * IL_ROWS * NP,
                 GW * IL_ROWS * 2)


def il_pad(K: int, G: int) -> tuple[int, int]:
    """(K', G') of interleaved planes whose G groups are padded to G' =
    8*ceil(G/8), as K6 and K8 take planes with G % 8 != 0 (ternary at K =
    1024, G = 4, and K = 11008, G = 43): zero-code, zero-scale groups G..G'
    of every period, x with zero columns there; (K, G) when G % 8 == 0."""
    Gp = -(-G // 8) * 8
    return K // G * Gp, Gp


def _pad_il_cols(t, G: int, Gp: int):
    """[..., gs*G] in the interleaved order (column p*G + g) -> [...,
    gs*Gp], zeros at g >= G."""
    lead = t.shape[:-1]
    v = t.reshape(*lead, t.shape[-1] // G, G)
    return torch.nn.functional.pad(v, (0, Gp - G)).reshape(*lead, -1)


def padded_il_planes(qt):
    """qt's interleaved planes with every period's groups padded to G' =
    8*ceil(G/8) (il_pad): codes or values 0 and scales (and bias) 0 in the
    new groups, so they add nothing.  Made once a tensor and kept on it
    (qt.fpad): QTensors with interleaved planes are built in several places
    (with_fast_planes, take_rows, the converter, the fuser), and the first
    launch is where they all meet."""
    from .ops.qmm_fast import _is_packed

    G = qt.fs.shape[1]
    Kp, Gp = il_pad(qt.k, G)
    if Gp == G:
        return qt
    if qt.fpad is not None:
        return qt.fpad
    if _is_packed(qt.cfg):
        p = qt.fq
        v = _pad_il_cols(torch.cat([p & 15, p >> 4], dim=1), G, Gp)
        fq = (v[:, :Kp // 2] | (v[:, Kp // 2:] << 4)).contiguous()
    else:
        fq = _pad_il_cols(qt.fq, G, Gp).contiguous()

    def pad_g(t):
        return None if t is None else torch.nn.functional.pad(t, (0, Gp - G)).contiguous()

    qt.fpad = dataclasses.replace(qt, k=Kp, fq=fq, fs=pad_g(qt.fs),
                                  fb=pad_g(qt.fb))
    return qt.fpad


def il_touched(geo: IlGeo, ks: int) -> int:
    """Residue blocks the widest of ks splits touches (its activation
    slots): split y takes stages [y*nst//ks, (y+1)*nst//ks)."""
    return max((((y + 1) * geo.nst // ks - 1) // geo.spr
                - y * geo.nst // ks // geo.spr + 1) for y in range(ks))


def il_smem(geo: IlGeo, fb: bool, bias: bool, ns: int, ks: int, gs: int,
            nb: int) -> int:
    """Shared memory of a block (csrc/fast_il.cu il_layout): ns ring slots
    (a weight box each), two scale regions (a scale box, and an fb box with
    a stored bias), the bf16 activation of the touched residue blocks, their
    group sums' three parts (with a bias), the norm's partials and factors,
    flag and mbarriers."""
    arb = il_touched(geo, ks)
    slab = nb * geo.GW * 2
    xgp = ns * geo.wb + 2 * geo.fsb * (2 if fb else 1) + _a128(arb * gs * slab)
    red = xgp + (_a128(arb * 3 * slab) if bias else 0)
    return _a128(red + 4 * 32 + 4 * 8 + 16) + 8 * (2 * ns + 3)


class IlPlan(NamedTuple):
    """A K6 (B <= 8) or K8 launch: ks splits of the stages, ns ring
    stages, nbx blocks along the tiles (each takes every nbx-th tile),
    smem bytes a block, per_sm blocks an SM."""
    ks: int
    ns: int
    nbx: int
    smem: int
    per_sm: int


def _pick_persistent(nst: int, tiles: int, rows_z: int, sms: int, stage: int,
                     smem_of, act_of, per_sms=(2, 1)):
    """The plan search of K6 (B <= 8), K7, K8 and K10 (B <= 8): for ks
    splits of the nst stages of `tiles` tiles (whole stages, at most 32),
    the deepest ring (up to 8 stages or the block's) whose smem_of(ns, ks)
    fits two blocks an SM, else one (per_sms: the counts tried, in order);
    one wave of persistent blocks along the tiles
    (times rows_z input rows); the cost, in plane bytes, of the busiest SM
    (a block alone streams at about half an SM's rate): its stages of
    `stage` bytes, a block's fixed cost, act_of(ks) activation bytes and,
    when K is split, each of its tiles' split sum.  Returns (ks, ns, nbx,
    smem, per_sm) of the cheapest, or None where no ring fits."""
    best = None
    for ks in range(1, min(nst, 32) + 1):
        per = -(-nst // ks)
        for per_sm in per_sms:
            budget = min(SMEM_BLOCK, SMEM_SM // per_sm - 1024)
            ns = min(8, per * tiles)
            while ns > 1 and smem_of(ns, ks) > budget:
                ns -= 1
            smem = smem_of(ns, ks)
            if smem <= budget and ns >= min(2, per * tiles):
                break
        else:
            continue
        nbx = max(1, min(tiles, sms * per_sm // (ks * rows_z)))
        blocks, tpb = nbx * ks * rows_z, -(-tiles // nbx)
        streams = max(-(-blocks // sms), 2)
        cost = (streams * tpb * per * stage + _IL_BLOCK_COST
                + _IL_ACT_WEIGHT * act_of(ks)
                + (tpb * _IL_SPLIT_COST if ks > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, (ks, ns, nbx, smem, per_sm))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def pick_il_gemv(K: int, G: int, packed: bool, fb: bool, bias: bool, nb: int,
                 tiles: int, rows_z: int, mode: int, sms: int) -> IlPlan:
    """Splits, ring and blocks of a K6 (B <= 8, mode 0-3 as fast_il_run's)
    or K8 launch (rows_z input rows, nb = 1) over `tiles` tiles of IL_ROWS
    rows, from its shapes and the card's SM count (_pick_persistent):
    each block builds its split's activation (the touched residue blocks'
    columns, twice in act mode, and the whole row for the norm) once."""
    geo = il_geo(K, G, packed)
    gs = K // G
    plan = _pick_persistent(
        geo.nst, tiles, rows_z, sms, geo.wb,
        lambda ns, ks: il_smem(geo, fb, bias, ns, ks, gs, nb),
        lambda ks: nb * 2 * (il_touched(geo, ks) * geo.GW * gs
                             * (2 if mode == 2 else 1) + (K if mode == 1 else 0)))
    if plan is None:
        raise ValueError(f"no K6/K8 plan fits shared memory: K={K}, G={G}, "
                         f"{nb} rows")
    return IlPlan(*plan)


def _il_plan(qt, nb: int, tiles: int, rows_z: int, mode: int, dev) -> IlPlan:
    from .ops.qmm_fast import _is_packed, _needs_xg

    sms = _sm_count(dev.index if dev.index is not None else
                    torch.cuda.current_device())
    return pick_il_gemv(qt.k, qt.fs.shape[1], _is_packed(qt.cfg),
                        qt.fb is not None, _needs_xg(qt.cfg, qt.fb), nb,
                        tiles, rows_z, mode, sms)


class DualPlan(NamedTuple):
    """A K7 launch: each part's IlPlan (its splits, ring, blocks along its
    tiles), the launch's shared memory a block (the larger part's) and
    blocks an SM."""
    a: IlPlan
    b: IlPlan
    smem: int
    per_sm: int


def dual_width(part_a: tuple, part_b: tuple) -> int:
    """K7's residue block width, one for both parts (csrc/fast_dual.cu: a
    kernel instance a width): 128 where both parts' G is 128 or more,
    else 16."""
    return 128 if part_a[1] >= 128 and part_b[1] >= 128 else 16


@functools.lru_cache(maxsize=None)
def pick_il_dual(part_a: tuple, part_b: tuple, nb: int, mode: int,
                 sms: int) -> DualPlan:
    """Splits, ring and blocks of a K7 launch (nb rows, mode 0 plain or 1
    normed) over two parts, each (K, G, packed, fb, bias, tiles) of its
    (padded) planes, from the shapes and the card's SM count: the SMs are
    shared between the parts in proportion to their plane bytes (stages x
    tiles x a stage's bytes), and each part takes _pick_persistent's plan
    on its share, both parts at two blocks an SM, else at one; both parts'
    stages at dual_width's residue block width."""
    parts = (part_a, part_b)
    gw = dual_width(part_a, part_b)
    geos = [il_geo(K, G, packed, gw) for K, G, packed, *_ in parts]
    work = [g.nst * g.wb * p[5] for g, p in zip(geos, parts)]
    share_a = min(sms - 1, max(1, round(sms * work[0] / sum(work))))
    for per_sm in (2, 1):
        plans = []
        for (K, G, packed, fb, bias, tiles), geo, share in zip(
                parts, geos, (share_a, sms - share_a)):
            gs = K // G
            plan = _pick_persistent(
                geo.nst, tiles, 1, share, geo.wb,
                lambda ns, ks, geo=geo, fb=fb, bias=bias, gs=gs:
                    il_smem(geo, fb, bias, ns, ks, gs, nb),
                lambda ks, geo=geo, gs=gs, K=K: nb * 2 * (
                    il_touched(geo, ks) * geo.GW * gs + (K if mode == 1 else 0)),
                per_sms=(per_sm,))
            if plan is None:
                break
            plans.append(IlPlan(*plan))
        else:
            return DualPlan(plans[0], plans[1],
                            max(p.smem for p in plans), per_sm)
    raise ValueError(f"no K7 plan fits shared memory: parts {parts}, {nb} "
                     "rows")


class FfnPlan(NamedTuple):
    """A K9 launch: each phase's splits and blocks along its tiles (A: wo,
    C: down; a phase's blocks are the first nbx x ks of the grid; B:
    gate_up, never split, nbx blocks along its pairs of a gate tile and the
    up tile of the same columns), the ring's stages, the persistent blocks
    (all resident at once, per_sm an SM) and the shared memory a block."""
    ks_a: int
    nbx_a: int
    ks_b: int
    nbx_b: int
    ks_c: int
    nbx_c: int
    ns: int
    blocks: int
    per_sm: int
    smem: int


def ffn_geos(d: int, G: int, K_dn: int, Gc: int, packed: bool):
    """The stages of K9's phases (csrc/ffn_fused.cu): wo and gate_up at
    residue blocks of 128 groups (G % 128 == 0, G <= 512), the down planes
    (K_dn columns in Gc groups, padded to a multiple of 8) at 128 where Gc
    >= 128, else 16; ValueError where the kernel takes none."""
    ga = il_geo(d, G, True)
    if ga.GW != 128 or G > 512:
        raise ValueError(f"K9 takes wo and gate_up planes of G % 128 == 0 "
                         f"and G <= 512, got G={G}")
    return ga, il_geo(K_dn, Gc, packed, 128 if Gc >= 128 else 16)


def ffn_act(geo: IlGeo, gs: int, nb: int, ks: int, bias: bool,
            partials: bool) -> int:
    """Bytes of one phase's activation region (csrc/ffn_fused.cu
    act_region): the bf16 slabs of the residue blocks the widest of ks
    splits touches, their group sums' three parts (with a bias) and, in
    phase B, the partial sums of four period groups."""
    arb = il_touched(geo, ks)
    slab = nb * geo.GW * 2
    end = _a128(arb * gs * slab) + (_a128(arb * 3 * slab) if bias else 0)
    return end + (4 * nb * arb * geo.GW * 4 if partials else 0)


def ffn_smem(ns: int, slotb: int, sb: int, actx: int, d: int) -> int:
    """K9's shared memory a block: ns ring slots of slotb bytes (weight
    boxes, and the fb boxes of planes with a stored bias), two scale
    regions of sb (fs boxes), the largest phase's activation region, a
    tile's outputs or phase A's tiles' sums of squares (f32 [max(d/64,
    64), 8]), the norm's factors, the last-block flag, the mbarriers."""
    tv = 4 * max(d // IL_ROWS, IL_ROWS) * 8
    return _a128(ns * slotb + 2 * sb + actx + tv + 4 * 8 + 16) + 8 * (2 * ns + 3)


@functools.lru_cache(maxsize=None)
def pick_ffn(d: int, G: int, n_ff: int, K_dn: int, Gc: int, packed: bool,
             fb: bool, bias: bool, nb: int, sms: int) -> FfnPlan:
    """Splits, ring and blocks of a K9 launch (nb <= 8 rows; wo [d, d] and
    gate_up [2 n_ff, d] nibble planes of G groups with a stored fb; down
    planes [d, K_dn] of Gc groups, packed or byte, with a stored fb, a bias,
    or none) from the shapes and the card's SM count: each phase takes
    _pick_persistent's plan (its splits of whole stages and its blocks along
    its tiles) on the whole card, every phase at two blocks an SM, else at
    one; phase B is never split (each block takes pairs of a gate and an up
    tile: 14336 / 64 = 224 pairs at the 8B widths, more than half the
    slots), its blocks one a pair up to the grid; the ring is the
    shallowest phase's, the activation region the largest phase's, and the
    grid every block slot of the card (a cooperative launch: all resident
    at once)."""
    ga, gc = ffn_geos(d, G, K_dn, Gc, packed)
    gs_a, gs_c = d // G, K_dn // Gc
    slotb = max(ga.wb, gc.wb)
    sb = max(ga.fsb, gc.fsb)  # fs boxes (fb boxes go through the ring)
    rows = (d, 2 * n_ff, d)
    if any(r % IL_ROWS for r in rows):
        raise ValueError(f"K9 takes rows in tiles of {IL_ROWS}: d={d}, "
                         f"n_ff={n_ff}")
    # phases A and C: geometry, the activation region at ks splits, and the
    # bytes its build reads (the bf16 x_a, the bf16 xd)
    phases = (
        (ga, lambda ks: ffn_act(ga, gs_a, nb, ks, True, False),
         lambda ks: nb * 2 * il_touched(ga, ks) * ga.GW * gs_a),
        (gc, lambda ks: ffn_act(gc, gs_c, nb, ks, bias, False),
         lambda ks: nb * 2 * il_touched(gc, ks) * gc.GW * gs_c))
    act_b = ffn_act(ga, gs_a, nb, 1, True, True)
    pairs = n_ff // IL_ROWS
    for per_sm in (2, 1):
        budget = min(SMEM_BLOCK, SMEM_SM // per_sm - 1024)
        plans = []
        for (geo, act, act_bytes), r in zip(phases, rows[::2]):
            plan = _pick_persistent(
                geo.nst, r // IL_ROWS, 1, sms, geo.wb,
                lambda ns, ks, act=act: ffn_smem(ns, slotb, sb, act(ks), d),
                act_bytes, per_sms=(per_sm,))
            if plan is None:
                break
            plans.append(plan)
        else:
            ns_b = max((ns for ns in range(1, 9)
                        if ffn_smem(ns, slotb, sb, act_b, d) <= budget), default=0)
            if not ns_b:
                continue
            ns = min(ns_b, *(p[1] for p in plans))
            actx = max(act_b, *(act(p[0]) for (_, act, _), p in zip(phases, plans)))
            (ka, _, xa, *_), (kc, _, xc, *_) = plans
            return FfnPlan(ka, xa, 1, min(pairs, sms * per_sm), kc, xc, ns,
                           sms * per_sm, per_sm, ffn_smem(ns, slotb, sb, actx, d))
    raise ValueError(f"no K9 plan fits shared memory: d={d}, n_ff={n_ff}, "
                     f"down K={K_dn}, Gc={Gc}, {nb} rows")


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
    b = (_plane_args(qts[1]) if len(qts) > 1
         else [None, None, None, 0, 0, 0, 0, 0, 0.0, 0])
    ncols = a[3] + b[3]
    dev = x.device
    plan = _gemv_plan(qts, [a[3], b[3]][:len(qts)], B, 1, dev)
    counters = _gemv_counters(dev, ncols // plan.cols)
    out = torch.empty((B, ncols), dtype=torch.float32, device=dev)
    ws = (torch.empty((plan.ks, B, ncols), dtype=torch.float32, device=dev)
          if plan.ks > 1 else None)
    n_res = 0 if res is None else res.shape[1]
    lib = _lib("qp8_gemv")
    rc = lib.qp8_gemv_run(
        _ptr(x), _ptr(wn), mode, 0.0 if eps is None else float(eps), B, K,
        *a, *b, plan.cols, plan.ks, plan.ns, plan.nteam, _ptr(ws),
        _ptr(counters), _ptr(out), _ptr(res), n_res, _stream(dev))
    if any(qt.cfg.code_map for qt in qts):
        kind += "_coded"
    _check(lib, rc, kind)
    LAUNCHES[kind] += 1
    return out


def qp8_gemv(x, qt, wn=None, eps=None, act: str = "", res=None):
    """K1 on the card: x f32 [B<=8, K] (or [B, 2K] with act) -> [B, n2]."""
    return _gemv_launch("qp8_gemv", x, [qt], wn, eps, act, res)


def qp8_dual(x, qt_a, qt_b, wn=None, eps=None):
    """K2 on the card: -> [B, n2_a + n2_b]."""
    return _gemv_launch("qp8_dual", x, [qt_a, qt_b], wn, eps, "", None)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm_token_tile(M: int) -> int:
    """The token tile (wgmma's N) that both wgmma GEMMs take for M rows:
    32 and 128 for the 32- and 128-token buckets, 256 above (the C
    entries' launch_n)."""
    return 32 if M <= 32 else 128 if M <= 128 else 256


def _gemm_splits(M: int, n2: int, K: int, dev) -> int:
    """The splits of K of the two wgmma GEMMs (K3, K6 above 8 rows): more
    blocks when the output tiles alone leave the card's SMs idle (the 8B's
    4096-lane wo and down, Mixtral's experts),
    taken only where they cut the waves of blocks by at least 15%, with
    at least 8 stages of 64 columns a split."""
    blocks = n2 // 128 * -(-M // gemm_token_tile(M))
    sms = _sm_count(dev.index if dev.index is not None else
                    torch.cuda.current_device())

    def waves(ks):
        return -(-blocks * ks // sms) / ks

    best = 1
    for ks in range(2, 9):
        if K // 64 // ks >= 8 and waves(ks) < 0.85 * waves(best):
            best = ks
    return best


def qp8_gemm(x, qt):
    """K3 on the card: x bf16 [M, K] -> [M, n2] f32."""
    _need(x, torch.bfloat16, "x", 2)
    M, K = x.shape
    if K != qt.k:
        raise ValueError(f"x K={K} vs weight K={qt.k}")
    fq, fs, fb, n2, ld, bl, bh, gs, off, cm = _plane_args(qt)
    dev = x.device
    # the group sums as three bf16 parts, groups padded to a stage of 64
    gp = -(-(K // gs) // 64) * 64
    xg = (torch.empty((M, 3 * gp), dtype=torch.bfloat16, device=dev)
          if fb is not None or off else None)
    ks = _gemm_splits(M, n2, K, dev)
    ws = (torch.empty((ks, M, n2), dtype=torch.float32, device=dev)
          if ks > 1 else None)
    out = torch.empty((M, n2), dtype=torch.float32, device=dev)
    lib = _lib("qp8_gemm")
    rc = lib.qp8_gemm_run(_ptr(x), fq, fs, fb, n2, ld, bl, bh, gs, off, cm, M,
                          K, _ptr(xg), ks, _ptr(ws), _ptr(out), _stream(dev))
    key = "qp8_gemm_coded" if cm else "qp8_gemm"
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    return out


def qp8_indirect(x, qt, ids, npe: int):
    """K5 on the card: x f32 [P, K], ids int32 [P] (read on the card) ->
    y [P, npe] f32, row p against lanes [ids[p]*npe, (ids[p]+1)*npe) of
    the stacked planes; an id outside [0, E) gives a NaN row."""
    _need(x, torch.float32, "x", 2)
    _need(ids, torch.int32, "ids", 1)
    P, K = x.shape
    if K != qt.k or ids.shape[0] != P:
        raise ValueError(f"x {tuple(x.shape)} / ids {tuple(ids.shape)} vs "
                         f"weight K={qt.k}")
    fq, fs, fb, n2, ld, bl, bh, gs, off, cm = _plane_args(qt)
    if npe % 128 or n2 % npe:
        raise ValueError(f"{npe} lanes an expert do not tile {n2} lanes")
    dev = x.device
    plan = _gemv_plan([qt], [npe], 1, P, dev)
    counters = _gemv_counters(dev, P * npe // plan.cols)
    out = torch.empty((P, npe), dtype=torch.float32, device=dev)
    ws = (torch.empty((plan.ks, P, npe), dtype=torch.float32, device=dev)
          if plan.ks > 1 else None)
    lib = _lib("qp8_gemv")
    rc = lib.qp8_indirect_run(
        _ptr(x), P, K, _ptr(ids), npe, n2 // npe, fq, fs, fb, ld, bl, bh, gs,
        off, cm, plan.cols, plan.ks, plan.ns, plan.nteam, _ptr(ws),
        _ptr(counters), _ptr(out), _stream(dev))
    key = "qp8_indirect_coded" if cm else "qp8_indirect"
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    return out


#: the C entries' plane families
_FAMILY_ID = {"byte": 0, "nibble": 1, "coded": 2}


def _il_plane_args(qt):
    """(n2, G, nibble, off, cm) of interleaved planes, checked: fq int8
    [n2, K] (byte family) or uint8 [n2, K/2] (nibble and coded families),
    fs and fb bf16 [n2, G] (fb None, or derived as off * fs when off != 0);
    cm the code-map id (0 uncoded)."""
    from .ops.qmm_fast import _is_packed, _offset_bias

    if qt.fl != "il":
        raise ValueError(f"planes of layout {qt.fl!r}: K6-K8 take il")
    nib = _is_packed(qt.cfg)
    _need(qt.fq, torch.uint8 if nib else torch.int8, "fq", 2)
    _need(qt.fs, torch.bfloat16, "fs", 2)
    _need(qt.fb, torch.bfloat16, "fb", 2)
    n2, G = qt.fs.shape
    K = qt.k
    if (qt.fq.shape != (n2, K // 2 if nib else K) or K % G
            or K % (64 if nib else 32)
            or (qt.fb is not None and qt.fb.shape != (n2, G))):
        raise ValueError(f"planes {tuple(qt.fq.shape)} / {tuple(qt.fs.shape)} "
                         f"do not fit K={K}")
    return n2, G, nib, _offset_bias(qt.cfg, qt.fb), CODE_MAPS[qt.cfg.code_map]


def _xg_args(xg, rows: int, G: int, bias: bool):
    """(xg, xg_mode) of a launch: 0 planes without a bias, 1 the caller's
    group sums xg f32 [rows, G], 2 sums taken in the kernel."""
    _need(xg, torch.float32, "xg", 2)
    if xg is not None and (not bias or xg.shape != (rows, G)):
        raise ValueError(f"group sums {tuple(xg.shape)} for planes "
                         f"{'with' if bias else 'without'} a bias, G={G}")
    return 0 if not bias else (1 if xg is not None else 2)


def _fast_launch(family: str, x, qt, wn, eps, act, res, pre_il, xg):
    if act not in ("", "silu"):
        raise NotImplementedError(f"act {act!r}: K6 takes silu only")
    if bool(act) + (eps is not None) + pre_il > 1:
        raise ValueError("K6 takes one mode: pre_il, normed or act")
    _need(x, torch.bfloat16, "x", 2)
    _need(wn, torch.float32, "wn", 1)
    _need(res, torch.float32, "res", 2)
    from .ops.qmm_fast import _family

    n2, G, nib, off, cm = _il_plane_args(qt)
    if family != "fast_" + _family(qt.cfg):
        raise ValueError(f"{qt.cfg.qtype.name} planes are not for {family}")
    K = qt.k
    B = x.shape[0]
    if x.shape[1] != (2 * K if act else K) or n2 % 128:
        raise ValueError(f"x {tuple(x.shape)} vs planes {tuple(qt.fq.shape)}")
    if (eps is None) != (wn is None) or (wn is not None and wn.shape[0] != K):
        raise ValueError("the normed mode takes wn [K] and eps together")
    if res is not None and (res.shape[0] != B or res.shape[1] > n2):
        raise ValueError(f"res {tuple(res.shape)} vs output [{B}, {n2}]")
    bias = qt.fb is not None or off != 0.0
    xg_mode = _xg_args(xg, B, G, bias)
    if act:
        mode, key = 2, family + "_act"
    elif eps is not None:
        mode, key = 1, family + "_normed"
    else:
        mode, key = (3 if pre_il else 0), (family + "_res" if res is not None
                                           else family)
    dev = x.device
    out = torch.empty((B, n2), dtype=torch.float32, device=dev)
    n_res = 0 if res is None else res.shape[1]
    eps = 0.0 if eps is None else float(eps)
    kn = K  # the normed mode's mean divides by the true K
    if il_pad(K, G)[1] != G:
        qt, x, wn, xg = _pad_call(qt, x, wn, xg, mode)
        K, G = qt.k, qt.fs.shape[1]
    if B > 8:
        return _fast_gemm(mode, key, x, qt, G, cm, off, xg, xg_mode, wn, eps,
                          kn, res, n_res, out)
    plan = _il_plan(qt, B, n2 // IL_ROWS, 1, mode, dev)
    ws = (torch.empty((plan.ks, B, n2), dtype=torch.float32, device=dev)
          if plan.ks > 1 else None)
    lib = _lib("fast_il")
    rc = lib.fast_il_run(mode, int(nib), cm, _ptr(x), B, K, _ptr(qt.fq),
                         _ptr(qt.fs), _ptr(qt.fb), n2, G, off, _ptr(xg),
                         xg_mode, _ptr(wn), eps, kn, _ptr(res), n_res, plan.ks,
                         plan.ns, plan.nbx, _ptr(ws),
                         _ptr(_gemv_counters(dev, n2 // IL_ROWS)), _ptr(out),
                         _stream(dev))
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    return out


def _pad_call(qt, x, wn, xg, mode: int):
    """A K6 call on planes with G % 8 != 0 as one on their padded planes
    (padded_il_planes): x gets zero columns in the new groups (at the end
    of a natural-order row; in every period of an interleaved one, each
    half of act's gate ++ up), so does the normed mode's wn, and the group
    sums xg zero groups."""
    pq = padded_il_planes(qt)
    G, Gp = qt.fs.shape[1], pq.fs.shape[1]
    if mode == 2:
        x = torch.cat([_pad_il_cols(h, G, Gp) for h in x.chunk(2, dim=1)], 1)
    elif mode == 3:
        x = _pad_il_cols(x, G, Gp)
    else:
        x = torch.nn.functional.pad(x, (0, pq.k - qt.k))
    if wn is not None:
        wn = _pad_il_cols(wn, G, Gp)
    if xg is not None:
        xg = torch.nn.functional.pad(xg, (0, Gp - G))
    return pq, x.contiguous(), wn, xg


def gemm_key(qt) -> str:
    """The GEMM_LAUNCHES key of K6's GEMM on interleaved planes qt."""
    from .ops.qmm_fast import _family, _offset_bias

    key = f"fast_{_family(qt.cfg)}_gemm"
    if qt.fb is not None:
        return key + "_stored"
    return key + ("_derived" if _offset_bias(qt.cfg, qt.fb) else "")


def _fast_gemm(mode, key, x, qt, G, cm, off, xg, xg_mode, wn, eps, kn, res,
               n_res, out):
    """K6 above 8 rows: the wgmma GEMM of fast_il_gemm.cu, its scratch (x
    permuted for the A fragments, the group sums in three bf16 parts, the
    partials of a K split) allocated here."""
    from .ops.qmm_fast import _family

    B, K = out.shape[0], qt.k
    n2 = out.shape[1]
    if K % 64 or G % 8:
        raise ValueError(f"K6's GEMM takes K % 64 == 0 and G % 8 == 0, got "
                         f"K={K}, G={G}")
    dev = x.device
    gp = -(-G // 64) * 64
    xp = torch.empty((B, K), dtype=torch.bfloat16, device=dev)
    xgs = (torch.empty((B, 3 * gp), dtype=torch.bfloat16, device=dev)
           if xg_mode else None)
    ks = _gemm_splits(B, n2, K, dev)
    ws = (torch.empty((ks, B, n2), dtype=torch.float32, device=dev)
          if ks > 1 else None)
    lib = _lib("fast_il_gemm")
    rc = lib.fast_il_gemm_run(
        mode, _FAMILY_ID[_family(qt.cfg)], cm, _ptr(x), B, K, _ptr(qt.fq),
        _ptr(qt.fs), _ptr(qt.fb), n2, G, off, _ptr(xg), xg_mode, _ptr(wn),
        eps, kn, _ptr(res), n_res, _ptr(xp), _ptr(xgs), ks, _ptr(ws), _ptr(out),
        _stream(dev))
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    GEMM_LAUNCHES[gemm_key(qt)] += 1
    return out


def fast_byte(x, qt, wn=None, eps=None, act: str = "", res=None,
              pre_il: bool = False, xg=None):
    """K6 on the card, interleaved byte planes (fq int8 [n2, K], fs bf16
    [n2, G], fb bf16 [n2, G] or a bias derived as off * fs, or none) ->
    [B, n2] f32.  x bf16 [B, K] in natural column order; normed with wn
    (f32 [K], interleaved) and eps; interleaved already with pre_il; [B, 2K]
    gate ++ up (interleaved) with act="silu".  xg f32 [B, G]: the caller's
    group sums of planes with a bias (None: the kernel sums its own
    activation).  res (f32 [B, n <= n2]) is added last."""
    return _fast_launch("fast_byte", x, qt, wn, eps, act, res, pre_il, xg)


def fast_nibble(x, qt, wn=None, eps=None, act: str = "", res=None,
                pre_il: bool = False, xg=None):
    """K6 on the card, interleaved nibble planes (fq uint8 [n2, K/2]);
    otherwise as fast_byte."""
    return _fast_launch("fast_nibble", x, qt, wn, eps, act, res, pre_il, xg)


def fast_coded(x, qt, wn=None, eps=None, act: str = "", res=None,
               pre_il: bool = False, xg=None):
    """K6 on the card, interleaved coded planes (fq uint8 [n2, K/2] of
    4-bit sign+magnitude codes, no group bias); otherwise as fast_byte."""
    return _fast_launch("fast_coded", x, qt, wn, eps, act, res, pre_il, xg)


def fast_dual(x, qt_a, qt_b, wn_a=None, wn_b=None, eps=None, xg_a=None,
              xg_b=None):
    """K7 on the card: x bf16 [B <= 8, K] in natural column order against
    two interleaved plane sets of any family -> [B, n2_a + n2_b] f32,
    each part normed with its own wn_* (f32 [K], interleaved like its
    planes) when eps is given and biased with its own group sums (xg_*
    f32 [B, G_*], or None: taken in the kernel).  One il_dual_kernel
    launch (csrc/fast_dual.cu), its plan from pick_il_dual; a part whose G
    is not a multiple of 8 runs on its padded planes (padded_il_planes), as
    K6 does."""
    from .ops.qmm_fast import _is_packed

    _need(x, torch.bfloat16, "x", 2)
    B, K = x.shape
    if not 1 <= B <= 8 or K != qt_a.k or K != qt_b.k:
        raise ValueError(f"x {tuple(x.shape)}: expected [B<=8, {qt_a.k}] "
                         f"for K={qt_a.k}/{qt_b.k}")
    if (eps is None) != (wn_a is None) or (wn_a is None) != (wn_b is None):
        raise ValueError("the normed mode takes wn_a, wn_b and eps together")
    mode = 0 if eps is None else 1
    dev = x.device
    parts, shapes = [], []
    for qt, wn, xg in ((qt_a, wn_a, xg_a), (qt_b, wn_b, xg_b)):
        n2, G, nib, off, cm = _il_plane_args(qt)
        _need(wn, torch.float32, "wn", 1)
        if wn is not None and wn.shape[0] != K:
            raise ValueError(f"wn {tuple(wn.shape)} vs K={K}")
        xg_mode = _xg_args(xg, B, G, qt.fb is not None or off != 0.0)
        xp = x
        if il_pad(K, G)[1] != G:
            qt, xp, wn, xg = _pad_call(qt, x, wn, xg, mode)
        parts.append((qt, xp, wn, xg, n2, nib, off, cm, xg_mode))
        shapes.append((qt.k, qt.fs.shape[1], _is_packed(qt.cfg),
                       qt.fb is not None, xg_mode != 0, -(-n2 // IL_ROWS)))
    sms = _sm_count(dev.index if dev.index is not None else
                    torch.cuda.current_device())
    plan = pick_il_dual(shapes[0], shapes[1], B, mode, sms)
    # the partials of split parts stay referenced until the launch: a
    # tensor freed earlier could be handed to `out` by the caching allocator
    args, ws = [], []
    for (qt, xp, wn, xg, n2, nib, off, cm, xg_mode), pp in zip(
            parts, (plan.a, plan.b)):
        ws.append(torch.empty((pp.ks, B, n2), dtype=torch.float32, device=dev)
                  if pp.ks > 1 else None)
        args += [_ptr(xp), qt.k, _ptr(wn), _ptr(qt.fq), _ptr(qt.fs),
                 _ptr(qt.fb), n2, qt.fs.shape[1], int(nib), cm, off,
                 _ptr(xg), xg_mode, pp.ks, pp.ns, pp.nbx, _ptr(ws[-1])]
    out = torch.empty((B, parts[0][4] + parts[1][4]), dtype=torch.float32,
                      device=dev)
    counters = _gemv_counters(dev, shapes[0][5] + shapes[1][5])
    lib = _lib("fast_dual")
    rc = lib.fast_dual_run(B, 0.0 if eps is None else float(eps), K, *args,
                           _ptr(counters), _ptr(out), _stream(dev))
    del ws
    key = ("fast_dual_coded" if qt_a.cfg.code_map or qt_b.cfg.code_map
           else "fast_dual")
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    return out


def fast_indirect(x, qt, ids, npe: int, xg=None):
    """K8 on the card: x bf16 [P, K] in natural column order, ids int32 [P]
    (read on the card), xg f32 [P, G] the group sums of x where the planes
    carry a bias -> y [P, npe] f32, row p against rows
    [ids[p]*npe, (ids[p]+1)*npe) of the stacked interleaved planes (byte
    or nibble; npe rows in tiles of IL_ROWS, the last one ragged); an id
    outside [0, E) gives a NaN row."""
    _need(x, torch.bfloat16, "x", 2)
    _need(ids, torch.int32, "ids", 1)
    n2, G, nib, off, cm = _il_plane_args(qt)
    P, K = x.shape
    if K != qt.k or ids.shape[0] != P:
        raise ValueError(f"x {tuple(x.shape)} / ids {tuple(ids.shape)} vs "
                         f"weight K={qt.k}")
    if npe < 1 or n2 % npe:
        raise ValueError(f"{npe} rows an expert do not tile {n2} rows")
    bias = qt.fb is not None or off != 0.0
    if _xg_args(xg, P, G, bias) == 2:
        raise ValueError("K8 takes the group sums of planes with a bias as "
                         "an input")
    key = ("fast_indirect_coded" if cm else
           "fast_indirect_nibble" if nib else "fast_indirect")
    if il_pad(K, G)[1] != G:
        qt, x, _, xg = _pad_call(qt, x, None, xg, 0)
        K, G = qt.k, qt.fs.shape[1]
    dev = x.device
    tiles = -(-npe // IL_ROWS)
    plan = _il_plan(qt, 1, tiles, P, 0, dev)
    ws = (torch.empty((plan.ks, P, npe), dtype=torch.float32, device=dev)
          if plan.ks > 1 else None)
    out = torch.empty((P, npe), dtype=torch.float32, device=dev)
    lib = _lib("fast_il")
    rc = lib.fast_indirect_run(_ptr(x), P, K, _ptr(ids), npe, n2 // npe,
                               _ptr(qt.fq), _ptr(qt.fs), _ptr(qt.fb), G,
                               int(nib), cm, off, _ptr(xg), plan.ks, plan.ns,
                               plan.nbx, _ptr(ws),
                               _ptr(_gemv_counters(dev, P * tiles)),
                               _ptr(out), _stream(dev))
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    return out


def ffn_fused(x_a, xg_a, h_il, wn, wo, gu, dn, eps: float, act: str = "silu"):
    """K9 on the card: x_a bf16 [B <= 8, d] (the attention output in wo's
    interleaved column order), xg_a f32 [B, G] (its group sums), h_il f32
    [B, d] (the residual, interleaved), wn f32 [d] (the ffn norm weight,
    interleaved); wo [d, d] and gate_up [2 n_ff, d] on nibble planes with a
    stored fb, down [d, n_ff] on nibble, byte or coded planes (rows of wo and
    down in the il32 order) -> the layer output f32 [B, d] in that order.

    One cooperative launch of csrc/ffn_fused.cu (K6's streaming block over
    three phases, wo, gate_up and down, one ring whose producer streams
    the next phase's weights across each boundary; the phases meet at
    device counters), its plan from pick_ffn; down planes whose groups are
    not a multiple of 8 run padded (padded_il_planes), as K6's do.  What
    bounds it is bytes: every weight byte is read once and feeds B
    multiply-adds (2B on packed planes)."""
    if act != "silu":
        raise NotImplementedError(f"act {act!r}: K9 takes silu only")
    from .ops.qmm_fast import _family, _is_packed

    _need(x_a, torch.bfloat16, "x_a", 2)
    _need(xg_a, torch.float32, "xg_a", 2)
    _need(h_il, torch.float32, "h_il", 2)
    _need(wn, torch.float32, "wn", 1)
    B, d = x_a.shape
    n_wo, G, nib_wo, _, _ = _il_plane_args(wo)
    n_gu, G_gu, nib_gu, _, _ = _il_plane_args(gu)
    n_dn, Gc, _, off, cm = _il_plane_args(dn)
    n_ff = dn.k
    if not (nib_wo and nib_gu and _family(wo.cfg) == _family(gu.cfg) == "nibble"
            and wo.fb is not None and gu.fb is not None):
        raise ValueError("K9 takes nibble wo and gate_up planes with a stored fb")
    if (not 1 <= B <= 8 or wo.k != d or n_wo != d or gu.k != d or G_gu != G
            or n_gu != 2 * n_ff or n_dn != d or xg_a.shape != (B, G)
            or h_il.shape != (B, d) or wn.shape != (d,)):
        raise ValueError(f"K9 shapes: x_a {tuple(x_a.shape)}, wo "
                         f"{tuple(wo.fq.shape)}, gate_up {tuple(gu.fq.shape)}, "
                         f"down {tuple(dn.fq.shape)}")
    family = _family(dn.cfg)
    key = "ffn_fused_" + family
    bias = dn.fb is not None or off != 0.0
    dnp = padded_il_planes(dn) if il_pad(n_ff, Gc)[1] != Gc else dn
    Gp = dnp.fs.shape[1]
    dev = x_a.device
    plan = pick_ffn(d, G, n_ff, dnp.k, Gp, _is_packed(dn.cfg),
                    dn.fb is not None, bias, B,
                    _sm_count(dev.index if dev.index is not None
                              else torch.cuda.current_device()))
    counters = _gemv_counters(dev, 2 * d // IL_ROWS + 3)
    # scratch stays referenced until the launch is enqueued
    h2 = torch.empty((B, d), dtype=torch.float32, device=dev)
    ssq = torch.empty((d // IL_ROWS, 8), dtype=torch.float32, device=dev)
    xd = torch.empty((B, n_ff), dtype=torch.bfloat16, device=dev)
    ws = [torch.empty((ks, B, d), dtype=torch.float32, device=dev)
          if ks > 1 else None for ks in (plan.ks_a, plan.ks_c)]
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    lib = _lib("ffn_fused")
    rc = lib.ffn_fused_run(
        B, d, n_ff, float(eps), _ptr(x_a), _ptr(xg_a), _ptr(h_il), _ptr(wn), G,
        _ptr(wo.fq), _ptr(wo.fs), _ptr(wo.fb), _ptr(gu.fq), _ptr(gu.fs),
        _ptr(gu.fb), _ptr(dnp.fq), _ptr(dnp.fs), _ptr(dnp.fb), dnp.k, Gp, Gc,
        _FAMILY_ID[family], cm, off, plan.ks_a, plan.nbx_a, plan.nbx_b,
        plan.ks_c, plan.nbx_c, plan.ns, plan.blocks, _ptr(h2), _ptr(ssq),
        _ptr(xd), *(_ptr(w) for w in ws), _ptr(counters), _ptr(out),
        _stream(dev))
    del ws
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    return out


def decode_attn(qkv, k_cache, v_cache, pos, cos_sin, *, Hq, Hkv, D, scale,
                swa=0, logit_cap=0.0, n_dims=0, k_scale=None, v_scale=None,
                kv_bits=0):
    """K4 on the card -> (attn [B, Hq*D], k_row [B, Hkv*D], v_row) f32.
    Caches bf16 [B, S, Hkv*D]; int8 with f32 row scales (k_scale given);
    or, with kv_bits=4, uint8 [B, S, Hkv*D/2] of packed 4-bit values
    (ops/decode_attn.pack_int4) with the same scales, counted apart under
    "decode_attn_q4"."""
    if D != 128:
        raise ValueError(f"head_dim {D}: the kernel takes 128")
    quant = k_scale is not None
    if kv_bits not in (0, 4) or (kv_bits == 4 and not quant):
        raise ValueError(f"kv_bits {kv_bits}: 4 (with row scales) or 0")
    _need(qkv, torch.float32, "qkv", 2)
    cdt = (torch.uint8 if kv_bits == 4 else torch.int8) if quant else torch.bfloat16
    _need(k_cache, cdt, "k_cache", 3)
    _need(v_cache, cdt, "v_cache", 3)
    _need(k_scale, torch.float32, "k_scale", 2)
    _need(v_scale, torch.float32, "v_scale", 2)
    _need(pos, torch.int32, "pos", 1)
    _need(cos_sin, torch.float32, "cos_sin", 2)
    B, S = k_cache.shape[:2]
    row = Hkv * D // 2 if kv_bits == 4 else Hkv * D
    if (k_cache.shape[2] != row or v_cache.shape != k_cache.shape
            or qkv.shape != (B, (Hq + 2 * Hkv) * D)):
        raise ValueError("qkv / cache shapes do not match the head counts")
    if quant and (k_scale.shape != (B, S) or v_scale.shape != (B, S)):
        raise ValueError(f"row scales {tuple(k_scale.shape)}: expected "
                         f"[{B}, {S}]")
    dev = qkv.device
    nsplit = _pick_nsplit(B * Hkv, S, min_slots=32)
    # one partial a split and a head, and the fresh row's self-term
    part = torch.empty((B, Hkv, nsplit + 1, Hq // Hkv, D + 2),
                       dtype=torch.float32, device=dev)
    out = torch.empty((B, Hq * D), dtype=torch.float32, device=dev)
    k_r = torch.empty((B, Hkv * D), dtype=torch.float32, device=dev)
    v_r = torch.empty((B, Hkv * D), dtype=torch.float32, device=dev)
    lib = _lib("decode_attn")
    rc = lib.decode_attn_run(
        _ptr(qkv), _ptr(k_cache), _ptr(v_cache), _ptr(k_scale),
        _ptr(v_scale), _ptr(pos), _ptr(cos_sin), B, Hq, Hkv, S,
        n_dims or D, float(scale), int(swa), float(logit_cap),
        (4 if kv_bits == 4 else 8) if quant else 16,
        nsplit, _ptr(part), _ptr(out), _ptr(k_r), _ptr(v_r), _stream(dev))
    key = "decode_attn_q4" if kv_bits == 4 else "decode_attn"
    _check(lib, rc, key)
    LAUNCHES[key] += 1
    return out, k_r, v_r


#: K10's plane families, (bits_lo, bits_hi, signed, lut, superblock, asym)
#: -> the C entry's id; the signed family holds Q8_0 and the expanded
#: i-quants and ternary
_WIRE_FAMILIES = {
    (8, 0, True, False, False, "none"): 0,
    (4, 0, False, True, False, "none"): 1,     # IQ4_NL
    (4, 0, False, True, True, "none"): 2,      # IQ4_XS
    (4, 0, False, False, False, "none"): 3,    # Q4_0
    (4, 0, False, False, False, "min"): 4,     # Q4_1
    (4, 1, False, False, False, "none"): 5,    # Q5_0
    (4, 1, False, False, False, "min"): 6,     # Q5_1
    (2, 0, False, False, True, "minsb"): 7,    # Q2_K
    (2, 1, False, False, True, "none"): 8,     # Q3_K
    (4, 0, False, False, True, "minsb"): 9,    # Q4_K
    (4, 1, False, False, True, "minsb"): 10,   # Q5_K
    (4, 2, False, False, True, "none"): 11,    # Q6_K
}


def wire_family(cfg) -> int:
    key = (cfg.bits_lo, cfg.bits_hi, cfg.signed, cfg.lut, cfg.superblock,
           cfg.asym)
    if key not in _WIRE_FAMILIES:
        raise NotImplementedError(f"{cfg.qtype.name}: no K10 family")
    return _WIRE_FAMILIES[key]


#: K10 at B <= 8 (csrc/qmm_wire.cu wire_gemv_kernel): weight rows a tile,
#: and the activation rows it takes
WIRE_ROWS = 64
WIRE_GEMV_ROWS = 8


def _wire_record(HW: int, gs: int, superblock: bool, asym: str):
    """(n, scw, nrec) of a run of HW columns' scale record (csrc/wire.cuh
    wire_record): its groups, sc words and words."""
    n = HW // gs if HW >= gs else 1
    two = 1 + (asym != "none")
    if superblock:
        scw = (n + 3) // 4 + 1
        return n, scw, (2 if asym == "minsb" else 1) + scw * two
    return n, 0, n * two


class WireGeo(NamedTuple):
    """A family's wire planes as K10's GEMV walks them (csrc/qmm_wire.cu
    wire_geo): per values a low-plane byte, Kp low and Kph high bytes a
    row (Kph = Kp without a high plane), R = Kp / Kph low bytes a high
    byte serves, HW high positions a stage (128, 64 or 32, dividing Kph),
    nst stages a tile; a run's scale record holds n groups in nrec words
    (scw of them for sc, and for m); sb bytes a ring slot (R low boxes,
    the high box, 64 rows of per*R records)."""
    per: int
    Kp: int
    Kph: int
    R: int
    HW: int
    nst: int
    n: int
    scw: int
    nrec: int
    sb: int


def wire_geo(K: int, bl: int, bh: int, superblock: bool, asym: str,
             gs: int) -> WireGeo:
    per = 8 // bl
    Kp = K // per
    Kph = K * bh // 8 if bh else Kp
    R = Kp // Kph
    HW = 128 if Kph % 128 == 0 else 64 if Kph % 64 == 0 else 32
    n, scw, nrec = _wire_record(HW, gs, superblock, asym)
    box = WIRE_ROWS * HW
    sb = _a128((R + (bh > 0)) * box + WIRE_ROWS * per * R * nrec * 4)
    return WireGeo(per, Kp, Kph, R, HW, Kph // HW, n, scw, nrec, sb)


def wire_smem(geo: WireGeo, ns: int, ks: int, nb: int,
              f32: bool = False) -> int:
    """Shared memory of a block (csrc/qmm_wire.cu wire_layout): ns ring
    slots, the split's activation (nb rows of per*R runs of the widest
    split's columns, bf16, or f32 with 16 bytes of skew every 32 columns),
    the halves' partial sums, flag and mbarriers."""
    lmax = -(-geo.nst // ks) * geo.HW
    run = lmax * 4 + lmax // 32 * 16 if f32 else lmax * 2
    pitch = _a128(geo.per * geo.R * run) + 16
    red = ns * geo.sb + _a128(nb * pitch)
    return _a128(red + 4 * 32 * 4 * 4 + 16) + 16 * ns


class WirePlan(NamedTuple):
    """A K10 launch at B <= 8: ks splits of the stages, ns ring slots, nbx
    blocks along the tiles (each takes every nbx-th tile), smem bytes a
    block, per_sm blocks an SM."""
    ks: int
    ns: int
    nbx: int
    smem: int
    per_sm: int


@functools.lru_cache(maxsize=None)
def pick_wire_gemv(K: int, bl: int, bh: int, superblock: bool, asym: str,
                   gs: int, tiles: int, nb: int, sms: int,
                   f32: bool = False) -> WirePlan:
    """Splits, ring and blocks of a K10 launch at B = nb <= 8 over `tiles`
    tiles of WIRE_ROWS rows, from its shapes and the card's SM count
    (_pick_persistent, as for K6): each block builds its split's f32 x
    columns (into bf16, or kept in f32) once."""
    geo = wire_geo(K, bl, bh, superblock, asym, gs)
    plan = _pick_persistent(geo.nst, tiles, 1, sms, geo.sb,
                            lambda ns, ks: wire_smem(geo, ns, ks, nb, f32),
                            lambda ks: nb * 4 * K // ks)
    if plan is None:
        raise ValueError(f"no K10 GEMV plan fits shared memory: K={K}, "
                         f"{nb} rows")
    return WirePlan(*plan)


#: K10 above 8 rows (csrc/qmm_wire_gemm.cu wire_gemm_kernel): weight rows
#: a block, K columns a stage, the token tile of f32 compute
WIRE_GEMM_ROWS = 128
_WG_KT = 64
_WG_F32_N = 64


def wire_gemm_tile(B: int, f32: bool) -> int:
    """The GEMM's token tile (wgmma's N) at B rows (csrc token_tile): 32,
    128 and 256 for B <= 32, <= 128 and above in bf16; 64 in f32."""
    if f32:
        return _WG_F32_N
    return 32 if B <= 32 else 128 if B <= 128 else 256


class WireGemmGeo(NamedTuple):
    """A family's stages in K10's GEMM (csrc/qmm_wire_gemm.cu gemm_geo):
    hw = 64/per high positions a stage (one low box r of R), nst = K/64
    stages, a run's record of nrec words; rtma: the scales come as npl TMA
    boxes a run ([128][16 bytes] each) where every scale plane's row pitch
    allows, else as records; sb bytes a ring slot (the x tile, the low and
    high boxes of 128 rows, the scales, each 1024-aligned)."""
    per: int
    Kp: int
    Kph: int
    R: int
    hw: int
    nst: int
    nrec: int
    rtma: bool
    npl: int
    sb: int


def _wire_tma_scales(K: int, gs: int, superblock: bool) -> bool:
    """Whether every scale plane's row pitch is whole 16-byte units, as
    TMA needs (csrc tma_scales): d and dmin f32 [K/256] (super-block) or
    [K/gs], sc and m uint8 [K/gs]."""
    if superblock:
        return K % 1024 == 0 and (K // gs) % 16 == 0
    return (K // gs) % 4 == 0


def wire_gemm_geo(K: int, bl: int, bh: int, superblock: bool, asym: str,
                  gs: int, N: int, f32: bool) -> WireGemmGeo:
    per = 8 // bl
    Kp = K // per
    Kph = K * bh // 8 if bh else Kp
    hw = _WG_KT // per
    _, _, nrec = _wire_record(hw, gs, superblock, asym)
    rtma = _wire_tma_scales(K, gs, superblock)
    npl = (2 if superblock else 1) * (2 if asym != "none" else 1)
    lo = N * _WG_KT * (8 if f32 else 2)
    rec = lo + WIRE_GEMM_ROWS * hw * (2 if bh else 1)
    scales = (per * npl * WIRE_GEMM_ROWS * 16 if rtma
              else WIRE_GEMM_ROWS * per * nrec * 4)
    sb = -(-(rec + scales) // 1024) * 1024
    return WireGemmGeo(per, Kp, Kph, Kp // Kph, hw, K // _WG_KT, nrec, rtma,
                       npl, sb)


def wire_gemm_smem(geo: WireGemmGeo, ns: int) -> int:
    """Shared memory of a GEMM block (csrc gemm_smem): alignment slack, ns
    ring slots, mbarriers and flag."""
    return 1024 + ns * geo.sb + 16 * ns + 16


class WireGemmPlan(NamedTuple):
    """A K10 launch above 8 rows: N tokens a tile, ks splits of the
    stages, ns ring slots, smem bytes a block, tiles (row tiles x token
    tiles)."""
    N: int
    ks: int
    ns: int
    smem: int
    tiles: int


@functools.lru_cache(maxsize=None)
def pick_wire_gemm(K: int, bl: int, bh: int, superblock: bool, asym: str,
                   gs: int, n_pad: int, B: int, sms: int,
                   f32: bool = False) -> WireGemmPlan:
    """Token tile, K splits and ring of a K10 GEMM launch (B > 8) from its
    shapes and the card's SM count: splits (whole stages, at least 8 a
    split, at most 8 splits) where the tiles alone leave SMs idle, taken
    only where they cut the waves of blocks by at least 15% (as K3's and
    K6's GEMMs take theirs: the 8B's 4096-row wq and down give 32 row tiles
    a token tile); then the deepest ring, up to 8 stages or the split's,
    that fits a block's shared memory."""
    N = wire_gemm_tile(B, f32)
    geo = wire_gemm_geo(K, bl, bh, superblock, asym, gs, N, f32)
    tiles = -(-n_pad // WIRE_GEMM_ROWS) * -(-B // N)

    def waves(ks):
        return -(-tiles * ks // sms) / ks

    ks = 1
    for k in range(2, 9):
        if geo.nst // k >= 8 and waves(k) < 0.85 * waves(ks):
            ks = k
    ns = min(8, -(-geo.nst // ks))
    while ns > 1 and wire_gemm_smem(geo, ns) > SMEM_BLOCK:
        ns -= 1
    if wire_gemm_smem(geo, ns) > SMEM_BLOCK:
        raise ValueError(f"no K10 GEMM ring fits shared memory: K={K}, "
                         f"N={N}")
    return WireGemmPlan(N, ks, ns, wire_gemm_smem(geo, ns), tiles)


def qmm_wire(x, cfg, planes, K: int, compute_dtype=torch.bfloat16):
    """K10 on the card: x f32 [B, K] against the wire planes (q, qh, d, sc,
    dmin, m) of a QConfig, in the dtypes ops.qmatmul._wire_planes gives
    them -> [B, n_pad] f32, the products of x and w rounded to
    compute_dtype (bf16 or f32) summed in f32: the streaming GEMV at B <=
    8, the wgmma GEMM above."""
    q, qh, d, sc, dmin, m = planes
    fam = wire_family(cfg)
    _need(x, torch.float32, "x", 2)
    B = x.shape[0]
    n_pad = q.shape[0]
    gs = cfg.gs
    dg = K // 256 if cfg.superblock else K // gs
    want = {"q": (q, torch.int8 if cfg.signed else torch.uint8,
                  K * cfg.bits_lo // 8),
            "qh": (qh, torch.uint8, K * cfg.bits_hi // 8),
            "d": (d, torch.float32, dg),
            "sc": (sc, torch.int8, K // gs),
            "dmin": (dmin, torch.float32, K // 256),
            "m": (m, torch.float32 if cfg.asym == "min" else torch.uint8,
                  K // gs)}
    used = {"q": True, "qh": cfg.bits_hi > 0, "d": True,
            "sc": cfg.superblock, "dmin": cfg.asym == "minsb",
            "m": cfg.asym in ("min", "minsb")}
    for what, (t, dtype, cols) in want.items():
        if not used[what]:
            continue
        if t is None:
            raise ValueError(f"{cfg.qtype.name}: the {what} plane is missing")
        _need(t, dtype, what, 2)
        if t.shape != (n_pad, cols):
            raise ValueError(f"{what} {tuple(t.shape)}: expected "
                             f"[{n_pad}, {cols}]")
    if x.shape[1] != K or K % 256 or n_pad % 64 or B < 1:
        raise ValueError(f"x {tuple(x.shape)} vs K={K}, n_pad={n_pad}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute dtype {compute_dtype}")
    f32 = compute_dtype == torch.float32

    def p(what, t):
        return _ptr(t) if used[what] else None

    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    args = (fam, int(f32), _ptr(x), B, K, _ptr(q), p("qh", qh), _ptr(d),
            p("sc", sc), p("dmin", dmin), p("m", m), n_pad, gs,
            float(cfg.offset))
    out = torch.empty((B, n_pad), dtype=torch.float32, device=dev)
    if B <= WIRE_GEMV_ROWS:
        plan = pick_wire_gemv(K, cfg.bits_lo, cfg.bits_hi, cfg.superblock,
                              cfg.asym, gs, n_pad // WIRE_ROWS, B,
                              _sm_count(index), f32)
        counters = _gemv_counters(dev, n_pad // WIRE_ROWS)
        ws = (torch.empty((plan.ks, B, n_pad), dtype=torch.float32,
                          device=dev) if plan.ks > 1 else None)
        lib = _lib("qmm_wire")
        rc = lib.qmm_wire_gemv_run(*args, plan.ks, plan.ns, plan.nbx,
                                   _ptr(ws), _ptr(counters), _ptr(out),
                                   _stream(dev))
    else:
        plan = pick_wire_gemm(K, cfg.bits_lo, cfg.bits_hi, cfg.superblock,
                              cfg.asym, gs, n_pad, B, _sm_count(index), f32)
        counters = _gemv_counters(dev, plan.tiles)
        # x in the stages' order: bf16, or f32 TF32 big and small parts
        xp = (torch.empty((2, B, K), dtype=torch.float32, device=dev) if f32
              else torch.empty((B, K), dtype=torch.bfloat16, device=dev))
        ws = (torch.empty((plan.ks, B, n_pad), dtype=torch.float32,
                          device=dev) if plan.ks > 1 else None)
        lib = _lib("qmm_wire_gemm")
        rc = lib.qmm_wire_gemm_run(*args, plan.ks, plan.ns, _ptr(xp),
                                   _ptr(ws), _ptr(counters), _ptr(out),
                                   _stream(dev))
    _check(lib, rc, "qmm_wire")
    LAUNCHES["qmm_wire"] += 1
    return out


def flash_attn(q, k, v, mask, scale: float):
    """K11 on the card: q [B,H,T,D], k/v [B,H,S,D] (f32, or bf16 all
    three; D a multiple of 32 up to 128), mask additive, broadcastable to
    [B,H,T,S] (f32, read through its broadcast strides) -> f32
    [B,H,T,D]."""
    dtype = q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {dtype}: K11 takes f32 or bf16")
    for what, t in (("q", q), ("k", k), ("v", v)):
        _need(t, dtype, what, 4)
    B, H, T, D = q.shape
    S = k.shape[2]
    if k.shape != (B, H, S, D) or v.shape != k.shape or D % 32 or D > 128:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: D a multiple of 32 up to 128")
    if not mask.is_cuda or mask.device != q.device:
        raise ValueError("mask: expected a CUDA tensor on q's device")
    mf = mask.to(torch.float32).expand(B, H, T, S)
    out = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    lib = _lib("attention")
    rc = lib.flash_attn_run(_ptr(q), _ptr(k), _ptr(v), _ptr(mf), *mf.stride(),
                            B, H, T, S, D, float(scale),
                            int(dtype == torch.bfloat16), _ptr(out),
                            _stream(q.device))
    _check(lib, rc, "flash_attn")
    LAUNCHES["flash_attn"] += 1
    return out


def _pick_nsplit(rows: int, S: int, min_slots: int) -> int:
    """Flash-decoding slot splits from the shapes alone (K4: min_slots=32):
    enough blocks to cover the card twice, each split at least min_slots
    slots of the whole cache."""
    return max(1, min(-(-264 // rows), -(-S // min_slots)))


#: K12 (csrc/attention.cu decode_gqa_kernel): blocks a cluster at most (the
#: portable limit), cache slots a split at least
GQA_MAX_SPLITS = 8
GQA_MIN_SLOTS = 32


@functools.lru_cache(maxsize=None)
def pick_gqa_splits(B: int, Hkv: int, S: int, sms: int) -> int:
    """K12's slot splits, the blocks of one (row, KV head)'s cluster, from
    the shapes and the SM count alone (pos stays on the card): one wave of
    clusters on the card's SMs, at most GQA_MAX_SPLITS, each split at least
    GQA_MIN_SLOTS slots of the cache."""
    return max(1, min(GQA_MAX_SPLITS, sms // (B * Hkv), S // GQA_MIN_SLOTS))


def decode_attn_gqa(qg, k, v, pos, scale: float, swa: int = 0,
                    logit_cap: float = 0.0):
    """K12 on the card: qg [B,Hkv,G,1,128] (f32 or bf16), k/v
    [B,S,Hkv,128] bf16 or f32 (the cache layout), pos int32 [B] -> f32
    [B,Hkv,G,1,128]; row b attends slots idx <= pos[b] (and pos[b] - idx
    < swa when swa > 0)."""
    B, Hkv, G, T, D = qg.shape
    if D != 128 or T != 1 or not 1 <= G <= 8:
        raise ValueError(f"qg {tuple(qg.shape)}: K12 takes head_dim 128, "
                         "one token and up to 8 query heads a KV head")
    cdt = k.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"cache dtype {cdt}: K12 takes bf16 or f32")
    _need(k, cdt, "k", 4)
    _need(v, cdt, "v", 4)
    _need(pos, torch.int32, "pos", 1)
    S = k.shape[1]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or pos.shape[0] != B:
        raise ValueError(f"k {tuple(k.shape)} / pos {tuple(pos.shape)} vs "
                         f"qg {tuple(qg.shape)}")
    if not qg.is_cuda:
        raise ValueError(f"qg: expected a CUDA tensor, got {qg.device}")
    q32 = qg.to(torch.float32).contiguous()
    dev = qg.device
    nsplit = pick_gqa_splits(B, Hkv, S, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    out = torch.empty((B, Hkv, G, 1, D), dtype=torch.float32, device=dev)
    lib = _lib("attention")
    rc = lib.decode_attn_gqa_run(_ptr(q32), _ptr(k), _ptr(v), _ptr(pos), B,
                                 Hkv, G, S, nsplit, float(scale), int(swa),
                                 float(logit_cap),
                                 int(cdt == torch.bfloat16), _ptr(out),
                                 _stream(dev))
    _check(lib, rc, "decode_attn_gqa")
    LAUNCHES["decode_attn_gqa"] += 1
    return out
