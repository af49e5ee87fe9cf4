"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the main paths' shapes (Llama-3-8B Q4_K_M on both layouts and
IQ4_XS, Mixtral-8x7B Q5_K_M, IQ4_XS and Q4_K_M widths).

These need an NVIDIA card: they carry the `gpu` marker and skip without
one.  The repository's conftest imports JAX, which the card's machine does
not have, so run them there as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances, per kernel, with their reasons:
  K1/K2 (q8 GEMV): both sides quantize the activation the same way and
      sum exact integer group partials; they differ in the f32 order of
      the per-group scale sums and, in the normed/act prologues, in the
      last ulp of rsqrt/sigmoid, which can move an activation across an
      int8 rounding tie.  NMSE <= 1e-6.
  K3 (bf16 GEMM): identical bf16 products, f32 accumulation in another
      order (K split over blocks where the output tiles alone leave SMs
      idle); the group bias is the f32 group sums, split exactly into
      three bf16 parts, times fb, each product exact.  NMSE <= 1e-6.
  K4 (attention): f32 throughout, another order and expf (the live slots
      split over blocks, their partials merged): max|d| <= 1e-4.  Over a
      q4_0 cache (4-bit values packed two a byte) the int8 path's math on
      the sign-extended nibbles, the same bound; a CUDA-graph replay gives
      the eager launch's bits.
  pack_tensor on the card (the GGUF wire bytes unpacked by torch integer
      ops): byte-equal to the same call on the CPU.
  K5 (gathered-expert GEMV): K1's arithmetic on the selected lanes.
      NMSE <= 1e-6.
  K6 (interleaved byte planes), every mode: identical f32 (B <= 8) or
      bf16 (B > 8) products, f32 sums in another order; the normed and act
      prologues can differ in the last ulp of 1/sqrt and expf, which can
      move an activation across a bf16 rounding step.  NMSE <= 1e-6.
  K6 on nibble planes, and on byte planes with a group bias: the same;
      the bias is an f32 dot of the same group sums, in another order.
      NMSE <= 1e-6.
  K6 above 8 rows (the wgmma GEMM, every family): identical bf16(q*scale)
      products, f32 sums in another order (K split over blocks where the
      tiles leave SMs idle); the group bias is the f32 group sums, split
      exactly into three bf16 parts, times fb (or bf16(off*fs), exact),
      each product exact, folded into the same accumulators.  NMSE <= 1e-6.
  K7 (dual projection): K6's B <= 8 kernel over two plane sets, each
      part's arithmetic K6's.  NMSE <= 1e-6; on rows whose prologue rounds
      alike everywhere NMSE <= 1e-9 against the plain twin and against K6
      on each part alone, the configurations' pairs and ternary parts
      (padded to 8 groups) in either position, at 1, 4 and 8 rows.
  K8 (gathered experts on interleaved planes): K6's B <= 8 arithmetic on
      the selected rows.  NMSE <= 1e-6.
  The coded i-quants and ternary on both layouts (K1, K2, K3, K5 on
      t-planes; K6, K7, K8 on coded nibble planes): the codes decode to the
      same integers on both sides, so each kernel keeps its tolerance and
      counts its launches under its *_coded key.  NMSE <= 1e-6.
  K9 (the whole-FFN megakernel): K6's B <= 8 arithmetic in each phase
      (bf16 mma, byte weights as two exact bf16 parts, the group sums as
      three exact bf16 parts, split sums in split order); f32 sums in
      another order can move xb and xd across a bf16 rounding step, and
      1/sqrt and expf can differ in their last ulp.  NMSE <= 1e-6, at d =
      4096 and n_ff = 2048 (every down branch), 14336 (Q4_K, Q6_K and
      ternary downs) and 1536 (ternary, padded to 8 groups); repeated
      launches, a launch after a K6 call that split K, and a CUDA-graph
      replay give the same bits.
  K10 (wire-plane dequant x matmul): the same f32 weight from the same
      roundings, the same bf16 (or f32) operands, f32 sums in another
      order (at B <= 8 in bf16 the streaming GEMV: K split over blocks,
      the splits summed in split order by each tile's last block).
      NMSE <= 1e-6, at every family, at K = 256 and 11008 (the scale
      planes' 4-, 172- and 344-byte row pitches), 64 rows and the
      128256-row head, B = 1, 2, 8 and 9; repeated calls and a CUDA-graph
      replay give the same bits.  Above 8 rows the wgmma GEMM: the same
      bf16 products (f32: each f32 operand split into two TF32 parts,
      three products, about 2^-21 relative), f32 sums in another order and
      K split over blocks (the last block of a tile sums the splits in
      split order).  NMSE <= 1e-6 at every family, B = 9, 64, 512 and 513,
      on 192 rows (a ragged 64-row tile), and for all 21 types at B = 9
      and 512.  In f32 (the GEMV's fmaf products at B <= 8, the GEMM's
      three TF32 products above, their tensor-core sums added into f32
      registers every 8 chunks) NMSE <= 1e-10 at every family, B = 1, 8,
      9, 100 and 512 (at most 3.8e-12 measured on an H100), where a
      kernel of one or two TF32 products (NMSE 3.8e-8 or more) fails: the
      tests check that their controls do.
  K6 and K8 on ternary planes whose group count is not a multiple of 8
      (G = 4 at K = 1024, G = 43 at K = 11008): the wrapper pads the
      groups to 8*ceil(G/8) with zero codes at zero scale and x with zero
      columns (the normed mode's mean over the true K), so every product
      is K6's or K8's.  NMSE <= 1e-6, every mode, B = 1, 8 and 512.
  K11 (masked flash attention): f32 scores and output; q*scale, k, p and
      v split into two TF32 parts (bf16 k and v are exact in TF32), three
      products (two for bf16 inputs) summed in f32, so each score and
      output is an f32 result to about 2^-22 relative, in another order,
      with expf: max|d| <= 1e-4.  K12 (GQA cache attention): f32
      throughout, another order (a split's slots scored and summed in
      passes of up to 512, the cluster's splits merged in rank order) and
      expf, as K4: max|d| <= 1e-4, at S = 1024 and 8192.
  K1/K2/K5 on inputs whose prologue is exact in any implementation (rows
      of mean square 4 - eps, whose rsqrt is 0.5; gates of magnitude 20 or
      more, whose silu is the gate or quantizes to 0): the same int8
      activation on both sides, exact integer group partials, f32 sums of
      the scaled partials in another order.  NMSE <= 1e-9, every mode, at
      1, 3 and 8 rows, K splits that end on a ragged chunk count included;
      two launches on the same inputs give the same bits (the last block
      of a split tile sums the splits in split order).
  K6 at B <= 8 and K8 on such inputs in bf16 (normed: inv = 0.5 exactly;
      act: silu(g) = g or about 0): the same bf16 activation on both sides,
      every product exact (byte weights q*s as two exact bf16 parts),
      f32 sums in another order, the group sums split into three exact
      bf16 parts.  NMSE <= 1e-9, every family, bias kind and mode, at 1, 3
      and 8 rows, ragged K splits included; repeated launches give the same
      bits.
"""
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.llama import qtensor_rows
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.ops import attention as PA
from ggml_hexagon_tpu_torch.ops import decode_attn as PD
from ggml_hexagon_tpu_torch.ops import ffn_fused as PFF
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P
from ggml_hexagon_tpu_torch.ops import qmatmul as PQ
from ggml_hexagon_tpu_torch.quant.formats import GGMLType
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS

pytestmark = pytest.mark.gpu

NMSE_MAX = 1e-6
NMSE_EXACT = 1e-9  # K1/K2/K5 on inputs with an exact prologue
NMSE_F32 = 1e-10   # K10 in f32 (the f32 GEMV; the GEMM's TF32 x3)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    return torch.device("cuda")


_QT = {}


def _qt(dev, n, k, qtype, layout="t"):
    """Random planes of (n, k, qtype): t-planes where the type has them
    (layout "t"), or interleaved ones ("il")."""
    key = (n, k, qtype, layout)
    if key not in _QT:
        g = torch.Generator(device=dev)
        g.manual_seed(n * 7 + k + int(qtype))
        _QT[key] = random_qtensor(g, n, k, qtype, dev).with_fast_planes(
            layout).without_wire()
    return _QT[key]


def _nmse(got, want):
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).mean() / ((want ** 2).mean() + 1e-30))


def _x(dev, *shape, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


@pytest.mark.parametrize("shape", [(6144, 4096, GGMLType.Q4_K),
                                   (4096, 14336, GGMLType.Q6_K),
                                   (4096, 14336, GGMLType.Q4_K),
                                   (1000, 4096, GGMLType.Q6_K),
                                   (4096, 4096, GGMLType.Q5_K)],
                         ids=["wqkv", "down_q6k", "down_q4k", "head_like",
                              "wq_q5k"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mode", ["raw", "normed", "res", "act"])
def test_qp8_gemv_kernel_matches_plain(dev, shape, B, mode):
    n, k, qtype = shape
    qt = _qt(dev, n, k, qtype)
    x = _x(dev, B, 2 * k if mode == "act" else k, seed=B)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(k, device=dev) + 0.5, eps=1e-5)
    elif mode == "res":
        kw = dict(res=_x(dev, B, n, seed=9))
    elif mode == "act":
        kw = dict(act="silu", res=_x(dev, B, n, seed=9))
    before = kernels.LAUNCHES["qp8_gemv"]
    got = P.qp8_gemv(x, qt, **kw)
    want = P.qp8_gemv_plain(x, qt, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["qp8_gemv"] == before + 1
    assert got.shape == want.shape
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("B", [1, 4])
def test_qp8_dual_kernel_matches_plain(dev, B):
    a = _qt(dev, 5120, 4096, GGMLType.Q4_K)
    b = _qt(dev, 1024, 4096, GGMLType.Q6_K)
    x = _x(dev, B, 4096, seed=3)
    wn = torch.rand(4096, device=dev) + 0.5
    got = P.qp8_dual(x, a, b, wn=wn, eps=1e-5)
    want = P.qp8_dual_plain(x, a, b, wn=wn, eps=1e-5)
    torch.cuda.synchronize()
    assert got.shape == (B, 6144)
    assert _nmse(got, want) <= NMSE_MAX


#: K3's M cases: the 9-row edge of the prefill route, the 32- and
#: 128-token buckets (token tiles of 32 and 128), a ragged 200 and the
#: 512-token chunk (tiles of 256); 16 and 100 as before
_K3_M = [9, 16, 32, 100, 128, 200, 512]


# Every t-plane family of K3: Q4_K with a stored bias (fb), Q6_K with the
# offset bias (4+2 bits), Q5_K (4+1), Q4_0 (4 bits, offset), Q2_K (2 bits,
# fb) and Q3_K (2+1, offset).  Q8_0 has no t-planes (its weights take the
# interleaved byte planes, K6), so K3 never sees it.
@pytest.mark.parametrize("M", _K3_M)
@pytest.mark.parametrize("shape", [(1024, 4096, GGMLType.Q4_K),
                                   (512, 14336, GGMLType.Q6_K),
                                   (1024, 4096, GGMLType.Q5_K),
                                   (1024, 4096, GGMLType.Q4_0),
                                   (1024, 4096, GGMLType.Q2_K),
                                   (1024, 4096, GGMLType.Q3_K)],
                         ids=["q4k", "q6k", "q5k", "q4_0", "q2k", "q3k"])
def test_qp8_gemm_kernel_matches_plain(dev, M, shape):
    n, k, qtype = shape
    qt = _qt(dev, n, k, qtype)
    x = _x(dev, M, k, seed=M).to(torch.bfloat16)
    got = P.qp8_gemm(x, qt)
    want = P.qp8_gemm_plain(x, qt)
    torch.cuda.synchronize()
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("M", [100, 512])
def test_qp8_gemm_and_gemv_kernels_take_expert_lane_slices(dev, M):
    """K3 and K1 on one expert's lane slice of stacked planes (a view with
    the stack's row pitch), against the plain version on a copy."""
    stack = _qt(dev, 4 * 1024, 4096, GGMLType.Q5_K)
    e2 = qtensor_rows(stack, 2 * 1024, 1024)
    assert not e2.fq.is_contiguous()
    copy = type(e2)(e2.cfg, e2.n, e2.k, fq=e2.fq.contiguous(),
                    fs=e2.fs.contiguous(), fb=e2.fb.contiguous())
    x = _x(dev, M, 4096, seed=5).to(torch.bfloat16)
    assert _nmse(P.qp8_gemm(x, e2), P.qp8_gemm_plain(x, copy)) <= NMSE_MAX
    x1 = _x(dev, 2, 4096, seed=6)
    assert _nmse(P.qp8_gemv(x1, e2), P.qp8_gemv_plain(x1, copy)) <= NMSE_MAX


def test_qp8_gemm_kernel_on_the_head(dev):
    """K3 on the Llama-3-8B head (Q6_K, 128256 x 4096) at M = 512, the
    shape of a perplexity chunk under logits_all: one launch, against the
    plain twin, counted under the head's weight in kernels.GEMM_SHAPES."""
    qt = _qt(dev, 128256, 4096, GGMLType.Q6_K)
    x = _x(dev, 512, qt.k, seed=11).to(torch.bfloat16)
    kernels.reset_launches()
    _counted("qp8_gemm", lambda: P.qp8_gemm(x, qt),
             lambda: P.qp8_gemm_plain(x, qt))
    assert kernels.GEMM_SHAPES == {"128256x4096": 1}


_MOE = {"gate_q5k": (14336, 4096, GGMLType.Q5_K),
        "down_q5k": (4096, 14336, GGMLType.Q5_K),
        "down_q6k": (4096, 14336, GGMLType.Q6_K)}


@pytest.mark.parametrize("M", [32, 512])
def test_qp8_gemm_kernel_without_k_splits(dev, M):
    """A gate_up-wide K3 (224 lane tiles) fills the card without splitting
    K; the narrow shapes above split it (partials summed on the card)."""
    qt = _qt(dev, 28672, 4096, GGMLType.Q4_K)
    assert kernels._gemm_splits(M, qt.fq.shape[1], qt.k, dev) == 1
    assert kernels._gemm_splits(M, 1024, qt.k, dev) > 1
    x = _x(dev, M, qt.k, seed=M).to(torch.bfloat16)
    _counted("qp8_gemm", lambda: P.qp8_gemm(x, qt),
             lambda: P.qp8_gemm_plain(x, qt))


@pytest.mark.parametrize("stack", list(_MOE))
@pytest.mark.parametrize("ids", [[5, 2], [3, 3], list(range(8)) * 2],
                         ids=["P2", "P2_dup", "P16"])
def test_qp8_indirect_kernel_matches_plain(dev, stack, ids):
    npe, k, qtype = _MOE[stack]
    qt = _qt(dev, 8 * npe, k, qtype)
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    x = _x(dev, ids.numel(), k, seed=ids.numel())
    before = kernels.LAUNCHES["qp8_indirect"]
    got = P.qp8_indirect(x, qt, ids, npe)
    want = P.qp8_indirect_plain(x, qt, ids, npe)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["qp8_indirect"] == before + 1
    assert got.shape == (ids.numel(), npe)
    assert _nmse(got, want) <= NMSE_MAX


def test_qp8_indirect_kernel_marks_bad_ids(dev):
    qt = _qt(dev, 8 * 4096, 14336, GGMLType.Q6_K)
    ids = torch.tensor([1, 8], dtype=torch.int32, device=dev)
    got = P.qp8_indirect(_x(dev, 2, 14336), qt, ids, 4096)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all() and torch.isnan(got[1]).all()


@pytest.mark.parametrize("n", [1024, 300])
@pytest.mark.parametrize("B", [1, 3, 8, 16, 128, 512])
def test_fast_byte_kernel_matches_plain(dev, n, B):
    g = torch.Generator(device=dev)
    g.manual_seed(n + B)
    qt = random_qtensor(g, n, 4096, GGMLType.Q8_0, dev).with_fast_planes()
    assert qt.fl == "il"
    x = _x(dev, B, 4096, seed=B).to(torch.bfloat16)
    before = kernels.LAUNCHES["fast_byte"]
    got = PF.fast_byte(x, qt)
    want = PF.fast_byte_plain(x, qt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_byte"] == before + 1
    assert got.shape == (B, qt.fq.shape[0])
    assert _nmse(got, want) <= NMSE_MAX


_IL = {"wqk_iq4xs": (5120, 4096, GGMLType.IQ4_XS),
       "wo_iq4xs": (4096, 4096, GGMLType.IQ4_XS),
       "down_iq4xs": (4096, 14336, GGMLType.IQ4_XS),
       "wk_q8_0": (1024, 4096, GGMLType.Q8_0)}


def _il(dev, name):
    n, k, qtype = _IL[name]
    qt = _qt(dev, n, k, qtype)
    assert qt.fl == "il"
    return qt


@pytest.mark.parametrize("name", ["wqk_iq4xs", "wk_q8_0"])
@pytest.mark.parametrize("B", [1, 3, 8, 128, 512])
def test_fast_byte_normed_kernel_matches_plain(dev, name, B):
    qt = _il(dev, name)
    x = _x(dev, B, qt.k, seed=B).to(torch.bfloat16)
    wn = torch.rand(qt.k, device=dev) + 0.5
    before = kernels.LAUNCHES["fast_byte_normed"]
    got = PF.fast_byte(x, qt, wn=wn, eps=1e-5)
    want = PF.fast_byte_plain(x, qt, wn=wn, eps=1e-5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_byte_normed"] == before + 1
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("name", ["wo_iq4xs", "wk_q8_0"])
@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("pre_il", [False, True], ids=["natural", "pre_il"])
def test_fast_byte_res_kernel_matches_plain(dev, name, B, pre_il):
    qt = _il(dev, name)
    x = _x(dev, B, qt.k, seed=B).to(torch.bfloat16)
    res = _x(dev, B, qt.n, seed=9)
    before = kernels.LAUNCHES["fast_byte_res"]
    got = PF.fast_byte(x, qt, res=res, pre_il=pre_il)
    want = PF.fast_byte_plain(x, qt, res=res, pre_il=pre_il)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_byte_res"] == before + 1
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("name", ["down_iq4xs", "wo_iq4xs"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("with_res", [False, True], ids=["", "res"])
def test_fast_byte_act_kernel_matches_plain(dev, name, B, with_res):
    qt = _il(dev, name)
    x = (_x(dev, B, 2 * qt.k, seed=B) * 2).to(torch.bfloat16)
    res = _x(dev, B, qt.n, seed=9) if with_res else None
    before = kernels.LAUNCHES["fast_byte_act"]
    got = PF.fast_byte(x, qt, act="silu", res=res)
    want = PF.fast_byte_plain(x, qt, act="silu", res=res)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_byte_act"] == before + 1
    assert _nmse(got, want) <= NMSE_MAX


_IL_MOE = {"gate_iq4xs": (14336, 4096, GGMLType.IQ4_XS),
           "down_iq4xs": (4096, 14336, GGMLType.IQ4_XS),
           "gate_q8_0": (14336, 4096, GGMLType.Q8_0)}


@pytest.mark.parametrize("stack", list(_IL_MOE))
@pytest.mark.parametrize("ids", [[5, 2], [3, 3], list(range(8)) * 2],
                         ids=["P2", "P2_dup", "P16"])
def test_fast_indirect_kernel_matches_plain(dev, stack, ids):
    npe, k, qtype = _IL_MOE[stack]
    qt = _qt(dev, 8 * npe, k, qtype)
    assert qt.fl == "il" and PF.supports_indirect(qt, npe)
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    x = _x(dev, ids.numel(), k, seed=ids.numel()).to(torch.bfloat16)
    before = kernels.LAUNCHES["fast_indirect"]
    got = PF.fast_indirect(x, qt, ids, npe)
    want = PF.fast_indirect_plain(x, qt, ids, npe)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_indirect"] == before + 1
    assert got.shape == (ids.numel(), npe)
    assert _nmse(got, want) <= NMSE_MAX


def test_fast_indirect_kernel_marks_bad_ids(dev):
    qt = _qt(dev, 8 * 4096, 14336, GGMLType.IQ4_XS)
    ids = torch.tensor([1, 8, -1], dtype=torch.int32, device=dev)
    x = _x(dev, 3, 14336).to(torch.bfloat16)
    got = PF.fast_indirect(x, qt, ids, 4096)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all()
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()


_NIB = {"wqkv_q4k": (6144, 4096, GGMLType.Q4_K),
        "wo_q4k": (4096, 4096, GGMLType.Q4_K),
        "down_q4k": (4096, 14336, GGMLType.Q4_K),
        "wq_q4_0": (1024, 4096, GGMLType.Q4_0),
        "down_q6k": (4096, 14336, GGMLType.Q6_K),
        "head_q6k": (1000, 4096, GGMLType.Q6_K),
        "wo_q5k": (4096, 4096, GGMLType.Q5_K)}


def _il_qt(dev, name):
    n, k, qtype = _NIB[name]
    qt = _qt(dev, n, k, qtype, "il")
    assert qt.fl == "il"
    return qt


def _k6_case(dev, name, mode, B, with_res=False, force_xg=False):
    """One K6 call on interleaved planes of either family: kernel against
    plain version, launch counted under its family and mode."""
    qt = _il_qt(dev, name)
    nib = PF._is_nibble(qt.cfg)
    fam = "fast_nibble" if nib else "fast_byte"
    x = _x(dev, B, 2 * qt.k if mode == "act" else qt.k, seed=B)
    x = (x * (2 if mode == "act" else 1)).to(torch.bfloat16)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(qt.k, device=dev) + 0.5, eps=1e-5)
    elif mode == "pre_il":
        kw = dict(pre_il=True)
    elif mode == "act":
        kw = dict(act="silu")
    if with_res:
        kw["res"] = _x(dev, B, qt.n, seed=9)
    _, nkj = PF._pick_blocks(PF._padded_rows(B), qt.k, nib, qt.cfg.gs)
    xg = PF.group_sums(qt, x, mode, kw.get("wn"), nkj)
    if force_xg and xg is None:  # the side-input route at an aligned G
        G = qt.fs.shape[1]
        xg = PF._sums_il(PF._interleave_x(x, G, qt.cfg.gs).float() * kw["wn"],
                         G)
    key = fam + {"normed": "_normed", "act": "_act"}.get(
        mode, "_res" if with_res else "")
    wrapper = PF.fast_nibble if nib else PF.fast_byte
    plain = PF.fast_nibble_plain if nib else PF.fast_byte_plain
    before = kernels.LAUNCHES[key]
    got = wrapper(x, qt, xg=xg, **kw)
    want = plain(x, qt, xg=xg, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == (B, qt.fq.shape[0])
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("name", ["wqkv_q4k", "down_q4k", "wq_q4_0",
                                  "down_q6k", "head_q6k", "wo_q5k"])
@pytest.mark.parametrize("B", [1, 3, 8, 16, 128, 512])
@pytest.mark.parametrize("mode", ["plain", "pre_il"])
def test_fast_il_plain_kernel_matches_plain(dev, name, B, mode):
    """K6's plain mode on nibble planes and on byte planes with a bias."""
    _k6_case(dev, name, mode, B)


@pytest.mark.parametrize("name", ["wqkv_q4k", "wo_q5k"])
@pytest.mark.parametrize("B", [1, 3, 8, 128, 512])
@pytest.mark.parametrize("side", [False, True], ids=["in_kernel", "side"])
def test_fast_il_normed_kernel_matches_plain(dev, name, B, side):
    """The normed mode with the group sums taken in the kernel, or handed
    in pre-norm (rescaled by the kernel's rsqrt factor)."""
    _k6_case(dev, name, "normed", B, force_xg=side)


@pytest.mark.parametrize("name", ["wo_q4k", "wo_q5k"])
@pytest.mark.parametrize("B", [1, 3, 8, 16])
def test_fast_il_res_kernel_matches_plain(dev, name, B):
    _k6_case(dev, name, "plain", B, with_res=True)


@pytest.mark.parametrize("name", ["down_q4k", "down_q6k"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("with_res", [False, True], ids=["", "res"])
def test_fast_il_act_kernel_matches_plain(dev, name, B, with_res):
    _k6_case(dev, name, "act", B, with_res=with_res)


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("normed", [True, False], ids=["normed", "raw"])
def test_fast_dual_kernel_matches_plain(dev, B, normed):
    """K7 on the 8B pair: Q4_K wqk (nibble, stored bias) + Q6_K wv (byte,
    derived bias)."""
    a = _qt(dev, 5120, 4096, GGMLType.Q4_K, "il")
    b = _qt(dev, 1024, 4096, GGMLType.Q6_K, "il")
    assert PF.supports_dual(a, b)
    x = _x(dev, B, 4096, seed=B).to(torch.bfloat16)
    kw = {}
    if normed:
        kw = dict(wn_a=torch.rand(4096, device=dev) + 0.5,
                  wn_b=torch.rand(4096, device=dev) + 0.5, eps=1e-5)
    before = kernels.LAUNCHES["fast_dual"]
    got = PF.fast_dual(x, a, b, **kw)
    want = PF.fast_dual_plain(x, a, b, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_dual"] == before + 1
    assert got.shape == (B, 6144)
    assert _nmse(got, want) <= NMSE_MAX


_IL_MOE_BIAS = {"gate_q4k": (14336, 4096, GGMLType.Q4_K),
                "down_q4k": (4096, 14336, GGMLType.Q4_K),
                "down_q6k": (4096, 14336, GGMLType.Q6_K)}


@pytest.mark.parametrize("stack", list(_IL_MOE_BIAS))
@pytest.mark.parametrize("ids", [[5, 2], [3, 3], list(range(8)) * 2],
                         ids=["P2", "P2_dup", "P16"])
def test_fast_indirect_bias_kernel_matches_plain(dev, stack, ids):
    """K8 on nibble stacks and on byte stacks with a derived bias."""
    npe, k, qtype = _IL_MOE_BIAS[stack]
    qt = _qt(dev, 8 * npe, k, qtype, "il")
    assert qt.fl == "il" and PF.supports_indirect(qt, npe)
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    x = _x(dev, ids.numel(), k, seed=ids.numel()).to(torch.bfloat16)
    xg = PF._sums_natural(x, qt.fs.shape[1])
    key = "fast_indirect_nibble" if PF._is_nibble(qt.cfg) else "fast_indirect"
    before = kernels.LAUNCHES[key]
    got = PF.fast_indirect(x, qt, ids, npe, xg=xg)
    want = PF.fast_indirect_plain(x, qt, ids, npe, xg=xg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert _nmse(got, want) <= NMSE_MAX


#: coded shapes of the IQ3_XXS configurations, and one of each other code map
_CODED = {"wqk_iq2s": (5120, 4096, GGMLType.IQ2_S),
          "wo_iq3s": (4096, 4096, GGMLType.IQ3_S),
          "down_iq3xxs": (4096, 14336, GGMLType.IQ3_XXS),
          "gu_iq3xxs": (4096, 4096, GGMLType.IQ3_XXS),
          "iq1s": (1024, 4096, GGMLType.IQ1_S),
          "iq1m": (1024, 4096, GGMLType.IQ1_M),
          "tq2": (1024, 4096, GGMLType.TQ2_0)}


def _coded(dev, name, layout):
    n, k, qtype = _CODED[name]
    qt = _qt(dev, n, k, qtype, layout)
    assert qt.fl == layout and qt.cfg.code_map
    return qt


def _counted(key, fn, plain):
    """fn() against plain(), with one launch counted under key."""
    before = kernels.LAUNCHES[key]
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("name", list(_CODED))
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mode", ["raw", "normed", "res", "act"])
def test_qp8_gemv_coded_kernel_matches_plain(dev, name, B, mode):
    qt = _coded(dev, name, "t")
    x = _x(dev, B, 2 * qt.k if mode == "act" else qt.k, seed=B)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(qt.k, device=dev) + 0.5, eps=1e-5)
    elif mode in ("res", "act"):
        kw = dict(res=_x(dev, B, qt.n, seed=9))
        if mode == "act":
            kw["act"] = "silu"
    _counted("qp8_gemv_coded", lambda: P.qp8_gemv(x, qt, **kw),
             lambda: P.qp8_gemv_plain(x, qt, **kw))


@pytest.mark.parametrize("B", [1, 4, 8])
def test_qp8_dual_coded_kernel_matches_plain(dev, B):
    """K2 on the 8B IQ3_XXS pair: IQ2_S wqk (coded) + Q4_K wv."""
    a = _coded(dev, "wqk_iq2s", "t")
    b = _qt(dev, 1024, 4096, GGMLType.Q4_K)
    x = _x(dev, B, 4096, seed=3)
    wn = torch.rand(4096, device=dev) + 0.5
    _counted("qp8_dual_coded", lambda: P.qp8_dual(x, a, b, wn=wn, eps=1e-5),
             lambda: P.qp8_dual_plain(x, a, b, wn=wn, eps=1e-5))


@pytest.mark.parametrize("name", list(_CODED))
@pytest.mark.parametrize("M", _K3_M)
def test_qp8_gemm_coded_kernel_matches_plain(dev, name, M):
    qt = _coded(dev, name, "t")
    x = _x(dev, M, qt.k, seed=M).to(torch.bfloat16)
    _counted("qp8_gemm_coded", lambda: P.qp8_gemm(x, qt),
             lambda: P.qp8_gemm_plain(x, qt))


_CODED_MOE = {"gate_iq3xxs": (2048, 4096, GGMLType.IQ3_XXS),
              "down_iq3xxs": (4096, 14336, GGMLType.IQ3_XXS)}


@pytest.mark.parametrize("stack", list(_CODED_MOE))
@pytest.mark.parametrize("layout", ["t", "il"])
@pytest.mark.parametrize("ids", [[5, 2], [3, 3], list(range(8)) * 2],
                         ids=["P2", "P2_dup", "P16"])
def test_indirect_coded_kernels_match_plain(dev, stack, layout, ids):
    """K5 (t-stacks) and K8 (coded nibble stacks) on IQ3_XXS experts."""
    npe, k, qtype = _CODED_MOE[stack]
    qt = _qt(dev, 8 * npe, k, qtype, layout)
    assert qt.fl == layout and PF.supports_indirect(qt, npe)
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    x = _x(dev, ids.numel(), k, seed=ids.numel())
    if layout == "t":
        _counted("qp8_indirect_coded", lambda: P.qp8_indirect(x, qt, ids, npe),
                 lambda: P.qp8_indirect_plain(x, qt, ids, npe))
    else:
        xb = x.to(torch.bfloat16)
        _counted("fast_indirect_coded",
                 lambda: PF.fast_indirect(xb, qt, ids, npe),
                 lambda: PF.fast_indirect_plain(xb, qt, ids, npe))


@pytest.mark.parametrize("name", list(_CODED))
@pytest.mark.parametrize("mode,B", [("plain", b) for b in (1, 3, 8, 16, 128, 512)]
                         + [("pre_il", 8), ("pre_il", 128), ("res", 1),
                            ("res", 8), ("act", 1), ("act", 8)]
                         + [("normed", b) for b in (1, 3, 8, 128, 512)],
                         ids=lambda c: str(c))
def test_fast_coded_kernel_matches_plain(dev, name, mode, B):
    """K6 on coded nibble planes, every mode, GEMV and GEMM."""
    qt = _coded(dev, name, "il")
    x = _x(dev, B, 2 * qt.k if mode == "act" else qt.k, seed=B)
    x = (x * (2 if mode == "act" else 1)).to(torch.bfloat16)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(qt.k, device=dev) + 0.5, eps=1e-5)
    elif mode == "pre_il":
        kw = dict(pre_il=True)
    elif mode in ("res", "act"):
        kw = dict(res=_x(dev, B, qt.n, seed=9))
        if mode == "act":
            kw["act"] = "silu"
    key = "fast_coded" + {"normed": "_normed", "act": "_act",
                          "res": "_res"}.get(mode, "")
    _counted(key, lambda: PF.fast_coded(x, qt, **kw),
             lambda: PF.fast_coded_plain(x, qt, **kw))


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("normed", [True, False], ids=["normed", "raw"])
def test_fast_dual_coded_kernel_matches_plain(dev, B, normed):
    """K7 on the 8B IQ3_XXS il pair: IQ2_S wqk (coded, G = 256) + Q4_K wv
    (nibble, stored bias, taken in the kernel): the family of one part
    must not reach the other."""
    a = _coded(dev, "wqk_iq2s", "il")
    b = _qt(dev, 1024, 4096, GGMLType.Q4_K, "il")
    assert PF.supports_dual(a, b)
    x = _x(dev, B, 4096, seed=B).to(torch.bfloat16)
    kw = {}
    if normed:
        kw = dict(wn_a=torch.rand(4096, device=dev) + 0.5,
                  wn_b=torch.rand(4096, device=dev) + 0.5, eps=1e-5)
    _counted("fast_dual_coded", lambda: PF.fast_dual(x, a, b, **kw),
             lambda: PF.fast_dual_plain(x, a, b, **kw))


#: K4's positions at S=1024: empty and one-slot caches, both sides of the
#: split boundaries (B=1: 32 splits, so 32 and 33; B=4: 9 splits, 288 and
#: 289), several tiles of 32 in a split (700), and the last slot
_K4_POS = [0, 1, 2, 31, 32, 33, 288, 289, 700, 1023]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos", _K4_POS)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("swa,cap", [(0, 0.0), (100, 2.0)],
                         ids=["plain", "swa_cap"])
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (8, 8), (32, 4)],
                         ids=["G4", "G1", "G8"])
def test_decode_attn_kernel_matches_plain(dev, quant, pos, B, swa, cap, Hq,
                                          Hkv):
    D, S = 128, 1024
    qkv = _x(dev, B, (Hq + 2 * Hkv) * D, seed=pos)
    if quant:
        kc = torch.randint(-127, 128, (B, S, Hkv * D), device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, (B, S, Hkv * D), device=dev,
                           dtype=torch.int8)
        ks = torch.rand(B, S, device=dev) * 0.02
        vs = torch.rand(B, S, device=dev) * 0.02
    else:
        kc = _x(dev, B, S, Hkv * D, seed=1).to(torch.bfloat16)
        vc = _x(dev, B, S, Hkv * D, seed=2).to(torch.bfloat16)
        ks = vs = None
    # rows at different positions (B=4: below, at half, past pos)
    rows = [pos, max(0, pos - 3), pos // 2, min(S - 1, pos + 5)][:B]
    posb = torch.tensor(rows, dtype=torch.int32, device=dev)
    inv = 500000.0 ** (-torch.arange(0, D, 2, device=dev).float() / D)
    ang = posb[:, None].float() * inv[None]
    cs = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).contiguous()
    kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5, k_scale=ks, v_scale=vs,
              swa=swa, logit_cap=cap)
    before = kernels.LAUNCHES["decode_attn"]
    got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
    want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attn"] == before + 1
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4


def test_decode_attn_splits_cover_the_card(dev):
    """At B=1 on the 8B's 8 KV heads and a 1024-slot cache, K4 launches at
    least one block an SM (flash-decoding over the live slots)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 8 * kernels._pick_nsplit(8, 1024, min_slots=32) >= sms


_K9_DOWN = {"q4k": GGMLType.Q4_K, "q6k": GGMLType.Q6_K, "q5k": GGMLType.Q5_K,
            "q4_0": GGMLType.Q4_0, "iq3xxs": GGMLType.IQ3_XXS}


def _k9_layer(dev, d, n_ff, down):
    """wo, gate_up and down planes in the megakernel layout: wo's and
    down's rows permuted to the il32 order, gate_up's rows in down's
    interleaved column order (models/fuse.attach_ffn_fused_layout)."""
    perm = PF.interleave_perm(d, 32)
    wo = _qt(dev, d, d, GGMLType.Q4_K, "il").take_rows(perm)
    dn = _qt(dev, d, n_ff, down, "il")
    pc = PF.interleave_perm(n_ff, dn.cfg.gs).to(dev)
    gu = _qt(dev, 2 * n_ff, d, GGMLType.Q4_K, "il").take_rows(
        torch.cat([pc, n_ff + pc]))
    dn = dn.take_rows(perm)
    assert PFF.supports_ffn_fused(wo, gu, dn, d, n_ff)
    return wo, gu, dn


def _k9_matches_plain(dev, d, n_ff, down, B):
    wo, gu, dn = _k9_layer(dev, d, n_ff, down)
    wn = torch.rand(d, device=dev) + 0.5
    attn, h = _x(dev, B, d, seed=B), _x(dev, B, d, seed=B + 1)
    key = "ffn_fused_" + PF._family(dn.cfg)
    before = kernels.LAUNCHES[key]
    got = PFF.ffn_fused(attn, h, wo, gu, dn, wn, 1e-5, out_dtype=torch.float32)
    want = PFF.ffn_fused(attn, h, wo, gu, dn, wn, 1e-5, out_dtype=torch.float32,
                         plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == (B, d) and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("down", list(_K9_DOWN))
@pytest.mark.parametrize("B", [1, 3, 8])
def test_ffn_fused_kernel_matches_plain(dev, down, B):
    """K9 at d = 4096, n_ff = 2048 on each down branch: the wrapper's
    kernel against its plain version, one launch under the down family's
    key."""
    _k9_matches_plain(dev, 4096, 2048, _K9_DOWN[down], B)


@pytest.mark.parametrize("down", ["q4k", "q6k"])
@pytest.mark.parametrize("B", [1, 8])
def test_ffn_fused_full_width_matches_plain(dev, down, B):
    """K9 at the Llama-3-8B widths (d = 4096, n_ff = 14336: phases A and C
    split K, the Q4_K down's last residue block ragged, 448 = 3 x 128 +
    64 groups) on the two down types of the 8B Q4_K_M layers."""
    _k9_matches_plain(dev, 4096, 14336, _K9_DOWN[down], B)


@pytest.mark.parametrize("n_ff", [1536, 2048, 14336])
@pytest.mark.parametrize("B", [1, 3])
def test_ffn_fused_ternary_down_matches_plain(dev, n_ff, B):
    """K9 on a ternary down (TQ2_0, 256 columns a group): G = 6 groups at
    n_ff = 1536 (padded to 8, kernels.padded_il_planes), 8 at 2048 and 56
    at 14336 (G % 16 == 8: the producer warp copies the weights)."""
    _k9_matches_plain(dev, 4096, n_ff, GGMLType.TQ2_0, B)


def _k9_args(dev, down=GGMLType.Q4_K, B=1, n_ff=14336):
    """kernels.ffn_fused's arguments at the 8B widths (d = 4096)."""
    d = 4096
    wo, gu, dn = _k9_layer(dev, d, n_ff, down)
    attn = _x(dev, B, d, seed=7).to(torch.bfloat16).float()
    h = _x(dev, B, d, seed=8)
    G, gs = wo.fs.shape[1], wo.cfg.gs
    x_a = PF._interleave_x(attn, G, gs).to(torch.bfloat16).contiguous()
    xg_a = PF._sums_natural(attn, G).contiguous()
    h_il = PF._interleave_x(h, G, gs).contiguous()
    wn = torch.rand(d, device=dev) + 0.5
    return (x_a, xg_a, h_il, wn, wo, gu, dn, 1e-5)


@pytest.mark.parametrize("B", [1, 8])
def test_ffn_fused_repeats_bits(dev, B):
    """K9 is deterministic and leaves its counters as it found them: two
    launches back to back (no host step between them), a third right
    after a K6 call whose plan splits K (it uses the same tile counters)
    give the same bits, and equal the plain version within NMSE_MAX."""
    args = _k9_args(dev, B=B)
    first = kernels.ffn_fused(*args)
    second = kernels.ffn_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    qt = _qt(dev, 4096, 14336, GGMLType.Q4_K, "il")
    x = _x(dev, 1, 14336, seed=3).to(torch.bfloat16)
    assert kernels._il_plan(qt, 1, 4096 // kernels.IL_ROWS, 1, 0, dev).ks > 1
    kernels.fast_nibble(x, qt, xg=PF.group_sums(qt, x, "plain"))
    third = kernels.ffn_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, third)
    assert _nmse(first, PFF.ffn_fused_plain(*args)) <= NMSE_MAX


@pytest.mark.parametrize("down", ["q4k", "q6k"])
def test_ffn_fused_graph_replay_matches_eager(dev, down):
    """A CUDA graph holding one K9 launch, replayed three times, gives the
    eager launch's bits each time (the counters reset on the card)."""
    args = _k9_args(dev, _K9_DOWN[down])
    want = kernels.ffn_fused(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.ffn_fused(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.ffn_fused(*args)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


#: one type of each K10 plane family, and two expanded (signed) types
_K10_TYPES = [GGMLType.Q8_0, GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.Q4_0,
              GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q2_K,
              GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
              GGMLType.IQ2_XS, GGMLType.TQ1_0]
_WIRE = {}


def _wire(dev, n, k, qtype):
    key = (n, k, qtype)
    if key not in _WIRE:
        g = torch.Generator(device=dev)
        g.manual_seed(n + k + int(qtype))
        _WIRE[key] = random_qtensor(g, n, k, qtype, dev)
    return _WIRE[key]


@pytest.mark.parametrize("B", [1, 3, 8, 512])
@pytest.mark.parametrize("qtype", _K10_TYPES, ids=lambda t: t.name)
def test_qmm_wire_kernel_matches_plain(dev, qtype, B):
    """K10 through qmatmul(backend="pallas") at 1000 x 4096 (rows padded
    to 1024): one launch, the plain twin's result."""
    qt = _wire(dev, 1000, 4096, qtype)
    x = _x(dev, B, 4096, seed=B)
    before = kernels.LAUNCHES["qmm_wire"]
    got = PQ.qmatmul(x, qt, backend="pallas")
    want = PQ.qmatmul_pallas(x, qt, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["qmm_wire"] == before + 1
    assert got.shape == (B, 1000) and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("B", [1, 8, 100])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K,
                                   GGMLType.Q5_1, GGMLType.IQ3_XXS],
                         ids=lambda t: t.name)
def test_qmm_wire_kernel_f32_matches_plain(dev, qtype, B):
    qt = _wire(dev, 1000, 4096, qtype)
    x = _x(dev, B, 4096, seed=B)
    got = PQ.qmatmul_pallas(x, qt, compute_dtype=torch.float32)
    want = PQ.qmatmul_pallas(x, qt, compute_dtype=torch.float32, plain=True)
    torch.cuda.synchronize()
    assert _nmse(got, want) <= NMSE_F32


def _tf32(v):
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero."""
    b = v.contiguous().view(torch.int32)
    r = torch.where((b & 0x7F800000) == 0x7F800000, b, (b + 0x1000) & ~0x1FFF)
    return r.view(torch.float32)


def _tf32_controls(x, qt, want):
    """NMSE against want of x . w with one TF32 product, rna(x) . rna(w),
    and with two, adding rna(x) . rna(w - rna(w)): what a K10 f32 kernel
    that kept fewer than three products would give."""
    w = PQ._dequant_expr(qt, torch.float32)[:want.shape[-1]]
    xb, wb = _tf32(x), _tf32(w)
    one = xb @ wb.t()
    return _nmse(one, want), _nmse(one + xb @ _tf32(w - wb).t(), want)


def _wire_rows(qt, rows):
    """qt's wire planes cut to their first `rows` rows (a multiple of 64:
    a ragged last tile of K10's 128-row GEMM blocks)."""
    import dataclasses

    def cut(t):
        return None if t is None else t[:rows].contiguous()

    return dataclasses.replace(qt, n=rows, q=cut(qt.q), qh=cut(qt.qh),
                               d=cut(qt.d), sc=cut(qt.sc), dmin=cut(qt.dmin),
                               m=cut(qt.m))


@pytest.mark.parametrize("B", [9, 64, 512, 513])
@pytest.mark.parametrize("qtype", _K10_TYPES[:12], ids=lambda t: t.name)
def test_qmm_wire_gemm_kernel_matches_plain(dev, qtype, B):
    """K10 above 8 rows (the wgmma GEMM) on every plane family at 1000 x
    4096 (1024 rows: 8 row tiles) and 192 x 11008 (a ragged 64-row tile;
    high planes of 1376 bytes), one launch a call."""
    for n, k in ((1000, 4096), (192, 11008)):
        qt = _wire(dev, n, k, qtype)
        if n == 192:
            qt = _wire_rows(qt, 192)
        x = _x(dev, B, k, seed=B + 5)
        before = kernels.LAUNCHES["qmm_wire"]
        got = PQ.qmatmul(x, qt, backend="pallas")
        want = PQ.qmatmul_pallas(x, qt, plain=True)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["qmm_wire"] == before + 1
        assert got.shape == (B, n) and torch.isfinite(got).all()
        assert _nmse(got, want) <= NMSE_MAX, (n, k)


@pytest.mark.parametrize("B", [9, 512])
@pytest.mark.parametrize("qtype", sorted(QCONFIGS, key=int), ids=lambda t: t.name)
def test_qmm_wire_kernel_every_type_above_eight_rows(dev, qtype, B):
    """All 21 wire types through the GEMM at 4096 x 4096, B = 9 and 512
    (chip_smoke.py holds them at B = 1 and 8)."""
    qt = _wire(dev, 4096, 4096, qtype)
    x = _x(dev, B, 4096, seed=B + 21)
    got = PQ.qmatmul(x, qt, backend="pallas")
    want = PQ.qmatmul_pallas(x, qt, plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("B", [1, 8, 9, 512])
@pytest.mark.parametrize("qtype", _K10_TYPES, ids=lambda t: t.name)
def test_qmm_wire_kernel_f32_every_family(dev, qtype, B):
    """K10 in f32: the f32 GEMV at B <= 8, the TF32-split GEMM above,
    within a limit that one or two TF32 products miss on the same
    inputs."""
    qt = _wire(dev, 1000, 4096, qtype)
    x = _x(dev, B, 4096, seed=B + 7)
    before = kernels.LAUNCHES["qmm_wire"]
    got = PQ.qmatmul_pallas(x, qt, compute_dtype=torch.float32)
    want = PQ.qmatmul_pallas(x, qt, compute_dtype=torch.float32, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["qmm_wire"] == before + 1
    assert torch.isfinite(got).all() and _nmse(got, want) <= NMSE_F32
    assert min(_tf32_controls(x, qt, want)) > NMSE_F32


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_qmm_wire_gemm_repeats_and_replays_bit_equal(dev, cd):
    """The 8B's wq at B = 512 splits K in two: two calls and a CUDA-graph
    replay give the same bits."""
    qt = _wire(dev, 4096, 4096, GGMLType.Q4_K)
    x = _x(dev, 512, 4096, seed=4)
    first = PQ.qmatmul_pallas(x, qt, compute_dtype=cd)
    second = PQ.qmatmul_pallas(x, qt, compute_dtype=cd)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PQ.qmatmul_pallas(x, qt, compute_dtype=cd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = PQ.qmatmul_pallas(x, qt, compute_dtype=cd)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)
    want = PQ.qmatmul_pallas(x, qt, compute_dtype=cd, plain=True)
    assert _nmse(first, want) <= (NMSE_F32 if cd == torch.float32
                                  else NMSE_MAX)


#: (mode, rows): every mode at decode rows, the prefill's modes at 512
_TERN_CASES = [(m, b) for b in (1, 8)
               for m in ("plain", "pre_il", "normed", "res", "act")] + [
    (m, 512) for m in ("plain", "pre_il", "normed")]


@pytest.mark.parametrize("mode,B", _TERN_CASES, ids=lambda c: str(c))
@pytest.mark.parametrize("shape", [(4096, 1024, GGMLType.TQ1_0),
                                   (4096, 11008, GGMLType.TQ2_0)],
                         ids=["tq1_g4", "tq2_g43"])
def test_fast_coded_kernel_on_ternary_groups_not_of_eight(dev, shape, mode, B):
    """K6 on ternary planes with G = 4 and G = 43, every mode (the residual
    and act modes at decode rows): the wrapper pads the groups to 8."""
    n, k, qtype = shape
    qt = _qt(dev, n, k, qtype, "il")
    assert qt.fl == "il" and qt.fs.shape[1] % 8
    x = _x(dev, B, 2 * k if mode == "act" else k, seed=B + 11)
    x = (x * (2 if mode == "act" else 1)).to(torch.bfloat16)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(k, device=dev) + 0.5, eps=1e-5)
    elif mode == "pre_il":
        kw = dict(pre_il=True)
    elif mode == "act":
        kw = dict(act="silu")
    if mode == "res":
        kw["res"] = _x(dev, B, n, seed=12)
    key = "fast_coded" + {"normed": "_normed", "act": "_act",
                          "res": "_res"}.get(mode, "")
    before = kernels.LAUNCHES[key]
    got = PF.fast_coded(x, qt, **kw)
    want = PF.fast_coded_plain(x, qt, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == (B, qt.fq.shape[0]) and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("ids", [[2, 0], list(range(4)) * 4], ids=["P2", "P16"])
@pytest.mark.parametrize("shape", [(1024, GGMLType.TQ1_0),
                                   (11008, GGMLType.TQ2_0)],
                         ids=["tq1_g4", "tq2_g43"])
def test_fast_indirect_kernel_on_ternary_groups_not_of_eight(dev, shape, ids):
    """K8 on stacked ternary planes with G = 4 and G = 43 (4 experts of
    512 rows)."""
    k, qtype = shape
    npe = 512
    qt = _qt(dev, 4 * npe, k, qtype, "il")
    assert qt.fs.shape[1] % 8
    x = _x(dev, len(ids), k, seed=13).to(torch.bfloat16)
    idt = torch.tensor(ids, dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["fast_indirect_coded"]
    got = PF.fast_indirect(x, qt, idt, npe)
    want = PF.fast_indirect_plain(x, qt, idt, npe)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_indirect_coded"] == before + 1
    assert torch.isfinite(got).all() and _nmse(got, want) <= NMSE_MAX


def _causal_mask(dev, T, S, dead):
    t = torch.arange(T, device=dev)[:, None]
    s = torch.arange(S, device=dev)[None, :]
    m = torch.where(s <= S - dead - T + t, 0.0, -1e30)
    m[:, S - dead:] = -1e30
    return m[None, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 4, 16, 512, 64), (1, 8, 100, 1024, 128)],
                         ids=["fixture", "ragged_t"])
def test_flash_attn_kernel_matches_plain(dev, dtype, shape):
    """K11 on a broadcast causal mask with a dead tail, and with one row
    whose slots are all masked (it averages v)."""
    B, H, T, S, D = shape
    q = _x(dev, B, H, T, D, seed=1).to(dtype)
    k = _x(dev, B, H, S, D, seed=2).to(dtype)
    v = _x(dev, B, H, S, D, seed=3).to(dtype)
    mask = _causal_mask(dev, T, S, 64)
    mask[..., 3, :] = -1e30
    before = kernels.LAUNCHES["flash_attn"]
    got = PA.flash_attention_pallas(q, k, v, mask, D ** -0.5, chunk=256)
    want = PA.flash_attention_pallas(q, k, v, mask, D ** -0.5, chunk=256,
                                     plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attn"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, H, T, D)
    assert float((got - want).abs().max()) <= 1e-4


#: one type of each K10 plane family (kernels._WIRE_FAMILIES)
_K10_FAMILIES = _K10_TYPES[:12]


@pytest.mark.parametrize("B", [1, 2, 8, 9])
@pytest.mark.parametrize("K", [256, 11008])
@pytest.mark.parametrize("qtype", _K10_FAMILIES, ids=lambda t: t.name)
def test_qmm_wire_kernel_at_the_edges_of_its_domain(dev, qtype, K, B):
    """K10 on 64 rows at K = 256 (d and dmin rows of 4 bytes, sc rows of
    8 or 16) and K = 11008 (172-byte d rows, 344-byte sc rows at gs = 32,
    high planes of 1376 bytes: 32-position stages), one launch a call;
    B = 9 is the first row count past the GEMV."""
    qt = _wire(dev, 64, K, qtype)
    x = _x(dev, B, K, seed=B + 1)
    before = kernels.LAUNCHES["qmm_wire"]
    got = PQ.qmatmul(x, qt, backend="pallas")
    want = PQ.qmatmul_pallas(x, qt, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["qmm_wire"] == before + 1
    assert got.shape == (B, 64) and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("B", [1, 8])
def test_qmm_wire_kernel_on_the_8b_head(dev, B):
    """The 128256-row Q6_K head: 2004 tiles, within the split counters."""
    qt = _wire(dev, 128256, 4096, GGMLType.Q6_K)
    x = _x(dev, B, 4096, seed=B + 2)
    before = kernels.LAUNCHES["qmm_wire"]
    got = PQ.qmatmul(x, qt, backend="pallas")
    want = PQ.qmatmul_pallas(x, qt, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["qmm_wire"] == before + 1
    assert torch.isfinite(got).all() and _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("shape", [(4096, 4096, GGMLType.Q4_K, 1),
                                   (4096, 14336, GGMLType.Q6_K, 8),
                                   (14336, 4096, GGMLType.Q5_K, 3)],
                         ids=["wq_b1", "down_b8", "gate_q5k_b3"])
def test_qmm_wire_kernel_repeats_and_replays_bit_equal(dev, shape):
    """Two calls and a CUDA-graph replay of the same call give the same
    bits: the split tiles' counters are left at zero and the splits are
    summed in split order."""
    n, k, qtype, B = shape
    qt = _wire(dev, n, k, qtype)
    x = _x(dev, B, k, seed=3)
    first = PQ.qmatmul(x, qt, backend="pallas")
    second = PQ.qmatmul(x, qt, backend="pallas")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PQ.qmatmul(x, qt, backend="pallas")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = PQ.qmatmul(x, qt, backend="pallas")
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)
    want = PQ.qmatmul_pallas(x, qt, plain=True)
    assert _nmse(first, want) <= NMSE_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["full", "broadcast"])
@pytest.mark.parametrize("S", [256, 1024])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_flash_attn_kernel_over_its_domain(dev, dtype, mask_kind, S, D):
    """K11 at T = 100 (a ragged last row block) over every head width, on
    a full [B,H,T,S] mask and a [1,1,T,S] broadcast one whose finite
    values are random (so no two slots of a row weigh alike: p has no
    symmetry for the accumulator-to-operand reuse to hide behind), a
    causal -1e30 part, a dead tail and one dead row (it averages v)."""
    B, H, T = 2, 3, 100
    q = _x(dev, B, H, T, D, seed=D + 1).to(dtype)
    k = _x(dev, B, H, S, D, seed=D + 2).to(dtype)
    v = _x(dev, B, H, S, D, seed=D + 3).to(dtype)
    lead = (B, H) if mask_kind == "full" else (1, 1)
    mask = 2.0 * _x(dev, *lead, T, S, seed=S + D)
    mask = mask + _causal_mask(dev, T, S, 32).expand(*lead, T, S)
    mask[..., 7, :] = -1e30
    mask = mask.contiguous()
    before = kernels.LAUNCHES["flash_attn"]
    got = PA.flash_attention_pallas(q, k, v, mask, D ** -0.5, chunk=128)
    want = PA.flash_attention_pallas(q, k, v, mask, D ** -0.5, chunk=128,
                                     plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attn"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, H, T, D)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4
    dead = v.float().mean(dim=2)
    assert float((got[:, :, 7] - dead).abs().max()) <= 1e-4


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("pos", [[0], [700], [700, 3, 1023, 2000], [-1]],
                         ids=["p0", "p700", "spread", "dead"])
@pytest.mark.parametrize("swa,cap", [(0, 0.0), (256, 0.0), (0, 30.0)],
                         ids=["plain", "swa", "cap"])
def test_decode_attn_gqa_kernel_matches_plain(dev, cache, pos, swa, cap):
    B, Hkv, G, S, D = len(pos), 8, 4, 1024, 128
    qg = _x(dev, B, Hkv, G, 1, D, seed=4)
    k = _x(dev, B, S, Hkv, D, seed=5).to(cache)
    v = _x(dev, B, S, Hkv, D, seed=6).to(cache)
    posb = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["decode_attn_gqa"]
    got = PA.decode_attention_pallas(qg, k, v, posb, D ** -0.5, swa=swa,
                                     logit_cap=cap)
    want = PA.decode_attention_pallas(qg, k, v, posb, D ** -0.5, swa=swa,
                                      logit_cap=cap, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attn_gqa"] == before + 1
    assert got.shape == qg.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4


#: K6's GEMM (B > 8) on every family and bias kind: byte planes without a
#: bias (IQ4_XS, Q8_0), with the derived bias (Q6_K, off * fs) and with a
#: stored one (Q5_K); nibble planes with a stored (Q4_K) and a derived
#: (Q4_0) bias; coded planes (IQ3_XXS, IQ2_S); and two widths whose group
#: count is not a multiple of a stage's groups (64 on byte planes, 32 on
#: packed ones), which load a stage's scales as boxes of 8 groups: Q8_0 at
#: K = 5120 (G = 160) and Q4_K at K = 11008 (G = 344)
_GEMM = {"iq4xs": (1024, 4096, GGMLType.IQ4_XS),
         "q8_0": (1024, 4096, GGMLType.Q8_0),
         "q6k": (512, 14336, GGMLType.Q6_K),
         "q5k": (1024, 4096, GGMLType.Q5_K),
         "q4k": (1024, 4096, GGMLType.Q4_K),
         "q4_0": (1024, 4096, GGMLType.Q4_0),
         "iq3xxs": (512, 14336, GGMLType.IQ3_XXS),
         "iq2s": (1024, 4096, GGMLType.IQ2_S),
         "q8_0_g160": (1024, 5120, GGMLType.Q8_0),
         "q4k_g344": (1024, 11008, GGMLType.Q4_K)}
#: its M cases: K3's, and 1024 (above the 512-token chunk, any M is tiled)
_GEMM_M = _K3_M + [1024]


def _gemm_case(dev, qt, mode, M, side=False):
    """K6 above 8 rows on interleaved planes qt in one mode (plain, pre_il,
    normed, res, act): kernel against plain version, one launch counted
    under its family-and-mode key and one under its GEMM key.  side: the
    normed mode with the caller's pre-norm group sums (xg_mode 1)."""
    fam = PF._family(qt.cfg)
    x = _x(dev, M, 2 * qt.k if mode == "act" else qt.k, seed=M)
    x = (x * (2 if mode == "act" else 1)).to(torch.bfloat16)
    kw = {}
    if mode == "normed":
        kw = dict(wn=torch.rand(qt.k, device=dev) + 0.5, eps=1e-5)
    elif mode == "pre_il":
        kw = dict(pre_il=True)
    elif mode in ("res", "act"):
        kw = dict(res=_x(dev, M, qt.n, seed=9))
        if mode == "act":
            kw["act"] = "silu"
    _, nkj = PF._pick_blocks(PF._padded_rows(M), qt.k, PF._is_packed(qt.cfg),
                             qt.cfg.gs)
    xg = PF.group_sums(qt, x, mode, kw.get("wn"), nkj)
    if side and xg is None and PF._needs_xg(qt.cfg, qt.fb):
        G = qt.fs.shape[1]
        xg = PF._sums_il(PF._interleave_x(x, G, qt.cfg.gs).float() * kw["wn"],
                         G)
    key = "fast_" + fam + {"normed": "_normed", "act": "_act",
                           "res": "_res"}.get(mode, "")
    gkey = kernels.gemm_key(qt)
    before = kernels.GEMM_LAUNCHES[gkey]
    wrapper, plain = PF._k6(qt, False), PF._k6(qt, True)
    _counted(key, lambda: wrapper(x, qt, xg=xg, **kw),
             lambda: plain(x, qt, xg=xg, **kw))
    assert kernels.GEMM_LAUNCHES[gkey] == before + 1


def _gemm_qt(dev, name):
    n, k, qtype = _GEMM[name]
    qt = _qt(dev, n, k, qtype, "il")
    assert qt.fl == "il"
    return qt


@pytest.mark.parametrize("M", _GEMM_M)
@pytest.mark.parametrize("name", list(_GEMM))
def test_fast_gemm_kernel_matches_plain(dev, name, M):
    """K6's GEMM in its plain mode, every family and bias kind."""
    _gemm_case(dev, _gemm_qt(dev, name), "plain", M)


@pytest.mark.parametrize("mode,M", [("pre_il", 16), ("pre_il", 512),
                                    ("normed", 32), ("normed", 512),
                                    ("side", 200), ("side", 512),
                                    ("res", 100), ("res", 512),
                                    ("act", 16), ("act", 512)])
@pytest.mark.parametrize("name", list(_GEMM))
def test_fast_gemm_modes_match_plain(dev, name, mode, M):
    """K6's GEMM in its pre_il, normed (sums in the kernel, or the caller's
    pre-norm sums: side), res and act modes."""
    _gemm_case(dev, _gemm_qt(dev, name), "normed" if mode == "side" else mode,
               M, side=mode == "side")


@pytest.mark.parametrize("M", [100, 512])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K,
                                   GGMLType.IQ3_XXS], ids=lambda t: t.name)
def test_fast_gemm_takes_an_expert_row_slice(dev, qtype, M):
    """One Mixtral expert's rows of a stacked interleaved tensor (a view of
    the stack, contiguous), as the dense MoE prefill runs them."""
    stack = _qt(dev, 4 * 1024, 4096, qtype, "il")
    e2 = qtensor_rows(stack, 2 * 1024, 1024)
    assert e2.fq.data_ptr() == stack.fq[2048:].data_ptr()
    _gemm_case(dev, e2, "plain", M)


@pytest.mark.parametrize("M", [32, 512])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_fast_gemm_without_k_splits(dev, qtype, M):
    """A gate_up-wide GEMM (224 lane tiles) fills the card without splitting
    K; the 1024-row shapes above split it (partials summed on the card,
    the residual added after)."""
    qt = _qt(dev, 28672, 4096, qtype, "il")
    assert kernels._gemm_splits(M, qt.fq.shape[0], qt.k, dev) == 1
    assert kernels._gemm_splits(M, 1024, qt.k, dev) > 1
    _gemm_case(dev, qt, "plain", M)
    _gemm_case(dev, qt, "res", M)


def test_wrappers_refuse_cpu_tensors_for_the_kernels(dev):
    qt = _qt(dev, 1024, 4096, GGMLType.Q4_K)
    with pytest.raises(ValueError):
        kernels.qp8_gemv(torch.zeros(1, 4096), qt)
    with pytest.raises(ValueError):
        kernels.qp8_gemm(torch.zeros(16, 4096, dtype=torch.bfloat16), qt)
    with pytest.raises(ValueError):
        kernels.qp8_indirect(torch.zeros(2, 4096), qt,
                             torch.zeros(2, dtype=torch.int32), 512)
    il = _il(dev, "wk_q8_0")
    with pytest.raises(ValueError):
        kernels.fast_byte(torch.zeros(1, 4096, dtype=torch.bfloat16), il)
    with pytest.raises(ValueError):
        kernels.fast_indirect(torch.zeros(2, 4096, dtype=torch.bfloat16), il,
                              torch.zeros(2, dtype=torch.int32), 512)


# ---------------------------------------------------------------------------
# K1 / K2 / K5 at NMSE <= 1e-9: inputs whose prologue is exact on both sides
# ---------------------------------------------------------------------------

def _exact_x(dev, B, k, mode, seed):
    """(x, kwargs) for K1's mode on rows whose prologue rounds alike in the
    kernel and the plain version: raw and res take any x; normed takes
    signed permutations of one vector of multiples of 1/8 with mean square
    4 - eps (every partial sum exact, so rsqrt(mean + eps) = 0.5 in any
    order); act takes gates of magnitude 20 to 30 (sigmoid is 1, or small
    enough that the product quantizes to 0) beside any up."""
    rng = np.random.default_rng(seed)
    kw = {}
    if mode == "normed":
        base = np.round(rng.normal(size=k) * 1.7 * 8) / 8
        x = np.stack([base[rng.permutation(k)] * rng.choice([-1.0, 1.0], k)
                      for _ in range(B)]).astype(np.float32)
        mean = np.float32(np.sum(base.astype(np.float32) ** 2)) / np.float32(k)
        assert 2.0 <= mean < 4.0
        kw = dict(wn=torch.tensor(rng.uniform(0.5, 1.5, k).astype(np.float32),
                                  device=dev),
                  eps=float(np.float32(4.0) - mean))
    elif mode == "act":
        gate = rng.choice([-1.0, 1.0], (B, k)) * rng.uniform(20, 30, (B, k))
        x = np.concatenate([gate, rng.normal(size=(B, k))], 1).astype(np.float32)
        kw = dict(act="silu")
    else:
        x = rng.normal(size=(B, k)).astype(np.float32)
    return torch.tensor(x, device=dev), kw


def _gemv_tight(dev, qt, mode, B, key):
    x, kw = _exact_x(dev, B, qt.k, mode, seed=B + qt.k)
    if mode in ("res", "act"):
        kw["res"] = _x(dev, B, qt.n, seed=9)
    before = kernels.LAUNCHES[key]
    got = P.qp8_gemv(x, qt, **kw)
    want = P.qp8_gemv_plain(x, qt, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_EXACT
    return got


_GEMV_TYPES = [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]
_MODES = ["raw", "normed", "res", "act"]


@pytest.mark.parametrize("qtype", _GEMV_TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mode", _MODES)
def test_qp8_gemv_kernel_matches_plain_exactly(dev, qtype, B, mode):
    _gemv_tight(dev, _qt(dev, 2048, 4096, qtype), mode, B, "qp8_gemv")


#: one plane set of each code map (iq2, iq3xxs, iq3s, iq1, ternary)
_CODE_MAPS = {"iq2": "wqk_iq2s", "iq3xxs": "down_iq3xxs", "iq3s": "wo_iq3s",
              "iq1": "iq1s", "tern": "tq2"}


@pytest.mark.parametrize("cm", list(_CODE_MAPS))
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mode", _MODES)
def test_qp8_gemv_coded_kernel_matches_plain_exactly(dev, cm, B, mode):
    qt = _coded(dev, _CODE_MAPS[cm], "t")
    assert qt.cfg.code_map == cm
    _gemv_tight(dev, qt, mode, B, "qp8_gemv_coded")


@pytest.mark.parametrize("pair", ["q4k_q6k", "iq2s_q4k"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_qp8_dual_kernel_matches_plain_exactly(dev, pair, B):
    a = (_qt(dev, 5120, 4096, GGMLType.Q4_K) if pair == "q4k_q6k"
         else _coded(dev, "wqk_iq2s", "t"))
    b = _qt(dev, 1024, 4096, GGMLType.Q6_K if pair == "q4k_q6k"
            else GGMLType.Q4_K)
    x, kw = _exact_x(dev, B, 4096, "normed", seed=B)
    got = P.qp8_dual(x, a, b, **kw)
    want = P.qp8_dual_plain(x, a, b, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, 6144)
    assert _nmse(got, want) <= NMSE_EXACT


@pytest.mark.parametrize("stack", ["gate_q5k", "down_q5k", "down_q6k",
                                   "gate_iq3xxs", "down_iq3xxs"])
@pytest.mark.parametrize("ids", [[5, 2], [3, 3], list(range(8)) * 2],
                         ids=["P2", "P2_dup", "P16"])
def test_qp8_indirect_kernel_matches_plain_exactly(dev, stack, ids):
    npe, k, qtype = {**_MOE, **_CODED_MOE}[stack]
    qt = _qt(dev, 8 * npe, k, qtype)
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    x = _x(dev, ids.numel(), k, seed=ids.numel())
    key = "qp8_indirect_coded" if qt.cfg.code_map else "qp8_indirect"
    before = kernels.LAUNCHES[key]
    got = P.qp8_indirect(x, qt, ids, npe)
    want = P.qp8_indirect_plain(x, qt, ids, npe)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_EXACT


def _plan_with(qts, nb, ks, cols=256):
    """A K1/K2/K5 plan of ks splits, the rest as the picker sizes it."""
    geos = [kernels.gemv_geo(q) for q in qts]
    per = max(-(-g.nchunks // ks) for g in geos)
    sb = max(kernels.gemv_stage(g, cols)[0] for g in geos)
    slots = max(kernels.gemv_slots(g, ks) for g in geos)
    for per_sm in (2, 1):  # as the picker: one block an SM where two do not fit
        budget = min(kernels.SMEM_BLOCK, kernels.SMEM_SM // per_sm - 1024)
        ns = min(16, per)
        while ns > 1 and kernels.gemv_smem(nb, sb, ns, slots) > budget:
            ns -= 1
        if ns >= min(2, per):
            break
    teams = 128 * kernels.gemv_cols_per_thread(nb) // cols
    nteam = (teams if per <= ns
             else min(teams, (ns - 1) * min(g.items for g in geos)))
    return kernels.GemvPlan(cols, ks, ns, nteam,
                            kernels.gemv_smem(nb, sb, ns, slots), per_sm)


@pytest.mark.parametrize("shape,ks", [((4096, 4096, GGMLType.Q4_K), 11),
                                      ((4096, 14336, GGMLType.Q6_K), 13),
                                      ((4096, 4096, GGMLType.Q5_K), 3),
                                      ((4096, 14336, GGMLType.IQ3_XXS), 9)],
                         ids=["q4k_64_11", "q6k_224_13", "q5k_16_3",
                              "iq3xxs_224_9"])
@pytest.mark.parametrize("B", [1, 8])
def test_qp8_gemv_kernel_on_a_ragged_k_split(dev, monkeypatch, shape, ks, B):
    """K splits whose chunk counts differ by one (the plane's unit chunks do
    not divide by ks): the last block of each tile sums them exactly."""
    n, k, qtype = shape
    qt = _qt(dev, n, k, qtype)
    assert kernels.gemv_geo(qt).nchunks % ks
    plan = _plan_with([qt], B, ks)
    monkeypatch.setattr(kernels, "_gemv_plan", lambda *a: plan)
    key = "qp8_gemv_coded" if qt.cfg.code_map else "qp8_gemv"
    _gemv_tight(dev, qt, "res", B, key)


@pytest.mark.parametrize("ks", [1, 16])
def test_qp8_gemv_kernel_gives_the_same_bits_twice(dev, monkeypatch, ks):
    """The split sum is deterministic: no float atomics, split order."""
    qt = _qt(dev, 4096, 14336, GGMLType.Q4_K)
    plan = _plan_with([qt], 1, ks)
    monkeypatch.setattr(kernels, "_gemv_plan", lambda *a: plan)
    x, kw = _exact_x(dev, 1, qt.k, "act", seed=4)
    first = P.qp8_gemv(x, qt, **kw)
    for _ in range(3):
        assert torch.equal(P.qp8_gemv(x, qt, **kw), first)
    assert _nmse(first, P.qp8_gemv_plain(x, qt, **kw)) <= NMSE_EXACT


def test_qp8_indirect_reads_expert_slices_in_place(dev):
    """K5 streams the selected experts' lanes of the stacked planes: the
    call allocates its output and split partials, no copy of an expert."""
    qt = _qt(dev, 8 * 4096, 14336, GGMLType.Q6_K)
    ids = torch.tensor([6, 1], dtype=torch.int32, device=dev)
    x = _x(dev, 2, 14336, seed=2)
    P.qp8_indirect(x, qt, ids, 4096)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    got = P.qp8_indirect(x, qt, ids, 4096)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - before
    one_expert = sum(t[:, :4096].numel() * t.element_size()
                     for t in (qt.fq, qt.fs))
    assert extra < one_expert // 16
    assert _nmse(got, P.qp8_indirect_plain(x, qt, ids, 4096)) <= NMSE_EXACT


# ---------------------------------------------------------------------------
# K6 at B <= 8 and K8 (csrc/fast_il.cu il_gemv_kernel) at NMSE <= 1e-9:
# inputs whose prologue is exact on both sides
# ---------------------------------------------------------------------------

#: one plane set of each family and bias kind: byte planes without a bias
#: (IQ4_XS), with the derived bias (Q6_K: off * fs) and with a stored one
#: (Q5_K); nibble planes (Q4_K, stored; Q4_0, derived); coded planes of two
#: code maps (IQ3_XXS, IQ2_S), ternary; nibble planes at K = 14336; G a
#: multiple of 8 but not of 16 (per-period boxes): byte planes and nibble
#: ones with the derived bias at K = 11008 (G = 344), ternary at K = 14336
#: (G = 56)
_IL_EXACT = {"byte": (2048, 4096, GGMLType.IQ4_XS),
             "byte_derived": (2048, 4096, GGMLType.Q6_K),
             "byte_stored": (2048, 4096, GGMLType.Q5_K),
             "nibble": (2048, 4096, GGMLType.Q4_K),
             "nibble_derived": (1024, 4096, GGMLType.Q4_0),
             "coded_iq3xxs": (2048, 4096, GGMLType.IQ3_XXS),
             "coded_iq2s": (2048, 4096, GGMLType.IQ2_S),
             "tern": (1024, 4096, GGMLType.TQ2_0),
             # G = 448: a ragged last residue block (64 of 128 groups)
             "nibble_g448": (1024, 14336, GGMLType.Q4_K),
             "byte_g344": (1024, 11008, GGMLType.IQ4_XS),
             "nibble_g344": (1024, 11008, GGMLType.Q4_0),
             "tern_g56": (1024, 14336, GGMLType.TQ2_0)}
_IL_MODES = ["plain", "pre_il", "normed", "act", "res"]


def _exact_bf16(dev, B, k, mode, seed):
    """(x bf16, kwargs) for K6's mode on rows whose prologue rounds alike in
    the kernel and the plain version (_exact_x's rows, in bf16: multiples
    of 1/8 of mean square 4 - eps for the norm, gates of magnitude 20-30
    for silu)."""
    x, kw = _exact_x(dev, B, k, "act" if mode == "act" else
                     "normed" if mode == "normed" else "raw", seed)
    if mode == "pre_il":
        kw = dict(pre_il=True)
    return x.to(torch.bfloat16), kw


def _il_tight(dev, qt, mode, B, seed=0):
    x, kw = _exact_bf16(dev, B, qt.k, mode, seed + B)
    if mode == "res":
        kw["res"] = _x(dev, B, qt.n, seed=9)
    elif mode == "act":
        kw["res"] = _x(dev, B, qt.n, seed=9)
    _, nkj = PF._pick_blocks(PF._padded_rows(B), qt.k, PF._is_packed(qt.cfg),
                             qt.cfg.gs)
    kw["xg"] = PF.group_sums(qt, x, "plain" if mode == "res" else mode,
                             kw.get("wn"), nkj)
    fam = "fast_" + PF._family(qt.cfg)
    key = fam + {"normed": "_normed", "act": "_act", "res": "_res"}.get(mode, "")
    before = kernels.LAUNCHES[key]
    got = PF._k6(qt, False)(x, qt, **kw)
    want = PF._k6(qt, True)(x, qt, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_EXACT
    return x, kw, got


@pytest.mark.parametrize("name", list(_IL_EXACT))
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mode", _IL_MODES)
def test_fast_il_gemv_matches_plain_exactly(dev, name, B, mode):
    """K6 at B <= 8, every family, bias kind and mode, one launch."""
    n, k, qtype = _IL_EXACT[name]
    _il_tight(dev, _qt(dev, n, k, qtype, "il"), mode, B)


def _il_plan_with(qt, nb, ks, rows_z=1):
    """A K6/K8 plan of ks splits and one tile a block, the ring the picker
    would give."""
    fb, bias = qt.fb is not None, PF._needs_xg(qt.cfg, qt.fb)
    G = qt.fs.shape[1]
    geo = kernels.il_geo(qt.k, G, PF._is_packed(qt.cfg))
    ns = 2
    return kernels.IlPlan(ks, ns, qt.fq.shape[0] // kernels.IL_ROWS,
                          kernels.il_smem(geo, fb, bias, ns, ks, qt.k // G, nb),
                          1)


@pytest.mark.parametrize("name,ks", [("byte", 5), ("nibble_derived", 3),
                                     ("coded_iq3xxs", 7), ("byte_stored", 6)])
@pytest.mark.parametrize("B", [1, 8])
def test_fast_il_gemv_on_a_ragged_k_split(dev, monkeypatch, name, ks, B):
    """Splits whose stage counts differ by one, starting inside a residue
    block: the last block of each tile sums them exactly, the bias once."""
    n, k, qtype = _IL_EXACT[name]
    qt = _qt(dev, n, k, qtype, "il")
    geo = kernels.il_geo(k, qt.fs.shape[1], PF._is_packed(qt.cfg))
    assert geo.nst % ks and geo.nst // ks < geo.spr
    plan = _il_plan_with(qt, B, ks)
    monkeypatch.setattr(kernels, "pick_il_gemv", lambda *a: plan)
    _il_tight(dev, qt, "normed", B)


@pytest.mark.parametrize("ns", [2, 4, 8])
def test_fast_il_gemv_one_stage_a_split_many_tiles_a_block(dev, monkeypatch, ns):
    """Every stage of a split loads its residue block's scales (one stage a
    split) and each block takes five tiles, its ring running ahead across
    them: a scale region is refilled only after its values fed the mma."""
    qt = _qt(dev, 5120, 4096, GGMLType.IQ4_XS, "il")
    geo = kernels.il_geo(qt.k, qt.fs.shape[1], False)
    plan = kernels.IlPlan(geo.nst, ns, 16, 0, 2)
    monkeypatch.setattr(kernels, "pick_il_gemv", lambda *a: plan)
    for _ in range(3):
        _il_tight(dev, qt, "plain", 1)


@pytest.mark.parametrize("ks", [1, 4])
def test_fast_il_gemv_gives_the_same_bits_twice(dev, monkeypatch, ks):
    """The split sum is deterministic: no float atomics, split order."""
    qt = _qt(dev, 2048, 4096, GGMLType.Q4_K, "il")
    plan = _il_plan_with(qt, 3, ks)
    monkeypatch.setattr(kernels, "pick_il_gemv", lambda *a: plan)
    x, kw, first = _il_tight(dev, qt, "act", 3)
    for _ in range(3):
        assert torch.equal(PF.fast_nibble(x, qt, **kw), first)


@pytest.mark.parametrize("stack", ["iq4xs", "q6k", "q4k", "iq3xxs"])
@pytest.mark.parametrize("ids", [[5, 2], [3, 3], [1, 8, -1]],
                         ids=["P2", "P2_dup", "bad_id"])
def test_fast_indirect_matches_plain_exactly(dev, stack, ids):
    """K8 on byte stacks without a bias and with the derived one, nibble
    stacks with a stored one and coded stacks; an id outside [0, E) gives
    a NaN row and leaves the others exact."""
    qtype = {"iq4xs": GGMLType.IQ4_XS, "q6k": GGMLType.Q6_K,
             "q4k": GGMLType.Q4_K, "iq3xxs": GGMLType.IQ3_XXS}[stack]
    qt = _qt(dev, 8 * 1024, 4096, qtype, "il")
    ids_t = torch.tensor(ids, dtype=torch.int32, device=dev)
    x = _x(dev, len(ids), 4096, seed=len(ids)).to(torch.bfloat16)
    xg = (PF._sums_natural(x, qt.fs.shape[1])
          if PF._needs_xg(qt.cfg, qt.fb) else None)
    key = ("fast_indirect_coded" if qt.cfg.code_map else "fast_indirect_nibble"
           if PF._is_nibble(qt.cfg) else "fast_indirect")
    before = kernels.LAUNCHES[key]
    got = PF.fast_indirect(x, qt, ids_t, 1024, xg)
    want = PF.fast_indirect_plain(x, qt, ids_t, 1024, xg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    ok = (ids_t >= 0) & (ids_t < 8)
    assert torch.isnan(got[~ok]).all() and torch.isfinite(got[ok]).all()
    assert _nmse(got[ok], want[ok]) <= NMSE_EXACT


@pytest.mark.parametrize("stack,k,npe,ids", [
    ("iq4xs", 4096, 96, [15, 2]), ("q4k", 4096, 160, [1, 15, 3]),
    ("q4_0", 11008, 96, [15, 0])])
def test_fast_indirect_on_experts_of_a_ragged_tile(dev, stack, k, npe, ids):
    """npe not a multiple of the 64-row tile (16 experts, rows a multiple
    of the planes' 512-row padding): the last tile of an expert reads the
    next expert's rows (or zeros past the last) and stores only its own;
    at K = 11008 the groups of 32 give G = 344 (the warp-copied stages)."""
    qtype = {"iq4xs": GGMLType.IQ4_XS, "q4k": GGMLType.Q4_K,
             "q4_0": GGMLType.Q4_0}[stack]
    qt = _qt(dev, 16 * npe, k, qtype, "il")
    assert qt.fq.shape[0] == 16 * npe
    ids_t = torch.tensor(ids, dtype=torch.int32, device=dev)
    x = _x(dev, len(ids), k, seed=npe).to(torch.bfloat16)
    xg = (PF._sums_natural(x, qt.fs.shape[1])
          if PF._needs_xg(qt.cfg, qt.fb) else None)
    got = PF.fast_indirect(x, qt, ids_t, npe, xg)
    want = PF.fast_indirect_plain(x, qt, ids_t, npe, xg)
    torch.cuda.synchronize()
    assert got.shape == (len(ids), npe) and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_EXACT


def test_fast_il_gemv_refuses_planes_it_cannot_stage(dev):
    """Groups that do not come in multiples of 8 (ternary at K = 1024:
    G = 4) are no geometry the kernel stages (il_geo raises); the wrapper
    pads them to 8 groups and launches the kernel, never the plain twin."""
    qt = _qt(dev, 1024, 1024, GGMLType.TQ2_0, "il")
    with pytest.raises(ValueError):
        kernels.il_geo(qt.k, qt.fs.shape[1], True)
    x = _x(dev, 1, 1024).to(torch.bfloat16)
    before = kernels.LAUNCHES["fast_coded"]
    got = PF.fast_coded(x, qt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_coded"] == before + 1
    assert _nmse(got, PF.fast_coded_plain(x, qt)) <= NMSE_MAX


#: K7's pairs (part a, part b): the configurations' (8B Q4_K_M il: Q4_K wqk,
#: nibble with a stored bias, + Q6_K wv, byte with the derived one; 8B
#: IQ3_XXS il: IQ2_S wqk, coded, + Q4_K wv), and ternary parts whose G is
#: not a multiple of 8 (G = 4 at K = 1024, G = 43 at K = 11008, padded to 8
#: and 48 groups) beside a Q4_K or Q8_0 part, in either position
_DUAL = {"q4k_q6k": ((5120, 4096, GGMLType.Q4_K), (1024, 4096, GGMLType.Q6_K)),
         "iq2s_q4k": ((5120, 4096, GGMLType.IQ2_S),
                      (1024, 4096, GGMLType.Q4_K)),
         "tq1g4_q4k": ((1024, 1024, GGMLType.TQ1_0),
                       (512, 1024, GGMLType.Q4_K)),
         "q8_0_tq1g4": ((512, 1024, GGMLType.Q8_0),
                        (1024, 1024, GGMLType.TQ1_0)),
         "tq2g43_q4k": ((1024, 11008, GGMLType.TQ2_0),
                        (512, 11008, GGMLType.Q4_K)),
         "q4k_tq2g43": ((512, 11008, GGMLType.Q4_K),
                        (1024, 11008, GGMLType.TQ2_0))}


@pytest.mark.parametrize("pair", list(_DUAL))
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("normed", [True, False], ids=["normed", "raw"])
def test_fast_dual_matches_plain_exactly(dev, pair, B, normed):
    """K7, one il_gemv_kernel launch a call, on rows whose prologue rounds
    alike everywhere (_exact_bf16): the output against fast_dual_plain,
    and each part's columns against K6 on that part alone in the same
    mode."""
    a, b = (_qt(dev, *shape, "il") for shape in _DUAL[pair])
    assert PF.supports_dual(a, b)
    x, kw = _exact_bf16(dev, B, a.k, "normed" if normed else "plain", B)
    mode = "normed" if normed else "plain"
    wns = ((kw["wn"], torch.rand(a.k, device=dev) + 0.5) if normed
           else (None, None))
    xgs = [PF.group_sums(q, x, mode, wn) for q, wn in zip((a, b), wns)]
    dkw = dict(wn_a=wns[0], wn_b=wns[1], eps=kw.get("eps"), xg_a=xgs[0],
               xg_b=xgs[1])
    key = ("fast_dual_coded" if a.cfg.code_map or b.cfg.code_map
           else "fast_dual")
    before = kernels.LAUNCHES[key]
    got = PF.fast_dual(x, a, b, **dkw)
    want = PF.fast_dual_plain(x, a, b, **dkw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    assert got.shape == (B, a.n + b.n) and torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_EXACT
    for q, cols, wn, xg in ((a, slice(0, a.n), wns[0], xgs[0]),
                            (b, slice(a.n, a.n + b.n), wns[1], xgs[1])):
        alone = PF._k6(q, False)(x, q, wn=wn, eps=kw.get("eps"), xg=xg)
        assert _nmse(got[:, cols], alone) <= NMSE_EXACT


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("pos", [[8191], [5000, 100], [-1]],
                         ids=["last", "spread", "dead"])
@pytest.mark.parametrize("G", [1, 8])
def test_decode_attn_gqa_kernel_on_a_long_cache(dev, cache, pos, G):
    """K12 at S = 8192: a split's share (1024 slots) runs in two score
    passes, the second rescaling the first's sums, through more chunks
    than its ring holds; G = 8 gives a thread two query heads."""
    B, Hkv, S, D = len(pos), 8, 8192, 128
    qg = _x(dev, B, Hkv, G, 1, D, seed=7)
    k = _x(dev, B, S, Hkv, D, seed=8).to(cache)
    v = _x(dev, B, S, Hkv, D, seed=9).to(cache)
    posb = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["decode_attn_gqa"]
    got = PA.decode_attention_pallas(qg, k, v, posb, D ** -0.5)
    want = PA.decode_attention_pallas(qg, k, v, posb, D ** -0.5, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attn_gqa"] == before + 1
    assert got.shape == qg.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("pos", [0, 31, 700])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("swa,cap", [(0, 0.0), (100, 2.0)],
                         ids=["plain", "swa_cap"])
def test_decode_attn_q4_kernel_matches_plain(dev, pos, B, swa, cap):
    """K4 over a q4_0 cache (the 8B's heads): the kernel against its plain
    twin (which unpacks the nibbles and runs the int8 path), counted under
    decode_attn_q4; then a CUDA graph of the launch, replayed, gives the
    eager launch's bits."""
    Hq, Hkv, D, S = 32, 8, 128, 1024
    g = torch.Generator(device=dev)
    g.manual_seed(pos * 10 + B)
    qkv = _x(dev, B, (Hq + 2 * Hkv) * D, seed=pos + 11)
    kc, vc = (PD.pack_int4(torch.randint(-7, 8, (B, S, Hkv * D), device=dev,
                                         dtype=torch.int8, generator=g))
              for _ in range(2))
    ks = torch.rand(B, S, device=dev, generator=g) * 0.02
    vs = torch.rand(B, S, device=dev, generator=g) * 0.02
    rows = [pos, max(0, pos - 3), pos // 2, min(S - 1, pos + 5)] * 2
    posb = torch.tensor(rows[:B], dtype=torch.int32, device=dev)
    inv = 500000.0 ** (-torch.arange(0, D, 2, device=dev).float() / D)
    ang = posb[:, None].float() * inv[None]
    cs = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).contiguous()
    kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5, k_scale=ks, v_scale=vs,
              swa=swa, logit_cap=cap, kv_bits=4)
    before = dict(kernels.LAUNCHES)
    got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
    want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attn_q4"] == before["decode_attn_q4"] + 1
    assert kernels.LAUNCHES["decode_attn"] == before["decode_attn"]
    for gt, w in zip(got, want):
        assert torch.isfinite(gt).all()
        assert float((gt - w).abs().max()) <= 1e-4
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(out, got):
            assert torch.equal(o, e)


def test_decode_attn_q4_kernel_refuses_int8_caches_as_int4(dev):
    B, Hkv, D, S = 1, 8, 128, 64
    qkv = _x(dev, B, (32 + 2 * Hkv) * D)
    kc = torch.zeros(B, S, Hkv * D, dtype=torch.int8, device=dev)
    sc = torch.ones(B, S, device=dev)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.decode_attn(qkv, kc, kc, pos, None, Hq=32, Hkv=Hkv, D=D,
                            scale=0.1, k_scale=sc, v_scale=sc, kv_bits=4)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K])
def test_pack_tensor_on_the_card_matches_cpu(dev, qtype):
    """GGUF wire bytes of a 4096-wide tensor (synth.wire_blocks of a random
    draw) unpack on the card to the CPU's planes, byte for byte."""
    from ggml_hexagon_tpu_torch.models.synth import wire_blocks
    from ggml_hexagon_tpu_torch.quant.pack import pack_tensor

    g = torch.Generator()
    g.manual_seed(int(qtype))
    raw = wire_blocks(random_qtensor(g, 1000, 4096, qtype, "cpu"))
    want = pack_tensor(raw, qtype, (1000, 4096))
    got = pack_tensor(raw.to(dev), qtype, (1000, 4096))
    torch.cuda.synchronize()
    for f in ("q", "qh", "d", "sc", "dmin", "m"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b), f


# -- the continuous-batching server's shapes: rows at their own positions, a
# -- row parked at the last slot (server/batch_engine.py)

_SERVE_POS = [0, 31, 700]  # and one row parked at S - 1


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_decode_attn_parked_row_at_the_server_shape(dev, kind):
    """K4 at B = 4, S = 2048, the 8B's heads, rows at 0, 31 and 700 and one
    parked at S - 1 (which reads the whole prefix): each row within 1e-4
    of the plain twin."""
    Hq, Hkv, D, S = 32, 8, 128, 2048
    posb = torch.tensor(_SERVE_POS + [S - 1], dtype=torch.int32, device=dev)
    B = posb.shape[0]
    qkv = _x(dev, B, (Hq + 2 * Hkv) * D, seed=41)
    kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5)
    if kind == "bf16":
        kc = _x(dev, B, S, Hkv * D, seed=42).to(torch.bfloat16)
        vc = _x(dev, B, S, Hkv * D, seed=43).to(torch.bfloat16)
    else:
        qmax = 127 if kind == "int8" else 7
        g = torch.Generator(device=dev)
        g.manual_seed(44)
        kc, vc = (torch.randint(-qmax, qmax + 1, (B, S, Hkv * D), device=dev,
                                dtype=torch.int8, generator=g)
                  for _ in range(2))
        if kind == "int4":
            kc, vc = PD.pack_int4(kc), PD.pack_int4(vc)
        kw.update(k_scale=torch.rand(B, S, device=dev, generator=g) * 0.02,
                  v_scale=torch.rand(B, S, device=dev, generator=g) * 0.02,
                  kv_bits=4 if kind == "int4" else 0)
    inv = 500000.0 ** (-torch.arange(0, D, 2, device=dev).float() / D)
    ang = posb[:, None].float() * inv[None]
    cs = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).contiguous()
    key = "decode_attn_q4" if kind == "int4" else "decode_attn"
    before = kernels.LAUNCHES[key]
    got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
    want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    for g_, w in zip(got, want):
        assert torch.isfinite(g_).all()
        assert float((g_ - w).abs().max()) <= 1e-4


_SERVE_MODEL = {}


def _serve_model(dev):
    """A 2-layer Q4_K_M model at the 8B's head geometry (8 query / 2 KV
    heads of 128), built once."""
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig
    from ggml_hexagon_tpu_torch.models.synth import build_model

    if "m" not in _SERVE_MODEL:
        cfg = LlamaConfig(n_vocab=512, n_embd=1024, n_layer=2, n_head=8,
                          n_head_kv=2, n_ff=2048, rope_theta=500000.0)
        _SERVE_MODEL["m"] = build_model(cfg, seed=5, device=dev)
    return _SERVE_MODEL["m"]


def _serve_tick(dev, kv, plain):
    """One B = 4 decode tick at rows 0, 31 and 700 and one parked at S-1 =
    2047, on a cache of random content (the same for both routes)."""
    from ggml_hexagon_tpu_torch.models.llama import forward, init_kv_cache

    cfg, w = _serve_model(dev)
    S = 2048
    cache = init_kv_cache(cfg, 4, S, kv, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    for n, a in cache.items():
        if a.dtype == torch.bfloat16:
            a.copy_(torch.randn(a.shape, generator=g, device=dev) * 0.5)
        elif a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        else:
            a.copy_(torch.rand(a.shape, generator=g, device=dev) * 0.01)
    toks = torch.tensor([[5], [77], [300], [0]], device=dev)
    pos = torch.tensor(_SERVE_POS + [S - 1], device=dev)
    logits, cache = forward(cfg, w, toks, cache, pos, plain=plain)
    torch.cuda.synchronize()
    return logits, cache


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_decode_tick_with_row_positions_matches_plain(dev, kv):
    """A B = 4 decode tick, rows at their own positions and one parked:
    the kernels' logits within NMSE 5e-4 of the plain forward's on the
    live rows (K1/K2 at 4 rows, K4 with a position a row)."""
    kernels.reset_launches()
    got, _ = _serve_tick(dev, kv, plain=False)
    assert kernels.LAUNCHES["decode_attn"] == 2
    assert kernels.LAUNCHES["qp8_gemv"] + kernels.LAUNCHES["qp8_dual"] > 0
    want, _ = _serve_tick(dev, kv, plain=True)
    assert torch.isfinite(got).all()
    assert _nmse(got[:3], want[:3]) <= 5e-4


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_bulk_kv_write_at_row_positions_matches_plain(dev, kv):
    """The tick's one bulk KV write puts each row's fresh k and v at the
    row's own slot (the parked row's into S-1, nowhere else): the caches
    of the kernel and plain forwards agree everywhere below S-1 (NMSE <=
    5e-4 on the written slots, bit-equal on the others)."""
    _, got = _serve_tick(dev, kv, plain=False)
    _, want = _serve_tick(dev, kv, plain=True)
    S = got["k"].shape[2]
    for n in got:
        a, b = got[n][:, :, :S - 1], want[n][:, :, :S - 1]
        written = torch.zeros(a.shape[:3], dtype=torch.bool, device=dev)
        for row, p in enumerate(_SERVE_POS):
            written[:, row, p] = True
        assert torch.equal(a[~written], b[~written]), n
        if n in ("k", "v"):
            fa, fb = a[written].float(), b[written].float()
            if kv == "q8_0":
                fa = fa * got[n + "_d"][:, :, :S - 1][written][:, None]
                fb = fb * want[n + "_d"][:, :, :S - 1][written][:, None]
            assert _nmse(fa, fb) <= 5e-4, n


# ---------------------------------------------------------------------------
# the branches Gemma-class models reach: gelu and relu acts (K1, K6, K9),
# K4 at a head width of 256 with a window and a logit cap
# ---------------------------------------------------------------------------

#: Gemma-2-9B's down projections (d = 3584, n_ff = 14336), and a coded
#: down at that shape for K6's coded family
_GEMMA_DOWN = {"down_q4k": (3584, 14336, GGMLType.Q4_K),
               "down_q6k": (3584, 14336, GGMLType.Q6_K)}
_GEMMA_DOWN_IL = {**_GEMMA_DOWN,
                  "down_iq3xxs": (3584, 14336, GGMLType.IQ3_XXS)}


@pytest.mark.parametrize("name", list(_GEMMA_DOWN))
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("with_res", [False, True], ids=["", "res"])
def test_qp8_gemv_act_branches_match_plain(dev, name, act, B, with_res):
    """K1's gelu and relu act prologues (a template instance each) on
    Gemma-2's downs, with and without the residual (Gemma-2 takes none):
    one launch, under the branch's suffixed key (qp8_gemv_gelu, ...);
    NMSE <= 1e-6 (tanhf and torch's tanh differ in the last ulp)."""
    n, k, qtype = _GEMMA_DOWN[name]
    qt = _qt(dev, n, k, qtype)
    x = _x(dev, B, 2 * k, seed=B + 20)
    kw = dict(act=act)
    if with_res:
        kw["res"] = _x(dev, B, n, seed=9)
    kernels.reset_launches()
    got = P.qp8_gemv(x, qt, **kw)
    want = P.qp8_gemv_plain(x, qt, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        f"qp8_gemv_{act}": 1}
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("name", list(_GEMMA_DOWN_IL))
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("with_res", [False, True], ids=["", "res"])
def test_fast_il_act_branches_match_plain(dev, name, act, B, with_res):
    """K6's gelu and relu act modes on Gemma-2's downs on interleaved
    planes (Q4_K nibble with a stored bias, Q6_K byte with the derived
    one, IQ3_XXS coded), at B <= 8 (build_act's act, picked a task) and
    above (the GEMM's pre-pass); one launch under the suffixed key."""
    n, k, qtype = _GEMMA_DOWN_IL[name]
    qt = _qt(dev, n, k, qtype, "il")
    nib = PF._is_packed(qt.cfg)
    x = (_x(dev, B, 2 * k, seed=B + 30) * 2).to(torch.bfloat16)
    kw = dict(act=act)
    if with_res:
        kw["res"] = _x(dev, B, n, seed=9)
    _, nkj = PF._pick_blocks(PF._padded_rows(B), k, nib, qt.cfg.gs)
    xg = PF.group_sums(qt, x, "act", None, nkj, act=act)
    kernels.reset_launches()
    got = PF._k6(qt, False)(x, qt, xg=xg, **kw)
    want = PF._k6(qt, True)(x, qt, xg=xg, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        f"fast_{PF._family(qt.cfg)}_act_{act}": 1}
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("down", ["q4k", "q6k"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("B", [1, 8])
def test_ffn_fused_act_branches_match_plain(dev, down, act, B):
    """K9's phase B in its gelu and relu instances at the Llama-3-8B widths
    (d = 4096, n_ff = 14336; no Gemma width takes K9: G = 3584 / 32 = 112
    is not a multiple of 128)."""
    wo, gu, dn = _k9_layer(dev, 4096, 14336, _K9_DOWN[down])
    wn = torch.rand(4096, device=dev) + 0.5
    attn, h = _x(dev, B, 4096, seed=B), _x(dev, B, 4096, seed=B + 1)
    kernels.reset_launches()
    got = PFF.ffn_fused(attn, h, wo, gu, dn, wn, 1e-6, act=act,
                        out_dtype=torch.float32)
    want = PFF.ffn_fused(attn, h, wo, gu, dn, wn, 1e-6, act=act,
                         out_dtype=torch.float32, plain=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        f"ffn_fused_{PF._family(dn.cfg)}_{act}": 1}
    assert torch.isfinite(got).all()
    assert _nmse(got, want) <= NMSE_MAX


def _k4_256(dev, kv, B, S, pos, swa, cap, Hq=16, Hkv=8, seed=0,
            clobber=False):
    """K4 at D = 256 (Gemma-2-9B's 16 query and 8 KV heads) against its
    plain twin over a bf16, int8 or packed int4 cache; clobber: then
    again with every slot below row 0's window overwritten, which must
    give the same bits."""
    D = 256
    qkv = _x(dev, B, (Hq + 2 * Hkv) * D, seed=seed)
    kw = {}
    if kv == "bf16":
        kc = _x(dev, B, S, Hkv * D, seed=1).to(torch.bfloat16)
        vc = _x(dev, B, S, Hkv * D, seed=2).to(torch.bfloat16)
    else:
        qmax = 127 if kv == "int8" else 7
        kc = torch.randint(-qmax, qmax + 1, (B, S, Hkv * D), device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-qmax, qmax + 1, (B, S, Hkv * D), device=dev,
                           dtype=torch.int8)
        kw = dict(k_scale=torch.rand(B, S, device=dev) * 2.0 / qmax,
                  v_scale=torch.rand(B, S, device=dev) * 2.0 / qmax)
        if kv == "int4":
            kc, vc = PD.pack_int4(kc), PD.pack_int4(vc)
            kw["kv_bits"] = 4
    rows = [pos, max(0, pos - 3), pos // 2, min(S - 1, pos + 5)][:B]
    posb = torch.tensor(rows, dtype=torch.int32, device=dev)
    inv = 10000.0 ** (-torch.arange(0, D, 2, device=dev).float() / D)
    ang = posb[:, None].float() * inv[None]
    cs = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).contiguous()
    kw.update(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5, swa=swa, logit_cap=cap)
    kernels.reset_launches()
    got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
    want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
    torch.cuda.synchronize()
    key = ("decode_attn_q4" if kv == "int4" else "decode_attn") + "_d256"
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {key: 1}
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4
    if clobber:
        lo = pos - swa + 1
        kc[:, :lo] = kc[:, lo:2 * lo].flip(1)
        vc[:, :lo] = vc[:, lo:2 * lo].flip(1)
        again = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
        assert torch.equal(again[0], got[0])
    return got


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("pos", [0, 1, 33, 700, 1023])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("swa,cap", [(0, 0.0), (100, 50.0)],
                         ids=["plain", "swa_cap"])
def test_decode_attn_d256_matches_plain(dev, kv, pos, B, swa, cap):
    _k4_256(dev, kv, B, 1024, pos, swa, cap, seed=pos)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_decode_attn_d256_window_masks(dev, kv):
    """Gemma-2's window on an 8192-slot cache at pos 4700: slots below pos
    - 4095 change nothing, and the capped scores match the plain twin."""
    _k4_256(dev, kv, 1, 8192, 4700, 4096, 50.0, seed=3, clobber=True)
