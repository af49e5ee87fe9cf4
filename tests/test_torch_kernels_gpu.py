"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the main path's shapes (Llama-3-8B Q4_K_M widths).

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
      order.  NMSE <= 1e-6.
  K4 (attention): f32 throughout, another order and expf: max|d| <= 1e-4.
"""
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.ops import decode_attn as PD
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P
from ggml_hexagon_tpu_torch.quant.formats import GGMLType

pytestmark = pytest.mark.gpu

NMSE_MAX = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    return torch.device("cuda")


_QT = {}


def _qt(dev, n, k, qtype):
    key = (n, k, qtype)
    if key not in _QT:
        g = torch.Generator(device=dev)
        g.manual_seed(n * 7 + k + int(qtype))
        _QT[key] = random_qtensor(g, n, k, qtype, dev).with_t_planes().without_wire()
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
                                   (1000, 4096, GGMLType.Q6_K)],
                         ids=["wqkv", "down_q6k", "down_q4k", "head_like"])
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


@pytest.mark.parametrize("M", [16, 100, 512])
@pytest.mark.parametrize("shape", [(1024, 4096, GGMLType.Q4_K),
                                   (512, 14336, GGMLType.Q6_K)],
                         ids=["q4k", "q6k"])
def test_qp8_gemm_kernel_matches_plain(dev, M, shape):
    n, k, qtype = shape
    qt = _qt(dev, n, k, qtype)
    x = _x(dev, M, k, seed=M).to(torch.bfloat16)
    got = P.qp8_gemm(x, qt)
    want = P.qp8_gemm_plain(x, qt)
    torch.cuda.synchronize()
    assert _nmse(got, want) <= NMSE_MAX


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, 1, 700])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("swa,cap", [(0, 0.0), (100, 2.0)],
                         ids=["plain", "swa_cap"])
def test_decode_attn_kernel_matches_plain(dev, quant, pos, B, swa, cap):
    Hq, Hkv, D, S = 32, 8, 128, 1024
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
    posb = torch.full((B,), pos, dtype=torch.int32, device=dev)
    posb[-1] = max(0, pos - 3)  # rows at different positions
    inv = 500000.0 ** (-torch.arange(0, D, 2, device=dev).float() / D)
    ang = posb[:, None].float() * inv[None]
    cs = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).contiguous()
    kw = dict(Hq=Hq, Hkv=Hkv, D=D, scale=D ** -0.5, k_scale=ks, v_scale=vs,
              swa=swa, logit_cap=cap)
    got = PD.decode_attn(qkv, kc, vc, posb, cs, **kw)
    want = PD.decode_attn_plain(qkv, kc, vc, posb, cs, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4


def test_wrappers_refuse_cpu_tensors_for_the_kernels(dev):
    qt = _qt(dev, 1024, 4096, GGMLType.Q4_K)
    with pytest.raises(ValueError):
        kernels.qp8_gemv(torch.zeros(1, 4096), qt)
    with pytest.raises(ValueError):
        kernels.qp8_gemm(torch.zeros(16, 4096, dtype=torch.bfloat16), qt)
