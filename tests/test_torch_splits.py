"""The host's tile and split choices for the wgmma GEMMs, K3 and K6 above
8 rows (token tile, K over blocks), and K4 (live cache slots over blocks):
pure functions of the shapes, so they run here without a card.  The
card's SM count is stubbed at the H100's 132."""
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.quant.formats import GGMLType

H100_SMS = 132
DEV = torch.device("cuda", 0)


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(kernels, "_sm_count", lambda index: H100_SMS)


@pytest.mark.parametrize("B,Hkv,S", [(1, 8, 1024), (4, 8, 1024),
                                     (1, 8, 8192), (1, 1, 64), (8, 8, 512)])
def test_decode_splits_cover_the_card_with_whole_slices(B, Hkv, S):
    ns = kernels._pick_nsplit(B * Hkv, S, min_slots=32)
    assert ns >= 1
    assert S / ns >= 32 or ns == 1   # at least 32 slots of the cache a split
    if S >= 32 * 132 // (B * Hkv):  # a cache long enough to fill the card
        assert B * Hkv * ns >= H100_SMS


def test_decode_splits_at_the_8b_decode_step():
    """B=1, 8 KV heads, 1024 slots: 32 splits, 256 blocks for 132 SMs."""
    assert kernels._pick_nsplit(8, 1024, min_slots=32) == 32


@pytest.mark.parametrize("M,n2,K,want", [
    (512, 28672, 4096, 1),    # gate_up: 224 x 2 tiles already fill the card
    (32, 28672, 4096, 1),
    (512, 4096, 14336, 2),    # down: 32 x 2 tiles
    (128, 4096, 14336, 4),
    (32, 4096, 14336, 4),
    (512, 4096, 4096, 2),     # wo
    (512, 6144, 4096, 4),     # wqkv: 96 tiles, a wave of 132 cut to 0.75
])
def test_gemm_splits_at_the_8b_shapes(sms, M, n2, K, want):
    assert kernels._gemm_splits(M, n2, K, DEV) == want


@pytest.mark.parametrize("M", [9, 32, 100, 128, 200, 512])
@pytest.mark.parametrize("n2,K", [(128, 1024), (1024, 4096), (4096, 14336),
                                  (128256, 4096)])
def test_gemm_splits_keep_eight_stages_a_split(sms, M, n2, K):
    ks = kernels._gemm_splits(M, n2, K, DEV)
    assert 1 <= ks <= 8
    assert ks == 1 or K // 64 // ks >= 8


@pytest.mark.parametrize("M,want", [(9, 32), (32, 32), (33, 128), (128, 128),
                                    (129, 256), (512, 256), (1024, 256)])
def test_gemm_token_tile(M, want):
    assert kernels.gemm_token_tile(M) == want


@pytest.mark.parametrize("M,n2,K,want", [
    (512, 14336, 4096, 1),    # a Mixtral expert's gate: 112 x 2 tiles
    (128, 14336, 4096, 1),    # 112 tiles: one wave either way
    (512, 4096, 14336, 2),    # an expert's down: 32 x 2 tiles
    (1024, 4096, 14336, 1),   # past the 512-token chunk: 32 x 4 tiles
    (1024, 28672, 4096, 1),
])
def test_gemm_splits_at_the_il_shapes(sms, M, n2, K, want):
    assert kernels._gemm_splits(M, n2, K, DEV) == want


#: K6's GEMM launch keys by family and group bias, on planes built here
_GEMM_KEYS = {GGMLType.IQ4_XS: "fast_byte_gemm", GGMLType.Q8_0: "fast_byte_gemm",
              GGMLType.Q6_K: "fast_byte_gemm_derived",
              GGMLType.Q5_K: "fast_byte_gemm_stored",
              GGMLType.Q4_K: "fast_nibble_gemm_stored",
              GGMLType.Q4_0: "fast_nibble_gemm_derived",
              GGMLType.IQ3_XXS: "fast_coded_gemm",
              GGMLType.IQ2_S: "fast_coded_gemm"}


@pytest.mark.parametrize("qtype", list(_GEMM_KEYS), ids=lambda t: t.name)
def test_gemm_keys_name_family_and_bias(qtype):
    g = torch.Generator()
    g.manual_seed(int(qtype))
    qt = random_qtensor(g, 128, 256, qtype, "cpu").with_fast_planes("il")
    assert qt.fl == "il"
    assert kernels.gemm_key(qt) == _GEMM_KEYS[qtype]
    assert kernels.gemm_key(qt) in kernels.GEMM_LAUNCHES
