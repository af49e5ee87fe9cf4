"""The host's split choices for K3 (K over blocks) and K4 (live cache slots
over blocks): pure functions of the shapes, so they run here without a
card.  The card's SM count is stubbed at the H100's 132."""
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels

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
