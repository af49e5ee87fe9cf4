"""The plan of the whole-FFN megakernel K9 (kernels.pick_ffn), on the CPU.

K9 (csrc/ffn_fused.cu) is one cooperative launch of persistent blocks over
three phases: wo (A), gate_up (B) and down (C), each cut into 64-row tiles
and whole stages of GW residues x NP periods (kernels.il_geo), a phase's
blocks the first nbx x ks of the grid; phase B is never split and takes
its tiles in pairs, gate tile p and up tile p + n_ff/64 (the gate and the
up of the same columns) in one block.  pick_ffn sizes each phase's splits
and blocks, the ring and the grid from the shapes and the SM count; these
tests hold it, at the Llama-3-8B widths (d = 4096, n_ff = 14336) for every
down family and B = 1, 3 and 8, to what the kernel needs: every (tile,
stage) of every phase taken by exactly one block, splits on whole stages
whose activation holds every residue block they touch, a grid the card
holds at once, the block's shared memory within the card's, and a refusal
of the shapes the kernel cannot stage.
"""
import pytest

from ggml_hexagon_tpu_torch import kernels as K

D, NFF, SMS = 4096, 14336, 132
G = D // 32

#: down planes at the 8B widths: (K, Gc, packed, stored fb, bias)
DOWNS = {
    "q4k": (NFF, NFF // 32, True, True, True),      # nibble, stored fb
    "q4_0": (NFF, NFF // 32, True, False, True),    # nibble, derived -8
    "q6k": (NFF, NFF // 16, False, False, True),    # byte, derived -32
    "q5k": (NFF, NFF // 32, False, True, True),     # byte, stored fb
    "q8_0": (NFF, NFF // 32, False, False, False),  # byte, no bias
    "iq3xxs": (NFF, NFF // 32, True, False, False),  # coded
    "iq2s": (NFF, NFF // 16, True, False, False),   # coded, gs 16
    "tern": (NFF, NFF // 256, True, False, False),  # ternary (G % 16 == 8)
}


def _plan(down, nb, sms=SMS):
    Kd, Gc, packed, fb, bias = DOWNS[down]
    return K.pick_ffn(D, G, NFF, Kd, Gc, packed, fb, bias, nb, sms)


def _phases(down, plan):
    """(geometry, tiles, ks, nbx) of phases A, B and C."""
    Kd, Gc, packed, _, _ = DOWNS[down]
    ga, gc = K.ffn_geos(D, G, Kd, Gc, packed)
    return ((ga, D // K.IL_ROWS, plan.ks_a, plan.nbx_a),
            (ga, 2 * NFF // K.IL_ROWS, plan.ks_b, plan.nbx_b),
            (gc, D // K.IL_ROWS, plan.ks_c, plan.nbx_c))


def _split(geo, ks, y):
    """Stages [s0, s1) of split y (csrc/ffn_fused.cu split_range)."""
    return y * geo.nst // ks, (y + 1) * geo.nst // ks


@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("down", list(DOWNS))
def test_pick_ffn_covers_every_row_once(down, nb):
    """Block b of phase A or C takes tiles b % nbx, + nbx, ... and the
    stages of split b // nbx; block b of phase B takes pairs b, b + nbx,
    ... (gate tile p, up tile p + n_ff/64), all stages: every (tile, stage)
    once, and the tiles cover the phase's rows (wo and down: d, gate_up:
    2 n_ff)."""
    plan = _plan(down, nb)
    assert plan.ks_b == 1
    for q, ((geo, tiles, ks, nbx), rows) in enumerate(zip(_phases(down, plan),
                                                          (D, 2 * NFF, D))):
        assert tiles * K.IL_ROWS == rows
        seen = {}
        for b in range(nbx * ks):
            bx, y = b % nbx, b // nbx
            s0, s1 = _split(geo, ks, y)
            mine = ([t for p in range(bx, tiles // 2, nbx) for t in (p, p + tiles // 2)]
                    if q == 1 else range(bx, tiles, nbx))
            for t in mine:
                for s in range(s0, s1):
                    seen[(t, s)] = seen.get((t, s), 0) + 1
        assert set(seen.values()) == {1}
        assert len(seen) == tiles * geo.nst


@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("down", list(DOWNS))
def test_pick_ffn_splits_on_whole_stages(down, nb):
    """Each split is a non-empty run of whole stages (a stage never cut),
    at most 32 of them (the kernel's split sums), and the phase's
    activation region holds the bf16 slabs of every residue block a split
    touches, all their periods (il_touched)."""
    plan = _plan(down, nb)
    Kd, Gc, _, _, bias = DOWNS[down]
    for (geo, _, ks, _), gs, b in zip(_phases(down, plan), (D // G, D // G, Kd // Gc),
                                      (True, True, bias)):
        assert 1 <= ks <= min(32, geo.nst)
        touched = 0
        for y in range(ks):
            s0, s1 = _split(geo, ks, y)
            assert s1 > s0
            touched = max(touched, (s1 - 1) // geo.spr - s0 // geo.spr + 1)
        assert touched == K.il_touched(geo, ks)
        assert K.ffn_act(geo, gs, nb, ks, b, False) >= touched * gs * nb * geo.GW * 2


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("down", list(DOWNS))
def test_pick_ffn_grid_and_smem_fit_the_card(down, nb, sms):
    """The grid is every block slot of the card and no more (per_sm blocks
    an SM, each SM's shared memory holding per_sm blocks and their 1 KB;
    the kernel's launch bounds give two an SM at most), each phase's blocks
    are within it, and the block's shared memory (ring, scale regions, the
    largest phase's activation, mbarriers: kernels.ffn_smem, the layout
    csrc/ffn_fused.cu computes) is within a block's."""
    plan = _plan(down, nb, sms)
    assert plan.per_sm in (1, 2)
    assert plan.blocks == plan.per_sm * sms
    assert plan.per_sm * (plan.smem + 1024) <= K.SMEM_SM
    assert plan.smem <= K.SMEM_BLOCK
    assert 1 <= plan.ns <= 8
    for geo, tiles, ks, nbx in _phases(down, plan):
        assert 1 <= nbx <= tiles and nbx * ks <= plan.blocks
    Kd, Gc, packed, fb, bias = DOWNS[down]
    ga, gc = K.ffn_geos(D, G, Kd, Gc, packed)
    actx = max(K.ffn_act(ga, D // G, nb, plan.ks_a, True, False),
               K.ffn_act(ga, D // G, nb, 1, True, True),
               K.ffn_act(gc, Kd // Gc, nb, plan.ks_c, bias, False))
    sb = max(ga.fsb, gc.fsb)
    assert plan.smem == K.ffn_smem(plan.ns, max(ga.wb, gc.wb), sb, actx, D)


def test_pick_ffn_two_blocks_an_sm_at_one_row():
    """At B = 1 (the decode step) every down family runs two blocks an SM,
    and phases A and C split K so that their tiles fill more than half the
    card's block slots."""
    for down in DOWNS:
        plan = _plan(down, 1)
        assert plan.per_sm == 2, down
        assert plan.ks_a * plan.nbx_a > plan.blocks // 2, down
        assert plan.ks_c * plan.nbx_c > plan.blocks // 2, down


@pytest.mark.parametrize("args", [
    (D, 64, NFF, NFF, NFF // 32, True, True, True),     # wo/gate_up G % 128
    (32 * 640, 640, NFF, NFF, NFF // 32, True, True, True),  # G > 512
    (D, G, NFF, NFF, 1792, True, False, False),         # packed gs 8
    (D, G, 1536, 1536, 6, True, False, False),          # Gc % 8 (unpadded)
    (D, G, NFF, NFF, NFF // 32 + 1, True, True, True),  # Gc does not divide K
    (D, G, 2016, 2016, 63, False, False, False),        # n_ff % 64
], ids=["wo_G64", "wo_G640", "packed_gs8", "tern_G6_unpadded", "ragged_K", "rows"])
def test_pick_ffn_refuses_what_the_kernel_cannot_stage(args):
    with pytest.raises(ValueError):
        K.pick_ffn(*args, 1, SMS)


def test_pick_ffn_takes_padded_ternary():
    """Ternary down planes whose groups are not a multiple of 8 (n_ff =
    1536, G = 6) run on their padded planes (8 groups, K = 2048), as K6's
    do (kernels.il_pad)."""
    Kp, Gp = K.il_pad(1536, 6)
    assert (Kp, Gp) == (2048, 8)
    plan = K.pick_ffn(D, G, 1536, Kp, Gp, True, False, False, 1, SMS)
    assert plan.blocks == 2 * SMS
