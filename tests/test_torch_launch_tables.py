"""The launch tables derived from a model's layers
(ggml_hexagon_tpu_torch/models/launches.py, which chip_smoke.py holds every
configuration's serving run to) against the tables the chip script held
its eleven synthetic configurations to by hand before: at full depth, on
models built on the meta device (shapes, types and layouts; no values),
every entry equal, exactly.  Then Gemma-2-9B Q4_K_M's table, counted by
hand from its Q4_K_M types, and a depth cut's table (the first layers of
the full-depth file, as chip_smoke.py's phases run them); the cut
chip_smoke.py runs holds every tensor type of each full file, and the
script refuses a shorter one."""
import subprocess
import sys
from functools import partial
from pathlib import Path

import pytest

from ggml_hexagon_tpu_torch.models import synth as S
from ggml_hexagon_tpu_torch.models.launches import launch_table

#: exact launches of each configuration per unit, as chip_smoke.py held
#: them by hand: "step" a decode step, "bucket8" the 8-token prefill chunk,
#: "chunk" a 128- or 512-token chunk.  Derived from the JAX dispatch
#: (llama.py:620-799, 1022-1068, 1196-1213; qmm_fast.py supports_dual,
#: supports_fused_epilogue, supports_indirect) under each configuration's
#: QuantPolicy.
LAUNCH_TABLES = {
    # wqkv (16 layers) or wqk + wv through K2 (16), wo+res, gate_up, act +
    # down, the head: all t-planes (K1 at <= 8 rows, K3 above)
    "Llama-3-8B Q4_K_M": {
        "step": dict(qp8_gemv=113, qp8_dual=16, decode_attn=32),
        "bucket8": dict(qp8_gemv=145),
        "chunk": dict(qp8_gemm=145),
    },
    # wq, wo and the head on Q5_K/Q6_K t-planes; wk, wv on Q8_0 interleaved
    # planes (K6); the experts gathered at <= 8 rows (K5: gate, up, down),
    # else every expert's gate, up and down through K3
    "Mixtral-8x7B Q5_K_M": {
        "step": dict(qp8_gemv=65, qp8_indirect=96, fast_byte=64,
                     decode_attn=32),
        "bucket8": dict(qp8_gemv=65, qp8_indirect=96, fast_byte=64),
        "chunk": dict(qp8_gemm=833, fast_byte=64),
    },
    # wqk IQ4_XS il + wv Q5_K t (no dual on mixed layouts): 32 K6 normed +
    # 32 K1 normed; wo IQ4_XS il: 32 K6 res; gate_up IQ4_XS il: 32 K6
    # normed; down Q5_K t in layers 0-3 (K1 act) and IQ4_XS il in 4-31 (K6
    # act); the Q6_K head on K1
    "Llama-3-8B IQ4_XS": {
        "step": dict(fast_byte_normed=64, fast_byte_res=32, fast_byte_act=28,
                     qp8_gemv=37, decode_attn=32),
        "bucket8": dict(fast_byte_normed=64, fast_byte=32, fast_byte_act=28,
                        qp8_gemv=37),
        "chunk": dict(fast_byte_normed=64, fast_byte=60, qp8_gemm=37),
    },
    # wq IQ4_XS, wk/wv Q8_0, all il and unfused: 96 K6; wo Q5_K and the
    # head on K1/K3; gate/up IQ4_XS stacks (K8) and down stacks Q5_K in
    # layers 0-3 (K5) and IQ4_XS in 4-31 (K8) gathered at <= 8 rows, every
    # expert's gate, up and down through K6 / K3 above
    "Mixtral-8x7B IQ4_XS": {
        "step": dict(fast_byte=96, fast_indirect=92, qp8_indirect=4,
                     qp8_gemv=33, decode_attn=32),
        "bucket8": dict(fast_byte=96, fast_indirect=92, qp8_indirect=4,
                        qp8_gemv=33),
        "chunk": dict(fast_byte=832, qp8_gemm=65),
    },
    # the interleaved layout everywhere: wqkv (16 layers, Q4_K) and gate_up
    # through K6 nibble normed, wqk Q4_K + wv Q6_K through K7 (16), wo
    # through K6 nibble res; down Q4_K (16) K6 nibble act, Q6_K (16) K6
    # byte act with the derived bias; the Q6_K head K6 byte.  At prefill no
    # dual: wqk K6 nibble normed and wv K6 byte normed, wo K6 nibble; at the
    # 8-bucket the act modes, above it down pre-interleaved through K6
    "Llama-3-8B Q4_K_M il": {
        "step": dict(fast_nibble_normed=48, fast_nibble_res=32,
                     fast_nibble_act=16, fast_byte_act=16, fast_byte=1,
                     fast_dual=16, decode_attn=32),
        "bucket8": dict(fast_nibble_normed=64, fast_byte_normed=16,
                        fast_nibble=32, fast_nibble_act=16, fast_byte_act=16,
                        fast_byte=1),
        "chunk": dict(fast_nibble_normed=64, fast_byte_normed=16,
                      fast_nibble=48, fast_byte=17),
    },
    # wq Q4_K K6 nibble, wk/wv Q8_0 and the Q6_K head K6 byte, wo Q5_K K6
    # byte res (stored bias; plain mode above one token); gate/up Q4_K
    # stacks and down stacks Q4_K (16 layers) through K8 nibble, Q6_K (16)
    # through K8 byte, at <= 8 rows; every expert's gate, up and down through
    # K6 above
    "Mixtral-8x7B Q4_K_M il": {
        "step": dict(fast_nibble=32, fast_byte=65, fast_byte_res=32,
                     fast_indirect_nibble=80, fast_indirect=16,
                     decode_attn=32),
        "bucket8": dict(fast_nibble=32, fast_byte=97,
                        fast_indirect_nibble=80, fast_indirect=16),
        "chunk": dict(fast_nibble=672, fast_byte=225),
    },
    # the coded i-quants (IQ3_XXS with an imatrix) on t-planes: IQ2_S wqk +
    # Q4_K wv through K2 at decode (at prefill one normed K1/K3 each), IQ3_S
    # wo (K1 res), IQ3_XXS gate_up (normed) and down (act), all coded; the
    # Q5_K head on K1 (K3 above the 8-bucket)
    "Llama-3-8B IQ3_XXS": {
        "step": dict(qp8_dual_coded=32, qp8_gemv_coded=96, qp8_gemv=1,
                     decode_attn=32),
        "bucket8": dict(qp8_gemv_coded=128, qp8_gemv=33),
        "chunk": dict(qp8_gemm_coded=128, qp8_gemm=33),
    },
    # the same on interleaved planes: K7 on the coded wqk + the Q4_K nibble
    # wv, K6 coded res / normed / act; at prefill wqk K6 coded normed, wv K6
    # nibble normed, wo K6 coded, down K6 coded act (8-bucket) or
    # pre-interleaved (chunk); the Q5_K head K6 byte with its stored bias
    "Llama-3-8B IQ3_XXS il": {
        "step": dict(fast_dual_coded=32, fast_coded_res=32,
                     fast_coded_normed=32, fast_coded_act=32, fast_byte=1,
                     decode_attn=32),
        "bucket8": dict(fast_coded_normed=64, fast_nibble_normed=32,
                        fast_coded=32, fast_coded_act=32, fast_byte=1),
        "chunk": dict(fast_coded_normed=64, fast_nibble_normed=32,
                      fast_coded=64, fast_byte=1),
    },
    # IQ2_S wq K6 coded, Q8_0 wk/wv and the Q5_K head K6 byte, Q5_K wo K6
    # byte res (plain mode above one token); the IQ3_XXS stacks through K8
    # coded at <= 8 rows, every expert's gate, up and down through K6 coded
    # above
    "Mixtral-8x7B IQ3_XXS il": {
        "step": dict(fast_coded=32, fast_byte=65, fast_byte_res=32,
                     fast_indirect_coded=96, decode_attn=32),
        "bucket8": dict(fast_coded=32, fast_byte=97, fast_indirect_coded=96),
        "chunk": dict(fast_coded=800, fast_byte=97),
    },
    # IQ2_S wq on coded t-planes (K1 / K3), Q8_0 wk/wv K6 byte, Q5_K wo and
    # head K1 / K3; the IQ3_XXS stacks through K5 coded at <= 8 rows, every
    # expert through K3 coded above
    "Mixtral-8x7B IQ3_XXS": {
        "step": dict(qp8_gemv_coded=32, qp8_gemv=33, fast_byte=64,
                     qp8_indirect_coded=96, decode_attn=32),
        "bucket8": dict(qp8_gemv_coded=32, qp8_gemv=33, fast_byte=64,
                        qp8_indirect_coded=96),
        "chunk": dict(qp8_gemm_coded=800, qp8_gemm=33, fast_byte=64),
    },
    # the interleaved layout with the megakernel layout on every layer: at
    # decode one K9 a layer (down Q4_K in 16 layers, Q6_K in 16) after wqkv
    # (K6 nibble normed, 16) or wqk + wv (K7, 16) and K4; the Q6_K head K6
    # byte.  At prefill no K9 and no act mode, at any bucket: wo K6 nibble
    # (its output un-permuted), gate_up K6 nibble normed, down K6
    # pre-interleaved (nibble 16, byte 16)
    "Llama-3-8B Q4_K_M il ffn": {
        "step": dict(ffn_fused_nibble=16, ffn_fused_byte=16,
                     fast_nibble_normed=16, fast_dual=16, fast_byte=1,
                     decode_attn=32),
        "bucket8": dict(fast_nibble_normed=64, fast_byte_normed=16,
                        fast_nibble=48, fast_byte=17),
        "chunk": dict(fast_nibble_normed=64, fast_byte_normed=16,
                      fast_nibble=48, fast_byte=17),
    },
}


#: exact K6 GEMM launches (kernels.GEMM_LAUNCHES) of each configuration's
#: 128- or 512-token prefill chunk, from its "chunk" entry above: the K6
#: launches of more than 8 rows by family and bias (the prefill takes the
#: head's logits on every row of the chunk); none at decode or the
#: 8-bucket
GEMM_TABLES = {
    "Mixtral-8x7B Q5_K_M": dict(fast_byte_gemm=64),            # wk, wv Q8_0
    "Llama-3-8B IQ4_XS": dict(fast_byte_gemm=124),             # IQ4_XS
    "Mixtral-8x7B IQ4_XS": dict(fast_byte_gemm=832),           # and Q8_0
    # wqkv, wqk, gate_up, wo, down Q4_K; wv, down and the head Q6_K
    "Llama-3-8B Q4_K_M il": dict(fast_nibble_gemm_stored=112,
                                 fast_byte_gemm_derived=33),
    # wq and the Q4_K experts; wk, wv Q8_0; wo Q5_K; the Q6_K down experts
    # and head
    "Mixtral-8x7B Q4_K_M il": dict(fast_nibble_gemm_stored=672,
                                   fast_byte_gemm=64,
                                   fast_byte_gemm_stored=32,
                                   fast_byte_gemm_derived=129),
    # wqk, gate_up, wo, down; wv Q4_K; the Q5_K head
    "Llama-3-8B IQ3_XXS il": dict(fast_coded_gemm=128,
                                  fast_nibble_gemm_stored=32,
                                  fast_byte_gemm_stored=1),
    # wq and the experts; wk, wv Q8_0; wo and the head Q5_K
    "Mixtral-8x7B IQ3_XXS il": dict(fast_coded_gemm=800, fast_byte_gemm=64,
                                    fast_byte_gemm_stored=33),
    "Mixtral-8x7B IQ3_XXS": dict(fast_byte_gemm=64),           # wk, wv Q8_0
    "Llama-3-8B Q4_K_M il ffn": dict(fast_nibble_gemm_stored=112,
                                     fast_byte_gemm_derived=33),
}


#: the configurations' build functions, as chip_smoke.py runs them
BUILDERS = {
    "Llama-3-8B Q4_K_M": S.build_8b,
    "Mixtral-8x7B Q5_K_M": S.build_mixtral,
    "Llama-3-8B IQ4_XS": S.build_8b_iq4xs,
    "Mixtral-8x7B IQ4_XS": S.build_mixtral_iq4xs,
    "Llama-3-8B Q4_K_M il": S.build_8b_il,
    "Mixtral-8x7B Q4_K_M il": S.build_mixtral_q4km_il,
    "Llama-3-8B IQ3_XXS": partial(S.build_8b_iq3xxs, "t"),
    "Llama-3-8B IQ3_XXS il": partial(S.build_8b_iq3xxs, "il"),
    "Mixtral-8x7B IQ3_XXS il": partial(S.build_mixtral_iq3xxs, "il"),
    "Mixtral-8x7B IQ3_XXS": partial(S.build_mixtral_iq3xxs, "t"),
    "Llama-3-8B Q4_K_M il ffn": partial(S.build_8b_il, ffn_fused=True),
}


@pytest.mark.parametrize("name", list(LAUNCH_TABLES))
def test_derived_table_equals_the_hand_written_one(name):
    cfg, weights = BUILDERS[name](device="meta")
    assert cfg.n_layer == len(weights["layers"]) == 32
    got = launch_table(cfg, weights)
    for unit in ("step", "bucket8", "chunk"):
        assert got[unit] == LAUNCH_TABLES[name][unit], unit
    assert got["gemm"] == GEMM_TABLES.get(name, {})
    # silu, D = 128: no branch key
    assert not any(k.endswith(("_gelu", "_relu", "_d256"))
                   for unit in ("step", "bucket8", "chunk") for k in got[unit])


def test_gemma2_9b_table():
    """42 layers: Q6_K attn_v (wqk + wv, K2) in the 21 _use_more_bits
    layers, wqkv (K1 normed) in the others; wo raw (the post-norms keep the
    residual out); gate_up normed; the downs in K1's gelu act mode; the
    tied Q6_K head; K4 at D = 256 every layer."""
    cfg, weights = S.build_gemma2_9b(device="meta")
    got = launch_table(cfg, weights)
    assert got["step"] == dict(qp8_gemv=21 + 42 * 2 + 1, qp8_gemv_gelu=42,
                               qp8_dual=21, decode_attn_d256=42)
    assert got["bucket8"] == dict(qp8_gemv=21 + 2 * 21 + 42 * 2 + 1,
                                  qp8_gemv_gelu=42)
    assert got["chunk"] == dict(qp8_gemm=21 + 2 * 21 + 42 * 3 + 1)
    assert got["gemm"] == {}
    q4 = launch_table(cfg, weights, kv_bits=4)
    assert (q4["step"]["decode_attn_q4_d256"] == 42
            and "decode_attn_d256" not in q4["step"])


def test_depth_cut_keeps_the_full_files_types():
    """The first 8 layers of the 8B Q4_K_M: the _use_more_bits layers of a
    32-layer file (0-3 and 6: Q6_K attn_v and ffn_down), not those of an
    8-layer one."""
    cfg, weights = S.build_8b(device="meta", depth=8)
    assert cfg.n_layer == 8
    got = launch_table(cfg, weights)
    assert got["step"] == dict(qp8_gemv=3 + 8 * 3 + 1, qp8_dual=5,
                               decode_attn=8)
    assert got["chunk"] == dict(qp8_gemm=3 + 2 * 5 + 8 * 3 + 1)


def _types(weights):
    return {(key, v.cfg.qtype.name) for lw in weights["layers"]
            for key, v in lw.items() if hasattr(v, "cfg")}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_phase_depth_holds_every_type_of_the_full_file(name):
    """chip_smoke.py's phases 2-12 run the first PHASE_DEPTH layers: every
    (tensor, type) pair of the full-depth file is among them, so each
    phase's checks find a layer of every type they look for."""
    import chip_smoke

    _, cut = BUILDERS[name](device="meta", depth=chip_smoke.PHASE_DEPTH)
    _, full = BUILDERS[name](device="meta")
    assert _types(cut) == _types(full)


@pytest.mark.parametrize("depth", [-1, 1, 2, 7, 33])
def test_chip_smoke_refuses_a_cut_its_checks_cannot_run(depth):
    """--depth below PHASE_DEPTH (the 8B's layers 0-3 hold Q6_K downs
    only) or past the configurations' 32 layers exits 2 with a message,
    before it looks for a card, and prints no result."""
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "chip_smoke.py", "--depth",
                        str(depth)], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2, r.stderr
    assert f"--depth {depth}: give 8 to 32" in r.stderr
    assert r.stdout == ""
