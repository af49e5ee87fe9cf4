"""The coded i-quants and ternary (`code_map`) in the port against the JAX
package, on the same planes and inputs.

  planes   every coded type on both layouts: t-planes byte-equal to
           `build_t_planes` (2+1 bits for iq2/iq1, 4+0 for iq3, 2+0 for
           ternary), coded nibble planes byte-equal to `build_fast_planes`
           under GHT_QP8=0; `dequantize_fast` of the wire-less tensor equal
           to the JAX one;
  t        plain K1 (raw, normed, res, act), K2 (a coded part beside a
           Q4_K part), K3 and K5 (P in {2, 5}, duplicate ids) through the
           port's entries against the JAX entries with interpret=True;
  il       plain K6 (plain, pre_il, normed, res, act), K7 (a coded IQ2_S
           part beside a Q4_K nibble part) and K8 (P in {2, 16}) the same
           way, under GHT_QP8=0;
  decode   `decode_codes` / `_decode_cm` against the JAX functions on every
           code;
  synth    `random_qtensor` on every coded type (alphabet values, the
           checkpoint RMS rule) and the port's QuantPolicy against the JAX
           one for the low-bit i-quant mixtures at the full-size shapes.

One type for each code map: IQ2_S (iq2, groups of 16), IQ3_XXS, IQ3_S, IQ1_S
(iq1) and TQ2_0 (ternary, groups of 256, whose t-layout needs K >= 2048).
The weights are drawn as alphabet values with numpy (`coded_qtensor`), not
through the JAX encoders.  Tolerance rtol = atol = 5e-4, the JAX package's
kernel-vs-oracle tolerance; the normed cases take inputs whose RMS factor
is exact in both packages (`normed_input`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.ops import qmm_fast as JF
from ggml_hexagon_tpu.ops import qmm_qp8 as JP
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.quant.pack import quantize_tensor

from _torch_port import CODE_VALUES, coded_qtensor, normed_input, port_qt
from ggml_hexagon_tpu_torch.models.synth import random_qtensor
from ggml_hexagon_tpu_torch.ops import qmm_fast as PF
from ggml_hexagon_tpu_torch.ops import qmm_qp8 as P

TOL = dict(rtol=5e-4, atol=5e-4)
CODED = [GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS,
         GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M, GGMLType.TQ1_0,
         GGMLType.TQ2_0]
#: one type for each code map
KTYPES = [GGMLType.IQ2_S, GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S,
          GGMLType.TQ2_0]
_QT = {}


def _k(qtype):
    return 2048 if qtype in (GGMLType.TQ1_0, GGMLType.TQ2_0) else 1024


def _planes(qt, layout):
    """The JAX package's matmul planes of a wire QTensor on `layout`."""
    with pytest.MonkeyPatch.context() as mp:
        if layout == "il":
            mp.setenv("GHT_QP8", "0")
        jq = qt.astype_device(fast=True)
    assert jq.fl == layout, (qt.cfg.qtype.name, jq.fl)
    return jq


def _qt(qtype, n, layout, seed=0):
    """(JAX QTensor with matmul planes, port twin), cached."""
    key = (qtype, n, layout, seed)
    if key not in _QT:
        jq = _planes(coded_qtensor(qtype, n, _k(qtype), seed), layout)
        _QT[key] = (jq, port_qt(jq))
    return _QT[key]


def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    t = np.asarray(t)
    return t.view(np.uint16) if t.dtype.name == "bfloat16" else t


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cm", ["iq2", "iq3xxs", "iq3s", "iq1", "tern"])
def test_decode_codes_match_jax(cm):
    n = np.arange(16, dtype=np.int32)
    want = JF.decode_codes(cm, n)
    np.testing.assert_array_equal(
        P.decode_codes(cm, torch.from_numpy(n)).numpy(), want)
    pb = {"iq2": (2, 1), "iq1": (2, 1), "tern": (2, 0)}.get(cm, (4, 0))
    w = np.arange(1 << sum(pb), dtype=np.int32)
    np.testing.assert_array_equal(
        P._decode_cm(cm, pb, torch.from_numpy(w)).numpy(),
        np.asarray(JP._decode_cm(cm, pb, jnp.asarray(w))).astype(np.int32))


@pytest.mark.parametrize("qtype", CODED, ids=lambda t: t.name)
@pytest.mark.parametrize("layout", ["t", "il"])
def test_planes_byte_equal_and_dequant(qtype, layout):
    qt = coded_qtensor(qtype, 300, _k(qtype), seed=1)
    jq = _planes(qt, layout)
    pq = port_qt(qt)
    got = (P.build_t_planes(pq) if layout == "t"
           else PF.build_fast_planes(pq))
    for name, g in zip(("fq", "fs", "fb"), got):
        w = getattr(jq, name)
        if w is None:
            assert g is None, name
            continue
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert pq.with_fast_planes(layout).fl == layout
    want = np.asarray(JF.dequantize_fast(jq.without_wire()))
    mine = PF.dequantize_fast(port_qt(jq).without_wire()).numpy()
    np.testing.assert_array_equal(mine, want)


# ---------------------------------------------------------------------------
# t-planes: K1, K2, K3, K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qtype", KTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("mode", ["raw", "normed", "res", "act"])
@pytest.mark.parametrize("B", [1, 8])
def test_k1_plain_matches_pallas(qtype, mode, B):
    jq, pq = _qt(qtype, 512, "t")
    K, n = jq.k, jq.n
    x = _rand(B * 3 + K, B, 2 * K if mode == "act" else K)
    wn = np.random.default_rng(5).random(K).astype(np.float32) + 0.5
    res = _rand(9, B, n)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if mode == "raw":
        want = JP.qp8_matmul(xj, jq, interpret=True)
        got = P.qp8_matmul(xt, pq)
    elif mode == "normed":
        x, eps = normed_input(B + K, B, K)
        want = JP.qp8_matmul_normed(jnp.asarray(x), jq, jnp.asarray(wn), eps,
                                    interpret=True)
        got = P.qp8_matmul_normed(torch.from_numpy(x), pq,
                                  torch.from_numpy(wn), eps)
    elif mode == "res":
        want = JP.qp8_matmul_res(xj, jq, jnp.asarray(res), interpret=True)
        got = P.qp8_matmul_res(xt, pq, torch.from_numpy(res))
    else:
        want = JP.qp8_matmul_act(xj, jq, "silu", res=jnp.asarray(res),
                                 interpret=True)
        got = P.qp8_matmul_act(xt, pq, "silu", res=torch.from_numpy(res))
    assert got.shape == (B, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B", [1, 4])
def test_k2_coded_and_q4k_plain_matches_pallas(B):
    """The Llama IQ3_XXS QKV: an IQ2_S wqk part beside a Q4_K wv part in one
    shared prologue."""
    ja, pa = _qt(GGMLType.IQ2_S, 1024, "t", seed=2)
    rng = np.random.default_rng(3)
    jb = quantize_tensor(rng.normal(size=(512, 1024)).astype(np.float32)
                         * 0.03, GGMLType.Q4_K).astype_device(fast=True)
    pb = port_qt(jb)
    assert P.supports_qp8_dual(pa, pb)
    x, eps = normed_input(B + 40, B, 1024)
    wn = np.random.default_rng(12).random(1024).astype(np.float32) + 0.5
    want = JP.qp8_matmul_dual(jnp.asarray(x), ja, jb, wn=jnp.asarray(wn),
                              eps=eps, interpret=True)
    got = P.qp8_matmul_dual(torch.from_numpy(x), pa, pb,
                            wn=torch.from_numpy(wn), eps=eps)
    assert got.shape == (B, 1536)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", KTYPES, ids=lambda t: t.name)
def test_k3_plain_matches_pallas(qtype):
    jq, pq = _qt(qtype, 512, "t")
    x = _rand(13, 16, jq.k)
    want = JP.qp8_matmul(jnp.asarray(x, jnp.bfloat16), jq, interpret=True)
    got = P.qp8_matmul(torch.from_numpy(x).to(torch.bfloat16), pq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", KTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("ids", [[2, 0], [3, 1, 0, 3, 2], [1, 1]],
                         ids=["P2", "P5", "P2_dup"])
def test_k5_plain_matches_pallas(qtype, ids):
    npe = 256
    jq, pq = _qt(qtype, 4 * npe, "t", seed=4)
    assert JP.supports_qp8_indirect(jq, npe) and P.supports_qp8_indirect(pq, npe)
    x = _rand(len(ids), len(ids), jq.k)
    ids = np.asarray(ids, np.int32)
    want = JP.qp8_matmul_indirect(jnp.asarray(x), jq, jnp.asarray(ids), npe,
                                  interpret=True)
    got = P.qp8_matmul_indirect(torch.from_numpy(x), pq,
                                torch.from_numpy(ids), npe)
    assert got.shape == (len(ids), npe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# coded nibble planes: K6, K7, K8
# ---------------------------------------------------------------------------

def _mode_call(mod, mode, x, qt, wn_il, res, eps, **kw):
    if mode == "plain":
        return mod.qmatmul_fast(x, qt, **kw)
    if mode == "pre_il":
        return mod.qmatmul_fast(x, qt, pre_interleaved=True, **kw)
    if mode == "normed":
        return mod.qmatmul_fast_normed(x, qt, wn_il, eps, **kw)
    if mode == "res":
        return mod.qmatmul_fast_res(x, qt, res, **kw)
    return mod.qmatmul_fast_act(x, qt, "silu", res=res, **kw)


#: (mode, rows): every mode at decode, the prefill's modes at 16 rows (the
#: residual and act modes are decode modes)
K6_CASES = [(m, 1) for m in ("plain", "pre_il", "normed", "res", "act")] + [
    (m, 16) for m in ("plain", "pre_il", "normed")]


@pytest.mark.parametrize("qtype", KTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("mode,B", K6_CASES, ids=lambda c: str(c))
def test_k6_plain_matches_pallas(qtype, mode, B):
    jq, pq = _qt(qtype, 512, "il")
    K = jq.k
    x = _rand(B * 5 + K, B, 2 * K if mode == "act" else K) * 1.5
    eps = 1e-5
    if mode == "normed":
        x, eps = normed_input(B * 5 + K, B, K)
    wn = np.random.default_rng(K).random(K).astype(np.float32) + 0.5
    wn_il = wn[JF.interleave_perm(K, jq.cfg.gs)]
    res = _rand(B + 3, B, jq.n) if mode in ("res", "act") else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_QP8", "0")
        want = _mode_call(JF, mode, jnp.asarray(x), jq, jnp.asarray(wn_il),
                          None if res is None else jnp.asarray(res), eps,
                          interpret=True)
    got = _mode_call(PF, mode, torch.from_numpy(x), pq,
                     torch.from_numpy(wn_il),
                     None if res is None else torch.from_numpy(res), eps)
    assert got.shape == (B, jq.n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("normed", [True, False], ids=["normed", "raw"])
def test_k7_coded_and_nibble_plain_matches_pallas(B, normed):
    """The Llama IQ3_XXS il QKV: a coded IQ2_S wqk part (groups of 16)
    beside a Q4_K nibble wv part with its stored bias, in one launch."""
    ja, pa = _qt(GGMLType.IQ2_S, 1024, "il", seed=2)
    rng = np.random.default_rng(6)
    jb = _planes(quantize_tensor(rng.normal(size=(512, 1024)).astype(
        np.float32) * 0.03, GGMLType.Q4_K), "il")
    pb = port_qt(jb)
    assert JF.supports_dual(ja, jb) and PF.supports_dual(pa, pb)
    x = _rand(B + 7, B, 1024) * 1.5
    kw = {}
    if normed:
        x, eps = normed_input(B + 7, B, 1024)
        kw = dict(eps=eps)
    wn = np.random.default_rng(5).random(1024).astype(np.float32) + 0.5
    wa, wb = wn[JF.interleave_perm(1024, 16)], wn[JF.interleave_perm(1024, 32)]
    want = JF.qmatmul_fast_dual(
        jnp.asarray(x), ja, jb, jnp.asarray(wa) if normed else None,
        jnp.asarray(wb) if normed else None, interpret=True, **kw)
    got = PF.qmatmul_fast_dual(
        torch.from_numpy(x), pa, pb, torch.from_numpy(wa) if normed else None,
        torch.from_numpy(wb) if normed else None, **kw)
    assert got.shape == (B, 1536)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", KTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("ids", [[2, 0], [1, 3, 0, 2, 2, 1, 0, 3] * 2],
                         ids=["P2", "P16"])
def test_k8_plain_matches_pallas(qtype, ids):
    npe = 256
    jq, pq = _qt(qtype, 4 * npe, "il", seed=4)
    assert PF.supports_indirect(pq, npe) and JF.supports_indirect(jq, npe)
    x = _rand(len(ids), len(ids), jq.k) * 1.5
    ids = np.asarray(ids, np.int32)
    want = JF.qmatmul_fast_indirect(jnp.asarray(x), jq, jnp.asarray(ids), npe,
                                    interpret=True)
    got = PF.qmatmul_fast_indirect(torch.from_numpy(x), pq,
                                   torch.from_numpy(ids), npe)
    assert got.shape == (len(ids), npe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _tern_1024(qtype, n, seed):
    """Ternary planes at K = 1024: G = 4 groups of 256, which the card's K6
    and K8 take padded to 8 (kernels.padded_il_planes)."""
    key = (qtype, n, "il1024", seed)
    if key not in _QT:
        jq = _planes(coded_qtensor(qtype, n, 1024, seed), "il")
        assert jq.fs.shape[1] == 4
        _QT[key] = (jq, port_qt(jq))
    return _QT[key]


@pytest.mark.parametrize("qtype", [GGMLType.TQ1_0, GGMLType.TQ2_0],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("mode,B", [(m, b) for b in (1, 16)
                                    for m in ("plain", "normed")],
                         ids=lambda c: str(c))
def test_k6_ternary_g4_plain_matches_pallas(qtype, mode, B):
    """K6 on ternary planes at K = 1024 (G = 4) at a decode row and a
    16-row prefill, plain and normed."""
    jq, pq = _tern_1024(qtype, 256, 6)
    K = jq.k
    x, eps = _rand(B * 11 + K, B, K) * 1.5, 1e-5
    if mode == "normed":
        x, eps = normed_input(B * 11 + K, B, K)
    wn = np.random.default_rng(K + 1).random(K).astype(np.float32) + 0.5
    wn_il = wn[JF.interleave_perm(K, jq.cfg.gs)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_QP8", "0")
        want = _mode_call(JF, mode, jnp.asarray(x), jq, jnp.asarray(wn_il),
                          None, eps, interpret=True)
    got = _mode_call(PF, mode, torch.from_numpy(x), pq,
                     torch.from_numpy(wn_il), None, eps)
    assert got.shape == (B, jq.n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qtype", [GGMLType.TQ1_0, GGMLType.TQ2_0],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("ids", [[1], [2, 0, 3, 1] * 4], ids=["P1", "P16"])
def test_k8_ternary_g4_plain_matches_pallas(qtype, ids):
    """K8 on stacked ternary planes at K = 1024 (G = 4), one and 16 rows."""
    npe = 256
    jq, pq = _tern_1024(qtype, 4 * npe, 7)
    assert PF.supports_indirect(pq, npe) and JF.supports_indirect(jq, npe)
    x = _rand(len(ids) + 50, len(ids), jq.k) * 1.5
    ids = np.asarray(ids, np.int32)
    want = JF.qmatmul_fast_indirect(jnp.asarray(x), jq, jnp.asarray(ids), npe,
                                    interpret=True)
    got = PF.qmatmul_fast_indirect(torch.from_numpy(x), pq,
                                   torch.from_numpy(ids), npe)
    assert got.shape == (len(ids), npe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_coded_wrappers_take_plain_only_on_cpu():
    """On CPU tensors the coded K6 wrapper is its plain version, bit for
    bit, and the uncoded family wrappers refuse coded planes."""
    _, pq = _qt(GGMLType.IQ3_XXS, 512, "il")
    x = torch.from_numpy(_rand(3, 2, 1024)).to(torch.bfloat16)
    torch.testing.assert_close(PF.fast_coded(x, pq),
                               PF.fast_coded_plain(x, pq), rtol=0, atol=0)
    for plain in (PF.fast_nibble_plain, PF.fast_byte_plain):
        with pytest.raises(ValueError):
            plain(x, pq)


# ---------------------------------------------------------------------------
# the synthetic models' repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qtype", CODED, ids=lambda t: t.name)
def test_random_coded_weights_lie_in_the_alphabet_with_checkpoint_rms(qtype):
    """models.synth.random_qtensor draws a coded type's values as a sign
    times a magnitude of its alphabet (ternary: -1..2), which the t-plane
    and coded nibble encoders take, with one scale a group sized so the
    weights keep the checkpoint rule of the other types (mean within 5% of
    the RMS, RMS within 10% of 1/sqrt(K))."""
    K = 4096
    g = torch.Generator().manual_seed(int(qtype))
    qt = random_qtensor(g, 256, K, qtype, "cpu")
    cm = qt.cfg.code_map
    vals = np.asarray(CODE_VALUES[cm])
    if cm != "tern":
        vals = np.concatenate([vals, -vals])
    assert qt.q.dtype == torch.int8 and qt.d.shape == (256, K // qt.cfg.gs)
    assert np.isin(qt.q.numpy(), vals).all()
    assert len(np.unique(qt.q.numpy())) == len(np.unique(vals))
    w = PF.dequantize_fast(qt.with_fast_planes("il"))[:256]
    rms = float(w.pow(2).mean().sqrt())
    assert abs(float(w.mean())) < 0.05 * rms
    assert abs(rms * K ** 0.5 - 1) < 0.1, rms * K ** 0.5


@pytest.mark.parametrize("ftype", ["IQ3_XXS", "IQ2_XS", "IQ2_S"])
@pytest.mark.parametrize("has_imatrix", [False, True],
                         ids=["no_imatrix", "imatrix"])
@pytest.mark.parametrize("model", ["llama3_8b", "mixtral_8x7b"])
def test_policy_matches_jax(ftype, has_imatrix, model):
    """The port's QuantPolicy picks the JAX package's type for every tensor
    of the full-size model, with and without an importance matrix."""
    from ggml_hexagon_tpu.quant.policy import QuantPolicy as JPolicy
    from ggml_hexagon_tpu_torch.models.synth import LLAMA3_8B, MIXTRAL_8X7B
    from ggml_hexagon_tpu_torch.quant.policy import QuantPolicy as PPolicy

    c = LLAMA3_8B if model == "llama3_8b" else MIXTRAL_8X7B
    L, d, E = c["n_layer"], c["n_embd"], c.get("n_expert", 0)
    nff = c["n_ff"]
    kw = dict(n_gqa=c["n_head"] // c["n_head_kv"], n_expert=max(E, 1),
              has_imatrix=has_imatrix)
    jp, pp = JPolicy(ftype, L, **kw), PPolicy(ftype, L, **kw)
    nq, nk = d, c["n_head_kv"] * (d // c["n_head"])
    shapes = {"token_embd.weight": (c["n_vocab"], d),
              "output.weight": (c["n_vocab"], d)}
    for il in range(L):
        p = f"blk.{il}."
        shapes.update({p + "attn_q.weight": (nq, d), p + "attn_k.weight": (nk, d),
                       p + "attn_v.weight": (nk, d),
                       p + "attn_output.weight": (d, nq)})
        ffn = ((("ffn_gate_exps", E * nff, d), ("ffn_up_exps", E * nff, d),
                ("ffn_down_exps", E * d, nff)) if E else
               (("ffn_gate", nff, d), ("ffn_up", nff, d), ("ffn_down", d, nff)))
        shapes.update({f"{p}{n}.weight": (r, k) for n, r, k in ffn})
    for name, shape in shapes.items():
        assert int(pp.tensor_type(name, shape)) == int(
            jp.tensor_type(name, shape)), name


def test_concat_rebuilds_padded_t_parts_interleaved_like_jax():
    """Repair: fusing coded t-plane parts whose planes are padded (a 256-row
    IQ2_S wk takes 512 lanes) rebuilt them as t-planes; the JAX package
    rebuilds from its device-resident wire, which takes the interleaved
    layout, and the port now does the same, byte for byte."""
    from ggml_hexagon_tpu.models import fuse as JFU
    from ggml_hexagon_tpu_torch.models import fuse as PFU

    parts = [_qt(GGMLType.IQ2_S, n, "t", seed=8)[0] for n in (1024, 256)]
    assert parts[1].fq.shape[1] == 512                   # padded lanes
    want = JFU._concat_qtensors(parts)
    got = PFU._concat_qtensors([port_qt(p) for p in parts])
    assert got.fl == want.fl == "il" and got.n == want.n == 1280
    for f in ("fq", "fs", "fb"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if g is not None:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)
