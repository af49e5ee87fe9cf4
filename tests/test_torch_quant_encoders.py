"""The port's encoders, decoders and i-quant expansion against the JAX
package's (ggml_hexagon_tpu_torch/quant/ref_numpy.py, iquants.py,
pack.py, stats.py, gguf/writer.py and reader.py against their JAX
originals).

- Every encoder of the port's QUANTIZE table, and every imatrix encoder of
  QUANTIZE_IMATRIX with quant_weights, byte-equal to the JAX
  ref_numpy.quantize on the same values (1-4 super-blocks a case for the
  i-quants, whose searches run ~20 k weights/s here).
- Every decoder of DEQUANTIZE bit-equal to JAX's on random wire bytes
  (every bit pattern, NaN and inf scales included: the same code on both
  sides).
- expand_to_planes of the port's numpy copy, and the torch expansion
  pack.expand_wire (run here on the CPU, on the card in chip_smoke.py),
  byte-equal to the JAX expand_to_planes for the nine expand types; the
  torch one also on uniform random bytes, where the NaN scales may differ
  in their payload only.
- pack_tensor on each expand type (rows padded) byte-equal to the JAX
  pack_tensor, quantize_tensor to JAX's, tensor_stats to JAX's, and the
  GGUF writer's quantizing add_tensor and the reader's tensor_f32 on
  i-quant files to JAX's.
- The CLI's quantize on a tiny f32 model (Q4_K_M, Q4_0, Q2_K, and
  IQ3_XXS with an importance matrix) writes the JAX CLI's file byte for
  byte, re-quantizes an i-quant file as it does, and quantize-stats
  prints its lines; the quantized IQ3_XXS file's planes and forward
  against the JAX package's.
- synth.write_gguf of every ftype (finite, centred weights of the
  policy's types) and LLAMA3_70B's first layers and decode launches.
The i-quant encoders build their neighbour tables once a process, so the
encoder, CLI and forward tests share one file (one xdist worker).
"""
import io

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread)
from ggml_hexagon_tpu.gguf.reader import GGUFReader as JReader
from ggml_hexagon_tpu.gguf.writer import GGUFWriter as JWriter
from ggml_hexagon_tpu.quant import iquants as JI
from ggml_hexagon_tpu.quant import pack as JP
from ggml_hexagon_tpu.quant import ref_numpy as JR
from ggml_hexagon_tpu.quant import stats as JS
from ggml_hexagon_tpu.quant.formats import GGMLType as JT

from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
from ggml_hexagon_tpu_torch.gguf.writer import GGUFWriter
from ggml_hexagon_tpu_torch.quant import iquants as PI
from ggml_hexagon_tpu_torch.quant import pack as PP
from ggml_hexagon_tpu_torch.quant import ref_numpy as PR
from ggml_hexagon_tpu_torch.quant import stats as PS
from ggml_hexagon_tpu_torch.quant.formats import TYPE_TRAITS, GGMLType, row_size
from ggml_hexagon_tpu_torch.quant.policy import FTYPES

EXPAND = [t for t, c in PP.QCONFIGS.items() if c.expand]
#: the i-quant encoders (searches over codebooks, ~20 k weights/s)
SLOW = {GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS,
        GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M}
#: byte offset of each expand type's f16 scale (IQ1_M keeps it in nibbles)
D_OFFSET = {GGMLType.TQ1_0: 52, GGMLType.TQ2_0: 64}


def _values(qtype, seed):
    """Weights of a trained checkpoint's shape: rows of a few super-blocks,
    a heavy tail, some zero blocks and repeated values (ties)."""
    rng = np.random.default_rng(seed)
    n = (2 if qtype in SLOW else 8) * 256
    x = rng.standard_t(5, size=n).astype(np.float32) * 0.02
    x[:32] = 0.0
    x[64:96] = x[64]
    return x


def _ids(t):
    return t.name


@pytest.mark.parametrize("imatrix", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("qtype", sorted(PR.QUANTIZE, key=int), ids=_ids)
def test_encoder_byte_equal_to_jax(qtype, imatrix):
    if imatrix and qtype not in PR.QUANTIZE_IMATRIX:
        assert qtype not in JR.QUANTIZE_IMATRIX
        return
    x = _values(qtype, int(qtype) + 100 * imatrix)
    qw = None
    if imatrix:
        qw = (np.random.default_rng(int(qtype)).random(x.size) + 0.05).astype(np.float32)
    got = PR.quantize(x, qtype, quant_weights=qw)
    want = JR.quantize(x, JT(int(qtype)), quant_weights=qw)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert got.size == row_size(qtype, x.size)


def test_encoder_tables_match_jax():
    for mine, theirs in ((PR.QUANTIZE, JR.QUANTIZE),
                         (PR.QUANTIZE_IMATRIX, JR.QUANTIZE_IMATRIX),
                         (PR.DEQUANTIZE, JR.DEQUANTIZE)):
        assert sorted(map(int, mine)) == sorted(map(int, theirs))


@pytest.mark.parametrize("qtype", sorted(PR.DEQUANTIZE, key=int), ids=_ids)
def test_decoder_bit_equal_to_jax(qtype):
    tr = TYPE_TRAITS[qtype]
    n = 4 * max(tr.block_size, 256)
    rng = np.random.default_rng(int(qtype))
    buf = rng.integers(0, 256, row_size(qtype, n), dtype=np.uint8)
    with np.errstate(all="ignore"):
        got = PR.dequantize(buf, qtype, n)
        want = JR.dequantize(buf, JT(int(qtype)), n)
    assert got.dtype == want.dtype and got.shape == (n,)
    assert got.tobytes() == want.tobytes()


def _finite_wire(qtype, N, K, seed):
    """Uniform random blocks whose f16 scale is a finite draw (IQ1_M keeps
    its scale's four nibbles in the top bits of its four scale words)."""
    rng = np.random.default_rng(seed)
    wire = rng.integers(0, 256, row_size(qtype, K) * N, dtype=np.uint8)
    b = wire.reshape(-1, TYPE_TRAITS[qtype].type_size)
    d = rng.uniform(-2.0, 2.0, len(b)).astype(np.float16)
    if qtype == GGMLType.IQ1_M:
        d16 = d.view(np.uint16)
        for j in range(4):
            b[:, 49 + 2 * j] = (b[:, 49 + 2 * j] & 0xF) | (((d16 >> (4 * j)) & 0xF) << 4)
    else:
        o = D_OFFSET.get(qtype, 0)
        b[:, o:o + 2] = d.view(np.uint8).reshape(-1, 2)
    return wire


@pytest.mark.parametrize("qtype", EXPAND, ids=_ids)
def test_expansion_byte_equal_to_jax(qtype, monkeypatch):
    N, K = 37, 1024
    wire = _finite_wire(qtype, N, K, int(qtype))
    jq, jd = JI.expand_to_planes(wire.copy(), JT(int(qtype)), N, K)
    nq, nd = PI.expand_to_planes(wire.copy(), qtype, N, K)
    # a slice of 4 rows at a time: the chunked loop as the card's big
    # tensors take it
    monkeypatch.setattr(PP, "_EXPAND_CHUNK", 4 * K)
    tq, td = PP.expand_wire(torch.from_numpy(wire.copy()), qtype, N, K)
    assert np.isfinite(jd).all()
    assert (jq.dtype, jd.dtype) == (np.int8, np.float32)
    assert (tq.dtype, td.dtype) == (torch.int8, torch.float32)
    assert jq.shape == nq.shape == tuple(tq.shape) == (N, K)
    assert jd.shape == nd.shape == tuple(td.shape) == (N, K // PP.QCONFIGS[qtype].gs)
    assert jq.tobytes() == nq.tobytes() == tq.numpy().tobytes()
    assert jd.tobytes() == nd.tobytes() == td.numpy().tobytes()


@pytest.mark.parametrize("qtype", EXPAND, ids=_ids)
def test_expansion_of_uniform_bytes(qtype):
    """Uniform bytes make NaN scales: q is byte-equal all the same, and d
    is, but for the NaN's payload."""
    N, K = 8, 512
    wire = np.random.default_rng(7 + int(qtype)).integers(
        0, 256, row_size(qtype, K) * N, dtype=np.uint8)
    with np.errstate(all="ignore"):
        jq, jd = JI.expand_to_planes(wire.copy(), JT(int(qtype)), N, K)
    tq, td = PP.expand_wire(torch.from_numpy(wire.copy()), qtype, N, K)
    td = td.numpy()
    assert jq.tobytes() == tq.numpy().tobytes()
    nan = np.isnan(jd)
    assert np.array_equal(nan, np.isnan(td))
    assert jd[~nan].tobytes() == td[~nan].tobytes()


@pytest.mark.parametrize("N", [128, 72], ids=["n128", "n72_padded"])
@pytest.mark.parametrize("qtype", EXPAND, ids=_ids)
def test_pack_tensor_expands_as_jax(qtype, N):
    K = 512
    wire = _finite_wire(qtype, N, K, 3 * int(qtype) + N)
    want = JP.pack_tensor(wire.copy(), JT(int(qtype)), (N, K))
    got = PP.pack_tensor(wire.copy(), qtype, (N, K))
    assert (got.n, got.k, got.n_pad) == (want.n, want.k, 128)
    for f in ("q", "d", "qh", "sc", "dmin", "m"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and tuple(a.shape) == b.shape, f
            assert a.numpy().tobytes() == b.tobytes(), f


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.IQ4_XS, GGMLType.TQ2_0],
                         ids=_ids)
def test_quantize_tensor_matches_jax(qtype):
    w = np.random.default_rng(int(qtype)).normal(size=(72, 512)).astype(np.float32)
    got = PP.quantize_tensor(w, qtype)
    want = JP.quantize_tensor(w, JT(int(qtype)))
    for f in ("q", "d", "qh", "sc", "dmin", "m"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), f


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q5_K, GGMLType.IQ4_NL],
                         ids=_ids)
def test_tensor_stats_match_jax(qtype):
    x = np.random.default_rng(1).normal(size=(16, 512)).astype(np.float32)
    assert PS.tensor_stats(x, qtype) == JS.tensor_stats(x, JT(int(qtype)))


def _gguf(writer_cls, types, rng):
    w = writer_cls()
    w.add("general.architecture", "llama")
    for i, t in enumerate(types):
        x = (rng.normal(size=(8, 512)) * 0.1).astype(np.float32)
        w.add_tensor(f"t{i}", x, t)
    w.add_tensor("norm", np.ones(512, np.float32))
    buf = io.BytesIO()
    w.write(buf)
    return buf.getvalue()


def test_writer_quantizes_as_jax():
    """add_tensor with a ggml_type encodes f32 data as the JAX writer
    does: the same file, byte for byte."""
    types = [GGMLType.Q4_0, GGMLType.Q6_K, GGMLType.IQ4_XS, GGMLType.TQ2_0,
             GGMLType.F16]
    got = _gguf(GGUFWriter, types, np.random.default_rng(3))
    want = _gguf(JWriter, [JT(int(t)) for t in types], np.random.default_rng(3))
    assert got == want


def test_reader_dequantizes_the_expand_types_as_jax():
    """tensor_f32 decodes every expand type (the i-quants and ternary,
    through the numpy decoders) as the JAX reader does."""
    w = JWriter()
    w.add("general.architecture", "llama")
    for qtype in EXPAND:
        raw = _finite_wire(qtype, 4, 512, int(qtype))
        w.add_tensor(qtype.name, raw, JT(int(qtype)), raw_ne=(512, 4))
    buf = io.BytesIO()
    w.write(buf)
    mine, ref = GGUFReader.from_buffer(buf.getvalue()), JReader.from_buffer(buf.getvalue())
    for qtype in EXPAND:
        got, want = mine.tensor_f32(qtype.name), ref.tensor_f32(qtype.name)
        assert got.shape == want.shape == (4, 512)
        assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the CLI's quantize and quantize-stats, and the quantized IQ3_XXS file's
# forward, against the JAX package's
# ---------------------------------------------------------------------------

#: the tiny f32 model the CLI quantizes: one layer, n_embd 256, 2 query
#: heads and 1 KV head of 64 (key_length), n_ff 256, a vocabulary of 64:
#: about 270 k weights of i-quants under IQ3_XXS (the encoders run ~20 k
#: weights/s here), the fewest that the port's forward runs (its FFN
#: fused, a quantized down of K % 256 == 0); wo (K = 128) falls back to
#: IQ4_NL as llama-quantize's block-size chain says
D, NH, HD, NKV, NFF, V = 256, 2, 64, 1, 256, 64
CLI_FTYPES = ("Q4_K_M", "Q4_0", "Q2_K", "IQ3_XXS")
PROMPT = [5, 30, 61, 17, 2, 43, 8, 11]


def _write_f32_model(path, seed=0):
    rng = np.random.default_rng(seed)
    w = JWriter()
    w.add("general.architecture", "llama")
    w.add("general.file_type", 0)
    for k, v in (("embedding_length", D), ("block_count", 1),
                 ("feed_forward_length", NFF), ("attention.head_count", NH),
                 ("attention.head_count_kv", NKV),
                 ("attention.key_length", HD), ("attention.value_length", HD),
                 ("context_length", 512), ("rope.dimension_count", HD)):
        w.add(f"llama.{k}", v)
    w.add("llama.rope.freq_base", 500000.0)
    w.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    shapes = {}

    def t(name, *shape):
        if len(shape) == 2:
            a = rng.normal(size=shape) * shape[1] ** -0.5
        else:
            a = rng.random(shape) + 0.5
        w.add_tensor(name, a.astype(np.float32), JT.F32)
        shapes[name] = shape

    t("token_embd.weight", V, D)
    t("output_norm.weight", D)
    t("output.weight", V, D)
    for name, shape in (("attn_norm", (D,)), ("attn_q", (NH * HD, D)),
                        ("attn_k", (NKV * HD, D)), ("attn_v", (NKV * HD, D)),
                        ("attn_output", (D, NH * HD)), ("ffn_norm", (D,)),
                        ("ffn_gate", (NFF, D)), ("ffn_up", (NFF, D)),
                        ("ffn_down", (D, NFF))):
        t(f"blk.0.{name}.weight", *shape)
    w.write_file(str(path))
    return shapes


def _cli(main, argv):
    """(exit code, stdout, stderr) of an in-process CLI run."""
    import contextlib

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    """The f32 file, an importance matrix, and each ftype's file written by
    both CLIs.  Both sides' native encoders are pinned: the JAX package's
    library must load (else the JAX CLI would take its numpy encoders)."""
    from ggml_hexagon_tpu import cli as jcli
    from ggml_hexagon_tpu import native as jnative
    from ggml_hexagon_tpu_torch import cli as pcli

    assert jnative.available(), "the JAX package's native library did not load"
    tmp = tmp_path_factory.mktemp("quant")
    src = tmp / "tiny-f32.gguf"
    shapes = _write_f32_model(src)
    rng = np.random.default_rng(9)
    im = tmp / "imatrix.npz"
    np.savez(im, **{n: (rng.random(s[-1]) + 0.1).astype(np.float32)
                    for n, s in shapes.items() if len(s) == 2})
    out = {"src": src, "tmp": tmp, "jcli": jcli.main, "pcli": pcli.main}
    for ft in CLI_FTYPES:
        extra = ["--imatrix", str(im)] if ft == "IQ3_XXS" else []
        for side, main in (("jax", jcli.main), ("port", pcli.main)):
            path = tmp / f"{side}-{ft}.gguf"
            out[side, ft] = (_cli(main, ["quantize", str(src), str(path), ft] + extra),
                             path)
    return out


@pytest.mark.parametrize("ftype", CLI_FTYPES)
def test_cli_quantize_writes_the_jax_file(quantized, ftype):
    (jrun, jpath), (prun, ppath) = quantized["jax", ftype], quantized["port", ftype]
    assert prun[0] == jrun[0] == 0
    assert prun[1].replace(str(ppath), "X") == jrun[1].replace(str(jpath), "X")
    assert prun[2] == jrun[2]           # the per-tensor type lines
    assert ppath.read_bytes() == jpath.read_bytes()
    with GGUFReader.open(str(ppath)) as r:
        types = {t.ggml_type.name for t in r.tensors.values()}
    if ftype == "IQ3_XXS":
        assert {"IQ2_S", "IQ3_XXS", "IQ3_S", "IQ4_NL", "Q5_K"} <= types


def test_cli_requantizes_an_iquant_file_as_jax(quantized):
    """An IQ3_XXS file reads back through tensor_f32's i-quant decoders
    (re-quantized to Q4_0 by both CLIs: the same file)."""
    src = quantized["port", "IQ3_XXS"][1]
    files = []
    for side in ("jax", "port"):
        path = quantized["tmp"] / f"{side}-requant.gguf"
        assert _cli(quantized[side[0] + "cli"], ["quantize", str(src), str(path),
                                                 "Q4_0"])[0] == 0
        files.append(path.read_bytes())
    assert files[0] == files[1]


@pytest.mark.parametrize("which", ["f32", "iq3_xxs"])
def test_quantize_stats_prints_the_jax_lines(quantized, which):
    if which == "f32":
        path = quantized["src"]
        argv = ["--type", "Q4_K", "--type", "Q6_K", "--type", "IQ4_NL",
                "--type", "Q8_0", "--per-layer"]
    else:
        path = quantized["port", "IQ3_XXS"][1]
        argv = ["--type", "Q8_0", "--type", "Q4_0", "-l", "blk.0", "--per-layer"]
    argv = ["quantize-stats", "-m", str(path)] + argv
    jrun, prun = _cli(quantized["jcli"], argv), _cli(quantized["pcli"], argv)
    assert prun == jrun and prun[0] == 0
    assert "__total__" in prun[1] and len(prun[1].splitlines()) > 4


def test_quantized_iq3xxs_forward_matches_jax(quantized, monkeypatch):
    """The port's IQ3_XXS file loaded by both packages: the i-quant planes
    of the token embedding (expanded by pack_tensor) equal the JAX
    loader's, and the prefill logits of the port's forward match the JAX
    forward's in its kernel-contract mode (NMSE <= 5e-4, the reference's
    mul_mat budget), as do one decode step's from the same cache."""
    import jax.numpy as jnp

    from _torch_gguf_model import jax_matching_mode
    from _torch_port import nmse
    from ggml_hexagon_tpu.models import llama as JL
    from ggml_hexagon_tpu.runtime.engine import Engine as JEngine
    from ggml_hexagon_tpu_torch.models import llama as PL
    from ggml_hexagon_tpu_torch.server.batch_engine import load_fused

    path = str(quantized["port", "IQ3_XXS"][1])
    jax_matching_mode(monkeypatch)
    je = JEngine.from_gguf(path, fuse=True, max_seq=32)
    jc = JL.init_kv_cache(je.cfg, 1, 32, jnp.bfloat16)
    want, jc = JL.forward(je.cfg, je.weights, jnp.asarray([PROMPT], jnp.int32),
                          jc, jnp.int32(0), logits_all=True)
    want_step, _ = JL.forward(je.cfg, je.weights, jnp.asarray([[9]], jnp.int32),
                              jc, jnp.int32(len(PROMPT)))
    cfg, w, _, _ = load_fused(path, "cpu")
    te, jte = w["tok_embd"], je.weights["tok_embd"]
    assert te.cfg.qtype.name == jte.cfg.qtype.name == "IQ3_S"
    assert te.q.numpy().tobytes() == np.asarray(jte.q).tobytes()
    assert te.d.numpy().tobytes() == np.asarray(jte.d).tobytes()
    lw = w["layers"][0]
    assert (lw["wq"].cfg.qtype.name, lw["wv"].cfg.qtype.name,
            lw["w_gateup_il"].cfg.qtype.name, lw["ffn_down"].cfg.qtype.name) == (
        "IQ2_S", "IQ3_XXS", "IQ3_XXS", "IQ3_XXS")
    cache = PL.init_kv_cache(cfg, 1, 32, "bf16", device="cpu")
    got, cache = PL.forward(cfg, w, torch.tensor([PROMPT]), cache, 0,
                            logits_all=True)
    assert nmse(got.numpy(), np.asarray(want)) <= 5e-4
    got_step, _ = PL.forward(cfg, w, torch.tensor([[9]]), cache, len(PROMPT))
    assert nmse(got_step.numpy(), np.asarray(want_step)) <= 5e-4


# ---------------------------------------------------------------------------
# synth.write_gguf of every ftype (the quantizer's f16 input, the 70B's
# random i-quant file) and the 70B's layout
# ---------------------------------------------------------------------------

def _synth_cfg():
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(n_vocab=64, n_embd=256, n_layer=4, n_head=2,
                       n_head_kv=1, n_ff=256, rope_theta=500000.0)


@pytest.mark.parametrize("ftype", sorted(FTYPES))
def test_write_gguf_draws_every_ftype(ftype):
    """The first 2 of 4 layers of a random model in any ftype: each
    tensor's type is the full-depth policy's (the JAX package's
    QuantPolicy too), and the JAX reader decodes every weight finite,
    centred, of RMS about 1/sqrt(k) (uniform wire bytes alone would give
    NaN and inf scales); an expand type's blocks expand in the port's
    pack_tensor as in the JAX package's."""
    from ggml_hexagon_tpu.quant.policy import QuantPolicy as JPolicy
    from ggml_hexagon_tpu_torch.models import synth

    cfg = _synth_cfg()
    imatrix = ftype.startswith("IQ")
    buf = bytearray()
    synth.write_gguf(buf, cfg, ftype, seed=5, device="cpu",
                     has_imatrix=imatrix, depth=2)
    r = JReader.from_buffer(bytes(buf))
    assert r.metadata["llama.block_count"] == 2
    assert r.metadata["general.file_type"] == synth.FILE_TYPES[ftype]
    policy = JPolicy(ftype, 4, n_gqa=2, has_imatrix=imatrix)
    for name, t in r.tensors.items():
        x = r.tensor_f32(name).astype(np.float64)
        assert np.isfinite(x).all(), name
        if len(t.shape) == 1:
            continue
        assert t.ggml_type == policy.tensor_type(name, t.shape), name
        rms = np.sqrt((x ** 2).mean())
        assert 0.8 < rms * t.shape[1] ** 0.5 < 1.25, (name, rms)
        assert abs(x.mean()) < 0.15 * rms, name
        qtype = GGMLType(int(t.ggml_type))
        if qtype in EXPAND:
            want = JP.pack_tensor(r.tensor_bytes(name), t.ggml_type, t.shape)
            got = PP.pack_tensor(r.tensor_bytes(name).copy(), qtype, t.shape)
            assert got.q.numpy().tobytes() == np.asarray(want.q).tobytes()
            assert got.d.numpy().tobytes() == np.asarray(want.d).tobytes()


def test_llama3_70b_first_layers_and_launches():
    """LLAMA3_70B under the imatrix IQ3_XXS policy, built on the meta
    device (shapes only): its first 8 layers hold every tensor type of the
    80-layer file, and one decode step launches K2 coded (IQ2_S wqk + Q4_K
    wv) and K4 once a layer, K1 coded three times a layer and K1 once on
    the Q5_K head, as the card's run of the file counted them."""
    from ggml_hexagon_tpu_torch.models import synth
    from ggml_hexagon_tpu_torch.models.launches import launch_table
    from ggml_hexagon_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**synth.LLAMA3_70B)
    assert (cfg.n_embd, cfg.n_ff, cfg.n_head, cfg.n_head_kv, cfg.hd,
            cfg.n_vocab, cfg.n_layer) == (8192, 28672, 64, 8, 128, 128256, 80)
    full = synth.gguf_tensor_names(cfg)
    policy = synth._policy(cfg, "IQ3_XXS", has_imatrix=True)

    def types(names):
        return {policy.tensor_type(n, s).name for n, s in names if len(s) == 2}

    first = [(n, s) for n, s in full if not n.startswith("blk.")
             or int(n.split(".")[1]) < 8]
    assert types(first) == types(full) == {"IQ2_S", "IQ3_S", "IQ3_XXS",
                                          "Q4_K", "Q5_K"}
    c8, w = synth.build_model(cfg, device="meta", ftype="IQ3_XXS",
                              has_imatrix=True, depth=8)
    lw = w["layers"][0]
    assert {k: (v.cfg.qtype.name, v.n, v.k) for k, v in lw.items()
            if hasattr(v, "fq")} == {
        "wqk": ("IQ2_S", 9216, 8192), "wv": ("Q4_K", 1024, 8192),
        "wo": ("IQ3_S", 8192, 8192), "w_gateup_il": ("IQ3_XXS", 57344, 8192),
        "ffn_down": ("IQ3_XXS", 8192, 28672)}
    assert launch_table(c8, w)["step"] == {"qp8_dual_coded": 8,
                                           "decode_attn": 8,
                                           "qp8_gemv_coded": 24,
                                           "qp8_gemv": 1}
