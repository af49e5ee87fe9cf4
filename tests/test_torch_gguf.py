"""The port's GGUF reader and writer, pack_tensor, architecture registry and
weight loader against the JAX package's, and the synthetic GGUF writer of
models/synth.py against the JAX package's block layout.

- A file written by one package's GGUFWriter (every value type, arrays, a
  string array, a non-default alignment) reads back equal through the
  other's reader: metadata and tensor bytes exactly.
- pack_tensor: the port's planes are byte-equal (values, dtypes, shapes)
  to the JAX package's for each of the 12 wire types that are not expanded
  at load, at 128 rows and at 72 (padded to 128), and for the expanded
  types (the i-quants below 4 bits and ternary: int8 values and f32 group
  scales) on zero blocks (tests/test_torch_quant_encoders.py holds them
  on random ones); the writer refuses a type it has no encoder for.
- config_from_gguf over every architecture of the registry, on a plain and
  a richer metadata set: dataclasses.asdict equal to JAX's, or the same
  exception.
- load_llama_weights on a one-layer MoE file: the stacked expert tensors
  [E, n, k] load as one [(E*n), k] QTensor with the JAX loader's wire
  planes, exactly; the config, the norms and the router equal JAX's.
- synth.wire_blocks is the inverse of the JAX decode: the JAX quantizer's
  Q4_K and Q6_K blocks come back byte for byte, and synth.write_gguf's
  blocks unpack (JAX pack_tensor) to the drawn planes exactly.
All comparisons are exact: the same integer and f16 decode on both sides.
"""
import dataclasses
import io

import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.gguf.reader import GGUFReader as JReader
from ggml_hexagon_tpu.gguf.reader import GGUFValueType as JVT
from ggml_hexagon_tpu.gguf.writer import GGUFWriter as JWriter
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.models.registry import ARCHS
from ggml_hexagon_tpu.models.registry import config_from_gguf as j_config
from ggml_hexagon_tpu.quant import ref_numpy as R
from ggml_hexagon_tpu.quant.formats import GGMLType as JT
from ggml_hexagon_tpu.quant.pack import pack_tensor as j_pack

from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader as PReader
from ggml_hexagon_tpu_torch.gguf.reader import GGUFValueType as PVT
from ggml_hexagon_tpu_torch.gguf.writer import GGUFWriter as PWriter
from ggml_hexagon_tpu_torch.models import synth
from ggml_hexagon_tpu_torch.models.llama import LlamaConfig, load_llama_weights
from ggml_hexagon_tpu_torch.models.registry import config_from_gguf as p_config
from ggml_hexagon_tpu_torch.quant.formats import GGMLType
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS, pack_tensor

PACKED = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K",
          "Q5_K", "Q6_K", "IQ4_NL", "IQ4_XS"]
PLANES = ("q", "d", "qh", "sc", "dmin", "m")


def _kv(w, vt):
    """Every GGUF value type, arrays of each scalar kind, a string array."""
    w.add("t.u8", 250, vt.UINT8)
    w.add("t.i8", -100, vt.INT8)
    w.add("t.u16", 65000, vt.UINT16)
    w.add("t.i16", -32000, vt.INT16)
    w.add("t.u32", 4000000000, vt.UINT32)
    w.add("t.i32", -2000000000, vt.INT32)
    w.add("t.f32", 0.15625, vt.FLOAT32)
    w.add("t.bool", True, vt.BOOL)
    w.add("t.str", "naïve 日本 😀", vt.STRING)
    w.add("t.u64", 2 ** 60 + 3, vt.UINT64)
    w.add("t.i64", -(2 ** 60), vt.INT64)
    w.add("t.f64", 1.0 / 3.0, vt.FLOAT64)
    w.add("t.arr_int", [1, 2, 3, 2 ** 31])
    w.add("t.arr_neg", [-5, 7])
    w.add("t.arr_f", [0.5, -1.25])
    w.add("t.arr_bool", [True, False, True])
    w.add("t.arr_str", ["a", "", "ü b"])
    w.add("t.arr_empty", [])


def _tensors(rng):
    """(name, packed bytes, ggml type, ne) of an F32 vector, an F16 matrix
    and Q4_K / Q8_0 blocks (odd byte counts, so alignment pads)."""
    q4 = R.quantize(rng.normal(size=(3, 256)).astype(np.float32).reshape(-1),
                    JT.Q4_K)
    q8 = R.quantize(rng.normal(size=(1, 96)).astype(np.float32).reshape(-1),
                    JT.Q8_0)
    f32 = rng.normal(size=7).astype(np.float32)
    f16 = rng.normal(size=(3, 5)).astype(np.float16)
    return [("v.f32", f32.view(np.uint8), 0, (7,)),
            ("m.f16", f16.reshape(-1).view(np.uint8), 1, (5, 3)),
            ("w.q4k", q4, 12, (256, 3)), ("w.q8", q8, 8, (96, 1))]


def _write(writer_cls, vt, alignment, rng):
    w = writer_cls(alignment=alignment)
    _kv(w, vt)
    tt = JT if writer_cls is JWriter else GGMLType
    for name, raw, t, ne in _tensors(rng):
        w.add_tensor(name, raw, tt(t), raw_ne=ne)
    buf = io.BytesIO()
    w.write(buf)
    return buf.getvalue()


def _same(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return a == b


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("alignment", [32, 64, 8])
def test_reader_writer_round_trip(direction, alignment):
    rng = np.random.default_rng(alignment)
    if direction == "jax_to_port":
        data = _write(JWriter, JVT, alignment, rng)
        ref = JReader.from_buffer(data)
    else:
        data = _write(PWriter, PVT, alignment, rng)
        ref = JReader.from_buffer(data)
    mine = PReader.from_buffer(data)
    assert mine.version == ref.version == 3
    assert mine.alignment == ref.alignment == alignment
    assert mine.data_offset == ref.data_offset
    assert mine.metadata.keys() == ref.metadata.keys()
    for k in ref.metadata:
        assert _same(mine.metadata[k], ref.metadata[k]), k
    assert mine.metadata["t.arr_str"] == ["a", "", "ü b"]
    assert mine.metadata["t.str"] == "naïve 日本 😀"
    assert list(mine.tensors) == list(ref.tensors)
    for name, t in ref.tensors.items():
        m = mine.tensors[name]
        assert (m.ne, int(m.ggml_type), m.offset) == (t.ne, int(t.ggml_type),
                                                      t.offset)
        assert np.array_equal(mine.tensor_bytes(name), ref.tensor_bytes(name))
        np.testing.assert_array_equal(mine.tensor_f32(name),
                                      ref.tensor_f32(name))
    # both writers give the same file
    assert _write(PWriter, PVT, alignment, np.random.default_rng(alignment)) \
        == _write(JWriter, JVT, alignment, np.random.default_rng(alignment))


def test_writer_refuses_quantizing():
    """The writer quantizes f32 data to any type of quant.ref_numpy's
    QUANTIZE table; TQ1_0 has no encoder (in either package), so it is
    refused."""
    w = PWriter()
    with pytest.raises(NotImplementedError):
        w.add_tensor("x", np.zeros((4, 256), np.float32), GGMLType.TQ1_0)
    w.add_tensor("y", np.zeros((4, 256), np.float32), GGMLType.Q4_K)
    assert w.tensors[-1][2] == GGMLType.Q4_K


@pytest.mark.parametrize("N", [128, 72], ids=["n128", "n72_padded"])
@pytest.mark.parametrize("qtype", PACKED)
def test_pack_tensor_matches_jax(qtype, N):
    K = 512
    rng = np.random.default_rng(int(JT[qtype]) * 7 + N)
    w = rng.normal(size=(N, K)).astype(np.float32)
    wire = R.quantize(w.reshape(-1), JT[qtype])
    want = j_pack(wire, JT[qtype], (N, K))
    got = pack_tensor(wire, GGMLType[qtype], (N, K))
    assert (got.n, got.k, got.n_pad) == (want.n, want.k, 128)
    assert got.cfg.qtype.name == qtype
    for f in PLANES:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            b = np.asarray(b)
            a = a.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("qtype", [t for t, c in QCONFIGS.items() if c.expand],
                         ids=lambda t: t.name)
def test_pack_tensor_refuses_expanded_types(qtype):
    """The expanded types no longer raise: zero blocks expand to the JAX
    package's planes (int8 values, f32 group scales), rows padded."""
    from ggml_hexagon_tpu_torch.quant.formats import row_size

    wire = np.zeros(row_size(qtype, 256) * 2, np.uint8)
    got = pack_tensor(wire, qtype, (2, 256))
    want = j_pack(wire, JT[qtype.name], (2, 256))
    for f in ("q", "d"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert got.qh is got.sc is got.dmin is got.m is None


def _arch_md(arch, rich):
    g = lambda k: f"{arch}.{k}"  # noqa: E731
    md = {"general.architecture": arch, g("embedding_length"): 256,
          g("block_count"): 4, g("attention.head_count"): 4,
          g("attention.head_count_kv"): 2, g("feed_forward_length"): 512,
          g("context_length"): 4096, g("vocab_size"): 100}
    if rich:
        md.update({g("rope.scaling.type"): "yarn", g("rope.scaling.factor"): 4.0,
                   g("rope.freq_base"): 500000.0,
                   g("rope.dimension_count"): 32,
                   g("attention.key_length"): 64,
                   g("attention.layer_norm_rms_epsilon"): 1e-6,
                   g("attention.layer_norm_epsilon"): 1e-5,
                   g("attention.sliding_window"): 128,
                   g("expert_count"): 8, g("expert_used_count"): 2,
                   g("expert_feed_forward_length"): 128,
                   g("attention.head_count"): [4, 4, 2, 4],
                   g("attention.head_count_kv"): [2, 2, 1, 2],
                   g("feed_forward_length"): [512, 256, 512, 512]})
    return md


@pytest.mark.parametrize("rich", [False, True], ids=["plain", "rich"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_from_gguf_matches_jax(arch, rich):
    md = _arch_md(arch, rich)
    try:
        want = dataclasses.asdict(j_config(md))
    except Exception as e:  # noqa: BLE001 - the port must raise alike
        with pytest.raises(type(e)):
            p_config(md)
        return
    got = dataclasses.asdict(p_config(md))
    assert got == want


def _moe_file(tmp_path):
    """A one-layer MoE llama GGUF (2 experts, stacked [E, n, k] Q4_K and Q6_K
    tensors, an f32 router) written by the JAX writer and quantizer."""
    rng = np.random.default_rng(9)
    d, nh, hd, E, nff, V = 256, 2, 128, 2, 256, 64
    w = JWriter()
    w.add("general.architecture", "llama")
    for k, v in (("embedding_length", d), ("block_count", 1),
                 ("feed_forward_length", nff), ("attention.head_count", nh),
                 ("attention.head_count_kv", 1), ("context_length", 512),
                 ("expert_count", E), ("expert_used_count", 1),
                 ("vocab_size", V)):
        w.add(f"llama.{k}", v)

    def q(name, shape, t=JT.Q4_K):
        w.add_tensor(name, (rng.normal(size=shape) * 0.05).astype(np.float32), t)

    q("token_embd.weight", (V, d))
    q("output.weight", (V, d), JT.Q6_K)
    w.add_tensor("output_norm.weight", rng.random(d).astype(np.float32) + 0.5)
    p = "blk.0."
    q(p + "attn_q.weight", (nh * hd, d))
    q(p + "attn_k.weight", (hd, d))
    q(p + "attn_v.weight", (hd, d), JT.Q6_K)
    q(p + "attn_output.weight", (d, nh * hd))
    for n in ("attn_norm", "ffn_norm"):
        w.add_tensor(p + n + ".weight", rng.random(d).astype(np.float32) + 0.5)
    w.add_tensor(p + "ffn_gate_inp.weight",
                 rng.normal(size=(E, d)).astype(np.float32))
    q(p + "ffn_gate_exps.weight", (E, nff, d))
    q(p + "ffn_up_exps.weight", (E, nff, d))
    q(p + "ffn_down_exps.weight", (E, d, nff), JT.Q6_K)
    path = tmp_path / "moe.gguf"
    w.write_file(str(path))
    return path


def test_loader_stacks_experts_like_jax(tmp_path):
    path = _moe_file(tmp_path)
    with JReader.open(path) as r:
        jcfg, jw = JL.load_llama_weights(r, device=False)
    with PReader.open(path) as r:
        pcfg, pw = load_llama_weights(r, device="cpu")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    jl, pl = jw["layers"][0], pw["layers"][0]
    assert sorted(pl) == sorted(jl)
    for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps", "wq", "wv",
                "wo"):
        a, b = pl[key], jl[key]
        assert (a.n, a.k, a.cfg.qtype.name) == (b.n, b.k, b.cfg.qtype.name)
        assert a.fq is not None
        for f in PLANES:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (key, f)
            if x is not None:
                assert x.numpy().tobytes() == np.asarray(y).tobytes(), (key, f)
    assert pl["ffn_gate_exps"].n == 2 * 256 and pl["ffn_down_exps"].n == 2 * 256
    for key in ("attn_norm", "ffn_norm"):
        assert np.array_equal(pl[key].numpy(), np.asarray(jl[key]))
    router = np.asarray(jl["ffn_gate_inp"]).astype(np.float32)
    assert pl["ffn_gate_inp"].dtype == torch.bfloat16
    assert np.array_equal(pl["ffn_gate_inp"].float().numpy(), router)


@pytest.mark.parametrize("qtype", ["Q4_K", "Q6_K"])
def test_wire_blocks_invert_the_jax_quantizer(qtype):
    rng = np.random.default_rng(5)
    wire = R.quantize(rng.normal(size=(64, 1024)).astype(np.float32)
                      .reshape(-1), JT[qtype])
    qt = pack_tensor(wire, GGMLType[qtype], (64, 1024))
    assert synth.wire_blocks(qt).numpy().tobytes() == wire.tobytes()


def test_write_gguf_blocks_unpack_to_the_draw():
    """A 1-layer Q4_K_M file of 4 heads of 128: every tensor's blocks
    unpack (JAX pack_tensor) to the planes draw_gguf_tensors draws."""
    cfg = LlamaConfig(n_vocab=256, n_embd=512, n_layer=1, n_head=4,
                      n_head_kv=2, n_ff=768, rope_theta=500000.0)
    buf = bytearray()
    info = synth.write_gguf(buf, cfg, "Q4_K_M", seed=2, device="cpu")
    assert info["bytes"] == len(buf)
    r = JReader.from_buffer(bytes(buf))
    assert r.metadata["llama.rope.freq_base"] == 500000.0
    assert r.metadata["general.file_type"] == 15
    names = [n for n, _ in synth.gguf_tensor_names(cfg)]
    assert list(r.tensors) == names
    seen = set()
    for name, drawn in synth.draw_gguf_tensors(cfg, "Q4_K_M", 2, "cpu"):
        t = r.tensors[name]
        if not hasattr(drawn, "cfg"):
            assert np.array_equal(r.tensor_f32(name), drawn.numpy())
            continue
        seen.add(t.ggml_type.name)
        got = j_pack(r.tensor_bytes(name), t.ggml_type, t.shape)
        for f in PLANES:
            a, b = getattr(drawn, f), getattr(got, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                np.testing.assert_array_equal(
                    np.asarray(b)[:drawn.n].astype(np.float64),
                    a[:drawn.n].numpy().astype(np.float64), err_msg=name + f)
    assert seen == {"Q4_K", "Q6_K"}
    assert synth.gguf_data_bytes(cfg) < len(buf)
