"""A GGUF file served from text by the port against the JAX package.

The model is a 2-layer Llama shaped like tests/test_torch_model.py's (8
query and 4 KV heads of 128, n_ff 512, vocab 300 with an SPM vocabulary):
Q4_K, with Q6_K on layer 1's attn_v and ffn_down and on the head, written
by the JAX package's GGUFWriter and quantizer (ref_numpy) and loaded by
both packages' Engine.from_gguf(path, fuse=True) (one JAX load for the
module).  The JAX side runs its Pallas kernels in interpret mode, as
test_torch_model.py sets it (GHT_FAST_INTERPRET=1 and the llama interpret
flags), the mode of the port's kernel contract, and its Engine's forward
op by op (not under jit): jit lets XLA fuse and reorder the f32 sums of the
RMSNorm prologues, whose last-ulp changes flip int8 activation roundings
(the decode GEMVs quantize activations to int8), which alone moved the
logits by NMSE 3e-4 to 6e-4 against the port on this model.  Op by op the
two agree to NMSE ~1e-13 on a bf16 cache.  On a q8_0 or q4_0 cache the
projections' f32 sums, in another order on each side (the kernels'
contract), differ in the last ulp, and where a key or value sits at an
int8 or int4 rounding boundary the two caches then differ by one step,
which the next int8 activation rounding amplifies (a 5-token q8_0 prefill
of this model: NMSE 4.7e-4; free-running, such events compound, 8e-4 to
9e-4 by the fourth step).  So the port's generate_text starts each step
from the JAX engine's cache (teacher forcing): measured on 5 prompts of
5-17 tokens, each step is within NMSE 1e-13 but for single-step rounding
events of 3e-5 to 4.7e-4, and every step's greedy token agrees.

Checked: the configs and the planes (the embedding's wire planes, every
matmul and norm plane of the fused layers) equal; generate_text under
bf16, q8_0 and q4_0 KV gives the JAX strings, the same greedy tokens and
logits within NMSE 5e-4 at every step (the mul_mat budget of the
reference's op tests, as test_torch_model.py holds its Engine); prefix
reuse and truncate leave n_past and cached_tokens as JAX does; the q4_0
units: _kv_quantize(bits=4) equal to JAX's values and scales exactly, and
K4's plain twin on packed 4-bit caches against the JAX
fused_decode_attention on jnp.int4 caches in interpret mode, max|d| <=
1e-5 (f32 throughout, another order and exp).
"""
import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.gguf.writer import GGUFWriter
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.ops.decode_attn import fused_decode_attention as j_fda
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine

from _torch_port import jax_tree_to_numpy, nmse
from ggml_hexagon_tpu_torch.models.llama import _kv_quantize
from ggml_hexagon_tpu_torch.ops.decode_attn import (decode_attn_plain,
                                                    pack_int4, unpack_int4)
from ggml_hexagon_tpu_torch.quant.pack import QTensor
from ggml_hexagon_tpu_torch.runtime.device_sampling import DeviceSamplerParams
from ggml_hexagon_tpu_torch.runtime.engine import Engine

NMSE_MAX = 5e-4
KV = {"bf16": jnp.bfloat16, "q8_0": "q8_0", "q4_0": "q4_0"}
MAX_SEQ = 32
N_GEN = 4
PROMPT = "hello world the model"
PROMPT2 = "hello world the card"   # shares a prefix with PROMPT


def _vocab_fields(V):
    """An SPM vocabulary of V tokens: <unk>, <s>, </s>, 256 byte tokens,
    then whole words and their prefixes."""
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    pieces = []
    for w in ("hello", "world", "the", "model", "card", "token", "text"):
        for i in range(1, len(w) + 1):
            for p in (w[:i], "▁" + w[:i]):
                if p not in pieces:
                    pieces.append(p)
    pieces = (["▁"] + pieces)[:V - len(toks)]
    scores = [0.0] * len(toks) + [-float(i % 13) for i in range(len(pieces))]
    toks += pieces
    types += [1] * len(pieces)
    assert len(toks) == V
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types}


def _write_model(path, seed=0, nh=8, nkv=4, hd=128, n_layer=2, V=300,
                 n_ff=512):
    rng = np.random.default_rng(seed)
    d = nh * hd
    w = GGUFWriter()
    w.add("general.architecture", "llama")
    for k, v in (("embedding_length", d), ("block_count", n_layer),
                 ("feed_forward_length", n_ff), ("attention.head_count", nh),
                 ("attention.head_count_kv", nkv), ("context_length", 8192),
                 ("rope.dimension_count", hd)):
        w.add(f"llama.{k}", v)
    w.add("llama.rope.freq_base", 500000.0)
    w.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    for k, v in _vocab_fields(V).items():
        w.add(k, v)

    def q(name, n, k, t=GGMLType.Q4_K):
        w.add_tensor(name, (rng.normal(size=(n, k)) * 0.05).astype(np.float32),
                     t)

    def norm(name):
        w.add_tensor(name, (rng.random(d) + 0.5).astype(np.float32))

    q("token_embd.weight", V, d)
    norm("output_norm.weight")
    q("output.weight", V, d, GGMLType.Q6_K)
    for il in range(n_layer):
        hi = GGMLType.Q6_K if il else GGMLType.Q4_K
        p = f"blk.{il}."
        norm(p + "attn_norm.weight")
        q(p + "attn_q.weight", nh * hd, d)
        q(p + "attn_k.weight", nkv * hd, d)
        q(p + "attn_v.weight", nkv * hd, d, hi)
        q(p + "attn_output.weight", d, nh * hd)
        norm(p + "ffn_norm.weight")
        q(p + "ffn_gate.weight", n_ff, d)
        q(p + "ffn_up.weight", n_ff, d)
        q(p + "ffn_down.weight", d, n_ff, hi)
    w.write_file(str(path))


def _jax_cache(kv: dict) -> dict:
    """A JAX engine's KV cache as numpy: bf16 as int16 bits, int4 as int8."""
    out = {}
    for k, v in kv.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            a = a.view(np.int16)
        elif a.dtype.name == "int4":
            a = a.astype(np.int8)
        out[k] = np.array(a)
    return out


def _port_cache(c: dict, kv: str) -> dict:
    """_jax_cache's arrays in the port's cache layout for KV type kv."""
    out = {}
    for k, a in c.items():
        t = torch.from_numpy(a.copy())
        if kv == "bf16":
            t = t.view(torch.bfloat16)
        elif kv == "q4_0" and k in ("k", "v"):
            t = pack_int4(t)
        out[k] = t
    return out


def _recorded(eng, states=None, kv=None):
    """Wrap eng.prefill / decode_one to record each step's logits, the
    tokens fed to decode and (JAX) the cache each step starts from; with
    `states` (the JAX engine's, port side), each step starts from the JAX
    engine's cache instead of its own (teacher forcing)."""
    rec = {"logits": [], "fed": [], "states": []}
    prefill, decode_one = eng.prefill, eng.decode_one

    def start():
        if states is None:
            rec["states"].append(_jax_cache(eng.kv))
        else:
            eng.kv = _port_cache(states[len(rec["logits"])], kv)

    def p(*a, **k):
        start()
        out = prefill(*a, **k)
        rec["logits"].append(np.asarray(out))
        return out

    def d(tokens):
        start()
        rec["fed"].append(int(np.asarray(tokens).reshape(-1)[0]))
        out = decode_one(tokens)
        rec["logits"].append(np.asarray(out))
        return out

    eng.prefill, eng.decode_one = p, d
    return rec


def _serve(eng, states=None, kv=None):
    """generate_text, then (bf16) prefix reuse and truncate."""
    rec = _recorded(eng, states, kv)
    out = {"text": eng.generate_text(PROMPT, N_GEN), "rec": rec}
    out["after_gen"] = (eng.n_past, list(eng.cached_tokens))
    if kv == "bf16" or (states is None and eng.kv["k"].dtype == jnp.bfloat16):
        ids2 = eng.tokenizer.encode(PROMPT2)
        out["reuse_logits"] = eng.prefill(np.asarray([ids2]), reuse_cache=True)
        out["after_reuse"] = (eng.n_past, list(eng.cached_tokens))
        eng.truncate(3)
        out["after_truncate"] = (eng.n_past, list(eng.cached_tokens))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("load") / "tiny-q4_k_m.gguf"
    _write_model(path)
    out = {"path": path}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_FAST_INTERPRET", "1")
        mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
        mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
        first = JEngine.from_gguf(str(path), fuse=True, max_seq=MAX_SEQ)
        out["cfg"], out["weights"] = first.cfg, jax_tree_to_numpy(first.weights)
        for kv, jkv in KV.items():
            eng = (first if kv == "bf16" else
                   JEngine(first.cfg, first.weights, first.vocab,
                           max_seq=MAX_SEQ, kv_dtype=jkv))
            # the forward op by op, as test_torch_model.py's forward cases
            # run it (see the module docstring)
            eng._fwd = partial(JL.forward, eng.cfg,
                               compute_dtype=eng.compute_dtype)
            out[kv] = _serve(eng)
    out["port"] = Engine.from_gguf(path, fuse=True, max_seq=MAX_SEQ,
                                   device="cpu")
    return out


def test_configs_equal(ref):
    assert (dataclasses.asdict(ref["port"].cfg)
            == dataclasses.asdict(ref["cfg"]))
    assert ref["port"].cfg.rope_mode == "neox"


def _eq(got, want, where):
    """A port tensor (or QTensor) equal to the JAX numpy leaf, bytes."""
    if isinstance(got, QTensor):
        assert (got.n, got.k, got.fl, got.cfg.qtype.name) == (
            want["n"], want["k"], want["fl"],
            GGMLType(want["qtype"]).name), where
        for f in ("q", "d", "qh", "sc", "dmin", "m", "fq", "fs", "fb"):
            a, b = getattr(got, f), want[f]
            if a is None and f in "q d qh sc dmin m".split():
                continue  # the port's drop_wire_planes drops more wire
            assert (a is None) == (b is None), (where, f)
            if a is not None:
                a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
                b = b.view(np.int16) if b.dtype == np.uint16 else b
                assert a.numpy().tobytes() == np.ascontiguousarray(b).tobytes(), (
                    where, f)
        return
    assert got.numpy().tobytes() == np.ascontiguousarray(
        np.asarray(want, got.numpy().dtype)).tobytes(), where


def test_planes_equal(ref):
    """The embedding keeps its wire planes; every fused layer's matmul and
    norm planes, and the head's, equal the JAX loader's (the port's
    drop_wire_planes also drops wqk's wire, which the JAX package keeps)."""
    pw, jw = ref["port"].weights, ref["weights"]
    te = pw["tok_embd"]
    assert te.q is not None
    _eq(te, jw["tok_embd"], "tok_embd")
    _eq(pw["output"], jw["output"], "output")
    _eq(pw["output_norm"], jw["output_norm"], "output_norm")
    for il, (pl, jl) in enumerate(zip(pw["layers"], jw["layers"])):
        assert sorted(pl) == sorted(jl), il
        for key, v in pl.items():
            if v is not None:
                _eq(v, jl[key], f"layer {il} {key}")
    assert "wqkv" in pw["layers"][0] and "wqk" in pw["layers"][1]


@pytest.mark.parametrize("kv", list(KV))
def test_generate_text_matches_jax(ref, kv):
    """The port's generate_text with each step started from the JAX
    engine's cache (teacher forcing): the same greedy tokens and text, the
    logits of every step (the prompt's, each decode step's and, under bf16,
    the prefix-reuse prefill's) within NMSE 5e-4, and n_past and
    cached_tokens after generation, reuse and truncate as JAX leaves them."""
    want = ref[kv]
    eng = ref["port"]
    e = Engine(eng.cfg, eng.weights, eng.vocab, max_seq=MAX_SEQ, kv_dtype=kv,
               device="cpu")
    got = _serve(e, want["rec"]["states"], kv)
    assert got["rec"]["fed"] == want["rec"]["fed"]
    assert len(got["rec"]["fed"]) == N_GEN
    assert len(got["rec"]["logits"]) == len(want["rec"]["logits"])
    for i, (g, w) in enumerate(zip(got["rec"]["logits"],
                                   want["rec"]["logits"])):
        err = nmse(g, w)
        assert err <= NMSE_MAX, (kv, i, err)
    assert got["text"] == want["text"]
    assert got["after_gen"] == want["after_gen"]
    if kv == "bf16":
        assert nmse(got["reuse_logits"], want["reuse_logits"]) <= NMSE_MAX
        assert got["after_reuse"] == want["after_reuse"]
        assert got["after_truncate"] == want["after_truncate"]


def test_generate_ondevice_greedy_and_seeded_on_cpu(ref):
    """On the CPU tensors: temp 0 gives the host greedy tokens (EOS the
    default stop on both); a seeded draw repeats."""
    e = ref["port"]
    ids = e.tokenizer.encode(PROMPT)
    e.reset()
    host = list(e.generate(ids, N_GEN))
    e.reset()
    dev = e.generate_ondevice(ids, N_GEN)
    assert list(dev) == host[:len(dev)] and len(dev) == len(host)
    assert e.n_past == len(ids) + N_GEN - 1
    p = DeviceSamplerParams(temp=0.8, top_k=40, top_p=0.95)
    runs = []
    for _ in range(2):
        e.reset()
        runs.append(list(e.generate_ondevice(ids, N_GEN, p, seed=7,
                                             stop_at_eos=False)))
    assert runs[0] == runs[1] and len(runs[0]) == N_GEN


def test_from_gguf_without_fuse_raises(ref):
    """The port's forward runs fused layers only."""
    with pytest.raises(NotImplementedError):
        Engine.from_gguf(ref["path"], fuse=False, max_seq=MAX_SEQ,
                         device="cpu")


def test_kv_quantize_4bit_matches_jax():
    x = np.random.default_rng(3).normal(size=(3, 5, 512)).astype(np.float32)
    x[0, 1] = 0.0  # a zero row: scale 0, values 0
    jq, jd = JL._kv_quantize(jnp.asarray(x), 4)
    pq, pd = _kv_quantize(torch.from_numpy(x), 4)
    assert pq.dtype == torch.int8 and pq.abs().max() <= 7
    assert np.array_equal(pq.numpy(), np.asarray(jq).astype(np.int8))
    assert np.array_equal(pd.numpy(), np.asarray(jd))
    packed = pack_int4(pq)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, 256)
    assert torch.equal(unpack_int4(packed), pq)
    # dim 2i in the low nibble of byte i, two's complement
    assert int(packed[0, 0, 0]) == (int(pq[0, 0, 0]) & 0xF) | (
        (int(pq[0, 0, 1]) & 0xF) << 4)


def test_decode_attn_plain_q4_matches_jax_int4_kernel():
    """K4's plain twin on packed caches against the JAX kernel on jnp.int4
    caches (interpret mode), as tests/test_decode_attn.py drives it."""
    Hq, Hkv, D, S = 8, 2, 128, 256
    scale = 1.0 / np.sqrt(D)
    rng = np.random.default_rng(11)
    qkv = rng.normal(size=(2, (Hq + 2 * Hkv) * D)).astype(np.float32)
    kq = rng.integers(-7, 8, (2, S, Hkv * D)).astype(np.int8)
    vq = rng.integers(-7, 8, (2, S, Hkv * D)).astype(np.int8)
    kd = (rng.random((2, S)) * 0.02 + 0.001).astype(np.float32)
    vd = (rng.random((2, S)) * 0.02 + 0.001).astype(np.float32)
    pos = np.asarray([100, 37], np.int32)
    want = j_fda(jnp.asarray(qkv), jnp.asarray(kq, jnp.int4),
                 jnp.asarray(vq, jnp.int4), jnp.asarray(pos), None,
                 k_scale=jnp.asarray(kd), v_scale=jnp.asarray(vd), Hq=Hq,
                 Hkv=Hkv, D=D, scale=scale, chunk=512, interpret=True)
    t = torch.from_numpy
    got = decode_attn_plain(t(qkv), pack_int4(t(kq)), pack_int4(t(vq)),
                            t(pos), None, Hq=Hq, Hkv=Hkv, D=D, scale=scale,
                            k_scale=t(kd), v_scale=t(vd), kv_bits=4)
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-5
