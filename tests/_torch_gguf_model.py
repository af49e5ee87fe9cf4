"""The 2-layer Llama GGUF file shared by the port's load and serving tests
(tests/test_torch_load.py, test_torch_batch_engine.py,
test_torch_http_server.py): 8 query and 4 KV heads of 128, n_ff 512, vocab
300 with an SPM vocabulary; Q4_K, with Q6_K on layer 1's attn_v and
ffn_down and on the head, written by the JAX package's GGUFWriter and
quantizer (ref_numpy); and the carriers of a KV cache between the two
packages."""
import numpy as np
import torch

from ggml_hexagon_tpu.gguf.writer import GGUFWriter
from ggml_hexagon_tpu.quant.formats import GGMLType

from ggml_hexagon_tpu_torch.ops.decode_attn import pack_int4


def vocab_fields(V):
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


def write_model(path, seed=0, nh=8, nkv=4, hd=128, n_layer=2, V=300,
                n_ff=512, extra_metadata=None, n_expert=0, n_expert_used=2):
    """The 2-layer Llama of the module docstring; n_expert > 0 makes it
    Mixtral-shaped: each layer's FFN an f32 router and stacked Q4_K gate /
    up experts and Q4_K (layer 0) or Q6_K (layer 1) down experts, top
    n_expert_used."""
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
    if n_expert:
        w.add("llama.expert_count", n_expert)
        w.add("llama.expert_used_count", n_expert_used)
    for k, v in vocab_fields(V).items():
        w.add(k, v)
    for k, v in (extra_metadata or {}).items():
        w.add(k, v)

    def q(name, n, k, t=GGMLType.Q4_K, e=0):
        shape = (e, n, k) if e else (n, k)
        w.add_tensor(name, (rng.normal(size=shape) * 0.05).astype(np.float32),
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
        if n_expert:
            w.add_tensor(p + "ffn_gate_inp.weight",
                         rng.normal(size=(n_expert, d)).astype(np.float32))
            q(p + "ffn_gate_exps.weight", n_ff, d, e=n_expert)
            q(p + "ffn_up_exps.weight", n_ff, d, e=n_expert)
            q(p + "ffn_down_exps.weight", d, n_ff, hi, e=n_expert)
            continue
        q(p + "ffn_gate.weight", n_ff, d)
        q(p + "ffn_up.weight", n_ff, d)
        q(p + "ffn_down.weight", d, n_ff, hi)
    w.write_file(str(path))


class _EagerJax:
    """The jax module with jit as the identity."""

    def __getattr__(self, name):
        import jax

        return getattr(jax, name)

    @staticmethod
    def jit(f, **_kw):
        return f


def jax_matching_mode(mp, eager=()):
    """The JAX package in the mode of the port's kernel contract, as
    test_torch_load.py sets it: GHT_FAST_INTERPRET=1 and the llama
    interpret flags; eager: JAX package modules (runtime/evaluate,
    runtime/engine, ...) whose own jax.jit calls become the identity, so
    that the forward they jit runs op by op (jit lets XLA reorder the f32
    sums of the RMSNorm prologues, whose last-ulp changes flip int8
    activation roundings; see test_torch_load.py), while the Pallas
    kernels' interpret mode keeps its own jit."""
    from ggml_hexagon_tpu.models import llama as JL

    mp.setenv("GHT_FAST_INTERPRET", "1")
    mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
    mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
    for mod in eager:
        mp.setattr(mod, "jax", _EagerJax())


def jax_cache(kv: dict) -> dict:
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


def port_cache(c: dict, kv: str) -> dict:
    """jax_cache's arrays in the port's cache layout for KV type kv."""
    out = {}
    for k, a in c.items():
        t = torch.from_numpy(a.copy())
        if kv == "bf16":
            t = t.view(torch.bfloat16)
        elif kv == "q4_0" and k in ("k", "v"):
            t = pack_int4(t)
        out[k] = t
    return out
