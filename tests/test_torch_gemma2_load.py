"""A tiny gemma2 GGUF file written in-process, loaded by the port and by the
JAX package: `config_from_gguf` (every config field), `load_llama_weights`
through the fused load pipeline (the post-norm tensors, the head tied to
the token embedding: the embedding's wire and matmul planes, no
output.weight in the file) and the logits of one 11-token prefill, the
port's against the JAX forward's (NMSE <= 5e-4, the reference's mul_mat
budget).  The file: n_embd 512, 4 query and 2 KV heads of 256, n_ff 512,
an SPM vocabulary of 300, Q4_K tensors with a Q6_K token embedding and
layer 1's attn_v and ffn_down, written by the JAX package's GGUFWriter and
quantizer; gemma2 metadata with a window of 8 and caps 5 and 3 (random
weights keep the scores near unit size)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_hexagon_tpu.gguf.reader import GGUFReader as JReader
from ggml_hexagon_tpu.gguf.writer import GGUFWriter
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.models.registry import config_from_gguf as j_config
from ggml_hexagon_tpu.quant.formats import GGMLType
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine

from _torch_gguf_model import vocab_fields
from _torch_port import nmse
from ggml_hexagon_tpu_torch.gguf.reader import GGUFReader
from ggml_hexagon_tpu_torch.models import llama as PL
from ggml_hexagon_tpu_torch.models.registry import config_from_gguf
from ggml_hexagon_tpu_torch.server.batch_engine import load_fused

D, NH, NKV, HD, NFF, V = 512, 4, 2, 256, 512, 300
PROMPT = [5, 30, 61, 17, 2, 99, 240, 8, 71, 150, 33]
MAX_SEQ = 32


def write_gemma2(path, seed=0):
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    w.add("general.architecture", "gemma2")
    for k, v in (("embedding_length", D), ("block_count", 2),
                 ("feed_forward_length", NFF), ("attention.head_count", NH),
                 ("attention.head_count_kv", NKV), ("context_length", 8192),
                 ("attention.key_length", HD), ("attention.value_length", HD),
                 ("attention.sliding_window", 8)):
        w.add(f"gemma2.{k}", v)
    w.add("gemma2.attention.layer_norm_rms_epsilon", 1e-6)
    w.add("gemma2.attn_logit_softcapping", 5.0)
    w.add("gemma2.final_logit_softcapping", 3.0)
    for k, v in vocab_fields(V).items():
        w.add(k, v)

    def q(name, n, k, t=GGMLType.Q4_K):
        w.add_tensor(name, (rng.normal(size=(n, k)) * 0.05).astype(np.float32),
                     t)

    def norm(name):
        w.add_tensor(name, (rng.random(D) + 0.5).astype(np.float32))

    q("token_embd.weight", V, D, GGMLType.Q6_K)   # tied: no output.weight
    norm("output_norm.weight")
    for il in range(2):
        hi = GGMLType.Q6_K if il else GGMLType.Q4_K
        p = f"blk.{il}."
        norm(p + "attn_norm.weight")
        q(p + "attn_q.weight", NH * HD, D)
        q(p + "attn_k.weight", NKV * HD, D)
        q(p + "attn_v.weight", NKV * HD, D, hi)
        q(p + "attn_output.weight", D, NH * HD)
        norm(p + "post_attention_norm.weight")
        norm(p + "ffn_norm.weight")
        q(p + "ffn_gate.weight", NFF, D)
        q(p + "ffn_up.weight", NFF, D)
        q(p + "ffn_down.weight", D, NFF, hi)
        norm(p + "post_ffw_norm.weight")
    w.write_file(str(path))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("gemma2") / "tiny-gemma2.gguf"
    write_gemma2(path)
    out = {"path": path}
    with JReader.open(str(path)) as r:
        out["jcfg"] = j_config(r.metadata)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GHT_FAST_INTERPRET", "1")
        mp.setattr(JL, "FUSED_ATTN_INTERPRET", True)
        mp.setattr(JL, "FUSED_EPILOGUE_INTERPRET", True)
        eng = JEngine.from_gguf(str(path), fuse=True, max_seq=MAX_SEQ)
        cache = JL.init_kv_cache(eng.cfg, 1, MAX_SEQ, jnp.bfloat16)
        lp, _ = JL.forward(eng.cfg, eng.weights, jnp.asarray([PROMPT], jnp.int32),
                           cache, jnp.int32(0), logits_all=True)
        out["logits"] = np.asarray(lp)
        out["jax_cfg_loaded"] = eng.cfg
    out["port"] = load_fused(path, "cpu")
    return out


def test_config_from_gguf_matches_jax(ref):
    with GGUFReader.open(ref["path"]) as r:
        cfg = config_from_gguf(r.metadata)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref["jcfg"])
    assert (cfg.arch, cfg.act, cfg.post_norms, cfg.swa_window,
            cfg.swa_pattern, cfg.attn_logit_softcap,
            cfg.final_logit_softcap, cfg.hd) == (
        "gemma2", "gelu", True, 8, 2, 5.0, 3.0, 256)
    assert cfg.embd_scale == pytest.approx(D ** 0.5)
    PL.check_supported(cfg)


def test_loaded_model_has_post_norms_and_a_tied_head(ref):
    cfg, w, _, _ = ref["port"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref["jax_cfg_loaded"])
    for lw in w["layers"]:
        assert lw["post_attn_norm"].shape == (D,)
        assert lw["post_ffn_norm"].shape == (D,)
    te, head = w["tok_embd"], w["output"]
    assert te.cfg.qtype.name == head.cfg.qtype.name == "Q6_K"
    assert te.q is not None and head.q is None  # the gather keeps the wire
    assert head.fq.data_ptr() == te.fq.data_ptr()  # one set of planes


def test_prefill_logits_match_jax(ref):
    cfg, w, _, _ = ref["port"]
    cache = PL.init_kv_cache(cfg, 1, MAX_SEQ, "bf16", device="cpu")
    lp, _ = PL.forward(cfg, w, torch.tensor([PROMPT]), cache, 0,
                       logits_all=True)
    err = nmse(lp.numpy(), ref["logits"])
    assert err <= 5e-4, err
    assert np.abs(lp.numpy()).max() < 3.0  # the final cap
