"""The port's decoder embeddings (runtime/embedding.py, the forward's tap
route) against the JAX package's, and the port server's embedding routes.

The model is the 2-layer Llama GGUF of tests/_torch_gguf_model.py, loaded
fused by both packages, the JAX side in the mode of the port's kernel
contract (its extract_embeddings runs the forward op by op).  The prompts
are 16 tokens each (K3 on every projection: the tap route takes every
projection raw) plus one of 7 (K1).

Measured: the pooled embeddings within NMSE 4.0e-6 (mean), 1.1e-5 (cls),
6.4e-5 (last) and the per-token states within 2.2e-5 ("none") of JAX's;
the tap names and their order equal; /v1/embeddings, /embeddings and
/embedding return extract_embeddings' rows exactly.  Limit: NMSE <= 5e-4
(the mul_mat budget of the reference's op tests).
"""
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread)
from _torch_gguf_model import jax_matching_mode, write_model
from _torch_port import nmse
from ggml_hexagon_tpu.models import llama as JL
from ggml_hexagon_tpu.runtime import embedding as JEmb
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine
from ggml_hexagon_tpu_torch.models.llama import forward, init_kv_cache
from ggml_hexagon_tpu_torch.runtime.embedding import extract_embeddings
from ggml_hexagon_tpu_torch.server.batch_engine import BatchEngine, load_fused
from ggml_hexagon_tpu_torch.server.http_server import (InferenceServer,
                                                       make_handler)

NMSE_MAX = 5e-4
ROUTE_NMSE = 1e-2
POOLINGS = ("mean", "cls", "last", "none")
WORDS = ("hello", "world", "the", "model")  # one SPM token each
TEXTS = [" ".join(WORDS[i] for i in np.random.default_rng(s).integers(0, 4, n))
         for s, n in ((0, 15), (1, 15), (2, 6))]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("emb") / "tiny-q4_k_m.gguf"
    write_model(path)
    cfg, weights, vocab, md = load_fused(path, torch.device("cpu"))
    out = {"path": path, "cfg": cfg, "weights": weights, "vocab": vocab,
           "md": md}
    with pytest.MonkeyPatch.context() as mp:
        jax_matching_mode(mp)
        je = JEngine.from_gguf(str(path), fuse=True, max_seq=32)
        ids = [je.tokenizer.encode(t) for t in TEXTS]
        out["ids"] = ids
        out["jax"] = {p: JEmb.extract_embeddings(je.cfg, je.weights, ids,
                                                 pooling=p)
                      for p in POOLINGS}
        names = []
        kv = JL.init_kv_cache(je.cfg, 1, 16, jnp.bfloat16)
        JL.forward(je.cfg, je.weights, jnp.asarray([ids[0]]), kv,
                   jnp.int32(0), logits_all=True,
                   tap=lambda name, x, **_kw: names.append(name))
        out["jax_names"] = names
    return out


@pytest.mark.parametrize("pooling", POOLINGS)
def test_extract_embeddings_matches_jax(ref, pooling):
    got = extract_embeddings(ref["cfg"], ref["weights"], ref["ids"],
                             pooling=pooling, device="cpu")
    want = ref["jax"][pooling]
    assert len(got) == len(want) == 3
    for g, w, ids in zip(got, want, ref["ids"]):
        shape = (len(ids), 1024) if pooling == "none" else (1024,)
        assert g.shape == w.shape == shape and g.dtype == np.float32
        assert nmse(g, w) <= NMSE_MAX
    if pooling != "none":
        assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_tap_names_and_order_match_jax(ref):
    """The forward's tap sees the JAX tap list: per layer attn_q, attn_k,
    attn_v, attn_output, ffn_gate, ffn_up, ffn_down, l_out; then the head's
    input; each with its [1, T, width] input."""
    seen = []
    kv = init_kv_cache(ref["cfg"], 1, 16, "bf16", "cpu")
    forward(ref["cfg"], ref["weights"], torch.tensor([ref["ids"][0]]), kv, 0,
            logits_all=True,
            tap=lambda name, x, **_kw: seen.append((name, tuple(x.shape))))
    assert [n for n, _ in seen] == ref["jax_names"]
    assert len(seen) == 2 * 8 + 1
    widths = {"ffn_down": 512}
    for name, shape in seen:
        w = next((v for k, v in widths.items() if k in name), 1024)
        assert shape == (1, 16, w), name


def test_tap_route_and_fused_route_agree(ref):
    """The forward with a tap (the tap route) and without one: above 8
    rows on t-planes both run the norm in torch and K3 on every projection,
    so the 16-token logits are bit-equal; at 7 rows the fused route folds
    the norms, the act and the residuals into K1, whose int8 activations
    differ from the raw route's (NMSE 1.4e-3 measured; two routes of one
    model are held to ROUTE_NMSE, as test_torch_batch_engine.py holds
    them)."""
    cfg, w = ref["cfg"], ref["weights"]
    for ids, exact in ((ref["ids"][0], True), (ref["ids"][2], False)):
        outs = []
        for tap in (None, lambda *a, **k: None):
            kv = init_kv_cache(cfg, 1, 16, "bf16", "cpu")
            outs.append(forward(cfg, w, torch.tensor([ids]), kv, 0,
                                logits_all=True, tap=tap)[0])
        if exact:
            assert torch.equal(outs[0], outs[1])
        else:
            assert nmse(outs[1].numpy(), outs[0].numpy()) <= ROUTE_NMSE


def _post(url, path, payload):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_embedding_routes_return_the_function_rows(ref):
    be = BatchEngine(ref["cfg"], ref["weights"], ref["vocab"], n_slots=1,
                     max_seq=32, device="cpu")
    be.metadata = ref["md"]
    srv = InferenceServer(be, model_path=str(ref["path"]))
    srv.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        ids = [srv.tokenizer.encode(t, parse_special=True) for t in TEXTS]
        want = extract_embeddings(ref["cfg"], ref["weights"], ids,
                                  device="cpu")
        got = _post(url, "/v1/embeddings", {"input": TEXTS})
        assert got["object"] == "list"
        assert got["usage"]["prompt_tokens"] == sum(map(len, ids))
        rows = [d["embedding"] for d in got["data"]]
        assert [d["index"] for d in got["data"]] == [0, 1, 2]
        assert np.array_equal(np.asarray(rows, np.float32), want)
        for path in ("/embedding", "/embeddings"):
            got = _post(url, path, {"content": TEXTS[0]})
            assert np.array_equal(np.asarray(got[0]["embedding"], np.float32),
                                  want[0])
        got = _post(url, "/v1/embeddings", {"input": ids[2]})
        assert np.array_equal(np.asarray(got["data"][0]["embedding"],
                                         np.float32), want[2])
    finally:
        httpd.shutdown()
        srv.stop()
