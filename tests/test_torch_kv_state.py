"""The Engine's state files and context shift against the JAX package's.

The model is the 2-layer Llama GGUF of tests/_torch_gguf_model.py, loaded
fused by both packages; the JAX Engine runs its forward op by op in the
mode of the port's kernel contract (_torch_gguf_model.jax_matching_mode).

  round trip   save_state / load_state under bf16, q8_0 and q4_0 KV: the
               cache planes, n_past and cached_tokens come back bit for
               bit, and the next greedy steps give bit-equal logits;
  across       a state file written by the JAX Engine loads into the port's
               and continues to the JAX Engine's greedy tokens, and one
               written by the port loads into the JAX Engine and continues
               to the port's (bf16 and q4_0: the 4-bit values widened to f32
               in the file, packed again on load);
  mismatch     another model, window, batch or cache type is refused;
  shift        shift_context against the JAX Engine's: n_past and
               cached_tokens equal, the cache within NMSE 5e-4 and the next
               step's logits within NMSE 5e-4.

Measured: across packages every continued step's logits within NMSE
1.0e-13 (bf16 both ways), 8.2e-5 (q4_0, JAX's file in the port: a key at
a 4-bit rounding boundary) and 8.5e-14 (q4_0, the port's file in JAX),
the greedy tokens equal; after the shift the cache within NMSE 9.9e-7 and
the next step's logits within 1.7e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread)
from _torch_gguf_model import jax_matching_mode, write_model
from _torch_port import nmse
from ggml_hexagon_tpu.runtime import engine as JEM
from ggml_hexagon_tpu.runtime.engine import Engine as JEngine
from ggml_hexagon_tpu_torch.cli import greedy_continue
from ggml_hexagon_tpu_torch.runtime.engine import Engine
from ggml_hexagon_tpu_torch.runtime.kv_ops import kv_dequant
from ggml_hexagon_tpu_torch.server.batch_engine import load_fused

NMSE_MAX = 5e-4
MAX_SEQ = 32
PROMPT = [1, 269, 279, 285, 295, 269]
N_GEN = 3
JKV = {"bf16": jnp.bfloat16, "q8_0": "q8_0", "q4_0": "q4_0"}
ACROSS = ("bf16", "q4_0")


def _greedy(eng, n=N_GEN):
    """n greedy steps after the last prompt token: (tokens, logits)."""
    toks, logits = [], []
    lg = eng.decode_one(np.asarray([PROMPT[-1]]))
    for _ in range(n):
        logits.append(np.asarray(lg[0], np.float32))
        toks.append(int(np.argmax(lg[0])))
        lg = eng.decode_one(np.asarray([toks[-1]]))
    return toks, logits


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("state")
    path = tmp / "tiny-q4_k_m.gguf"
    write_model(path)
    cfg, weights, vocab, _ = load_fused(path, torch.device("cpu"))
    out = {"tmp": tmp, "cfg": cfg, "weights": weights, "vocab": vocab}
    with pytest.MonkeyPatch.context() as mp:
        jax_matching_mode(mp, eager=(JEM,))
        first = JEngine.from_gguf(str(path), fuse=True, max_seq=MAX_SEQ)
        out["jcfg"], out["jw"] = first.cfg, first.weights

        def jeng(kv):
            return JEngine(first.cfg, first.weights, first.vocab,
                           max_seq=MAX_SEQ, kv_dtype=JKV[kv])

        for kv in ACROSS:
            e = jeng(kv)
            e.prefill(np.asarray([PROMPT[:-1]], np.int32))
            f = str(tmp / f"jax_{kv}.state")
            e.save_state(f)
            out[f"jax_{kv}"] = (f, _greedy(e))
            # the port's file, written by a port Engine, continued in JAX
            pe = _engine(out, kv)
            pe.prefill(np.asarray([PROMPT[:-1]]))
            f = str(tmp / f"port_{kv}.state")
            pe.save_state(f)
            e = jeng(kv)
            e.load_state(f)
            out[f"port_{kv}"] = (_greedy(pe), _greedy(e))
        e = jeng("bf16")
        e.prefill(np.asarray([PROMPT * 2], np.int32))
        e.shift_context(2, 4)
        out["shift"] = (e.n_past, list(e.cached_tokens),
                        {k: np.asarray(v, np.float32) for k, v in e.kv.items()},
                        np.asarray(e.decode_one(np.asarray([269], np.int32))))
    return out


def _engine(ref, kv, **kw):
    return Engine(ref["cfg"], ref["weights"], ref["vocab"], device="cpu",
                  max_seq=kw.pop("max_seq", MAX_SEQ), kv_dtype=kv, **kw)


@pytest.mark.parametrize("kv", list(JKV))
def test_state_round_trip_is_bit_exact(ref, kv, tmp_path):
    a = _engine(ref, kv)
    a.prefill(np.asarray([PROMPT[:-1]]))
    f = tmp_path / "s.state"
    a.save_state(f)
    b = _engine(ref, kv)
    b.load_state(f)
    assert (b.n_past, b.cached_tokens) == (a.n_past, a.cached_tokens)
    assert b.n_past == len(PROMPT) - 1
    for name, t in a.kv.items():
        assert t.dtype == b.kv[name].dtype and torch.equal(t, b.kv[name])
    (ta, la), (tb, lb) = _greedy(a), _greedy(b)
    assert ta == tb and all(np.array_equal(x, y) for x, y in zip(la, lb))
    z = np.load(f)
    assert sorted(z.files) == sorted(["__meta__", *a.kv])
    if kv == "q4_0":  # widened to f32, unpacked: the JAX package's layout
        assert z["k"].dtype == np.float32 and z["k"].shape[-1] == 4 * 128
        assert np.abs(z["k"]).max() <= 7


@pytest.mark.parametrize("kv", ACROSS)
def test_jax_state_continues_in_the_port(ref, kv):
    f, (want, wl) = ref[f"jax_{kv}"]
    e = _engine(ref, kv)
    e.load_state(f)
    assert e.n_past == len(PROMPT) - 1 and e.cached_tokens == PROMPT[:-1]
    got, gl = _greedy(e)
    assert got == want
    for g, w in zip(gl, wl):
        assert nmse(g, w) <= NMSE_MAX


@pytest.mark.parametrize("kv", ACROSS)
def test_port_state_continues_in_jax(ref, kv):
    (want, wl), (got, gl) = ref[f"port_{kv}"]
    assert got == want
    for g, w in zip(gl, wl):
        assert nmse(g, w) <= NMSE_MAX


def test_state_mismatch_is_refused(ref, tmp_path):
    a = _engine(ref, "bf16")
    a.prefill(np.asarray([PROMPT]))
    f = tmp_path / "s.state"
    a.save_state(f)
    for kw in ({"kv": "q8_0"}, {"kv": "q4_0"}, {"kv": "bf16", "max_seq": 64},
               {"kv": "bf16", "batch": 2}):
        e = _engine(ref, kw.pop("kv"), **kw)
        with pytest.raises(ValueError, match="mismatch"):
            e.load_state(f)
    other = _engine(ref, "bf16")
    other.cfg = dataclasses.replace(other.cfg, n_layer=3)
    with pytest.raises(ValueError, match="n_layer"):
        other.load_state(f)
    np.savez(tmp_path / "other.npz",
             __meta__=np.frombuffer(b'{"magic": "XXXX"}', np.uint8))
    with pytest.raises(ValueError, match="not a saved state"):
        a.load_state(tmp_path / "other.npz")
    assert a.n_past == len(PROMPT)


def test_shift_context_matches_jax(ref):
    n_past, cached, jkv, jlogits = ref["shift"]
    e = _engine(ref, "bf16")
    e.prefill(np.asarray([PROMPT * 2]))
    e.shift_context(2, 4)
    assert (e.n_past, e.cached_tokens) == (n_past, cached)
    assert cached == PROMPT[:2] + (PROMPT * 2)[6:]
    for name in ("k", "v"):
        got = kv_dequant(e.kv, name)[:, :, :n_past].numpy()
        assert nmse(got, jkv[name][:, :, :n_past]) <= NMSE_MAX
    logits = e.decode_one(np.asarray([269]))
    assert nmse(logits, jlogits) <= NMSE_MAX
    with pytest.raises(ValueError):
        e.shift_context(4, e.n_past)


def test_greedy_continue_is_the_cli_loop(ref):
    """save-load-state's loop (cli.greedy_continue) is _greedy's."""
    a, b = _engine(ref, "bf16"), _engine(ref, "bf16")
    for e in (a, b):
        e.prefill(np.asarray([PROMPT[:-1]]))
    assert greedy_continue(a, PROMPT[-1], N_GEN) == _greedy(b)[0]
