"""The port's native encoders (ggml_hexagon_tpu_torch/native: its own copy
of quantize.cpp, built with g++ into ggml_hexagon_tpu_torch/_build/)
against the JAX package's native library and against the port's numpy
encoders.

- Byte-equal to the JAX package's `native.quantize_native` for Q4_0, Q8_0,
  Q4_K and Q6_K, with and without quant_weights (the same C++ source).
- Q4_0 and Q8_0 byte-equal to the numpy encoder; Q4_K and Q6_K within
  tests/test_native.py's quality bound (tie-breaks of the scale search).
- The library is the port's own, in its _build/ directory; a type it
  lacks returns None (quantize_model routes it to numpy); a failed build
  raises, with no fallback; the thread count moves no byte.
"""
import numpy as np
import pytest

import _torch_port  # noqa: F401  (one torch thread)
from ggml_hexagon_tpu import native as jnative
from ggml_hexagon_tpu.quant.formats import GGMLType as JT

from ggml_hexagon_tpu_torch import native
from ggml_hexagon_tpu_torch.quant import ref_numpy as R
from ggml_hexagon_tpu_torch.quant.formats import GGMLType

NATIVE = [GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K]


@pytest.fixture(scope="module")
def data():
    x = np.random.default_rng(0).normal(size=256 * 512).astype(np.float32)
    x[:256] = 0.0                      # an all-zero super-block
    x[512:768] = x[512]                # a constant one
    return x


@pytest.mark.parametrize("imatrix", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("qtype", NATIVE, ids=lambda t: t.name)
def test_native_byte_equal_to_jax_native(qtype, imatrix, data):
    """The JAX package's library is required here (it builds with g++ at
    first use, as tests/test_native.py builds it): without it the JAX
    package would fall back to numpy and this would compare other bytes."""
    assert jnative.available(), "the JAX package's native library did not load"
    qw = (np.abs(np.random.default_rng(1).normal(size=data.size)) + 0.1).astype(
        np.float32) if imatrix else None
    got = native.quantize_native(data, int(qtype), quant_weights=qw)
    want = jnative.quantize_native(data, int(JT(int(qtype))), quant_weights=qw)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("qtype", NATIVE, ids=lambda t: t.name)
def test_native_against_numpy(qtype, data):
    a = native.quantize_native(data, int(qtype))
    b = R.quantize(data, qtype)
    if qtype in (GGMLType.Q4_0, GGMLType.Q8_0):
        assert a.tobytes() == b.tobytes()
        return
    da = R.dequantize(a, qtype, data.size)
    db = R.dequantize(b, qtype, data.size)
    ea = np.sqrt(np.mean((da - data) ** 2))
    eb = np.sqrt(np.mean((db - data) ** 2))
    assert abs(ea - eb) / eb < 0.005
    assert np.sqrt(np.mean((da - db) ** 2)) / np.std(data) < 0.05


def test_library_is_the_ports_own():
    lib = native.load()
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "ggml_hexagon_tpu_torch"
    assert path.exists() and lib._name == str(path)
    assert path.name.startswith("libquantize-")


def test_unsupported_type_returns_none(data):
    for qtype in (GGMLType.Q5_K, GGMLType.IQ4_XS, GGMLType.F16):
        assert native.quantize_native(data, int(qtype)) is None


def test_threads_move_no_byte(data):
    a1 = native.quantize_native(data, int(GGMLType.Q4_K), n_threads=1)
    a8 = native.quantize_native(data, int(GGMLType.Q4_K), n_threads=8)
    assert a1.tobytes() == a8.tobytes()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises RuntimeError from build() and from the
    first quantize_native call: no quiet fallback to numpy."""
    bad = tmp_path / "quantize.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native encoder build failed"):
        native.build()
    with pytest.raises(RuntimeError):
        native.quantize_native(np.zeros(256, np.float32), int(GGMLType.Q4_0))
    assert not list((tmp_path / "_build").glob("*.so"))
