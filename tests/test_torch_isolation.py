"""The port stands alone: it imports neither jax, ml_dtypes, regex (which
the card's machine lacks) nor anything of ggml_hexagon_tpu, and its entry
points run on the card unless the caller asks for the CPU.

The import check runs in a subprocess whose import system refuses the
blocked packages; the entry-point checks run in one with no visible card
(CUDA_VISIBLE_DEVICES=""), so they hold wherever the tests run."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.models.llama import LlamaConfig
from ggml_hexagon_tpu_torch.models.synth import build_model
from ggml_hexagon_tpu_torch.runtime.engine import Engine

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ggml_hexagon_tpu_torch"
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "regex", "ggml_hexagon_tpu")

_BLOCKER = f"""
import importlib.abc, sys
BLOCKED = {BLOCKED!r}
def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""

_IMPORT_ALL = _BLOCKER + """
import importlib, json, pkgutil
import ggml_hexagon_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(json.dumps({"modules": mods,
                  "leaked": sorted(m for m in sys.modules if blocked(m))}))
"""

_NO_CARD = _BLOCKER + """
import dataclasses, json
import numpy as np
import torch
from ggml_hexagon_tpu_torch import kernels
from ggml_hexagon_tpu_torch.convert import convert
from ggml_hexagon_tpu_torch.models.llama import LlamaConfig, init_kv_cache
from ggml_hexagon_tpu_torch.models.synth import build_8b
from ggml_hexagon_tpu_torch.ops.qmm_qp8 import build_t_planes
from ggml_hexagon_tpu_torch.quant.pack import QCONFIGS, QTensor
from ggml_hexagon_tpu_torch.quant.formats import GGMLType
from ggml_hexagon_tpu_torch.runtime.engine import Engine

cfg = LlamaConfig(n_vocab=64, n_embd=256, n_layer=1, n_head=2, n_head_kv=1,
                  n_ff=512)
qt = QTensor(QCONFIGS[GGMLType.Q4_K], 128, 256,
             q=torch.zeros(128, 128, dtype=torch.uint8),
             d=torch.ones(128, 1), sc=torch.ones(128, 8, dtype=torch.int8),
             dmin=torch.zeros(128, 1), m=torch.zeros(128, 8, dtype=torch.uint8))
fq, fs, fb = build_t_planes(qt)
qt = QTensor(qt.cfg, 128, 256, fq=fq, fs=fs, fb=fb)
cases = {
    "engine": lambda: Engine(cfg, {}),
    "build_8b": lambda: build_8b(),
    "init_kv_cache": lambda: init_kv_cache(cfg, 1, 8),
    "convert": lambda: convert(dataclasses.asdict(cfg),
                               {"output_norm": np.ones(4, np.float32)}),
    "qp8_gemv_kernel": lambda: kernels.qp8_gemv(torch.zeros(1, 256), qt),
    "qp8_gemm_kernel": lambda: kernels.qp8_gemm(
        torch.zeros(16, 256, dtype=torch.bfloat16), qt),
}
out = {}
for name, fn in cases.items():
    try:
        fn()
        out[name] = "returned"
    except (RuntimeError, ValueError) as e:
        out[name] = type(e).__name__
print(json.dumps(out))
"""


def _run(args, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax_or_the_jax_package():
    r = _run(["-c", _IMPORT_ALL])
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in ("kernels", "convert", "ops.qmm_qp8", "ops.decode_attn",
                "models.llama", "models.synth", "models.registry",
                "runtime.engine", "runtime.sampling",
                "runtime.device_sampling", "gguf.reader", "gguf.writer",
                "tokenizer.pretok", "tokenizer.bpe"):
        assert f"ggml_hexagon_tpu_torch.{mod}" in got["modules"]


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"])
def test_source_names_no_blocked_import(path):
    """Also the imports inside functions, which an import run never meets."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names
           if any(n == b or n.startswith(b + ".") for b in BLOCKED)]
    assert bad == []


@pytest.fixture(scope="module")
def no_card():
    r = _run(["-c", _NO_CARD])
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("entry,raised", [
    ("engine", "RuntimeError"), ("build_8b", "RuntimeError"),
    ("init_kv_cache", "RuntimeError"), ("convert", "RuntimeError"),
    ("qp8_gemv_kernel", "ValueError"), ("qp8_gemm_kernel", "ValueError")])
def test_entry_points_refuse_without_a_card(no_card, entry, raised):
    """Entry points default to the card; the kernels' bindings refuse CPU
    tensors (the wrappers, not the bindings, take the plain versions)."""
    assert no_card[entry] == raised


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        r = _run(["chip_smoke.py"], cwd=tmp_path)
    else:
        r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_tiny_random_model_serves_on_cpu():
    """The synthetic Q4_K_M build and the Engine run on the CPU when asked,
    through the plain versions: no kernel launches."""
    cfg = LlamaConfig(n_vocab=96, n_embd=256, n_layer=2, n_head=2,
                      n_head_kv=1, n_ff=512, rope_theta=500000.0)
    cfg2, weights = build_model(cfg, seed=3, device="cpu")
    assert cfg2.rope_mode == "neox"
    assert {"wqkv", "w_gateup_il", "attn_norm_il"} <= set(weights["layers"][0])
    kernels.reset_launches()
    eng = Engine(cfg2, weights, max_seq=32, device="cpu")
    toks = list(eng.generate(np.arange(5) % cfg.n_vocab, n_predict=4))
    assert len(toks) == 4 and all(0 <= t < cfg.n_vocab for t in toks)
    assert eng.n_past == 5 + 4  # generate decodes after every yielded token
    assert set(kernels.LAUNCHES.values()) == {0}
    assert eng.kv["k"].device.type == "cpu"
    assert torch.isfinite(eng.kv["k"].float()).all()
