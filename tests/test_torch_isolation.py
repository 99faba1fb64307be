"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no silent fallback to the CPU."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import production_stack_tpu_torch
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.ops.attention import paged_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(production_stack_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "production_stack_tpu", "aiohttp", "pydantic",
             "prometheus_client", "xxhash")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    code = textwrap.dedent("""
        import pkgutil, sys
        before = set(sys.modules)
        import production_stack_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            __import__(name)
        new = sorted(set(sys.modules) - before)
        print(len(names))
        print("\\n".join(new))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert int(out[0]) >= 20  # every module of the package was imported
    loaded = out[1:]
    assert "production_stack_tpu_torch.engine.server" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"importing the port loaded {bad}"


def test_sources_import_nothing_forbidden():
    paths = sorted([*PKG.rglob("*.py"), ROOT / "chip_smoke.py"])
    assert len(paths) >= 20
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            where = f"{path.relative_to(ROOT)}:{node.lineno}"
            assert not bad, f"{where} imports {bad}"


def test_package_calls_no_library_attention_or_compiler():
    """The port's path runs its own kernels: no fused PyTorch attention, no
    ``torch.compile``."""
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        for name in ("scaled_dot_product_attention", "torch.compile",
                     "flash_attn"):
            assert name not in src, f"{path.relative_to(ROOT)} uses {name}"


def test_engine_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        LLMEngine(EngineConfig(device="cuda"))


def test_cuda_attention_on_cpu_tensors_raises():
    q = torch.zeros(1, 1, 2, 128)
    kv = torch.zeros(1, 4, 2, 8, 256)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(q, kv, tables, lens, pos, scale=1.0, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        paged_attention(q, kv, tables, lens, pos, scale=1.0, impl="pallas")
