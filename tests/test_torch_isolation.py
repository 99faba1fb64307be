"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no silent fallback to the CPU."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import production_stack_tpu_torch
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.models.llama import Llama
from production_stack_tpu_torch.models.registry import get_model_config
from production_stack_tpu_torch.ops import int4_matmul as i4
from production_stack_tpu_torch.ops import paged_attention_cuda as pac
from production_stack_tpu_torch.ops.attention import paged_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(production_stack_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "production_stack_tpu", "aiohttp", "pydantic",
             "prometheus_client", "xxhash", "safetensors", "ml_dtypes",
             "requests")
# Imported lazily, for an HF tokenizer only: never at import time.
LAZY = ("transformers",)


def _forbidden(module: str, names=FORBIDDEN) -> bool:
    return module.split(".")[0] in names


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
    assert int(out[0]) >= 21  # every module of the package was imported
    loaded = out[1:]
    for name in ("engine.server", "ops.int4_matmul", "ops.paged_attention_cuda",
                 "tools.profile_step"):
        assert f"production_stack_tpu_torch.{name}" in loaded
    bad = [m for m in loaded if _forbidden(m, FORBIDDEN + LAZY)]
    assert not bad, f"importing the port loaded {bad}"


def test_sources_import_nothing_forbidden():
    paths = sorted([*PKG.rglob("*.py"), ROOT / "chip_smoke.py"])
    assert len(paths) >= 22
    assert PKG / "ops" / "int4_matmul.py" in paths
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
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        LLMEngine(EngineConfig(quantization="int4", device="cuda"))
    with pytest.raises(ValueError, match="quantization"):
        EngineConfig(quantization="fp4", device="cpu")


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


def _decode_step(monkeypatch, impl: str, fused: bool):
    """One tiny-Llama decode step (after a 5-token prefill) on CPU tensors,
    with or without ``PST_FUSED_KV_WRITE=1``."""
    monkeypatch.setenv("PST_FUSED_KV_WRITE", "1" if fused else "0")
    model = Llama(get_model_config("tiny-llama-debug"))
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    cache = model.make_kv_cache(4, 8, device=torch.device("cpu"))
    i32 = dict(dtype=torch.int32)
    tables = torch.tensor([[2, 0]], **i32)
    model.forward(params, torch.tensor([[1, 2, 3, 4, 5]], **i32),
                  torch.arange(5, **i32)[None], torch.arange(16, 21, **i32)[None],
                  tables, torch.tensor([5], **i32), torch.tensor([4], **i32),
                  cache, attn_impl="gather")
    logits, _ = model.forward(
        params, torch.tensor([[6]], **i32), torch.tensor([[5]], **i32),
        torch.tensor([[21]], **i32), tables, torch.tensor([6], **i32),
        torch.zeros(1, **i32), cache, attn_impl=impl)
    return logits, cache


def test_fused_kv_write_needs_cuda_and_never_fuses_gather(monkeypatch):
    """PST_FUSED_KV_WRITE=1 routes a decode step of impl='cuda' to the fused
    CUDA kernel, which refuses CPU tensors like every CUDA path; under
    impl='gather' the flag changes nothing. On CPU tensors the kernels'
    wrappers run their plain versions and count no launch."""
    with pytest.raises(ValueError, match="CUDA"):
        _decode_step(monkeypatch, "cuda", fused=True)
    plain, plain_cache = _decode_step(monkeypatch, "gather", fused=False)
    flagged, flagged_cache = _decode_step(monkeypatch, "gather", fused=True)
    assert torch.equal(plain, flagged) and torch.equal(plain_cache, flagged_cache)

    pac.reset_launch_counts()
    i4.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(-128, 128, (16, 8)).astype(np.int8))
    scales = torch.from_numpy(rng.random((2, 8)).astype(np.float32))
    assert torch.equal(i4.int4_matmul(x, packed, scales),
                       i4.int4_matmul_plain(x, packed, scales))
    kv = torch.zeros(1, 4, 2, 8, 256)
    args = (torch.ones(1, 2, 128), kv, torch.tensor([[1, 2]], dtype=torch.int32),
            torch.tensor([3], dtype=torch.int32), 0, torch.ones(1, 256),
            torch.full((1, 256), 2.0), torch.tensor([10], dtype=torch.int32))
    out = pac.paged_attention_decode_write(*args, scale=1.0)
    # Row 2 of page 1, the only key q scores above the zero rows, is read back.
    assert torch.allclose(out, torch.full((1, 2, 128), 2.0))
    assert torch.equal(kv[0, 1, :, 2], torch.stack([args[5][0], args[6][0]]))
    assert set(pac.launch_counts.values()) == {0}
    assert i4.launch_counts == {"int4": 0}
