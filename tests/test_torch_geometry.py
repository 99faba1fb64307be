"""Head geometries on the port's kernels, checked on the CPU.

``kernel_route`` is the kernels' own geometry and type check (``_check``
calls it before every launch), so every preset the port's ``Llama``
accepts must pass it for each cache dtype the engine serves, and a preset
without a kernel cannot land again. A G = 7 model with Qwen2 biases (the
head grouping of ``qwen2-7b``) is held against the JAX package at a tiny
width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu_torch.engine.config import (
    EngineConfig,
    kv_cache_torch_dtype,
)
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama
from production_stack_tpu_torch.models.registry import PRESETS
from production_stack_tpu_torch.ops import paged_attention_cuda as pac

from .test_torch_model import BS, NB, _agree, _jax_params, _steps, _variant

KINDS = ("decode", "decode_write", "prefill")


def test_every_served_preset_has_a_kernel():
    served = []
    for name, cfg in PRESETS.items():
        try:
            Llama(cfg)
        except NotImplementedError:
            continue  # an architecture the port does not serve yet
        served.append(name)
        q = cfg.torch_dtype
        for kv in (None, "float8_e4m3fn"):
            cache = kv_cache_torch_dtype(
                EngineConfig(model=name, kv_cache_dtype=kv), cfg)
            for kind in KINDS:
                route = pac.kernel_route(kind, q, cache, cfg.num_heads,
                                         cfg.num_kv_heads, cfg.head_dim)
                want = ("simt" if q == torch.float32
                        or cfg.head_dim not in (128, 256)
                        else "wgmma" if kind == "prefill" else "split")
                assert route == want, (name, kv, kind, route)
    assert {"tiny-llama-debug", "llama-3-8b", "qwen2-7b", "gemma-7b",
            "gemma2-9b", "qwen3-8b", "tiny-gemma-debug", "tiny-gemma2-debug",
            "tiny-qwen3-debug", "tiny-mixtral-debug",
            "mixtral-8x7b"} <= set(served)


def test_kernel_route_refuses_what_no_kernel_takes():
    bf16, e4m3 = torch.bfloat16, torch.float8_e4m3fn
    # Head dims no kernel takes.
    for hd in (96, 512):
        with pytest.raises(ValueError, match="queue 2 item 2"):
            pac.kernel_route("decode", bf16, bf16, 16, 16, hd)
    with pytest.raises(ValueError, match="1 to 8"):
        pac.kernel_route("prefill", bf16, e4m3, 36, 4, 128)  # G = 9
    with pytest.raises(ValueError):
        pac.kernel_route("decode", bf16, bf16, 12, 8, 128)  # H % KH
    with pytest.raises(ValueError):
        pac.kernel_route("decode", torch.float32, torch.float32, 8, 8, 48)
    with pytest.raises(TypeError):
        pac.kernel_route("decode", bf16, torch.float8_e5m2, 8, 8, 128)
    with pytest.raises(TypeError):
        pac.kernel_route("decode", bf16, torch.float32, 8, 8, 128)
    with pytest.raises(ValueError):
        pac.kernel_route("verify", bf16, bf16, 8, 8, 128)
    for G in range(1, 9):
        assert pac.kernel_route("decode", bf16, e4m3, 4 * G, 4, 128) == "split"
        for cache in (bf16, e4m3):  # head_dim 256: the Gemma family
            for kind in KINDS:
                assert pac.kernel_route(kind, bf16, cache, 4 * G, 4, 256) == (
                    "wgmma" if kind == "prefill" else "split")
            assert pac.kernel_route("decode", torch.float32, e4m3, 4 * G, 4,
                                    256) == "simt"


def test_g7_qwen2_bias_forward_matches_jax():
    """14 query heads over 2 kv heads (G = 7, as qwen2-7b's 28 over 4),
    Qwen2 QKV biases, fp32: one chunked prefill and three decode steps
    through both packages' gather paths on the same weights, logits under
    the numerics oracle's rule and the caches equal."""
    jcfg, tcfg = _variant(num_heads=14, num_kv_heads=2, attention_bias=True,
                          dtype="float32")
    assert tcfg.num_heads // tcfg.num_kv_heads == 7
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = _jax_params(jmodel, jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jforward = jax.jit(jmodel.forward, static_argnames=("attn_impl",))
    jcache = jmodel.make_kv_cache(NB, BS)
    tcache = tmodel.make_kv_cache(NB, BS, device=torch.device("cpu"))
    for i, step in enumerate(_steps(seed=3, vocab=jcfg.vocab_size)):
        want, jcache = jforward(
            jparams, *(jnp.asarray(a) for a in step), jcache,
            attn_impl="gather")
        got, tcache = tmodel.forward(
            tparams, *(torch.from_numpy(a) for a in step), tcache,
            attn_impl="gather")
        _agree(got.numpy()[:1], np.asarray(want)[:1], f"G=7 step {i}")
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               rtol=1e-5, atol=1e-5)
