"""The port's fp8 (e4m3) KV cache against the JAX package's, on the CPU.

``cast_e4m3`` must write the bytes JAX's ``astype(float8_e4m3fn)`` writes,
NaN and its sign included; the port's ``Llama`` with an e4m3 cache must
agree with the JAX ``Llama`` with the same cache dtype, step by step, and
write the same bytes; an engine with an e4m3 cache serves deterministic
greedy tokens from fp8 pages, prefix hits included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu_torch.engine.config import (
    EngineConfig,
    kv_cache_torch_dtype,
    resolve_num_kv_blocks,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama, LlamaConfig
from production_stack_tpu_torch.models.registry import get_model_config
from production_stack_tpu_torch.ops.fp8 import cast_e4m3, raw

from .test_numerics_oracle import FAMILIES, _agree
from .test_torch_model import BS, NB, _steps

_jax_cast = jax.jit(lambda x: x.astype(jnp.float8_e4m3fn))


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(_jax_cast(jnp.asarray(x))).view(np.uint8)


def test_cast_e4m3_matches_jax_bit_for_bit():
    # Every bf16 bit pattern: zeros, subnormals, the ties at 464, the
    # overflow past it, +-inf and NaNs of both signs.
    bits = np.arange(1 << 16, dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    got = raw(cast_e4m3(x)).numpy()
    np.testing.assert_array_equal(got, _bits(bits.view(ml_dtypes.bfloat16)))
    # fp32 over e4m3's whole range and past it, with the edges that bf16
    # cannot hold (465 overflows, 464 does not).
    rng = np.random.default_rng(0)
    f = (rng.standard_normal(1 << 18)
         * rng.choice([1e-3, 1.0, 30.0, 300.0, 3000.0], 1 << 18)
         ).astype(np.float32)
    f[:10] = [464.0, np.nextafter(np.float32(464), np.float32(1e9)), -465.0,
              448.0, -480.0, np.inf, -np.inf, np.nan, -np.nan, 2.0 ** -10]
    got = raw(cast_e4m3(torch.from_numpy(f))).numpy()
    np.testing.assert_array_equal(got, _bits(f))
    assert list(got[:3]) == [0x7E, 0x7F, 0xFF]


def test_kv_cache_dtype_config():
    """The cache holds the model dtype or e4m3, anything else raises; an
    e4m3 page is half a bf16 page, so the same budget holds twice the
    pages."""
    mcfg = get_model_config("llama-1b")
    assert kv_cache_torch_dtype(EngineConfig(), mcfg) == torch.bfloat16
    assert kv_cache_torch_dtype(EngineConfig(kv_cache_dtype="bfloat16"),
                                mcfg) == torch.bfloat16
    cfg8 = EngineConfig(kv_cache_dtype="float8_e4m3fn", max_num_seqs=1,
                        max_model_len=64)
    assert kv_cache_torch_dtype(cfg8, mcfg) == torch.float8_e4m3fn
    for bad in ("float16", "float32", "float8_e5m2", "int8"):
        with pytest.raises(ValueError):
            kv_cache_torch_dtype(EngineConfig(kv_cache_dtype=bad), mcfg)
    cpu = torch.device("cpu")  # a fixed 512 MiB budget on the CPU
    n16 = resolve_num_kv_blocks(dataclasses.replace(cfg8, kv_cache_dtype=None),
                                mcfg, cpu)
    n8 = resolve_num_kv_blocks(cfg8, mcfg, cpu)
    assert n8 == 2 * n16


def test_fp8_cache_forward_matches_jax():
    """The port's version of test_numerics_oracle's
    test_fp8_kv_matches_rounded_reference: ``llama-gqa`` (fp32, 8 heads
    over 2 kv heads) with an e4m3 cache, a 20-token prefill (a padding row,
    dropped tail writes) and three decode steps through both packages'
    gather paths; logits under the oracle's fp8 rule, and the caches byte
    for byte (both write K/V cast from fp32 by the same rounding)."""
    jcfg = FAMILIES["llama-gqa"]
    tcfg = LlamaConfig(**dataclasses.asdict(jcfg))
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(11))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jforward = jax.jit(jmodel.forward, static_argnames=("attn_impl",))
    jcache = jmodel.make_kv_cache(NB, BS, "float8_e4m3fn")
    tcache = tmodel.make_kv_cache(NB, BS, dtype=torch.float8_e4m3fn,
                                  device=torch.device("cpu"))
    assert tcache.dtype == torch.float8_e4m3fn
    for i, step in enumerate(_steps(seed=8, vocab=jcfg.vocab_size)):
        want, jcache = jforward(
            jparams, *(jnp.asarray(a) for a in step), jcache,
            attn_impl="gather")
        got, tcache = tmodel.forward(
            tparams, *(torch.from_numpy(a) for a in step), tcache,
            attn_impl="gather")
        _agree(got.numpy()[:1], np.asarray(want)[:1], f"fp8 step {i}",
               atol_scale=5e-3)
    jc = np.asarray(jcache).view(np.uint8)
    np.testing.assert_array_equal(raw(tcache).numpy(), jc)
    assert np.count_nonzero(jc.reshape(-1, jc.shape[-1]).any(-1)) > 0


def test_fp8_kv_cache_serves():
    """The port's version of test_engine_core's test_fp8_kv_cache_serves:
    an engine on an e4m3 cache (on the CPU, through the plain paths)
    generates the same greedy tokens twice, the second time from prefix
    hits on its fp8 pages."""
    prompt = list(range(5, 120))
    eng = LLMEngine(EngineConfig(
        model="tiny-llama-debug", max_model_len=256, block_size=8,
        num_kv_blocks=96, max_num_seqs=4, max_prefill_tokens=64,
        kv_cache_dtype="float8_e4m3fn", device="cpu"))
    assert eng.runner.kv_cache.dtype == torch.float8_e4m3fn
    sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    out = eng.generate([prompt], sp)[0]["token_ids"]
    hits = eng.allocator.hit_tokens
    again = eng.generate([prompt], sp)[0]["token_ids"]
    assert again == out
    assert eng.allocator.hit_tokens > hits
    assert len(out) == 8 and all(0 <= t < 512 for t in out)
