"""The port's KV swap against the JAX engine's, on the CPU.

The runner's page I/O (``download_page`` / ``upload_page``) must move
the bytes the JAX runner's moves, over a float cache and an e4m3 cache,
and write into the cache in place. A tiny engine whose pool is too small
for its requests must swap (or, with ``kv_swap`` off, recompute) where
the JAX engine does and serve its greedy tokens; an aborted parked
request leaves no stash behind, and a level-2 sleep with parked requests
leaves an engine that swaps again into its restored cache.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import (
    engine_config_from_args,
    parse_engine_args,
)
from production_stack_tpu_torch.models.convert import params_from_jax

from .test_torch_overlap_decode import _reqs, _run

# Twenty-eight 8-token pages for four requests that grow to 9-10 pages
# each: parked sequences resume, and some lose committed pages to the
# others' growth and recompute.
SMALL = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
             num_kv_blocks=28, max_num_seqs=4, max_prefill_tokens=64,
             num_decode_steps=2, overlap_decode=False)
LENGTHS, MAX_TOKENS = (30, 34, 27, 38), (40, 40, 44, 36)
SWAP_KEYS = ("num_preemptions_total", "kv_swap_out_total", "kv_swap_in_total",
             "kv_swap_tail_pages_total", "kv_swap_fallback_recompute_total",
             "kv_swap_stash_blocks", "num_requests_swapped")


def _jax(**over):
    return JaxLLMEngine(JaxEngineConfig(**{**SMALL, "attn_impl": "gather",
                                           "async_decode": False, **over}))


def _port(jax_engine, **over):
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jax_engine.runner.params))
    return LLMEngine(EngineConfig(**{**SMALL, "device": "cpu", **over}),
                     params=params)


@pytest.mark.parametrize("kv_dtype", [None, "float8_e4m3fn"])
def test_page_io_moves_the_jax_runners_bytes(kv_dtype):
    jeng = _jax(kv_cache_dtype=kv_dtype)
    port = _port(jeng, kv_cache_dtype=kv_dtype).runner
    jr = jeng.runner
    cache = port.kv_cache
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (*cache.shape, cache.element_size()),
                       dtype=np.uint8)
    # The same bytes in both caches (NaN codes of e4m3 included).
    np_dtype = (ml_dtypes.float8_e4m3fn if kv_dtype
                else np.dtype(str(cache.dtype).split(".")[1]))
    jr.kv_cache = jnp.asarray(raw.view(np_dtype).reshape(cache.shape))
    cache.view(torch.uint8).view(*cache.shape, -1).copy_(torch.from_numpy(raw))
    ptr = cache.data_ptr()
    for blk in (0, 7, port.num_blocks - 1):
        k, v = port.download_page(blk)
        jk, jv = jr.download_page(blk)
        assert k.dtype == cache.dtype  # the stash keeps the cache's type
        for got, want in ((k, jk), (v, jv)):
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                          np.asarray(want).view(np.uint8))
    # An upload writes the page in place, and the same bytes JAX writes.
    src_k, src_v = port.download_page(3)
    port.upload_page(11, src_k, src_v)
    jk, jv = jr.download_page(3)
    jr.upload_page(11, jk, jv)
    assert port.kv_cache.data_ptr() == ptr
    np.testing.assert_array_equal(
        port.kv_cache.view(torch.uint8).numpy().reshape(raw.shape),
        np.asarray(jr.kv_cache).view(np.uint8).reshape(raw.shape))


@pytest.mark.parametrize("mode, over", [
    ("swap", dict(kv_swap=True, swap_quantum_tokens=16)),
    # Recompute preemption at this pool thrashes in the JAX engine (each
    # re-prefill evicts the next; the port's admission does not, see
    # test_torch_scheduler_liveness.py): 35 pages preempt once in both.
    ("recompute", dict(kv_swap=False, num_kv_blocks=35)),
])
def test_small_pool_serves_the_jax_engines_tokens(mode, over):
    # The defaults are the JAX engine's, in the config and the server.
    flags = engine_config_from_args(parse_engine_args([]))
    for name in ("kv_swap", "swap_quantum_tokens", "swap_stash_blocks",
                 "deadline_shedding", "tenant_fairness"):
        want = getattr(JaxEngineConfig(), name)
        assert getattr(EngineConfig(), name) == getattr(flags, name) == want
    jeng = _jax(**over)
    port = _port(jeng, **over)
    _, want = _run(jeng, _reqs(LENGTHS, MAX_TOKENS, JaxSamplingParams,
                               temperature=0.0))
    _, got = _run(port, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                              temperature=0.0))
    assert got == want
    js, ps = jeng.stats(), port.stats()
    for key in SWAP_KEYS:
        assert ps.get(key) == js.get(key), key
    if mode == "swap":
        assert ps["kv_swap_in_total"] > 0
        assert ps["kv_swap_fallback_recompute_total"] > 0
        assert ps["kv_swap_in_total"] + ps[
            "kv_swap_fallback_recompute_total"] == ps["kv_swap_out_total"]
    else:
        assert ps["num_preemptions_total"] > 0 and "kv_swap_out_total" not in ps
    assert port.allocator.num_free == port.allocator.num_blocks


def _until_parked(engine: LLMEngine) -> list:
    """Step until a request is parked; returns the parked ids."""
    for _ in range(500):
        engine.step()
        if engine.scheduler.swapped:
            return [s.request_id for s in engine.scheduler.swapped]
    raise AssertionError("no request was parked")


def test_aborted_parked_request_drops_its_stash():
    port = _port(_jax())
    for rid, prompt, sp in _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                                 temperature=0.0):
        port.add_request(rid, prompt_token_ids=prompt, sampling=sp)
    parked = _until_parked(port)
    swapper = port.swapper
    assert swapper.stash_blocks > 0 and parked[0] in swapper
    stash = swapper.stash_blocks
    assert port.abort_request(parked[0])
    assert parked[0] not in swapper
    assert swapper.stash_blocks < stash
    assert parked[0] not in {s.request_id for s in port.scheduler.swapped}
    while port.has_work():
        port.step()
    assert swapper.stash_blocks == 0 and port.scheduler.num_swapped == 0
    assert port.allocator.num_free == port.allocator.num_blocks


def test_level2_sleep_with_parked_requests_then_swaps_into_the_new_cache():
    jeng = _jax(swap_quantum_tokens=16)
    engine = AsyncLLMEngine(EngineConfig(**{**SMALL, "device": "cpu",
                                            "swap_quantum_tokens": 16}),
                            params=params_from_jax(jax.tree.map(
                                np.asarray, jeng.runner.params)))
    eng = engine.engine  # no step thread: sleep and wake run inline
    for rid, prompt, sp in _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                                 temperature=0.0):
        eng.add_request("pre-" + rid, prompt_token_ids=prompt, sampling=sp)
    _until_parked(eng)
    assert eng.swapper.stash_blocks > 0
    swaps_before = eng.swapper.swap_out_total
    engine.sleep(level=2)
    assert not eng.has_work() and eng.swapper.stash_blocks == 0
    assert eng.allocator.num_free == eng.allocator.num_blocks
    assert eng.scheduler.allocator is eng.allocator
    engine.wake_up()
    # The same requests after the wake: parked and resumed through the
    # restored cache, with the JAX engine's tokens.
    _, want = _run(jeng, _reqs(LENGTHS, MAX_TOKENS, JaxSamplingParams,
                               temperature=0.0))
    _, got = _run(eng, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                             temperature=0.0))
    assert got == want
    assert eng.swapper.swap_out_total > swaps_before
    assert eng.swapper.swap_in_total > 0
    assert eng.allocator.num_free == eng.allocator.num_blocks
