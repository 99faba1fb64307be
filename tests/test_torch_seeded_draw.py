"""The port's seeded draw against ``jax.random``, and what it samples.

``ops/sampling.py::threefry_bits`` computes the JAX sampler's draw,
``jax.random.gumbel(jax.random.PRNGKey(seed), (K,))``, with int64 torch
ops: its 32-bit words must be ``jax.random.bits``' bit for bit and its
Gumbel values within 1e-6 of JAX's (the two ``log``s may round apart).
``sample_tokens`` must then pick the JAX sampler's tokens on the same
seeded logits, and a ``tiny-llama-debug`` engine of each package, on the
same weights (``params_from_jax``), the same tokens for seeded requests
at temperature 0.8 (the token rule of
``tests/test_numerics_oracle.py::_agree``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.ops import sampling as jsamp
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.ops import sampling as tsamp

# The seeds of the issue, and two a decode burst reaches past 2^31 - 1 (the
# JAX runners add the step index to a uint32 seed, which does not wrap
# there; the port adds it to an int64 one).
SEEDS = np.array([0, 1, 7, 12345, 2**31 - 1, 2**31, 2**31 + 2], np.uint32)


@jax.jit
def _jax_bits(seeds):
    return {k: jax.vmap(lambda s: jax.random.bits(
        jax.random.PRNGKey(s), (k,), jnp.uint32))(seeds) for k in (256, 300)}


@jax.jit
def _jax_gumbel(seeds):
    return {k: jax.vmap(lambda s: jax.random.gumbel(
        jax.random.PRNGKey(s), (k,), jnp.float32))(seeds) for k in (256, 300)}


_jax_sample = jax.jit(jsamp.sample_tokens)


def _seeds():
    return torch.from_numpy(SEEDS.astype(np.int64))


def test_words_equal_jax_random_bits():
    want = _jax_bits(jnp.asarray(SEEDS))
    for k, w in want.items():
        got = tsamp.threefry_bits(_seeds(), k).numpy()
        assert got.min() >= 0 and got.max() < 2**32
        np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(w))


def test_gumbel_within_1e6_of_jax():
    want = _jax_gumbel(jnp.asarray(SEEDS))
    for k, w in want.items():
        got = tsamp.gumbel_noise(_seeds(), k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_sample_tokens_equal_the_jax_sampler():
    """Logits wider than the top-k cap (K = 256), each row at its own
    temperature, with top-k, top-p and min-p cuts, over 8 draws."""
    rng = np.random.default_rng(3)
    B, V = len(SEEDS), 1000
    temps = np.array([0.0, 0.5, 0.8, 1.0, 1.3, 0.8, 2.0], np.float32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.7, 1.0, 0.95, 1.0], np.float32)
    top_ks = np.array([0, 0, 40, 0, 5, 0, 100], np.int32)
    min_ps = np.array([0.0, 0.0, 0.0, 0.05, 0.0, 0.1, 0.0], np.float32)
    for draw in range(8):
        lg = rng.standard_normal((B, V)).astype(np.float32) * 3
        seeds = SEEDS + np.uint32(draw)
        want = np.asarray(_jax_sample(
            jnp.asarray(lg), jnp.asarray(temps), jnp.asarray(top_ps),
            jnp.asarray(top_ks), jnp.asarray(min_ps), jnp.asarray(seeds)))
        got = tsamp.sample_tokens(
            torch.from_numpy(lg), torch.from_numpy(temps),
            torch.from_numpy(top_ps), torch.from_numpy(top_ks),
            torch.from_numpy(min_ps),
            torch.from_numpy(seeds.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got, want)


COMMON = dict(model="tiny-llama-debug", block_size=8, max_prefill_tokens=32,
              max_model_len=256, num_kv_blocks=128, max_num_seqs=8)
_rng = np.random.default_rng(1)
PROMPTS = [_rng.integers(1, 512, n).tolist() for n in (40, 13, 7)]
SAMPLING = dict(max_tokens=12, temperature=0.8, top_p=0.95, top_k=50,
                seed=1234, ignore_eos=True)


@pytest.fixture(scope="module")
def jax_run():
    engine = JaxLLMEngine(JaxEngineConfig(num_decode_steps=1, **COMMON))
    out = engine.generate([list(p) for p in PROMPTS],
                          JaxSamplingParams(**SAMPLING))
    return engine, out


@pytest.mark.parametrize("steps", [1, 4])
def test_seeded_engine_equals_the_jax_engine(jax_run, steps):
    """The port stepping one token at a time, and in four-step decode
    bursts (each step's seed derived on the device)."""
    jax_engine, want = jax_run
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jax_engine.runner.params))
    engine = LLMEngine(EngineConfig(num_decode_steps=steps, device="cpu",
                                    **COMMON), params=params)
    got = engine.generate([list(p) for p in PROMPTS],
                          SamplingParams(**SAMPLING))
    for g, w in zip(got, want, strict=True):
        assert g["token_ids"] == w["token_ids"]
