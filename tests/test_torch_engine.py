"""The PyTorch engine vs the JAX engine on the same weights.

Both engines serve ``tiny-llama-debug`` with 8-token pages and a 32-token
prefill budget, so the 50-token prompt is prefilled in chunks; the port's
engine runs on the CPU with the JAX engine's parameters converted by
``params_from_jax``. Greedy token ids must equal the JAX engine's
token-by-token output, for the port stepping one token at a time and in
four-step decode bursts, greedy and with penalties, a logit bias and a
guided choice. The JAX reference runs once per case (its compiles are the
costly part of this file).
"""

import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax

COMMON = dict(model="tiny-llama-debug", block_size=8, max_prefill_tokens=32,
              max_model_len=256, num_kv_blocks=128, max_num_seqs=8)

_rng = np.random.default_rng(0)
PROMPTS = [
    _rng.integers(1, 512, 50).tolist(),  # longer than the prefill budget
    _rng.integers(1, 512, 13).tolist(),
    _rng.integers(1, 512, 7).tolist(),
]
SAMPLING = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
CASES = {
    "greedy": (PROMPTS, SAMPLING),
    "penalties": (PROMPTS[1:], dict(
        SAMPLING, ignore_eos=False, repetition_penalty=1.3,
        presence_penalty=0.5, frequency_penalty=0.2)),
    "logit_bias": (PROMPTS[1:], dict(
        SAMPLING, ignore_eos=False, logit_bias=((5, 4.0), (17, -2.0)))),
    "guided_choice": (PROMPTS[1:], dict(
        SAMPLING, ignore_eos=False, max_tokens=5,
        guided_choice=((7, 8, 9), (7, 10), (11,)))),
}


@pytest.fixture(scope="module")
def jax_engine():
    return JaxLLMEngine(JaxEngineConfig(num_decode_steps=1, **COMMON))


@pytest.fixture(scope="module")
def reference(jax_engine):
    """The JAX engine's outputs per case, computed on first use."""
    done = {}

    def get(case):
        if case not in done:
            prompts, kw = CASES[case]
            done[case] = jax_engine.generate(
                [list(p) for p in prompts], JaxSamplingParams(**kw))
        return done[case]

    return get


@pytest.fixture(scope="module", params=[1, 4], ids=lambda n: f"steps{n}")
def port_engine(request, jax_engine):
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.runner.params))
    return LLMEngine(
        EngineConfig(num_decode_steps=request.param, device="cpu", **COMMON),
        params=params)


def test_greedy_tokens_match_jax_engine(port_engine, reference):
    for case, (prompts, kw) in CASES.items():
        want = reference(case)
        got = port_engine.generate([list(p) for p in prompts],
                                   SamplingParams(**kw))
        for w, g in zip(want, got):
            assert g["token_ids"] == w["token_ids"], case
            assert g["text"] == w["text"], case
            assert g["finish_reason"] == w["finish_reason"], case
        assert not port_engine.has_work()
        assert port_engine.stats()["num_requests_running"] == 0.0


def test_prefix_cache_reuse_keeps_tokens(port_engine):
    """A repeated prompt is served from the prefix cache and gives the same
    greedy tokens."""
    sp = SamplingParams(**SAMPLING)
    first = port_engine.generate([list(PROMPTS[0])], sp)[0]
    hits = port_engine.allocator.hit_tokens
    again = port_engine.generate([list(PROMPTS[0])], sp)[0]
    assert port_engine.allocator.hit_tokens > hits
    assert again["token_ids"] == first["token_ids"]
    assert first["finish_reason"] == "length"
