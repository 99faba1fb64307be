"""The PyTorch port's speculative engine (``speculative_ngram=4``) against
the JAX spec engine and against the port's own plain engine, on the
cases of ``tests/test_spec_decode.py``: the repetitive and the random
prompt, a batch of four, a greedy and a seeded sampled request in one
batch, the ``max_model_len=32`` clamp and the 24-page pool; and
``tiny-gemma2-debug`` (attention and final softcaps, a 16-token window
on alternate layers, a tied unembed), whose rows run past the window
while they draft and verify.

Both packages run their gather paths on the same weights. In each case
the port's spec engine gives the JAX spec engine's tokens, its proposed
and accepted draft totals (``stats()`` too), and the tokens of the
port's plain engine: greedy output does not change with speculation.
The port's plain engine runs the synchronous loop (``overlap_decode``
off), so no wall-clock gate decides its steps.
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

COMMON = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
              num_kv_blocks=128, max_num_seqs=8, max_prefill_tokens=64)
REPEAT = [11, 22, 33, 44, 55, 66, 77, 88, 11, 22, 33, 44, 55, 66, 77, 88,
          11, 22, 33, 44]
RANDOM = [3, 17, 98, 255, 42, 7, 205, 131, 8, 77, 123, 9, 54, 201, 33, 4]

_PARAMS = {}


def _params(model=COMMON["model"]):
    """The JAX tiny engine's weights of ``model``, converted once for the
    module."""
    if model not in _PARAMS:
        engine = JaxLLMEngine(JaxEngineConfig(
            attn_impl="gather", **dict(COMMON, model=model)))
        _PARAMS[model] = jax.tree.map(np.asarray, engine.runner.params)
    return _PARAMS[model]


def _engines(**over):
    """(JAX spec engine, port spec engine, port plain engine) of one
    config on the same weights."""
    jcfg = dict(COMMON, attn_impl="gather", speculative_ngram=4, **over)
    jax_spec = JaxLLMEngine(JaxEngineConfig(**jcfg))
    params = _params(jcfg["model"])
    # The same seed draws the same weights.
    assert np.array_equal(np.asarray(jax_spec.runner.params["embed"]),
                          params["embed"])
    tcfg = dict(COMMON, device="cpu", **over)
    return (jax_spec,
            LLMEngine(EngineConfig(speculative_ngram=4, **tcfg),
                      params=params_from_jax(params)),
            LLMEngine(EngineConfig(overlap_decode=False, **tcfg),
                      params=params_from_jax(params)))


def _drive(engine, waves):
    """Each wave's requests added together, then stepped to completion;
    returns the tokens by request id."""
    sp_cls = (JaxSamplingParams if isinstance(engine, JaxLLMEngine)
              else SamplingParams)
    toks = {}
    for wave in waves:
        for rid, prompt, sp in wave:
            engine.add_request(rid, prompt_token_ids=list(prompt),
                               sampling=sp_cls(ignore_eos=True, **sp))
            toks[rid] = []
        for _ in range(2000):
            if not engine.has_work():
                break
            for out in engine.step():
                toks[out.request_id].extend(out.new_token_ids)
        assert not engine.has_work(), "engine did not drain"
    return toks


GREEDY16 = dict(max_tokens=16, temperature=0.0)
CASES = {
    # The JAX tests' prompts alone: high acceptance, then rejects and the
    # no-draft fallback.
    "repeat": ({}, [[("s", REPEAT, dict(max_tokens=24, temperature=0.0))]]),
    "random": ({}, [[("s", RANDOM, dict(max_tokens=24, temperature=0.0))]]),
    "batch_of_four": ({}, [[
        (f"r{i}", p, GREEDY16) for i, p in enumerate(
            [REPEAT, RANDOM, REPEAT[4:], [9] * 9])]]),
    # Sampled rows ride the verify step, position 0 fully sampled.
    "mixed_greedy_and_seeded": ({}, [[
        ("g", REPEAT, GREEDY16),
        ("s", RANDOM, dict(max_tokens=16, temperature=0.9, seed=11))]]),
    # Rows near max_model_len get no drafts; the 20 + 11 tokens stop short.
    "max_model_len_32": (dict(max_model_len=32), [[
        ("m", REPEAT[:20], dict(max_tokens=11, temperature=0.0))]]),
    # The tight pool of the JAX test, its three runs one after the other
    # (prefix hits on the repeated prompt).
    "pool_of_24_pages": (dict(num_kv_blocks=24, max_num_seqs=4), [
        [(f"p{i}", REPEAT, GREEDY16)] for i in range(3)]),
    # Gemma-2: softcapped verify logits, and rows of 44 and 40 tokens
    # beside the 16-token window of every other layer.
    "gemma2_softcap_window": (dict(model="tiny-gemma2-debug"), [[
        ("g", REPEAT, dict(max_tokens=24, temperature=0.0)),
        ("h", REPEAT[4:], dict(max_tokens=24, temperature=0.0))]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_engine_equals_jax_and_plain(case):
    over, waves = CASES[case]
    jax_spec, port_spec, port_plain = _engines(**over)
    want = _drive(jax_spec, waves)
    got = _drive(port_spec, waves)
    plain = _drive(port_plain, waves)
    assert got == want
    assert got == plain
    n_tok = {rid: sp["max_tokens"] for wave in waves for rid, _, sp in wave}
    assert {rid: len(t) for rid, t in got.items()} == n_tok
    assert (port_spec.spec_proposed_total, port_spec.spec_accepted_total) == (
        jax_spec.spec_proposed_total, jax_spec.spec_accepted_total)
    stats = port_spec.stats()
    assert stats["spec_decode_num_draft_tokens_total"] == float(
        port_spec.spec_proposed_total)
    assert stats["spec_decode_num_accepted_tokens_total"] == float(
        port_spec.spec_accepted_total)
    assert "spec_decode_num_draft_tokens_total" not in port_plain.stats()
    if case in ("repeat", "batch_of_four", "mixed_greedy_and_seeded",
                "gemma2_softcap_window"):
        assert port_spec.spec_accepted_total > 0  # speculation shortcut steps
