"""Fault 3.9: a row's greedy tokens must not depend on when the overlapped
decode engages.

Two things used to follow the engagement step. A pipelined burst keeps
the row bucket it was dispatched at while its rows finish, where the
synchronous loop shrank its bucket with them, and a row's rounding
follows its batch's bucket (a GEMM's algorithm by its row count, the
split-KV decode's splits by its rows). And the synchronous loop swapped
a page that decoding filled for an existing copy of the same tokens,
computed by other steps, while a pipelined burst kept its own. Now a
decode batch's bucket is set when a row joins and held while rows leave
(``ModelRunner._decode_rows``), and a decoded page is never swapped
(``LLMEngine._commit``).

Here, on the CPU: 4 greedy rows with different ``max_tokens`` (so rows
finish inside a continuation), after a warm-up round whose pages they
hit, with the pipeline's arrival gate opened from decode pass k, give
the synchronous loop's tokens and top-2 logprobs bit for bit, and the
JAX engine's under the numerics oracle's tolerance; and unit tests of
the held bucket and of the decoded pages' copies.
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
from production_stack_tpu_torch.engine.sequence import SamplingParams, Sequence
from production_stack_tpu_torch.models.convert import params_from_jax

from .test_numerics_oracle import _agree

TINY = dict(model="tiny-llama-debug", max_model_len=512, block_size=8,
            num_kv_blocks=256, max_prefill_tokens=64, max_num_seqs=8)
PROMPTS = [np.random.default_rng(0).integers(1, 500, n).tolist()
           for n in (37, 50, 61, 45)]
MAX_TOKENS = (20, 33, 41, 27)
ENGAGE = (None, 0, 2, 5)  # None: the pipeline never engages


@pytest.fixture(scope="module")
def jax_engine():
    return JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        overlap_decode=False, **TINY))


@pytest.fixture(scope="module")
def params(jax_engine):
    return params_from_jax(jax.tree.map(np.asarray, jax_engine.runner.params))


def _serve(eng, sampling_cls, with_logprobs: bool) -> dict:
    """Serve ``PROMPTS`` at once; request id -> (tokens, top-2 rows)."""
    out = {}
    for i, p in enumerate(PROMPTS):
        eng.add_request(f"r{i}", prompt_token_ids=p, sampling=sampling_cls(
            max_tokens=MAX_TOKENS[i], temperature=0.0, ignore_eos=True,
            logprobs=2 if with_logprobs else None))
    while eng.has_work():
        for o in eng.step():
            toks, tops = out.setdefault(o.request_id, ([], []))
            toks.extend(o.new_token_ids)
            tops.extend([tuple(t) for t in e["top"]] for e in o.logprobs or ())
    return out


def _engaged_at(k, params):
    """A warm-up round, then the rows with the pipeline's gate opened from
    decode pass ``k`` (None: the synchronous loop). Returns the served
    rows, the row bucket of every decode dispatch and the engine."""
    eng = LLMEngine(EngineConfig(device="cpu", overlap_decode=k is not None,
                                 **TINY), params=params)
    _serve(eng, SamplingParams, False)
    buckets = []
    build = eng.runner._decode_batch

    def recorded(seqs, multi=False):
        batch = build(seqs, multi)
        buckets.append(batch["kv_lens"].shape[0])
        return batch

    eng.runner._decode_batch = recorded
    if k is not None:
        passes = iter(range(1 << 30))
        eng._arrival_safe = lambda: next(passes) >= k
    return _serve(eng, SamplingParams, True), buckets, eng


def test_engagement_moves_no_token_or_logprob(params, jax_engine):
    ref, _, _ = _engaged_at(None, params)
    for k in ENGAGE[1:]:
        got, _, eng = _engaged_at(k, params)
        assert eng.pipelined_bursts_total > 0, k
        assert got == ref, f"engaged after pass {k}"
    # The JAX engine (synchronous) on the same weights, under the numerics
    # oracle's tolerance.
    _serve(jax_engine, JaxSamplingParams, False)
    want = _serve(jax_engine, JaxSamplingParams, True)
    for rid, (toks, tops) in ref.items():
        assert toks == want[rid][0], rid
        _agree(np.array([[lp for _, lp in row] for row in tops]),
               np.array([[lp for _, lp in row] for row in want[rid][1]]),
               rid)


def test_a_decode_batch_holds_its_bucket_while_rows_leave(params):
    """The held bucket, step by step: the pipelined runs build their
    batches at the synchronous run's bucket (4 rows: 4, then held as the
    rows finish), where a per-step bucket would shrink to 2 and 1."""
    _, ref, eng = _engaged_at(None, params)
    assert set(ref) == {4}
    for k in ENGAGE[1:]:
        _, got, _ = _engaged_at(k, params)
        assert set(got) == {4}, k
    runner = eng.runner
    seqs = [Sequence(f"u{i}", [1, 2, 3], SamplingParams()) for i in range(5)]
    assert runner._decode_rows(seqs[:4]) == 4
    assert [runner._decode_rows(seqs[:n]) for n in (3, 2, 1)] == [4, 4, 4]
    # A row joins: the bucket is its batch's again.
    assert runner._decode_rows([seqs[0], seqs[4]]) == 2
    assert runner._decode_rows(seqs[4:]) == 2
    assert runner._decode_rows(seqs) == 8


def test_a_decoded_page_keeps_its_own_copy(params):
    """Two greedy requests on one prompt, one after the other: the second
    one's prefill adopts the first one's prompt pages, but the pages its
    decoding fills stay its own, though the first request committed the
    same tokens."""
    eng = LLMEngine(EngineConfig(device="cpu", overlap_decode=False, **TINY),
                    params=params)
    prompt = PROMPTS[0]
    sp = SamplingParams(max_tokens=30, temperature=0.0, ignore_eos=True)
    eng.add_request("a", prompt_token_ids=prompt, sampling=sp)
    while eng.has_work():
        eng.step()
    first = dict(eng.allocator._block_of_hash)
    seq = eng.add_request("b", prompt_token_ids=prompt, sampling=sp)
    decoded = []
    while eng.has_work():
        eng.step()
        if not seq.is_finished:
            decoded = list(zip(seq.block_hashes, seq.block_ids))
    bs, P = TINY["block_size"], len(prompt)
    prompt_pages = decoded[:P // bs]
    later = decoded[P // bs:]
    assert prompt_pages and later
    assert all(first[h] == b for h, b in prompt_pages)
    assert all(h in first and first[h] != b for h, b in later)
