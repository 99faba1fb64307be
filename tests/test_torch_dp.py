"""The port's data parallelism on the CPU: two replicas over gloo against
the one-rank port and the JAX package at ``data_parallel_size=2``.

One rank group serves the module (this process is replica 0, one spawned
process replica 1). A batch whose rows divide by 2 is split, each
replica running its half, sharing its K/V rows with the other after
every forward and gathering every row it sampled; any other batch runs
whole on both (the JAX rule).

- A split forward (four prompts' prefill, then a decode step of the four
  rows) equals the one-rank port's logits bit for bit, and the replicas'
  caches are equal bit for bit after it; the decode row bucket's floor
  is ``dp``.
- Greedy tokens of dp-2 engines through a lazy warmup, bursts, pipelined
  bursts and the verify step equal a JAX engine's at
  ``data_parallel_size=2``, seeded sampled bursts draw its tokens, and
  both replicas' caches are equal after each engine's run.
- Pages leave a dp-2 engine whole and a small pool's swaps give the
  one-rank engine's tokens and swap counts.
"""

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.precompile import decode_row_buckets
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.registry import get_model_config

from .test_torch_pp import (
    COMMON,
    check_engines,
    check_pages,
    parallel_ranks,
    runner_on,
)

DP = dict(data_parallel_size=2, device="cpu")


@pytest.fixture(scope="module")
def ranks():
    with parallel_ranks(DP) as r:
        yield r


@pytest.fixture(scope="module")
def jax_dp2():
    return JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        data_parallel_size=2, **COMMON))


def _split_steps(nb: int, bs: int, vocab: int):
    """Four prompts of 13, 20, 7 and 16 tokens prefilled into their own
    pages, then one decode step of the four rows."""
    rng = np.random.default_rng(9)
    lens = (13, 20, 7, 16)
    T, W = max(lens), 4
    tables = np.arange(4 * W, dtype=np.int32).reshape(4, W)
    drop = nb * bs

    def slot(i, p):
        return int(tables[i, p // bs]) * bs + p % bs

    tokens = np.zeros((4, T), np.int32)
    positions = np.zeros((4, T), np.int32)
    write = np.full((4, T), drop, np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, vocab, n)
        positions[i, :n] = np.arange(n)
        positions[i, n:] = n - 1
        write[i, :n] = [slot(i, p) for p in range(n)]
    prefill = {"tokens": tokens, "positions": positions, "write_idx": write,
               "block_tables": tables, "kv_lens": np.array(lens, np.int32),
               "last_idx": np.array(lens, np.int32) - 1}
    decode = {"tokens": rng.integers(1, vocab, (4, 1)).astype(np.int32),
              "positions": np.array(lens, np.int32)[:, None],
              "write_idx": np.array([[slot(i, n)] for i, n in
                                     enumerate(lens)], np.int32),
              "block_tables": tables,
              "kv_lens": np.array(lens, np.int32) + 1,
              "last_idx": np.zeros(4, np.int32)}
    return prefill, decode


def test_a_split_forward_equals_one_rank_and_shares_its_rows(ranks, jax_dp2):
    params = params_from_jax(jax.tree.map(np.asarray, jax_dp2.runner.params))
    cfg = get_model_config("tiny-llama-debug")
    kw = dict(num_kv_blocks=32, block_size=8)
    one = ModelRunner(EngineConfig(**{**COMMON, "device": "cpu", **kw}),
                      cfg, params)
    with runner_on(ranks, DP, cfg, params, **kw) as runner:
        assert runner._row_bucket(1) == 2
        for batch in _split_steps(32, 8, cfg.vocab_size):
            got = runner.forward_logits(batch)
            assert got.shape == (4, cfg.vocab_size)
            assert torch.equal(got, one.forward_logits(batch))
        parts = runner.page_replicas(list(range(runner.num_blocks)))
        assert torch.equal(parts[0], parts[1])
        assert torch.equal(parts[0], one.page_replicas(
            list(range(one.num_blocks)))[0])
    assert decode_row_buckets(EngineConfig(**DP, max_num_seqs=8)) == [
        2, 4, 8]


def test_greedy_and_seeded_engines_match_the_jax_engine(ranks, jax_dp2):
    check_engines(ranks, DP, jax_dp2)


def test_pages_move_in_the_one_rank_layout(ranks, jax_dp2):
    check_pages(ranks, DP, params_from_jax(
        jax.tree.map(np.asarray, jax_dp2.runner.params)))
