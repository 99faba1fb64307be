"""The port's dp2 x pp2 grid on the CPU: four ranks over gloo (two
replicas of two stages each) against the JAX package at
``data_parallel_size=2, pipeline_parallel_size=2``.

One rank group serves the module (this process is rank 0, three spawned
processes the others; ranks 0, 1 are replica 0's stages, 2, 3 replica
1's).

- The rank grid: each rank's coordinates, the groups it holds and
  ``/debug/state``'s layout of them.
- Greedy tokens through a lazy warmup, bursts, pipelined bursts and the
  verify step, and seeded sampled bursts, equal the JAX engine's; every
  rank draws the same rows and the replicas' caches are equal, stage by
  stage, after each engine's run.
- Pages leave the engine whole and a small pool's swaps give the
  one-rank engine's tokens and swap counts.
- LoRA adapters (the bank cut a stage at a time) give the JAX engine's
  tokens at the same layout.
"""

import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax

from .test_torch_lora import _drive, make_adapter
from .test_torch_pp import (
    COMMON,
    check_engines,
    check_pages,
    engine_on,
    parallel_ranks,
    same_rows_and_replicas,
)
from .test_torch_spec_engine import RANDOM, REPEAT

GRID = dict(data_parallel_size=2, pipeline_parallel_size=2, device="cpu")
JAX_GRID = dict(data_parallel_size=2, pipeline_parallel_size=2)


@pytest.fixture(scope="module")
def ranks():
    with parallel_ranks(GRID) as r:
        yield r


@pytest.fixture(scope="module")
def jax_grid():
    return JaxLLMEngine(JaxEngineConfig(attn_impl="gather", **JAX_GRID,
                                        **COMMON))


def test_the_grid_and_its_groups(ranks):
    ctx = ranks.ctx
    assert [ctx.grid.coords(r)["dp"] for r in range(4)] == [0, 0, 1, 1]
    assert [ctx.grid.coords(r)["pp"] for r in range(4)] == [0, 1, 0, 1]
    assert ctx.grid.groups("pp") == [[0, 1], [2, 3]]
    assert ctx.grid.groups("dp") == [[0, 2], [1, 3]]
    assert sorted(ctx.groups) == ["dp", "pp"]
    assert ctx.backends == {"dp": "gloo", "pp": "gloo"}
    with engine_on(ranks, GRID) as eng:
        assert [(r["rank"], r["dp"], r["pp"], r["tp"], r["device"])
                for r in eng.rank_layout()] == [
            (0, 0, 0, 0, "0/cpu"), (1, 0, 1, 0, "0/cpu"),
            (2, 1, 0, 0, "0/cpu"), (3, 1, 1, 0, "0/cpu")]
        reports = same_rows_and_replicas(eng.runner, GRID)
        assert [r["coords"] for r in reports] == [
            {"dp": d, "pp": p, "sp": 0, "ep": 0, "tp": 0} for d in (0, 1)
            for p in (0, 1)]


def test_greedy_and_seeded_engines_match_the_jax_engine(ranks, jax_grid):
    check_engines(ranks, GRID, jax_grid)


def test_pages_move_in_the_one_rank_layout(ranks, jax_grid):
    check_pages(ranks, GRID, params_from_jax(
        jax.tree.map(np.asarray, jax_grid.runner.params)))


def test_lora_matches_the_jax_engine(ranks, tmp_path):
    lora = dict(enable_lora=True, max_loras=2, max_lora_rank=8,
                lora_dir=str(tmp_path))
    p1 = make_adapter(tmp_path, "ad1")
    make_adapter(tmp_path, "ad2", targets=("q_proj", "v_proj", "o_proj"),
                 seed=2)
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather", **JAX_GRID,
                                        **COMMON, **lora))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    reqs = [("base", REPEAT, None, 10), ("a1", RANDOM, "ad1", 10),
            ("a2", REPEAT[2:], "ad2", 12)]
    with engine_on(ranks, GRID, params, overlap_decode=False, **lora) as eng:
        for e in (jeng, eng):
            assert e.load_lora("ad1", p1).slot == 1
            assert e.load_lora("ad2").slot == 2
        assert _drive(eng, reqs, SamplingParams) == _drive(
            jeng, reqs, JaxSamplingParams)
        assert eng.unload_lora("ad1")
        same_rows_and_replicas(eng.runner, GRID)
