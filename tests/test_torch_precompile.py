"""Step capture over the shape-bucket lattice (``engine/precompile.py``
of the PyTorch port) against the JAX package's precompile module.

The port's lattice (its ``encode`` lengths included), lazy core and
budget selection must be the JAX ones, for the same pipeline fields (``overlap_decode``, ``async_decode``,
``adaptive_decode_steps``) on both sides, pipelining off and on, without
n-gram speculation (with it: ``tests/test_torch_spec_decode.py``). On the CPU nothing can be
captured, so one test injects a
stand-in for ``torch.cuda.CUDAGraph`` into a tiny CPU engine: after a
full warmup, traffic that spans the lattice adds no graph key, and every
replay adds the launch counts its capture recorded. Another holds a
tiny CPU engine that ran ``warmup="full"`` between two runs of the same
requests to the JAX engine's greedy and seeded tokens (the all-padding
warmup batches write only to the drop slot, or the second run's cached
prefix pages would differ).
"""

import dataclasses

import jax
import numpy as np
import pytest

from production_stack_tpu.engine import precompile as jpre
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine import precompile as tpre
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.ops import paged_attention_cuda as pac

# (block_size, max_num_seqs, max_prefill_tokens, max_model_len,
#  num_decode_steps, min_decode_bucket[, pipeline]): the tiny JAX test
# engine's, the served llama-3-8b's in chip_smoke.py, and a config of
# non-powers of two with a decode-row floor and no burst, each with every
# pipeline mode off; then the same three pipelined: the default overlap,
# async_decode with an adaptive depth of 8, and the overlap at depth 1
# (its b{B}xn1 bursts).
PIPELINES = {
    "off": dict(overlap_decode=False, async_decode=False),
    "overlap": dict(overlap_decode=True, async_decode=False),
    "async_adaptive8": dict(overlap_decode=False, async_decode=True,
                            adaptive_decode_steps=8),
}
CONFIGS = [
    (16, 2, 8, 64, 2, 1),
    (32, 16, 512, 4096, 4, 1),
    (16, 6, 48, 200, 1, 3),
    (16, 2, 8, 64, 2, 1, "overlap"),
    (32, 16, 512, 4096, 4, 1, "async_adaptive8"),
    (16, 6, 48, 200, 1, 3, "overlap"),
]


def _configs(c):
    bs, seqs, budget, max_len, steps, floor, *pipe = c
    common = dict(model="tiny-llama-debug", block_size=bs, max_num_seqs=seqs,
                  max_prefill_tokens=budget, max_model_len=max_len,
                  num_decode_steps=steps, min_decode_bucket=floor,
                  **PIPELINES[pipe[0] if pipe else "off"])
    jcfg = JaxEngineConfig(speculative_ngram=0, **common)
    return EngineConfig(device="cpu", **common), jcfg


def _served(buckets):
    """JAX buckets as field tuples: the port serves every kind, the
    encode lengths included."""
    return [dataclasses.astuple(b) for b in buckets]


def _tuples(buckets):
    return [dataclasses.astuple(b) for b in buckets]


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: "x".join(map(str, c)))
def test_lattice_equals_the_jax_lattice(config):
    cfg, jcfg = _configs(config)
    got = tpre.enumerate_lattice(cfg)
    want = jpre.enumerate_lattice(jcfg)
    assert got and _tuples(got) == _served(want)
    assert [b.label for b in got] == [b.label for b in want]
    assert tpre.encode_buckets(cfg) == jpre.encode_buckets(jcfg)
    assert {b.kind for b in got} >= {"decode", "prefill", "encode"}
    assert tpre.decode_row_buckets(cfg) == jpre.decode_row_buckets(jcfg)
    assert tpre.table_width_buckets(cfg) == jpre.table_width_buckets(jcfg)
    assert tpre.prefill_shape_buckets(cfg) == jpre.prefill_shape_buckets(jcfg)


def test_lazy_core_and_budget_selection_equal_jax():
    for config in CONFIGS:
        cfg, jcfg = _configs(config)
        lattice = tpre.enumerate_lattice(cfg)
        jlattice = jpre.enumerate_lattice(jcfg)
        assert _tuples(tpre.lazy_core(lattice, cfg)) == _served(
            jpre.lazy_core(jlattice, jcfg))
        for mode, budget in (("full", 0), ("full", 3), ("full", 11),
                             ("lazy", 0), ("lazy", 2), ("off", 0)):
            got = tpre.Precompiler(None, cfg, mode, budget).select(lattice)
            want = jpre.Precompiler(None, jcfg, mode, budget).select(jlattice)
            assert _tuples(got) == _served(want), (config, mode, budget)
    with pytest.raises(ValueError):
        tpre.Precompiler(None, cfg, mode="sometimes")


class StandInGraph:
    """``torch.cuda.CUDAGraph``'s interface on the CPU, where nothing can
    be captured: the step runs once between ``capture_begin`` and
    ``capture_end``, and ``replay`` runs nothing (the test reads the
    runner's keys and counts; the tokens are another test's)."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        pass

    def replay(self):
        pass


# The JAX precompile test's tiny engine: two decode row buckets, one table
# bucket, four prefill chunk buckets, a 2-step burst; synchronous, so the
# steps it takes do not depend on the wall clock.
TINY = dict(model="tiny-llama-debug", max_model_len=64, block_size=16,
            num_kv_blocks=16, max_num_seqs=2, max_prefill_tokens=8,
            num_decode_steps=2, overlap_decode=False, device="cpu")


def _drain(engine) -> None:
    for _ in range(400):
        if not engine.has_work():
            return
        engine.step()
    raise AssertionError("engine did not drain")


def test_full_warmup_then_spanning_traffic_adds_no_key(monkeypatch):
    engine = LLMEngine(EngineConfig(**TINY))
    runner = engine.runner
    runner._graph_cls = StandInGraph
    # Each forward counts as one launch, by kind, so a step's capture
    # records launches; the traffic's own forwards are counted apart.
    forward = runner.model.forward

    def counted_forward(params, tokens, *args, **kwargs):
        pac.launch_counts["prefill" if tokens.shape[1] > 1 else "decode"] += 1
        return forward(params, tokens, *args, **kwargs)

    monkeypatch.setattr(runner.model, "forward", counted_forward)
    want = {"decode": 0, "prefill": 0}
    step, multi_step = runner._step, runner._multi_step

    def counted_step(batch, *args):
        want["prefill" if batch["tokens"].shape[1] > 1 else "decode"] += 1
        return step(batch, *args)

    def counted_multi_step(batch, n_steps, *args):
        want["decode"] += n_steps
        return multi_step(batch, n_steps, *args)

    monkeypatch.setattr(runner, "_step", counted_step)
    monkeypatch.setattr(runner, "_multi_step", counted_multi_step)

    summary = engine.precompile(mode="full")
    assert summary["buckets_compiled"] == summary["buckets_total"] > 0
    assert summary["coverage"] == 1.0 and summary["mode"] == "full"
    keys = set(runner._graphs)
    # A one-token prefill bucket pads like a decode bucket: one graph.
    assert 0 < len(keys) <= summary["buckets_total"]
    warm = dict(runner.graph_counts)
    assert warm["captured"] == warm["eager"] == len(keys)
    assert engine.stats()["graphs_captured"] == len(keys)

    pac.reset_launch_counts()
    want.update(decode=0, prefill=0)
    # Greedy single request (chunks 8 + 2, bursts at row bucket 1); a
    # greedy and a sampled one together (batched prefill rows, mixed
    # bursts, a one-row tail); two sampled rows.
    for batch in (
        [(list(range(2, 12)), dict(max_tokens=3, temperature=0.0))],
        [(list(range(20, 26)), dict(max_tokens=4, temperature=1.0, seed=7)),
         (list(range(30, 42)), dict(max_tokens=2, temperature=0.0))],
        [(list(range(2, 9)), dict(max_tokens=2, temperature=0.9, seed=1)),
         (list(range(9, 16)), dict(max_tokens=2, temperature=0.8, seed=2))],
    ):
        for ids, sp in batch:
            engine.add_request(f"r{ids[0]}", prompt_token_ids=ids,
                               sampling=SamplingParams(ignore_eos=True, **sp))
        _drain(engine)
    assert set(runner._graphs) == keys, "live traffic captured a new key"
    gc = runner.graph_counts
    assert gc["captured"] == warm["captured"] and gc["eager"] == warm["eager"]
    assert gc["replayed"] > warm["replayed"]
    # Replays add the launches their captures recorded, and no others.
    assert want["decode"] > 0 and want["prefill"] > 0
    assert {k: pac.launch_counts[k] for k in want} == want

    # A penalized row: its bursts replay the warmed dense-penalty graphs;
    # its prefill carries pow2-length penalty id arrays, which the lattice
    # cannot enumerate: one capture on first use.
    engine.add_request(
        "r-pen", prompt_token_ids=list(range(4, 11)),
        sampling=SamplingParams(max_tokens=3, temperature=0.0,
                                repetition_penalty=1.3, presence_penalty=0.5,
                                ignore_eos=True))
    _drain(engine)
    new = set(runner._graphs) - keys
    assert len(new) <= 1 and all(k[0] == "step" for k in new)
    assert gc["captured"] == warm["captured"] + len(new)
    assert {k: pac.launch_counts[k] for k in want} == want


COMMON = dict(model="tiny-llama-debug", block_size=8, max_prefill_tokens=32,
              max_model_len=256, num_kv_blocks=128, max_num_seqs=8)
_rng = np.random.default_rng(4)
PROMPTS = [_rng.integers(1, 512, n).tolist() for n in (40, 13, 7)]
RUNS = (dict(max_tokens=10, temperature=0.0, ignore_eos=True),
        dict(max_tokens=10, temperature=0.8, top_p=0.95, top_k=50,
             seed=99, ignore_eos=True))


@pytest.fixture(scope="module")
def jax_run():
    engine = JaxLLMEngine(JaxEngineConfig(num_decode_steps=1, **COMMON))
    outs = [engine.generate([list(p) for p in PROMPTS],
                            JaxSamplingParams(**sp)) for sp in RUNS]
    return engine, outs


def test_full_warmup_keeps_the_jax_engine_tokens(jax_run):
    jax_engine, want = jax_run
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jax_engine.runner.params))
    engine = LLMEngine(EngineConfig(num_decode_steps=4, device="cpu",
                                    **COMMON), params=params)

    def run():
        return [[g["token_ids"] for g in engine.generate(
            [list(p) for p in PROMPTS], SamplingParams(**sp))] for sp in RUNS]

    first = run()
    summary = engine.precompile(mode="full")
    assert summary["buckets_compiled"] == summary["buckets_total"] > 0
    second = run()  # on the prefix pages the first run cached
    assert engine.allocator.hit_rate > 0
    expected = [[w["token_ids"] for w in out] for out in want]
    assert first == expected
    assert second == expected
