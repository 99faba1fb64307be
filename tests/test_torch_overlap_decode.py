"""The port's pipelined decode (``overlap_decode``) against the JAX overlap
engine and against the port's own synchronous loop, on the cases of
``tests/test_overlap_decode.py``: engagement with identical streams,
seeded and penalized rows, ``max_tokens`` and stop strings with the
overshoot trimmed, an abort mid-overlap, the host gap of 0, and guided
rows kept out of the pipeline.

The arrival gates are held open (``adaptive_decode_quiet_s=0``), so the
pipeline engages on the CPU whatever the wall clock. The port's runner
steps through a stand-in ``torch.cuda.CUDAGraph`` whose replay reruns the
captured step into the ONE static output its capture returned, as a
graph rewrites its output on each replay: a runner that read burst N's
rows or carry after burst N+1's replay would read N+1's, and fail here.
"""

import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine import runner as runner_mod
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax

from .test_torch_precompile import StandInGraph

COMMON = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
              num_kv_blocks=128, max_num_seqs=8, max_prefill_tokens=64)
PIPELINED = dict(overlap_decode=True, adaptive_decode_quiet_s=0.0,
                 adaptive_decode_min_running=0)
PENALTY_SP = dict(presence_penalty=0.8, frequency_penalty=0.5,
                  repetition_penalty=1.3)


class StaticOutputGraph(StandInGraph):
    """The stand-in graph whose replay reruns the captured step and writes
    its result into the static output of the capture (a tensor, or a
    burst's rows and carry), which every replay of the key shares."""

    def replay(self):
        new = self.fn()
        if isinstance(self.out, dict):
            for k, v in self.out.items():
                v.copy_(new[k])
        else:
            self.out.copy_(new)


def _capture(graph, fn, pool=None):
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    graph.fn, graph.out = fn, fn()
    graph.capture_end()
    return graph.out


@pytest.fixture(autouse=True)
def _static_outputs(monkeypatch):
    monkeypatch.setattr(runner_mod, "capture", _capture)


_JAX = {}


def _jax(**over):
    """A JAX engine (gather attention, every pipeline mode off unless
    asked), one per config for the module."""
    kw = dict(COMMON, attn_impl="gather", num_decode_steps=2,
              overlap_decode=False, async_decode=False)
    kw.update(over)
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        _JAX[key] = JaxLLMEngine(JaxEngineConfig(**kw))
    return _JAX[key]


def _port(**over):
    """The port's engine on the JAX engine's weights, stepping through
    the static-output stand-in graph."""
    kw = dict(COMMON, num_decode_steps=2, overlap_decode=False, device="cpu")
    kw.update(over)
    params = params_from_jax(jax.tree.map(np.asarray,
                                          _jax().runner.params))
    engine = LLMEngine(EngineConfig(**kw), params=params)
    engine.runner._graph_cls = StaticOutputGraph
    return engine


def _run(engine, requests):
    """Drive to completion: (per-request event stream, token ids). An
    event is what a stream frame carries."""
    for rid, prompt, sp in requests:
        engine.add_request(rid, prompt_token_ids=list(prompt), sampling=sp)
    events = {rid: [] for rid, _, _ in requests}
    toks = {rid: [] for rid, _, _ in requests}
    for _ in range(1000):
        if not engine.has_work():
            return events, toks
        for out in engine.step():
            events[out.request_id].append(
                (out.text_delta, tuple(out.new_token_ids), out.finished,
                 out.finish_reason))
            toks[out.request_id].extend(out.new_token_ids)
    raise AssertionError("engine did not drain")


def _reqs(lengths, max_tokens, sp_cls, **sp):
    rng = np.random.default_rng(11)
    return [(f"r{i}", rng.integers(1, 500, size=n).tolist(),
             sp_cls(max_tokens=mt, ignore_eos=True, **sp))
            for i, (n, mt) in enumerate(zip(lengths, max_tokens))]


def _balanced(engine):
    assert not engine.runner.burst_in_flight and not engine._burst_deferred
    assert engine.allocator.num_free == engine.allocator.num_blocks


def test_overlap_engages_and_streams_identically():
    # The pipeline fields default to the JAX engine's: overlap on.
    fields = ("overlap_decode", "async_decode", "adaptive_decode_steps",
              "adaptive_decode_quiet_s", "adaptive_decode_min_running")
    assert EngineConfig().overlap_decode
    assert [getattr(EngineConfig(), f) for f in fields] == [
        getattr(JaxEngineConfig(), f) for f in fields]
    shape = ((17, 33, 9, 25), (12, 20, 7, 16))
    ref_events, ref = _run(_port(), _reqs(*shape, SamplingParams,
                                          temperature=0.0))
    eng = _port(**PIPELINED)
    events, got = _run(eng, _reqs(*shape, SamplingParams, temperature=0.0))
    _, want = _run(_jax(**PIPELINED), _reqs(*shape, JaxSamplingParams,
                                            temperature=0.0))
    assert eng.pipelined_bursts_total > 0, "pipeline never engaged"
    assert eng.stats()["pipelined_bursts_total"] == eng.pipelined_bursts_total
    assert eng.runner.graph_counts["replayed"] > 0
    assert got == ref == want
    for rid in ref_events:
        assert "".join(e[0] for e in events[rid]) == "".join(
            e[0] for e in ref_events[rid])
        assert events[rid][-1][2:] == ref_events[rid][-1][2:]
        assert all(not e[2] for e in events[rid][:-1])
    _balanced(eng)
    # A guided choice's mask is rebuilt per token on the host: its rows
    # step one token at a time and never pipeline.
    eng = _port(**PIPELINED, num_decode_steps=4)
    choice = ((5, 9), (5, 12, 13))
    _, toks = _run(eng, [("g", [3, 4, 5], SamplingParams(
        max_tokens=8, temperature=0.0, guided_choice=choice))])
    assert eng.pipelined_bursts_total == 0 and tuple(toks["g"]) in choice


def _seeded(sp_cls):
    """Two seeded rows: seed 42, and a seed whose pipelined offsets pass
    2**31 - 1 unmasked. A continuation carries the offset as the JAX
    ``seed_off`` does, while a synchronous burst masks its seed afresh
    (both packages): the second row is held to the JAX overlap engine
    only."""
    rng = np.random.default_rng(11)
    return [(f"r{i}", rng.integers(1, 500, size=n).tolist(),
             sp_cls(max_tokens=10, temperature=0.9, seed=seed,
                    ignore_eos=True))
            for i, (n, seed) in enumerate(((13, 42), (22, 2**31 - 3)))]


# (name, engine overrides, requests, the rows the synchronous loop must
# match too): seeded rows at depth 2, penalized rows at depth 4 (their
# counts ride the carry).
CARRY_CASES = [
    ("seeded", {}, _seeded, ("r0",)),
    ("penalties", dict(num_decode_steps=4),
     lambda cls: _reqs((14, 23), (18, 18), cls, temperature=0.0,
                       **PENALTY_SP), ("r0", "r1")),
]


@pytest.mark.parametrize("case", CARRY_CASES, ids=[c[0] for c in CARRY_CASES])
def test_carry_rides_pipelined_bursts(case):
    _, over, reqs, sync_rows = case
    eng = _port(**PIPELINED, **over)
    _, got = _run(eng, reqs(SamplingParams))
    _, want = _run(_jax(**PIPELINED, **over), reqs(JaxSamplingParams))
    assert eng.pipelined_bursts_total > 0
    assert got == want
    _, ref = _run(_port(**over), reqs(SamplingParams))
    assert [got[r] for r in sync_rows] == [ref[r] for r in sync_rows]
    _balanced(eng)


def test_max_tokens_and_stop_strings_trim_the_overshoot():
    """Depth 4 under the pipeline: max_tokens that are no multiple of the
    depth are met exactly, and a stop string ends the text where the
    synchronous loop's and the JAX overlap engine's end; no frame leaks
    the stop string."""
    eng = _port(**PIPELINED, num_decode_steps=4)
    _, toks = _run(eng, _reqs((15, 21), (9, 13), SamplingParams,
                              temperature=0.0))
    assert eng.pipelined_bursts_total > 0
    assert [len(toks[f"r{i}"]) for i in range(2)] == [9, 13]

    prompt = np.random.default_rng(7).integers(1, 200, size=12).tolist()
    full = "".join(e[0] for e in _run(_port(), [(
        "s", prompt, SamplingParams(max_tokens=40, temperature=0.0,
                                    ignore_eos=True))])[0]["s"])
    assert len(full) > 8
    stop = full[5:8]

    def run_stop(engine, sp_cls):
        events, _ = _run(engine, [("s", prompt, sp_cls(
            max_tokens=40, temperature=0.0, ignore_eos=True, stop=[stop]))])
        text = ""
        for delta, *_ in events["s"]:
            text += delta
            assert stop not in text, "stop string leaked into a frame"
        return text, events["s"][-1][3]

    eng = _port(**PIPELINED, num_decode_steps=4)
    got = run_stop(eng, SamplingParams)
    assert eng.pipelined_bursts_total > 0
    assert got == run_stop(_port(num_decode_steps=4), SamplingParams)
    assert got == run_stop(_jax(**PIPELINED, num_decode_steps=4),
                           JaxSamplingParams)
    assert got[1] == "stop"
    _balanced(eng)


def test_abort_mid_overlap_releases_every_page():
    """Aborting an in-flight member defers its page release to the drain;
    the survivor's tokens are the JAX engine's and every page returns."""
    rng = np.random.default_rng(5)
    p0 = rng.integers(1, 500, size=19).tolist()
    p1 = rng.integers(1, 500, size=27).tolist()
    keep = dict(max_tokens=20, temperature=0.0, ignore_eos=True)
    want = _run(_jax(**PIPELINED), [("keep", p0, JaxSamplingParams(**keep))])
    eng = _port(**PIPELINED)
    eng.add_request("keep", prompt_token_ids=p0,
                    sampling=SamplingParams(**keep))
    eng.add_request("gone", prompt_token_ids=p1, sampling=SamplingParams(
        max_tokens=50, temperature=0.0, ignore_eos=True))
    kept, steps, deferred = [], 0, False
    while eng.has_work():
        for out in eng.step():
            assert not (steps >= 4 and out.request_id == "gone"), (
                "an aborted request kept emitting")
            if out.request_id == "keep":
                kept.extend(out.new_token_ids)
        steps += 1
        if steps == 4:
            assert eng.runner.burst_in_flight
            assert eng.abort_request("gone")
            deferred = bool(eng._burst_deferred)
        assert steps < 500
    assert deferred, "the abort released pages an in-flight burst writes"
    assert eng.pipelined_bursts_total > 0
    assert kept == want[1]["keep"]
    _balanced(eng)


def test_host_gap_is_zero_under_the_pipeline():
    """Continuations record 0-valued gaps (dispatched before the previous
    burst's fetch), in the pipelined ``b{B}xn{n}`` bucket; the synchronous
    loop records each gap as it was."""
    def gaps(engine):
        seen = []
        record = engine.telemetry.record_host_gap

        def spy(bucket, seconds):
            seen.append((bucket, seconds))
            record(bucket, seconds)

        engine.telemetry.record_host_gap = spy
        _run(engine, _reqs((9,), (24,), SamplingParams, temperature=0.0))
        return seen

    eng = _port(**PIPELINED)
    seen = gaps(eng)
    assert eng.pipelined_bursts_total >= 2
    zeros = [b for b, s in seen if s == 0.0]
    assert len(zeros) >= eng.pipelined_bursts_total - 1
    assert all("xn" in b for b in zeros)
    text = eng.telemetry.render()
    assert 'pst_engine_host_gap_seconds_bucket{batch_bucket="b1xn2",' \
           'le="0.0005"}' in text
    sync = gaps(_port())
    assert sync and all(s > 0.0 for _, s in sync)
