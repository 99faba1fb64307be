"""The port's unconditional pipelining (``async_decode``), a late arrival's
prefill behind an in-flight burst, adaptive deep bursts, and the
scheduler's page locks, against the JAX package.

``async_decode`` pipelines whatever the arrival stream does; its tokens
must be the synchronous loop's and the JAX async engine's. A request
that arrives while a burst is in flight is prefilled behind it
(``prefill_dispatch``, then the burst's drain, then ``prefill_fetch``)
and joins the batch. Adaptive deep bursts are counted in ``stats()`` as
the JAX engine counts them and reach ``/metrics``. The port's
``schedule(locked=..., n_decode=...)`` makes the JAX scheduler's
decisions on one scripted sequence of events, ``blocked_on_locked``
included.
"""

import numpy as np
import pytest

from production_stack_tpu.engine import kv_manager as jkv
from production_stack_tpu.engine import scheduler as jsched
from production_stack_tpu.engine import sequence as jseq
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine import kv_manager as tkv
from production_stack_tpu_torch.engine import scheduler as tsched
from production_stack_tpu_torch.engine import sequence as tseq
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import EngineMetrics

from .test_torch_overlap_decode import (  # noqa: F401 (autouse fixture)
    PIPELINED,
    _jax,
    _port,
    _reqs,
    _run,
    _static_outputs,
)

ASYNC = dict(async_decode=True, overlap_decode=False)


@pytest.mark.parametrize("sp", [dict(temperature=0.0),
                                dict(temperature=0.9, seed=7)],
                         ids=["greedy", "seeded"])
def test_async_decode_equals_the_synchronous_loop(sp):
    shape = ((17, 33, 9), (12, 20, 7))
    eng = _port(**ASYNC)
    _, got = _run(eng, _reqs(*shape, SamplingParams, **sp))
    _, ref = _run(_port(), _reqs(*shape, SamplingParams, **sp))
    _, want = _run(_jax(**ASYNC), _reqs(*shape, JaxSamplingParams, **sp))
    assert eng.pipelined_bursts_total > 0
    assert got == ref == want
    assert not eng.runner.burst_in_flight
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_late_arrival_is_prefilled_behind_the_burst():
    """A request added while a burst is in flight: its prefill is
    dispatched while the burst still runs, the burst drains, the new
    request joins the next pipeline; every row's tokens are the JAX async
    engine's on the same schedule and the late row's equal its run
    alone."""
    early = _reqs((17, 25), (24, 24), SamplingParams, temperature=0.0)
    late = np.random.default_rng(9).integers(1, 500, 21).tolist()
    sp = dict(max_tokens=10, temperature=0.0, ignore_eos=True)

    def run(engine, sp_cls, reqs, spied=False):
        seen = []
        dispatch = engine.runner.prefill_dispatch
        if spied:
            def spy(items):
                seen.append((engine.runner.burst_in_flight,
                             [it.seq.request_id for it in items]))
                return dispatch(items)

            engine.runner.prefill_dispatch = spy
        for rid, prompt, s in reqs:
            engine.add_request(rid, prompt_token_ids=list(prompt), sampling=s)
        toks = {"r0": [], "r1": [], "late": []}
        steps = 0
        while engine.has_work():
            for out in engine.step():
                toks[out.request_id].extend(out.new_token_ids)
            steps += 1
            if steps == 5:
                assert engine.runner.burst_in_flight
                engine.add_request("late", prompt_token_ids=list(late),
                                   sampling=sp_cls(**sp))
            assert steps < 500
        return toks, seen

    eng = _port(**ASYNC)
    got, seen = run(eng, SamplingParams, early, spied=True)
    want, _ = run(_jax(**ASYNC), JaxSamplingParams, _reqs(
        (17, 25), (24, 24), JaxSamplingParams, temperature=0.0))
    assert seen == [(True, ["late"])], seen
    assert got == want
    alone = _run(_port(), [("late", late, SamplingParams(**sp))])[1]
    assert got["late"] == alone["late"]
    assert eng.allocator.num_free == eng.allocator.num_blocks


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            return float(line.rpartition(" ")[2])
    raise AssertionError(f"{name} not in /metrics")


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["synchronous", "overlap"])
def test_adaptive_deep_bursts_are_counted(pipelined):
    over = dict(adaptive_decode_steps=8, adaptive_decode_quiet_s=0.0)
    if pipelined:
        over = dict(PIPELINED, **over)
    shape = ((13, 30), (26, 19))
    eng = _port(**over)
    _, got = _run(eng, _reqs(*shape, SamplingParams, temperature=0.0))
    jeng = _jax(**over)
    before = jeng.stats()
    _, want = _run(jeng, _reqs(*shape, JaxSamplingParams, temperature=0.0))
    _, ref = _run(_port(), _reqs(*shape, SamplingParams, temperature=0.0))
    assert got == want == ref
    stats, jstats = eng.stats(), jeng.stats()
    for key in ("adaptive_deep_bursts_total", "pipelined_bursts_total"):
        if key in jstats:
            assert stats[key] == jstats[key] - before.get(key, 0.0), key
        else:
            assert key not in stats
    assert stats["adaptive_deep_bursts_total"] > 0
    assert (stats.get("pipelined_bursts_total", 0) > 0) == pipelined
    metrics = EngineMetrics(eng.model_name)
    metrics.refresh(stats)
    text = metrics.registry.render()
    assert _metric(text, "pst:adaptive_deep_bursts_total") == \
        stats["adaptive_deep_bursts_total"]
    assert _metric(text, "pst:pipelined_bursts_total") == \
        stats.get("pipelined_bursts_total", 0.0)


# One scripted sequence of events: ("add", rid, prompt length) or
# ("schedule", locked request ids, n_decode). Ten 4-token pages, a
# 16-token prefill budget, depth 2 with the pipeline's two-burst
# lookahead: the locked members keep their pages while a newcomer is
# preempted, and a locked member that needs a page only a locked member
# holds reports blocked_on_locked.
SCRIPT = [
    ("add", "A", 9), ("add", "B", 5),
    ("schedule", (), None),
    ("schedule", (), None),
    ("schedule", ("A", "B"), None),
    ("add", "C", 8),
    ("schedule", ("A", "B"), None),
    ("schedule", ("A", "B"), None),
    ("schedule", ("A", "B"), 4),
    ("schedule", (), 4),
    ("schedule", (), None),
]


def _drive(Scheduler, Config, Allocator, Sequence, SP, **cfg):
    alloc = Allocator(10, 4, True)
    sched = Scheduler(Config(max_num_seqs=4, max_prefill_tokens=16,
                             max_model_len=64, num_decode_steps=2,
                             decode_lookahead=2, **cfg), alloc)
    seqs, log = {}, []
    rng = np.random.default_rng(2)
    for ev in SCRIPT:
        if ev[0] == "add":
            _, rid, n = ev
            seqs[rid] = Sequence(rid, rng.integers(1, 500, n).tolist(),
                                 SP(max_tokens=64, temperature=0.0))
            sched.add(seqs[rid])
            continue
        _, locked, n_dec = ev
        out = sched.schedule(locked=frozenset(locked), n_decode=n_dec)
        for it in out.prefills:
            s = it.seq
            s.num_computed_tokens = it.end
            s.commit_full_blocks(alloc)
            if it.end == s.num_prompt_tokens and not s.output_token_ids:
                s.output_token_ids.append(100 + len(s.output_token_ids))
        for s in out.decodes:
            for _ in range(out.n_decode_steps):
                s.num_computed_tokens += 1
                s.output_token_ids.append(100 + len(s.output_token_ids))
                s.commit_full_blocks(alloc, allow_swap=not locked)
        log.append((
            [(it.seq.request_id, it.start, it.end) for it in out.prefills],
            [s.request_id for s in out.decodes],
            [s.request_id for s in out.preempted],
            out.n_decode_steps, out.blocked_on_locked,
            {r: list(s.block_ids) for r, s in sorted(seqs.items())},
            alloc.num_free))
    return log


def test_schedule_locked_equals_the_jax_scheduler():
    want = _drive(jsched.Scheduler, jsched.SchedulerConfig,
                  jkv.BlockAllocator, jseq.Sequence, jseq.SamplingParams)
    got = _drive(tsched.Scheduler, tsched.SchedulerConfig,
                 tkv.BlockAllocator, tseq.Sequence, tseq.SamplingParams)
    assert got == want
    assert any(entry[4] for entry in got), "no pass was blocked on a lock"
    assert any(entry[2] for entry in got), "no pass preempted"
    # A locked member is never the one preempted.
    for ev, entry in zip([e for e in SCRIPT if e[0] == "schedule"], got):
        assert not set(entry[2]) & set(ev[1])
