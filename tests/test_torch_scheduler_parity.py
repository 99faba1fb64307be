"""The port's scheduler and KV swapper pass for pass against the JAX ones.

Each case is a script of events — ``("add", rid, prompt length, tenant,
tier)``, ``("schedule", locked ids, n_decode)``, ``("finish", rid or None for
every running one)``,
``("expire", rid)`` — run through the JAX ``Scheduler`` + ``KVSwapper``
and through the port's, each over its own allocator and an in-memory
page store (``_Pages``) that stands in for the runner's page I/O. Every
written page holds its owner and the tokens in it, so a swapped-in page
must come back holding what went out. After every pass both sides must
agree on the prefill items, the decode set, the preempted, expired and
swapped ids, the queues, the block tables, the pages moved and the
counters.
"""

import numpy as np
import pytest

from production_stack_tpu.engine import kv_manager as jkv
from production_stack_tpu.engine import scheduler as jsched
from production_stack_tpu.engine import sequence as jseq
from production_stack_tpu.engine import swap as jswap
from production_stack_tpu_torch.engine import kv_manager as tkv
from production_stack_tpu_torch.engine import scheduler as tsched
from production_stack_tpu_torch.engine import sequence as tseq
from production_stack_tpu_torch.engine import swap as tswap

JAX = (jsched.Scheduler, jsched.SchedulerConfig, jkv.BlockAllocator,
       jseq.Sequence, jseq.SamplingParams, jswap.KVSwapper)
PORT = (tsched.Scheduler, tsched.SchedulerConfig, tkv.BlockAllocator,
        tseq.Sequence, tseq.SamplingParams, tswap.KVSwapper)


class _Pages:
    """The runner's page I/O over a dict: page id -> (K, V) contents."""

    def __init__(self):
        self.pages, self.moves = {}, []

    def download_page(self, blk):
        self.moves.append(("down", blk))
        return self.pages[blk]

    def upload_page(self, blk, k, v):
        self.moves.append(("up", blk))
        self.pages[blk] = (k, v)


def _add(rid, n, tenant="default", tier="interactive"):
    return ("add", rid, n, tenant, tier)


def _sched(n=None, locked=()):
    return ("schedule", tuple(locked), n)


SHED_PASSES = 8

# Each case: (pages, block size, scheduler config, prefix caching, events,
# what must have happened in it).
CASES = {
    # Three sequences outgrow twelve 4-token pages: the youngest is parked
    # with its committed pages left in place, one tail page moved out and
    # back, and resumes at its token once the oldest finishes.
    "swap_moves_only_the_tail": (
        12, 4, dict(max_num_seqs=4, max_prefill_tokens=32),
        True,
        [_add("A", 9), _add("B", 10), _add("C", 11), _sched()]
        + [_sched() for _ in range(7)] + [("finish", "A")]
        + [_sched() for _ in range(4)],
        lambda c: c["swap_out"] > 0 and c["swap_in"] == c["swap_out"]
        and 0 < c["tail"] < c["swap_out"] * 3 and c["fallback"] == 0),
    # A quantum of 3 tokens with a third request waiting: the running
    # sequence with the most progress rotates out, to the back of the line.
    "quantum_rotation": (
        32, 4, dict(max_num_seqs=2, max_prefill_tokens=32, swap_quantum=3),
        True,
        [_add("A", 6), _add("B", 7), _sched(), _add("C", 5)]
        + [_sched() for _ in range(12)],
        lambda c: c["swap_out"] >= 2 and c["swap_in"] >= 1),
    # A parked sequence's committed pages are reused by the others'
    # growth: its resume falls back to recompute from what survives.
    "fallback_when_committed_pages_were_reused": (
        9, 4, dict(max_num_seqs=3, max_prefill_tokens=32),
        True,
        [_add("A", 8), _add("B", 8), _sched(), _sched(), _sched(),
         _add("C", 3)] + [_sched() for _ in range(10)]
        + [("finish", "A")] + [_sched() for _ in range(6)],
        lambda c: c["swap_out"] > 0 and c["fallback"] > 0),
    # Tenants t1 and t2 take turns (deficit round robin, ties to the
    # larger name) and both admit before an earlier batch request; one
    # sequence runs at a time.
    "drr_across_tenants_interactive_first": (
        32, 4, dict(max_num_seqs=1, max_prefill_tokens=32),
        True,
        [_add("b0", 5, "t3", "batch"), _add("x1", 5, "t1"),
         _add("x2", 6, "t1"), _add("x3", 7, "t1"), _add("y1", 5, "t2"),
         _add("y2", 6, "t2")]
        + [_sched(), _sched(), ("finish", None)] * 6,
        lambda c: c["admitted"] == ["y1", "x1", "y2", "x2", "x3", "b0"]),
    # Batch work holds the pool: a waiting interactive request preempts
    # (parks) the youngest batch sequence to admit, and under decode
    # pressure the older batch sequence is the victim, not the youngest.
    "batch_first_preemption": (
        12, 4, dict(max_num_seqs=4, max_prefill_tokens=32),
        True,
        [_add("b1", 12, "t9", "batch"), _add("i0", 6, "t1"),
         _add("b2", 12, "t9", "batch"), _sched(), _sched(),
         _add("i1", 9, "t1"), _sched(), _sched()]
        + [_sched() for _ in range(8)] + [("finish", "i1")]
        + [_sched() for _ in range(6)],
        lambda c: c["batch_preemptions"] > 0 and c["victims"][:2] == [
            "b2", "b1"] and not {"i0", "i1"} & set(c["victims"])),
    # Deadlines: a queued sequence is shed before its prefill, a running
    # one between decode steps, a locked (in-flight burst) one only on the
    # pass after its lock is released, and a parked one (A, swapped out
    # for C's growth after SHED_PASSES passes) from the line.
    "deadline_sheds_queued_running_locked": (
        8, 4, dict(max_num_seqs=2, max_prefill_tokens=32),
        True,
        [_add("A", 8), _add("B", 8), _add("Q", 5), _sched(), _sched(),
         ("expire", "Q"), _sched(), ("expire", "B"), _sched(locked=("B",)),
         _sched(locked=("A", "B")), _sched(), _add("C", 6)]
        + [_sched() for _ in range(SHED_PASSES)] + [("expire", "A")]
        + [_sched() for _ in range(3)],
        lambda c: c["shed_queued"] == 2 and c["shed_parked"] == 1
        and c["shed_running"] == 1 and c["blocked_locked_shed"]),
}


def _drive(side, pages, bs, cfg, caching, events):
    Scheduler, Config, Allocator, Sequence, SP, Swapper = side
    alloc = Allocator(pages, bs, caching)
    store = _Pages()
    swapper = Swapper(store, max_stash_blocks=64)
    sched = Scheduler(Config(max_model_len=256, **cfg), alloc,
                      swapper=swapper)
    rng = np.random.default_rng(7)
    seqs, log = {}, []
    facts = {"admitted": [], "victims": [], "shed_parked": 0,
             "blocked_locked_shed": False}

    def write(s, upto):
        """The pages holding tokens [0, upto) carry their contents."""
        toks = s.all_token_ids
        for p in range(-(-upto // bs)):
            page = (s.request_id, tuple(toks[p * bs:min((p + 1) * bs, upto)]))
            store.pages[s.block_ids[p]] = ("K", page), ("V", page)

    def check_pages(s):
        """A running sequence's computed pages hold its own tokens:
        committed ones untouched, the tail as it went out."""
        toks = s.all_token_ids
        for p in range(-(-s.num_computed_tokens // bs)):
            hi = min((p + 1) * bs, s.num_computed_tokens)
            k, v = store.pages[s.block_ids[p]]
            assert k[1][1] == tuple(toks[p * bs:hi]), (s.request_id, p)
            assert v == ("V", k[1])

    for ev in events:
        if ev[0] == "add":
            _, rid, n, tenant, tier = ev
            seqs[rid] = Sequence(
                rid, rng.integers(1, 500, n).tolist(),
                SP(max_tokens=200, temperature=0.0), deadline=1e12,
                tenant=tenant, tenant_class=tier)
            sched.add(seqs[rid])
            continue
        if ev[0] == "finish" and ev[1] is None:  # every running one
            for s in list(sched.running):
                sched.finish(s, "stop")
            continue
        if ev[0] == "finish":  # ends as it runs, or aborted where it is
            if seqs[ev[1]] in sched.running:
                sched.finish(seqs[ev[1]], "stop")
            else:
                sched.abort(ev[1])
            continue
        if ev[0] == "expire":
            seqs[ev[1]].deadline = 0.0  # long past on the monotonic clock
            continue
        _, locked, n_dec = ev
        running_before = {s.request_id for s in sched.running}
        parked_before = {s.request_id for s in sched.swapped}
        store.moves = []
        out = sched.schedule(locked=frozenset(locked), n_decode=n_dec)
        for s in sched.running:
            if s.request_id not in running_before and (
                    s.request_id not in facts["admitted"]):
                facts["admitted"].append(s.request_id)
        for it in out.prefills:
            s = it.seq
            s.num_computed_tokens = it.end
            write(s, it.end)
            s.commit_full_blocks(alloc)
            if it.end == s.num_prompt_tokens and not s.output_token_ids:
                s.output_token_ids.append(100 + len(s.output_token_ids))
        for s in out.decodes:
            for _ in range(out.n_decode_steps):
                s.num_computed_tokens += 1
                write(s, s.num_computed_tokens)
                s.output_token_ids.append(100 + len(s.output_token_ids))
                s.commit_full_blocks(alloc, allow_swap=not locked)
        for s in sched.running:
            check_pages(s)
        facts["victims"] += [s.request_id for s in out.preempted] + [
            s.request_id for s in sched.swapped
            if s.request_id in running_before]
        expired = [s.request_id for s in out.expired]
        facts["shed_parked"] += len(set(expired) & parked_before)
        if set(locked) & {rid for rid, s in seqs.items()
                          if s.deadline == 0.0 and rid in running_before}:
            # A locked, expired member survives the pass.
            facts["blocked_locked_shed"] = not set(locked) & set(expired)
        log.append(dict(
            prefills=[(it.seq.request_id, it.start, it.end)
                      for it in out.prefills],
            decodes=[s.request_id for s in out.decodes],
            n=out.n_decode_steps,
            preempted=[s.request_id for s in out.preempted],
            expired=expired,
            blocked=out.blocked_on_locked,
            waiting=[s.request_id for s in sched.waiting],
            running=[s.request_id for s in sched.running],
            swapped=[s.request_id for s in sched.swapped],
            tables={r: list(s.block_ids) for r, s in sorted(seqs.items())},
            computed={r: s.num_computed_tokens for r, s in sorted(seqs.items())},
            free=alloc.num_free,
            moves=list(store.moves),
            counters=(swapper.swap_out_total, swapper.swap_in_total,
                      swapper.tail_pages_moved,
                      swapper.fallback_recompute_total, swapper.stash_blocks,
                      sched.deadline_sheds_queued,
                      sched.deadline_sheds_running, sched.batch_preemptions),
        ))
    c = log[-1]["counters"]
    facts.update(swap_out=c[0], swap_in=c[1], tail=c[2], fallback=c[3],
                 shed_queued=c[5], shed_running=c[6], batch_preemptions=c[7])
    return log, facts


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_and_swapper_equal_the_jax_ones(case):
    pages, bs, cfg, caching, events, happened = CASES[case]
    want, _ = _drive(JAX, pages, bs, cfg, caching, events)
    got, facts = _drive(PORT, pages, bs, cfg, caching, events)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g == w, f"pass {i}"
    assert happened(facts), facts
