"""Mixed-tier traffic under page pressure drains through the port's
scheduler, where the JAX scheduler stops admitting.

Fourteen requests alternate batch and interactive over a pool that holds
five prompts. An interactive sequence is parked for the others' growth
while older batch requests and newer interactive ones wait. The parked
head yields to the oldest waiting request (a batch one); the JAX
scheduler's waiting queue, interactive first, then holds its pick behind
the older parked head: neither admits, and nothing runs. The port's
waiting queue admits its pick once the head yielded, so every request
finishes; where the JAX scheduler does not stall, the two agree (the
parity cases of ``test_torch_scheduler_parity.py``). Also faults 3.6
(recompute preemption) and 3.7 (a resume behind an in-flight burst).
"""

import numpy as np
import pytest

from .test_torch_scheduler_parity import JAX, PORT, _Pages


def _serve(side, passes: int = 400) -> tuple:
    """(passes until drained or None, waiting, parked, running ids)."""
    Scheduler, Config, Allocator, Sequence, SP, Swapper = side
    alloc = Allocator(40, 4, True)
    store = _Pages()
    sched = Scheduler(Config(max_num_seqs=16, max_prefill_tokens=64,
                             max_model_len=512, num_decode_steps=4,
                             decode_lookahead=2),
                      alloc, swapper=Swapper(store))
    rng = np.random.default_rng(0)
    for i in range(14):
        tier = ("batch", "interactive")[i % 2]
        sched.add(Sequence(f"r{i}", rng.integers(1, 1000, 32).tolist(),
                           SP(max_tokens=16, temperature=0.0), tenant=tier,
                           tenant_class=tier))
    done = []
    for n in range(passes):
        if not sched.has_work():
            return n, done
        out = sched.schedule()
        for it in out.prefills:
            s = it.seq
            s.num_computed_tokens = it.end
            for p in range(-(-it.end // 4)):
                store.pages[s.block_ids[p]] = (s.request_id, p), None
            s.commit_full_blocks(alloc)
            if it.end == s.num_prompt_tokens and not s.output_token_ids:
                s.output_token_ids.append(5)
        for s in out.decodes:
            for _ in range(out.n_decode_steps):
                s.num_computed_tokens += 1
                store.pages[s.block_ids[(s.num_computed_tokens - 1) // 4]] = (
                    (s.request_id, (s.num_computed_tokens - 1) // 4), None)
                s.output_token_ids.append(5)
                s.commit_full_blocks(alloc)
                if len(s.output_token_ids) >= 16:
                    sched.finish(s, "length")
                    done.append(s.request_id)
                    break
    return None, (sorted(s.request_id for s in sched.waiting),
                  [s.request_id for s in sched.swapped], len(sched.running))


@pytest.mark.parametrize("side", ["jax", "port"])
def test_mixed_tiers_under_page_pressure(side):
    passes, state = _serve(JAX if side == "jax" else PORT)
    if side == "jax":
        # Stuck: requests wait and one is parked, and nothing runs.
        assert passes is None
        waiting, parked, running = state
        assert waiting and parked and running == 0
        return
    assert passes is not None
    assert sorted(state) == sorted(f"r{i}" for i in range(14))
    # Interactive requests finish first (the pool's first five prompts).
    assert {int(r[1:]) % 2 for r in state[:5]} == {1}


def _drain(engine, requests, cap: int):
    """Step until drained or ``cap`` steps: (steps or None, token ids)."""
    for rid, prompt, sp in requests:
        engine.add_request(rid, prompt_token_ids=list(prompt), sampling=sp)
    toks = {rid: [] for rid, _, _ in requests}
    for n in range(cap):
        if not engine.has_work():
            return n, toks
        for out in engine.step():
            toks[out.request_id].extend(out.new_token_ids)
    return None, toks


def test_recompute_preemption_drains_where_the_jax_engine_livelocks():
    """ROADMAP fault 3.6. With kv_swap off, the JAX admission sizes a
    preempted sequence's pages by its prompt; it recomputes its output
    too, takes the missing pages by preempting the next sequence, and the
    two evict each other for good. The port sizes it by all its tokens:
    at the small pool it drains, with the tokens the JAX engine serves
    where it does not thrash."""
    from .test_torch_kv_swap import LENGTHS, MAX_TOKENS, SMALL, _jax, _port
    from .test_torch_overlap_decode import _reqs

    from production_stack_tpu.engine.sequence import (
        SamplingParams as JaxSamplingParams,
    )
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    assert SMALL["num_kv_blocks"] == 28
    jeng = _jax(kv_swap=False)
    steps, _ = _drain(jeng, _reqs(LENGTHS, MAX_TOKENS, JaxSamplingParams,
                                  temperature=0.0), cap=120)
    assert steps is None
    assert jeng.stats()["num_preemptions_total"] > 50
    port = _port(jeng, kv_swap=False)
    steps, got = _drain(port, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                                    temperature=0.0), cap=120)
    assert steps is not None
    assert 1 <= port.stats()["num_preemptions_total"] <= 2
    assert port.allocator.num_free == port.allocator.num_blocks
    _, want = _drain(_jax(kv_swap=False, num_kv_blocks=64),
                     _reqs(LENGTHS, MAX_TOKENS, JaxSamplingParams,
                           temperature=0.0), cap=120)
    assert got == want


def _parked_behind_a_burst(side, tiered):
    """A sequence parked with its three committed pages, then the pool
    filled by pages that wait for an in-flight burst's drain (finished
    members: off ``running``), which evicts the parked chain to the host
    tier; one pass with that burst in flight."""
    Sched, Cfg, _, Seq, SP, Swapper = side
    pages = _Pages()
    alloc = tiered(8, 4, page_io=pages, host_blocks=16)
    swapper = Swapper(pages, max_stash_blocks=16)
    sched = Sched(Cfg(max_num_seqs=4, max_prefill_tokens=64,
                      max_model_len=64), alloc, swapper=swapper)
    seq = Seq("parked", list(range(1, 13)), SP(max_tokens=8))
    sched.add(seq)
    assert [it.seq for it in sched.schedule().prefills] == [seq]
    for blk in seq.block_ids:
        pages.pages[blk] = (np.full(4, blk), np.full(4, -blk))
    seq.num_computed_tokens = 12
    seq.commit_full_blocks(alloc)
    seq.output_token_ids.append(7)
    sched.running.remove(seq)
    swapper.swap_out(seq, alloc)
    sched.swapped.append(seq)
    held = [alloc.allocate() for _ in range(alloc.num_free)]
    assert alloc.num_free == 0 and alloc.spilled_blocks == 3
    sched.schedule(locked=frozenset({"finished-member"}))
    return sched, swapper, alloc, seq, held


def test_a_resume_waits_for_an_in_flight_bursts_pages():
    """ROADMAP fault 3.7. With nothing running the scheduler resumes a
    parked sequence ungated, but an in-flight burst's finished members
    still hold their pages: the JAX scheduler resumes into a full pool,
    faults none of the chain back and recomputes it. The port waits while
    a burst is in flight, and after its drain faults the chain up from
    the host tier."""
    from production_stack_tpu.engine.cache_tiering import (
        TieredAllocator as JaxTiered,
    )
    from production_stack_tpu_torch.engine.cache_tiering import (
        TieredAllocator,
    )

    _, jswapper, _, jseq, _ = _parked_behind_a_burst(JAX, JaxTiered)
    assert jswapper.fallback_recompute_total == 1
    assert jswapper.swap_in_total == 0 and not jseq.output_token_ids[1:]
    sched, swapper, alloc, seq, held = _parked_behind_a_burst(
        PORT, TieredAllocator)
    assert list(sched.swapped) == [seq]
    assert swapper.fallback_recompute_total == swapper.swap_in_total == 0
    alloc.release_all(held)  # the burst drained
    sched.schedule()
    assert swapper.swap_in_total == 1 and swapper.fallback_recompute_total == 0
    # The chain's three pages back (and one for the next decode token).
    assert seq in sched.running and len(seq.block_ids) == 4
    assert alloc.host_hit_blocks == 3 and len(seq.block_hashes) == 3
    assert seq.num_computed_tokens == 12
