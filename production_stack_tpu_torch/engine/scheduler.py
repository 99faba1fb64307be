"""Continuous-batching scheduler: admission, chunked prefill, preemption.

A copy of the JAX package's ``engine/scheduler.py``. Each call to
:meth:`Scheduler.schedule` emits one device step: either a set of prefill
chunks (token-budget bounded) or one decode batch over all running
sequences.

- **Deadlines**: sequences whose end-to-end budget expired are shed
  first, queued ones before any prefill step, running ones between
  decode steps (``SchedulerOutput.expired``).
- **KV swap** (with a ``swapper``, ``engine/swap.py``): out of pages,
  the youngest sequence is parked — its committed pages stay addressed
  in place, its uncommitted tail goes to a host stash — instead of
  recomputed; ``swapped`` and ``waiting`` admit as one stamp-ordered
  FIFO; with work waiting or parked, a running sequence that decoded
  ``swap_quantum`` tokens since its admission rotates out.
- **Tenants**: the waiting queue admits interactive before batch and,
  within a tier, by deficit round robin across tenants; batch-tier
  sequences are preempted first, also to admit a waiting interactive
  one.
- **Admission** reserves pages for all of a waiting sequence's tokens,
  its output included once it recomputes; the JAX scheduler reserves its
  prompt's, and livelocks under recompute preemption.

While a pipelined decode burst is in flight, ``schedule(locked=...)``
never sheds, rotates or preempts its members (the device still writes
through their pages) and reports ``blocked_on_locked`` when one of them
needs pages only another member holds; ``decode_lookahead`` reserves the
pages of the continuation that writes one burst past the host's view.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, FrozenSet, List, Optional

from ..logging_utils import init_logger
from ..resilience.tenancy import DeficitScheduler
from .kv_manager import BlockAllocator, NoFreeBlocksError
from .sequence import Sequence, SequenceStatus

logger = init_logger(__name__)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_num_seqs: int = 64
    max_prefill_tokens: int = 2048  # per-step chunked-prefill token budget
    max_model_len: int = 4096
    num_decode_steps: int = 1  # decode burst length per device call
    # Bursts of page reservation per decode pass: 2 when the engine
    # pipelines bursts (the in-flight continuation writes one burst past
    # what the host has seen, so its pages must exist at dispatch time).
    decode_lookahead: int = 1
    # Extra per-sequence page reservation for speculative decoding: a
    # verify step writes KV at up to spec_tokens positions past the
    # committed length, so those pages must exist before dispatch.
    spec_tokens: int = 0
    # Fair timeslicing when more live users than the cache holds (needs
    # a swapper): after a running sequence has decoded this many tokens
    # since its last (re)admission, it may rotate out in favor of a
    # parked or waiting one. 0 = rotate only under allocation pressure.
    swap_quantum: int = 0
    # Drop sequences whose end-to-end budget (Sequence.deadline,
    # monotonic) expired: queued ones before they take a prefill step,
    # running ones between decode steps.
    deadline_shedding: bool = True
    # Admit the waiting queue weighted-fair across tenants with strict
    # tier priority (interactive before batch), and preempt batch-tier
    # sequences first. With one tenant and tier this is plain FIFO.
    tenant_fairness: bool = True


@dataclasses.dataclass
class PrefillItem:
    seq: Sequence
    start: int  # first token index processed this step
    end: int  # one past the last token index


@dataclasses.dataclass
class SchedulerOutput:
    prefills: List[PrefillItem] = dataclasses.field(default_factory=list)
    decodes: List[Sequence] = dataclasses.field(default_factory=list)
    preempted: List[Sequence] = dataclasses.field(default_factory=list)
    # Sequences shed this pass because their deadline expired (pages
    # already released): the engine answers them finish_reason="deadline".
    expired: List[Sequence] = dataclasses.field(default_factory=list)
    n_decode_steps: int = 1
    # A locked (in-flight-burst) sequence needed pages it could not get
    # without evicting another locked sequence: the engine must drain the
    # burst and schedule again.
    blocked_on_locked: bool = False

    @property
    def is_empty(self) -> bool:
        return not self.prefills and not self.decodes


class Scheduler:
    def __init__(self, config: SchedulerConfig, allocator: BlockAllocator,
                 swapper=None):
        self.config = config
        self.allocator = allocator
        # Optional engine/swap.KVSwapper: preemption parks KV host-side
        # and resumes without recompute.
        self.swapper = swapper
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self.swapped: Deque[Sequence] = deque()
        # Monotonic admission stamp: ``waiting`` and ``swapped`` form ONE
        # logical FIFO (else rotation would free pages for a waiting
        # request only for the rotated-out sequence to reclaim them).
        # Involuntary preemption or swap keeps the original stamp (front
        # of the line); voluntary rotation takes a fresh one (back).
        self._stamp = 0
        # (request_id, num_free) of the last head-of-line admission failure:
        # no point re-running the prefix match until free pages change.
        self._admit_blocked: Optional[tuple] = None
        # Request ids of the in-flight burst's members (this pass).
        self._locked: FrozenSet[str] = frozenset()
        # Deadline sheds (engine stats → pst:deadline_shed_*).
        self.deadline_sheds_queued = 0  # shed before any prefill step
        self.deadline_sheds_running = 0  # shed between decode steps
        # DRR credit across tenants for the admission order, and the
        # batch-tier preemptions made for interactive work.
        self._tenant_drr = DeficitScheduler()
        self.batch_preemptions = 0

    # -- queue ops --------------------------------------------------------

    def prompt_fits(self, n_prompt_tokens: int) -> bool:
        """Whether a prompt (plus its first decode token) can EVER be
        scheduled in this pool."""
        bs = self.allocator.block_size
        return -(-(n_prompt_tokens + 1) // bs) <= self.allocator.num_blocks

    def add(self, seq: Sequence) -> None:
        if seq.num_prompt_tokens >= self.config.max_model_len:
            raise ValueError(
                f"prompt of {seq.num_prompt_tokens} tokens exceeds "
                f"max_model_len={self.config.max_model_len}"
            )
        if not self.prompt_fits(seq.num_prompt_tokens):
            raise ValueError(
                f"prompt of {seq.num_prompt_tokens} tokens needs more KV "
                f"pages than the engine has ({self.allocator.num_blocks})"
            )
        seq.queue_stamp = self._next_stamp()
        self.waiting.append(seq)

    def _next_stamp(self) -> int:
        self._stamp += 1
        return self._stamp

    @staticmethod
    def _insert_by_stamp(dq: "Deque[Sequence]", seq: Sequence) -> None:
        """Insert keeping the deque ascending by queue_stamp (after rotate
        and resume cycles the running list is no longer stamp-ordered)."""
        if not dq or dq[-1].queue_stamp <= seq.queue_stamp:
            dq.append(seq)
            return
        for i, s in enumerate(dq):
            if s.queue_stamp > seq.queue_stamp:
                dq.insert(i, seq)
                return

    def abort(self, request_id: str) -> Optional[Sequence]:
        for q in (self.waiting, self.running, self.swapped):
            for seq in list(q):
                if seq.request_id == request_id:
                    q.remove(seq)
                    self._finish(seq, "abort")
                    return seq
        return None

    def detach(self, request_id: str,
               reason: str = "abort") -> Optional[Sequence]:
        """Remove a sequence from the queues WITHOUT releasing its pages:
        an in-flight pipelined burst still writes through its block table,
        so the engine releases them when the burst drains."""
        for q in (self.waiting, self.running, self.swapped):
            for seq in list(q):
                if seq.request_id == request_id:
                    q.remove(seq)
                    seq.status = SequenceStatus.FINISHED
                    seq.finish_reason = reason
                    return seq
        return None

    def finish(self, seq: Sequence, reason: str) -> None:
        if seq in self.running:
            self.running.remove(seq)
        self._finish(seq, reason)

    def _finish(self, seq: Sequence, reason: str) -> None:
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = reason
        self.allocator.release_all(seq.block_ids)
        seq.block_ids = []
        if self.swapper is not None:
            self.swapper.drop(seq.request_id)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    @property
    def num_swapped(self) -> int:
        return len(self.swapped)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.swapped)

    # -- the step ---------------------------------------------------------

    def schedule(
        self,
        locked: FrozenSet[str] = frozenset(),
        n_decode: Optional[int] = None,
    ) -> SchedulerOutput:
        """``locked``: request ids whose pages an in-flight burst
        references; none of them is shed, rotated or preempted this pass.
        ``n_decode``: the burst depth for this pass (the engine's adaptive
        hint), clamped by the same per-sequence limits as the configured
        one."""
        self._locked = locked
        out = SchedulerOutput()
        # Deadline sweep first: an expired sequence never takes a device
        # step, nor an admission that pins pages.
        self._shed_expired(out)
        self._admit(out)
        # Fair timeslicing: with parked or queued work left after
        # admission, rotate out the running sequence with the most decode
        # progress past the quantum; the next pass admits into its pages.
        if (self.swapper is not None and (self.swapped or self.waiting)
                and len(self.running) > 1):
            self._rotate()

        # Phase 1: sequences needing prompt (or post-preemption recompute)
        # work get chunks, oldest first, bounded by the step token budget.
        # A preempted sequence that already has outputs recomputes KV up to
        # its last token exclusive — that token is re-processed by decode.
        budget = self.config.max_prefill_tokens
        for seq in list(self.running):
            if budget <= 0:
                break
            if seq not in self.running:  # evicted by an earlier _ensure_blocks
                continue
            target = (
                seq.num_prompt_tokens
                if not seq.output_token_ids
                else seq.num_tokens - 1
            )
            remaining = target - seq.num_computed_tokens
            if remaining <= 0:
                continue
            chunk = min(remaining, budget)
            start = seq.num_computed_tokens
            end = start + chunk
            if not self._ensure_blocks(seq, end, out):
                continue
            out.prefills.append(PrefillItem(seq=seq, start=start, end=end))
            budget -= chunk
        if out.prefills:
            return out

        # Phase 2: a decode burst for every running sequence, bounded so no
        # sequence writes KV past max_model_len; early stops are trimmed
        # host-side.
        n = max(n_decode or self.config.num_decode_steps, 1)
        for seq in self.running:
            n = min(n, max(self.config.max_model_len - seq.num_tokens, 1))
            if seq.sampling.guided_choice:
                n = 1  # the allowed-token mask is rebuilt per token
        look = max(self.config.decode_lookahead, 1)
        for seq in list(self.running):
            if seq not in self.running:  # lost pages to an earlier preemption
                continue
            reserve = min(
                seq.num_tokens + max(look * n - 1, self.config.spec_tokens),
                self.config.max_model_len)
            if not self._ensure_blocks(seq, reserve, out, protect=seq):
                continue
            out.decodes.append(seq)
        out.n_decode_steps = n
        return out

    # -- state for stats ----------------------------------------------------

    def flight_depths(self) -> tuple:
        """(waiting, running, swapped, batch-tier running rows). Read on
        the step thread, which mutates the queues."""
        running = self.running
        batch = sum(1 for s in running if s.tier_rank)
        return (len(self.waiting), len(running), len(self.swapped), batch)

    def queue_age_by_tier(self, now: Optional[float] = None) -> dict:
        """The oldest queued (waiting or parked) sequence's age per tier,
        in seconds: the starvation signal behind
        ``pst:tenant_queue_age_*``."""
        now = now if now is not None else time.monotonic()
        ages = {"interactive": 0.0, "batch": 0.0}
        # list(deque) is one C-level copy (atomic under the GIL): this runs
        # on an HTTP thread while the step thread mutates the queues.
        for q in (list(self.waiting), list(self.swapped)):
            for seq in q:
                tier = "batch" if seq.tier_rank else "interactive"
                ages[tier] = max(ages[tier], now - seq.arrival_time)
        return ages

    # -- internals --------------------------------------------------------

    def _shed_expired(self, out: SchedulerOutput) -> None:
        """Drop sequences whose deadline budget is gone, before a device
        step is spent on them: queued or parked ones from the line
        (``deadline_sheds_queued``), running ones between decode steps
        (``deadline_sheds_running``). Members of an in-flight burst are
        skipped (the device still writes through their pages) and caught
        on the pass after the drain."""
        if not self.config.deadline_shedding:
            return
        now = time.monotonic()
        for q, running in ((self.waiting, False), (self.swapped, False),
                           (self.running, True)):
            for seq in [s for s in q if s.deadline_expired(now)]:
                if seq.request_id in self._locked:
                    continue
                q.remove(seq)
                self._finish(seq, "deadline")
                if running:
                    self.deadline_sheds_running += 1
                else:
                    self.deadline_sheds_queued += 1
                    self._admit_blocked = None  # free pages changed
                out.expired.append(seq)
                logger.info(
                    "shedding request %s (deadline exceeded while %s)",
                    seq.request_id, "running" if running else "queued",
                )

    def _rotate(self) -> None:
        """Swap out at most ONE quantum-expired running sequence per pass
        (bounds thrash; steady state rotates every ``swap_quantum``
        tokens)."""
        q = self.config.swap_quantum
        if q <= 0:
            return
        best: Optional[Sequence] = None
        for seq in self.running:
            if seq.request_id in self._locked or seq.in_prefill:
                continue
            progress = seq.num_tokens - seq.resume_marker
            if progress >= q and (
                best is None
                or progress > best.num_tokens - best.resume_marker
            ):
                best = seq
        if best is not None and self.swapper.can_stash(best, self.allocator):
            self.running.remove(best)
            self.swapper.swap_out(best, self.allocator)
            best.queue_stamp = self._next_stamp()  # back of the line
            self.swapped.append(best)
            self._admit_blocked = None  # free pages changed

    def _next_waiting_index(self) -> int:
        """Which waiting sequence admits next: FIFO (index 0) when tenant
        fairness is off or the queue is homogeneous; otherwise the best
        tier first and, within it, tenants by deficit round robin. Stamp
        order holds within each (tier, tenant) class."""
        if not self.config.tenant_fairness or len(self.waiting) < 2:
            return 0
        keys = {(s.tier_rank, s.tenant) for s in self.waiting}
        if len(keys) == 1:
            return 0
        best_rank = min(rank for rank, _ in keys)
        heads: dict = {}
        for i, s in enumerate(self.waiting):
            if s.tier_rank == best_rank and s.tenant not in heads:
                heads[s.tenant] = i
        pick = self._tenant_drr.pick({t: 1.0 for t in heads})
        return heads.get(pick, 0)

    def _preempt_batch_for(self, seq: Sequence, out: SchedulerOutput) -> bool:
        """An interactive sequence is blocked on pages that batch-tier
        work holds: preempt ONE running batch-tier sequence (swap first)
        and report whether pages were freed."""
        victim: Optional[Sequence] = None
        for cand in reversed(self.running):  # youngest batch first
            if cand.request_id in self._locked or cand.tier_rank != 1:
                continue
            victim = cand
            break
        if victim is None:
            return False
        self._preempt(victim, out)
        self.batch_preemptions += 1
        self._admit_blocked = None  # free pages changed
        logger.info(
            "preempting batch-tier request %s for waiting interactive %s",
            victim.request_id, seq.request_id,
        )
        return True

    def _promised_pages(self) -> int:
        """Pages already-admitted sequences will still allocate to finish
        their prompts (admission itself allocates nothing)."""
        bs = self.allocator.block_size
        return sum(
            s.blocks_needed(s.num_prompt_tokens, bs) for s in self.running
        )

    def _admit(self, out: SchedulerOutput) -> None:
        # ``swapped`` and ``waiting`` admit as one stamp-ordered FIFO. A
        # swap-in is gated by a worst-case page check, so a blocked resume
        # does not churn I/O every pass.
        promised = self._promised_pages()
        while self.swapped and len(self.running) < self.config.max_num_seqs:
            seq = self.swapped[0]
            if self.waiting and self.waiting[0].queue_stamp < seq.queue_stamp:
                break  # an older waiting request admits first
            # Headroom beyond the bare resume need: each running sequence
            # may grow a page within a few steps, and a resume that leaves
            # no slack is swapped right back out. With NOTHING running the
            # gate must not hold (a sequence that once filled the pool
            # would wait forever): swap_in itself degrades safely. Unless
            # a burst is in flight: its members that finished are off
            # ``running`` while their pages wait for its drain, and a
            # resume now would find no page for the chain it faults back
            # and recompute. The JAX scheduler resumes there (ROADMAP
            # fault 3.7); the port waits for the drain, one step.
            reserve = len(self.running) + 1
            if (self.running or self._locked) and (
                self.swapper.blocks_needed(seq) + reserve + promised
                > self.allocator.num_free
            ):
                return  # no room for the line's head: nobody jumps it
            self.swapped.popleft()
            if not self.swapper.swap_in(seq, self.allocator):
                self._insert_by_stamp(self.swapped, seq)
                return
            if seq.status == SequenceStatus.RUNNING:
                seq.resume_marker = seq.num_tokens
                if seq.first_scheduled_time is None:
                    seq.first_scheduled_time = time.monotonic()
                self.running.append(seq)
            else:
                # Part of the committed chain was reused: the sequence
                # recomputes from its longest surviving prefix.
                self._insert_by_stamp(self.waiting, seq)
        # A parked head still in ``swapped`` here yielded to an older
        # waiting request (a head that could not resume returned above),
        # so the waiting queue's pick admits. The JAX scheduler holds its
        # pick behind an older parked head of its tier or better: with
        # tiers ordering the pick, an interactive pick then waits on the
        # parked head, which waits on an older batch request, for good.
        while self.waiting and len(self.running) < self.config.max_num_seqs:
            idx = self._next_waiting_index()
            seq = self.waiting[idx]
            if self._admit_blocked == (seq.request_id, self.allocator.num_free):
                break  # nothing changed since the last failed attempt
            # Prefix-cache lookup; never match the full token list — at
            # least one token must be computed to produce logits.
            if not seq.block_ids:
                toks = seq.all_token_ids
                blocks, hashes = self.allocator.match_prefix(
                    toks[: len(toks) - 1], salt=seq.cache_salt,
                    deadline=seq.deadline)
                if blocks:
                    seq.adopt_cached_prefix(blocks, hashes)
                    seq.num_computed_tokens = len(blocks) * self.allocator.block_size
                    seq.num_cached_prompt_tokens = seq.num_computed_tokens
            # Admission requires pages for everything the sequence
            # computes, not just the first chunk (chunk-level admission
            # overcommits the pool and thrashes prefills at near-capacity).
            # That is its prompt AND its output when it recomputes after a
            # preemption (or a swap-in whose chain was reused). The JAX
            # scheduler sizes this by the prompt alone: a recompute then
            # admits short of pages, takes them by preempting the next
            # sequence, and with kv_swap off the two livelock. The port
            # departs from it here on purpose.
            need = seq.blocks_needed(
                seq.num_tokens, self.allocator.block_size
            )
            if need + promised > self.allocator.num_free:
                # Stays queued; release the adopted prefix (re-matched on
                # the next attempt) so a waiting sequence pins nothing.
                if seq.block_ids:
                    self.allocator.release_all(seq.block_ids)
                    seq.reset_for_recompute()
                    seq.status = SequenceStatus.WAITING
                # Before declaring the pool full for a waiting interactive
                # sequence, evict one running batch-tier sequence and
                # retry: batch work never starves interactive prefills.
                if (self.config.tenant_fairness and seq.tier_rank == 0
                        and self._preempt_batch_for(seq, out)):
                    promised = self._promised_pages()
                    continue
                self._admit_blocked = (seq.request_id, self.allocator.num_free)
                break
            del self.waiting[idx]
            self._admit_blocked = None
            self._tenant_drr.charge(seq.tenant)
            seq.status = SequenceStatus.RUNNING
            seq.resume_marker = seq.num_tokens
            if seq.first_scheduled_time is None:
                seq.first_scheduled_time = time.monotonic()
            self.running.append(seq)
            promised += need

    def _ensure_blocks(
        self,
        seq: Sequence,
        up_to_tokens: int,
        out: SchedulerOutput,
        protect: Optional[Sequence] = None,
    ) -> bool:
        """Allocate pages for ``seq`` up to ``up_to_tokens``, preempting the
        youngest other sequence on exhaustion. False if ``seq`` itself lost."""
        while True:
            try:
                for _ in range(
                    seq.blocks_needed(up_to_tokens, self.allocator.block_size)
                ):
                    seq.block_ids.append(self.allocator.allocate())
                return True
            except NoFreeBlocksError:
                victim = self._pick_victim(exclude=protect or seq)
                if victim is None:
                    if seq.request_id in self._locked:
                        # An in-flight burst writes through its pages: it
                        # cannot preempt itself. The engine drains and
                        # schedules again.
                        out.blocked_on_locked = True
                        out.decodes[:] = [s for s in out.decodes
                                          if s is not seq]
                        return False
                    self._preempt(seq, out)  # nothing left but itself
                    return False
                self._preempt(victim, out)

    def _pick_victim(self, exclude: Sequence) -> Optional[Sequence]:
        if self.config.tenant_fairness:
            # Batch-tier sequences go first: an interactive sequence loses
            # pages only when no batch victim remains.
            for seq in reversed(self.running):  # youngest batch first
                if (seq is not exclude and seq.request_id not in self._locked
                        and seq.tier_rank == 1):
                    return seq
        for seq in reversed(self.running):  # youngest first (vLLM policy)
            if seq is not exclude and seq.request_id not in self._locked:
                return seq
        return None

    def _preempt(self, seq: Sequence, out: SchedulerOutput) -> None:
        if seq in self.running:
            self.running.remove(seq)
        # The victim may already have been granted work this step.
        out.decodes[:] = [s for s in out.decodes if s is not seq]
        out.prefills[:] = [it for it in out.prefills if it.seq is not seq]
        if (self.swapper is not None and not seq.in_prefill
                and self.swapper.can_stash(seq, self.allocator)):
            # Park KV instead of recompute: the committed prefix stays
            # addressed in place; only the tail pages move host-side. It
            # keeps its original stamp: near the front of the resume line.
            logger.info("swapping out request %s (out of KV pages)",
                        seq.request_id)
            self.swapper.swap_out(seq, self.allocator)
            self._insert_by_stamp(self.swapped, seq)
            return
        logger.warning("preempting request %s (out of KV pages)", seq.request_id)
        self.allocator.release_all(seq.block_ids)
        seq.reset_for_recompute()
        self._insert_by_stamp(self.waiting, seq)
        out.preempted.append(seq)
