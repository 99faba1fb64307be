"""Continuous-batching scheduler: admission, chunked prefill, preemption.

A copy of the JAX package's ``engine/scheduler.py`` for the paths this
slice serves. Each call to :meth:`Scheduler.schedule` emits one device
step: either a set of prefill chunks (token-budget bounded) or one decode
batch over all running sequences. Out-of-pages decode preempts the
youngest sequence (free its pages, recompute later).

While a pipelined decode burst is in flight, ``schedule(locked=...)``
never preempts its members (the device still writes through their
pages) and reports ``blocked_on_locked`` when one of them needs pages
only another member holds; ``decode_lookahead`` reserves the pages of
the continuation that writes one burst past the host's view.

Not ported yet: KV swap (preemption always recomputes), tenant-fair
admission (``tenant_fairness=True`` raises) and deadline shedding.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, FrozenSet, List, Optional

from ..logging_utils import init_logger
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
    tenant_fairness: bool = False


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
    n_decode_steps: int = 1
    # A locked (in-flight-burst) sequence needed pages it could not get
    # without evicting another locked sequence: the engine must drain the
    # burst and schedule again.
    blocked_on_locked: bool = False

    @property
    def is_empty(self) -> bool:
        return not self.prefills and not self.decodes


class Scheduler:
    def __init__(self, config: SchedulerConfig, allocator: BlockAllocator):
        if config.tenant_fairness:
            raise NotImplementedError(
                "tenant-fair scheduling is not ported to the PyTorch package"
            )
        self.config = config
        self.allocator = allocator
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        # Monotonic admission stamp: preempted sequences keep theirs and
        # re-enter the waiting line in stamp order.
        self._stamp = 0
        # (request_id, num_free) of the last head-of-line admission failure:
        # no point re-running the prefix match until free pages change.
        self._admit_blocked: Optional[tuple] = None
        # Request ids of the in-flight burst's members (this pass).
        self._locked: FrozenSet[str] = frozenset()

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
        self._stamp += 1
        seq.queue_stamp = self._stamp
        self.waiting.append(seq)

    @staticmethod
    def _insert_by_stamp(dq: "Deque[Sequence]", seq: Sequence) -> None:
        """Insert keeping the deque ascending by queue_stamp."""
        if not dq or dq[-1].queue_stamp <= seq.queue_stamp:
            dq.append(seq)
            return
        for i, s in enumerate(dq):
            if s.queue_stamp > seq.queue_stamp:
                dq.insert(i, seq)
                return

    def abort(self, request_id: str) -> Optional[Sequence]:
        for q in (self.waiting, self.running):
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
        for q in (self.waiting, self.running):
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

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- the step ---------------------------------------------------------

    def schedule(
        self,
        locked: FrozenSet[str] = frozenset(),
        n_decode: Optional[int] = None,
    ) -> SchedulerOutput:
        """``locked``: request ids whose pages an in-flight burst
        references; none of them is preempted this pass. ``n_decode``:
        the burst depth for this pass (the engine's adaptive hint),
        clamped by the same per-sequence limits as the configured one."""
        self._locked = locked
        out = SchedulerOutput()
        self._admit()

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
            reserve = min(seq.num_tokens + look * n - 1,
                          self.config.max_model_len)
            if not self._ensure_blocks(seq, reserve, out, protect=seq):
                continue
            out.decodes.append(seq)
        out.n_decode_steps = n
        return out

    # -- internals --------------------------------------------------------

    def _promised_pages(self) -> int:
        """Pages already-admitted sequences will still allocate to finish
        their prompts (admission itself allocates nothing)."""
        bs = self.allocator.block_size
        return sum(
            s.blocks_needed(s.num_prompt_tokens, bs) for s in self.running
        )

    def _admit(self) -> None:
        promised = self._promised_pages()
        while self.waiting and len(self.running) < self.config.max_num_seqs:
            seq = self.waiting[0]
            if self._admit_blocked == (seq.request_id, self.allocator.num_free):
                break  # nothing changed since the last failed attempt
            # Prefix-cache lookup; never match the full token list — at
            # least one token must be computed to produce logits.
            if not seq.block_ids:
                toks = seq.all_token_ids
                blocks, hashes = self.allocator.match_prefix(toks[: len(toks) - 1])
                if blocks:
                    seq.adopt_cached_prefix(blocks, hashes)
                    seq.num_computed_tokens = len(blocks) * self.allocator.block_size
                    seq.num_cached_prompt_tokens = seq.num_computed_tokens
            # Admission requires pages for the FULL prompt, not just the
            # first chunk (chunk-level admission overcommits the pool and
            # thrashes prefills at near-capacity).
            need = seq.blocks_needed(
                seq.num_prompt_tokens, self.allocator.block_size
            )
            if need + promised > self.allocator.num_free:
                # Stays queued; release the adopted prefix (re-matched on
                # the next attempt) so a waiting sequence pins nothing.
                if seq.block_ids:
                    self.allocator.release_all(seq.block_ids)
                    seq.reset_for_recompute()
                    seq.status = SequenceStatus.WAITING
                self._admit_blocked = (seq.request_id, self.allocator.num_free)
                break
            self.waiting.popleft()
            self._admit_blocked = None
            seq.status = SequenceStatus.RUNNING
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
        logger.warning("preempting request %s (out of KV pages)", seq.request_id)
        self.allocator.release_all(seq.block_ids)
        seq.reset_for_recompute()
        self._insert_by_stamp(self.waiting, seq)
        out.preempted.append(seq)
