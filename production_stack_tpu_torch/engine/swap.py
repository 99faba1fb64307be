"""Live-sequence KV swap: preempt by parking KV, not by recompute.

A copy of the JAX package's ``engine/swap.py``. The engine content-
addresses every filled page (``Sequence.commit_full_blocks``), so when a
sequence is parked:

- its **committed pages stay where they are**: released to the
  allocator's reusable set they keep their content and hash addressing
  and serve prefix hits for other requests meanwhile;
- only the **uncommitted tail** (at most one partial page, plus pages
  reserved ahead of the write cursor) is copied into a host stash.

Resume re-acquires the committed chain by hash (``acquire_resident``:
over a tiered allocator a page evicted meanwhile faults back up from host
memory or the remote store), uploads the stashed tail, and decode
continues at the exact token it stopped at. If part of the chain is gone
from every tier, the sequence falls back to the recompute path from the
longest surviving prefix — strictly no worse than recompute preemption.

``page_io`` is the runner (``download_page`` / ``upload_page``). On the
GPU both are queued on the step stream without a host wait: a page's
device-to-host copy lands in pinned memory, and its upload, queued after
it on the same stream, reads it only once it landed. So the stash holds
the runner's tensors (pinned ones on the GPU) in the cache's own type; a
reader on the host synchronizes first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from ..logging_utils import init_logger
from .kv_manager import BlockAllocator, NoFreeBlocksError
from .sequence import Sequence, SequenceStatus

logger = init_logger(__name__)


@dataclasses.dataclass
class _SwapRecord:
    hashes: List[int]  # committed-prefix block hashes (in order)
    # (K page, V page) per page past the committed chain, in sequence
    # order — the tail is contiguous starting at len(hashes).
    tail: List[Tuple[Any, Any]]
    num_computed_tokens: int
    num_blocks: int  # pages holding computed KV at swap-out


class KVSwapper:
    """Parks and resumes live sequences' KV. ``page_io`` is the runner
    adapter (``download_page`` / ``upload_page``)."""

    def __init__(self, page_io, max_stash_blocks: int = 4096):
        self.page_io = page_io
        self.max_stash_blocks = max_stash_blocks
        self._stash: Dict[str, _SwapRecord] = {}
        self._stash_blocks = 0
        # KPIs (engine.stats → /metrics).
        self.swap_out_total = 0
        self.swap_in_total = 0
        self.tail_pages_moved = 0
        self.fallback_recompute_total = 0

    def __contains__(self, request_id: str) -> bool:
        return request_id in self._stash

    @property
    def stash_blocks(self) -> int:
        return self._stash_blocks

    @staticmethod
    def _tail_range(seq: Sequence, allocator: BlockAllocator) -> Tuple[int, int]:
        """(committed, used) page bounds for a swap: pages in
        [committed, used) must be physically stashed. Pages ≥ ``used`` are
        lookahead reserve holding no computed KV — resume re-reserves them
        instead of moving garbage. With prefix caching off nothing is
        hash-recoverable, so everything up to ``used`` is tail."""
        bs = allocator.block_size
        used = -(-seq.num_computed_tokens // bs)
        committed = (
            min(seq._committed_blocks, used)
            if allocator.enable_prefix_caching
            else 0
        )
        return committed, used

    def can_stash(self, seq: Sequence, allocator: BlockAllocator) -> bool:
        committed, used = self._tail_range(seq, allocator)
        return self._stash_blocks + (used - committed) <= self.max_stash_blocks

    def swap_out(self, seq: Sequence, allocator: BlockAllocator) -> None:
        """Copy out the uncommitted tail, release all pages, park the
        sequence. The committed prefix needs no copying — content-addressed
        pages survive release in the reusable set."""
        committed, used = self._tail_range(seq, allocator)
        tail = [self.page_io.download_page(seq.block_ids[i])
                for i in range(committed, used)]
        self._stash[seq.request_id] = _SwapRecord(
            hashes=list(seq.block_hashes[:committed]),
            tail=tail,
            num_computed_tokens=seq.num_computed_tokens,
            num_blocks=used,
        )
        self._stash_blocks += len(tail)
        allocator.release_all(seq.block_ids)
        seq.block_ids = []
        seq.status = SequenceStatus.SWAPPED
        self.swap_out_total += 1
        self.tail_pages_moved += len(tail)
        logger.debug(
            "swapped out %s: %d committed pages stay addressed, %d tail "
            "pages stashed", seq.request_id, committed, len(tail),
        )

    def swap_in(self, seq: Sequence, allocator: BlockAllocator) -> bool:
        """Resurrect a parked sequence. True → seq is RUNNING-ready with its
        full KV resident and ``num_computed_tokens`` restored. False → could
        not (no free pages): the caller keeps it parked and retries later.

        An unrecoverable committed page (reused meanwhile) downgrades to
        recompute-from-longest-prefix: the stash is dropped and the
        sequence re-enters the recompute flow, left WAITING with the
        recovered prefix adopted; True is returned (it is schedulable)."""
        rec = self._stash.get(seq.request_id)
        assert rec is not None, f"no swap record for {seq.request_id}"
        acquired: List[int] = []
        for h in rec.hashes:
            blk = allocator.acquire_resident(h)
            if blk is None:
                break
            acquired.append(blk)
        if len(acquired) < len(rec.hashes):
            # Part of the chain is gone. Keep what survives as an adopted
            # prefix and recompute the rest (chunked-prefill path).
            self._drop_record(seq.request_id, rec)
            self.fallback_recompute_total += 1
            seq.reset_for_recompute()
            if acquired:
                seq.adopt_cached_prefix(acquired, rec.hashes[: len(acquired)])
                seq.num_computed_tokens = len(acquired) * allocator.block_size
            seq.status = SequenceStatus.WAITING
            logger.warning(
                "swap-in of %s lost %d/%d committed pages; recomputing "
                "from token %d", seq.request_id,
                len(rec.hashes) - len(acquired), len(rec.hashes),
                seq.num_computed_tokens,
            )
            return True
        # Allocate and upload the stashed tail.
        fresh: List[int] = []
        try:
            for _ in rec.tail:
                fresh.append(allocator.allocate())
        except NoFreeBlocksError:
            for blk in fresh:
                allocator.release(blk)
            for blk in acquired:
                allocator.release(blk)
            return False
        for (k, v), blk in zip(rec.tail, fresh):
            self.page_io.upload_page(blk, k, v)
        seq.block_ids = acquired + fresh
        seq.block_hashes = list(rec.hashes)
        seq._committed_blocks = len(rec.hashes)
        seq._last_hash = rec.hashes[-1] if rec.hashes else seq.cache_salt
        seq.num_computed_tokens = rec.num_computed_tokens
        seq.status = SequenceStatus.RUNNING
        self._drop_record(seq.request_id, rec)
        self.swap_in_total += 1
        return True

    def blocks_needed(self, seq: Sequence) -> int:
        """Worst-case fresh pages a swap-in may allocate."""
        rec = self._stash.get(seq.request_id)
        return rec.num_blocks if rec is not None else 0

    def drop(self, request_id: str) -> None:
        """Forget a parked sequence's stash (abort or finish)."""
        rec = self._stash.pop(request_id, None)
        if rec is not None:
            self._stash_blocks -= len(rec.tail)

    def _drop_record(self, request_id: str, rec: _SwapRecord) -> None:
        self._stash.pop(request_id, None)
        self._stash_blocks -= len(rec.tail)
