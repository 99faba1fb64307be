"""Paged KV-cache block manager with content-hash prefix caching.

A copy of the JAX package's ``engine/kv_manager.py``. Host-side
bookkeeping only — the device pages live in the stacked
``[L, nb, 2, bs, KH*hd]`` cache tensor owned by the runner; this class
decides *which page index* each sequence writes and reads, and which full
pages are shareable across requests via the prefix-committing block hashes
of :mod:`production_stack_tpu_torch.kvcache.hashing`.

Eviction is LRU over reusable pages (refcount 0 but content intact). An
``on_evict(blk, h)`` hook lets the tiering layer
(``engine/cache_tiering.py``) capture pages on their way out.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..kvcache.hashing import block_hashes


class NoFreeBlocksError(RuntimeError):
    pass


class BlockAllocator:
    """Reference-counted page allocator with hash-addressed reuse."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
        on_evict: Optional[Callable[[int, int], None]] = None,
    ):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self.on_evict = on_evict
        self._refcount = [0] * num_blocks
        self._hash_of_block: Dict[int, int] = {}
        self._block_of_hash: Dict[int, int] = {}
        # refcount-0 blocks with intact, hash-addressed content (LRU order).
        self._reusable: "collections.OrderedDict[int, int]" = collections.OrderedDict()
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        # Prefix-cache KPIs.
        self.hit_tokens = 0
        self.query_tokens = 0

    # -- capacity ---------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._reusable)

    @property
    def usage(self) -> float:
        return 1.0 - self.num_free / max(self.num_blocks, 1)

    # -- allocation -------------------------------------------------------

    def allocate(self) -> int:
        """Take one writable page (evicting the LRU reusable page if needed)."""
        if self._free:
            blk = self._free.pop()
            self._refcount[blk] = 1
            return blk
        if self._reusable:
            blk, h = self._reusable.popitem(last=False)
            del self._block_of_hash[h]
            del self._hash_of_block[blk]
            if self.on_evict is not None:
                self.on_evict(blk, h)
            self._refcount[blk] = 1
            return blk
        raise NoFreeBlocksError("out of KV blocks")

    def acquire_cached(self, h: int):
        """Reuse the page holding hash ``h``, if resident. Increfs."""
        if not self.enable_prefix_caching:
            return None
        blk = self._block_of_hash.get(h)
        if blk is None:
            return None
        if blk in self._reusable:
            del self._reusable[blk]
        self._refcount[blk] += 1
        return blk

    def incref(self, blk: int) -> None:
        self._refcount[blk] += 1

    def acquire_resident(self, h: int):
        """Reacquire the page holding hash ``h`` from wherever it survives.
        Here device memory only; the tiered allocator also faults pages
        back up from host memory or the remote store. The swap path uses
        it to resurrect a parked sequence's committed prefix without
        copying bytes that never left."""
        return self.acquire_cached(h)

    def commit(self, blk: int, h: int, allow_swap: bool = True) -> int:
        """Mark a freshly written full page as content-addressed by ``h``.
        If another request already committed the same content, dedup to the
        existing page: the caller must swap to the returned id.
        ``allow_swap=False`` suppresses that (and the release of the
        duplicate): the engine keeps a page that decoding filled, whose
        sequence goes on reading the bits it wrote (ROADMAP fault 3.9),
        and which an in-flight burst's block table may still point at."""
        if not self.enable_prefix_caching:
            return blk
        existing = self._block_of_hash.get(h)
        if existing is not None and existing != blk:
            if not allow_swap:
                return blk  # our copy stays un-addressed; existing owns h
            self.release(blk)
            self.incref(existing)
            if existing in self._reusable:
                del self._reusable[existing]
            return existing
        self._hash_of_block[blk] = h
        self._block_of_hash[h] = blk
        return blk

    def release(self, blk: int) -> None:
        self._refcount[blk] -= 1
        assert self._refcount[blk] >= 0, f"double free of block {blk}"
        if self._refcount[blk] == 0:
            h = self._hash_of_block.get(blk)
            if h is not None:
                self._reusable[blk] = h  # keep content for future hits
            else:
                self._free.append(blk)

    def release_all(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.release(b)

    # -- prefix lookup ----------------------------------------------------

    def match_prefix(
        self,
        token_ids: Sequence[int],
        salt: int = 0,
        deadline: Optional[float] = None,
    ) -> Tuple[List[int], List[int]]:
        """Longest resident prefix of ``token_ids`` at block granularity.
        ``salt`` seeds the hash chain; ``deadline`` (monotonic) bounds the
        tiered allocator's lower-tier fetches, and this device-only one
        ignores it. Returns (matched block ids — increfed, their hashes).
        Callers start computing at ``len(matched) * block_size``."""
        self.query_tokens += len(token_ids)
        if not self.enable_prefix_caching:
            return [], []
        matched: List[int] = []
        matched_hashes: List[int] = []
        for h in block_hashes(token_ids, self.block_size, parent=salt):
            blk = self.acquire_cached(h)
            if blk is None:
                break
            matched.append(blk)
            matched_hashes.append(h)
        self.hit_tokens += len(matched) * self.block_size
        return matched, matched_hashes

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.query_tokens if self.query_tokens else 0.0
