"""Replicated, sharded remote-KV client.

A copy of the JAX package's ``kvserver/sharded.py``: one
:class:`~production_stack_tpu_torch.engine.cache_tiering.RemoteKVClient`
a kvserver shard behind the same call surface, so the tiered allocator,
the handoff publisher and the prefetcher are shard-oblivious
(``--remote-kv-url`` grows commas).

Placement: a block's owners are the ``replication`` (R) distinct shards
clockwise from its hash on the consistent-hash ring
(:mod:`production_stack_tpu_torch.hashring`, the JAX ring's placement);
manifests replicate to the request id's owners the same way.

- **puts** fan out to all R owners; a page counts as stored when one
  owner took it.
- **reads** walk the ring order from the block's position (owners first,
  then the other shards), skip shards whose circuit breaker refuses, fail
  over on an error, a miss or a corrupt copy, each hop bounded by the
  caller's remaining deadline.
- **read repair**: a block served by anything but its first healthy
  owner is re-pushed to the owners that missed it (``read_repairs``).

Every breaker touch goes through one lock: the engine's step, worker and
handler threads all call in here.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from ..hashring import ConsistentHashRing
from ..logging_utils import init_logger
from ..resilience.breaker import CircuitBreaker

logger = init_logger(__name__)

# Shard breakers trip faster than router-engine ones: a dead shard costs
# every read a timeout until its breaker opens.
SHARD_FAILURE_THRESHOLD = 3
SHARD_RECOVERY_TIME_S = 5.0


class ShardedKVClient:
    """R-way replicated client over N kvserver shards."""

    def __init__(self, urls: Sequence[str], replication: int = 2,
                 timeout: float = 5.0):
        from ..engine.cache_tiering import INTEGRITY_SOURCES, RemoteKVClient

        self.urls = [u.rstrip("/") for u in urls if u]
        if not self.urls:
            raise ValueError("ShardedKVClient needs at least one shard URL")
        self.replication = min(max(int(replication), 1), len(self.urls))
        self.timeout = timeout
        self._ring = ConsistentHashRing()
        self._ring.update(self.urls)
        self._clients: Dict[str, RemoteKVClient] = {
            u: RemoteKVClient(u, timeout=timeout) for u in self.urls}
        self._breakers: Dict[str, CircuitBreaker] = {
            u: CircuitBreaker(u, failure_threshold=SHARD_FAILURE_THRESHOLD,
                              recovery_time=SHARD_RECOVERY_TIME_S)
            for u in self.urls}
        self._breaker_lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "integrity_failures": 0, "read_repairs": 0, "failovers": 0,
            "retries": 0}
        self.integrity_by_source: Dict[str, int] = dict.fromkeys(
            INTEGRITY_SOURCES, 0)

    # -- ring placement ---------------------------------------------------

    def owners(self, key) -> List[str]:
        """The R owners of a block hash or request id."""
        return self._ring.get_nodes(str(key), self.replication)

    def _walk(self, key) -> List[str]:
        """The read walk: the owners, then every other shard."""
        return self._ring.get_nodes(str(key), len(self.urls))

    # -- breakers ---------------------------------------------------------

    def _admits(self, url: str) -> bool:
        with self._breaker_lock:
            return self._breakers[url].allows()

    def _record(self, url: str, ok: bool) -> None:
        with self._breaker_lock:
            if ok:
                self._breakers[url].record_success()
            else:
                self._breakers[url].record_failure()

    def refresh_counters(self) -> None:
        """Fold the shard clients' audit counters into this client's."""
        for key in ("integrity_failures", "retries"):
            self.counters[key] = sum(c.counters[key]
                                     for c in self._clients.values())
        for source in self.integrity_by_source:
            self.integrity_by_source[source] = sum(
                c.integrity_by_source.get(source, 0)
                for c in self._clients.values())

    # -- puts (to every owner) --------------------------------------------

    def put(self, h: int, k, v, timeout: Optional[float] = None) -> bool:
        ok_any = False
        for url in self.owners(h):
            ok = self._clients[url].put(h, k, v, timeout=timeout)
            self._record(url, ok)
            ok_any = ok_any or ok
        return ok_any

    def put_blocks(self, pages: Sequence[tuple],
                   timeout: Optional[float] = None) -> bool:
        """Batched puts to each page's owners; True when EVERY page landed
        on at least one owner."""
        if not pages:
            return True
        by_owner: Dict[str, List[tuple]] = {}
        for page in pages:
            for url in self.owners(page[0]):
                by_owner.setdefault(url, []).append(page)
        owner_ok: Dict[str, bool] = {}
        for url, group in by_owner.items():
            if not self._admits(url):
                owner_ok[url] = False
                continue
            ok = self._clients[url].put_blocks(group, timeout=timeout)
            self._record(url, ok)
            owner_ok[url] = ok
        return all(any(owner_ok.get(url, False) for url in self.owners(p[0]))
                   for p in pages)

    # -- reads (nearest healthy owner, failover, read repair) ------------

    def get(self, h: int, timeout: Optional[float] = None,
            source: str = "restore") -> Optional[tuple]:
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.timeout)
        owner_set = set(self.owners(h))
        missed_owners: List[str] = []
        for i, url in enumerate(self._walk(h)):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            if not self._admits(url):
                if url in owner_set:
                    missed_owners.append(url)
                continue
            page, status = self._clients[url].get_ex(
                h, timeout=remaining, source=source)
            self._record(url, status != "error")
            if page is not None:
                if i > 0:
                    self.counters["failovers"] += 1
                self._repair([(h, *page)], missed_owners)
                return page
            if url in owner_set:
                missed_owners.append(url)
        return None

    def get_blocks(self, hashes: Sequence[int],
                   timeout: Optional[float] = None,
                   source: str = "match_prefix") -> Dict[int, tuple]:
        if not hashes:
            return {}
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.timeout)
        # Grouped by read walk: each shard sees ONE batched round trip a
        # call.
        groups: Dict[tuple, List[int]] = {}
        for h in hashes:
            groups.setdefault(tuple(self._walk(h)), []).append(h)
        found: Dict[int, tuple] = {}
        repairs: Dict[str, List[tuple]] = {}
        for walk, group in groups.items():
            owner_set = {h: set(self.owners(h)) for h in group}
            remaining_hashes = list(group)
            missed: Dict[int, List[str]] = {h: [] for h in group}
            for i, url in enumerate(walk):
                if not remaining_hashes:
                    break
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                if not self._admits(url):
                    for h in remaining_hashes:
                        if url in owner_set[h]:
                            missed[h].append(url)
                    continue
                pages, status = self._clients[url].get_blocks_ex(
                    remaining_hashes, timeout=budget, source=source)
                self._record(url, status != "error")
                if i > 0 and pages:
                    self.counters["failovers"] += 1
                for h, page in pages.items():
                    found[h] = page
                    for owner in missed[h]:
                        repairs.setdefault(owner, []).append((h, *page))
                still = []
                for h in remaining_hashes:
                    if h in pages:
                        continue
                    if url in owner_set[h]:
                        missed[h].append(url)
                    still.append(h)
                remaining_hashes = still
        for url, batch in repairs.items():
            self._push_repairs(url, batch)
        return found

    def _repair(self, pages, missed_owners: List[str]) -> None:
        for url in missed_owners:
            self._push_repairs(url, pages)

    def _push_repairs(self, url: str, pages) -> None:
        """Re-push blocks an owner was shown to miss, inline on the read
        path (bounded by what that read just saw missing)."""
        if not pages or not self._admits(url):
            return
        ok = self._clients[url].put_blocks(pages, timeout=self.timeout)
        self._record(url, ok)
        if ok:
            self.counters["read_repairs"] += len(pages)

    # -- manifests (to the request id's owners) ---------------------------

    def post_manifest(self, request_id: str, hashes: Sequence[int],
                      complete: bool = False,
                      total_blocks: Optional[int] = None,
                      timeout: Optional[float] = None) -> bool:
        ok_any = False
        for url in self.owners(request_id):
            ok = self._clients[url].post_manifest(
                request_id, hashes, complete=complete,
                total_blocks=total_blocks, timeout=timeout)
            self._record(url, ok)
            ok_any = ok_any or ok
        return ok_any

    def get_manifest(self, request_id: str, wait_s: float = 0.0,
                     have: int = -1,
                     timeout: Optional[float] = None) -> Optional[dict]:
        """The first healthy owner carries the long poll; without
        progress the other owners get a quick look, and the richest view
        wins (a replica that missed appends cannot stall the consumer)."""
        best: Optional[dict] = None
        poll = wait_s
        for url in self.owners(request_id):
            if not self._admits(url):
                continue
            view = self._clients[url].get_manifest(
                request_id, wait_s=poll, have=have, timeout=timeout)
            poll = 0.0
            if view is None:
                continue
            if (best is None
                    or (view.get("complete") and not best.get("complete"))
                    or len(view.get("hashes") or [])
                    > len(best.get("hashes") or [])):
                best = view
            if best.get("complete") or len(best.get("hashes") or []) > have:
                return best
        return best
