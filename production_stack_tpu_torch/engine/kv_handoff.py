"""Streamed disaggregated-prefill KV handoff.

A copy of the JAX package's ``engine/kv_handoff.py``, keyed by the
router's request id:

- :class:`KVHandoffPublisher` (producer engine): as each prefill chunk's
  pages commit, the step thread queues their device-to-host copies (the
  spill path's ``download_page``) and hands them over with the CUDA event
  recorded after the copies; a worker thread waits on that event, ships
  the pages in batched ``POST /blocks`` round trips and appends their
  hashes to the request's manifest. When the prefill completes, a
  completion marker with the prompt's full-block count lands on the
  manifest. The step thread never waits on the network or the copies.
- :class:`KVHandoffPrefetcher` (decode engine): long-polls the manifest
  while the prefill still runs, batch-fetches each newly published block
  into the tiered allocator's host pool and returns once the completion
  marker is seen and every block landed; admission then finds the whole
  prompt a host-tier prefix hit. A manifest timeout or a dead kvserver
  degrades to plain admission (the engine recomputes the prefill: the
  fused path), counted in ``fallbacks``, never an error.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional

from ..logging_utils import init_logger
from .cache_tiering import wait_landed

logger = init_logger(__name__)

# One publish batch a manifest append: the decode side sees progress at
# chunk granularity.
PUBLISH_BATCH_BLOCKS = 32
# Bound on queued publish entries (chunk batches and completion markers):
# a slow kvserver must not let downloaded pages pile up in host memory. An
# overflowing transfer is marked failed (the decode side falls back).
PUBLISH_QUEUE_CAP = 1024


class KVHandoffPublisher:
    """Streams a disaggregated prefill's KV pages to the remote store.

    ``publish`` and ``complete`` run on the engine's step thread (cheap:
    queued copies and a deque append); all HTTP runs on the worker
    thread. A failure marks the request failed: its manifest never
    completes and the decode side times out into its fused fallback."""

    def __init__(self, remote) -> None:
        self.remote = remote
        self._queue: "collections.deque[tuple]" = collections.deque()
        self._event = threading.Event()
        self._stop = threading.Event()
        self._failed: set = set()
        self._lock = threading.Lock()
        self.published_blocks = 0
        self.publish_failures = 0
        self.transfer_seconds = 0.0
        self._thread = threading.Thread(target=self._worker,
                                        name="kv-handoff-publish", daemon=True)
        self._thread.start()

    def _overloaded(self, request_id: str) -> bool:
        if len(self._queue) < PUBLISH_QUEUE_CAP:
            return False
        # The worker cannot keep up: shed THIS transfer rather than buffer
        # host copies without bound.
        self._mark_failed(request_id)
        return True

    def publish(self, request_id: str, pages: List[tuple],
                landed=None) -> None:
        """Queue one prefill chunk's freshly committed ``(hash, k, v)``
        pages; ``landed`` is the CUDA event after their copies (None on
        the CPU)."""
        if not pages or self._overloaded(request_id):
            return
        self._queue.append(("pages", request_id, (pages, landed)))
        self._event.set()

    def complete(self, request_id: str, total_blocks: int) -> None:
        """The prefill finished: the completion marker, after every page
        batch already queued."""
        if self._overloaded(request_id):
            return
        self._queue.append(("complete", request_id, total_blocks))
        self._event.set()

    def shutdown(self) -> None:
        self._stop.set()
        self._event.set()
        self._thread.join(timeout=2.0)

    def _mark_failed(self, request_id: str) -> None:
        with self._lock:
            self._failed.add(request_id)
            if len(self._failed) > 4096:  # bounded: old ids age out
                self._failed = set(list(self._failed)[-2048:])
        self.publish_failures += 1

    def _is_failed(self, request_id: str) -> bool:
        with self._lock:
            return request_id in self._failed

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                kind, rid, payload = self._queue.popleft()
            except IndexError:
                self._event.wait(timeout=0.5)
                self._event.clear()
                continue
            if self._is_failed(rid):
                continue  # the transfer already broke: drop the rest
            t0 = time.monotonic()
            if kind == "pages":
                pages, landed = payload
                wait_landed(landed)
                ok = True
                for i in range(0, len(pages), PUBLISH_BATCH_BLOCKS):
                    if not self.remote.put_blocks(
                            pages[i:i + PUBLISH_BATCH_BLOCKS]):
                        ok = False
                        break
                if ok:
                    ok = self.remote.post_manifest(rid,
                                                   [h for h, _, _ in pages])
                if ok:
                    self.published_blocks += len(pages)
                else:
                    self._mark_failed(rid)
            elif not self.remote.post_manifest(rid, [], complete=True,
                                               total_blocks=payload):
                self._mark_failed(rid)
            self.transfer_seconds += time.monotonic() - t0


class KVHandoffPrefetcher:
    """Pulls a disaggregated prefill's published KV while the prefill
    still runs. Blocking by design (the server's handler thread runs it);
    bounded by ``timeout_s`` and the request's deadline."""

    def __init__(self, remote, host_pool, timeout_s: float = 10.0,
                 depth: int = 64) -> None:
        self.remote = remote
        self.host_pool = host_pool
        self.timeout_s = timeout_s
        # Most blocks a batched GET fetches: bounds one response's memory.
        self.depth = max(int(depth), 1)
        self.prefetched_blocks = 0
        self.fallbacks = 0

    def prefetch(self, request_id: str,
                 deadline: Optional[float] = None) -> dict:
        """Follow ``request_id``'s manifest to its completion, fetching
        published blocks into the host pool as they appear. Returns
        ``{"complete", "blocks", "total_blocks", "wall_s"}``;
        ``complete=False`` means admit anyway (the fused fallback)."""
        t0 = time.monotonic()
        expire = t0 + self.timeout_s
        if deadline is not None:
            expire = min(expire, deadline)
        have = fetched = 0
        complete = False
        total: Optional[int] = None
        while True:
            remaining = expire - time.monotonic()
            if remaining <= 0:
                break
            view = self.remote.get_manifest(
                request_id, wait_s=min(remaining, 1.0), have=have,
                timeout=min(remaining + 2.0, self.timeout_s))
            if view is None:
                # Not published yet, or the kvserver died: a short pause,
                # then again until the window ends.
                time.sleep(min(0.02, max(remaining, 0.0)))
                continue
            hashes = view.get("hashes") or []
            new = hashes[have:]
            for i in range(0, len(new), self.depth):
                pages = self.remote.get_blocks(
                    new[i:i + self.depth],
                    timeout=max(expire - time.monotonic(), 0.001),
                    source="prefetch")
                for h, (k, v) in pages.items():
                    self.host_pool.put(h, k, v)
                fetched += len(pages)
            have = len(hashes)
            if view.get("complete"):
                total = view.get("total_blocks")
                complete = total is None or have >= int(total)
                if complete:
                    break
        self.prefetched_blocks += fetched
        if not complete:
            self.fallbacks += 1
        return {"complete": complete, "blocks": fetched,
                "total_blocks": total, "wall_s": time.monotonic() - t0}
