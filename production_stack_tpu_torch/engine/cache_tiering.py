"""KV tiering: device memory -> host DRAM -> remote store.

A copy of the JAX package's ``engine/cache_tiering.py``:

- :class:`HostKVPool`: an LRU pool of KV pages in host memory, keyed by
  the same prefix-committing block hashes the device allocator uses.
  Pages are allocated one per ``put`` (a spilled page's pinned copy, or a
  page read from the remote store), never a pool's worth upfront.
- :class:`RemoteKVClient`: the kvserver's HTTP client on ``http.client``
  (``kvserver/server.py``), with per-call deadlines, one bounded jittered
  GET retry, BLAKE2b-128 digests checked on every read (a corrupt copy is
  quarantined on its server and reads as a miss), batched ``POST
  /blocks`` and ``GET /blocks?hashes=``, and transfer manifests.
- :class:`TieredAllocator`: a :class:`BlockAllocator` whose evictions
  spill down-tier and whose ``match_prefix`` and ``acquire_resident``
  fault pages back up (a host or remote hit: take a device page, upload,
  commit). The scheduler is tier-oblivious.

The page serde is the JAX package's byte for byte: the ``PSTKV2`` magic,
a 4-byte header length, the JSON header ``{"dtype", "shape"}`` (the
ml_dtypes names ``bfloat16``, ``float8_e4m3fn``, ``float32``; the shape
``[L, bs, KH, hd]``), then the raw K bytes and the raw V bytes.

On the GPU a spill's ``download_page`` only queues its copies (on the
step stream, behind whatever was queued before it, into pinned memory),
and the allocator never waits on the host inside ``allocate()``: the
evicted page is reusable, so nothing writes it before a later step, which
is queued after the copies. The allocator records a CUDA event after the
copies; every host reader of those bytes (the push worker's serde here,
the handoff publisher) waits on that event, never on the whole device. A
fault-up ``upload_page`` is queued on the same stream and needs no wait.

A spill's host page is pinned by PyTorch's caching host allocator: fresh
while the host pool fills (milliseconds a 2 MiB tensor, two a page, on
the step thread), and from its cache of freed pinned blocks once the
pool's LRU frees pages (microseconds).
"""

from __future__ import annotations

import collections
import http.client
import json
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlencode, urlsplit

import numpy as np
import torch

from ..kvcache.hashing import block_hashes
from ..logging_utils import init_logger
from .kv_manager import BlockAllocator, NoFreeBlocksError

logger = init_logger(__name__)

# Bounded retry for idempotent GETs: one extra attempt with a jittered
# pause, still under the caller's per-call deadline, so a transient
# kvserver blip does not force a whole-prompt recompute. Puts stay single
# shot (the spill and publish paths are best effort).
GET_RETRY_ATTEMPTS = 2
_RETRY_BACKOFF_S = (0.02, 0.08)

# The sources a digest failure is counted under
# (pst_kv_integrity_failures_total{source}).
INTEGRITY_SOURCES = ("prefetch", "match_prefix", "restore")
# What a failed call raises: refused, reset or timed-out sockets, and a
# malformed or cut HTTP answer.
_NET_ERRORS = (OSError, http.client.HTTPException)


def wait_landed(event) -> None:
    """Block this host thread until the copies ``event`` follows have
    landed (no-op for None: the CPU's copies are synchronous)."""
    if event is not None:
        event.synchronize()


def create_remote_client(url: str, replication: int = 2,
                         timeout: float = 5.0):
    """One base URL builds a :class:`RemoteKVClient`; a comma-separated
    shard list builds the replicated
    :class:`~production_stack_tpu_torch.kvserver.sharded.ShardedKVClient`
    (same call surface)."""
    urls = [u.strip() for u in (url or "").split(",") if u.strip()]
    if not urls:
        return None
    if len(urls) == 1:
        return RemoteKVClient(urls[0], timeout=timeout)
    from ..kvserver.sharded import ShardedKVClient

    return ShardedKVClient(urls, replication=replication, timeout=timeout)


class HostKVPool:
    """LRU pool of KV pages in host memory, keyed by block hash."""

    def __init__(self, max_blocks: int):
        self.max_blocks = max_blocks
        self._pages: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._pages)

    def put(self, h: int, k, v) -> None:
        with self._lock:
            if h in self._pages:
                self._pages.move_to_end(h)
                return
            while len(self._pages) >= self.max_blocks:
                _, (ek, ev) = self._pages.popitem(last=False)
                self.bytes_used -= ek.nbytes + ev.nbytes
            self._pages[h] = (k, v)
            self.bytes_used += k.nbytes + v.nbytes

    def get(self, h: int) -> Optional[tuple]:
        with self._lock:
            item = self._pages.get(h)
            if item is not None:
                self._pages.move_to_end(h)
            return item

    def contains(self, h: int) -> bool:
        with self._lock:
            return h in self._pages


# v2: the per-page host layout [L, bs, KH, hd] (the JAX package's magic).
_MAGIC = b"PSTKV2\x00\x00"


def _page_bytes(t) -> Tuple[str, list, bytes]:
    """(dtype name, shape, raw bytes) of a host page: a torch tensor
    (bf16 and e4m3 through a byte view) or a numpy array."""
    if isinstance(t, torch.Tensor):
        raw = t.detach().contiguous().view(-1).view(torch.uint8).numpy()
        return str(t.dtype).replace("torch.", ""), list(t.shape), raw.tobytes()
    return str(t.dtype), list(t.shape), np.ascontiguousarray(t).tobytes()


def _serialize_page(k, v) -> bytes:
    """The self-describing page serde: header (dtype, shape), then raw K
    and V bytes."""
    dtype, shape, kb = _page_bytes(k)
    header = json.dumps({"dtype": dtype, "shape": shape}).encode()
    return (_MAGIC + len(header).to_bytes(4, "little") + header + kb
            + _page_bytes(v)[2])


def _deserialize_page(buf: bytes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pages of :func:`_serialize_page` as host tensors of the
    header's type (``torch.bfloat16``, ``torch.float8_e4m3fn``, ...)."""
    if buf[:8] != _MAGIC:
        raise ValueError("bad KV page magic")
    hlen = int.from_bytes(buf[8:12], "little")
    header = json.loads(buf[12:12 + hlen].decode())
    dtype = getattr(torch, header["dtype"])
    shape = tuple(header["shape"])
    n = torch.empty((), dtype=dtype).element_size() * int(np.prod(shape))
    body = memoryview(buf)[12 + hlen:]
    if len(body) != 2 * n:
        raise ValueError(f"KV page body of {len(body)} bytes, want {2 * n}")

    def one(part) -> torch.Tensor:
        return torch.frombuffer(bytearray(part), dtype=torch.uint8).view(
            dtype).reshape(shape)

    return one(body[:n]), one(body[n:])


class RemoteKVClient:
    """Blocking HTTP client for one kvserver, safe to call from any
    thread (one connection a call).

    Every call is bounded by ``timeout`` (connect and each read: a hung
    kvserver surfaces as a tier miss, never hangs the caller), and a
    caller on a request deadline can tighten it per call."""

    # Byte budget of one batched POST /blocks: under the kvserver's
    # 256 MiB request cap even for large pages.
    BATCH_PUT_MAX_BYTES = 64 << 20

    def __init__(self, base_url: str, timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        parts = urlsplit(self.base_url)
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self._prefix = parts.path.rstrip("/")
        self.timeout = timeout
        # Audit counters (engine stats: kv_integrity_failures_total,
        # kv_remote_retries_total); read_repairs stays 0 here, repair
        # needs replicas (the sharded client's).
        self.counters: Dict[str, int] = {
            "integrity_failures": 0, "retries": 0, "read_repairs": 0}
        self.integrity_by_source: Dict[str, int] = dict.fromkeys(
            INTEGRITY_SOURCES, 0)

    # -- plumbing ---------------------------------------------------------

    def _request(self, method: str, path: str, timeout: float,
                 body: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> Tuple[int, dict, bytes]:
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=timeout)
        try:
            conn.request(method, self._prefix + path, body=body,
                         headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def _json(self, method: str, path: str, payload, timeout: float):
        return self._request(method, path, timeout,
                             json.dumps(payload).encode(),
                             {"Content-Type": "application/json"})

    def _effective_timeout(self, timeout: Optional[float]) -> float:
        if timeout is None:
            return self.timeout
        return max(min(self.timeout, timeout), 0.001)

    def _retry_pause(self, deadline: float) -> bool:
        """Jittered backoff before a GET's second attempt; False when the
        remaining per-call budget cannot cover it."""
        backoff = random.uniform(*_RETRY_BACKOFF_S)
        if deadline - time.monotonic() <= backoff:
            return False
        self.counters["retries"] += 1
        time.sleep(backoff)
        return True

    def _quarantine(self, hashes: Sequence[int]) -> None:
        """Tell the server to drop copies a digest check proved rotten
        (best effort: the store also ages them out)."""
        try:
            self._json("POST", "/admin/quarantine",
                       {"hashes": [int(h) for h in hashes]},
                       min(self.timeout, 2.0))
        except _NET_ERRORS as e:
            logger.debug("quarantine report failed: %s", e)

    def _note_corrupt(self, hashes: Sequence[int], source: str) -> None:
        self.counters["integrity_failures"] += len(hashes)
        self.integrity_by_source[source] = (
            self.integrity_by_source.get(source, 0) + len(hashes))
        logger.warning(
            "remote KV digest mismatch on %s (%d block(s), source=%s): "
            "quarantining replica copies", self.base_url, len(hashes), source)
        self._quarantine(hashes)

    # -- single pages -----------------------------------------------------

    def put(self, h: int, k, v, timeout: Optional[float] = None) -> bool:
        try:
            status, _, _ = self._request(
                "PUT", f"/blocks/{h}", self._effective_timeout(timeout),
                _serialize_page(k, v),
                {"Content-Type": "application/octet-stream"})
            return status == 200
        except _NET_ERRORS as e:  # the remote tier is best effort
            logger.debug("remote KV put failed: %s", e)
            return False

    def get(self, h: int, timeout: Optional[float] = None,
            source: str = "restore") -> Optional[tuple]:
        return self.get_ex(h, timeout=timeout, source=source)[0]

    def get_ex(self, h: int, timeout: Optional[float] = None,
               source: str = "restore") -> Tuple[Optional[tuple], str]:
        """``(page, status)``, status ``ok`` | ``miss`` | ``corrupt`` |
        ``error``: a replicated wrapper tells a healthy miss (try the
        next owner) from a dead shard (its breaker). The served digest
        (``X-PST-Digest``) is checked before the page is read; a mismatch
        quarantines this copy."""
        from ..kvserver.server import block_digest

        deadline = time.monotonic() + self._effective_timeout(timeout)
        status = "error"
        for _ in range(GET_RETRY_ATTEMPTS):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                code, headers, data = self._request(
                    "GET", f"/blocks/{h}", remaining)
            except _NET_ERRORS as e:
                logger.debug("remote KV get failed: %s", e)
                if not self._retry_pause(deadline):
                    break
                continue
            if code == 404:
                return None, "miss"
            if code != 200:
                if not self._retry_pause(deadline):
                    break
                continue
            digest_hex = headers.get("X-PST-Digest")
            if digest_hex:
                try:
                    expected = bytes.fromhex(digest_hex)
                except ValueError:
                    expected = b""
                if block_digest(data) != expected:
                    self._note_corrupt([h], source)
                    return None, "corrupt"
            return _deserialize_page(data), "ok"
        return None, status

    # -- batches (one round trip for N pages) -----------------------------

    def put_blocks(self, pages: Sequence[tuple],
                   timeout: Optional[float] = None) -> bool:
        """Ship ``(hash, k, v)`` pages in batched ``POST /blocks`` round
        trips, each bounded by bytes (a count bound could pass the
        server's request cap for large pages)."""
        if not pages:
            return True
        try:
            batch: list = []
            batch_bytes = 0
            for h, k, v in pages:
                data = _serialize_page(k, v)
                if batch and batch_bytes + len(data) > self.BATCH_PUT_MAX_BYTES:
                    if not self._post_block_batch(batch, timeout):
                        return False
                    batch, batch_bytes = [], 0
                batch.append((h, data))
                batch_bytes += len(data)
            return self._post_block_batch(batch, timeout)
        except _NET_ERRORS as e:
            logger.debug("remote KV batched put failed: %s", e)
            return False

    def _post_block_batch(self, batch, timeout: Optional[float]) -> bool:
        from ..kvserver.server import pack_blocks

        if not batch:
            return True
        status, _, _ = self._request(
            "POST", "/blocks", self._effective_timeout(timeout),
            pack_blocks(batch), {"Content-Type": "application/octet-stream"})
        return status == 200

    def get_blocks(self, hashes: Sequence[int],
                   timeout: Optional[float] = None,
                   source: str = "match_prefix") -> Dict[int, tuple]:
        """Up to N pages in ONE ``GET /blocks?hashes=`` round trip; absent
        hashes are missing from the result."""
        return self.get_blocks_ex(hashes, timeout=timeout, source=source)[0]

    def get_blocks_ex(self, hashes: Sequence[int],
                      timeout: Optional[float] = None,
                      source: str = "match_prefix"
                      ) -> Tuple[Dict[int, tuple], str]:
        """``(pages, status)``: ``ok`` (the round trip completed; absent
        hashes are real misses) or ``error``. Every frame is digest
        checked; corrupt ones are dropped, counted and quarantined, so to
        the caller they are misses, never pages."""
        if not hashes:
            return {}, "ok"
        from ..kvserver.server import unpack_blocks

        query = urlencode({"hashes": ",".join(str(int(h)) for h in hashes)})
        deadline = time.monotonic() + self._effective_timeout(timeout)
        for _ in range(GET_RETRY_ATTEMPTS):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                code, _, data = self._request("GET", f"/blocks?{query}",
                                              remaining)
                if code != 200:
                    raise http.client.HTTPException(f"status {code}")
                corrupt: List[int] = []
                pages = {h: _deserialize_page(payload)
                         for h, payload in unpack_blocks(data, corrupt)}
                if corrupt:
                    self._note_corrupt(corrupt, source)
                return pages, "ok"
            except (*_NET_ERRORS, ValueError) as e:
                logger.debug("remote KV batched get failed: %s", e)
                if not self._retry_pause(deadline):
                    break
        return {}, "error"

    # -- disaggregated-transfer manifests ---------------------------------

    def post_manifest(self, request_id: str, hashes: Sequence[int],
                      complete: bool = False,
                      total_blocks: Optional[int] = None,
                      timeout: Optional[float] = None) -> bool:
        try:
            status, _, _ = self._json(
                "POST", f"/manifests/{request_id}",
                {"hashes": [int(h) for h in hashes],
                 "complete": bool(complete), "total_blocks": total_blocks},
                self._effective_timeout(timeout))
            return status == 200
        except _NET_ERRORS as e:
            logger.debug("manifest post failed: %s", e)
            return False

    def get_manifest(self, request_id: str, wait_s: float = 0.0,
                     have: int = -1,
                     timeout: Optional[float] = None) -> Optional[dict]:
        """The manifest's view (None: unknown request id or server down).
        ``wait_s`` long-polls on the server for progress past ``have``;
        the read timeout covers the poll and some slack."""
        try:
            query = urlencode({"wait_s": wait_s, "have": have})
            status, _, data = self._request(
                "GET", f"/manifests/{request_id}?{query}",
                max(self._effective_timeout(timeout), wait_s + 2.0))
            if status != 200:
                return None
            return json.loads(data)
        except (*_NET_ERRORS, ValueError) as e:
            logger.debug("manifest get failed: %s", e)
            return None


def _no_stage(stage: str, seconds: float) -> None:
    pass


class TieredAllocator(BlockAllocator):
    """Device allocator with spill-down and fault-up across the host and
    remote tiers.

    ``page_io`` is the runner (``download_page``, ``upload_page`` and
    ``page_event``). ``observe_stage(stage, seconds)`` receives the
    ``kv_fetch_host`` and ``kv_fetch_remote`` stage durations.
    ``host_pool``: an existing pool to keep (in place of a new one of
    ``host_blocks``)."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        page_io,
        host_blocks: int = 0,
        remote=None,
        enable_prefix_caching: bool = True,
        observe_stage: Callable[[str, float], None] = _no_stage,
        host_pool: Optional[HostKVPool] = None,
    ):
        super().__init__(num_blocks, block_size,
                         enable_prefix_caching=enable_prefix_caching,
                         on_evict=self._spill)
        self.page_io = page_io
        # An existing pool carries a warm tier over a rebuild.
        self.host_pool = host_pool if host_pool is not None else (
            HostKVPool(host_blocks) if host_blocks > 0 else None)
        self.remote = remote
        self.observe_stage = observe_stage
        # Tier KPIs (engine stats: kv_offload_*).
        self.host_hit_blocks = 0
        self.remote_hit_blocks = 0
        self.spilled_blocks = 0
        self.remote_push_drops = 0
        # Remote pushes ride a bounded queue and a worker thread: eviction
        # must never wait on the network. Entries are (hash, k, v, event).
        self._push_queue: "collections.deque[tuple]" = collections.deque(
            maxlen=256)
        self._push_event = threading.Event()
        self._push_stop = threading.Event()
        self._push_thread: Optional[threading.Thread] = None
        if remote is not None:
            self._push_thread = threading.Thread(
                target=self._push_worker, name="kv-remote-push", daemon=True)
            self._push_thread.start()

    # -- spill down -------------------------------------------------------

    def _spill(self, blk: int, h: int) -> None:
        if self.host_pool is None and self.remote is None:
            return
        k, v = self.page_io.download_page(blk)
        if self.host_pool is not None:
            self.host_pool.put(h, k, v)
        if self.remote is not None:
            if len(self._push_queue) == self._push_queue.maxlen:
                self.remote_push_drops += 1  # the deque drops the oldest
            self._push_queue.append((h, k, v, self.page_io.page_event()))
            self._push_event.set()
        self.spilled_blocks += 1

    def _push_worker(self) -> None:
        while not self._push_stop.is_set():
            batch = []
            try:
                # Whatever spilled since the last pass, in one batched
                # POST (at most 64 pages).
                while len(batch) < 64:
                    batch.append(self._push_queue.popleft())
            except IndexError:
                pass
            if not batch:
                self._push_event.wait(timeout=1.0)
                self._push_event.clear()
                continue
            # The pages' copies were only queued: wait for them to land
            # before the serde reads the bytes.
            for event in {id(e): e for *_, e in batch}.values():
                wait_landed(event)
            self.remote.put_blocks([(h, k, v) for h, k, v, _ in batch])

    def shutdown(self) -> None:
        """Stop the push worker (a level-2 sleep rebuilds the allocator;
        without this every sleep would leak a thread)."""
        self._push_stop.set()
        self._push_event.set()
        if self._push_thread is not None:
            self._push_thread.join(timeout=2.0)
            self._push_thread = None

    # -- fault up ---------------------------------------------------------

    def _host_get(self, h: int) -> Optional[tuple]:
        if self.host_pool is None:
            return None
        t0 = time.monotonic()
        page = self.host_pool.get(h)
        if page is not None:
            self.host_hit_blocks += 1
            self.observe_stage("kv_fetch_host", time.monotonic() - t0)
        return page

    def _fetch_lower_tier(self, h: int,
                          deadline: Optional[float] = None
                          ) -> Optional[tuple]:
        """The host pool always; the remote store within the remaining
        budget of ``deadline`` (monotonic), and not at all once it is
        spent: recomputing beats blocking an expired request."""
        page = self._host_get(h)
        if page is not None:
            return page
        if self.remote is None:
            return None
        remaining: Optional[float] = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
        t0 = time.monotonic()
        page = self.remote.get(h, timeout=remaining)
        # A hit or a miss, a round trip happened: both are its stage.
        self.observe_stage("kv_fetch_remote", time.monotonic() - t0)
        if page is not None:
            self.remote_hit_blocks += 1
            if self.host_pool is not None:  # promote to the warmer tier
                self.host_pool.put(h, *page)
        return page

    def acquire_resident(self, h: int) -> Optional[int]:
        """A device hit, else fault the page up from host or remote."""
        blk = self.acquire_cached(h)
        if blk is not None:
            return blk
        page = self._fetch_lower_tier(h)
        if page is None:
            return None
        try:
            blk = self.allocate()
        except NoFreeBlocksError:
            return None
        self.page_io.upload_page(blk, *page)
        return self.commit(blk, h)

    def _remote_batch_fetch(self, hashes: Sequence[int],
                            deadline: Optional[float]) -> Dict[int, tuple]:
        """One batched ``GET /blocks?hashes=`` for every hash neither on
        the device nor in the host pool."""
        if self.remote is None:
            return {}
        wanted = [h for h in hashes
                  if self._block_of_hash.get(h) is None
                  and (self.host_pool is None
                       or not self.host_pool.contains(h))]
        if not wanted:
            return {}
        remaining: Optional[float] = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {}
        t0 = time.monotonic()
        pages = self.remote.get_blocks(wanted, timeout=remaining)
        self.observe_stage("kv_fetch_remote", time.monotonic() - t0)
        self.remote_hit_blocks += len(pages)
        if self.host_pool is not None:  # promote to the warmer tier
            for h, (k, v) in pages.items():
                self.host_pool.put(h, k, v)
        return pages

    def match_prefix(self, token_ids: Sequence[int], salt: int = 0,
                     deadline: Optional[float] = None
                     ) -> Tuple[List[int], List[int]]:
        self.query_tokens += len(token_ids)
        if not self.enable_prefix_caching:
            return [], []
        hashes = block_hashes(token_ids, self.block_size, parent=salt)
        fetched: Dict[int, tuple] = {}
        fetch_attempted = False
        matched: List[int] = []
        matched_hashes: List[int] = []
        for i, h in enumerate(hashes):
            blk = self.acquire_cached(h)
            if blk is None:
                page = fetched.pop(h, None)
                if page is None:
                    page = self._host_get(h)
                if page is None and self.remote is not None \
                        and not fetch_attempted:
                    # The first miss below the host tier fetches the whole
                    # remaining suffix in ONE round trip; a hash absent
                    # from that reply is a real remote miss.
                    fetch_attempted = True
                    fetched = self._remote_batch_fetch(hashes[i:], deadline)
                    page = fetched.pop(h, None)
                if page is None:
                    break
                try:
                    blk = self.allocate()
                except NoFreeBlocksError:
                    break
                self.page_io.upload_page(blk, *page)
                blk = self.commit(blk, h)
            matched.append(blk)
            matched_hashes.append(h)
        self.hit_tokens += len(matched) * self.block_size
        return matched, matched_hashes
