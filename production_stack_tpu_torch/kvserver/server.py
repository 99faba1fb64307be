"""Remote KV block store (the LMCache-server analogue) on ``http.server``.

The JAX package's ``kvserver/server.py``, route for route and byte for
byte, in the standard library: the page serde of
:mod:`production_stack_tpu_torch.engine.cache_tiering` over HTTP, with a
byte-capacity LRU.

Endpoints:
  PUT  /blocks/{hash}     store one page (raw serde body; an optional
                          ``X-PST-Digest`` header is checked at ingest)
  GET  /blocks/{hash}     fetch one page (404 if absent; the stored digest
                          rides back in ``X-PST-Digest``)
  POST /blocks            store N pages in ONE round trip (framed body)
  GET  /blocks?hashes=    fetch N pages in ONE round trip (framed body;
                          absent hashes are left out of the reply)
  POST /manifests/{rid}   append to a disaggregated transfer's manifest
  GET  /manifests/{rid}   read a manifest (``?wait_s=`` long-polls for
                          progress past ``?have=`` blocks or completion)
  POST /contains          presence probe for N hashes
  POST /admin/quarantine  drop named blocks (a reader found a digest
                          mismatch on this copy)
  POST /admin/fail        fault injection: ``corrupt`` | ``slow`` |
                          ``drop_manifest``
  POST /admin/heal        clear injected faults
  GET  /stats             occupancy, bytes, hits and integrity counters
  GET  /health

The framed batch body is ``repeat([8B hash LE][4B length LE][16B blake2b
digest][payload])``: the hash is the engine's block hash, the payload the
page serde, the digest BLAKE2b-128 over the payload. The producer
computes the digest when it packs, the store keeps it and serves it
verbatim, so a copy that rotted here is caught by its reader. A batch's
digests run on a shared pool of threads (``block_digests``): BLAKE2b
releases the GIL over large buffers, and a page handed from producer to
consumer is digested three times (packed, stored, read).

The peer ring: with ``--peers`` (every shard's base URL, this one
included, as the clients address them) and ``--self-url`` the shard
answers ``GET /ring``, and with ``--sweep-interval-s`` above 0 a daemon
thread runs the anti-entropy sweep: every interval it samples its most
recently used blocks (``SWEEP_SAMPLE_BLOCKS``), finds each block's owners
on the consistent-hash ring (``--replication``), probes each co-owner
with ``POST /contains`` and re-pushes the missing frames with their
stored digests (``POST /blocks``). A shard restarted empty is backfilled
by its peers within a sweep interval; a peer that fails is skipped until
the next sweep. ``/stats`` counts ``anti_entropy_sweeps`` and
``anti_entropy_pushes``.

    python -m production_stack_tpu_torch.kvserver.server --port 8100 \\
        [--max-bytes 8589934592] [--self-url http://shard-0:8100 \\
        --peers http://shard-0:8100,http://shard-1:8100 --replication 2 \\
        --sweep-interval-s 30]
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import http.client
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlsplit

from ..hashring import ConsistentHashRing
from ..logging_utils import init_logger

logger = init_logger(__name__)

# Manifests older than this are dropped (a crashed decode leg must not pin
# its prefill's manifest for ever).
MANIFEST_TTL_S = 10 * 60.0
MANIFEST_CAP = 4096

# BLAKE2b digest width carried a frame (integrity, not addressing).
DIGEST_SIZE = 16
_FRAME_HEADER = 8 + 4 + DIGEST_SIZE
# The JAX kvserver's request size cap (aiohttp's client_max_size).
MAX_REQUEST_BYTES = 256 << 20
# Blocks one anti-entropy sweep samples, most recently used first.
SWEEP_SAMPLE_BLOCKS = 2048
# Seconds a sweep waits on one peer request.
SWEEP_TIMEOUT_S = 10.0


def block_digest(data: bytes) -> bytes:
    """BLAKE2b-128 over the page serde bytes: computed where the bytes
    are born, checked wherever they are read."""
    return hashlib.blake2b(data, digest_size=DIGEST_SIZE).digest()


# Below this many bytes a batch is digested on the calling thread.
_POOLED_DIGEST_BYTES = 1 << 20
_digest_pool: Optional[ThreadPoolExecutor] = None
_digest_pool_lock = threading.Lock()


def block_digests(payloads: Sequence[bytes]) -> List[bytes]:
    """:func:`block_digest` of each payload, in order; a batch of 1 MiB or
    more on a shared pool of up to 8 threads."""
    global _digest_pool
    if len(payloads) < 2 or sum(map(len, payloads)) < _POOLED_DIGEST_BYTES:
        return [block_digest(d) for d in payloads]
    with _digest_pool_lock:
        if _digest_pool is None:
            _digest_pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="kv-digest")
    return list(_digest_pool.map(block_digest, payloads))


def pack_blocks(pages: Sequence[tuple]) -> bytes:
    """Frame N pages into one batch body. Items are ``(hash, payload)``
    (the digest is computed here) or ``(hash, payload, digest)`` to ship
    a stored frame with its producer's digest."""
    fresh = iter(block_digests([page[1] for page in pages
                                if len(page) == 2]))
    parts = []
    for page in pages:
        if len(page) == 3:
            h, data, digest = page
        else:
            h, data = page
            digest = next(fresh)
        parts.append(int(h).to_bytes(8, "little", signed=False))
        parts.append(len(data).to_bytes(4, "little"))
        parts.append(digest)
        parts.append(data)
    return b"".join(parts)


def unpack_blocks_ex(buf: bytes, corrupt: Optional[List[int]] = None
                     ) -> List[Tuple[int, bytes, bytes]]:
    """Inverse of :func:`pack_blocks`, digest-checked. A torn frame raises
    ValueError; so does a digest mismatch unless ``corrupt`` is given, in
    which case the bad block's hash is appended there and the block
    skipped (a corrupt page never reaches decode)."""
    frames: List[Tuple[int, bytes, bytes]] = []
    view = memoryview(buf)
    off, n = 0, len(buf)
    while off < n:
        if off + _FRAME_HEADER > n:
            raise ValueError("torn batch frame header")
        h = int.from_bytes(view[off:off + 8], "little")
        ln = int.from_bytes(view[off + 8:off + 12], "little")
        digest = bytes(view[off + 12:off + _FRAME_HEADER])
        off += _FRAME_HEADER
        if off + ln > n:
            raise ValueError("torn batch frame payload")
        frames.append((h, bytes(view[off:off + ln]), digest))
        off += ln
    out: List[Tuple[int, bytes, bytes]] = []
    for frame, got in zip(frames, block_digests([f[1] for f in frames])):
        h, _, digest = frame
        if got != digest:
            if corrupt is None:
                raise ValueError(f"digest mismatch for block {h}")
            corrupt.append(h)
            continue
        out.append(frame)
    return out


def unpack_blocks(buf: bytes, corrupt: Optional[List[int]] = None
                  ) -> List[Tuple[int, bytes]]:
    """:func:`unpack_blocks_ex` without the digest column."""
    return [(h, data) for h, data, _ in unpack_blocks_ex(buf, corrupt)]


class BlockStore:
    """Byte-capacity LRU of framed pages (not locked: the server holds
    its lock around every call)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._blocks: "collections.OrderedDict[int, Tuple[bytes, bytes]]" = (
            collections.OrderedDict())
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Transfer audit: round trips apart from pages moved.
        self.put_calls = 0
        self.blocks_put = 0
        self.get_calls = 0
        # Integrity audit: ingest digest rejects, reader quarantines.
        self.integrity_rejects = 0
        self.quarantined = 0

    def put(self, h: int, data: bytes, digest: Optional[bytes] = None) -> None:
        self.blocks_put += 1
        if len(data) > self.max_bytes:
            return  # unstorable; never evict the fleet's cache trying
        if digest is None:
            digest = block_digest(data)
        if h in self._blocks:
            self.bytes_used -= len(self._blocks.pop(h)[0])
        while self._blocks and self.bytes_used + len(data) > self.max_bytes:
            _, (old, _d) = self._blocks.popitem(last=False)
            self.bytes_used -= len(old)
            self.evictions += 1
        self._blocks[h] = (data, digest)
        self.bytes_used += len(data)

    def get(self, h: int) -> Optional[bytes]:
        item = self.get_with_digest(h)
        return None if item is None else item[0]

    def get_with_digest(self, h: int) -> Optional[Tuple[bytes, bytes]]:
        item = self._blocks.get(h)
        if item is None:
            self.misses += 1
            return None
        self._blocks.move_to_end(h)
        self.hits += 1
        return item

    def contains(self, h: int) -> bool:
        return h in self._blocks

    def sample_hashes(self, limit: int) -> List[int]:
        """Up to ``limit`` block hashes, most recently used first (the
        anti-entropy sweep's working set)."""
        return list(reversed(self._blocks.keys()))[:limit]

    def quarantine(self, hashes: Sequence[int]) -> int:
        """Drop named blocks; returns how many were present."""
        dropped = 0
        for h in hashes:
            item = self._blocks.pop(int(h), None)
            if item is not None:
                self.bytes_used -= len(item[0])
                dropped += 1
        self.quarantined += dropped
        return dropped


class FaultState:
    """Injected faults (POST /admin/fail). ``corrupt`` flips a byte in
    each served payload (the stored digest still rides along: a rotted
    copy); ``slow`` delays every block and manifest handler by
    ``delay_s``; ``drop_manifest`` acknowledges manifest appends and
    discards them (the consumer's long poll starves into the fused
    fallback). ``count`` bounds the operations affected (<= 0: until
    /admin/heal)."""

    def __init__(self) -> None:
        self.mode: Optional[str] = None
        self.remaining = 0
        self.delay_s = 0.25
        self.injected = 0

    def arm(self, mode: str, count: int, delay_s: float) -> None:
        self.mode = mode
        self.remaining = count
        self.delay_s = delay_s

    def heal(self) -> None:
        self.mode = None
        self.remaining = 0

    def take(self, mode: str) -> bool:
        """Consume one fault of ``mode`` if armed."""
        if self.mode != mode:
            return False
        if self.remaining > 0:
            self.remaining -= 1
            if self.remaining == 0:
                self.mode = None
        self.injected += 1
        return True


def _flip_byte(data: bytes) -> bytes:
    if not data:
        return data
    i = len(data) // 2
    return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]


class ManifestStore:
    """Request-id-keyed transfer manifests; a long poll waits on one
    condition that every update notifies."""

    def __init__(self):
        self._manifests: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        self._cond = threading.Condition()

    def _prune(self, now: float) -> None:
        cutoff = now - MANIFEST_TTL_S
        for rid in [r for r, m in self._manifests.items() if m["ts"] < cutoff]:
            del self._manifests[rid]
        while len(self._manifests) > MANIFEST_CAP:
            self._manifests.popitem(last=False)

    def update(self, rid: str, hashes: List[int], complete: bool,
               total_blocks: Optional[int]) -> dict:
        with self._cond:
            now = time.time()
            self._prune(now)
            m = self._manifests.get(rid)
            if m is None:
                m = {"hashes": [], "complete": False, "total_blocks": None,
                     "ts": now}
                self._manifests[rid] = m
            seen = set(m["hashes"])
            for h in hashes:
                if h not in seen:
                    m["hashes"].append(int(h))
                    seen.add(h)
            if complete:
                m["complete"] = True
            if total_blocks is not None:
                m["total_blocks"] = int(total_blocks)
            m["ts"] = now
            # An append refreshes the eviction rank too: an actively
            # streaming transfer must not be the first one the cap drops.
            self._manifests.move_to_end(rid)
            while len(self._manifests) > MANIFEST_CAP:
                self._manifests.popitem(last=False)
            self._cond.notify_all()
            return {"blocks": len(m["hashes"]), "complete": m["complete"]}

    def _view(self, rid: str) -> Optional[dict]:
        m = self._manifests.get(rid)
        if m is None:
            return None
        return {"request_id": rid, "hashes": list(m["hashes"]),
                "complete": m["complete"], "total_blocks": m["total_blocks"]}

    def view(self, rid: str) -> Optional[dict]:
        with self._cond:
            return self._view(rid)

    def wait(self, rid: str, have: int, wait_s: float) -> Optional[dict]:
        """Long poll: the view as soon as the manifest has more than
        ``have`` blocks or is complete, else after ``wait_s``."""
        deadline = time.monotonic() + max(wait_s, 0.0)
        with self._cond:
            while True:
                m = self._manifests.get(rid)
                if m is not None and (len(m["hashes"]) > have
                                      or m["complete"]):
                    return self._view(rid)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._view(rid)
                self._cond.wait(remaining)

    def __len__(self) -> int:
        with self._cond:
            return len(self._manifests)


class KVServer(ThreadingHTTPServer):
    """One kvserver shard; ``serve_forever()`` serves it (a thread a
    connection) and starts its anti-entropy sweep when the ring is set
    (``peers``, ``self_url`` and ``sweep_interval_s`` above 0). ``store``,
    ``manifests`` and ``faults`` are its state, ``lock`` guards the store,
    the faults and the sweep's counters."""

    daemon_threads = True

    def __init__(self, address: Tuple[str, int], max_bytes: int = 8 << 30,
                 peers: Optional[Sequence[str]] = None,
                 self_url: Optional[str] = None, replication: int = 2,
                 sweep_interval_s: float = 0.0):
        self.store = BlockStore(max_bytes)
        self.manifests = ManifestStore()
        self.faults = FaultState()
        self.lock = threading.Lock()
        self.peers = [p.rstrip("/") for p in (peers or []) if p]
        self.self_url = (self_url or "").rstrip("/")
        self.replication = max(int(replication), 1)
        self.sweep_interval_s = float(sweep_interval_s)
        self.anti_entropy_sweeps = 0
        self.anti_entropy_pushes = 0
        self._sweep_stop = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        super().__init__(address, _Handler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        if (self.peers and self.self_url and self.sweep_interval_s > 0
                and self._sweeper is None):
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="kv-anti-entropy", daemon=True)
            self._sweeper.start()
        super().serve_forever(poll_interval)

    def server_close(self) -> None:
        self._sweep_stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=SWEEP_TIMEOUT_S + 1)
        super().server_close()

    def ring(self) -> dict:
        return {"peers": self.peers, "self": self.self_url,
                "replication": self.replication,
                "sweep_interval_s": self.sweep_interval_s}

    def _sweep_loop(self) -> None:
        while not self._sweep_stop.wait(self.sweep_interval_s):
            try:
                pushed = self.sweep_once()
            except Exception:  # the sweep must survive any one pass
                logger.exception("anti-entropy sweep failed")
                pushed = 0
            with self.lock:
                self.anti_entropy_pushes += pushed
                self.anti_entropy_sweeps += 1

    def sweep_once(self) -> int:
        """One anti-entropy pass: for each sampled block this shard
        co-owns, re-push its stored frame (the producer's digest) to every
        co-owner that lacks it. Returns the blocks pushed. A peer that
        fails is skipped: it is what a later sweep heals."""
        ring = ConsistentHashRing()
        ring.update(self.peers)
        with self.lock:
            sample = self.store.sample_hashes(SWEEP_SAMPLE_BLOCKS)
        by_peer = collections.defaultdict(list)
        for h in sample:
            owners = ring.get_nodes(str(h), self.replication)
            if self.self_url not in owners:
                continue  # left here by an old ring: reads still find it
            for o in owners:
                if o != self.self_url:
                    by_peer[o].append(h)
        pushed = 0
        for peer, hashes in by_peer.items():
            try:
                status, raw = _peer_call(peer, "/contains",
                                         json.dumps({"hashes": hashes}))
                if status != 200:
                    continue
                present = json.loads(raw).get("present") or []
                frames = []
                with self.lock:
                    for h, there in zip(hashes, present):
                        item = (None if there
                                else self.store.get_with_digest(h))
                        if item is not None:
                            frames.append((h, *item))
                if frames and _peer_call(peer, "/blocks",
                                         pack_blocks(frames))[0] == 200:
                    pushed += len(frames)
            except (OSError, http.client.HTTPException, ValueError) as e:
                logger.debug("anti-entropy: peer %s failed: %s", peer, e)
        return pushed

    def stats(self) -> dict:
        store = self.store
        with self.lock:
            return {
                "num_blocks": len(store._blocks),
                "bytes_used": store.bytes_used,
                "max_bytes": store.max_bytes,
                "hits": store.hits,
                "misses": store.misses,
                "evictions": store.evictions,
                "put_calls": store.put_calls,
                "blocks_put": store.blocks_put,
                "get_calls": store.get_calls,
                "manifests": len(self.manifests),
                "integrity_rejects": store.integrity_rejects,
                "quarantined": store.quarantined,
                "faults_injected": self.faults.injected,
                "anti_entropy_sweeps": self.anti_entropy_sweeps,
                "anti_entropy_pushes": self.anti_entropy_pushes,
            }


def _peer_call(base: str, path: str, body) -> Tuple[int, bytes]:
    """POST ``body`` to a peer shard, within ``SWEEP_TIMEOUT_S``."""
    parts = urlsplit(base)
    conn = http.client.HTTPConnection(parts.hostname, parts.port or 80,
                                      timeout=SWEEP_TIMEOUT_S)
    try:
        conn.request("POST", parts.path + path, body,
                     {"Content-Type": "application/json"
                      if isinstance(body, str) else
                      "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class _Handler(BaseHTTPRequestHandler):
    server: KVServer

    def log_message(self, fmt, *args):  # access logs at debug level
        logger.debug("%s %s", self.address_string(), fmt % args)

    # -- plumbing ---------------------------------------------------------

    def _send(self, status: int, body: bytes, content_type: str,
              headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, payload: dict) -> None:
        self._send(status, json.dumps(payload).encode(),
                   "application/json; charset=utf-8")

    def _read(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def _read_json(self):
        return json.loads(self._read() or b"null")

    def _maybe_slow(self) -> None:
        with self.server.lock:
            slow = self.server.faults.take("slow")
            delay = self.server.faults.delay_s
        if slow:
            time.sleep(delay)

    def _served(self, data: bytes, digest: bytes) -> Tuple[bytes, bytes]:
        """The ``corrupt`` fault on one outgoing block (caller holds the
        lock): the payload damaged, the stored digest intact."""
        if self.server.faults.take("corrupt"):
            return _flip_byte(data), digest
        return data, digest

    def _dispatch(self, method: str) -> None:
        url = urlsplit(self.path)
        self.query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        parts = url.path.strip("/").split("/")
        if int(self.headers.get("Content-Length", 0)) > MAX_REQUEST_BYTES:
            self._json(413, {"error": "request too large"})
            return
        head, arg = parts[0], "/".join(parts[1:])
        route = {
            ("PUT", "blocks"): self.put_block,
            ("POST", "blocks"): self.put_blocks,
            ("GET", "blocks"): self.get_block,
            ("POST", "manifests"): self.post_manifest,
            ("GET", "manifests"): self.get_manifest,
            ("POST", "contains"): self.contains,
            ("POST", "admin"): self.admin,
            ("GET", "ring"): self.ring,
            ("GET", "stats"): self.stats,
            ("GET", "health"): self.health,
        }.get((method, head))
        with_arg = head in ("manifests",) or (head == "blocks"
                                              and method == "PUT")
        if route is None or (with_arg and not arg) or (
                head in ("contains", "ring", "stats", "health") and arg):
            self._json(404, {"error": "not found"})
            return
        route(arg)

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_POST(self) -> None:
        self._dispatch("POST")

    def do_PUT(self) -> None:
        self._dispatch("PUT")

    # -- blocks -----------------------------------------------------------

    def put_block(self, arg: str) -> None:
        self._maybe_slow()
        try:
            h = int(arg)
        except ValueError:
            self._json(400, {"error": "hash must be an integer"})
            return
        data = self._read()
        digest: Optional[bytes] = None
        header = self.headers.get("X-PST-Digest")
        store = self.server.store
        if header:
            try:
                digest = bytes.fromhex(header)
            except ValueError:
                self._json(400, {"error": "X-PST-Digest must be hex"})
                return
            if block_digest(data) != digest:
                with self.server.lock:
                    store.put_calls += 1
                    store.integrity_rejects += 1
                self._json(400, {"error": "digest mismatch"})
                return
        with self.server.lock:
            store.put_calls += 1
            store.put(h, data, digest)
        self._json(200, {"status": "ok"})

    def put_blocks(self, arg: str) -> None:
        """N pages, one round trip; frames are digest-checked at ingest
        (a block corrupted in flight is refused, 400)."""
        if arg:
            self._json(404, {"error": "not found"})
            return
        self._maybe_slow()
        store = self.server.store
        try:
            pages = unpack_blocks_ex(self._read())
        except ValueError as e:
            with self.server.lock:
                store.put_calls += 1
                store.integrity_rejects += 1
            self._json(400, {"error": str(e)})
            return
        with self.server.lock:
            store.put_calls += 1
            for h, data, digest in pages:
                store.put(h, data, digest)
        self._json(200, {"status": "ok", "stored": len(pages)})

    def get_block(self, arg: str) -> None:
        if not arg or "hashes" in self.query:
            self.get_blocks()
            return
        self._maybe_slow()
        try:
            h = int(arg)
        except ValueError:
            self._json(400, {"error": "hash must be an integer"})
            return
        with self.server.lock:
            self.server.store.get_calls += 1
            item = self.server.store.get_with_digest(h)
            if item is not None:
                item = self._served(*item)
        if item is None:
            self._json(404, {"error": "not found"})
            return
        data, digest = item
        self._send(200, data, "application/octet-stream",
                   {"X-PST-Digest": digest.hex()})

    def get_blocks(self) -> None:
        """``?hashes=h1,h2``: a framed body of the present pages."""
        self._maybe_slow()
        try:
            hashes = [int(h) for h in self.query.get("hashes", "").split(",")
                      if h]
        except ValueError:
            self._json(400, {"error": "hashes must be integers"})
            return
        pages = []
        with self.server.lock:
            self.server.store.get_calls += 1
            for h in hashes:
                item = self.server.store.get_with_digest(h)
                if item is not None:
                    pages.append((h, *self._served(*item)))
        self._send(200, pack_blocks(pages), "application/octet-stream",
                   {"X-PST-Blocks": str(len(pages))})

    # -- manifests --------------------------------------------------------

    def post_manifest(self, rid: str) -> None:
        self._maybe_slow()
        try:
            body = self._read_json()
        except ValueError:
            self._json(400, {"error": "invalid JSON"})
            return
        if not isinstance(body, dict):
            self._json(400, {"error": "body must be an object"})
            return
        try:
            hashes = [int(h) for h in body.get("hashes") or []]
            total = body.get("total_blocks")
            total = int(total) if total is not None else None
        except (TypeError, ValueError):
            self._json(400, {"error": "hashes/total_blocks must be integers"})
            return
        with self.server.lock:
            dropped = self.server.faults.take("drop_manifest")
        if dropped:
            # Acknowledged but discarded: the producer believes the append
            # landed while the consumer's long poll starves.
            self._json(200, {"status": "ok", "blocks": 0, "complete": False})
            return
        m = self.server.manifests.update(rid, hashes,
                                         bool(body.get("complete")), total)
        self._json(200, {"status": "ok", **m})

    def get_manifest(self, rid: str) -> None:
        self._maybe_slow()
        try:
            wait_s = float(self.query.get("wait_s", 0))
            have = int(self.query.get("have", -1))
        except ValueError:
            self._json(400, {"error": "wait_s/have must be numbers"})
            return
        manifests = self.server.manifests
        if wait_s > 0:
            view = manifests.wait(rid, have, min(wait_s, 30.0))
        else:
            view = manifests.view(rid)
        if view is None:
            self._json(404, {"error": "not found"})
            return
        self._json(200, view)

    # -- probes and admin -------------------------------------------------

    def contains(self, arg: str) -> None:
        body = self._read_json() or {}
        with self.server.lock:
            present = [self.server.store.contains(int(h))
                       for h in body.get("hashes", [])]
        self._json(200, {"present": present})

    def admin(self, arg: str) -> None:
        if arg == "quarantine":
            try:
                hashes = [int(h) for h in
                          (self._read_json() or {}).get("hashes") or []]
            except (AttributeError, TypeError, ValueError):
                self._json(400, {"error": "invalid body"})
                return
            with self.server.lock:
                dropped = self.server.store.quarantine(hashes)
            logger.warning("quarantined %d/%d blocks on reader-reported "
                           "digest mismatch", dropped, len(hashes))
            self._json(200, {"status": "ok", "dropped": dropped})
        elif arg == "fail":
            try:
                body = self._read_json()
            except ValueError:
                body = None
            body = body if isinstance(body, dict) else {}
            mode = body.get("mode")
            if mode not in ("corrupt", "slow", "drop_manifest"):
                self._json(400, {"error":
                                 "mode must be corrupt|slow|drop_manifest"})
                return
            with self.server.lock:
                self.server.faults.arm(mode, int(body.get("count", 0)),
                                       float(body.get("delay_s", 0.25)))
            self._json(200, {"status": "ok", "mode": mode})
        elif arg == "heal":
            with self.server.lock:
                self.server.faults.heal()
            self._json(200, {"status": "ok"})
        else:
            self._json(404, {"error": "not found"})

    def ring(self, arg: str) -> None:
        self._json(200, self.server.ring())

    def stats(self, arg: str) -> None:
        self._json(200, self.server.stats())

    def health(self, arg: str) -> None:
        self._json(200, {"status": "ok"})


def start_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    """Serve ``server`` from a daemon thread (stop it with
    ``server.shutdown(); server.server_close()``)."""
    thread = threading.Thread(target=server.serve_forever,
                              name=type(server).__name__, daemon=True)
    thread.start()
    return thread


def server_from_args(argv=None) -> KVServer:
    """A kvserver shard from the command line (the JAX kvserver's flags
    and defaults); ``serve_forever()`` serves it."""
    p = argparse.ArgumentParser(
        description="production-stack-tpu remote KV store (PyTorch port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--max-bytes", type=int, default=8 << 30)
    p.add_argument("--peers", default=None,
                   help="comma-separated base URLs of every ring shard "
                        "(this one included): enables GET /ring and the "
                        "anti-entropy sweep")
    p.add_argument("--self-url", default=None,
                   help="this shard's own base URL as it appears in "
                        "--peers")
    p.add_argument("--replication", type=int, default=2,
                   help="replicas a block on the ring (the engines' "
                        "--kv-replication)")
    p.add_argument("--sweep-interval-s", type=float, default=30.0,
                   help="seconds between anti-entropy sweeps (0 disables; "
                        "needs --peers and --self-url)")
    args = p.parse_args(argv)
    server = KVServer((args.host, args.port), args.max_bytes,
                      peers=(args.peers or "").split(","),
                      self_url=args.self_url, replication=args.replication,
                      sweep_interval_s=args.sweep_interval_s)
    logger.info("kvserver on %s:%d (%d bytes; ring %s)", args.host,
                args.port, args.max_bytes, server.ring())
    return server


def main(argv=None) -> None:
    server = server_from_args(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
