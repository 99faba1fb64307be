"""The port's kvserver as a ring shard: the chart's cache-server argv,
``GET /ring`` and the anti-entropy sweep, beside the JAX kvserver.

A ring mixes port shards (``http.server``) and JAX shards (aiohttp on a
loop thread, ``tests/test_kvserver_ring.py``'s harness). Pages are put on
their owners, one shard is wiped, and the others' sweeps push the missing
frames back within two sweep intervals, with the digests the producer
computed: a port shard backfilled by JAX shards and a JAX shard by port
shards.
"""

import http.client
import json
import socket
import time

import pytest

from production_stack_tpu_torch.hashring import ConsistentHashRing
from production_stack_tpu_torch.kvserver.server import (
    KVServer,
    block_digest,
    pack_blocks,
    server_from_args,
    start_in_thread,
    unpack_blocks_ex,
)

from .test_kvserver_ring import _Shard

# The chart's cache-server args (helm/templates/cache-server.yaml at the
# default values, a release named "pst", shard 0 of 2).
SHARDS = ("http://pst-cache-server-0.pst-cache-server:8100,"
          "http://pst-cache-server-1.pst-cache-server:8100")
CHART_CACHE_ARGV = [
    "--host", "0.0.0.0", "--port", "8100", "--max-bytes", "64000000000",
    "--self-url", "http://pst-cache-server-0.pst-cache-server:8100",
    "--peers", SHARDS, "--replication", "2", "--sweep-interval-s", "30",
]
SWEEP_S = 1.0


def _get(url: str, path: str):
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _post(url: str, path: str, body: bytes):
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.request("POST", path, body)
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


class Ring:
    """Shards of the kinds given ("port" or "jax"), on localhost, each
    knowing every shard's URL."""

    def __init__(self, kinds, replication=2, sweep_interval_s=SWEEP_S):
        self.kinds = list(kinds)
        self.shards, self.urls = [], []
        for kind in kinds:
            if kind == "port":
                # Bound now (port 0); its ring is set once every URL is
                # known, before it serves.
                shard = KVServer(("127.0.0.1", 0), 1 << 30)
                self.urls.append(shard.url)
            else:
                sock = socket.socket()
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sock.bind(("127.0.0.1", 0))
                shard = sock
                self.urls.append(f"http://127.0.0.1:{sock.getsockname()[1]}")
            self.shards.append(shard)
        self.threads = []
        for i, (kind, url) in enumerate(zip(kinds, self.urls)):
            if kind == "port":
                shard = self.shards[i]
                shard.peers, shard.self_url = list(self.urls), url
                shard.replication = replication
                shard.sweep_interval_s = sweep_interval_s
                self.threads.append(start_in_thread(shard))
            else:
                self.shards[i] = _Shard(self.shards[i], url, self.urls,
                                        replication, sweep_interval_s).start()
        self.ring = ConsistentHashRing()
        self.ring.update(self.urls)
        self.replication = replication

    def stats(self, i: int) -> dict:
        return json.loads(_get(self.urls[i], "/stats")[1])

    def holds(self, i: int, hashes) -> bool:
        body = json.dumps({"hashes": list(hashes)})
        host, port = self.urls[i].split("//")[1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        conn.request("POST", "/contains", body)
        present = json.loads(conn.getresponse().read())["present"]
        conn.close()
        return all(present)

    def wipe(self, i: int, hashes) -> None:
        shard = self.shards[i]
        if self.kinds[i] == "port":
            with shard.lock:
                assert shard.store.quarantine(hashes) == len(hashes)
        else:
            assert shard.app["store"].quarantine(hashes) == len(hashes)

    def stop(self) -> None:
        for kind, shard in zip(self.kinds, self.shards):
            if kind == "port":
                shard.shutdown()
                shard.server_close()
            else:
                shard.stop()
        for t in self.threads:
            t.join(timeout=10)


def test_the_kvserver_takes_the_charts_argv_and_answers_ring_as_jax():
    server = server_from_args(CHART_CACHE_ARGV[:3] + ["0"]
                              + CHART_CACHE_ARGV[4:])
    try:
        assert server.ring() == {
            "peers": SHARDS.split(","),
            "self": "http://pst-cache-server-0.pst-cache-server:8100",
            "replication": 2, "sweep_interval_s": 30.0}
        assert server.sweep_interval_s == 30.0 and server._sweeper is None
    finally:
        server.server_close()
    ring = Ring(["port", "jax"], replication=3, sweep_interval_s=0.0)
    try:
        answers = [json.loads(_get(u, "/ring")[1]) for u in ring.urls]
        for i, a in enumerate(answers):
            assert a == {"peers": ring.urls, "self": ring.urls[i],
                         "replication": 3, "sweep_interval_s": 0.0}
        # Neither sweeps at interval 0, and the counters say so.
        time.sleep(0.2)
        assert [ring.stats(i)["anti_entropy_sweeps"] for i in (0, 1)] \
            == [0, 0]
        assert ring.shards[0]._sweeper is None
    finally:
        ring.stop()


@pytest.mark.parametrize("kinds, victim", [
    (["port", "jax", "port"], 1), (["jax", "port", "jax"], 1)],
    ids=["port-shards-backfill-a-jax-shard",
         "jax-shards-backfill-a-port-shard"])
def test_a_wiped_shard_is_backfilled_by_the_sweep(kinds, victim):
    ring = Ring(kinds)
    try:
        payloads = {h: bytes([h % 251]) * (4096 + h) for h in range(100, 160)}
        digests = {h: block_digest(d) for h, d in payloads.items()}
        by_owner = {u: [] for u in ring.urls}
        for h, d in payloads.items():
            for owner in ring.ring.get_nodes(str(h), ring.replication):
                by_owner[owner].append((h, d))
        for url, frames in by_owner.items():
            assert _post(url, "/blocks", pack_blocks(frames)) == 200
        owned = [h for h, _ in by_owner[ring.urls[victim]]]
        assert owned
        before = [ring.stats(i)["anti_entropy_pushes"] for i in range(3)]
        ring.wipe(victim, owned)
        assert not ring.holds(victim, owned[:1])
        t0 = time.monotonic()
        while (not ring.holds(victim, owned)
               and time.monotonic() - t0 < 4 * SWEEP_S):
            time.sleep(0.02)
        took = time.monotonic() - t0
        assert ring.holds(victim, owned) and took <= 2 * SWEEP_S, took
        status, raw = _get(ring.urls[victim], "/blocks?hashes="
                           + ",".join(map(str, owned)))
        assert status == 200
        frames = unpack_blocks_ex(raw)
        assert sorted(frames) == sorted((h, payloads[h], digests[h])
                                        for h in owned)
        # The pushes came from the victim's co-owners, of the other kind.
        pushed = [ring.stats(i)["anti_entropy_pushes"] - before[i]
                  for i in range(3)]
        assert pushed[victim] == 0 and sum(pushed) >= len(owned)
        assert all(ring.stats(i)["anti_entropy_sweeps"] > 0
                   for i in range(3))
    finally:
        ring.stop()


def test_a_sweep_needs_its_ring_and_skips_a_peer_that_fails():
    lone = KVServer(("127.0.0.1", 0), 1 << 20, sweep_interval_s=0.05)
    thread = start_in_thread(lone)
    try:
        time.sleep(0.2)
        assert lone._sweeper is None and lone.stats()[
            "anti_entropy_sweeps"] == 0
    finally:
        lone.shutdown()
        lone.server_close()
        thread.join(timeout=10)
    # A co-owner that refuses connections: the pass pushes nothing and
    # raises nothing.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    shard = KVServer(("127.0.0.1", 0), 1 << 20, peers=[dead],
                     self_url="", replication=2)
    try:
        shard.self_url = shard.url
        shard.peers = [shard.url, dead]
        shard.store.put(7, b"page")
        assert shard.sweep_once() == 0
    finally:
        shard.server_close()
