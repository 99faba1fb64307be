"""The port's sharded KV client, shard breaker and cache controller
against the JAX package's.

Three port kvservers on fixed ports carry one trace twice, once for the
port's ``ShardedKVClient`` and once for the JAX one (fresh stores on the
same URLs, so the ring places every page on the same owners): pages
written with all shards up, one shard killed, more pages written, every
page read back; then the shard restarted empty and every page read by a
fresh client, which re-pushes what an owner it walked first missed. Both
clients read every page and count the same read repairs and failovers,
and leave the same page counts on the shards. The breaker
walks the JAX breaker's states on a scripted clock, and the controller
answers as the JAX controller's state does.
"""

import http.client
import json
import socket

import ml_dtypes
import numpy as np
import torch

from production_stack_tpu.engine.tokenizer import ByteTokenizer
from production_stack_tpu.kvcache.hashing import chunk_hashes as jax_chunks
from production_stack_tpu.kvserver.controller import (
    ControllerState as JaxControllerState,
)
from production_stack_tpu.kvserver.sharded import (
    ShardedKVClient as JaxShardedKVClient,
)
from production_stack_tpu.resilience.breaker import (
    CircuitBreaker as JaxCircuitBreaker,
)
from production_stack_tpu_torch.engine.cache_tiering import _serialize_page
from production_stack_tpu_torch.kvcache.hashing import CHUNK_TOKENS
from production_stack_tpu_torch.kvserver.controller import ControllerServer
from production_stack_tpu_torch.kvserver.server import KVServer, start_in_thread
from production_stack_tpu_torch.kvserver.sharded import ShardedKVClient
from production_stack_tpu_torch.resilience.breaker import CircuitBreaker

SHAPE = (2, 8, 2, 16)


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _Shard:
    def __init__(self, port: int):
        self.server = KVServer(("127.0.0.1", port), 1 << 30)
        self.thread = start_in_thread(self.server)

    def kill(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _pages(jax_side: bool, hashes):
    rng = np.random.default_rng(7)
    out = []
    for h in hashes:
        raw = rng.integers(0, 256, (2, *SHAPE, 2), dtype=np.uint8)
        if jax_side:
            k, v = raw.view(ml_dtypes.bfloat16).reshape(2, *SHAPE)
        else:
            k, v = torch.from_numpy(raw).view(torch.bfloat16).reshape(
                2, *SHAPE)
        out.append((h, k, v))
    return out


def _trace(client_cls, jax_side: bool, ports: list) -> dict:
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    shards = [_Shard(p) for p in ports]
    first = _pages(jax_side, range(100, 124))
    second = _pages(jax_side, range(200, 212))
    want = {h: _serialize_page(k, v) for h, k, v in first + second}
    out = {}
    try:
        client = client_cls(urls, replication=2, timeout=2.0)
        assert client.put_blocks(first)
        shards[2].kill()
        # One shard down: each page still lands on a live owner, and
        # every page reads back, failing over past the dead shard.
        assert client.put_blocks(second)
        got = client.get_blocks(list(want))
        assert {h: _serialize_page(*p) for h, p in got.items()} == want
        for h in list(want)[:8]:
            assert _serialize_page(*client.get(h)) == want[h]
        # Restarted empty; a fresh client (closed breakers) reads it all,
        # re-pushing what an owner walked first was missing.
        shards[2] = _Shard(ports[2])
        client = client_cls(urls, replication=2, timeout=2.0)
        got = client.get_blocks(list(want))
        assert {h: _serialize_page(*p) for h, p in got.items()} == want
        if hasattr(client, "refresh_counters"):
            client.refresh_counters()
        out["repairs"] = client.counters["read_repairs"]
        out["failovers"] = client.counters["failovers"]
        out["owners"] = {h: client.owners(h) for h in want}
        out["stored"] = [json.loads(_get(p, "/stats"))["num_blocks"]
                         for p in ports]
    finally:
        for shard in shards:
            shard.kill()
    return out


def _get(port: int, path: str, body=None, method="GET") -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    raw = conn.getresponse().read()
    conn.close()
    return raw


def test_sharded_client_reads_every_page_and_repairs_as_the_jax_one():
    ports = _free_ports(3)
    got = _trace(ShardedKVClient, False, ports)
    want = _trace(JaxShardedKVClient, True, ports)
    assert got == want
    assert got["repairs"] > 0 and got["failovers"] > 0


def test_shard_breaker_walks_the_jax_states():
    ours = CircuitBreaker("s", failure_threshold=3, recovery_time=5.0)
    theirs = JaxCircuitBreaker("s", failure_threshold=3, recovery_time=5.0)
    rng = np.random.default_rng(8)
    now = 1000.0
    for step in range(300):
        now += float(rng.choice([0.1, 0.5, 2.0, 6.0]))
        op = rng.random()
        for b in (ours, theirs):
            if op < 0.4:
                b.record_failure(now)
            elif op < 0.6:
                b.record_success(now)
        assert ours.allows(now) == theirs.allows(now), step
        assert ours.current_state(now).value == \
            theirs.current_state(now).value, step
        assert ours.consecutive_failures == theirs.consecutive_failures


def test_controller_answers_as_the_jax_controllers_state():
    server = ControllerServer(("127.0.0.1", 0), instance_ttl=120.0)
    thread = start_in_thread(server)
    port = server.server_address[1]
    ref = JaxControllerState(120.0)

    def post(path, body):
        return json.loads(_get(port, path, body, "POST"))

    try:
        toks = list(range(CHUNK_TOKENS * 3))
        hashes = jax_chunks(toks)
        regs = [("http://e1:8000", "m", hashes[:2], True),
                ("http://e2:8000", "m", hashes, True),
                ("http://e3:8000", "m", hashes[1:], True),
                ("http://e1:8000", "m", hashes[2:], False),
                ("http://e4:8000", "other", hashes, True)]
        for url, model, hs, replace in regs:
            assert post("/register", {"url": url, "model": model,
                                      "hashes": hs, "replace": replace}) == {
                "status": "ok"}
            ref.register(url, model, hs, replace)
        for model, hs in (("m", hashes), ("m", hashes[:1]), ("other", hashes),
                          ("none", hashes)):
            assert post("/lookup", {"model": model, "hashes": hs}) == {
                "matches": ref.lookup(model, hs)}
        assert post("/lookup", {"model": "m", "hashes": hashes})[
            "matches"]["http://e2:8000"] == 3 * CHUNK_TOKENS
        # A gateway's text lookup: byte-tokenized and chunk-hashed here.
        text = "x" * (CHUNK_TOKENS * 2 + 5)
        post("/register", {"url": "http://e5:8000", "model": "t",
                           "hashes": jax_chunks(ByteTokenizer().encode(text))})
        assert post("/lookup", {"model": "t", "text": text}) == {
            "matches": {"http://e5:8000": 2 * CHUNK_TOKENS}}
        assert post("/deregister", {"url": "http://e2:8000"}) == {
            "status": "ok"}
        ref.deregister("http://e2:8000")
        listing = json.loads(_get(port, "/instances"))
        assert listing["m"] == {u: len(h) for u, h in
                                ref.instances["m"].items()}
        assert json.loads(_get(port, "/health")) == {"status": "ok"}
        assert b"invalid body" in _get(port, "/register", {"model": "m"},
                                       "POST")
        # An engine silent past the TTL is dropped.
        server.state.instance_ttl = 0.0
        assert post("/lookup", {"model": "m", "hashes": hashes}) == {
            "matches": {}}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
