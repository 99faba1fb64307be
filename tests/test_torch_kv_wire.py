"""Each package's remote-KV client against the other package's kvserver.

The port's kvserver (``http.server``) and client (``http.client``) must
speak the JAX package's wire format (aiohttp and ``requests``) byte for
byte: the JAX client stores and reads pages, batches and manifests on the
port's store, and the port's client on the JAX store (aiohttp on its own
loop thread). Both cover a single and a batched put and get, the served
digest, an injected ``corrupt`` read that is counted and quarantined, a
manifest long poll answered by a later append, a ``drop_manifest``
fault, and a kvserver that never answers, which each client's deadline
bounds.
"""

import hashlib
import http.client
import json
import socket
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.cache_tiering import (
    RemoteKVClient as JaxRemoteKVClient,
)
from production_stack_tpu.engine.cache_tiering import (
    _serialize_page as jax_serialize,
)
from production_stack_tpu_torch.engine.cache_tiering import (
    RemoteKVClient,
    _serialize_page,
)
from production_stack_tpu_torch.kvserver.server import KVServer, start_in_thread

from .test_disagg_prefill import ThreadedKVServer

SHAPE = (2, 8, 2, 16)


def _pages(jax_side: bool, n: int):
    """``n`` (k, v) bf16 pages of random bytes, as the client's package
    holds them (numpy for JAX, tensors for the port)."""
    rng = np.random.default_rng(6)
    out = []
    for _ in range(n):
        kv = []
        for _ in range(2):
            raw = rng.integers(0, 256, (*SHAPE, 2), dtype=np.uint8)
            kv.append(raw.view(ml_dtypes.bfloat16).reshape(SHAPE) if jax_side
                      else torch.from_numpy(raw).view(torch.bfloat16)
                      .reshape(SHAPE))
        out.append(tuple(kv))
    return out


def _bytes(page) -> bytes:
    k, v = page
    if isinstance(k, torch.Tensor):
        return _serialize_page(k, v)
    return jax_serialize(k, v)


def _http(url: str, method: str, path: str, body=None):
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), raw


def _stats(url: str) -> dict:
    return json.loads(_http(url, "GET", "/stats")[2])


@pytest.fixture(scope="module")
def stores():
    port = KVServer(("127.0.0.1", 0), 1 << 30)
    thread = start_in_thread(port)
    jax = ThreadedKVServer().start()
    yield {"port": port.url, "jax": jax.url}
    port.shutdown()
    port.server_close()
    thread.join(timeout=10)
    jax.stop()


@pytest.mark.parametrize("client_side, store_side", [
    ("jax", "port"), ("port", "jax")], ids=["jax-client-port-store",
                                           "port-client-jax-store"])
def test_client_against_the_other_packages_kvserver(stores, client_side,
                                                    store_side):
    url = stores[store_side]
    jax_side = client_side == "jax"
    client = (JaxRemoteKVClient if jax_side else RemoteKVClient)(url)
    pages = _pages(jax_side, 4)
    base = 1000 if jax_side else 2000  # the two runs share no hash
    # One page: stored, read back, its served digest the producer's.
    assert client.put(base, *pages[0])
    got = client.get(base)
    assert _bytes(got) == _bytes(pages[0])
    status, headers, raw = _http(url, "GET", f"/blocks/{base}")
    assert status == 200 and raw == _bytes(pages[0])
    assert headers["X-PST-Digest"] == hashlib.blake2b(
        raw, digest_size=16).hexdigest()
    assert client.get(base + 99) is None
    # A batch: one round trip each way; absent hashes left out.
    calls = _stats(url)["put_calls"]
    assert client.put_blocks([(base + i, *p) for i, p in
                              enumerate(pages[1:], start=1)])
    assert _stats(url)["put_calls"] == calls + 1
    found = client.get_blocks([base + 1, base + 2, base + 3, base + 77])
    assert sorted(found) == [base + 1, base + 2, base + 3]
    for i in (1, 2, 3):
        assert _bytes(found[base + i]) == _bytes(pages[i])
    # A rotted copy: dropped, counted, quarantined on the store.
    quarantined = _stats(url)["quarantined"]
    assert _http(url, "POST", "/admin/fail",
                 {"mode": "corrupt", "count": 1})[0] == 200
    assert client.get(base + 1) is None
    assert client.counters["integrity_failures"] == 1
    assert _http(url, "POST", "/admin/fail",
                 {"mode": "corrupt", "count": 1})[0] == 200
    # The first frame served is the rotted one.
    assert sorted(client.get_blocks([base + 2, base + 3])) == [base + 3]
    assert client.counters["integrity_failures"] == 2
    assert _stats(url)["quarantined"] == quarantined + 2
    present = json.loads(_http(url, "POST", "/contains", {
        "hashes": [base + 1, base + 2, base + 3]})[2])["present"]
    assert present == [False, False, True]
    if not jax_side:
        assert client.integrity_by_source == {
            "prefetch": 0, "match_prefix": 1, "restore": 1}
    # A manifest long poll, answered by an append 0.3 s later.
    rid = f"rid-{client_side}"
    timer = threading.Timer(0.3, client.post_manifest, (rid, [base, base + 1]))
    t0 = time.monotonic()
    timer.start()
    view = client.get_manifest(rid, wait_s=5.0, have=0)
    assert 0.2 < time.monotonic() - t0 < 3.0
    assert view == {"request_id": rid, "hashes": [base, base + 1],
                    "complete": False, "total_blocks": None}
    assert client.post_manifest(rid, [base + 1, base + 2], complete=True,
                                total_blocks=3)
    assert client.get_manifest(rid, wait_s=1.0, have=2) == {
        "request_id": rid, "hashes": [base, base + 1, base + 2],
        "complete": True, "total_blocks": 3}
    # drop_manifest: acknowledged, never stored.
    assert _http(url, "POST", "/admin/fail",
                 {"mode": "drop_manifest", "count": 1})[0] == 200
    assert client.post_manifest(rid + "-lost", [base])
    assert client.get_manifest(rid + "-lost") is None
    assert _http(url, "POST", "/admin/heal")[0] == 200
    assert client.counters["retries"] == 0


def test_a_kvserver_that_never_answers_is_bounded_by_the_deadline():
    """A socket that accepts and never answers: every call of either
    client returns a miss within its deadline."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(16)
    url = f"http://127.0.0.1:{sock.getsockname()[1]}"
    try:
        for client in (RemoteKVClient(url, timeout=0.3),
                       JaxRemoteKVClient(url, timeout=0.3)):
            t0 = time.monotonic()
            assert client.get(1) is None
            assert client.get_blocks([1, 2], timeout=0.2) == {}
            assert client.get_manifest("r", timeout=0.2) is None
            assert not client.put_blocks([(1, *_pages(True, 1)[0])])
            # Each call is cut at its own deadline (get_manifest's read
            # covers its poll plus 2 s of slack).
            assert time.monotonic() - t0 < 5.0
    finally:
        sock.close()
