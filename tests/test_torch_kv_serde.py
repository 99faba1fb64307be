"""The port's page serde, batch frames, host pool and block store against
the JAX package's, byte for byte.

A page spilled or published by one package must be read by the other:
the serialized bytes of the same page (bf16, e4m3 and fp32, the JAX
runner's ``[L, bs, KH, hd]`` layout) are equal, each side reads the
other's, the batch frames are equal, and the host pool and the kvserver's
byte LRU keep and drop the same pages on the same trace. Digests of a
large batch run on a thread pool and frame the same bytes.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import cache_tiering as jax_tiering
from production_stack_tpu.kvserver import server as jax_kv
from production_stack_tpu_torch.engine import cache_tiering as tiering
from production_stack_tpu_torch.kvserver import server as kv

SHAPE = (2, 8, 2, 16)  # [L, bs, KH, hd]


def _page(rng, torch_dtype, np_dtype):
    """The same random bytes as a port tensor and a JAX (numpy) array."""
    size = torch.empty((), dtype=torch_dtype).element_size()
    raw = rng.integers(0, 256, (*SHAPE, size), dtype=np.uint8)
    if torch_dtype == torch.float32:  # finite values: a readable page
        raw = rng.standard_normal(SHAPE).astype(np.float32).view(
            np.uint8).reshape(*SHAPE, 4)
    t = torch.from_numpy(raw.copy()).view(torch_dtype).reshape(SHAPE)
    return t, raw.view(np_dtype).reshape(SHAPE)


@pytest.mark.parametrize("torch_dtype, np_dtype", [
    (torch.bfloat16, ml_dtypes.bfloat16),
    (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
    (torch.float32, np.float32),
], ids=["bf16", "e4m3", "fp32"])
def test_page_serde_is_the_jax_bytes(torch_dtype, np_dtype):
    rng = np.random.default_rng(3)
    k, jk = _page(rng, torch_dtype, np_dtype)
    v, jv = _page(rng, torch_dtype, np_dtype)
    data = tiering._serialize_page(k, v)
    assert data == jax_tiering._serialize_page(jk, jv)
    # Each side reads the other's bytes.
    rk, rv = tiering._deserialize_page(jax_tiering._serialize_page(jk, jv))
    assert rk.dtype == torch_dtype and tuple(rk.shape) == SHAPE
    for got, want in ((rk, jk), (rv, jv)):
        np.testing.assert_array_equal(got.view(torch.uint8).numpy().ravel(),
                                      want.view(np.uint8).ravel())
    jrk, jrv = jax_tiering._deserialize_page(data)
    assert jrk.dtype == np.dtype(np_dtype)
    np.testing.assert_array_equal(jrv.view(np.uint8), jv.view(np.uint8))
    # The port also writes JAX's numpy pages as JAX does.
    assert tiering._serialize_page(jk, jv) == data
    with pytest.raises(ValueError, match="magic"):
        tiering._deserialize_page(b"PSTKV1\x00\x00" + data[8:])


def test_host_pool_keeps_the_jax_pools_pages():
    pool, jpool = tiering.HostKVPool(3), jax_tiering.HostKVPool(3)
    rng = np.random.default_rng(4)
    a = np.ones((1, 2, 2, 2), np.float32)
    for step in range(200):
        h = int(rng.integers(0, 8))
        if rng.random() < 0.5:
            pool.put(h, torch.from_numpy(a), torch.from_numpy(a))
            jpool.put(h, a, a)
        else:
            assert (pool.get(h) is None) == (jpool.get(h) is None), step
        assert list(pool._pages) == list(jpool._pages), step
        assert pool.bytes_used == jpool.bytes_used
        assert len(pool) == len(jpool)
    assert pool.contains(list(pool._pages)[0])


def test_batch_frames_and_block_store_equal_the_jax_ones():
    rng = np.random.default_rng(5)
    pages = [(int(rng.integers(0, 2**63)),
              rng.integers(0, 256, int(rng.integers(0, 300)),
                           dtype=np.uint8).tobytes()) for _ in range(7)]
    body = kv.pack_blocks(pages)
    assert body == jax_kv.pack_blocks(pages)
    with_digest = [(h, d, kv.block_digest(d)) for h, d in pages]
    assert kv.pack_blocks(with_digest) == body
    assert kv.unpack_blocks_ex(body) == jax_kv.unpack_blocks_ex(body)
    assert kv.unpack_blocks(body) == pages
    # A rotted payload: skipped into ``corrupt`` or raised, as in JAX.
    bad = bytearray(body)
    bad[28 + len(pages[0][1]) // 2] ^= 0xFF
    got, want = [], []
    assert kv.unpack_blocks(bytes(bad), got) == jax_kv.unpack_blocks(
        bytes(bad), want)
    assert got == want == ([pages[0][0]] if pages[0][1] else [])
    for torn in (body[:5], body[:-1]):
        with pytest.raises(ValueError, match="torn"):
            kv.unpack_blocks(torn)
    # The byte LRU evicts the same hashes on the same trace.
    store, jstore = kv.BlockStore(1000), jax_kv.BlockStore(1000)
    trace = [(int(rng.integers(0, 24)), rng.random(),
              bytes(int(rng.integers(0, 8)) * 40 + 1)) for _ in range(400)]
    trace.append((99, 0.0, bytes(2000)))  # larger than the store
    for step, (h, op, payload) in enumerate(trace):
        for s in (store, jstore):
            if op < 0.6:
                s.put(h, payload)
            elif op < 0.9:
                s.get(h)
            else:
                s.quarantine([h, h + 1])
        assert list(store._blocks) == list(jstore._blocks), step
        for name in ("bytes_used", "hits", "misses", "evictions",
                     "blocks_put", "quarantined"):
            assert getattr(store, name) == getattr(jstore, name), name
    assert store.evictions > 0 and store.quarantined > 0
    assert store.get(99) is None


def test_pooled_digests_frame_the_jax_bytes(monkeypatch):
    """Batches past the pooled-digest threshold digest on the thread pool:
    the frames equal the JAX package's byte for byte, and a corrupt frame
    among them is the one counted, as the JAX reader counts it."""
    monkeypatch.setattr(kv, "_POOLED_DIGEST_BYTES", 0)
    rng = np.random.default_rng(9)
    pages = [(int(h), rng.bytes(3000 + 7 * i))
             for i, h in enumerate(rng.integers(1, 2**63, 12))]
    assert kv.block_digests([p for _, p in pages]) == [
        jax_kv.block_digest(p) for _, p in pages]
    body = kv.pack_blocks(pages[:5] + [(h, p, kv.block_digest(p))
                                       for h, p in pages[5:]])
    assert body == jax_kv.pack_blocks(pages)
    rotten = bytearray(body)
    bad = 3
    off = sum(28 + len(p) for _, p in pages[:bad]) + 28 + 100
    rotten[off] ^= 0xFF
    got, jgot = [], []
    out = kv.unpack_blocks(bytes(rotten), got)
    jout = jax_kv.unpack_blocks(bytes(rotten), jgot)
    assert got == jgot == [pages[bad][0]]
    assert out == jout == pages[:bad] + pages[bad + 1:]
    with pytest.raises(ValueError, match="digest mismatch"):
        kv.unpack_blocks(bytes(rotten))
