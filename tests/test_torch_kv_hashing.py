"""The port's xxh64, block and chunk hashes and hash ring against the JAX
package's, bit for bit.

The hashes leave the engine (the kvserver keys pages by block hash, the
cache controller and the router's KV-aware lookup compare chunk hashes),
and the ring places pages on kvserver shards: each must equal the JAX
package's (``xxhash``) for the same input.
"""

import numpy as np
import xxhash

from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.engine.sequence import Sequence as JaxSequence
from production_stack_tpu.hashring import ConsistentHashRing as JaxRing
from production_stack_tpu.kvcache import hashing as jax_hashing
from production_stack_tpu_torch.engine.kv_manager import BlockAllocator
from production_stack_tpu_torch.engine.sequence import SamplingParams, Sequence
from production_stack_tpu_torch.hashring import ConsistentHashRing
from production_stack_tpu_torch.kvcache.hashing import (
    CHUNK_TOKENS,
    block_hashes,
    chunk_hashes,
)
from production_stack_tpu_torch.kvcache.xxh64 import xxh64


def test_xxh64_equals_xxhash():
    rng = np.random.default_rng(0)
    for n in [*range(0, 101), *range(256, 2101, 3)]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1, 2**64 - 1):
            assert xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed), n


def test_block_and_chunk_hashes_equal_the_jax_ones():
    rng = np.random.default_rng(1)
    vocab = 128256
    # Every residue of the block size mod 4 (the parent lands in a
    # stripe when it is 3), prompts shorter than a block, ragged tails.
    for bs in [*range(1, 20), 32, 63, 64, 256]:
        for n in (0, 1, bs - 1, bs, 3 * bs + 1, 5 * bs):
            toks = rng.integers(0, vocab, max(n, 0)).tolist()
            for parent in (0, 1, 0x7FFF_FFFF_FFFF_FFFF,
                           int(rng.integers(0, 2**63))):
                assert block_hashes(toks, bs, parent) == \
                    jax_hashing.block_hashes(toks, bs, parent), (bs, n)
    toks = rng.integers(0, vocab, 9 * CHUNK_TOKENS + 77).tolist()
    assert chunk_hashes(toks) == jax_hashing.chunk_hashes(toks)
    assert len(chunk_hashes(toks)) == 9
    # numpy input and the masked 63-bit range.
    arr = np.asarray(toks, dtype=np.int64)
    assert block_hashes(arr, 32) == jax_hashing.block_hashes(toks, 32)
    assert all(0 <= h < 2**63 for h in block_hashes(toks, 32))


def test_incremental_chains_equal_the_full_one():
    """Block by block from each emitted hash, and the sequence's commit
    cursors (blocks and controller chunks), land on the one-shot chain,
    as the JAX sequence's do."""
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 500, 2 * CHUNK_TOKENS + 40).tolist()
    full = block_hashes(toks, 8)
    prev, inc = 0, []
    for i in range(len(toks) // 8):
        prev = block_hashes(toks[i * 8:(i + 1) * 8], 8, parent=prev)[0]
        inc.append(prev)
    assert inc == full == jax_hashing.block_hashes(toks, 8)
    alloc = BlockAllocator(200, 8)
    seq = Sequence("s", toks, SamplingParams())
    jseq = JaxSequence("s", toks, JaxSamplingParams())
    seq.block_ids = [alloc.allocate() for _ in range(len(toks) // 8 + 1)]
    jalloc = BlockAllocator(200, 8)
    jseq.block_ids = [jalloc.allocate() for _ in range(len(toks) // 8 + 1)]
    chunks, jchunks = [], []
    for end in (5, 8, 100, CHUNK_TOKENS + 3, CHUNK_TOKENS + 3, len(toks)):
        seq.num_computed_tokens = jseq.num_computed_tokens = end
        seq.commit_full_blocks(alloc)
        jseq.commit_full_blocks(jalloc)
        chunks += seq.commit_full_chunks(CHUNK_TOKENS)
        jchunks += jseq.commit_full_chunks(CHUNK_TOKENS)
    assert seq.block_hashes == jseq.block_hashes == full
    assert chunks == jchunks == chunk_hashes(toks)
    assert len(chunks) == 2


def test_ring_owners_equal_the_jax_rings():
    urls = [f"http://10.0.0.{i}:8100" for i in range(1, 6)]
    for nodes in (urls[:1], urls[:3], urls):
        ring, jring = ConsistentHashRing(), JaxRing()
        ring.update(nodes)
        jring.update(nodes)
        assert ring._ring == jring._ring
        for key in range(1000):
            k = str(key * 7919 + 2**62)
            assert ring.get_node(k) == jring.get_node(k)
            for n in (1, 2, 3):
                assert ring.get_nodes(k, n) == jring.get_nodes(k, n)
    assert ConsistentHashRing().get_nodes("x", 2) == []
