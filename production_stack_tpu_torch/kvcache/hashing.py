"""Content hashing of token chunks: the contract that makes prefix reuse,
KV-aware routing and remote KV lookup agree with each other.

The JAX package's ``kvcache/hashing.py`` scheme, bit for bit: a rolling
xxh64 over fixed-size token chunks (each chunk's int64 tokens, then the
previous hash as 8 little-endian bytes), masked to 63 bits, so each hash
commits to the full prefix before it (equal hash means equal prefix,
modulo 64-bit collisions). Block hashes key the engine's prefix cache and
the kvserver's pages; chunk hashes (256 tokens) are what the cache
controller and the router's KV-aware lookup compare. The xxh64 is this
package's own (``kvcache/xxh64.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .xxh64 import chained_xxh64

# One hash per CHUNK_TOKENS tokens. Must align with the engine KV block
# size (engine blocks per chunk = CHUNK_TOKENS // block_size).
CHUNK_TOKENS = 256
_MASK63 = 0x7FFF_FFFF_FFFF_FFFF


def block_hashes(
    token_ids: Sequence[int], block_size: int, parent: int = 0
) -> List[int]:
    """Per-KV-block prefix-committing hashes of each full ``block_size``
    block of ``token_ids``, chained from ``parent`` (used when extending
    an existing sequence; the chain runs on the emitted, masked values, so
    an incremental caller lands on the one-shot chain). Returns unsigned
    63-bit ints (JSON-safe)."""
    n_full = len(token_ids) // block_size
    arr = np.asarray(token_ids[: n_full * block_size], dtype=np.int64)
    return chained_xxh64(arr.reshape(n_full, block_size), int(parent), _MASK63)


def chunk_hashes(token_ids: Sequence[int],
                 chunk_tokens: int = CHUNK_TOKENS) -> List[int]:
    """Prefix-committing hashes of each full chunk of ``token_ids``: a
    700-token prompt with 256-token chunks yields 2 hashes."""
    return block_hashes(token_ids, chunk_tokens)
