"""Prefix-committing content hashes of KV blocks (engine-side prefix cache).

Each block hash commits to the full prefix before it (the parent hash is
chained in), so equal hash means equal prefix, modulo 64-bit collisions.
The digest is BLAKE2b-64 from the standard library. These hashes are
internal to this engine's prefix cache: the router- and controller-facing
chunk hashes of the JAX package (xxh64) are not produced here yet.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


def block_hashes(
    token_ids: Sequence[int], block_size: int, parent: int = 0
) -> List[int]:
    """Hash of each full ``block_size`` block of ``token_ids``, chained
    from ``parent``. Returns unsigned 63-bit ints."""
    out: List[int] = []
    prev = parent
    n_full = len(token_ids) // block_size
    arr = np.asarray(token_ids[: n_full * block_size], dtype=np.int64)
    for i in range(n_full):
        h = hashlib.blake2b(
            arr[i * block_size : (i + 1) * block_size].tobytes(), digest_size=8
        )
        h.update(prev.to_bytes(8, "little", signed=False))
        prev = int.from_bytes(h.digest(), "little") & 0x7FFF_FFFF_FFFF_FFFF
        out.append(prev)
    return out
