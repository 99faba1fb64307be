"""Host time of the block hashes of one prompt: the xxh64 chain the
engine runs on every admission (``kvcache/hashing.py``) beside the
BLAKE2b-64 chain the port used before it (kept here only to be timed).

    python -m production_stack_tpu_torch.tools.hash_times [--tokens 4096]

prints one JSON line: each chain's median milliseconds over ``--reps``
batches of ``--iters`` calls, for a prompt of ``--tokens`` random token
ids in ``--block-size`` blocks.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time
from typing import List, Sequence

import numpy as np

from ..kvcache.hashing import block_hashes


def blake2b_block_hashes(token_ids: Sequence[int], block_size: int,
                         parent: int = 0) -> List[int]:
    """The earlier chain: BLAKE2b-64 of each block's int64 tokens and the
    parent's 8 bytes, masked to 63 bits."""
    out: List[int] = []
    prev = parent
    n_full = len(token_ids) // block_size
    arr = np.asarray(token_ids[: n_full * block_size], dtype=np.int64)
    for i in range(n_full):
        h = hashlib.blake2b(arr[i * block_size:(i + 1) * block_size].tobytes(),
                            digest_size=8)
        h.update(prev.to_bytes(8, "little", signed=False))
        prev = int.from_bytes(h.digest(), "little") & 0x7FFF_FFFF_FFFF_FFFF
        out.append(prev)
    return out


def time_ms(fn, tokens: list, block_size: int, iters: int, reps: int) -> float:
    fn(tokens, block_size)  # warm
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(tokens, block_size)
        runs.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(runs)


def hash_times(n_tokens: int = 4096, block_size: int = 32, iters: int = 50,
               reps: int = 5, seed: int = 0) -> dict:
    tokens = np.random.default_rng(seed).integers(
        0, 128256, n_tokens).tolist()
    return {"tokens": n_tokens, "block_size": block_size,
            "xxh64_ms": time_ms(block_hashes, tokens, block_size, iters,
                                reps),
            "blake2b_ms": time_ms(blake2b_block_hashes, tokens, block_size,
                                  iters, reps)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tokens", type=int, default=4096)
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    print(json.dumps(hash_times(args.tokens, args.block_size, args.iters,
                                args.reps)))


if __name__ == "__main__":
    main()
