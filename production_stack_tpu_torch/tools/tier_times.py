"""Host time of the KV tiers' steps, stage by stage.

    python -m production_stack_tpu_torch.tools.tier_times [--pages 64]

At one bf16 Llama-3-8B page (``[32, 32, 8, 128]`` K and V, 4 MiB) and
``--pages`` pages (64: a 2048-token prompt's handoff), the median
milliseconds over ``--reps`` runs of: serializing the pages, their
BLAKE2b digests on one thread and on the digest pool
(``kvserver.server.block_digests``), deserializing them, and, against
the port's kvserver in a thread over localhost, the publisher's batched
``POST /blocks`` (32 pages a batch, digests packed and checked at
ingest) and the prefetcher's one ``GET /blocks?hashes=`` (digests
checked on read); on a GPU also the pinned host memory a spill takes,
2 MiB tensors fresh and again from PyTorch's cache of freed blocks.
Prints one JSON object as its last line. (The block hashes' time:
``tools/hash_times.py``.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..engine.cache_tiering import (
    RemoteKVClient,
    _deserialize_page,
    _serialize_page,
)
from ..kvserver import server as kvs

PAGE = (32, 32, 8, 128)  # Llama-3-8B [L, bs, KH, hd]


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tier_times(n_pages: int = 64, reps: int = 5) -> dict:
    rng = np.random.default_rng(0)
    pages = [(int(h), *(torch.from_numpy(
        rng.integers(0, 1 << 16, PAGE, dtype=np.uint16)).view(torch.bfloat16)
        for _ in range(2))) for h in rng.integers(1, 1 << 62, n_pages)]
    data = [_serialize_page(k, v) for _, k, v in pages]
    out = {
        "pages": n_pages,
        "page_mib": len(data[0]) / 2**20,
        "serialize": median_ms(
            lambda: [_serialize_page(k, v) for _, k, v in pages], reps),
        "digest_one_thread": median_ms(
            lambda: [kvs.block_digest(d) for d in data], reps),
        "digest_pool": median_ms(lambda: kvs.block_digests(data), reps),
        "deserialize": median_ms(
            lambda: [_deserialize_page(d) for d in data], reps),
    }
    server = kvs.KVServer(("127.0.0.1", 0), 8 << 30)
    thread = kvs.start_in_thread(server)
    try:
        client = RemoteKVClient(server.url, timeout=120.0)

        def put():
            for i in range(0, n_pages, 32):
                assert client.put_blocks(pages[i:i + 32])

        def get():
            assert len(client.get_blocks([h for h, _, _ in pages])) == n_pages

        out["post_blocks"] = median_ms(put, reps)
        out["get_blocks"] = median_ms(get, reps)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    if torch.cuda.is_available():
        def pins():
            return [torch.empty(2 << 20, dtype=torch.uint8, pin_memory=True)
                    for _ in range(2 * n_pages)]

        torch.cuda.init()
        t0 = time.perf_counter()
        held = pins()
        out["pin_fresh"] = (time.perf_counter() - t0) * 1e3
        del held
        t0 = time.perf_counter()
        held = pins()
        out["pin_cached"] = (time.perf_counter() - t0) * 1e3
        del held
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pages", type=int, default=64)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    print(json.dumps({"ms": tier_times(args.pages, args.reps)}), flush=True)


if __name__ == "__main__":
    main()
