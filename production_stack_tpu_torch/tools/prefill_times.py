"""Device time of ``paged_attention_prefill`` at the served heads.

    python -m production_stack_tpu_torch.tools.prefill_times \
        [--heads gemma2-9b gemma-7b llama-3-8b]

For each preset's attention heads (gemma2-9b: H 16, KH 8, head_dim 256,
softcap 50; gemma-7b: H 16, KH 16, head_dim 256; llama-3-8b: H 32, KH 8,
head_dim 128), over a bf16 and an e4m3 cache, and at one sequence's
fresh 512-token chunk, 512-token chunk at 3584 and fresh 2048-token
chunk (``chip_smoke.py`` phase 5's points, block size 32): the time of one
call through the wrapper, calls back to back between CUDA events, queued
behind a spin kernel, the median of 5 batches of 20, and the split count
the wrapper's plan gives. It reads the package from ``sys.path``, so
``PYTHONPATH=<old checkout> python3
production_stack_tpu_torch/tools/prefill_times.py`` times an older
checkout. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

HEADS = {"gemma2-9b": (16, 8, 256, 50.0), "gemma-7b": (16, 16, 256, 0.0),
         "llama-3-8b": (32, 8, 128, 0.0)}
POINTS = ((512, 0), (512, 3584), (2048, 0))
BS = 32


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--heads", nargs="+", default=list(HEADS),
                   choices=list(HEADS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_times needs a CUDA GPU")
    from production_stack_tpu_torch.ops import paged_attention_cuda as pac
    from production_stack_tpu_torch.ops.fp8 import E4M3, to_cache_dtype
    from production_stack_tpu_torch.tools.int4_times import device_ms

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = getattr(pac, "prefill_plan", None)  # absent before the split
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    points = []
    for name in args.heads:
        h, kh, hd, cap = HEADS[name]
        for cache_dtype in (torch.bfloat16, E4M3):
            for T, start in POINTS:
                W = -(-(start + T) // BS)
                q = torch.randn((1, T, h, hd), generator=gen,
                                device=dev).bfloat16()
                cache = to_cache_dtype(torch.randn(
                    (2, W + 3, 2, BS, kh * hd), generator=gen, device=dev),
                    cache_dtype)
                tables = torch.randperm(W + 3, generator=gen, device=dev)[
                    :W].reshape(1, W).to(torch.int32)
                kl = torch.tensor([start + T], dtype=torch.int32, device=dev)
                st = torch.tensor([start], dtype=torch.int32, device=dev)
                ms = device_ms(lambda: pac.paged_attention_prefill(
                    q, cache, tables, kl, st, 1, scale=hd ** -0.5,
                    softcap=cap))
                point = {"heads": name, "cache": str(cache_dtype)[6:],
                         "T": T, "start": start, "ms": ms,
                         "splits": plan(1, kh, T, h // kh, W, BS, n_sm, hd)
                         if plan else 1}
                print(json.dumps(point), flush=True)
                points.append(point)
    print(json.dumps({"card": card, "points": points}), flush=True)


if __name__ == "__main__":
    main()
