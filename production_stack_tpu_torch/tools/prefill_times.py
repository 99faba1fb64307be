"""Device time of ``paged_attention_prefill`` at the served heads.

    python -m production_stack_tpu_torch.tools.prefill_times \
        [--parts wgmma simt] [--heads gemma2-9b gemma-7b llama-3-8b] \
        [--splits 1 2 4]

``wgmma``: bf16 q on the tensor-core prefill, for each preset's attention
heads (gemma2-9b: H 16, KH 8, head_dim 256, softcap 50; gemma-7b: H 16,
KH 16, head_dim 256; llama-3-8b: H 32, KH 8, head_dim 128), over a bf16
and an e4m3 cache, at one sequence's fresh 512-token chunk, 512-token
chunk at 3584 and fresh 2048-token chunk (``chip_smoke.py`` phase 5's
points, block size 32). ``simt``: fp32 q on the CUDA-core prefill, at
tiny-llama-debug's heads (H = KH = 8, head_dim 16) on a fresh 256-token
chunk over an fp32 and an e4m3 cache, at Llama-3-8B's heads on a fresh
512-token chunk and a 512-token chunk at 3584, and at gemma2-9b's (no
softcap) on a fresh 512-token chunk, each over an fp32 cache, beside an
empty kernel queued the same way (``floor_ms``) and the operations bound,
4 * H * head_dim * (the keys each row sees) FLOP at 67 TFLOP/s (fp32 off
the tensor cores, the H100 SXM's data sheet). (The port calls no library
attention; ``chip_smoke.py`` phase 5 times the yardstick, SDPA, at the
same points.) Each time: one call through the wrapper, calls back to back
between CUDA events, queued behind a spin kernel, the median of 5 batches
of 20 (``int4_times.device_ms``), with the split count the wrapper's plan
gives; ``--splits``: also the time at each of these split counts, the
plan replaced (``forced_ms``). It reads the package from ``sys.path``, so
``PYTHONPATH=<old checkout> python3
production_stack_tpu_torch/tools/prefill_times.py`` times an older
checkout (one without a plan reports 1 split). Prints one JSON object as
its last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

HEADS = {"gemma2-9b": (16, 8, 256, 50.0), "gemma-7b": (16, 16, 256, 0.0),
         "llama-3-8b": (32, 8, 128, 0.0)}
POINTS = ((512, 0), (512, 3584), (2048, 0))
# The CUDA-core prefill's points: (name, H, KH, head_dim, cache, T, start).
SIMT_POINTS = (("tiny-llama-debug", 8, 8, 16, "float32", 256, 0),
               ("tiny-llama-debug", 8, 8, 16, "float8_e4m3fn", 256, 0),
               ("llama-3-8b", 32, 8, 128, "float32", 512, 0),
               ("llama-3-8b", 32, 8, 128, "float32", 512, 3584),
               ("gemma2-9b", 16, 8, 256, "float32", 512, 0))
BS = 32
FP32_FLOPS = 67e12


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parts", nargs="+", default=["wgmma", "simt"],
                   choices=["wgmma", "simt"])
    p.add_argument("--heads", nargs="+", default=list(HEADS),
                   choices=list(HEADS))
    p.add_argument("--splits", nargs="*", type=int, default=[])
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
    simt_plan = getattr(pac, "simt_prefill_plan", None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)

    def case(T, start, h, kh, hd, q_dtype, cache_dtype):
        W = -(-(start + T) // BS)
        q = torch.randn((1, T, h, hd), generator=gen, device=dev).to(q_dtype)
        cache = to_cache_dtype(torch.randn(
            (2, W + 3, 2, BS, kh * hd), generator=gen, device=dev),
            cache_dtype)
        tables = torch.randperm(W + 3, generator=gen, device=dev)[
            :W].reshape(1, W).to(torch.int32)
        kl = torch.tensor([start + T], dtype=torch.int32, device=dev)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        return q, cache, tables, kl, st

    def forced(name, c, hd, cap):
        """The prefill's ms at each of ``--splits``, the plan replaced."""
        saved = getattr(pac, name, None)
        out = {}
        try:
            for n in args.splits if saved else ():
                setattr(pac, name, lambda *a, **k: n)
                out[n] = device_ms(lambda: pac.paged_attention_prefill(
                    *c, 1, scale=hd ** -0.5, softcap=cap))
        finally:
            if saved:
                setattr(pac, name, saved)
        return out

    points = []
    for name in args.heads if "wgmma" in args.parts else ():
        h, kh, hd, cap = HEADS[name]
        for cache_dtype in (torch.bfloat16, E4M3):
            for T, start in POINTS:
                c = case(T, start, h, kh, hd, torch.bfloat16, cache_dtype)
                ms = device_ms(lambda: pac.paged_attention_prefill(
                    *c, 1, scale=hd ** -0.5, softcap=cap))
                nb = c[1].shape[1]  # the launch plans at the page count
                point = {"heads": name, "cache": str(cache_dtype)[6:],
                         "T": T, "start": start, "ms": ms,
                         "splits": plan(1, kh, T, h // kh, nb, BS, n_sm, hd)
                         if plan else 1,
                         "forced_ms": forced("prefill_plan", c, hd, cap)}
                print(json.dumps(point), flush=True)
                points.append(point)
    cuda_core = []
    if "simt" in args.parts:
        floor_ms = device_ms(lambda: torch.cuda._sleep(0))
        for name, h, kh, hd, cdt, T, start in SIMT_POINTS:
            c = case(T, start, h, kh, hd, torch.float32, getattr(torch, cdt))
            q, cache, tables = c[:3]
            ms = device_ms(lambda: pac.paged_attention_prefill(
                *c, 1, scale=hd ** -0.5))
            keys = T * start + T * (T + 1) // 2  # each row's keys, summed
            point = {"heads": name, "cache": cdt, "T": T, "start": start,
                     "ms": ms, "floor_ms": floor_ms,
                     "bound_ms": 4 * h * hd * keys / FP32_FLOPS * 1e3,
                     "splits": simt_plan(1, kh, T, h // kh, cache.shape[1],
                                         BS, n_sm, hd) if simt_plan else 1,
                     "forced_ms": forced("simt_prefill_plan", c, hd, 0.0)}
            print(json.dumps(point), flush=True)
            cuda_core.append(point)
            del c, q, cache
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "points": points,
                      "cuda_core": cuda_core}), flush=True)


if __name__ == "__main__":
    main()
