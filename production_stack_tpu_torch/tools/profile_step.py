"""Where one whole-model step's time goes on the GPU.

    python -m production_stack_tpu_torch.tools.profile_step \
        [--model llama-3-8b] [--batch 8] [--ctx 4096] [--prefill 512] \
        [--quantization int4] [--kv-cache-dtype float8_e4m3fn] [--graphs]

Builds the model with random weights on the card (quantized on the card
with ``--quantization``; the KV cache in ``--kv-cache-dtype``, default
the model's; ``PST_FUSED_KV_WRITE=1`` in the environment
selects the fused decode-write kernel), then for a decode step
(``--batch`` rows at position ``--ctx - 1``) and a fresh prefill chunk of
``--prefill`` tokens, through the CUDA kernels: the host wall time per
step (synchronised), the device time per step under ``torch.profiler``
(the union of kernel intervals), the device's idle share of the wall
time, and the kernels that take the most device time. With ``--graphs``
each step is also captured into a CUDA graph (as the engine's runner
captures a bucket) and the same numbers are taken for its replay beside
the eager run's. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Optional

import torch

from ..engine.runner import capture, on_stream
from ..models.llama import Llama
from ..models.registry import get_model_config


def _kernel_events(prof) -> List:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_us(events) -> float:
    """Length of the union of the kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def step_inputs(model: Llama, batch: int, ctx: int, prefill: int,
                block_size: int, device: torch.device,
                kv_dtype: Optional[torch.dtype] = None):
    """A zeroed cache (of ``kv_dtype``, default the model's) and the
    forward arguments (tokens, positions,
    write_idx, block_tables, kv_lens, last_idx) of two steps: a decode step
    of ``batch`` rows at position ``ctx - 1`` and one fresh ``prefill``-token
    chunk. Returns (cache, decode_args, prefill_args)."""
    B, T, bs = batch, prefill, block_size
    W = -(-max(ctx, T) // bs)
    cache = model.make_kv_cache(B * W + 1, bs, dtype=kv_dtype, device=device)
    tables = torch.arange(B * W, dtype=torch.int32, device=device).reshape(B, W)
    i32 = dict(dtype=torch.int32, device=device)
    pos = ctx - 1
    decode = (torch.ones((B, 1), **i32), torch.full((B, 1), pos, **i32),
              tables[:, pos // bs: pos // bs + 1] * bs + pos % bs, tables,
              torch.full((B,), ctx, **i32), torch.zeros(B, **i32))
    chunk = (torch.ones((1, T), **i32), torch.arange(T, **i32)[None],
             torch.arange(T, **i32)[None], tables[:1],
             torch.tensor([T], **i32), torch.tensor([T - 1], **i32))
    return cache, decode, chunk


def profile(fn, steps: int, top: int) -> Dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = _kernel_events(prof)
    by_name: Dict[str, List[float]] = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    busy_ms = _busy_us(kernels) / 1e3 / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernels_per_step": len(kernels) / steps,
        "top": [{"kernel": n[:90], "ms_per_step": t / 1e3 / steps,
                 "launches_per_step": c / steps} for n, (t, c) in ranked],
    }


def replayed(fn):
    """``fn`` captured into a CUDA graph, after one eager run on the
    capture stream (which loads what its kernels load lazily); returns the
    graph's ``replay``."""
    stream = torch.cuda.Stream()
    with on_stream(stream):
        fn()
    graph = torch.cuda.CUDAGraph()
    with on_stream(stream):
        capture(graph, fn)
    return graph.replay


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama-3-8b")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--ctx", type=int, default=4096)
    p.add_argument("--prefill", type=int, default=512)
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--quantization", choices=("int8", "int4"), default=None)
    p.add_argument("--kv-cache-dtype", choices=("float8_e4m3fn",),
                   default=None, help="default: the model dtype")
    p.add_argument("--graphs", action="store_true",
                   help="also time each step replayed from a CUDA graph")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA GPU")
    dev = torch.device("cuda")
    model = Llama(get_model_config(args.model))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen, dev, quantization=args.quantization)
    kv_dtype = getattr(torch, args.kv_cache_dtype or model.cfg.dtype)
    cache, decode, prefill = step_inputs(model, args.batch, args.ctx,
                                         args.prefill, args.block_size, dev,
                                         kv_dtype)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "model": args.model,
              "quantization": args.quantization,
              "kv_cache_dtype": str(kv_dtype),
              "fused_kv_write": os.environ.get("PST_FUSED_KV_WRITE") == "1"}
    for name, batch in (("decode", decode), ("prefill", prefill)):
        def step(batch=batch):
            return model.forward(params, *batch, cache, attn_impl="cuda")

        runs = {"eager": step}
        if args.graphs:
            runs["replayed"] = replayed(step)
        for how, fn in runs.items():
            r = profile(fn, args.steps, args.top)
            result[name if how == "eager" else f"{name}_{how}"] = r
            print(f"{name} ({how}): wall {r['wall_ms']:.2f} ms/step, device "
                  f"busy {r['device_busy_ms']:.2f} ms, idle "
                  f"{r['idle_share']:.1%}, {r['kernels_per_step']:.0f} "
                  "kernels/step", flush=True)
            for row in r["top"]:
                print(f"  {row['ms_per_step']:8.3f} ms  "
                      f"x{row['launches_per_step']:5.0f}  {row['kernel']}",
                      flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
