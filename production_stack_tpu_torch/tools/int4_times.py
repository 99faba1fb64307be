"""Device time of ``int4_matmul`` at Llama-3-8B's projection shapes.

    python -m production_stack_tpu_torch.tools.int4_times [--rows 1 8 16]

For each (din, dout) of the seven per-layer projections (wq/wo 4096 x
4096, wk/wv 4096 x 1024, w_gate/w_up 4096 x 14336, w_down 14336 x 4096)
and each row count, the time of one call through the wrapper (the route it
picks) and of ``torch.matmul`` on the weight dequantized to bf16
beforehand: calls back to back between CUDA events, queued behind a spin
kernel, four weights of the shape in turn (as a step finds each layer's
weights cold), the median of 5 batches of 20. It reads the package from
``sys.path``, so the same script times an older checkout of the package
put first on ``PYTHONPATH``. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # the host queues the batch meanwhile
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, nargs="+", default=[1, 8, 16])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int4_times needs a CUDA GPU")
    from production_stack_tpu_torch.models.llama import quantize_leaf_int4
    from production_stack_tpu_torch.ops import int4_matmul as i4

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    points = []
    for din, dout in SHAPES:
        weights = [quantize_leaf_int4(
            torch.randn((din, dout), generator=gen, device=dev) * 0.02)
            for _ in range(4)]
        dense = [i4.dequant_int4(pk, sc, torch.bfloat16) for pk, sc in weights]
        turn = {"i": 0}

        def nxt():
            turn["i"] = (turn["i"] + 1) % 4
            return turn["i"]

        for N in args.rows:
            x = torch.randn((N, din), generator=gen, device=dev).bfloat16()
            point = {"N": N, "din": din, "dout": dout,
                     "route": i4.route(x, *weights[0]),
                     "ms": device_ms(lambda: i4.int4_matmul(x, *weights[nxt()])),
                     "library_ms": device_ms(
                         lambda: torch.matmul(x, dense[nxt()]))}
            points.append(point)
            print(f"N={N} {din}x{dout} ({point['route']}): {point['ms']:.4f} ms, "
                  f"torch.matmul on bf16 {point['library_ms']:.4f} ms", flush=True)
        del weights, dense
    print(json.dumps({"card": card, "points": points}), flush=True)


if __name__ == "__main__":
    main()
