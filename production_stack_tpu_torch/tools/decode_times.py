"""Device time of the decode kernels and of the int4 CUDA-core route.

    python -m production_stack_tpu_torch.tools.decode_times \
        [--heads llama-3-8b gemma2-9b] [--parts split simt int4] \
        [--splits 1 2 4 8]

``split``: for each preset's attention heads (llama-3-8b: H 32, KH 8,
head_dim 128; gemma2-9b: H 16, KH 8, head_dim 256, softcap 50), over a
bf16 and an e4m3 cache, at B in {1, 8, 64} sequences of 4096 tokens and
64 of 512 (block size 32): the time of one ``paged_attention_decode`` and
one ``paged_attention_decode_write`` call through the wrapper (bf16 q: the
split-KV kernel), the split count the wrapper's plan gives and the byte
bound (each live K/V row read once at 3.35 TB/s, the H100 SXM's
data-sheet rate). ``simt``: the same for
fp32 q on the CUDA-core kernels, at tiny-llama-debug's heads (H = KH = 8,
head_dim 16) over an fp32 and an e4m3 cache at B=8 x 1024, and at
Llama-3-8B's over an fp32 cache at B=8 x 4096, with an empty kernel
queued the same way (``floor_ms``). Four layers of cache in turn, so the
50 MB L2 never holds the keys. ``int4``: ``int4_matmul``'s CUDA-core
route (fp32 x, N 8) at the tiny engine's w_gate (128 x 256) and at
Llama-3-8B's (4096 x 14336, not a served shape; four weights in turn)
beside ``torch.matmul`` on the weight dequantized to fp32 beforehand.
``--splits``: also the decode at each of these split counts, the wrapper's
plan replaced (``forced_ms``), for choosing a plan.
(The port calls no library attention; ``chip_smoke.py`` phase 5 times the
attention yardstick, SDPA, at the same points.)

Each time: calls back to back between CUDA events, queued behind a spin
kernel, the median of 5 batches of 20 (``int4_times.device_ms``). It reads
the package from ``sys.path``, so ``PYTHONPATH=<old checkout> python3
production_stack_tpu_torch/tools/decode_times.py`` times an older
checkout. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import torch

HEADS = {"llama-3-8b": (32, 8, 128, 0.0), "gemma2-9b": (16, 8, 256, 50.0)}
POINTS = ((1, 4096), (8, 4096), (64, 4096), (64, 512))
# The CUDA-core decode's points: (name, H, KH, head_dim, cache, B, kv_len).
SIMT_POINTS = (("tiny-llama-debug", 8, 8, 16, "float32", 8, 1024),
               ("tiny-llama-debug", 8, 8, 16, "float8_e4m3fn", 8, 1024),
               ("llama-3-8b", 32, 8, 128, "float32", 8, 4096))
SIMT_SHAPES = ((8, 128, 256, 1), (8, 4096, 14336, 4))  # N, din, dout, weights
BS = 32
LAYERS = 4
BYTES_PER_S = 3.35e12


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--heads", nargs="+", default=list(HEADS),
                   choices=list(HEADS))
    p.add_argument("--parts", nargs="+", default=["split", "simt", "int4"],
                   choices=["split", "simt", "int4"])
    p.add_argument("--splits", nargs="*", type=int, default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_times needs a CUDA GPU")
    from production_stack_tpu_torch.models.llama import quantize_leaf_int4
    from production_stack_tpu_torch.ops import int4_matmul as i4
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
    by_form = len(inspect.signature(pac.decode_plan).parameters) > 6
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)

    def case(B, kvl, h, kh, hd, q_dtype, cache_dtype):
        """q, a four-layer cache, shuffled tables, lengths, the rows to
        write and their slots."""
        W = kvl // BS
        nb = B * W + 3
        q = torch.randn((B, h, hd), generator=gen, device=dev).to(q_dtype)
        cache = to_cache_dtype(torch.randn(
            (LAYERS, nb, 2, BS, kh * hd), generator=gen, device=dev),
            cache_dtype)
        tables = torch.randperm(nb, generator=gen, device=dev)[
            :B * W].reshape(B, W).to(torch.int32)
        kl = torch.full((B,), kvl, dtype=torch.int32, device=dev)
        k_new = torch.randn((B, kh * hd), generator=gen,
                            device=dev).to(q_dtype)
        v_new = torch.randn_like(k_new)
        wf = (tables[:, -1].long() * BS + BS - 1).to(torch.int32)
        return q, cache, tables, kl, k_new, v_new, wf

    def times(q, cache, tables, kl, k_new, v_new, wf, scale, cap):
        """(decode ms, decode-write ms) through the wrappers, each launch on
        the next layer."""
        turn = {"layer": 0}

        def layer():
            turn["layer"] = (turn["layer"] + 1) % LAYERS
            return turn["layer"]

        dec_ms = device_ms(lambda: pac.paged_attention_decode(
            q, cache, tables, kl, layer(), scale=scale, softcap=cap))
        dw_ms = device_ms(lambda: pac.paged_attention_decode_write(
            q, cache, tables, kl, layer(), k_new, v_new, wf, scale=scale,
            softcap=cap))
        return dec_ms, dw_ms

    def forced(q, cache, tables, kl, scale, cap):
        """The decode's ms at each of ``--splits``, the plans replaced."""
        plans = pac.decode_plan, getattr(pac, "simt_decode_plan", None)
        turn = {"layer": 0}

        def layer():
            turn["layer"] = (turn["layer"] + 1) % LAYERS
            return turn["layer"]

        out = {}
        try:
            for n in args.splits:
                pac.decode_plan = pac.simt_decode_plan = lambda *a, **k: n
                out[n] = device_ms(lambda: pac.paged_attention_decode(
                    q, cache, tables, kl, layer(), scale=scale, softcap=cap))
        finally:
            pac.decode_plan, pac.simt_decode_plan = plans
        return out

    points = []
    for name in args.heads if "split" in args.parts else ():
        h, kh, hd, cap = HEADS[name]
        scale = hd ** -0.5
        for cache_dtype in (torch.bfloat16, E4M3):
            for B, kvl in POINTS:
                c = case(B, kvl, h, kh, hd, torch.bfloat16, cache_dtype)
                dec_ms, dw_ms = times(*c, scale, cap)
                sweep = forced(*c[:4], scale, cap)
                del c
                torch.cuda.empty_cache()
                fp8 = cache_dtype == E4M3
                splits = (pac.decode_plan(B, kh, kvl // BS, BS, n_sm, hd, fp8)
                          if by_form else
                          pac.decode_plan(B, kh, kvl // BS, BS, n_sm, hd))
                nbytes = (B * kvl * 2 * kh * hd * cache_dtype.itemsize
                          + 2 * B * h * hd * 2)
                point = {"heads": name, "cache": str(cache_dtype)[6:],
                         "B": B, "kv_len": kvl, "splits": splits,
                         "decode_ms": dec_ms, "decode_write_ms": dw_ms,
                         "forced_ms": sweep,
                         "bound_ms": nbytes / BYTES_PER_S * 1e3}
                print(json.dumps(point), flush=True)
                points.append(point)
    cuda_core = []
    if "simt" in args.parts:
        floor_ms = device_ms(lambda: torch.cuda._sleep(0))
        plan = getattr(pac, "simt_decode_plan", None)
        for name, h, kh, hd, cdt, B, kvl in SIMT_POINTS:
            cache_dtype = getattr(torch, cdt)
            c = case(B, kvl, h, kh, hd, torch.float32, cache_dtype)
            dec_ms, dw_ms = times(*c, hd ** -0.5, 0.0)
            sweep = forced(*c[:4], hd ** -0.5, 0.0)
            del c
            torch.cuda.empty_cache()
            nbytes = (B * kvl * 2 * kh * hd * cache_dtype.itemsize
                      + 2 * B * h * hd * 4)
            point = {"heads": name, "cache": cdt, "B": B, "kv_len": kvl,
                     "splits": (plan(B, kh, kvl // BS, BS, n_sm, hd,
                                     cache_dtype.itemsize) if plan else 1),
                     "decode_ms": dec_ms, "decode_write_ms": dw_ms,
                     "floor_ms": floor_ms, "forced_ms": sweep,
                     "bound_ms": nbytes / BYTES_PER_S * 1e3}
            print(json.dumps(point), flush=True)
            cuda_core.append(point)
    simt = []
    for N, din, dout, n_w in SIMT_SHAPES if "int4" in args.parts else ():
        weights = [quantize_leaf_int4(
            torch.randn((din, dout), generator=gen, device=dev) * 0.02)
            for _ in range(n_w)]
        dense = [i4.dequant_int4(pk, sc, torch.float32) for pk, sc in weights]
        x = torch.randn((N, din), generator=gen, device=dev)
        turn = {"i": 0}

        def nxt():
            turn["i"] = (turn["i"] + 1) % n_w
            return turn["i"]

        G = din // weights[0][1].shape[0]
        nbytes = din * dout // 2 + (din // G) * dout * 4 + N * (din + dout) * 4
        point = {"N": N, "din": din, "dout": dout, "G": G,
                 "route": i4.route(x, *weights[0]),
                 "ms": device_ms(lambda: i4.int4_matmul(x, *weights[nxt()])),
                 "library_ms": device_ms(
                     lambda: torch.matmul(x, dense[nxt()])),
                 "bytes_ms": nbytes / BYTES_PER_S * 1e3,
                 "ops_ms": 2 * N * din * dout / 67e12 * 1e3}
        print(json.dumps(point), flush=True)
        simt.append(point)
        del weights, dense
    print(json.dumps({"card": card, "points": points, "cuda_core": cuda_core,
                      "int4_simt": simt}), flush=True)


if __name__ == "__main__":
    main()
