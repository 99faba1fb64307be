#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases, in order; any exception, mismatch or NaN exits non-zero:

1. Device and toolchain: the card's name and power limit, CUDA and nvcc
   versions; the CUDA kernels are built from ``production_stack_tpu_torch/
   ops/csrc`` (one nvcc per source, in parallel) and the build time
   printed.
2. Each kernel against its plain PyTorch version: the attention kernels
   at Llama-3-8B attention shapes (H=32, KH=8, hd=128, bs=32) in bf16 (the
   wgmma prefill kernel also at every head-group size with a window that
   starts mid-page and a softcap, a ragged T, three sequences at different
   starts with a kv_len 0 row, T=2048 fresh and T=512 at start 3584), plus
   small fp32 cases with a sliding window and a softcap and the other
   head-group sizes; the decode-write kernel's cache must equal its plain
   version's bit for bit; the split-KV decode and decode-write kernels in
   bf16 at every head-group size with a window that starts mid-page and a
   softcap, over ragged lengths (0 to 4096: short rows get empty splits),
   at one sequence of 4096 (the most splits), with a write 5 positions
   before a row's end and a dropped write, and two launches bit for bit
   equal; the W4A16 int4 kernels at every Llama-3-8B projection shape:
   the decode route at N in {1, 2, 8, 16} and every decode bucket up to
   its boundary, the wgmma route at N in {17, 64, 300, 512, 2048}; the
   decode route also at a ragged dout (208), an odd dout (201), a group
   size wgmma refuses (48, up to 300 rows) and unaligned x and packed
   pointers, two of its launches bit for bit equal, and the resident
   blocks its plan counts on (the occupancy calculator); small shapes in
   fp32 against float64. Negative controls show the bf16 checks reject a
   decode missing a key, a prefill whose rows each miss one key and an
   int4 product with swapped nibbles (on both bf16 int4 routes); on CUDA
   tensors a wrapper refuses what its kernel does not take.
3. The full-width 32-layer Llama-3-8B (random bf16 weights from a seed):
   one 512-token prefill and 8 decode steps through the kernels and again
   through the gather path; the logits must agree, and every decode
   launch must have taken the split-KV kernel. A decode step, a
   sampled draw and a prefill chunk then run under CUDA's sync debug mode
   set to raise (no host sync), and the unembed is held to a float32
   product.
4. Serving: the port's OpenAI server on localhost answers completions
   (streamed, chunked-prefill, concurrent); the kernels' launch counters
   are zeroed just before and must have grown by its end.
3b. The same model int4-quantized on the card (streamed from the seed, the
   bf16 tree freed first), under ``PST_FUSED_KV_WRITE=1``: the same steps
   through the int4 and decode-write kernels, against the gather path on a
   copy whose int4 weights were dequantized to bf16 beforehand; every
   decode-row projection on the decode route, with no split-sum pass.
4b. Serving int4 with ``PST_FUSED_KV_WRITE=1``: a second engine and server
   after the first is shut down; the int4, decode-write and prefill
   counters must grow.
5. Times of each kernel at the slice's shapes beside its plain version, a
   PyTorch call as a yardstick where one computes the same function, and
   its bound: decode at B=8, 1 and 64 at kv_len 4096 and at B=64 x 512
   (with the split count of each), decode-write at B=8 x 4096; prefill at T=512 fresh, T=512 at start 3584 and T=2048
   fresh; the int4 wgmma route at N=512 for the four projection shapes and
   at N=2048; the int4 decode route at N in {1, 8, 16} (and the decode
   buckets up to its boundary) for the four projection shapes; both bf16
   int4 routes at N in {1, 8, 16, 32, 64} on the four shapes (the route
   boundary's crossover).

The line before the last is a JSON ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import http.client
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA GPU is available")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine  # noqa: E402
from production_stack_tpu_torch.engine.config import EngineConfig  # noqa: E402
from production_stack_tpu_torch.engine.server import serve_in_thread  # noqa: E402
from production_stack_tpu_torch.models.llama import (  # noqa: E402
    Llama,
    quantize_leaf_int4,
    unembed_logits,
)
from production_stack_tpu_torch.models.registry import get_model_config  # noqa: E402
from production_stack_tpu_torch.ops import _build  # noqa: E402
from production_stack_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from production_stack_tpu_torch.ops import paged_attention_cuda as pac  # noqa: E402
from production_stack_tpu_torch.ops.sampling import (  # noqa: E402
    apply_logit_bias,
    sample_tokens_packed,
)
from production_stack_tpu_torch.tools.profile_step import step_inputs  # noqa: E402

DEV = torch.device("cuda")
MODEL = "llama-3-8b"
H, KH, HD, BS = 32, 8, 128, 32  # Llama-3-8B attention shapes
SCALE = HD ** -0.5

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# bf16 keeps about 3 significant decimal digits and the kernel sums in a
# different order than the plain version: 2e-2 of the largest magnitude of
# the same output row (one head of one query), so a row over 4000 keys is
# held to its own small scale and not to that of a one-key row.
BF16_REL_ATOL = 2e-2
# fp32 inputs, fp32 accumulation in both, only the summation order differs.
FP32_ATOL = 1e-4
# The int4 kernel in fp32 against the float64 product: the TPU kernel's own
# rule (tests/test_int4_matmul.py), a share of the largest |ref|.
INT4_FP32_REL = 1e-5
# Logits of 32 bf16 layers computed in a different order (kernel vs gather).
MODEL_REL_ATOL = 5e-2

SOURCE = "production_stack_tpu_torch/ops/csrc/decode_splitkv.cu"
KERNELS = {
    "decode": dict(
        name="paged_attention_decode", route="cuda", source=SOURCE,
        replaces="production_stack_tpu/ops/paged_attention_pallas.py:218",
    ),
    "prefill": dict(
        name="paged_attention_prefill", route="cuda",
        source="production_stack_tpu_torch/ops/csrc/prefill_wgmma.cu",
        replaces="production_stack_tpu/ops/paged_attention_pallas.py:430",
    ),
    "decode_write": dict(
        name="paged_attention_decode_write", route="cuda", source=SOURCE,
        replaces="production_stack_tpu/ops/paged_attention_pallas.py:301",
    ),
    "int4": dict(
        name="int4_matmul", route="cuda",
        source="production_stack_tpu_torch/ops/csrc/int4_decode.cu",
        replaces="production_stack_tpu/ops/int4_matmul.py:73",
    ),
    "int4_wgmma": dict(
        name="int4_matmul_wgmma", route="cuda",
        source="production_stack_tpu_torch/ops/csrc/int4_matmul.cu",
        replaces="production_stack_tpu/ops/int4_matmul.py:73",
    ),
}
# Which launch counter of the served run belongs to each row: the route
# of the kernel the row times (the int4 wrapper's two bf16 routes are two
# kernels).
ROUTE_OF = {"prefill": "prefill_wgmma", "int4": "decode", "int4_wgmma": "wgmma",
            "decode": "decode_split", "decode_write": "decode_write_split"}
max_err = {k: 0.0 for k in KERNELS}

# Llama-3-8B projections: (din, dout) of wq/wo, wk/wv, w_gate/w_up, w_down.
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# The seven projections of a layer, in that order: wq, wk, wv, wo, w_gate,
# w_up, w_down.
LAYER_SHAPES = ((4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                (4096, 14336), (4096, 14336), (14336, 4096))
# The engine's decode buckets (powers of two up to max_num_seqs = 64).
DECODE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Phase 1: device and toolchain
# ---------------------------------------------------------------------------


def phase_toolchain() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log("nvcc: " + nvcc[-1])
    t0 = time.perf_counter()
    _build.load()
    log(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.last_build_seconds:.1f}s) -> {_build.library_path()}")
    ptxas = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    for line in ptxas:
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    return smi


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_case(gen, *, B, T, kv_lens, starts=None, dtype=torch.bfloat16,
              h=H, kh=KH, layers=2, extra_pages=3):
    """Random q and a paged cache whose pages each row reaches through a
    shuffled block table. Returns q [B,T,h,HD], cache, tables, kv_lens,
    starts (all on the card)."""
    W = max(-(-max(kv_lens) // BS), 1)
    nb = B * W + extra_pages
    q = torch.randn((B, T, h, HD), generator=gen, device=DEV).to(dtype)
    cache = torch.randn((layers, nb, 2, BS, kh * HD), generator=gen,
                        device=DEV).to(dtype)
    perm = torch.randperm(nb, generator=gen, device=DEV)[: B * W]
    tables = perm.reshape(B, W).to(torch.int32).contiguous()
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=DEV)
    st = torch.tensor(starts if starts is not None else [0] * B,
                      dtype=torch.int32, device=DEV)
    return q, cache, tables, lens, st


def bf16_row_check(got: torch.Tensor, ref: torch.Tensor):
    """One tolerance per output row (the last axis): 2e-2 of that row's
    largest |ref|, so a row with no live key must be exactly 0. Returns
    (all rows within, worst err / row tol, smallest nonzero row tol)."""
    diff = (got.float() - ref.float()).abs()
    tol = BF16_REL_ATOL * ref.float().abs().amax(-1, keepdim=True)
    ratio = float((diff / tol.clamp_min(1e-30)).max())
    return bool((diff <= tol).all()), ratio, float(tol[tol > 0].min())


def compare(kind: str, got: torch.Tensor, ref: torch.Tensor,
            label: str, rows: bool = False) -> float:
    """bf16 outputs (or ``rows``: fp32 outputs of bf16 inputs) are held to
    the per-row tolerance; other fp32 outputs to FP32_ATOL."""
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    if got.dtype == torch.bfloat16 or rows:
        ok, ratio, smallest = bf16_row_check(got, ref)
        log(f"  {label}: max|err| {err:.3e}, worst err / row tol "
            f"{ratio:.3f} (row tol 2e-2·max|ref row|, smallest {smallest:.3e})")
        max_err[kind] = max(max_err[kind], err)
        check(ok, f"{label}: kernel disagrees with its plain version")
    else:
        log(f"  {label}: max|err| {err:.3e} (tol {FP32_ATOL:.1e})")
        check(err <= FP32_ATOL,
              f"{label}: kernel disagrees with its plain version")
    return err


def run_decode(q3, cache, tables, lens, layer, **kw):
    got = pac.paged_attention_decode(q3, cache, tables, lens, layer,
                                     scale=SCALE, **kw)
    ref = pac.paged_attention_decode_plain(q3, cache, tables, lens, layer,
                                           scale=SCALE, **kw)
    torch.cuda.synchronize()
    return got, ref


def run_prefill(q, cache, tables, lens, starts, layer, **kw):
    got = pac.paged_attention_prefill(q, cache, tables, lens, starts, layer,
                                      scale=SCALE, **kw)
    ref = pac.paged_attention_prefill_plain(q, cache, tables, lens, starts,
                                            layer, scale=SCALE, **kw)
    torch.cuda.synchronize()
    return got, ref


def phase_kernels() -> None:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)

    # Decode, bf16: lengths 0 (padding row), 1, a page minus/at/plus one,
    # about 4k.
    lens = [0, 1, 31, 32, 33, 4096, 4000, 777]
    q, cache, tables, kl, _ = make_case(gen, B=8, T=1, kv_lens=lens)
    got, ref = run_decode(q[:, 0], cache, tables, kl, 1)
    check(bool((got[0] == 0).all()), "decode: kv_len 0 row must be zeros")
    compare("decode", got, ref, f"decode bf16 B=8 kv_lens={lens}")
    # The check has teeth: the plain version with the last key of each long
    # row dropped (a kernel that misses one key of 4096 or 4000) fails it.
    wrong = pac.paged_attention_decode_plain(q[:, 0], cache, tables, kl - 1, 1,
                                             scale=SCALE)
    ok, ratio, _ = bf16_row_check(wrong[5:7], ref[5:7])
    log(f"  a decode that drops the last of 4096/4000 keys: worst err / row "
        f"tol {ratio:.3f}")
    check(not ok, "the bf16 row check passes a decode that drops a key")
    check(torch.equal(got, pac.paged_attention_decode(q[:, 0], cache, tables,
                                                      kl, 1, scale=SCALE)),
          "decode: two launches on the same inputs differ")
    # One sequence at 4096 (the most splits the plan gives), and every
    # head-group size with a window that starts mid-page and a softcap,
    # over the same ragged lengths (short rows get empty splits).
    q, cache, tables, kl, _ = make_case(gen, B=1, T=1, kv_lens=[4096])
    got, ref = run_decode(q[:, 0], cache, tables, kl, 1)
    compare("decode", got, ref, f"decode bf16 B=1 kv_len 4096 ({splits_of(q, cache, tables)} splits)")
    for h, kh in ((8, 8), (16, 8), (H, KH), (16, 2)):
        q, cache, tables, kl, _ = make_case(gen, B=8, T=1, kv_lens=lens,
                                            h=h, kh=kh)
        got, ref = run_decode(q[:, 0], cache, tables, kl, 0, window=45,
                              softcap=30.0)
        check(bool((got[0] == 0).all()), "decode: kv_len 0 row must be zeros")
        compare("decode", got, ref,
                f"decode bf16 G={h // kh} window=45 softcap=30 "
                f"({splits_of(q, cache, tables)} splits)")
    check(pac.route_counts["decode_simt"] == 0,
          "a bf16 decode took the fp32 kernel")

    # Prefill, bf16 (the wgmma kernel): T=512 fresh, T=512 continuing at
    # 1000 and at 3584, T=300 ragged, T=2048 fresh.
    for T, start in ((512, 0), (512, 1000), (512, 3584), (300, 77),
                     (2048, 0)):
        q, cache, tables, kl, st = make_case(
            gen, B=2, T=T, kv_lens=[start + T, start + T],
            starts=[start, start])
        got, ref = run_prefill(q, cache, tables, kl, st, 1)
        compare("prefill", got, ref, f"prefill bf16 B=2 T={T} start={start}")
        if T == 512 and start == 0:
            # The check has teeth: the plain version with every row's last
            # key dropped (each row one position earlier) fails it, on the
            # rows that keep a key.
            wrong = pac.paged_attention_prefill_plain(
                q, cache, tables, kl, st - 1, 1, scale=SCALE)
            ok, ratio, _ = bf16_row_check(got[:, 1:], wrong[:, 1:])
            log(f"  a prefill whose rows each miss their last key: worst err "
                f"/ row tol {ratio:.3f}")
            check(not ok, "the bf16 row check passes a prefill that drops a key")
    # Three sequences at different starts, the middle one with kv_len 0:
    # its rows see no key and must be exactly zero.
    q, cache, tables, kl, st = make_case(
        gen, B=3, T=100, kv_lens=[100, 0, 1100], starts=[0, 300, 1000])
    got, ref = run_prefill(q, cache, tables, kl, st, 1)
    check(bool((got[1] == 0).all()), "prefill: kv_len 0 rows must be zeros")
    compare("prefill", got, ref,
            "prefill bf16 B=3 T=100 starts=[0, 300, 1000] kv_lens=[100, 0, "
            "1100]")
    # Every head-group size, with a window that starts mid-page and a
    # softcap.
    for h, kh in ((8, 8), (16, 8), (H, KH), (16, 2)):
        q, cache, tables, kl, st = make_case(
            gen, B=2, T=70, kv_lens=[270, 70], starts=[200, 0], h=h, kh=kh)
        got, ref = run_prefill(q, cache, tables, kl, st, 0, window=45,
                               softcap=30.0)
        compare("prefill", got, ref,
                f"prefill bf16 G={h // kh} T=70 window=45 softcap=30")
    check(pac.route_counts["prefill_simt"] == 0,
          "a bf16 prefill took the fp32 kernel")

    # fp32 with a window that starts mid-page and a softcap, and every head
    # group size the kernels are compiled for.
    for h, kh in ((H, KH), (8, 8), (16, 2), (4, 2)):
        lens = [0, 50, 300, 1000]
        q, cache, tables, kl, _ = make_case(
            gen, B=4, T=1, kv_lens=lens, dtype=torch.float32, h=h, kh=kh)
        got, ref = run_decode(q[:, 0], cache, tables, kl, 0, window=100,
                              softcap=30.0)
        compare("decode", got, ref,
                f"decode fp32 H={h} KH={kh} window=100 softcap=30")
        q, cache, tables, kl, st = make_case(
            gen, B=2, T=70, kv_lens=[270, 70], starts=[200, 0],
            dtype=torch.float32, h=h, kh=kh)
        got, ref = run_prefill(q, cache, tables, kl, st, 0, window=45,
                               softcap=30.0)
        compare("prefill", got, ref,
                f"prefill fp32 H={h} KH={kh} T=70 window=45 softcap=30")
        got, ref = run_prefill(q, cache, tables, kl, st, 1)
        compare("prefill", got, ref, f"prefill fp32 H={h} KH={kh} T=70")

    # On the card a wrapper launches its kernel or raises: never the plain
    # version.
    q, cache, tables, kl, _ = make_case(gen, B=2, T=1, kv_lens=[5, 9])
    refused = (
        (NotImplementedError, (q[:, 0], cache.to(torch.float8_e4m3fn))),
        (ValueError, (q[:, 0, :, :64].contiguous(), cache[..., :512].contiguous())),
        (ValueError, (q[:, 0].transpose(0, 1).contiguous().transpose(0, 1), cache)),
    )
    for err, (qq, cc) in refused:
        try:
            pac.paged_attention_decode(qq, cc, tables, kl, 0, scale=SCALE)
        except err:
            continue
        raise AssertionError(f"decode wrapper accepted what it must refuse ({err})")
    log("  wrappers refuse fp8 caches, head_dim 64 and non-contiguous q")


def write_slots(tables, positions, drop_rows, nb):
    """Flat write slot of each row's position (``nb * BS``: dropped)."""
    slots = [int(tables[i, p // BS]) * BS + p % BS
             for i, p in enumerate(positions)]
    for i in drop_rows:
        slots[i] = nb * BS
    return torch.tensor(slots, dtype=torch.int32, device=DEV)


def splits_of(q, cache, tables) -> int:
    """The split count the decode wrapper's plan gives these inputs."""
    _, _, _, bs, lanes = cache.shape
    return pac.decode_plan(q.shape[0], lanes // HD, tables.shape[1], bs,
                           torch.cuda.get_device_properties(0).multi_processor_count)


def run_decode_write(q3, cache, tables, lens, layer, k_new, v_new, wf, **kw):
    """Kernel and plain version, each on its own copy of the cache; the
    caches must come out bit for bit equal, and the rows must have landed."""
    got_cache, ref_cache = cache.clone(), cache.clone()
    got = pac.paged_attention_decode_write(q3, got_cache, tables, lens, layer,
                                           k_new, v_new, wf, scale=SCALE, **kw)
    ref = pac.paged_attention_decode_write_plain(
        q3, ref_cache, tables, lens, layer, k_new, v_new, wf, scale=SCALE, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got_cache, ref_cache),
          "decode_write: the kernel's cache differs from its plain version's")
    check(not torch.equal(got_cache, cache), "decode_write: nothing written")
    return got, ref


def phase_decode_write_kernels() -> None:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4321)
    # bf16 at the decode shapes: lengths 1, 33, ~4k; row 3 drops its write
    # (and reads its cache as it was), row 2 writes 5 positions before its
    # end (the kernel reads the row back from the cache, wherever it is).
    lens = [1, 33, 4096, 4000, 777, 31, 32, 100]
    q, cache, tables, kl, _ = make_case(gen, B=8, T=1, kv_lens=lens)
    pos = [n - 1 for n in lens]
    pos[2] -= 5
    wf = write_slots(tables, pos, [3], cache.shape[1])
    k_new = torch.randn((8, KH * HD), generator=gen, device=DEV).bfloat16()
    v_new = torch.randn((8, KH * HD), generator=gen, device=DEV).bfloat16()
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 1, k_new, v_new, wf)
    compare("decode_write", got, ref,
            f"decode_write bf16 B=8 kv_lens={lens} (row 3 dropped): caches "
            "equal;")
    again = pac.paged_attention_decode_write(
        q[:, 0], cache.clone(), tables, kl, 1, k_new, v_new, wf, scale=SCALE)
    check(torch.equal(got, again),
          "decode_write: two launches on the same inputs differ")
    # The ragged lengths of the decode checks (the kv_len 0 row drops its
    # write, row 5 writes 5 positions before its end) at every head-group
    # size with a window that starts mid-page and a softcap; one sequence
    # at 4096 with the most splits.
    lens = [0, 1, 31, 32, 33, 4096, 4000, 777]
    for h, kh in ((8, 8), (16, 8), (H, KH), (16, 2)):
        q, cache, tables, kl, _ = make_case(gen, B=8, T=1, kv_lens=lens,
                                            h=h, kh=kh)
        pos = [max(n - 1, 0) for n in lens]
        pos[5] -= 5
        wf = write_slots(tables, pos, [0], cache.shape[1])
        k_new = torch.randn((8, kh * HD), generator=gen, device=DEV).bfloat16()
        v_new = torch.randn((8, kh * HD), generator=gen, device=DEV).bfloat16()
        got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new,
                                    v_new, wf, window=45, softcap=30.0)
        check(bool((got[0] == 0).all()),
              "decode_write: kv_len 0 row must be zeros")
        compare("decode_write", got, ref,
                f"decode_write bf16 G={h // kh} window=45 softcap=30 (row 0 "
                f"dropped, {splits_of(q, cache, tables)} splits): caches equal;")
    q, cache, tables, kl, _ = make_case(gen, B=1, T=1, kv_lens=[4096])
    wf = write_slots(tables, [4095], [], cache.shape[1])
    k_new = torch.randn((1, KH * HD), generator=gen, device=DEV).bfloat16()
    v_new = torch.randn((1, KH * HD), generator=gen, device=DEV).bfloat16()
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 1, k_new, v_new, wf)
    compare("decode_write", got, ref,
            f"decode_write bf16 B=1 kv_len 4096 ({splits_of(q, cache, tables)} "
            "splits): caches equal;")
    check(pac.route_counts["decode_write_simt"] == 0,
          "a bf16 decode-write took the fp32 kernel")
    # fp32 with a window that starts mid-page and a softcap.
    lens = [50, 300, 1000, 7]
    q, cache, tables, kl, _ = make_case(gen, B=4, T=1, kv_lens=lens,
                                        dtype=torch.float32)
    wf = write_slots(tables, [n - 1 for n in lens], [1], cache.shape[1])
    k_new = torch.randn((4, KH * HD), generator=gen, device=DEV)
    v_new = torch.randn((4, KH * HD), generator=gen, device=DEV)
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new, v_new,
                                wf, window=100, softcap=30.0)
    compare("decode_write", got, ref,
            "decode_write fp32 window=100 softcap=30 (row 1 dropped): caches "
            "equal;")


def int4_case(gen, N, din, dout, dtype=torch.bfloat16):
    """x [N, din] and a random [din, dout] weight quantized on the card."""
    w = torch.randn((din, dout), generator=gen, device=DEV) * 0.02
    packed, scales = quantize_leaf_int4(w)
    x = torch.randn((N, din), generator=gen, device=DEV).to(dtype)
    return x, packed, scales


def int4_weights(gen, din, dout, G=None, offset=0):
    """packed [din/2, dout] and scales: quantized from a random weight, or
    (G given) random bytes and scales at group size G; ``offset`` bytes
    into their buffer, so the packed pointer is unaligned."""
    if G is None:
        w = torch.randn((din, dout), generator=gen, device=DEV) * 0.02
        packed, scales = quantize_leaf_int4(w)
    else:
        packed = torch.randint(-128, 128, (din // 2, dout), generator=gen,
                               device=DEV, dtype=torch.int8)
        scales = torch.rand((din // G, dout), generator=gen, device=DEV) * 0.01
    if offset:
        buf = torch.empty(packed.numel() + offset, dtype=torch.int8, device=DEV)
        packed = buf[offset:].view(packed.shape).copy_(packed)
    return packed, scales


def int4_check(x, packed, scales, label, want_route):
    route = i4.route(x, packed, scales)
    check(route == want_route, f"{label}: route {route}, expected {want_route}")
    got = i4.int4_matmul(x, packed, scales)
    ref = i4.int4_matmul_plain(x, packed, scales)
    torch.cuda.synchronize()
    N, dout = x.shape[0], packed.shape[1]
    check(got.dtype == torch.float32 and got.shape == (N, dout),
          f"int4: output {got.dtype} {tuple(got.shape)}")
    compare("int4_wgmma" if route == "wgmma" else "int4", got, ref,
            f"{label} ({route})", rows=True)
    return got


def phase_int4_kernels() -> None:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(777)
    # bf16 (tensor-core routes): every projection shape at decode rows (1, 2
    # and every bucket up to the decode route's boundary) and at 17, 64,
    # 300, 512 and 2048 rows (the wgmma kernel above the boundary).
    edge = i4._DECODE_MAX_ROWS
    decode_rows = sorted({1, 2, 8, 16} | {b for b in DECODE_BUCKETS if b <= edge})
    for din, dout in INT4_SHAPES:
        packed, scales = int4_weights(gen, din, dout)
        for N in decode_rows + [17, 64, 300, 512, 2048]:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            int4_check(x, packed, scales, f"int4 bf16 N={N} din={din} dout={dout}",
                       "decode" if N <= edge else "wgmma")
    # The decode route's other calls: a ragged dout (208: both routes), an
    # odd dout and a group of 48 (wgmma refuses both, at any N), unaligned x
    # and packed pointers (wgmma needs 16 bytes).
    for din, dout, G, rows, poff, xoff in (
            (256, 208, None, (1, 8, 16, 40, 300), 0, 0),
            (256, 201, None, (3, 8, 16, 40), 0, 0),
            (4608, 256, 48, (8, 40, 300), 0, 0),
            (1024, 256, None, (8, 40), 1, 1)):
        packed, scales = int4_weights(gen, din, dout, G, poff)
        for N in rows:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            if xoff:
                buf = torch.empty(x.numel() + xoff, dtype=torch.bfloat16, device=DEV)
                x = buf[xoff:].view(x.shape).copy_(x)
            tag = f" G={G}" if G else ""
            tag += " unaligned x, packed" if xoff else ""
            wgmma_ok = (dout % 16 == 0 and G is None and not xoff and N > edge)
            int4_check(x, packed, scales,
                       f"int4 bf16 N={N} din={din} dout={dout}{tag}",
                       "wgmma" if wgmma_ok else "decode")
    # Determinism (the splits add up in split order) and the resident
    # blocks the plan counts on.
    for din, dout in INT4_SHAPES:
        packed, scales = int4_weights(gen, din, dout)
        for N in (1, 8, 16):
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            a = i4.int4_matmul(x, packed, scales)
            b = i4.int4_matmul(x, packed, scales)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"int4 decode N={N} {din}x{dout}: two "
                  "launches differ")
            nt, mt = i4.decode_tile(N, din, dout, 128)
            p = i4.plan("decode", N, din, dout, 128)
            held = i4.decode_occupancy(nt, mt, p.per_split)
            want = i4._DECODE_BLOCKS_PER_SM[(nt, mt)]
            check(held >= want, f"int4 decode ({nt}, {mt}): an SM holds {held} "
                  f"blocks, the plan counts on {want}")
            log(f"  int4 decode N={N} {din}x{dout}: tile ({nt}, {mt}), grid "
                f"{p.grid}, {p.per_split} groups a split; an SM holds {held} "
                f"blocks (plan: {want}); two launches bit for bit equal")
    # The check has teeth on both routes: the kernel's product against a
    # plain version with the two nibble planes of every byte swapped fails.
    x64 = torch.randn((64, 4096), generator=gen, device=DEV).bfloat16()
    _, packed, scales = int4_case(gen, 1, 4096, 4096)
    swapped = torch.bitwise_left_shift(packed, 4) | ((packed >> 4) & 0x0F)
    for x in (x64[:8].contiguous(), x64):
        got = i4.int4_matmul(x, packed, scales)
        ok, ratio, _ = bf16_row_check(got, i4.int4_matmul_plain(x, swapped,
                                                                scales))
        log(f"  int4 N={x.shape[0]} ({i4.route(x, packed, scales)}) against a "
            f"product with swapped nibble planes: worst err / row tol "
            f"{ratio:.3f}")
        check(not ok, "the int4 row check passes swapped nibbles")

    # fp32 (CUDA-core route) against the float64 product: 128-row groups,
    # and a group-16 tiny shape; bf16 with group 8 and a ragged dout takes
    # the CUDA-core route too.
    for N, din, dout, dtype in ((5, 1024, 256, torch.float32),
                                (3, 48, 16, torch.float32),
                                (3, 24, 40, torch.bfloat16)):
        x, packed, scales = int4_case(gen, N, din, dout, dtype)
        got = i4.int4_matmul(x, packed, scales)
        ref = x.double() @ i4.dequant_int4(packed, scales, torch.float64)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "int4: non-finite output")
        err = float((got.double() - ref).abs().max())
        tol = INT4_FP32_REL * float(ref.abs().max())
        G = din // scales.shape[0]
        log(f"  int4 {str(dtype)[6:]} N={N} din={din} dout={dout} G={G} vs "
            f"float64: max|err| {err:.3e} (tol {tol:.3e})")
        check(err <= tol, "int4 kernel disagrees with the float64 product")

    x, packed, scales = int4_case(gen, 4, 256, 128)
    refused = (
        (TypeError, (x.half(), packed, scales)),
        (ValueError, (x.t().contiguous().t(), packed, scales)),
        (ValueError, (x, packed, scales[:, :64].contiguous())),
    )
    for err, args in refused:
        try:
            i4.int4_matmul(*args)
        except err:
            continue
        raise AssertionError(f"int4 wrapper accepted what it must refuse ({err})")
    log("  int4 wrapper refuses fp16 x, non-contiguous x and mismatched scales")


# ---------------------------------------------------------------------------
# Phase 3: the full-width model, kernels vs gather
# ---------------------------------------------------------------------------


def build_model(seed: int = 0):
    cfg = get_model_config(MODEL)
    model = Llama(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(gen, DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[phase 3] {MODEL}: {cfg.num_layers} layers, {n / 1e9:.2f}B params "
        f"{cfg.dtype} on {DEV} in {time.perf_counter() - t0:.1f}s")
    return model, params


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def drive_model(model, params, impl: str, prompt, decode_tokens):
    """One prefill of ``prompt`` then one decode step per token of
    ``decode_tokens``; returns the logits of every step [1 + n, V]."""
    cfg = model.cfg
    T = len(prompt)
    nb = -(-(T + len(decode_tokens)) // BS) + 1
    cache = model.make_kv_cache(nb, BS, device=DEV)
    tables = torch.arange(nb - 1, dtype=torch.int32, device=DEV)[None].flip(1)
    tables = tables.contiguous()  # pages in reverse: a real indirection
    drop = nb * BS

    def slot(p):
        return int(tables[0, p // BS]) * BS + p % BS

    toks = torch.tensor([prompt], dtype=torch.int32, device=DEV)
    pos = torch.arange(T, dtype=torch.int32, device=DEV)[None]
    widx = torch.tensor([[slot(p) for p in range(T)]], dtype=torch.int32,
                        device=DEV)
    out = []
    logits, cache = model.forward(
        params, toks, pos, widx, tables,
        torch.tensor([T], dtype=torch.int32, device=DEV),
        torch.tensor([T - 1], dtype=torch.int32, device=DEV), cache,
        attn_impl=impl)
    out.append(logits[0])
    for i, tok in enumerate(decode_tokens):
        p = T + i
        # Row 1 is a padding row: kv_len 0, write dropped.
        logits, cache = model.forward(
            params,
            torch.tensor([[tok], [0]], dtype=torch.int32, device=DEV),
            torch.tensor([[p], [0]], dtype=torch.int32, device=DEV),
            torch.tensor([[slot(p)], [drop]], dtype=torch.int32, device=DEV),
            torch.cat([tables, torch.zeros_like(tables)]),
            torch.tensor([p + 1, 0], dtype=torch.int32, device=DEV),
            torch.zeros(2, dtype=torch.int32, device=DEV), cache,
            attn_impl=impl)
        out.append(logits[0])
    torch.cuda.synchronize()
    return torch.stack(out), cache


def phase_model(model, params) -> dict:
    cfg = model.cfg
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(1, cfg.vocab_size, (512,), generator=gen).tolist()
    decode_tokens = torch.randint(1, cfg.vocab_size, (8,), generator=gen).tolist()

    pac.reset_launch_counts()
    t0 = time.perf_counter()
    got, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    t_cuda = time.perf_counter() - t0
    counts = dict(pac.launch_counts)
    check(counts == {"prefill": cfg.num_layers,
                     "decode": cfg.num_layers * len(decode_tokens),
                     "decode_write": 0},
          f"launch counts {counts}: expected one per layer per step")
    want = {k: 0 for k in pac.route_counts}
    want.update(prefill_wgmma=cfg.num_layers,
                decode_split=cfg.num_layers * len(decode_tokens))
    check(pac.route_counts == want,
          f"routes {pac.route_counts}: expected the wgmma prefill and the "
          "split-KV decode")
    t0 = time.perf_counter()
    ref, _ = drive_model(model, params, "gather", prompt, decode_tokens)
    t_gather = time.perf_counter() - t0

    check(bool(torch.isfinite(got).all()), "model: non-finite logits (cuda)")
    check(bool(torch.isfinite(ref).all()), "model: non-finite logits (gather)")
    check(got.shape == (1 + len(decode_tokens), cfg.vocab_size),
          f"model: logits shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    tol = MODEL_REL_ATOL * float(ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"  512-token prefill + 8 decode steps: max|logit| "
        f"{float(ref.abs().max()):.3f}, max|cuda - gather| {err:.4f} "
        f"(tol {tol:.4f}), argmax agreement {agree:.2f}; "
        f"cuda {t_cuda:.2f}s, gather {t_gather:.2f}s (first calls)")
    check(err <= tol, "model: the kernel path disagrees with the gather path")
    return {"prefill_chunk": counts["prefill"],
            "decode_step": counts["decode"] // len(decode_tokens)}


def phase_no_host_sync(model, params) -> None:
    """One decode step (with a padding row whose write is dropped), a
    sampled draw with a logit bias, and one prefill chunk (with dropped
    tail writes), under CUDA's sync debug mode set to raise: the forward
    and the sampler never make the host wait for the card, so a decode
    burst chains its steps on the device. Also holds the bf16 unembed to
    a float32 product of the same operands (its accumulator is kept)."""
    cfg = model.cfg
    B, V = 4, cfg.vocab_size
    cache, dec, pre = step_inputs(model, B, 256, 64, BS, DEV)
    drop = cache.shape[1] * BS
    dec, pre = [t.clone() for t in dec], [t.clone() for t in pre]
    dec[2][B - 1] = drop  # write_idx of a padding row ...
    dec[4][B - 1] = 0  # ... with no live key
    pre[2][0, -8:] = drop  # a padded tail
    f32 = dict(dtype=torch.float32, device=DEV)
    sampling = (torch.full((B,), 0.8, **f32), torch.full((B,), 0.9, **f32),
                torch.full((B,), 50, dtype=torch.int32, device=DEV),
                torch.zeros(B, **f32), torch.arange(B))  # seeds stay on host
    bias_ids = torch.tensor([[5, V]] * B, dtype=torch.int32, device=DEV)
    bias_vals = torch.tensor([[3.0, 1.0]] * B, **f32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.forward(params, *dec, cache)
        packed = sample_tokens_packed(
            apply_logit_bias(logits, bias_ids, bias_vals), *sampling)
        model.forward(params, *pre, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(packed.shape == (B, 1) and bool(torch.isfinite(logits).all()),
          "no-sync step: bad output")
    log("  decode step, sampling with a logit bias and a prefill chunk ran "
        "with no host sync (CUDA sync debug mode 'error')")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    x = torch.randn((8, cfg.hidden_size), generator=gen, device=DEV).to(
        cfg.torch_dtype)
    w = params["lm_head"] if "lm_head" in params else params["embed"]
    got = unembed_logits(x, w)
    ref = x.float() @ w.float().t()
    err = float((got - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())  # one bf16 rounding would be ~2e-3
    log(f"  unembed {tuple(w.shape)} {w.dtype}: {got.dtype} out, max|err| vs "
        f"float32 product {err:.3e} (tol {tol:.3e})")
    check(got.dtype == torch.float32 and err <= tol,
          "unembed: logits lost their float32 accumulator")


def phase_step_times(model, params, tag: str = "",
                     impls=("cuda", "gather")) -> dict:
    """Device time of one whole-model step at the timed kernels' shapes
    (decode: 8 rows at position 4095; prefill: one fresh 512-token chunk),
    through the kernels and through the gather path."""
    cfg = model.cfg
    B, ctx, T = 8, 4096, 512
    cache, dec, pre = step_inputs(model, B, ctx, T, BS, DEV)
    out = {}
    for impl in impls:
        for name, args in (("decode_step", dec), ("prefill_step", pre)):
            out[f"{tag}{name}_{impl}_ms"] = step_ms(
                lambda: model.forward(params, *args, cache, attn_impl=impl))
    log(f"[phase 3{'b' if tag else ''}] one {cfg.num_layers}-layer {tag}step "
        f"(B={B} decode at {ctx} ctx; T={T} fresh prefill): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def dequantized_copy(params):
    """The tree with its int4 leaves dequantized to bf16 beforehand (a layer
    at a time): the function the JAX package's XLA fallback computes."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {}
    for k, v in params["layers"].items():
        if k.endswith("_q4s"):
            continue
        s = params["layers"].get(k + "_q4s")
        if s is None:
            layers[k] = v
            continue
        w = torch.empty((v.shape[0], 2 * v.shape[1], v.shape[2]),
                        dtype=torch.bfloat16, device=DEV)
        for i in range(v.shape[0]):
            w[i] = i4.dequant_int4(v[i], s[i], torch.bfloat16)
        layers[k] = w
    out["layers"] = layers
    return out


def phase_int4_model(model):
    """Llama-3-8B int4, streamed on the card; one 512-token prefill and 8
    decode steps through the int4 and decode-write kernels, against the
    gather path on the dequantized tree."""
    cfg = model.cfg
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init_params(gen, DEV, quantization="int4")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    proj = sum(v.numel() * v.element_size() for k, v in params["layers"].items()
               if k.startswith("w"))
    top = sum(params[k].numel() + params[k + "_qs"].numel() * 4
              for k in ("embed", "lm_head"))
    log(f"[phase 3b] {MODEL} int4 on {DEV} in {time.perf_counter() - t0:.1f}s: "
        f"resident weights {nbytes / 1e9:.3f} GB (projections + group scales "
        f"{proj / 1e9:.3f} GB, int8 embed/lm_head + scales {top / 1e9:.3f} GB); "
        f"peak allocated while drawing {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
    check(4.3e9 < nbytes < 5.3e9, f"int4 tree holds {nbytes} bytes")

    os.environ["PST_FUSED_KV_WRITE"] = "1"
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(1, cfg.vocab_size, (512,), generator=gen).tolist()
    decode_tokens = torch.randint(1, cfg.vocab_size, (8,), generator=gen).tolist()
    reset_launch_counts()
    got, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    counts = launch_counts()
    L, n = cfg.num_layers, len(decode_tokens)
    want = {"prefill": L, "decode": 0, "decode_write": L * n,
            "int4": 7 * L * (1 + n)}
    check(counts == want, f"launch counts {counts}, expected {want}")
    # The 512-token prefill's projections take the wgmma kernel (and a
    # split-sum pass where its plan splits), the decode steps' (2 rows) the
    # decode route, whose splits add up in the same launch: no sum pass.
    routes = dict(i4.route_counts)
    sums = L * sum(i4.plan("wgmma", len(prompt), din, dout, 128).splits > 1
                   for din, dout in LAYER_SHAPES)
    want = {"wgmma": 7 * L, "decode": 7 * L * n, "simt": 0, "sum": sums}
    check(routes == want, f"int4 routes {routes}, expected {want}")
    check(pac.route_counts["decode_write_split"] == L * n,
          f"decode-write routes {pac.route_counts}: expected the split kernel")
    ref_params = dequantized_copy(params)
    ref, _ = drive_model(model, ref_params, "gather", prompt, decode_tokens)
    del ref_params
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(got).all()), "int4 model: non-finite logits (cuda)")
    check(bool(torch.isfinite(ref).all()), "int4 model: non-finite logits (gather)")
    check(got.shape == (1 + n, cfg.vocab_size),
          f"int4 model: logits shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    tol = MODEL_REL_ATOL * float(ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"  int4, PST_FUSED_KV_WRITE=1: 512-token prefill + {n} decode steps, "
        f"launches {counts}; max|logit| {float(ref.abs().max()):.3f}, "
        f"max|kernels - dequantized gather| {err:.4f} (tol {tol:.4f}), "
        f"argmax agreement {agree:.2f}")
    check(err <= tol, "int4 model: the kernel path disagrees with the "
          "dequantized gather path")

    # The fused int4 decode step makes the host wait for nothing either.
    cache, dec, _ = step_inputs(model, 4, 256, 64, BS, DEV)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.forward(params, *dec, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(logits).all()), "int4 no-sync step: bad output")
    log("  int4 fused decode step ran with no host sync")
    return params, {"decode": routes["decode"] // n, "wgmma": routes["wgmma"],
                    "decode_write": counts["decode_write"] // n}


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------


def _post(port: int, body: dict, timeout: float = 300.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _completion(port: int, body: dict, want_tokens: int) -> dict:
    status, data = _post(port, body)
    check(status == 200, f"completion: HTTP {status}: {data[:300]!r}")
    out = json.loads(data)
    ch = out["choices"][0]
    check(out["usage"]["completion_tokens"] == want_tokens,
          f"completion: {out['usage']} != {want_tokens} tokens")
    check(ch["finish_reason"] == "length",
          f"completion: finish_reason {ch['finish_reason']!r}")
    return out


def _stream(port: int, body: dict, want_tokens: int) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/completions", json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    check(resp.status == 200, f"stream: HTTP {resp.status}")
    frames = [ln[len(b"data: "):].strip() for ln in resp.read().split(b"\n")
              if ln.startswith(b"data: ")]
    conn.close()
    check(frames and frames[-1] == b"[DONE]", "stream: no [DONE] frame")
    chunks = [json.loads(f) for f in frames[:-1]]
    check(len(chunks) == want_tokens,
          f"stream: {len(chunks)} frames for {want_tokens} tokens")
    check(chunks[-1]["choices"][0]["finish_reason"] == "length",
          "stream: last frame has no finish_reason 'length'")
    return len(chunks)


def launch_counts() -> dict:
    return {**pac.launch_counts, **i4.launch_counts}


def route_counts() -> dict:
    """Launches by kernel; the int4 wrapper's routes carry an ``int4_``
    prefix (its ``decode`` route is not the attention wrapper's)."""
    return {**pac.route_counts,
            **{f"int4_{k}": n for k, n in i4.route_counts.items()}}


def reset_launch_counts() -> None:
    pac.reset_launch_counts()
    i4.reset_launch_counts()


def phase_serving(params, label: str, quantization=None,
                  used=("decode", "decode_split", "prefill",
                        "prefill_wgmma")) -> dict:
    """Four completions through the server; the kernels in ``used`` (by
    wrapper, and by route) must have launched while serving and no other
    kernel may have. Returns both counts."""
    cfg = EngineConfig(model=MODEL, device=DEV.type, max_prefill_tokens=512,
                       num_decode_steps=4, max_num_seqs=16,
                       quantization=quantization)
    t0 = time.perf_counter()
    engine = AsyncLLMEngine(cfg, params=params)
    runner = engine.engine.runner
    log(f"[phase {label}] engine up in {time.perf_counter() - t0:.1f}s "
        f"({quantization or 'bf16'} weights, {runner.param_bytes / 1e9:.3f} "
        f"GB; PST_FUSED_KV_WRITE={os.environ.get('PST_FUSED_KV_WRITE')}): "
        f"{runner.num_blocks} KV pages x {cfg.block_size} tokens, "
        f"max_prefill_tokens {cfg.max_prefill_tokens}, "
        f"num_decode_steps {cfg.num_decode_steps}")
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    try:
        status, health = _get(port, "/health")
        check(status == 200, f"/health: {status} {health}")
        status, models = _get(port, "/v1/models")
        check(status == 200 and models["data"][0]["id"] == MODEL,
              f"/v1/models: {status} {models}")

        reset_launch_counts()
        t0 = time.perf_counter()
        n_req = 0
        long_prompt = ("The quick brown fox jumps over the lazy dog. " * 40)[:1500]
        out = _completion(port, {"prompt": long_prompt, "max_tokens": 24,
                                 "temperature": 0.0, "ignore_eos": True}, 24)
        check(out["usage"]["prompt_tokens"] == 1500
              and 1500 > cfg.max_prefill_tokens,
              "long prompt must be chunked over several prefill steps")
        n_req += 1
        _stream(port, {"prompt": "Once upon a time", "max_tokens": 20,
                       "temperature": 0.0, "ignore_eos": True}, 20)
        n_req += 1
        results: dict = {}

        def worker(i: int) -> None:
            try:
                results[i] = _completion(port, {
                    "prompt": f"Request {i}: tell me about paged attention.",
                    "max_tokens": 16 + 4 * i, "temperature": 0.8,
                    "top_p": 0.9, "top_k": 50, "seed": 100 + i,
                    "ignore_eos": True}, 16 + 4 * i)
            except BaseException as e:  # re-raised on the main thread
                results[i] = e

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(2):
            if isinstance(results[i], BaseException):
                raise results[i]
        n_req += 2
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**launch_counts(), **route_counts()}
        check(engine.is_healthy(), f"engine failed: {engine.step_error}")
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    log(f"  {n_req} completions served in {wall:.2f}s; kernel launches "
        f"during serving: {counts}")
    check(n_req >= 4, "fewer than 4 completions served")
    for k, n in counts.items():
        if k in used:
            check(n > 0, f"serving never launched the {k} kernel")
        else:
            check(n == 0, f"serving launched the {k} kernel {n} times")
    del engine, runner
    return counts


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


# Cycles of the spin kernel that keeps the card busy while the host queues
# a batch of timed launches (about 50 ms at the H100's clock).
SPIN_CYCLES = 100_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls back to back
    between two CUDA events, queued behind a spin kernel so that the host's
    dispatch time is not counted (a version that makes the host wait for
    the card, as the plain decode-write does, still counts its stalls);
    the median over ``reps`` batches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def step_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Time of one call from its dispatch on an idle card: CUDA events
    around each call, so a host-bound step counts its host time; the
    median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gathered_kv(cache, tables, layer, kv_len):
    """K/V of one layer gathered into [B, KH, kv_len, HD] (the yardstick's
    input, made before timing)."""
    B, W = tables.shape
    kv = cache[layer][tables.long()]  # [B, W, 2, BS, KH*HD]
    k = kv[:, :, 0].reshape(B, W * BS, KH, HD)[:, :kv_len].transpose(1, 2)
    v = kv[:, :, 1].reshape(B, W * BS, KH, HD)[:, :kv_len].transpose(1, 2)
    return k.contiguous(), v.contiguous()


def sdpa(q, k, v, causal):
    # Yardstick only: one PyTorch call computing the same attention.
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=SCALE, enable_gqa=True)


def phase_times(per_step: dict, served: dict, card: str) -> list:
    """Rows of the attention kernels (decode, prefill, decode-write)."""
    log(f"[phase 5] kernel times at the slice's shapes ({card})")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(99)
    rows = []

    # Decode: B=8, every row at kv_len 4096 (the profiled step's shape),
    # then one interactive user (B=1) and a large batch (B=64) at 4096 and
    # at 512. Four layers of cache (537 MB at B=8), each launch reads
    # another layer, so the 50 MB L2 never holds the KV.
    decode = []
    for B, kvl in ((8, 4096), (1, 4096), (64, 4096), (64, 512)):
        q, cache, tables, kl, _ = make_case(gen, B=B, T=1, kv_lens=[kvl] * B,
                                            layers=4)
        q3 = q[:, 0].contiguous()
        state = {"layer": 0}

        def dec():
            state["layer"] = (state["layer"] + 1) % 4
            return pac.paged_attention_decode(q3, cache, tables, kl,
                                              state["layer"], scale=SCALE)

        ms = cuda_ms(dec)
        plain_ms = cuda_ms(lambda: pac.paged_attention_decode_plain(
            q3, cache, tables, kl, 1, scale=SCALE), iters=5)
        k, v = gathered_kv(cache, tables, 1, kvl)
        qs = q3[:, :, None]  # [B, H, 1, HD]
        lib_ms = cuda_ms(lambda: sdpa(qs, k, v, False))
        ref = sdpa(qs, k, v, False)[:, :, 0]
        got = pac.paged_attention_decode(q3, cache, tables, kl, 1, scale=SCALE)
        splits = splits_of(q, cache, tables)
        compare("decode", got, ref,
                f"decode bf16 B={B} kv_len {kvl} ({splits} splits) vs sdpa")
        kv_bytes = B * kvl * 2 * KH * HD * 2
        io_bytes = 2 * B * H * HD * 2 + tables.numel() * 4 + B * 4
        flops = 4 * B * H * HD * kvl
        r = _row("decode", ms, plain_ms, lib_ms, kv_bytes + io_bytes, flops,
                 PEAK_BF16_FLOPS, per_step["decode_step"],
                 served[ROUTE_OF["decode"]],
                 card, f"B={B} kv_len={kvl} H={H} KH={KH} hd={HD} bs={BS} "
                       f"bf16, {splits} splits")
        r["splits"] = splits
        decode.append(r)
        if B == 8:
            kept = (q3, cache, tables, kl, kv_bytes, io_bytes, flops)
        del q, cache, k, v, ref, got
    rows.append(with_points(decode))
    torch.cuda.empty_cache()
    q3, cache, tables, kl, kv_bytes, io_bytes, flops = kept
    B, kvl = 8, 4096

    # Decode-write at the same shape: each launch also writes its row (the
    # same slot every time: kv_len counts it). No single PyTorch call
    # computes this; the unfused pair it replaces (index_copy_ of the two
    # rows, then the decode kernel) is timed in its place.
    k_new = torch.randn((B, KH * HD), generator=gen, device=DEV).bfloat16()
    v_new = torch.randn((B, KH * HD), generator=gen, device=DEV).bfloat16()
    wf = write_slots(tables, [kvl - 1] * B, [], cache.shape[1])

    def dw():
        state["layer"] = (state["layer"] + 1) % 4
        return pac.paged_attention_decode_write(
            q3, cache, tables, kl, state["layer"], k_new, v_new, wf,
            scale=SCALE)

    ms = cuda_ms(dw)
    plain_ms = cuda_ms(lambda: pac.paged_attention_decode_write_plain(
        q3, cache, tables, kl, 1, k_new, v_new, wf, scale=SCALE), iters=5)
    flat = cache.view(-1, KH * HD)
    nb = cache.shape[1]
    rows_k = ((nb + wf.long() // BS) * 2 * BS + wf.long() % BS)  # layer 1

    def pair():
        flat.index_copy_(0, rows_k, k_new)
        flat.index_copy_(0, rows_k + BS, v_new)
        return pac.paged_attention_decode(q3, cache, tables, kl, 1, scale=SCALE)

    pair_ms = cuda_ms(pair)
    row_bytes = 2 * B * KH * HD * 2 * 2  # k_new/v_new read, rows written
    r = _row("decode_write", ms, plain_ms, None, kv_bytes + io_bytes + row_bytes,
             flops, PEAK_BF16_FLOPS, per_step["decode_write_step"],
             served[ROUTE_OF["decode_write"]], card,
             f"B={B} kv_len={kvl} H={H} KH={KH} hd={HD} bs={BS} bf16, "
             f"one K/V row written per sequence, "
             f"{splits_of(q3, cache, tables)} splits",
             library="none: no single PyTorch call computes it")
    r["splits"] = splits_of(q3, cache, tables)
    r["unfused_pair_ms"] = pair_ms
    r["unfused_pair"] = "index_copy_ of the K/V rows + paged_attention_decode"
    log(f"  unfused pair (index_copy_ + paged_attention_decode): {pair_ms:.4f} ms")
    rows.append(r)

    # Prefill, one sequence: a fresh 512-token chunk, a 512-token chunk at
    # start 3584 (the last chunk of a 4096-token prompt) and a fresh
    # 2048-token chunk (the engine's default max_prefill_tokens).
    prefill = []
    for T, start in ((512, 0), (512, 3584), (2048, 0)):
        q, cache, tables, kl, st = make_case(gen, B=1, T=T, kv_lens=[start + T],
                                             starts=[start], layers=4)
        ms = cuda_ms(lambda: pac.paged_attention_prefill(
            q, cache, tables, kl, st, 1, scale=SCALE))
        plain_ms = cuda_ms(lambda: pac.paged_attention_prefill_plain(
            q, cache, tables, kl, st, 1, scale=SCALE), iters=5)
        k, v = gathered_kv(cache, tables, 1, start + T)
        qs = q.transpose(1, 2).contiguous()  # [1, H, T, HD]
        yard = sdpa_chunk(qs, k, v)
        lib_ms = cuda_ms(lambda: yard(qs, k, v))
        ref = yard(qs, k, v).transpose(1, 2)
        got = pac.paged_attention_prefill(q, cache, tables, kl, st, 1,
                                          scale=SCALE)
        compare("prefill", got, ref,
                f"prefill bf16 T={T} start={start} vs sdpa ({yard.__doc__})")
        pairs = T * start + T * (T + 1) // 2  # (query, live key) pairs
        nbytes = 2 * T * H * HD * 2 + (start + T) * 2 * KH * HD * 2
        prefill.append(_row(
            "prefill", ms, plain_ms, lib_ms, nbytes, 4 * H * HD * pairs,
            PEAK_BF16_FLOPS, per_step["prefill_chunk"],
            served[ROUTE_OF["prefill"]], card,
            f"B=1 T={T} start={start} H={H} KH={KH} hd={HD} bs={BS} bf16",
            library="torch.nn.functional.scaled_dot_product_attention, "
                    + yard.__doc__))
    rows.append(with_points(prefill))
    return rows


def sdpa_chunk(q, k, v):
    """The yardstick for a chunk of T queries at the end of S keys: SDPA,
    causal from the upper left when T == S, else lower-right causal (as a
    CausalBias, or as an explicit boolean mask where the bias does not
    combine with enable_gqa). Timing only, never on the path."""
    T, S = q.shape[2], k.shape[2]
    F = torch.nn.functional
    if T == S:
        def fresh(q, k, v):
            """causal"""
            return sdpa(q, k, v, True)
        return fresh
    from torch.nn.attention.bias import causal_lower_right

    def bias(q, k, v):
        """lower-right causal bias"""
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_lower_right(T, S), scale=SCALE,
            enable_gqa=True)
    try:
        bias(q, k, v)
        return bias
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
        log(f"  SDPA's lower-right causal bias with enable_gqa: {e!r}")
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)

    def explicit(q, k, v):
        """lower-right causal boolean mask"""
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=SCALE, enable_gqa=True)
    return explicit


def with_points(rows: list) -> dict:
    """The first row, with every row's shape and numbers under
    ``points``."""
    keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "splits")
    main = dict(rows[0])
    main["points"] = [{k: r[k] for k in keys if k in r} for r in rows]
    return main


def phase_int4_times(per_step: dict, served: dict, card: str):
    """Rows of the int4 kernels: the decode route at the four projection
    shapes with 1, 8 and 16 rows (and the decode buckets up to its
    boundary), the wgmma route at 512 rows for the four shapes and at 2048
    rows for w_gate; and the crossover of the two bf16 routes at N in {1,
    8, 16, 32, 64} on the four shapes. Four weights of each shape in turn
    (117 MB of packed weights for w_gate, more than the 50 MB L2), as a
    step finds each layer's weights cold. The yardstick is torch.matmul on
    the weight dequantized to bf16 beforehand: it reads 4x the bytes.
    Returns (rows, crossover)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(98)
    edge = i4._DECODE_MAX_ROWS
    decode_rows = sorted({1, 8, 16} | {b for b in DECODE_BUCKETS if 16 <= b <= edge})
    # w_gate's shape first: its N = 8 row heads the decode route's points.
    shapes = ((4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024))
    wgmma_cases = {(4096, 14336): (512, 2048)}
    rows = {"int4": [], "int4_wgmma": []}
    crossover = []
    for din, dout in shapes:
        weights = [int4_case(gen, 1, din, dout)[1:] for _ in range(4)]
        dense = [i4.dequant_int4(p, s, torch.bfloat16) for p, s in weights]
        G = din // weights[0][1].shape[0]
        turn = {"i": 0}

        def nxt():
            turn["i"] = (turn["i"] + 1) % 4
            return turn["i"]

        cases = [("int4", N) for N in decode_rows]
        cases += [("int4_wgmma", N) for N in wgmma_cases.get((din, dout), (512,))]
        for kind, N in cases:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            check(i4.route(x, *weights[0]) == ROUTE_OF[kind],
                  f"int4 N={N}: not the {ROUTE_OF[kind]} route")
            ms = cuda_ms(lambda: i4.int4_matmul(x, *weights[nxt()]))
            plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(x, *weights[nxt()]),
                               iters=5)
            lib_ms = cuda_ms(lambda: torch.matmul(x, dense[nxt()]))
            got = i4.int4_matmul(x, *weights[0])
            compare(kind, got, torch.matmul(x.float(), dense[0].float()),
                    f"int4 bf16 N={N} din={din} dout={dout} vs fp32 product "
                    "of the bf16-dequantized weight", rows=True)
            nbytes = (din * dout // 2 + (din // G) * dout * 4 + N * din * 2
                      + N * dout * 4)
            rows[kind].append(_row(
                kind, ms, plain_ms, lib_ms, nbytes, 2 * N * din * dout,
                PEAK_BF16_FLOPS, per_step[ROUTE_OF[kind]],
                served["int4_" + ROUTE_OF[kind]], card,
                f"N={N} din={din} dout={dout} G={G} bf16 x",
                library="torch.matmul on the weight dequantized to bf16 "
                        "beforehand (reads 4x the bytes)"))
        # Both bf16 routes at every decode bucket: where the boundary goes.
        for N in DECODE_BUCKETS:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            point = {"shape": f"N={N} din={din} dout={dout}"}
            for name in ("decode", "wgmma"):
                point[f"{name}_ms"] = cuda_ms(
                    lambda: i4._launch(name, x, *weights[nxt()]))
            crossover.append(point)
            log(f"  crossover {point['shape']}: decode route "
                f"{point['decode_ms']:.4f} ms, wgmma route "
                f"{point['wgmma_ms']:.4f} ms")
        del weights, dense
    main = [r for r in rows["int4"] if r["shape"].startswith("N=8 ")]
    rows["int4"].remove(main[0])
    return ([with_points(main[:1] + rows["int4"]), with_points(
        sorted(rows["int4_wgmma"], key=lambda r: "N=2048" in r["shape"]))],
            crossover)


def _row(kind, ms, plain_ms, lib_ms, nbytes, flops, peak, per_step, launches,
         card, shape,
         library="torch.nn.functional.scaled_dot_product_attention"):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(KERNELS[kind])
    row.update(
        launches=launches, launches_per_step=per_step,
        max_abs_err=max_err[kind], ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms, library=library, shape=shape, card=card,
    )
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"  {row['name']} [{shape}]: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"library {lib}, bound {bound_ms:.4f} ms by {row['bound_by']}; "
        f"{bound_ms / ms:.1%} of bound); {per_step} launches per step, "
        f"{launches} while serving")
    return row


def main() -> None:
    t_start = time.perf_counter()
    os.environ.pop("PST_FUSED_KV_WRITE", None)  # bf16 phases: unfused path
    card = phase_toolchain()
    log("[phase 2] kernels vs plain versions")
    phase_kernels()
    phase_decode_write_kernels()
    phase_int4_kernels()
    model, params = build_model()
    per_step = phase_model(model, params)
    phase_no_host_sync(model, params)
    steps = phase_step_times(model, params)
    torch.cuda.empty_cache()  # the engine sizes its KV cache from free memory
    served = phase_serving(params, "4")
    del params
    gc.collect()  # the engine's KV cache and the bf16 tree, cycles included
    torch.cuda.empty_cache()
    log(f"[phase 3b] bf16 tree and engine freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    q_params, q_per_step = phase_int4_model(model)  # sets PST_FUSED_KV_WRITE=1
    steps.update(phase_step_times(model, q_params, tag="int4_", impls=("cuda",)))
    per_step["decode_write_step"] = q_per_step["decode_write"]
    torch.cuda.empty_cache()
    q_served = phase_serving(
        q_params, "4b", quantization="int4",
        used=("decode_write", "decode_write_split", "int4", "prefill",
              "prefill_wgmma", "int4_wgmma", "int4_decode", "int4_sum"))
    # Split-sum passes follow only wgmma (and CUDA-core) launches.
    check(q_served["int4_sum"] <= q_served["int4_wgmma"] + q_served["int4_simt"],
          f"int4 serving: {q_served['int4_sum']} sum passes for "
          f"{q_served['int4_wgmma']} wgmma launches")
    del q_params
    gc.collect()
    torch.cuda.empty_cache()

    rows = phase_times(per_step, {**served, "decode_write_split":
                                  q_served["decode_write_split"]},
                       card)
    int4_rows, crossover = phase_int4_times(q_per_step, q_served, card)
    rows += int4_rows
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows, "steps": steps, "int4_crossover": crossover}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
