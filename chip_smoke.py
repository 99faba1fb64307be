#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases, in order; any exception, mismatch or NaN exits non-zero:

1. Device and toolchain: the card's name and power limit, CUDA and nvcc
   versions; the CUDA kernels are built from ``production_stack_tpu_torch/
   ops/csrc`` and the build time printed.
2. Each kernel against its plain PyTorch version at Llama-3-8B attention
   shapes (H=32, KH=8, hd=128, bs=32) in bf16, plus small fp32 cases with
   a sliding window and a softcap and the other head-group sizes; on CUDA
   tensors a wrapper refuses what its kernel does not take.
3. The full-width 32-layer Llama-3-8B (random bf16 weights from a seed):
   one 512-token prefill and 8 decode steps through the kernels and again
   through the gather path; the logits must agree. A decode step, a
   sampled draw and a prefill chunk then run under CUDA's sync debug mode
   set to raise (no host sync), and the unembed is held to a float32
   product.
4. Serving: the port's OpenAI server on localhost answers completions
   (streamed, chunked-prefill, concurrent); the kernels' launch counters
   are zeroed just before and must have grown by its end.
5. Times of each kernel at the slice's shapes beside its plain version,
   ``scaled_dot_product_attention`` as a yardstick, and its bound.

The line before the last is a JSON ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

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
from production_stack_tpu_torch.models.llama import Llama, unembed_logits  # noqa: E402
from production_stack_tpu_torch.models.registry import get_model_config  # noqa: E402
from production_stack_tpu_torch.ops import _build  # noqa: E402
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
# Logits of 32 bf16 layers computed in a different order (kernel vs gather).
MODEL_REL_ATOL = 5e-2

SOURCE = "production_stack_tpu_torch/ops/csrc/paged_attention.cu"
KERNELS = {
    "decode": dict(
        name="paged_attention_decode", route="cuda", source=SOURCE,
        replaces="production_stack_tpu/ops/paged_attention_pallas.py:218",
    ),
    "prefill": dict(
        name="paged_attention_prefill", route="cuda", source=SOURCE,
        replaces="production_stack_tpu/ops/paged_attention_pallas.py:430",
    ),
}
max_err = {"decode": 0.0, "prefill": 0.0}


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
            label: str) -> float:
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    if got.dtype == torch.bfloat16:
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
    log("[phase 2] kernels vs plain versions")
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

    # Prefill, bf16: T=512 fresh, T=512 continuing at 1000, T=300 ragged.
    for T, start in ((512, 0), (512, 1000), (300, 77)):
        q, cache, tables, kl, st = make_case(
            gen, B=2, T=T, kv_lens=[start + T, start + T],
            starts=[start, start])
        got, ref = run_prefill(q, cache, tables, kl, st, 1)
        compare("prefill", got, ref, f"prefill bf16 B=2 T={T} start={start}")

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
                     "decode": cfg.num_layers * len(decode_tokens)},
          f"launch counts {counts}: expected one per layer per step")
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


def phase_step_times(model, params) -> dict:
    """Device time of one whole-model step at the timed kernels' shapes
    (decode: 8 rows at position 4095; prefill: one fresh 512-token chunk),
    through the kernels and through the gather path."""
    cfg = model.cfg
    B, ctx, T = 8, 4096, 512
    cache, dec, pre = step_inputs(model, B, ctx, T, BS, DEV)
    out = {}
    for impl in ("cuda", "gather"):
        for name, args in (("decode_step", dec), ("prefill_step", pre)):
            out[f"{name}_{impl}_ms"] = cuda_ms(
                lambda: model.forward(params, *args, cache, attn_impl=impl),
                iters=10, warmup=2)
    log(f"[phase 3] one {cfg.num_layers}-layer step: decode B={B} at "
        f"{ctx} ctx {out['decode_step_cuda_ms']:.2f} ms (gather path "
        f"{out['decode_step_gather_ms']:.2f}); prefill T={T} fresh "
        f"{out['prefill_step_cuda_ms']:.2f} ms (gather path "
        f"{out['prefill_step_gather_ms']:.2f})")
    return out


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


def phase_serving(params) -> dict:
    cfg = EngineConfig(model=MODEL, device=DEV.type, max_prefill_tokens=512,
                       num_decode_steps=4, max_num_seqs=16)
    t0 = time.perf_counter()
    engine = AsyncLLMEngine(cfg, params=params)
    runner = engine.engine.runner
    log(f"[phase 4] engine up in {time.perf_counter() - t0:.1f}s: "
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

        pac.reset_launch_counts()
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
        counts = dict(pac.launch_counts)
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
        check(n > 0, f"serving never launched the {k} kernel")
    del engine, runner
    return counts


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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
    log(f"[phase 5] kernel times at the slice's shapes ({card})")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(99)
    rows = []

    # Decode: B=8, every row at kv_len 4096. Four layers of cache (537 MB),
    # each launch reads another layer, so the 50 MB L2 never holds the KV.
    B, kvl = 8, 4096
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
    compare("decode", got, ref, "decode bf16 B=8 kv_len 4096 vs sdpa")
    kv_bytes = B * kvl * 2 * KH * HD * 2
    io_bytes = 2 * B * H * HD * 2 + tables.numel() * 4 + B * 4
    flops = 4 * B * H * HD * kvl
    rows.append(_row("decode", ms, plain_ms, lib_ms, kv_bytes + io_bytes,
                     flops, PEAK_BF16_FLOPS, per_step["decode_step"],
                     served["decode"], card,
                     f"B={B} kv_len={kvl} H={H} KH={KH} hd={HD} bs={BS} bf16"))

    # Prefill: T=512 fresh, one sequence.
    T = 512
    q, cache, tables, kl, st = make_case(gen, B=1, T=T, kv_lens=[T],
                                         starts=[0], layers=4)
    ms = cuda_ms(lambda: pac.paged_attention_prefill(
        q, cache, tables, kl, st, 1, scale=SCALE))
    plain_ms = cuda_ms(lambda: pac.paged_attention_prefill_plain(
        q, cache, tables, kl, st, 1, scale=SCALE), iters=5)
    k, v = gathered_kv(cache, tables, 1, T)
    qs = q.transpose(1, 2).contiguous()  # [1, H, T, HD]
    lib_ms = cuda_ms(lambda: sdpa(qs, k, v, True))
    ref = sdpa(qs, k, v, True).transpose(1, 2)
    got = pac.paged_attention_prefill(q, cache, tables, kl, st, 1, scale=SCALE)
    compare("prefill", got, ref, "prefill bf16 T=512 fresh vs sdpa")
    start = 0
    flops = 4 * H * HD * T * (start + T / 2)
    nbytes = 2 * T * H * HD * 2 + (start + T) * 2 * KH * HD * 2
    rows.append(_row("prefill", ms, plain_ms, lib_ms, nbytes, flops,
                     PEAK_BF16_FLOPS, per_step["prefill_chunk"],
                     served["prefill"], card,
                     f"B=1 T={T} start={start} H={H} KH={KH} hd={HD} bs={BS} bf16"))
    return rows


def _row(kind, ms, plain_ms, lib_ms, nbytes, flops, peak, per_step, launches,
         card, shape):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(KERNELS[kind])
    row.update(
        launches=launches, launches_per_step=per_step,
        max_abs_err=max_err[kind], ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms, library="torch.nn.functional.scaled_dot_product_attention",
        shape=shape, card=card,
    )
    log(f"  {row['name']} [{shape}]: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"sdpa {lib_ms:.4f}, bound {bound_ms:.4f} ms by {row['bound_by']}; "
        f"{bound_ms / ms:.1%} of bound); {per_step} launches per step, "
        f"{launches} while serving")
    return row


def main() -> None:
    t_start = time.perf_counter()
    card = phase_toolchain()
    phase_kernels()
    model, params = build_model()
    per_step = phase_model(model, params)
    phase_no_host_sync(model, params)
    steps = phase_step_times(model, params)
    torch.cuda.empty_cache()  # the engine sizes its KV cache from free memory
    served = phase_serving(params)
    del params
    torch.cuda.empty_cache()
    rows = phase_times(per_step, served, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows, "steps": steps}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
