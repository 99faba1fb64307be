"""The CUDA-core prefill's key split and in-launch merge, on the CPU.

``paged_prefill_kernel`` (``csrc/paged_attention.cuh``) runs only on the
card, where ``chip_smoke.py`` holds it against the plain version. Here:
the split count the wrapper plans (``simt_prefill_plan``: shapes only,
the grid within one wave) and the keys each split of a q-tile reads
(``simt_prefill_split_keys``, the formula of ``csrc/splits.cuh::
split_run``); and a plain PyTorch model of the kernel's algorithm at its
partition (q-tiles of ``SIMT_PREFILL_TILES[hd][0]`` rows, key tiles of
``SIMT_PREFILL_TILES[hd][1]`` keys, one softmax update a tile in the log2
domain, the runs merged in split order with empty runs skipped) against
``paged_attention_prefill_plain`` and the JAX package's Pallas
``_prefill_kernel`` in interpret mode (``tests/conftest.py`` sets
``PST_FORCE_PALLAS_INTERPRET``), at head_dim 16 and 128 in fp32 and over
an e4m3 cache.
"""

from __future__ import annotations

import inspect
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.ops.paged_attention_pallas import (
    pallas_paged_attention,
)
from production_stack_tpu_torch.ops import paged_attention_cuda as pac
from production_stack_tpu_torch.ops.attention import window_eff

LOG2E = 1.4426950408889634
# fp32 inputs, fp32 arithmetic on every side; only the order of the sums
# and the softmax's rescaling points differ.
TOL = dict(rtol=1e-5, atol=1e-5)
_pallas_jit = jax.jit(pallas_paged_attention,
                      static_argnames=("scale", "softcap"))


def split_model(q, kv_pages, tables, kv_lens, starts, layer, *, scale,
                splits, window=0, softcap=0.0):
    """``paged_prefill_kernel`` in plain PyTorch (fp32): q-tile ``qt`` of
    (sequence, kv head) holds positions ``qt * TQ ..`` (TQ = rows // G)
    times the G heads; split s walks the keys ``simt_prefill_split_keys``
    gives it in tiles aligned to the kernel's key tile, one online-softmax
    update a tile (log2 domain, each row masked to its window and causal
    bound); the non-empty runs merge in split order; a row with no live
    key gives 0. Returns [B, T, H, hd] fp32."""
    B, T, H, hd = q.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH, W = lanes // hd, tables.shape[1]
    G = H // KH
    rows, tile = pac.SIMT_PREFILL_TILES[hd]
    tq = rows // G
    out = torch.zeros((B, T, H, hd))
    for b in range(B):
        n, st = int(kv_lens[b]), int(starts[b])
        for kh in range(KH):
            cols = slice(kh * hd, (kh + 1) * hd)
            for qt in range(pac.simt_prefill_qtiles(T, G, hd)):
                t = torch.arange(qt * tq, min(qt * tq + tq, T))
                qr = q[b, t, kh * G:(kh + 1) * G].float().reshape(-1, hd)
                pos = (st + t).repeat_interleave(G)  # row r: (t_r, g_r)
                low = torch.clamp(pos + 1 - window_eff(window), min=0)
                bound = torch.clamp(pos + 1, max=n)
                parts = []
                for s in range(splits):
                    k0, k1 = pac.simt_prefill_split_keys(
                        n, st, T, G, qt, window, splits, s, hd)
                    if k1 == k0:
                        continue  # an empty run: skipped by the merge
                    m = torch.full((len(pos),), -math.inf)
                    l = torch.zeros(len(pos))
                    acc = torch.zeros((len(pos), hd))
                    for kb in range(k0 - k0 % tile, k1, tile):
                        keys = torch.arange(max(kb, k0), min(kb + tile, k1))
                        pages = tables[b, torch.clamp(keys // bs, max=W - 1)]
                        r = keys % bs
                        k = kv_pages[layer, pages.long(), 0, r, cols].float()
                        v = kv_pages[layer, pages.long(), 1, r, cols].float()
                        x = (qr @ k.T) * scale
                        if softcap:
                            x = torch.tanh(x / softcap) * softcap
                        live = (keys[None] >= low[:, None]) & (
                            keys[None] < bound[:, None])
                        x = (x * LOG2E).masked_fill(~live, -math.inf)
                        m_new = torch.maximum(m, x.max(1).values)
                        base = torch.where(m_new == -math.inf,
                                           torch.zeros_like(m_new), m_new)
                        alpha = torch.exp2(m - base)
                        p = torch.exp2(x - base[:, None])
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ v
                        m = m_new
                    parts.append((m, l, acc))
                if not parts:
                    continue
                M = torch.stack([m for m, _, _ in parts]).max(0).values
                L = torch.zeros_like(M)
                A = torch.zeros_like(parts[0][2])
                for m, l, acc in parts:
                    c = torch.where(M == -math.inf, torch.zeros_like(M),
                                    torch.exp2(m - M))
                    L = L + l * c
                    A = A + acc * c[:, None]
                inv = torch.where(L == 0, torch.zeros_like(L), 1 / L)
                out[b, t, kh * G:(kh + 1) * G] = (A * inv[:, None]).reshape(
                    len(t), G, hd)
    return out


def test_simt_prefill_plan_fills_one_wave_from_shapes():
    # What the plan reads: shapes, never kv_lens or starts.
    assert list(inspect.signature(pac.simt_prefill_plan).parameters) == [
        "B", "KH", "T", "G", "W", "bs", "n_sm", "hd"]
    # An H100's 132 SMs, block size 32. tiny-llama-debug's heads (KH 8, G
    # 1, hd 16) at T=256: 16 q-tile blocks, 4 splits over a 256-key table
    # (one split per two 32-key tiles), 16 (the cap) over a long one.
    assert pac.simt_prefill_plan(1, 8, 256, 1, 8, 32, 132, 16) == 4
    assert pac.simt_prefill_plan(1, 8, 256, 1, 64, 32, 132, 16) == 16
    # fp32 Llama-3-8B heads (KH 8, G 4): 16 q-tiles of 32 positions at
    # T=512, 128 blocks of one an SM: one split, fresh or at 3584.
    assert pac.simt_prefill_plan(1, 8, 512, 4, 16, 32, 132, 128) == 1
    assert pac.simt_prefill_plan(1, 8, 512, 4, 128, 32, 132, 128) == 1
    # fp32 gemma2-9b heads (KH 8, G 2, hd 256: 64-row q-tiles): 128
    # blocks at T=512, one split; 16 at T=64, eight.
    assert pac.simt_prefill_plan(1, 8, 512, 2, 16, 32, 132, 256) == 1
    assert pac.simt_prefill_plan(1, 8, 64, 2, 64, 32, 132, 256) == 8
    for hd in pac.HEAD_DIMS:
        per_sm = pac._SIMT_PREFILL_BLOCKS_PER_SM[hd]
        for B, KH, T, G, W in ((1, 8, 256, 1, 8), (3, 2, 37, 7, 40),
                               (2, 4, 1, 3, 100), (1, 1, 16, 1, 4096),
                               (8, 8, 2048, 8, 64)):
            plan = pac.simt_prefill_plan(B, KH, T, G, W, 32, 132, hd)
            blocks = B * KH * pac.simt_prefill_qtiles(T, G, hd)
            assert 1 <= plan <= pac._SIMT_PREFILL_MAX_SPLITS
            # Within one wave, unless one split already overflows it.
            assert plan == 1 or blocks * plan <= per_sm * 132
            assert plan == 1 or plan <= -(-W * 32 // pac.SIMT_PREFILL_TILES[
                hd][1]) // 2


def test_simt_prefill_split_keys_cover_each_live_key_once():
    for hd in (16, 128, 256):
        rows, tile = pac.SIMT_PREFILL_TILES[hd]
        for G in (1, 2, 3, 8):
            tq = rows // G
            for T, start, short in ((37, 0, 0), (150, 700, 0), (70, 100, 9),
                                    (1, 5, 1), (300, 13, 0)):
                n = start + T - short  # the last rows past kv_len
                for window in (0, 7, 300):
                    for splits in (1, 2, 3, 5):
                        for qt in range(pac.simt_prefill_qtiles(T, G, hd)):
                            runs = [pac.simt_prefill_split_keys(
                                n, start, T, G, qt, window, splits, s, hd)
                                for s in range(splits)]
                            for k0, k1 in runs:
                                assert k1 == k0 or k0 % tile == 0 or (
                                    k0 == runs[0][0]), (k0, tile)
                            for t in range(qt * tq, min(qt * tq + tq, T)):
                                pos = start + t
                                lo = max(pos + 1 - window_eff(window), 0)
                                live = list(range(lo, min(pos + 1, n)))
                                seen = [k for k0, k1 in runs
                                        for k in range(k0, k1) if k in live]
                                assert seen == live, (hd, G, T, start,
                                                      window, splits, qt, t)


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 and e4m3 as ml_dtypes) as a torch tensor of the
    same bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("hd, cache", [(16, "fp32"), (128, "fp32"),
                                       (16, "e4m3")])
def test_split_model_matches_plain_and_pallas_prefill(hd, cache):
    """Two sequences: a 40-row chunk continuing at 150 under a window of
    100 (its first key 51, mid-page) with a softcap, and a fresh one whose
    kv_len stops 5 rows short of T; G = 8 at hd 16 (three q-tiles of 16
    positions, the last ragged), G = 4 at hd 128 (two of 32); S of 1, 3
    and 5 (empty runs among them).

    "fp32": fp32 q and cache, every side in fp32 (1e-5). "e4m3": bf16 q
    over an e4m3 cache; the model against the plain version in fp32
    (1e-5), against Pallas at ``tests/test_torch_fp8_pallas.py``'s
    tolerance: its P·V rounds P to about 2^-8, and its output is bf16."""
    rng = np.random.default_rng(hd)
    H, KH = (8, 1) if hd == 16 else (8, 2)
    B, T, nb, bs, W = 2, 40, 30, 16, 13
    q = rng.standard_normal((B, T, H, hd), dtype=np.float32)
    kv = rng.standard_normal((1, nb, 2, bs, KH * hd), dtype=np.float32) * 2
    if cache == "e4m3":
        q = q.astype(ml_dtypes.bfloat16)
        kv = kv.astype(ml_dtypes.float8_e4m3fn)
    tables = rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32)
    starts = np.asarray([150, 0], np.int32)
    lens = np.asarray([150 + T, T - 5], np.int32)
    q_pos = starts[:, None] + np.arange(T, dtype=np.int32)[None]
    window, scale, softcap = 100, hd ** -0.5, 20.0
    tq, kv_t = _torch(q), _torch(kv)
    args = (kv_t, _torch(tables), _torch(lens), _torch(starts), 0)
    plain = pac.paged_attention_prefill_plain(
        tq.float(), *args, scale=scale, window=window, softcap=softcap)
    want = np.asarray(_pallas_jit(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(q_pos), 0, window=window,
        scale=scale, softcap=softcap), np.float32)
    for splits in (1, 3, 5):
        got = split_model(tq, *args, scale=scale, splits=splits,
                          window=window, softcap=softcap)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
        if cache == "fp32":
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        else:
            v_max = float(np.abs(kv.astype(np.float32)[:, :, 1]).max())
            np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -8,
                                       atol=2.0 ** -8 * v_max)
