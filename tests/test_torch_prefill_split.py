"""The wgmma prefill kernel's key split and in-launch merge, on the CPU.

``paged_prefill_wgmma_kernel`` (``csrc/prefill_wgmma.cuh``) runs only on
the card, where ``chip_smoke.py`` holds it against the plain version. Here:
the split count the wrapper plans and the keys each split of a q-tile reads
(``prefill_plan``, ``prefill_split_keys``, the formula of
``csrc/splits.cuh::split_run``); and a plain PyTorch model of the kernel's
algorithm at its partition (128-row q-tiles, key tiles of
``PREFILL_TILES[hd]`` keys, one softmax update a tile in the log2 domain,
the runs merged in split order with empty runs skipped) against
``paged_attention_prefill_plain`` and the JAX package's Pallas
``_prefill_kernel`` in interpret mode (``tests/conftest.py`` sets
``PST_FORCE_PALLAS_INTERPRET``), as ``tests/test_torch_hd256_pallas.py``
runs it. The Pallas calls take seconds each, so this file is its own file
for ``--dist loadfile``.
"""

from __future__ import annotations

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
# fp32 inputs, fp32 arithmetic on both sides; only the order of the sums
# and the softmax's rescaling points differ.
TOL = dict(rtol=2e-5, atol=2e-5)
_pallas_jit = jax.jit(pallas_paged_attention,
                      static_argnames=("scale", "softcap"))


def _merge(parts):
    """Flash states (m, l, acc) of the rows, merged in list order."""
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        c = torch.where(M == -math.inf, torch.zeros_like(M),
                        torch.exp2(m - M))
        L = L + l * c
        A = A + acc * c[:, None]
    return L, A


def split_model(q, kv_pages, tables, kv_lens, starts, layer, *, scale,
                splits, window=0, softcap=0.0, kernel_hd=256):
    """``paged_prefill_wgmma_kernel`` in plain PyTorch (fp32, where the
    kernel rounds P to bf16) as built at head dim ``kernel_hd``, whatever
    q's: q-tile ``qt`` of (sequence, kv head) holds positions ``qt * TQ ..``
    (TQ = 128 // G) times the G heads; split s walks the keys
    ``prefill_split_keys`` gives it in tiles aligned to
    ``PREFILL_TILES[kernel_hd]`` keys, one online-softmax update a tile
    (log2 domain, each row masked to its window and causal bound); the
    non-empty runs merge in split order; a row with no live key gives 0.
    Returns [B, T, H, hd] in q's type."""
    B, T, H, hd = q.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH, W = lanes // hd, tables.shape[1]
    G = H // KH
    tile, tq = pac.PREFILL_TILES[kernel_hd], pac.PREFILL_ROWS // G
    out = torch.zeros((B, T, H, hd))
    for b in range(B):
        n, st = int(kv_lens[b]), int(starts[b])
        for kh in range(KH):
            cols = slice(kh * hd, (kh + 1) * hd)
            for qt in range(pac.prefill_qtiles(T, G)):
                t = torch.arange(qt * tq, min(qt * tq + tq, T))
                qr = q[b, t, kh * G:(kh + 1) * G].float().reshape(-1, hd)
                pos = (st + t).repeat_interleave(G)  # row r: (t_r, g_r)
                low = torch.clamp(pos + 1 - window_eff(window), min=0)
                bound = torch.clamp(pos + 1, max=n)
                parts = []
                for s in range(splits):
                    k0, k1 = pac.prefill_split_keys(n, st, T, G, qt, window,
                                                    splits, s, kernel_hd)
                    if k1 == k0:
                        continue  # an empty run: skipped by the merge
                    m = torch.full((len(pos),), -math.inf)
                    l = torch.zeros(len(pos))
                    acc = torch.zeros((len(pos), hd))
                    for kb in range(k0 - k0 % tile, k1, tile):
                        keys = torch.arange(max(kb, k0), min(kb + tile, k1))
                        pages = tables[b, torch.clamp(keys // bs, max=W - 1)]
                        rows = keys % bs
                        k = kv_pages[layer, pages.long(), 0, rows, cols].float()
                        v = kv_pages[layer, pages.long(), 1, rows, cols].float()
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
                L, A = _merge(parts)
                inv = torch.where(L == 0, torch.zeros_like(L), 1 / L)
                out[b, t, kh * G:(kh + 1) * G] = (A * inv[:, None]).reshape(
                    len(t), G, hd)
    return out.to(q.dtype)


def test_prefill_plan_covers_every_live_key_once():
    # An H100's 132 SMs, block size 32. gemma2-9b (KH 8, G 2) and gemma-7b
    # (KH 16, G 1): a 512-token chunk has 64 q-tiles, so two splits, fresh
    # (a 16-page table) or at 3584 (128 pages); 2048 tokens fill the card.
    assert pac.prefill_plan(1, 8, 512, 2, 128, 32, 132, 256) == 2
    assert pac.prefill_plan(1, 16, 512, 1, 128, 32, 132, 256) == 2
    assert pac.prefill_plan(1, 8, 512, 2, 16, 32, 132, 256) == 2
    assert pac.prefill_plan(1, 8, 2048, 2, 64, 32, 132, 256) == 1
    assert pac.prefill_plan(1, 8, 509, 2, 16, 32, 132, 256) == 2
    # Llama-3-8B (KH 8, G 4): 128 q-tiles a 512-token chunk, no split.
    assert pac.prefill_plan(1, 8, 512, 4, 16, 32, 132, 128) == 1
    assert pac.prefill_plan(3, 8, 100, 2, 40, 32, 132, 256) == 2
    assert pac.prefill_plan(1, 1, 16, 1, 4096, 32, 132, 256) == 32  # capped
    assert pac.prefill_plan(1, 8, 16, 2, 1, 32, 132, 256) == 1  # one tile
    assert pac.prefill_plan(1, 8, 16, 2, 8, 32, 132, 256) == 2  # two a split
    for hd in (128, 256):
        tile = pac.PREFILL_TILES[hd]
        for G in (1, 2, 4, 7):
            tq = pac.PREFILL_ROWS // G
            for T, start, short in ((37, 0, 0), (130, 13, 0), (70, 100, 5),
                                    (1, 0, 1)):
                n = start + T - short  # the last rows past kv_len
                W = -(-(start + T) // 16)
                plan = pac.prefill_plan(1, 2, T, G, W, 16, 8, hd)
                assert 1 <= plan <= max(1, -(-W * 16 // tile) // 2)
                for window in (0, 7, 45):
                    for splits in sorted({1, 2, 3, plan}):
                        for qt in range(pac.prefill_qtiles(T, G)):
                            runs = [pac.prefill_split_keys(
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


def _case(G, T, starts, lens, KH=2, hd=32, bs=8, L=2, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    W = max(-(-max(s + T for s in starts) // bs), 1)
    nb = B * W + 3
    q = torch.from_numpy(rng.standard_normal((B, T, KH * G, hd), np.float32))
    kv = torch.from_numpy(
        rng.standard_normal((L, nb, 2, bs, KH * hd), np.float32))
    tables = torch.from_numpy(
        rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32))
    return (q, kv, tables, torch.tensor(lens, dtype=torch.int32),
            torch.tensor(starts, dtype=torch.int32))


@pytest.mark.parametrize("window, softcap", [(0, 0.0), (45, 50.0)])
def test_split_model_equals_plain_prefill(window, softcap):
    """Both key tiles (64 keys at head_dim 128, 32 at 256), G in {1, 2, 4,
    7}: a continuing chunk whose window starts mid-page, a fresh chunk, a
    row shorter than its chunk and a kv_len 0 row; S from 1 to 5 and the
    plan's."""
    starts, T = [77, 0, 40, 0], 70
    lens = [77 + T, T, 40 + T - 9, 0]
    for G in (1, 2, 4, 7):
        q, kv, tables, kl, st = _case(G, T, starts, lens, seed=G)
        want = pac.paged_attention_prefill_plain(
            q, kv, tables, kl, st, 1, scale=0.2, window=window,
            softcap=softcap)
        for khd in (128, 256):
            plan = pac.prefill_plan(4, 2, T, G, tables.shape[1], 8, 8, khd)
            for splits in sorted({1, 2, 5, plan}):
                got = split_model(q, kv, tables, kl, st, 1, scale=0.2,
                                  splits=splits, window=window,
                                  softcap=softcap, kernel_hd=khd)
                np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
                assert not got[3].any()  # kv_len 0


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (e4m3 as ml_dtypes) as a torch tensor of the same
    bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_split_model_matches_pallas_prefill_kernel(cache):
    """gemma2-9b's attention (hd 256, G 2, scale 1/16, softcap 50) at
    the kernel's head_dim-256 partition, three splits: a 16-row chunk
    continuing at 200 under a window of 150 (row 0's first key 51,
    mid-page; the runs end at 64, 128 and 216) and a fresh one (two empty
    runs).

    "bf16": q and cache values that are bf16 numbers, held as fp32, so the
    Pallas kernel and the model both compute in fp32 (2e-5). "e4m3": bf16
    q over an e4m3 cache, at ``tests/test_torch_fp8_pallas.py``'s tolerance:
    the Pallas P·V rounds P to about 2^-8 and either bf16 output rounds
    once more."""
    rng = np.random.default_rng(8)
    B, T, H, KH, hd, nb, bs, W = 2, 16, 4, 2, 256, 30, 16, 14
    q = rng.standard_normal((B, T, H, hd), dtype=np.float32)
    kv = rng.standard_normal((1, nb, 2, bs, KH * hd), dtype=np.float32) * 2
    if cache == "bf16":
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
        kv = kv.astype(ml_dtypes.bfloat16).astype(np.float32)
    else:
        q = q.astype(ml_dtypes.bfloat16)
        kv = kv.astype(ml_dtypes.float8_e4m3fn)
    tables = rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32)
    starts = np.asarray([200, 0], np.int32)
    lens = starts + T
    q_pos = starts[:, None] + np.arange(T, dtype=np.int32)[None]
    window, scale, softcap = 150, 1.0 / 16, 50.0
    assert [pac.prefill_split_keys(216, 200, T, 2, 0, window, 3, s, hd)
            for s in range(3)] == [(51, 64), (64, 128), (128, 216)]
    assert [pac.prefill_split_keys(16, 0, T, 2, 0, window, 3, s, hd)
            for s in range(3)] == [(0, 0), (0, 0), (0, 16)]
    want = np.asarray(_pallas_jit(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(q_pos), 0, window=window,
        scale=scale, softcap=softcap), np.float32)
    got = split_model(_torch(q), _torch(kv), _torch(tables), _torch(lens),
                      _torch(starts), 0, scale=scale, splits=3,
                      window=window, softcap=softcap).float().numpy()
    if cache == "bf16":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        v_max = float(np.abs(kv.astype(np.float32)[:, :, 1]).max())
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                   atol=2.0 ** -8 * v_max)
