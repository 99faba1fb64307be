"""The CUDA-core split-KV decode's plan and algorithm, on the CPU.

``paged_decode_kernel`` (``csrc/paged_attention.cuh``: fp32 q at head_dim
16 to 256, bf16 q at 16 to 64, over a cache in q's type or e4m3) runs only
on the card, where ``chip_smoke.py`` holds it against the plain versions.
Here: its plan (``simt_decode_plan``, ``simt_tile``, ``simt_split_keys``:
shapes only, one wave, every live key read once) and a plain PyTorch model
of its algorithm (each split's tiles, each warp's lane groups with their
own flash state updated once a tile in the log2 domain, the lane groups,
warps and splits merged in a fixed order, and the decode-write's
substitution of this step's row for its slot) against
``paged_attention_decode_plain`` / ``paged_attention_decode_write_plain``
and the JAX package's Pallas decode and decode-write kernels in interpret
mode, at tiny-llama-debug's heads (H = KH = 8, head_dim 16) and at G 4.
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
    pallas_paged_attention_decode_write,
)
from production_stack_tpu_torch.ops import paged_attention_cuda as pac
from production_stack_tpu_torch.ops.fp8 import E4M3, to_cache_dtype

LOG2E = 1.4426950408889634
# fp32 on both sides; only the order of the sums and the softmax's
# rescaling points differ.
TOL = dict(rtol=0, atol=1e-5)
# Against the Pallas kernels: tests/test_torch_attention_pallas.py's fp32
# tolerance, and tests/test_torch_fp8_pallas.py's over e4m3 (the Pallas
# P·V keeps P to about 2^-8; this kernel does not round P).
PALLAS_TOL = dict(rtol=2e-5, atol=2e-5)
_pallas_jit = jax.jit(pallas_paged_attention, static_argnames=("scale",
                                                               "softcap"))
_fused_jit = jax.jit(pallas_paged_attention_decode_write,
                     static_argnames=("scale", "softcap"))


def test_simt_plan_covers_every_live_key_once():
    # Tiles: about 16 KB of K rows, at most 8 steps of a warp and 128 keys.
    assert [pac.simt_tile(hd, 4) for hd in (16, 32, 64, 128, 256)] == [
        128, 128, 64, 32, 16]
    assert [pac.simt_tile(hd, 1) for hd in (16, 32, 64, 128, 256)] == [
        128, 128, 128, 64, 64]
    assert pac.simt_lanes(16) == (4, 4, 8) and pac.simt_lanes(256) == (8, 32,
                                                                       1)
    # The tiny engine (KH 8, hd 16) at B=8 x 1024 on 132 SMs: a row's 128
    # KB of K and V (32 KB in e4m3) is under one split's 256 KB; fp32
    # Llama-3-8B heads (a 96 KB ring, two blocks an SM) at 4096 tokens.
    assert pac.simt_decode_plan(8, 8, 32, 32, 132, 16, 4) == 1
    assert pac.simt_decode_plan(8, 8, 32, 32, 132, 16, 1) == 1
    assert pac.simt_decode_plan(8, 8, 128, 32, 132, 128, 4) == 4
    assert pac.simt_decode_plan(1, 8, 128, 32, 132, 128, 4) == 16
    assert pac.simt_decode_plan(64, 8, 128, 32, 132, 128, 4) == 1
    assert pac.simt_decode_plan(1, 1, 4096, 32, 132, 16, 4) == 64  # capped
    for hd in (16, 32, 64, 128, 256):
        for item in (4, 2, 1):
            tile = pac.simt_tile(hd, item)
            for B in (1, 3, 8, 64):
                for W, bs in ((1, 8), (5, 8), (16, 32), (128, 32)):
                    S = pac.simt_decode_plan(B, 8, W, bs, 132, hd, item)
                    assert 1 <= S <= 64 and S <= max(1, -(-W * bs // tile))
                    assert S == 1 or S * 256 * 1024 <= W * bs * 2 * hd * item
                    assert S == 1 or B * 8 * S <= 4 * 132
                    for window in (0, 45):
                        for n in sorted({0, 1, tile - 1, tile, tile + 1,
                                         W * bs // 2, W * bs}):
                            lo = max(n - window, 0) if window else 0
                            seen = []
                            for s in range(S):
                                k0, k1 = pac.simt_split_keys(
                                    n, window, S, s, hd, item)
                                assert (k1 == k0 or k0 == lo
                                        or k0 % tile == 0)
                                seen += range(k0, k1)
                            assert seen == list(range(lo, n)), (hd, B, n)


def _merge(parts, G, hd):
    """Flash states (m, l, acc) merged in list order: (M, L, A)."""
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, A = torch.zeros(G), torch.zeros((G, hd))
    for m_s, l_s, acc_s in parts:
        c = torch.where(M == -math.inf, torch.zeros(G), torch.exp2(m_s - M))
        L = L + l_s * c
        A = A + acc_s * c[:, None]
    return M, L, A


def simt_model(q3, kv, tables, kv_lens, layer, *, scale, splits, window=0,
               softcap=0.0, write=None):
    """``paged_decode_kernel`` in plain PyTorch (fp32; K and V the cache's
    values, P not rounded): split s reads the keys ``simt_split_keys``
    gives it in tiles of ``simt_tile`` keys; lane group ``sub`` of warp w
    owns keys i * 8 KPW + w KPW + sub of each tile (i < the tile's steps)
    and updates its flash state once a tile (log2 domain); the lane
    groups merge, then the warps, then the splits, in order. ``write`` =
    (k_new, v_new, write_flat): the key whose flat slot is the row's write
    slot takes the new row in the cache's type. Returns [B, H, hd] in q's
    type."""
    B, H, hd = q3.shape
    _, nb, _, bs, lanes = kv.shape
    KH, W = lanes // hd, tables.shape[1]
    G = H // KH
    item = kv.dtype.itemsize
    tile = pac.simt_tile(hd, item)
    kpw = pac.simt_lanes(hd)[2]
    step = pac.SIMT_WARPS * kpw
    out = torch.zeros((B, H, hd))
    for b in range(B):
        n = int(kv_lens[b])
        wf = int(write[2][b]) if write is not None else -1
        for kh in range(KH):
            cols = slice(kh * hd, (kh + 1) * hd)
            qg = q3[b, kh * G:(kh + 1) * G].float()
            blocks = []
            for s in range(splits):
                k0, k1 = pac.simt_split_keys(n, window, splits, s, hd, item)
                groups = []
                for w in range(pac.SIMT_WARPS):
                    for sub in range(kpw):
                        m = torch.full((G,), -math.inf)
                        l_ = torch.zeros(G)
                        acc = torch.zeros((G, hd))
                        for t in (range(k0 - k0 % tile, k1, tile) if k1 > k0
                                  else ()):
                            pos = (t + torch.arange(0, tile, step)
                                   + w * kpw + sub)
                            live = (pos >= k0) & (pos < k1)
                            pages = tables[b, torch.clamp(pos // bs,
                                                          max=W - 1)]
                            rows = pos % bs
                            k = kv[layer, pages.long(), 0, rows, cols].float()
                            v = kv[layer, pages.long(), 1, rows, cols].float()
                            if write is not None and 0 <= wf < nb * bs:
                                sub_key = live & (
                                    (pages.long() * bs + rows) == wf)
                                new = [to_cache_dtype(x[b, cols], kv.dtype)
                                       .float() for x in write[:2]]
                                k[sub_key], v[sub_key] = new
                            x = (k @ qg.T) * scale
                            if softcap:
                                x = torch.tanh(x / softcap) * softcap
                            x = torch.where(live[:, None], x * LOG2E,
                                            torch.full_like(x, -math.inf))
                            m_new = torch.maximum(m, x.max(0).values)
                            mb = torch.where(m_new == -math.inf,
                                             torch.zeros(G), m_new)
                            alpha = torch.exp2(m - mb)
                            p = torch.exp2(x - mb)
                            l_ = l_ * alpha + p.sum(0)
                            acc = acc * alpha[:, None] + p.T @ v
                            m = m_new
                        groups.append((m, l_, acc))
                blocks.append(_merge(groups, G, hd))
            _, L, A = _merge(blocks, G, hd)
            out[b, kh * G:(kh + 1) * G] = torch.where(
                L[:, None] > 0, A / L.clamp_min(1e-30)[:, None],
                torch.zeros_like(A))
    return out.to(q3.dtype)


def _case(G, lens, cache_dtype, KH=8, hd=16, bs=8, L=2, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    W = max(-(-max(lens) // bs), 1)
    nb = B * W + 3
    q = torch.from_numpy(rng.standard_normal((B, KH * G, hd), np.float32))
    kv = torch.from_numpy(rng.standard_normal((L, nb, 2, bs, KH * hd),
                                              np.float32) * 2)
    tables = torch.from_numpy(
        rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32))
    return (q, to_cache_dtype(kv, cache_dtype), tables,
            torch.tensor(lens, dtype=torch.int32))


LENS = [0, 1, 7, 130, 129, 300, 77, 256]


@pytest.mark.parametrize("cache_dtype", [torch.float32, E4M3])
def test_simt_model_equals_plain_decode(cache_dtype):
    """G 1 (the tiny engine's heads) and 4; a kv_len 0 row, tiles cut
    ragged, with and without a window and a softcap; one split, three
    (empty runs included) and the plan's."""
    for G, KH in ((1, 8), (4, 2)):
        q, kv, tables, lens = _case(G, LENS, cache_dtype, KH=KH, seed=G)
        plan = pac.simt_decode_plan(len(LENS), KH, tables.shape[1], 8, 4, 16,
                                    cache_dtype.itemsize)
        for window, softcap in ((0, 0.0), (45, 30.0)):
            want = pac.paged_attention_decode_plain(
                q, kv, tables, lens, 1, scale=0.25, window=window,
                softcap=softcap)
            for splits in sorted({1, 3, plan}):
                got = simt_model(q, kv, tables, lens, 1, scale=0.25,
                                 splits=splits, window=window,
                                 softcap=softcap)
                np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
                assert not got[0].any()  # kv_len 0


def _pallas_inputs(cache_dtype, H, KH, seed):
    """q [B, H, 16] and a one-layer cache as numpy arrays (fp32 q and
    cache, or bf16 q over an e4m3 cache, as ml_dtypes), shuffled tables:
    rows of 150 keys (pages of 32), 0 and 77."""
    rng = np.random.default_rng(seed)
    B, hd, nb, bs, W = 3, 16, 16, 32, 5
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    kv = rng.standard_normal((1, nb, 2, bs, KH * hd), dtype=np.float32) * 2
    if cache_dtype == E4M3:
        q = q.astype(ml_dtypes.bfloat16)
        kv = kv.astype(ml_dtypes.float8_e4m3fn)
    tables = rng.permutation(nb)[:B * W].reshape(B, W).astype(np.int32)
    return q, kv, tables, np.asarray([150, 0, 77], np.int32)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(E4M3)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, kv: np.ndarray) -> None:
    want = np.asarray(want).astype(np.float32)
    if kv.dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, **PALLAS_TOL)
    else:
        v_max = float(np.abs(kv.astype(np.float32)[:, :, 1]).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                                   atol=2.0 ** -8 * v_max)


@pytest.mark.parametrize("cache_dtype", [torch.float32, E4M3])
def test_simt_model_matches_pallas_decode(cache_dtype):
    """G 1 at tiny-llama-debug's heads (fp32 q and cache), and G 4 over an
    e4m3 cache with bf16 q; a window of 100 and a softcap of 30; the plan's
    splits and three. The Pallas kernel runs in interpret mode."""
    H, KH = (8, 8) if cache_dtype == torch.float32 else (8, 2)
    q, kv, tables, lens = _pallas_inputs(cache_dtype, H, KH, seed=11)
    q_pos = (np.maximum(lens, 1) - 1)[:, None]
    want = _pallas_jit(jnp.asarray(q)[:, None], jnp.asarray(kv),
                       jnp.asarray(tables), jnp.asarray(lens),
                       jnp.asarray(q_pos), window=100, scale=0.25,
                       softcap=30.0)[:, 0]
    tq, tkv, tt, tl = _torch(q), _torch(kv), _torch(tables), _torch(lens)
    plan = pac.simt_decode_plan(3, KH, tables.shape[1], 32, 132, 16,
                                tkv.dtype.itemsize)
    for splits in (plan, 3):
        got = simt_model(tq, tkv, tt, tl, 0, scale=0.25, splits=splits,
                         window=100, softcap=30.0)
        _close(got, want, kv)
        assert not got[1].float().any()


def test_simt_substitution_under_prefix_sharing():
    """The decode-write rule: two rows share a full prefix page and each
    writes its own last page (row 0 at its last position, row 1 five
    before its end; row 2 drops its write). Substituting the new rows
    (every split; the model leaves the cache to split 0's store) equals
    the Pallas decode-write, which writes the cache and reads it back, and
    the plain version; both caches come out the same."""
    rng = np.random.default_rng(12)
    B, H, KH, hd, nb, bs = 3, 8, 8, 16, 12, 32
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    kv = rng.standard_normal((1, nb, 2, bs, KH * hd), dtype=np.float32)
    shared = 4  # a full prefix page both rows 0 and 1 read
    tables = np.asarray([[shared, 7, 2, 0], [shared, 9, 5, 0],
                         [1, 3, 0, 0]], np.int32)
    lens = np.asarray([100, 70, 40], np.int32)
    pos = [99, 64, 39]
    wf = np.asarray([int(tables[i, p // bs]) * bs + p % bs
                     for i, p in enumerate(pos)], np.int32)
    wf[2] = nb * bs  # dropped
    k_new = rng.standard_normal((B, KH * hd), dtype=np.float32)
    v_new = rng.standard_normal((B, KH * hd), dtype=np.float32)
    want, want_kv = _fused_jit(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), 0, jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(wf), window=0, scale=0.25, softcap=0.0)
    new = (_torch(k_new), _torch(v_new), _torch(wf))
    cache = _torch(kv)
    plain = pac.paged_attention_decode_write_plain(
        _torch(q), cache, _torch(tables), _torch(lens), 0, *new, scale=0.25)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want_kv))
    for splits in (1, 3):
        got = simt_model(_torch(q), _torch(kv), _torch(tables), _torch(lens),
                         0, scale=0.25, splits=splits, write=new)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **PALLAS_TOL)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
