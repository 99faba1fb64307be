"""The split-KV decode kernel's plan and algorithm, on the CPU.

``decode_split_kernel`` (``csrc/decode_splitkv.cu``) runs only on the card,
where ``chip_smoke.py`` holds it against the plain versions. Here: the
split count the wrapper plans and the key range each split reads
(``decode_plan``, ``decode_split_keys``) at both key tiles (64 keys at
head_dim 128, 32 at 256); a plain PyTorch model of the kernel's algorithm
(each 16-key group of a tile with its own softmax state in the log2
domain, the groups' and then the splits' (m, l, acc) merged in a fixed
order, and decode-write's
substitution of this step's row) against ``paged_attention_decode_plain``,
``paged_attention_decode_write_plain`` and the JAX package's Pallas decode
kernel; and the engine rule that lets decode-write skip ordering between
blocks: no row reads a page another row writes in the same step.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops.paged_attention_pallas import (
    pallas_paged_attention,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.ops import paged_attention_cuda as pac

LOG2E = 1.4426950408889634
# fp32 inputs, fp32 arithmetic on both sides; only the order of the sums
# and the softmax's rescaling points differ.
TOL = dict(rtol=0, atol=1e-5)


def _tile_rows(tables, b, pos, bs, W):
    """Pages and rows of positions ``pos`` of row ``b`` (the table clamped
    to its last entry, as the kernels clamp it)."""
    pages = tables[b, torch.clamp(pos // bs, max=W - 1)].long()
    return pages, pos % bs


def _merge(parts, G, hd):
    """Flash states (m, l, acc) merged in list order: (M, L, A)."""
    M = torch.stack([p[0] for p in parts]).max(0).values
    L = torch.zeros(G)
    A = torch.zeros((G, hd))
    for m_s, l_s, acc_s in parts:
        c = torch.where(M == -math.inf, torch.zeros(G), torch.exp2(m_s - M))
        L = L + l_s * c
        A = A + acc_s * c[:, None]
    return M, L, A


def split_model(q3, kv_pages, tables, kv_lens, layer, *, scale, splits,
                window=0, softcap=0.0, write=None, kernel_hd=128):
    """``decode_split_kernel`` in plain PyTorch (fp32, where the kernel
    rounds P to bf16) as built at head dim ``kernel_hd``, whatever q's:
    split s reads the keys ``decode_split_keys`` gives it in tiles of
    ``SPLIT_TILES[kernel_hd]`` keys (64 at head_dim 128, 32 at 256); warp
    w of its block owns keys TW w .. TW w + TW - 1 of every tile (TW = 16
    at head_dim 128, 8 at 256) and updates its own flash state (log2
    domain) once per TW keys; the warps merge in order, then the splits.
    ``write`` = (k_new,
    v_new, write_flat): a key whose flat slot is the row's write slot comes
    from k_new / v_new, and the cache is left as it was (split 0's store is
    the caller's). Returns [B, H, hd]."""
    B, H, hd = q3.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH, W = lanes // hd, tables.shape[1]
    G = H // KH
    T = pac.SPLIT_TILES[kernel_hd]
    TW = T // 4
    out = torch.zeros((B, H, hd))
    for b in range(B):
        n = int(kv_lens[b])
        wf = int(write[2][b]) if write is not None else -1
        wf = wf if 0 <= wf < nb * bs else -1
        for kh in range(KH):
            lanes_kh = slice(kh * hd, (kh + 1) * hd)
            qg = q3[b, kh * G:(kh + 1) * G].float()  # [G, hd]
            blocks = []
            for s in range(splits):
                k0, k1 = pac.decode_split_keys(n, window, splits, s,
                                               kernel_hd)
                warps = []
                for w in range(T // TW):
                    m = torch.full((G,), -math.inf)
                    l = torch.zeros(G)
                    acc = torch.zeros((G, hd))
                    tiles = range(k0 - k0 % T, k1, T) if k1 > k0 else ()
                    for t in tiles:
                        lo_w = max(t + TW * w, k0)
                        hi_w = min(t + TW * (w + 1), k1)
                        if hi_w <= lo_w:
                            continue
                        pos = torch.arange(lo_w, hi_w)
                        pages, rows = _tile_rows(tables, b, pos, bs, W)
                        k = kv_pages[layer, pages, 0, rows, lanes_kh].float()
                        v = kv_pages[layer, pages, 1, rows, lanes_kh].float()
                        if wf >= 0:
                            sub = (pages * bs + rows) == wf
                            k[sub] = write[0][b, lanes_kh].float()
                            v[sub] = write[1][b, lanes_kh].float()
                        x = (k @ qg.T) * scale  # [keys, G]
                        if softcap:
                            x = torch.tanh(x / softcap) * softcap
                        x = x * LOG2E
                        m_new = torch.maximum(m, x.max(0).values)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(x - m_new)
                        l = l * alpha + p.sum(0)
                        acc = acc * alpha[:, None] + p.T @ v
                        m = m_new
                    warps.append((m, l, acc))
                blocks.append(_merge(warps, G, hd))
            _, L, A = _merge(blocks, G, hd)
            res = torch.where(L[:, None] > 0, A / L.clamp_min(1e-30)[:, None],
                              torch.zeros_like(A))
            out[b, kh * G:(kh + 1) * G] = res
    return out.to(q3.dtype)


def _case(G, lens, KH=2, hd=32, bs=8, L=2, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    W = max(-(-max(lens) // bs), 1)
    nb = B * W + 3
    q = torch.from_numpy(rng.standard_normal((B, KH * G, hd), np.float32))
    kv = torch.from_numpy(
        rng.standard_normal((L, nb, 2, bs, KH * hd), np.float32))
    tables = torch.from_numpy(
        rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32))
    return q, kv, tables, torch.tensor(lens, dtype=torch.int32)


LENS = [0, 1, 7, 8, 9, 40, 77, 128]


def test_decode_plan_covers_every_live_key_once():
    # Llama-3-8B heads (KH=8, bs=32, a 4096-token table) on an H100's 132
    # SMs: one wave of blocks, more splits the fewer the sequences.
    assert pac.decode_plan(8, 8, 128, 32, 132, 128) == 4
    assert pac.decode_plan(16, 8, 128, 32, 132, 128) == 2
    assert pac.decode_plan(1, 8, 128, 32, 132, 128) == 32  # two tiles a split
    assert pac.decode_plan(64, 8, 128, 32, 132, 128) == 1
    assert pac.decode_plan(1, 8, 4, 32, 132, 128) == 1  # a 128-key table
    assert pac.decode_plan(1, 1, 4096, 32, 132, 128) == 64  # capped
    # At head_dim 256 a tile holds 32 keys: gemma2-9b (KH 8) and gemma-7b
    # (KH 16) at 4096 tokens.
    assert pac.SPLIT_TILES == {128: 64, 256: 32}
    assert pac.decode_plan(8, 8, 128, 32, 132, 256) == 4
    assert pac.decode_plan(8, 16, 128, 32, 132, 256) == 2
    assert pac.decode_plan(1, 8, 128, 32, 132, 256) == 33
    assert pac.decode_plan(1, 8, 2, 32, 132, 256) == 1  # a 64-key table
    assert pac.decode_plan(1, 8, 4, 32, 132, 256) == 2  # two tiles a split
    for hd in (128, 256):
        tile = pac.SPLIT_TILES[hd]
        for B in (1, 3, 8, 64):
            for W, bs in ((1, 8), (5, 8), (16, 32), (128, 32)):
                S = pac.decode_plan(B, 8, W, bs, 132, hd)
                assert 1 <= S <= 64 and S <= max(1, W * bs // (2 * tile))
                for window in (0, 45):
                    for n in sorted({0, 1, 31, 32, 33, W * bs // 2, W * bs}):
                        lo = max(n - window, 0) if window else 0
                        seen = []
                        for s in range(S):
                            k0, k1 = pac.decode_split_keys(n, window, S, s,
                                                           hd)
                            assert k0 <= k1
                            assert k1 == k0 or (
                                k0 == lo or k0 % tile == 0), (k0, tile)
                            seen += range(k0, k1)
                        assert seen == list(range(lo, n)), (
                            tile, B, W, bs, window, n)


@pytest.mark.parametrize("window, softcap", [(0, 0.0), (45, 30.0)])
def test_split_model_equals_plain_decode(window, softcap):
    """Both key tiles: 64 keys (head_dim 128) and 32 (head_dim 256)."""
    for G in (1, 2, 4, 8):
        q, kv, tables, lens = _case(G, LENS, seed=G)
        want = pac.paged_attention_decode_plain(
            q, kv, tables, lens, 1, scale=0.2, window=window, softcap=softcap)
        for khd in (128, 256):
            for splits in (1, 3, pac.decode_plan(len(LENS), 2, tables.shape[1],
                                                 8, 4, khd)):
                got = split_model(q, kv, tables, lens, 1, scale=0.2,
                                  splits=splits, window=window,
                                  softcap=softcap, kernel_hd=khd)
                np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
            assert torch.equal(got[0], torch.zeros_like(got[0]))  # kv_len 0


def test_split_model_substitution_equals_plain_decode_write():
    """Each row writes its last position, row 5 five positions before its
    end, row 0 (kv_len 0) and row 2 drop their writes; a window of 11
    starts mid-page."""
    G, KH, hd, bs = 4, 2, 32, 8
    q, kv, tables, lens = _case(G, LENS, seed=9)
    rng = np.random.default_rng(10)
    B, nb = len(LENS), kv.shape[1]
    k_new = torch.from_numpy(rng.standard_normal((B, KH * hd), np.float32))
    v_new = torch.from_numpy(rng.standard_normal((B, KH * hd), np.float32))
    pos = [max(n - 1, 0) for n in LENS]
    pos[5] -= 5
    wf = [int(tables[i, p // bs]) * bs + p % bs for i, p in enumerate(pos)]
    wf[0], wf[2] = nb * bs, -1
    wf = torch.tensor(wf, dtype=torch.int32)
    for window in (0, 11):
        want_kv = kv.clone()
        want = pac.paged_attention_decode_write_plain(
            q, want_kv, tables, lens, 0, k_new, v_new, wf, scale=0.2,
            window=window)
        for splits, khd in ((1, 128), (4, 128), (4, 256)):
            got = split_model(q, kv, tables, lens, 0, scale=0.2,
                              splits=splits, window=window,
                              write=(k_new, v_new, wf), kernel_hd=khd)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # The cache is as split 0 leaves it: the rows written, nothing else.
    flat = kv.clone().view(-1, KH * hd)
    keep = [i for i in range(B) if 0 <= int(wf[i]) < nb * bs]
    w = wf.long()[keep]
    rows = (w // bs) * 2 * bs + w % bs  # layer 0
    flat[rows] = k_new[keep]
    flat[rows + bs] = v_new[keep]
    assert torch.equal(flat.view_as(kv), want_kv)


_pallas_jit = jax.jit(pallas_paged_attention, static_argnames=("scale",))


def test_split_model_matches_pallas_decode_kernel():
    # The setup of tests/test_torch_attention_pallas.py (G=4, a length that
    # crosses a 32-token page, an empty row), three splits. The Pallas
    # kernel runs in interpret mode; fp32 on both sides.
    rng = np.random.default_rng(0)
    B, H, KH, hd, nb, bs, W = 3, 8, 2, 32, 8, 32, 2
    q = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    kv = rng.standard_normal((1, nb, 2, bs, KH * hd), dtype=np.float32)
    tables = rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32)
    kv_lens = np.asarray([13, 0, 41], np.int32)
    q_pos = (kv_lens - 1)[:, None]
    scale = 1.0 / np.sqrt(hd)
    want = np.asarray(_pallas_jit(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_pos), scale=scale))[:, 0]
    got = split_model(torch.from_numpy(q[:, 0].copy()), torch.from_numpy(kv),
                      torch.from_numpy(tables), torch.from_numpy(kv_lens), 0,
                      scale=scale, splits=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_no_row_reads_a_slot_another_row_writes():
    """Prefix sharing in the port's engine: two prompts with a common
    prefix of three full pages, served together after the prefix is cached.
    In every decode step (one step at a time, and four-step bursts; each
    synchronous, and pipelined with the arrival gates open, where deferred
    releases, lookahead pages and suppressed dedup swaps come into play),
    no row's write slot lies in a page that another serving row's table
    reads. A row that writes nothing (a member finished on the host whose
    burst runs on; its kv_len is 0) serves no token: what it reads is
    discarded."""
    bs = 8
    prefix = list(range(1, 3 * bs + 1))
    sp = SamplingParams(max_tokens=10, temperature=0.0, ignore_eos=True)
    for steps, pipelined in ((1, False), (4, False), (1, True), (4, True)):
        engine = LLMEngine(EngineConfig(
            model="tiny-llama-debug", device="cpu", block_size=bs,
            max_prefill_tokens=64, max_model_len=128, num_kv_blocks=64,
            max_num_seqs=4, num_decode_steps=steps, overlap_decode=pipelined,
            adaptive_decode_quiet_s=0.0))
        runner = engine.runner
        forward = runner.model.forward
        seen = []

        def spy(params, tokens, positions, write_idx, tables, kv_lens, *a,
                **kw):
            if tokens.shape[1] == 1:
                seen.append((write_idx[:, 0].clone(), tables.clone(),
                             kv_lens.clone()))
            return forward(params, tokens, positions, write_idx, tables,
                           kv_lens, *a, **kw)

        runner.model.forward = spy
        engine.generate([prefix + [40]], sp)  # caches the prefix pages
        seen.clear()
        engine.generate([prefix + [41, 42], prefix + [43]], sp)
        assert seen and engine.allocator.hit_tokens >= 2 * len(prefix)
        assert (engine.pipelined_bursts_total > 0) == pipelined
        shared = False
        drop = runner.num_blocks * bs
        for wf, tables, lens in seen:
            serving = [0 <= w < drop for w in wf.tolist()]
            reads = [set(tables[i, :-(-int(n) // bs)].tolist())
                     if n > 0 and serving[i] else set()
                     for i, n in enumerate(lens)]
            shared |= any(reads[i] & reads[j] for i in range(len(reads))
                          for j in range(i))
            for i, w in enumerate(wf.tolist()):
                if lens[i] == 0 or not serving[i]:
                    continue
                for j, r in enumerate(reads):
                    assert j == i or w // bs not in r, (steps, i, j, w)
        assert shared  # the two rows did read common prefix pages
