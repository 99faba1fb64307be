"""The bf16 head_dim-256 split-KV decode's design, on the CPU.

``decode_split_kernel<256, G, kWrite, false>`` (``csrc/decode_splitkv.cuh``)
runs only on the card, where ``chip_smoke.py`` holds it against the plain
versions. Here: its plan (``decode_plan`` at head_dim 256 over a bf16
cache: 32-key tiles, 8 keys a warp, two blocks an SM, one wave, shapes
only); its fragments, rebuilt lane by lane from a staged tile through
models of ldmatrix (plain and .trans) and of the mma.sync fragment layouts
(PTX ISA, m16n8k16 and m16n8k8: A rows lane / 4 and + 8, k columns 2 (lane
% 4) + {0, 1}, and + 8 at k16; B k rows the same, column lane / 4; D rows
lane / 4 and + 8, columns 2 (lane % 4) + {0, 1}), which must give S = Q Kᵀ
(each key's scores computed by the one warp that owns it) and Oᵀ = Vᵀ Pᵀ
(m16n8k8: the warp's 8 keys as k, the G <= 8 heads as n8, no padding
rows); the staging layout (whole rows from the bulk copy engine, padded
by 16 bytes), whose fragment loads hit every bank once a quarter-warp;
and a model of the kernel's split and
merge against the plain version and the JAX package's Pallas decode and
decode-write kernels in interpret mode.
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

HD = 256
TILE = 32  # keys of a tile: 8 a warp, 4 warps
KPW = 8  # keys a warp
KW = 8  # the keys of warp 1 in a tile: rows 8..15
LOG2E = 1.4426950408889634
_pallas_jit = jax.jit(pallas_paged_attention,
                      static_argnames=("scale", "softcap"))
_fused_jit = jax.jit(pallas_paged_attention_decode_write,
                     static_argnames=("scale", "softcap"))


def test_hd256_bf16_plan_fills_one_wave():
    # gemma2-9b (KH 8) and gemma-7b (KH 16) at 4096 tokens on an H100's
    # 132 SMs: a 96 KB ring, so two blocks an SM.
    assert pac.split_tile(HD) == TILE
    assert pac.decode_plan(8, 8, 128, 32, 132, HD) == 4
    assert pac.decode_plan(1, 8, 128, 32, 132, HD) == 33
    assert pac.decode_plan(64, 8, 128, 32, 132, HD) == 1
    assert pac.decode_plan(8, 16, 128, 32, 132, HD) == 2
    assert pac.decode_plan(1, 8, 1, 32, 132, HD) == 1  # a 32-key table
    assert pac.decode_plan(1, 8, 4, 32, 132, HD) == 2  # two tiles a split
    for B in (1, 3, 8, 16, 64):
        for W, bs in ((1, 8), (5, 8), (16, 32), (128, 32), (256, 16)):
            S = pac.decode_plan(B, 8, W, bs, 132, HD)
            assert 1 <= S <= 64 and S <= max(1, W * bs // (2 * TILE))
            assert S == 1 or B * 8 * S <= 2 * 132  # one wave, two an SM
            for window in (0, 45):
                for n in sorted({0, 1, 63, 64, 65, W * bs // 2, W * bs}):
                    lo = max(n - window, 0) if window else 0
                    seen = []
                    for s in range(S):
                        k0, k1 = pac.decode_split_keys(n, window, S, s, HD)
                        assert k1 == k0 or k0 == lo or k0 % TILE == 0
                        seen += range(k0, k1)
                    assert seen == list(range(lo, n)), (B, W, bs, n)


# ---------------------------------------------------------------------------
# Fragments, lane by lane.
# ---------------------------------------------------------------------------

def _bf16(rng, shape) -> np.ndarray:
    """Random bf16 values as float64 (exact)."""
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16).astype(
        np.float64)


def _stage(rows: np.ndarray, row0: int = KW) -> np.ndarray:
    """A 32-key tile's staging buffer (bf16 values [TILE * HD], indexed by
    byte offset / 2) with ``rows`` [n, HD] at rows row0.., each 16-byte
    chunk where the copier puts it (``bf16_stage_offset``)."""
    tile = np.zeros(pac.bf16_stage_offset(TILE, 0, HD) // 2)
    for i, row in enumerate(rows):
        for c in range(HD // 8):
            off = pac.bf16_stage_offset(row0 + i, c, HD) // 2
            tile[off:off + 8] = row[8 * c:8 * c + 8]
    return tile


def _ldmatrix(tile: np.ndarray, addrs, trans: bool):
    """ldmatrix.sync.m8n8.x4 (.trans): lanes 8 i .. 8 i + 7 give the byte
    addresses of matrix i's 8 rows of 8 bf16; returns regs[lane][i] = the
    two values lane receives of matrix i: (row lane / 4, columns 2 (lane %
    4) + {0, 1}), or with .trans (rows 2 (lane % 4) + {0, 1}, column lane /
    4)."""
    mats = [np.stack([tile[addrs[8 * i + r] // 2:addrs[8 * i + r] // 2 + 8]
                      for r in range(8)]) for i in range(4)]
    regs = []
    for lane in range(32):
        grp, tig = divmod(lane, 4)
        regs.append([(m[grp, 2 * tig], m[grp, 2 * tig + 1]) if not trans
                     else (m[2 * tig, grp], m[2 * tig + 1, grp])
                     for m in mats])
    return regs


def _s_from_fragments(q: np.ndarray, tile: np.ndarray) -> np.ndarray:
    """S [G, 8] of warp 1's 8 keys as the kernel builds it (m16n8k16): Q's
    A fragments (k-step kk: dims 16 kk + 2 tig + {0, 1} and + 8 of head
    grp; rows 8..15 zero), K's B fragments by ldmatrix from the staged
    rows (matrix i of call p: the 8 keys at chunk 4 p + i, i.e. b0, b1 of
    k-step 2 p and of 2 p + 1), column n the key KW + n."""
    G = q.shape[0]
    S = np.zeros((G, KPW))
    for p in range(HD // 32):
        addrs = [pac.bf16_stage_offset(KW + (lane & 7), 4 * p + (lane >> 3),
                                       HD) for lane in range(32)]
        regs = _ldmatrix(tile, addrs, trans=False)
        for half in range(2):  # k-steps 2 p and 2 p + 1
            kk = 2 * p + half
            A = np.zeros((16, 16))
            B = np.zeros((16, 8))
            for lane in range(32):
                grp, tig = divmod(lane, 4)
                if grp < G:
                    d = 16 * kk + 2 * tig
                    A[grp, [2 * tig, 2 * tig + 1]] = q[grp, [d, d + 1]]
                    A[grp, [2 * tig + 8, 2 * tig + 9]] = q[grp, [d + 8, d + 9]]
                B[[2 * tig, 2 * tig + 1], grp] = regs[lane][2 * half]
                B[[2 * tig + 8, 2 * tig + 9], grp] = regs[lane][2 * half + 1]
            S += (A @ B)[:G]
    return S


def _o_from_fragments(p: np.ndarray, tile: np.ndarray) -> np.ndarray:
    """O [G, HD] = P V over warp 1's 8 keys as the kernel's Oᵀ += Vᵀ Pᵀ
    (m16n8k8) builds it: Pᵀ's B fragment is the lane's S accumulator
    (keys 2 tig + {0, 1} of head grp), Vᵀ's A fragments one
    ldmatrix.trans two m-tiles (matrix i of call u: the 8 keys at chunk
    4 u + i; registers (0, 1) are a0, a1 of m-tile 2 u, (2, 3) those of
    2 u + 1), and m-tile t's rows grp, grp + 8 are the dims
    ``bf16_o_dims(grp, t)``."""
    G = p.shape[0]
    O = np.zeros((G, HD))
    for u in range(HD // 32):
        addrs = [pac.bf16_stage_offset(KW + (lane & 7), 4 * u + (lane >> 3),
                                       HD) for lane in range(32)]
        regs = _ldmatrix(tile, addrs, trans=True)
        for half in range(2):
            t = 2 * u + half
            A = np.zeros((16, 8))
            B = np.zeros((8, 8))
            for lane in range(32):
                grp, tig = divmod(lane, 4)
                A[grp, [2 * tig, 2 * tig + 1]] = regs[lane][2 * half]
                A[grp + 8, [2 * tig, 2 * tig + 1]] = regs[lane][2 * half + 1]
                if grp < G:
                    B[[2 * tig, 2 * tig + 1], grp] = p[grp, [2 * tig,
                                                             2 * tig + 1]]
            D = A @ B  # [16 dims, 8 heads]
            for grp in range(8):
                d0, d1 = pac.bf16_o_dims(grp, t)
                O[:, d0] += D[grp, :G]
                O[:, d1] += D[grp + 8, :G]
    return O


def _conflict_free(addrs):
    """A 16-byte access a lane: each quarter-warp (8 lanes; for ldmatrix,
    one matrix's 8 row addresses) must touch each of the 32 banks of 4
    bytes once."""
    for qw in range(4):
        banks = [(a // 4 + i) % 32 for a in addrs[8 * qw:8 * qw + 8]
                 for i in range(4)]
        if len(set(banks)) != 32:
            return False
    return True


def test_fragments_and_staging():
    """S = Q Kᵀ and O = P V from the fragments equal the plain products
    (float64 on both sides: products of bf16 values are exact, only the
    order of the sums differs) at G 1, 2 and 8; in the staging layout each
    row is one 16-byte-aligned run (a bulk copy's destination), no two
    chunks meet, and the fragment loads hit every bank once a
    quarter-warp."""
    rng = np.random.default_rng(256)
    for G in (1, 2, 8):
        q = _bf16(rng, (G, HD))
        p = rng.random((G, KPW)).astype(ml_dtypes.bfloat16).astype(
            np.float64)
        k, v = _bf16(rng, (KPW, HD)), _bf16(rng, (KPW, HD))
        np.testing.assert_allclose(_s_from_fragments(q, _stage(k)), q @ k.T,
                                   rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(_o_from_fragments(p, _stage(v)), p @ v,
                                   rtol=1e-12, atol=1e-9)
    chunks = HD // 8
    offs = [pac.bf16_stage_offset(r, c, HD) for r in range(TILE)
            for c in range(chunks)]
    assert len(set(offs)) == len(offs) and min(offs) == 0
    for r in range(TILE):
        row0 = pac.bf16_stage_offset(r, 0, HD)
        assert row0 % 16 == 0 and [pac.bf16_stage_offset(r, c, HD) - row0
                                   for c in range(chunks)] == list(
                                       range(0, 2 * HD, 16))
    assert pac.bf16_stage_offset(TILE, 0, HD) * 2 * 3 <= 227 * 1024 // 2
    for kw in range(0, TILE, KPW):  # each warp's 8 keys
        # K (ldmatrix) and Vᵀ (ldmatrix.trans) alike: matrix lane // 8 of
        # call p is the warp's keys at chunk 4 p + lane // 8.
        for p in range(HD // 32):
            assert _conflict_free([pac.bf16_stage_offset(
                kw + (lane & 7), 4 * p + (lane >> 3), HD)
                for lane in range(32)])


# ---------------------------------------------------------------------------
# A model of the kernel against the plain version and the Pallas kernels.
# ---------------------------------------------------------------------------

def _merge(parts, G):
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, A = torch.zeros(G), torch.zeros((G, HD))
    for m_s, l_s, acc_s in parts:
        c = torch.where(M == -math.inf, torch.zeros(G), torch.exp2(m_s - M))
        L = L + l_s * c
        A = A + acc_s * c[:, None]
    return M, L, A


def bf16_hd256_model(q3, kv, tables, kv_lens, layer, *, scale, splits,
                     window=0, softcap=0.0, write=None):
    """``decode_split_kernel<256, G, kWrite, false>`` in plain PyTorch
    (fp32; q, K and V the bf16 values, P rounded to bf16 as the kernel
    rounds it): split s reads the keys ``decode_split_keys`` gives it in
    32-key tiles; warp w owns keys 8 w .. 8 w + 7 of each tile with its
    own flash state (log2 domain), one update per 8 keys; the warps merge
    in order, then the splits. ``write`` = (k_new, v_new, write_flat): the
    key whose flat slot is the row's write slot takes the new row. Returns
    [B, H, HD] bf16."""
    B, H, _ = q3.shape
    _, nb, _, bs, lanes = kv.shape
    KH, W = lanes // HD, tables.shape[1]
    G = H // KH
    out = torch.zeros((B, H, HD))
    for b in range(B):
        n = int(kv_lens[b])
        wf = int(write[2][b]) if write is not None else -1
        for kh in range(KH):
            cols = slice(kh * HD, (kh + 1) * HD)
            qg = q3[b, kh * G:(kh + 1) * G].float()
            blocks = []
            for s in range(splits):
                k0, k1 = pac.decode_split_keys(n, window, splits, s, HD)
                warps = []
                for w in range(TILE // KPW):
                    m = torch.full((G,), -math.inf)
                    l_ = torch.zeros(G)
                    acc = torch.zeros((G, HD))
                    for t in (range(k0 - k0 % TILE, k1, TILE) if k1 > k0
                              else ()):
                        lo_w = max(t + KPW * w, k0)
                        hi_w = min(t + KPW * w + KPW, k1)
                        if hi_w <= lo_w:
                            continue
                        pos = torch.arange(lo_w, hi_w)
                        pages = tables[b, torch.clamp(pos // bs, max=W - 1)]
                        rows = pos % bs
                        k = kv[layer, pages.long(), 0, rows, cols].float()
                        v = kv[layer, pages.long(), 1, rows, cols].float()
                        if write is not None and 0 <= wf < nb * bs:
                            sub = (pages.long() * bs + rows) == wf
                            k[sub] = write[0][b, cols].float()
                            v[sub] = write[1][b, cols].float()
                        x = (k @ qg.T) * scale
                        if softcap:
                            x = torch.tanh(x / softcap) * softcap
                        x = x * LOG2E
                        m_new = torch.maximum(m, x.max(0).values)
                        mb = torch.where(m_new == -math.inf,
                                         torch.zeros(G), m_new)
                        alpha = torch.exp2(m - mb)
                        p = torch.exp2(x - mb)
                        l_ = l_ * alpha + p.sum(0)
                        acc = (acc * alpha[:, None]
                               + p.T.bfloat16().float() @ v)
                        m = m_new
                    warps.append((m, l_, acc))
                blocks.append(_merge(warps, G))
            _, L, A = _merge(blocks, G)
            out[b, kh * G:(kh + 1) * G] = torch.where(
                L[:, None] > 0, A / L.clamp_min(1e-30)[:, None],
                torch.zeros_like(A))
    return out.bfloat16()


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _agree(got: torch.Tensor, want) -> None:
    """tests/test_numerics_oracle.py's ``_agree`` rule, rtol 2e-3 and an
    atol of ``atol_scale`` times the largest |want|, with atol_scale =
    2^-7: one bf16 step at the largest |want|. Both sides read the same
    bf16 q, K and V, accumulate in fp32, round P to bf16 (P·V in bf16
    operands) and round the output to bf16; they differ in where the
    running max rescales P and in the order of the sums, which can move an
    output across a bf16 rounding boundary."""
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-3,
                               atol=2.0 ** -7 * scale)


@pytest.mark.parametrize("write", [False, True])
def test_model_matches_plain_and_pallas(write):
    """H=4, KH=2 (G 2), bf16 q and cache, rows of 150 keys (five 32-key
    tiles, the last ragged), 77 and an empty padding row, a window of 100
    (starting mid-page) and the softcap of 50; three splits (empty runs
    included) and the plan's. The Pallas kernels run in interpret mode."""
    rng = np.random.default_rng(7 + write)
    B, H, KH, nb, bs, W = 3, 4, 2, 16, 32, 5
    q = rng.standard_normal((B, H, HD)).astype(ml_dtypes.bfloat16)
    kv = (rng.standard_normal((1, nb, 2, bs, KH * HD)) * 2).astype(
        ml_dtypes.bfloat16)
    tables = rng.permutation(nb)[:B * W].reshape(B, W).astype(np.int32)
    lens = np.asarray([150, 0, 77], np.int32)
    scale, window, cap = 1.0 / 16, 100, 50.0
    tq, tkv, tt, tl = _torch(q), _torch(kv), _torch(tables), _torch(lens)
    new = None
    if not write:
        q_pos = (np.maximum(lens, 1) - 1)[:, None]
        want = _pallas_jit(jnp.asarray(q)[:, None], jnp.asarray(kv),
                           jnp.asarray(tables), jnp.asarray(lens),
                           jnp.asarray(q_pos), window=window, scale=scale,
                           softcap=cap)[:, 0]
        plain = pac.paged_attention_decode_plain(
            tq, tkv, tt, tl, 0, scale=scale, window=window, softcap=cap)
    else:
        k_new = rng.standard_normal((B, KH * HD)).astype(ml_dtypes.bfloat16)
        v_new = rng.standard_normal((B, KH * HD)).astype(ml_dtypes.bfloat16)
        pos = [max(int(n) - 1, 0) for n in lens]
        pos[0] -= 5  # row 0 writes 5 positions before its end
        wf = np.asarray([int(tables[i, p // bs]) * bs + p % bs
                         for i, p in enumerate(pos)], np.int32)
        wf[1] = nb * bs  # the padding row drops its write
        want, want_kv = _fused_jit(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
            jnp.asarray(lens), 0, jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(wf), window=window, scale=scale, softcap=cap)
        new = (_torch(k_new), _torch(v_new), _torch(wf))
        cache = tkv.clone()
        plain = pac.paged_attention_decode_write_plain(
            tq, cache, tt, tl, 0, *new, scale=scale, window=window,
            softcap=cap)
        assert np.array_equal(cache.view(torch.int16).numpy(),
                              np.asarray(want_kv).view(np.int16))
    plan = pac.decode_plan(B, KH, W, bs, 132, HD)
    for splits in (3, plan):
        got = bf16_hd256_model(tq, tkv, tt, tl, 0, scale=scale,
                               splits=splits, window=window, softcap=cap,
                               write=new)
        assert got.dtype == torch.bfloat16 and not got[1].float().any()
        _agree(got, want)
        _agree(got, plain.float().numpy())
