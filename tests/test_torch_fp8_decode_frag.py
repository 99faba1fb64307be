"""The e4m3 split-KV decode's fragment design, on the CPU.

``decode_split_kernel``'s e4m3 form (``csrc/decode_splitkv.cuh``) builds
its tensor-core fragments from the staged e4m3 bytes and runs only on the
card. Here, through the Python mirror of its maps
(``paged_attention_cuda.e4m3_stage_offset``, ``e4m3_k_dims``,
``e4m3_s_key``, ``e4m3_o_dims``): lane by lane, the 16-byte loads of the
staged rows, the byte permutes and the mma.sync m16n8k16 fragment layouts
(PTX ISA: A rows lane / 4 and + 8, k columns 2 (lane % 4) + {0, 1} and
+ 8; B k rows the same, column lane / 4; D rows lane / 4 and + 8, columns
2 (lane % 4) + {0, 1}) rebuild S = Q Kᵀ and Oᵀ = Vᵀ Pᵀ, which must equal
the plain products over all 256 e4m3 codes (NaN where the plain product is
NaN); the staging layout is a bijection whose fragment loads and copies
hit every bank once a quarter-warp; the e4m3 plan covers every live key
once; and a model of the kernel at its e4m3 tile geometry (64-key tiles,
16 keys a warp, P rounded to bf16) agrees with the JAX package's Pallas
decode and decode-write in interpret mode, under
``tests/test_torch_fp8_pallas.py``'s tolerance.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops import paged_attention_cuda as pac
from production_stack_tpu_torch.ops.fp8 import cast_e4m3
from tests.test_torch_fp8_pallas import (
    RTOL,
    _fused_jit,
    _inputs,
    _pallas_jit,
    _torch,
)

TILE = 64  # keys of an e4m3 tile at either head dim
KW = 16  # the keys of warp 1 in a tile: rows 16..31
LOG2E = 1.4426950408889634


def _values(codes: np.ndarray) -> np.ndarray:
    """e4m3 codes as float64 values (NaN for 0x7f and 0xff)."""
    return np.asarray(codes, np.uint8).view(ml_dtypes.float8_e4m3fn).astype(
        np.float64)


def _stage(rows: np.ndarray, hd: int, row0: int = KW) -> np.ndarray:
    """A 64-key tile's staging buffer with ``rows`` (e4m3 codes [n, hd])
    at rows row0.. , each 16-byte chunk where the copier puts it."""
    tile = np.zeros(TILE * hd, np.uint8)
    for i, row in enumerate(rows):
        for c in range(hd // 16):
            off = pac.e4m3_stage_offset(row0 + i, c, hd)
            tile[off:off + 16] = row[16 * c:16 * c + 16]
    return tile


def _load16(tile: np.ndarray, r: int, c: int, hd: int) -> np.ndarray:
    off = pac.e4m3_stage_offset(r, c, hd)
    return tile[off:off + 16]


def _word(chunk: np.ndarray, w: int) -> int:
    return int(chunk[4 * w:4 * w + 4].view(np.uint32)[0])


def _byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's __byte_perm: byte n of the result is byte (sel >> 4 n) & 7 of
    the eight bytes of (b, a)."""
    pool = a | (b << 32)
    return sum(((pool >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _pair(x: int) -> tuple:
    """The bf16x2 register e4m3x2_to_bf16x2 makes of the low 16 bits."""
    return tuple(_values(np.array([x & 0xFF, (x >> 8) & 0xFF])))


def _codes(rng, n: int, hd: int, nan: bool) -> np.ndarray:
    """[n, hd] e4m3 codes running through all 256 in shuffled orders; the
    two NaN codes replaced by 0 unless ``nan``."""
    c = np.concatenate([rng.permutation(256) for _ in range(
        -(-n * hd // 256))])[:n * hd].astype(np.uint8)
    if not nan:
        c[(c == 0x7F) | (c == 0xFF)] = 0
    return c.reshape(n, hd)


def _s_from_fragments(q: np.ndarray, tile: np.ndarray, hd: int):
    """S [G, 16] of the warp's 16 keys, as the kernel's mma.sync builds it:
    Q's A fragments in e4m3_k_dims order, K's B fragments word by word from
    the staged rows, n8 tile j's column n the key e4m3_s_key(n, j)."""
    G = q.shape[0]
    S = np.zeros((G, 16))
    for j in range(2):
        for kk in range(hd // 16):
            A = np.zeros((16, 16))
            B = np.zeros((16, 8))
            for lane in range(32):
                grp, tig = divmod(lane, 4)
                d = pac.e4m3_k_dims(tig, kk)
                if grp < G:
                    A[grp, [2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9]] = \
                        q[grp, list(d)]
                chunk = _load16(tile, KW + pac.e4m3_s_key(grp, j),
                                tig + 4 * (kk // 4), hd)
                word = _word(chunk, kk % 4)
                B[[2 * tig, 2 * tig + 1], grp] = _pair(word)
                B[[2 * tig + 8, 2 * tig + 9], grp] = _pair(word >> 16)
            D = A @ B
            for n in range(8):
                S[:, pac.e4m3_s_key(n, j)] += D[:G, n]
    return S


def _o_from_fragments(p: np.ndarray, tile: np.ndarray, hd: int):
    """O [G, hd] = P V over the warp's 16 keys as the kernel's Oᵀ += Vᵀ Pᵀ
    builds it: Pᵀ's B fragment is the lane's S accumulator (keys
    e4m3_s_key(2 tig + e, j)), Vᵀ's A fragments come from key rows
    4 tig .. 4 tig + 3 of the staged tile through a byte permute, and
    m-tile t's rows grp, grp + 8 are the dims e4m3_o_dims(grp, t)."""
    G = p.shape[0]
    O = np.zeros((G, hd))
    for t in range(hd // 16):
        A = np.zeros((16, 16))
        B = np.zeros((16, 8))
        for lane in range(32):
            grp, tig = divmod(lane, 4)
            if grp < G:
                for e in range(2):
                    B[2 * tig + e, grp] = p[grp, pac.e4m3_s_key(2 * tig + e, 0)]
                    B[2 * tig + 8 + e, grp] = p[grp,
                                                pac.e4m3_s_key(2 * tig + e, 1)]
            words = [_word(_load16(tile, KW + 4 * tig + i, grp + 8 * (t // 8),
                                   hd), (t % 8) // 2) for i in range(4)]
            sel = 0x5140 if t % 2 == 0 else 0x7362
            x01 = _byte_perm(words[0], words[1], sel)
            x23 = _byte_perm(words[2], words[3], sel)
            A[grp, [2 * tig, 2 * tig + 1]] = _pair(x01)
            A[grp + 8, [2 * tig, 2 * tig + 1]] = _pair(x01 >> 16)
            A[grp, [2 * tig + 8, 2 * tig + 9]] = _pair(x23)
            A[grp + 8, [2 * tig + 8, 2 * tig + 9]] = _pair(x23 >> 16)
        D = A @ B  # [16 dims, 8 heads]
        for grp in range(8):
            d0, d1 = pac.e4m3_o_dims(grp, t)
            O[:, d0] += D[grp, :G]
            O[:, d1] += D[grp + 8, :G]
    return O


@pytest.mark.parametrize("hd", [128, 256])
def test_fragment_products_equal_plain_over_all_codes(hd):
    """Every e4m3 code in K and in V; first without the NaN codes (every
    value compared), then with them (NaN exactly where the plain product
    has it). float64 on both sides: the products of bf16 q or P and
    e4m3 values are exact, only the order of the sums differs."""
    rng = np.random.default_rng(hd)
    G = 8
    q = rng.standard_normal((G, hd)).astype(ml_dtypes.bfloat16).astype(
        np.float64)
    p = rng.random((G, 16)).astype(ml_dtypes.bfloat16).astype(np.float64)
    for nan in (False, True):
        k = _codes(rng, 16, hd, nan)
        v = _codes(rng, 16, hd, nan)
        np.testing.assert_allclose(_s_from_fragments(q, _stage(k, hd), hd),
                                   q @ _values(k).T, rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(_o_from_fragments(p, _stage(v, hd), hd),
                                   p @ _values(v), rtol=1e-12, atol=1e-9)
        if nan:
            assert np.isnan(q @ _values(k).T).any()
            assert np.isnan(p @ _values(v)).any()


def _conflict_free(addrs):
    """A 16-byte access a lane: each quarter-warp (8 lanes) must touch each
    of the 32 banks of 4 bytes once."""
    for qw in range(4):
        banks = [(a // 4 + i) % 32 for a in addrs[8 * qw:8 * qw + 8]
                 for i in range(4)]
        if len(set(banks)) != 32:
            return False
    return True


def test_staging_layout_bijective_and_conflict_free():
    for hd in (128, 256):
        _check_staging(hd)


def _check_staging(hd):
    chunks = hd // 16
    offs = [pac.e4m3_stage_offset(r, c, hd) for r in range(TILE)
            for c in range(chunks)]
    assert sorted(offs) == list(range(0, TILE * hd, 16))
    for kw in range(0, TILE, 16):  # each warp's 16 keys
        for j in range(2):  # S's K loads: n8 tile j, chunk tig + 4 h
            for h in range(hd // 64):
                assert _conflict_free([pac.e4m3_stage_offset(
                    kw + pac.e4m3_s_key(lane // 4, j), lane % 4 + 4 * h, hd)
                    for lane in range(32)])
        for i in range(4):  # Vᵀ's loads: row 4 tig + i, chunk grp + 8 hh
            for hh in range(hd // 128):
                assert _conflict_free([pac.e4m3_stage_offset(
                    kw + 4 * (lane % 4) + i, lane // 4 + 8 * hh, hd)
                    for lane in range(32)])
    # The copier: thread t puts chunk t % chunks of rows t // chunks +
    # (128 // chunks) j, one warp's 32 pieces an instruction.
    for j in range(TILE * chunks // 128):
        for w in range(4):
            assert _conflict_free([pac.e4m3_stage_offset(
                t // chunks + (128 // chunks) * j, t % chunks, hd)
                for t in range(32 * w, 32 * w + 32)])
    # The decode-write's substituted row (the cast k_new, from sNew) is
    # stored at the copier's offsets: a fragment load of that key reads it.
    rng = np.random.default_rng(7)
    rows = _codes(rng, 16, hd, nan=False)
    new = _codes(rng, 1, hd, nan=False)[0]
    tile = _stage(rows, hd)
    sub = 5  # key 5 of warp 1 is this step's write slot
    for c in range(hd // 16):
        off = pac.e4m3_stage_offset(KW + sub, c, hd)
        tile[off:off + 16] = new[16 * c:16 * c + 16]
    want = rows.copy()
    want[sub] = new
    q = np.eye(8, hd)
    np.testing.assert_array_equal(_s_from_fragments(q, tile, hd),
                                  q @ _values(want).T)


def test_e4m3_plan_covers_every_live_key_once():
    # 64-key tiles at both head dims; four blocks an SM at head_dim 128
    # (a 48 KB ring), two at 256 (96 KB).
    assert pac.SPLIT_TILES_E4M3 == {128: 64, 256: 64}
    assert pac.decode_plan(8, 8, 128, 32, 132, 128, True) == 8
    assert pac.decode_plan(1, 8, 128, 32, 132, 128, True) == 32
    assert pac.decode_plan(64, 8, 128, 32, 132, 128, True) == 1
    assert pac.decode_plan(8, 8, 128, 32, 132, 256, True) == 4
    assert pac.decode_plan(1, 8, 128, 32, 132, 256, True) == 32
    assert pac.decode_plan(1, 8, 2, 32, 132, 256, True) == 1  # a 64-key table
    for hd in (128, 256):
        for B in (1, 3, 8, 64):
            for W, bs in ((1, 8), (5, 8), (16, 32), (128, 32)):
                S = pac.decode_plan(B, 8, W, bs, 132, hd, True)
                assert 1 <= S <= 64 and S <= max(1, W * bs // (2 * TILE))
                for window in (0, 45):
                    for n in sorted({0, 1, 63, 64, 65, W * bs // 2, W * bs}):
                        lo = max(n - window, 0) if window else 0
                        seen = []
                        for s in range(S):
                            k0, k1 = pac.decode_split_keys(n, window, S, s,
                                                           hd, True)
                            assert k1 == k0 or k0 == lo or k0 % TILE == 0
                            seen += range(k0, k1)
                        assert seen == list(range(lo, n)), (hd, B, W, n)


def e4m3_model(q3, kv, tables, kv_lens, layer, *, scale, splits, window=0,
               softcap=0.0, write=None, hd_kernel=128):
    """``decode_split_kernel``'s e4m3 form in plain PyTorch (fp32; K and V
    the cache's e4m3 values, P rounded to bf16 as the kernel rounds it):
    split s reads the keys decode_split_keys(..., e4m3=True) gives it in
    64-key tiles; warp w owns keys 16 w .. 16 w + 15 of each tile with its
    own flash state (log2 domain), one update per 16 keys; the warps merge
    in order, then the splits. ``write`` = (k_new, v_new, write_flat): the
    key whose flat slot is the row's write slot takes cast_e4m3 of the new
    row. Returns [B, H, hd] bf16."""
    B, H, hd = q3.shape
    _, nb, _, bs, lanes = kv.shape
    KH, W = lanes // hd, tables.shape[1]
    G = H // KH
    out = torch.zeros((B, H, hd))
    for b in range(B):
        n = int(kv_lens[b])
        wf = int(write[2][b]) if write is not None else -1
        for kh in range(KH):
            cols = slice(kh * hd, (kh + 1) * hd)
            qg = q3[b, kh * G:(kh + 1) * G].float()
            blocks = []
            for s in range(splits):
                k0, k1 = pac.decode_split_keys(n, window, splits, s,
                                               hd_kernel, True)
                warps = []
                for w in range(TILE // 16):
                    m = torch.full((G,), -math.inf)
                    l_ = torch.zeros(G)
                    acc = torch.zeros((G, hd))
                    for t in (range(k0 - k0 % TILE, k1, TILE) if k1 > k0
                              else ()):
                        lo_w = max(t + 16 * w, k0)
                        hi_w = min(t + 16 * w + 16, k1)
                        if hi_w <= lo_w:
                            continue
                        pos = torch.arange(lo_w, hi_w)
                        pages = tables[b, torch.clamp(pos // bs, max=W - 1)]
                        rows = pos % bs
                        k = kv[layer, pages.long(), 0, rows, cols].float()
                        v = kv[layer, pages.long(), 1, rows, cols].float()
                        if write is not None and 0 <= wf < nb * bs:
                            sub = (pages.long() * bs + rows) == wf
                            k[sub] = cast_e4m3(write[0][b, cols]).float()
                            v[sub] = cast_e4m3(write[1][b, cols]).float()
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
                blocks.append(_merge(warps, G, hd))
            _, L, A = _merge(blocks, G, hd)
            out[b, kh * G:(kh + 1) * G] = torch.where(
                L[:, None] > 0, A / L.clamp_min(1e-30)[:, None],
                torch.zeros_like(A))
    return out.bfloat16()


def _merge(parts, G, hd):
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, A = torch.zeros(G), torch.zeros((G, hd))
    for m_s, l_s, acc_s in parts:
        c = torch.where(M == -math.inf, torch.zeros(G), torch.exp2(m_s - M))
        L = L + l_s * c
        A = A + acc_s * c[:, None]
    return M, L, A


def _close(got, want, kv):
    v_max = float(np.nanmax(np.abs(kv.astype(np.float32)[:, :, 1])))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=RTOL, atol=2.0 ** -8 * v_max)


@pytest.mark.parametrize("write", [False, True])
def test_e4m3_kernel_model_matches_pallas(write):
    """G=4, rows of 150 keys (three 64-key tiles, the last ragged), 77 and
    an empty padding row, a window of 100 on the decode-write; three
    splits (empty runs included). Against the Pallas kernel in interpret
    mode and against the plain version."""
    q, kv, tables, lens, q_pos = _inputs(B=3, T=1, starts=[149, 0, 76],
                                         kv_lens=[150, 0, 77], nb=16, W=5,
                                         seed=3)
    scale = 1.0 / np.sqrt(q.shape[-1])
    tq, tkv, tt, tl = _torch(q[:, 0]), _torch(kv), _torch(tables), _torch(lens)
    if not write:
        want = _pallas_jit(jnp.asarray(q), jnp.asarray(kv),
                           jnp.asarray(tables), jnp.asarray(lens),
                           jnp.asarray(q_pos), scale=scale)[:, 0]
        got = e4m3_model(tq, tkv, tt, tl, 0, scale=scale, splits=3,
                         hd_kernel=128)
        plain = pac.paged_attention_decode_plain(tq, tkv, tt, tl, 0,
                                                 scale=scale)
    else:
        rng = np.random.default_rng(4)
        lanes = kv.shape[-1]
        k_new = rng.standard_normal((3, lanes)).astype(ml_dtypes.bfloat16)
        v_new = rng.standard_normal((3, lanes)).astype(ml_dtypes.bfloat16)
        bs = kv.shape[3]
        wf = np.asarray([int(tables[i, max(n - 1, 0) // bs]) * bs
                         + max(n - 1, 0) % bs
                         for i, n in enumerate(lens)], np.int32)
        want, _ = _fused_jit(
            jnp.asarray(q[:, 0]), jnp.asarray(kv), jnp.asarray(tables),
            jnp.asarray(lens), 0, jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(wf), scale=scale, window=100)
        new = (_torch(k_new), _torch(v_new), _torch(wf))
        got = e4m3_model(tq, tkv, tt, tl, 0, scale=scale, splits=3,
                         window=100, write=new, hd_kernel=128)
        plain = pac.paged_attention_decode_write_plain(
            tq, tkv.clone(), tt, tl, 0, *new, scale=scale, window=100)
    assert got.dtype == torch.bfloat16 and not got[1].float().any()
    _close(got, want, kv)
    _close(got, plain.float().numpy(), kv)
