"""The int4 decode route (``csrc/int4_decode.cu``) on the CPU: its launch
plan, its fragment-row -> output-column map, and a step-for-step model of
the kernel held against the plain version and the JAX Pallas kernel.

The kernel computes outᵀ = Wᵀ xᵀ on mma.sync with the weights as the m16
operand: a block of 4 warps owns a tile of columns and one split of the
contraction, each warp an even share of the split's k-steps; a warp turns
32-bit words of packed bytes into bf16 weights (the TPU kernel's rounding:
the level times the scale rounded to bf16), the block adds its warps' sums
in warp order, and the splits of a tile (one thread block cluster) add up
in split order. ``kernel_model`` repeats those steps with the wrapper's
real ``plan``, ``decode_tile`` and ``decode_columns``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import dequant_int4 as jax_dequant_int4
from production_stack_tpu.models.llama import quantize_leaf_int4
from production_stack_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from production_stack_tpu_torch.ops import int4_matmul as i4

LLAMA_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
WARPS = 4


def word_weights(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``weights_bits`` (csrc/int4_bits.cuh) on 32-bit words, step for step:
    four adjacent bytes of a packed row make a word w; for byte j, prmt
    takes byte j of w and of w >> 4 into the low and high half;
    ``& 0x000F000F`` then ``^ 0x43084308`` makes each half the bf16 136 +
    q; a bf16 subtract of 136 leaves q, and a bf16 multiply by the scale
    rounded to bf16 gives the weight. ``packed`` is int8 [R, 4c], scales
    fp32 [4c] (one per column); returns bf16 [2R, 4c]: packed row r gives
    contraction rows 2r (low nibble) and 2r + 1."""
    b = packed.to(torch.int64) & 0xFF
    R, C = b.shape
    words = (b.reshape(R, C // 4, 4) << (8 * torch.arange(4))).sum(-1)
    w4 = words >> 4
    j = torch.arange(4)
    lo = (words[..., None] >> (8 * j)) & 0xFF  # byte j of w: [R, C/4, 4]
    hi = (w4[..., None] >> (8 * j)) & 0xFF  # byte j of w >> 4
    halves = (torch.stack([lo, hi], dim=0) & 0x000F) ^ 0x4308
    levels = halves.to(torch.int16).view(torch.bfloat16) - torch.tensor(
        136.0, dtype=torch.bfloat16)
    w = levels * scales.to(torch.bfloat16).reshape(C // 4, 4)
    return w.reshape(2, R, C).transpose(0, 1).reshape(2 * R, C)


def kernel_model(x: torch.Tensor, packed: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """``int4_decode_kernel`` step for step on the CPU (fp32 sums)."""
    N, din = x.shape
    dout = packed.shape[1]
    G = din // scales.shape[0]
    groups, spg = din // G, G // 16
    nt, mt = i4.decode_tile(N, din, dout, G)
    p = i4.plan("decode", N, din, dout, G)
    BR, BC = 8 * nt, 16 * mt
    # Fragment row (m-tile m, half h, gid) -> column of the tile.
    cmap = torch.tensor(i4.decode_columns(mt))  # [lane, m, h]
    frag_cols = torch.stack([cmap[4 * g, m, h] for m in range(mt)
                             for h in range(2) for g in range(8)])
    xp = torch.zeros((p.grid[0] * BR, din))
    xp[:N] = x.float()
    pk = torch.zeros((din // 2, p.grid[1] * BC), dtype=torch.int8)
    pk[:, :dout] = packed  # bytes past dout: level 0
    sc = torch.zeros((groups, p.grid[1] * BC))
    sc[:, :dout] = scales
    out = torch.zeros((p.grid[0] * BR, p.grid[1] * BC))
    for tn in range(p.grid[0]):
        xt = xp[tn * BR:(tn + 1) * BR]
        for tc in range(p.grid[1]):
            cols = slice(tc * BC, (tc + 1) * BC)
            partials = []
            for z in range(p.splits):
                g0 = z * p.per_split
                n_blk = (min(g0 + p.per_split, groups) - g0) * spg
                block = None
                for w in range(WARPS):
                    acc = torch.zeros((16 * mt, BR))  # Cᵀ: fragment rows x rows of x
                    for s in range(w * n_blk // WARPS, (w + 1) * n_blk // WARPS):
                        k0 = g0 * G + 16 * s
                        wts = word_weights(pk[k0 // 2:k0 // 2 + 8, cols],
                                           sc[k0 // G, cols])  # [16, BC]
                        a = wts[:, frag_cols].t().float()  # [16 * mt, 16]
                        acc += a @ xt[:, k0:k0 + 16].t()
                    block = acc if block is None else block + acc
                partials.append(block)
            total = partials[0]
            for part in partials[1:]:
                total = total + part
            out[tn * BR:(tn + 1) * BR, tc * BC + frag_cols] = total.t()
    return out[:N, :dout]


def test_decode_plan_fills_one_wave():
    for N, (din, dout) in ((n, s) for n in (1, 8, 16) for s in LLAMA_SHAPES):
        G = 128
        groups = din // G
        nt, mt = i4.decode_tile(N, din, dout, G)
        assert nt == (1 if N <= 8 else 2) and mt in (4, 8)
        p = i4.plan("decode", N, din, dout, G)
        rows, cols = 8 * nt, 16 * mt
        gx, gy, gz = p.grid
        # Every row and column tile once, and no more.
        assert gx * rows >= N > (gx - 1) * rows
        assert gy * cols >= dout > (gy - 1) * cols
        # Splits end on group boundaries, none empty, one cluster a tile.
        assert gz == p.splits <= i4._DECODE_MAX_SPLITS
        assert p.splits * p.per_split >= groups > (p.splits - 1) * p.per_split
        # One wave of the blocks the card holds.
        wave = i4._DECODE_BLOCKS_PER_SM[(nt, mt)] * i4._N_SM
        assert gx * gy * gz <= wave
        assert gx * gy * gz > wave // 2 or gz == min(groups, i4._DECODE_MAX_SPLITS)
    # N = 8, the engine's decode bucket, as timed in chip_smoke.py.
    assert i4.plan("decode", 8, 4096, 14336, 128) == i4.Plan((1, 112, 4), 4, 8)
    assert i4.plan("decode", 8, 14336, 4096, 128) == i4.Plan((1, 64, 8), 8, 14)
    assert i4.plan("decode", 8, 4096, 4096, 128) == i4.Plan((1, 64, 8), 8, 4)
    assert i4.plan("decode", 8, 4096, 1024, 128) == i4.Plan((1, 16, 8), 8, 4)


def test_decode_column_map_is_a_bijection_per_warp_tile():
    for mt in (8, 4):
        cmap = i4.decode_columns(mt)
        assert len(cmap) == 32 and all(len(c) == mt for c in cmap)
        owner = {}  # (m-tile, fragment row) -> column
        for lane, per_m in enumerate(cmap):
            gid = lane // 4
            mine = [c for pair in per_m for c in pair]
            # A lane's columns are 2 * mt adjacent bytes of a packed row: one
            # 16- or 8-byte load; byte 2m is m-tile m's row gid, 2m + 1 its
            # row gid + 8.
            assert mine == list(range(2 * mt * gid, 2 * mt * (gid + 1)))
            for m, (c0, c1) in enumerate(per_m):
                for row, col in ((gid, c0), (gid + 8, c1)):
                    # The four lanes of a quad hold the same fragment rows.
                    assert owner.setdefault((m, row), col) == col
        assert len(owner) == 16 * mt
        assert sorted(owner.values()) == list(range(16 * mt))


@pytest.mark.parametrize("N", [1, 8, 16])
def test_kernel_model_matches_plain_and_pallas(N):
    din = 1024
    rng = np.random.default_rng(1000 + N)
    for dout in (256, 208):
        w = jnp.asarray(rng.normal(size=(din, dout)).astype(np.float32) * 0.02)
        packed, scales = jax.jit(quantize_leaf_int4)(w)
        # bf16 activations, handed to JAX as the fp32 values they are (its
        # CPU backend has no bf16 x bf16 -> fp32 dot).
        x = rng.normal(size=(N, din)).astype(np.float32)
        xt = torch.from_numpy(x).bfloat16()
        x = xt.float().numpy()
        want = np.asarray(jax_int4_matmul(jnp.asarray(x), packed, scales))
        pt = torch.from_numpy(np.array(packed))
        st = torch.from_numpy(np.array(scales))
        got = kernel_model(xt, pt, st)
        plain = i4.int4_matmul_plain(xt, pt, st)
        assert got.dtype == torch.float32 and got.shape == (N, dout)
        # The same bf16 products summed in another order: fp32
        # reassociation over din terms, a share of the largest |out|.
        tol = 1e-5 * float(plain.abs().max())
        assert float((got - plain).abs().max()) <= tol, dout
        # The Pallas kernel at fp32 multiplies the exact q * s; the route
        # rounds each weight to bf16 first (2^-9 of it at most), so the two
        # differ by at most 2^-9 * sum_k |x_k| |q_k s_k| (2^-8 for margin).
        wf = i4.dequant_int4(pt, st, torch.float32)
        bound = 2.0 ** -8 * (xt.float().abs() @ wf.abs()).numpy()
        assert (np.abs(got.numpy() - want) <= bound).all(), dout
        assert float(np.abs(got.numpy() - want).max()) > 0  # the rounding shows


def test_word_conversion_is_exact_for_every_byte_and_position():
    # Every byte value at every position of a 32-bit word (bytes 0..3 of
    # the word are four adjacent columns), times scales over six decades.
    vals = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    packed = torch.stack([vals.roll(j) for j in range(4)], dim=1).reshape(1, -1)
    packed = packed.repeat(2, 1)  # two packed rows: contraction rows 0..3
    C = packed.shape[1]
    ones = torch.ones(C)
    got = word_weights(packed, ones)
    want = i4.dequant_int4(packed, ones[None], torch.bfloat16)
    assert torch.equal(got, want)
    assert set(got.float().unique().tolist()) == set(range(-8, 8))
    scales = torch.pow(10.0, torch.from_numpy(np.random.default_rng(0).uniform(
        -6.0, 0.0, C).astype(np.float32)))
    got = word_weights(packed, scales)
    ref = np.asarray(jax.jit(jax_dequant_int4, static_argnums=2)(
        jnp.asarray(packed.numpy()), jnp.asarray(scales.numpy()[None]),
        jnp.bfloat16))
    assert torch.equal(got.view(torch.int16),
                       torch.from_numpy(ref.view(np.int16).copy()))
    assert math.prod(got.shape) == 4 * C
