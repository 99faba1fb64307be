"""The port's kernel routes and the host-side index math of its wgmma
kernels, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What the wrappers decide on the host is
checked here: which kernel each call goes to, the int4 launch plan, the
fragment-row -> output-column map the int4 wgmma kernel is handed, and a
step-for-step emulation of that kernel's bit-level nibble conversion.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import dequant_int4 as jax_dequant_int4
from production_stack_tpu_torch.ops import int4_matmul as i4
from production_stack_tpu_torch.ops import paged_attention_cuda as pac


def test_prefill_route_by_dtype():
    bf16, f32, e4m3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    assert pac.kernel_route("prefill", bf16, bf16, 32, 8, 128) == "wgmma"
    assert pac.kernel_route("prefill", bf16, e4m3, 28, 4, 128) == "wgmma"
    assert pac.kernel_route("prefill", f32, f32, 32, 8, 128) == "simt"
    assert pac.kernel_route("prefill", f32, e4m3, 8, 8, 16) == "simt"
    # head_dim below 128 takes the CUDA-core kernel in bf16 too.
    assert pac.kernel_route("prefill", bf16, bf16, 8, 8, 16) == "simt"
    assert pac.kernel_route("prefill", bf16, e4m3, 12, 4, 64) == "simt"
    with pytest.raises(TypeError):
        pac.kernel_route("prefill", torch.float16, torch.float16, 8, 8, 128)


def _route(N, dout, G, dtype=torch.bfloat16):
    din = 4 * G
    x = torch.zeros((N, din), dtype=dtype)
    packed = torch.zeros((din // 2, dout), dtype=torch.int8)
    scales = torch.ones((din // G, dout), dtype=torch.float32)
    return i4.route(x, packed, scales)


def test_int4_route_and_plan():
    # bf16 with G % 16 == 0: decode rows on int4_decode_kernel, more rows
    # on the wgmma kernel; fp32 and small groups on the CUDA cores.
    assert _route(1, 14336, 128) == "decode"
    assert _route(16, 14336, 128) == "decode"
    assert _route(17, 14336, 128) == "wgmma"
    assert _route(512, 1024, 128) == "wgmma"
    assert _route(2048, 4096, 64) == "wgmma"
    assert _route(512, 4096, 256) == "wgmma"
    assert _route(512, 4096, 128, dtype=torch.float32) == "simt"
    assert _route(512, 4096, 8) == "simt"
    # What cp.async or the chunking cannot take goes to the decode route.
    assert _route(512, 40, 16) == "decode"  # dout % 16
    assert _route(512, 4096, 48) == "decode"  # 48 neither divides 128 nor is a multiple
    # A contraction of thousands of 16-row groups: a split's scales would
    # outgrow the decode kernel's shared memory.
    x = torch.zeros((8, 16 * 4096), dtype=torch.bfloat16)
    assert i4.route(x, torch.zeros((8 * 4096, 64), dtype=torch.int8),
                    torch.ones((4096, 64))) == "simt"

    # Llama-3-8B at a 512-token chunk: the 14336-wide projections' output
    # tiles fill the card with no split; the 4096-wide ones split the
    # contraction in 2 and the 1024-wide ones in 8 to reach 128 blocks.
    assert i4.plan("wgmma", 512, 4096, 14336, 128) == i4.Plan((4, 56, 1), 1, 32)
    assert i4.plan("wgmma", 512, 14336, 4096, 128) == i4.Plan((4, 16, 2), 2, 56)
    assert i4.plan("wgmma", 512, 4096, 4096, 128) == i4.Plan((4, 16, 2), 2, 16)
    assert i4.plan("wgmma", 512, 4096, 1024, 128) == i4.Plan((4, 4, 8), 8, 4)
    # The decode route: row tiles first, 128-column tiles, 4 splits of 8
    # groups (tests/test_torch_int4_decode.py holds its plan at every
    # Llama-3-8B shape); the CUDA-core route takes 8-column tiles, 4
    # splits of 2 groups (one cluster a tile), each group in 32 runs
    # (tests/test_torch_int4_simt.py holds its partition).
    assert i4.plan("decode", 8, 4096, 14336, 128) == i4.Plan((1, 112, 4), 4, 8)
    assert i4.plan("simt", 5, 1024, 256, 128) == i4.Plan((32, 1, 4), 4, 2,
                                                         8, 32)

    for route in ("wgmma", "decode", "simt"):
        for N in (17, 64, 300, 512, 2048):
            for din, dout in ((4096, 4096), (4096, 1024), (4096, 14336),
                              (14336, 4096), (256, 208)):
                groups = din // 128
                p = i4.plan(route, N, din, dout, 128)
                if route == "decode":
                    nt, mt = i4.decode_tile(N, din, dout, 128)
                    rows, cols = 8 * nt, 16 * mt
                elif route == "simt":
                    rows, cols = i4._SIMT_ROWS, p.cols
                else:
                    rows, cols = i4._TILES[route]
                gx, gy, gz = p.grid
                tiles_n, tiles_c = (gy, gx) if route == "simt" else (gx, gy)
                assert tiles_n * rows >= N > (tiles_n - 1) * rows
                assert tiles_c * cols >= dout > (tiles_c - 1) * cols
                assert gz == p.splits and 1 <= p.splits <= groups
                assert p.splits * p.per_split >= groups
                assert (p.splits - 1) * p.per_split < groups


def levels_bitwise(packed: torch.Tensor, scales=None) -> torch.Tensor:
    """``int4_wgmma_kernel``'s conversion of packed bytes to weights
    (``weights_bits`` in csrc/int4_matmul.cu), step for step: two adjacent
    bytes make a 16-bit word w; for byte j, prmt takes byte j of w and of
    w >> 4 into the low and high half; ``& 0x000F000F`` then ``^
    0x43084308`` makes each half the bf16 136 + q; a bf16 subtract of 136
    leaves q; with ``scales`` (fp32, one per column), a bf16 multiply by
    the scale rounded to bf16. ``packed`` is int8 [..., 2k] along its last
    axis; returns bf16 [..., 2k, 2] (the low nibble's value first)."""
    b = packed.to(torch.int64) & 0xFF
    words = b.reshape(*b.shape[:-1], -1, 2)
    w = (words << (8 * torch.arange(2))).sum(-1, keepdim=True)
    w4 = w >> 4
    x_lo = (w >> (8 * torch.arange(2))) & 0xFF  # byte j of w
    x_hi = (w4 >> (8 * torch.arange(2))) & 0xFF  # byte j of w >> 4
    halves = torch.stack([x_lo, x_hi], dim=-1)  # the prmt's two halves
    halves = (halves & 0x000F) ^ 0x4308
    bits = halves.to(torch.int16)  # < 0x8000: no sign wrap
    levels = bits.view(torch.bfloat16) - torch.tensor(136.0,
                                                      dtype=torch.bfloat16)
    levels = levels.reshape(*packed.shape, 2)
    if scales is None:
        return levels
    return levels * scales.to(torch.bfloat16)[..., None]


def test_nibble_conversion_is_exact_for_every_byte():
    # Every byte value, in two-column words as the kernel loads them.
    packed = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)[None]
    got = levels_bitwise(packed)  # [1, 256, 2] bf16
    assert got.dtype == torch.bfloat16
    ones = torch.ones((1, 256), dtype=torch.float32)
    want = i4.dequant_int4(packed, ones, torch.bfloat16)  # [2, 256]
    assert torch.equal(got[0, :, 0], want[0])  # low nibble: row 2i
    assert torch.equal(got[0, :, 1], want[1])  # high nibble: row 2i + 1
    ref = np.asarray(jax_dequant_int4(jnp.asarray(packed.numpy()),
                                      jnp.ones((1, 256), jnp.float32),
                                      jnp.float32))
    np.testing.assert_array_equal(got[0].float().numpy().T, ref)
    assert set(got.float().unique().tolist()) == set(range(-8, 8))
    # Times a scale rounded to bf16, the kernel's weights equal the JAX
    # package's bf16 dequantization bit for bit, for every byte and scales
    # over six decades.
    scales = torch.from_numpy(np.random.default_rng(0).uniform(
        -6.0, 0.0, (1, 256)).astype(np.float32))
    scales = torch.pow(10.0, scales)
    got = levels_bitwise(packed, scales[0])
    ref = np.asarray(jax_dequant_int4(jnp.asarray(packed.numpy()),
                                      jnp.asarray(scales.numpy()),
                                      jnp.bfloat16))
    assert torch.equal(got[0].T.contiguous().view(torch.int16),
                       torch.from_numpy(ref.view(np.int16).copy()))


def test_fragment_columns_are_a_bijection_per_tile():
    cols = i4.fragment_columns()
    assert len(cols) == 128 and all(len(c) == 2 for c in cols)
    owner = {}  # fragment row of the warpgroup's M tile -> column
    for t, (c0, c1) in enumerate(cols):
        # A thread's two columns are adjacent (one 16-bit load, one float2
        # store), the first even.
        assert c1 == c0 + 1 and c0 % 2 == 0
        r = 16 * (t // 32) + (t % 32) // 4
        for row, col in ((r, c0), (r + 8, c1)):
            # The four threads of a quad hold the same fragment row and must
            # agree on its column.
            assert owner.setdefault(row, col) == col
    assert sorted(owner) == list(range(64))
    assert sorted(owner.values()) == list(range(64))
    # The block's four warpgroups tile its 256 columns.
    rows, block_cols = i4._TILES["wgmma"]
    block = sorted(64 * wg + c for wg in range(4) for c in owner.values())
    assert block == list(range(block_cols)) and block_cols == 256
    assert math.prod(i4._colmap(torch.device("cpu")).shape) == 256


def test_cpu_wrappers_run_plain_and_count_no_route():
    pac.reset_launch_counts()
    i4.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((20, 64), generator=g).bfloat16()
    packed = torch.randint(-128, 128, (32, 32), generator=g, dtype=torch.int8)
    scales = torch.rand((4, 32), generator=g)
    got = i4.int4_matmul(x, packed, scales)
    assert torch.equal(got, i4.int4_matmul_plain(x, packed, scales))
    q = torch.randn((1, 5, 4, 128), generator=g).bfloat16()
    cache = torch.randn((1, 3, 2, 4, 256), generator=g).bfloat16()
    tables = torch.tensor([[2, 0]], dtype=torch.int32)
    lens = torch.tensor([7], dtype=torch.int32)
    starts = torch.tensor([2], dtype=torch.int32)
    out = pac.paged_attention_prefill(q, cache, tables, lens, starts, 0,
                                      scale=0.1)
    ref = pac.paged_attention_prefill_plain(q, cache, tables, lens, starts, 0,
                                            scale=0.1)
    assert torch.equal(out, ref)
    assert set(i4.route_counts.values()) == {0}
    assert set(pac.route_counts.values()) == {0}
    assert set(pac.launch_counts.values()) == {0}
    assert i4.launch_counts == {"int4": 0}
