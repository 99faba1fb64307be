"""The int4 matmul's CUDA-core route (``int4_simt_kernel``), on the CPU.

The kernel (``csrc/int4_matmul.cu``) runs only on the card. Here: its plan
(``int4_matmul.plan("simt")``: column tiles of 8 to 128, at most 8 splits
of whole groups, one cluster a tile, so every call is one launch) and a
model of its partition and fixed-order merge, built from
``int4_matmul.simt_partition`` (each thread's rows, 4 columns and units of
packed rows in the order it takes them): each thread sums x q over a unit
in fp32 and adds scale * sum, the k-lanes' sums add in lane order, the
splits' in split order. The model must cover every (row, column, packed
row) once and equal ``int4_matmul_plain`` in fp32, to 1e-5 of the largest
|output| (fp32 sums over up to 4096 terms in another order; the JAX
package's own int4 tests hold its kernel to the same share).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.models.llama import quantize_leaf_int4
from production_stack_tpu_torch.ops import int4_matmul as i4

REL = 1e-5


def simt_model(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               plan: i4.Plan) -> torch.Tensor:
    """``int4_simt_kernel`` at ``plan`` in plain PyTorch (fp32). Checks that
    the threads' units cover each output's contraction exactly once."""
    N, din = x.shape
    dout = packed.shape[1]
    G = din // scales.shape[0]
    xf = x.float()
    lo = (torch.bitwise_left_shift(packed, 4) >> 4).float()  # k = 2p
    hi = (packed >> 4).float()  # k = 2p + 1
    # Per block: the k-lanes' sums [lanes, rows, cols] in lane order.
    blocks = {}
    covered = torch.zeros((N, dout, din // 2), dtype=torch.int32)
    for block, kl, rows, cols, work in i4.simt_partition(plan, N, din, dout,
                                                         G):
        if not len(rows) or not len(cols):
            continue
        r, c = list(rows), list(cols)
        acc = torch.zeros((len(r), len(c)))
        for g, p0, ru in work:
            p = slice(p0, p0 + ru)
            s = (xf[r][:, 2 * p0:2 * (p0 + ru):2] @ lo[p][:, c]
                 + xf[r][:, 2 * p0 + 1:2 * (p0 + ru):2] @ hi[p][:, c])
            acc = acc + scales[g, c][None] * s
            covered[r[0]:r[-1] + 1, c[0]:c[-1] + 1, p] += 1
        lanes = blocks.setdefault(block, {})
        lanes.setdefault(kl, []).append((r, c, acc))
    assert bool((covered == 1).all()), "a contraction row is summed twice"
    out = torch.zeros((N, dout))
    gx, gy, gz = plan.grid
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):  # splits, in order
                part = torch.zeros((N, dout))
                for kl in sorted(blocks.get((bx, by, bz), {})):
                    for r, c, acc in blocks[(bx, by, bz)][kl]:
                        part[r[0]:r[-1] + 1, c[0]:c[-1] + 1] += acc
                out += part
    return out


def _case(N, din, dout, G, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N, din), np.float32)).to(dtype)
    if G == 128:
        w = torch.from_numpy(rng.standard_normal((din, dout), np.float32))
        packed, scales = quantize_leaf_int4(w * 0.02)
    else:
        packed = torch.from_numpy(
            rng.integers(-128, 128, (din // 2, dout)).astype(np.int8))
        scales = torch.from_numpy(
            rng.random((din // G, dout), np.float32) * 0.01)
    return x, packed, scales


@pytest.mark.parametrize("N, din, dout, G, dtype", [
    (8, 128, 256, 128, torch.float32),  # the tiny engine's w_gate
    (5, 64, 48, 8, torch.bfloat16),  # groups of 8 in bf16
    (11, 256, 37, 16, torch.float32),  # ragged rows and columns
    (3, 2048, 40, 8, torch.bfloat16),  # 256 groups: splits over a cluster
])
def test_simt_model_equals_plain(N, din, dout, G, dtype):
    x, packed, scales = _case(N, din, dout, G, dtype, seed=N + din + dout)
    plan = i4.plan("simt", N, din, dout, G)
    got = simt_model(x, packed, scales, plan)
    want = i4.int4_matmul_plain(x.float(), packed, scales)
    tol = REL * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_simt_plan_one_launch():
    # The tiny engine's w_gate: one group of 128 cannot split, so 8-column
    # tiles give 32 blocks, and each group runs in 64 one-row units, one a
    # k-lane.
    assert i4.plan("simt", 8, 128, 256, 128) == i4.Plan(
        (32, 1, 1), 1, 1, 8, 64)
    # A Llama projection in fp32: 16-column tiles reach four blocks an SM
    # with no split; a k-lane takes whole groups.
    assert i4.plan("simt", 8, 4096, 14336, 128) == i4.Plan(
        (896, 1, 1), 1, 32, 16, 1)
    for N in (1, 5, 8, 17, 300):
        for din, dout, G in ((128, 256, 128), (1024, 256, 128),
                             (4096, 14336, 128), (14336, 4096, 128),
                             (4096, 40, 8), (48, 16, 16), (24, 40, 8),
                             (96, 7, 6), (2, 3, 2)):
            p = i4.plan("simt", N, din, dout, G)
            groups, gp = din // G, G // 2
            gx, gy, gz = p.grid
            # One launch: the splits of a tile are one cluster (<= 8).
            assert gz == p.splits and 1 <= p.splits <= i4._SIMT_MAX_SPLITS
            assert p.splits * p.per_split >= groups
            assert (p.splits - 1) * p.per_split < groups
            assert p.cols in i4._SIMT_COLS and gp % p.kslices == 0
            assert gx * p.cols >= dout > (gx - 1) * p.cols
            assert gy * i4._SIMT_ROWS >= N > (gy - 1) * i4._SIMT_ROWS
