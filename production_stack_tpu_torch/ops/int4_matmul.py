"""Matmul over packed int4 weights with group-wise scales (W4A16).

``int4_matmul`` replaces the JAX package's Pallas ``_kernel``
(``production_stack_tpu/ops/int4_matmul.py``) with CUDA C++ kernels for
Hopper (``csrc/int4_matmul.cu``, ``csrc/int4_decode.cu``). They read the
packed weights from device memory at 0.5 byte per weight and never write
a dequantized weight matrix back. ``int4_matmul_plain`` beside it is the JAX package's XLA
fallback: ``dequant_int4`` in the activation dtype, then a product with
an fp32 result. The wrapper runs the plain version only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.

Layouts (the JAX package's, ``quantize_leaf_int4``):
  x       [N, din]        bf16 or fp32 activations
  packed  [din/2, dout]   int8; original row 2i in the low nibble of packed
                          row i, row 2i+1 in the high nibble, both signed
  scales  [din/G, dout]   fp32, one per G-row group and output column
Returns [N, dout] fp32.

``launch_counts["int4"]`` counts calls that launch a kernel,
``route_counts`` splits them by kernel, and ``route_counts["sum"]`` counts
the second pass that adds the splits of the wgmma route (the decode and
CUDA-core routes add their splits in the same launch). ``route`` picks the
kernel and ``plan`` its grid; the wgmma kernel's fragment-row -> output
column map (``fragment_columns``) is built here and handed to it, and the
decode kernel's (``decode_columns``) is written down here, so the CPU tests
reach all of them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

launch_counts: Dict[str, int] = {"int4": 0}
route_counts: Dict[str, int] = {"wgmma": 0, "decode": 0, "simt": 0, "sum": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Block tile of the wgmma kernel (csrc/int4_matmul.cu): (rows of x, output
# columns) per block. The decode kernel's depend on N (``decode_tile``),
# the CUDA-core kernel's columns on the shape (``plan``).
_TILES = {"wgmma": (128, 256)}
_DECODE_MAX_ROWS = 16  # N at or below which bf16 takes int4_decode_kernel
_WGMMA_CHUNK = 128  # contraction rows the wgmma kernel stages at a time
_N_SM = 132  # SMs of an H100 SXM
# int4_simt_kernel: rows of x and threads a block; its column tiles, 8 to
# 128 columns (4 a thread); the narrowest it takes is the widest that
# still starts _TARGET_BLOCKS blocks (four an SM). Its contraction splits
# across at most 8 blocks (one cluster) where the tiles leave SMs idle.
_SIMT_ROWS = 8
_SIMT_THREADS = 128
_SIMT_COLS = (128, 64, 32, 16, 8)
_TARGET_BLOCKS = 4 * _N_SM
_SIMT_MAX_SPLITS = 8
# int4_decode_kernel (csrc/int4_decode.cu): blocks an SM holds, by (n8
# tiles, m16 tiles a warp) (its launch bounds); the most splits of a tile
# (the blocks of one portable cluster).
_DECODE_BLOCKS_PER_SM = {(1, 8): 4, (1, 4): 4, (2, 4): 4, (4, 4): 3}
_DECODE_MAX_SPLITS = 8
# Shared memory a split's group scales may take (the kernel's 96 KB holds
# them beside its other buffers); past it (a contraction of thousands of
# small groups) bf16 goes to the CUDA cores.
_DECODE_SCALE_BYTES = 64 * 1024
# The wgmma route runs one block per SM (registers): it splits the
# contraction only when its output tiles leave SMs idle.
_WGMMA_TARGET_BLOCKS = 132


class Plan(NamedTuple):
    grid: tuple  # (x, y, z = splits) of the launch
    splits: int
    per_split: int  # groups of the contraction per split
    cols: int = 0  # CUDA-core route: output columns a block
    kslices: int = 1  # CUDA-core route: runs of each group (units)


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for k in counts:
            counts[k] = 0


def fragment_columns() -> List[List[int]]:
    """The wgmma route's map from A-fragment rows to output columns. Entry
    ``t`` is the pair of columns (within its warpgroup's 64, one M tile)
    that thread ``t`` of a warpgroup holds as fragment rows r and r + 8,
    where r = 16 * (t // 32) + (t % 32) // 4. The four threads of a quad
    (same r) share their columns, and a thread's two are adjacent: one
    16-bit load of a packed row fills both registers."""
    cols = []
    for t in range(128):
        quad = 8 * (t // 32) + (t % 32) // 4
        cols.append([2 * quad, 2 * quad + 1])
    return cols


_COLMAPS: Dict[torch.device, torch.Tensor] = {}


def _colmap(device: torch.device) -> torch.Tensor:
    if device not in _COLMAPS:
        _COLMAPS[device] = torch.tensor(fragment_columns(), dtype=torch.int32,
                                        device=device)
    return _COLMAPS[device]


def decode_tile(N: int, din: int, dout: int, G: int) -> Tuple[int, int]:
    """``int4_decode_kernel``'s tile for a call: (n8 tiles, m16 tiles a
    warp). Up to 8 rows of x take one n8 tile, up to 16 two, more four (in
    row tiles of 32). With one n8 tile a warp's columns are 128 (MT = 8,
    16-byte loads) or 64 (MT = 4, 8-byte loads), whichever gives the
    launch more blocks, up to one wave (the wider on a tie); with more,
    64 (registers)."""
    nt = 1 if N <= 8 else 2 if N <= 16 else 4
    best = None
    for mt in ((8, 4) if nt == 1 else (4,)):
        tiles = math.ceil(N / (8 * nt)) * math.ceil(dout / (16 * mt))
        wave = _DECODE_BLOCKS_PER_SM[(nt, mt)] * _N_SM
        blocks = tiles * max(1, min(wave // tiles, din // G,
                                    _DECODE_MAX_SPLITS))
        if best is None or blocks > best[0]:
            best = (blocks, mt)
    return nt, best[1]


def decode_columns(mt: int) -> List[List[List[int]]]:
    """The decode kernel's map from A-fragment rows to output columns (the
    weights are the m16 operand of the swapped product): entry
    ``[lane][m]`` is the pair of columns, within the warp's 16 * mt, that
    fragment rows gid and gid + 8 (gid = lane // 4) of m-tile ``m`` stand
    for. Lane l holds the 2 * mt adjacent columns from 2 * mt * (l // 4),
    so one load of a packed row fills its registers of every m-tile."""
    return [[[2 * mt * (lane // 4) + 2 * m, 2 * mt * (lane // 4) + 2 * m + 1]
             for m in range(mt)] for lane in range(32)]


def dequant_int4(packed: torch.Tensor, scales: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Unpack and scale an int4 weight ``[..., din/2, dout]`` to
    ``[..., din, dout]`` in ``dtype``: the JAX ``dequant_int4``, op for op
    (the scale is cast to ``dtype`` before the product)."""
    lo = torch.bitwise_left_shift(packed, 4) >> 4  # sign-extended low nibble
    hi = packed >> 4  # arithmetic shift: sign-extended high nibble
    w = torch.stack([lo, hi], dim=-2)  # [..., din/2, 2, dout]
    *lead, half, _, dout = w.shape
    din = 2 * half
    w = w.reshape(*lead, din, dout).to(dtype)
    groups = scales.shape[-2]
    w = w.reshape(*lead, groups, din // groups, dout) * scales[
        ..., :, None, :
    ].to(dtype)
    return w.reshape(*lead, din, dout)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands with an fp32 result. bf16 products keep
    their fp32 accumulator, as the JAX package's ``preferred_element_type``
    does."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of batched 3-D operands with an fp32 result, as
    :func:`mm_f32` (the LoRA delta's two products)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """``x @ dequant_int4(packed, scales, x.dtype)`` with an fp32 result."""
    return mm_f32(x, dequant_int4(packed, scales, x.dtype))


def _check(x, packed, scales) -> int:
    """Raise on what the kernel does not take; returns the group size."""
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(
            f"int4_matmul takes x [N, din], packed [din/2, dout] and scales "
            f"[din/G, dout]; got {tuple(x.shape)}, {tuple(packed.shape)}, "
            f"{tuple(scales.shape)}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"packed must be int8 and scales float32, got "
                        f"{packed.dtype} and {scales.dtype}")
    din, dout = x.shape[1], packed.shape[1]
    groups = scales.shape[0]
    if (packed.shape[0] * 2 != din or scales.shape[1] != dout or groups == 0
            or din % groups or (din // groups) % 2):
        raise ValueError(
            f"shapes do not match: x {tuple(x.shape)}, packed "
            f"{tuple(packed.shape)}, scales {tuple(scales.shape)} (din must "
            "be 2 * packed rows and an even multiple of the scale groups)"
        )
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return din // groups


def route(x: torch.Tensor, packed: torch.Tensor,
          scales: torch.Tensor) -> str:
    """The kernel for a call: ``"wgmma"`` (bf16 x, G % 16 == 0, more than
    ``_DECODE_MAX_ROWS`` rows, dout % 16 == 0 and 16-byte aligned operands,
    as cp.async needs, and G dividing or a multiple of the kernel's 128-row
    chunk), ``"decode"`` (the other bf16 calls with G % 16 == 0: decode
    rows, and the shapes wgmma refuses) or ``"simt"`` (fp32 x, small
    groups, and splits whose scales outgrow ``_DECODE_SCALE_BYTES``)."""
    G = x.shape[1] // scales.shape[0]
    if x.dtype != torch.bfloat16 or G % 16:
        return "simt"
    N, dout = x.shape[0], packed.shape[1]
    if (N > _DECODE_MAX_ROWS and dout % 16 == 0
            and (_WGMMA_CHUNK % G == 0 or G % _WGMMA_CHUNK == 0)
            and all(t.data_ptr() % 16 == 0 for t in (x, packed, scales))):
        return "wgmma"
    din = x.shape[1]
    # Up to 1024 groups a split of at most 128 columns always fits.
    if din // G > _DECODE_MAX_SPLITS * _DECODE_SCALE_BYTES // (128 * 4):
        p = plan("decode", N, din, dout, G)
        cols = 16 * decode_tile(N, din, dout, G)[1]
        if p.per_split * cols * 4 > _DECODE_SCALE_BYTES:
            return "simt"
    return "decode"


def plan(route_name: str, N: int, din: int, dout: int, G: int) -> Plan:
    """The launch of a route: its grid and the split of the contraction.
    Splits end on group boundaries and are only made where the output
    tiles alone leave the card short of blocks.

    The decode route fills one wave of the blocks the card holds at once
    (``_DECODE_BLOCKS_PER_SM`` an SM) with splits of at least one group,
    at most ``_DECODE_MAX_SPLITS`` a tile (one thread block cluster)."""
    groups = din // G
    if route_name == "decode":
        nt, mt = decode_tile(N, din, dout, G)
        tiles_n, tiles_c = math.ceil(N / (8 * nt)), math.ceil(dout / (16 * mt))
        wave = _DECODE_BLOCKS_PER_SM[(nt, mt)] * _N_SM
        splits = max(1, min(wave // (tiles_n * tiles_c), groups,
                            _DECODE_MAX_SPLITS))
        per_split = math.ceil(groups / splits)
        splits = math.ceil(groups / per_split)
        return Plan((tiles_n, tiles_c, splits), splits, per_split)
    if route_name == "simt":
        return simt_plan(N, din, dout, G)
    rows, cols = _TILES[route_name]
    tiles_n, tiles_c = math.ceil(N / rows), math.ceil(dout / cols)
    tiles = tiles_n * tiles_c
    splits = min(groups, max(1, _WGMMA_TARGET_BLOCKS // tiles))
    per_split = math.ceil(groups / splits)
    splits = math.ceil(groups / per_split)
    # x-tiles fastest: they share a weight tile
    return Plan((tiles_n, tiles_c, splits), splits, per_split)


def simt_plan(N: int, din: int, dout: int, G: int) -> Plan:
    """``int4_simt_kernel``'s launch. Column tiles as wide as still give
    ``_TARGET_BLOCKS`` blocks (8 columns at the least); where the tiles
    leave SMs idle, up to 8 splits of whole groups (one cluster, added in
    the launch). Each group's G / 2 packed rows are cut into ``kslices``
    equal runs (a divisor of G / 2), as many as give the block's k-lanes
    (128 / (cols / 4) threads of the same columns) a run each."""
    groups, gp = din // G, G // 2
    tiles_n = math.ceil(N / _SIMT_ROWS)
    cols = next(c for c in _SIMT_COLS
                if c == _SIMT_COLS[-1]
                or tiles_n * math.ceil(dout / c) >= _TARGET_BLOCKS)
    tiles = tiles_n * math.ceil(dout / cols)
    splits = max(1, min(math.ceil(_N_SM / tiles), groups, _SIMT_MAX_SPLITS))
    per_split = math.ceil(groups / splits)
    splits = math.ceil(groups / per_split)
    lanes = _SIMT_THREADS // (cols // 4)
    want = math.ceil(lanes / per_split)
    kslices = max(d for d in range(1, min(gp, want) + 1) if gp % d == 0)
    return Plan((math.ceil(dout / cols), tiles_n, splits), splits, per_split,
                cols, kslices)


def simt_partition(plan: Plan, N: int, din: int, dout: int, G: int):
    """The CUDA-core kernel's work, for the tests: for each block (x, y, z)
    of ``plan``'s grid and each of its threads, the output rows and
    columns the thread sums and its units in the order it takes them, each
    unit (group, first packed row, packed rows)."""
    gp = G // 2
    ru = gp // plan.kslices
    ctn = plan.cols // 4
    lanes = _SIMT_THREADS // ctn
    groups = din // G
    gx, gy, gz = plan.grid
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                g_lo = bz * plan.per_split
                units = (min(g_lo + plan.per_split, groups) - g_lo) \
                    * plan.kslices
                for t in range(_SIMT_THREADS):
                    ct, kl = t % ctn, t // ctn
                    n0 = bx * plan.cols + 4 * ct
                    r0 = by * _SIMT_ROWS
                    work = []
                    for u in range(kl, units, lanes):
                        g = g_lo + u // plan.kslices
                        work.append((g, g * gp + (u % plan.kslices) * ru, ru))
                    yield ((bx, by, bz), kl,
                           range(r0, min(r0 + _SIMT_ROWS, N)),
                           range(n0, min(n0 + 4, dout)), work)


def decode_occupancy(nt: int, mt: int, per_split: int) -> int:
    """Blocks of ``int4_decode_kernel`` with ``nt`` n8 and ``mt`` m16 tiles
    that one SM of the current card holds at a split of ``per_split``
    groups (the CUDA occupancy calculator, from its registers and shared
    memory)."""
    from ._build import load

    blocks = ctypes.c_int(0)
    rc = load().pst_int4_decode_occupancy(nt, mt, per_split,
                                          ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {rc}")
    return blocks.value


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(packed, scales)`` in fp32. Any N >= 1, any dout, any
    even group size G dividing din."""
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scales)
    _check(x, packed, scales)
    return _launch(route(x, packed, scales), x, packed, scales)


def _launch(name: str, x: torch.Tensor, packed: torch.Tensor,
            scales: torch.Tensor) -> torch.Tensor:
    """One call on route ``name`` (checked operands on the card)."""
    from ._build import load

    lib = load()
    N, din = x.shape
    dout = packed.shape[1]
    G = din // scales.shape[0]
    out = torch.empty((N, dout), dtype=torch.float32, device=x.device)
    if N == 0 or dout == 0:
        return out
    p = plan(name, N, din, dout, G)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "decode":
        # The splits of a tile are one cluster and add up in the launch.
        nt, mt = decode_tile(N, din, dout, G)
        rc = lib.pst_int4_decode(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            out.data_ptr(), N, din, dout, G, nt, mt, p.grid[0], p.grid[1],
            p.splits, p.per_split, stream)
    elif name == "simt":
        # The splits of a tile are one cluster and add up in the launch.
        rc = lib.pst_int4_simt(
            _DTYPES[x.dtype], x.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), out.data_ptr(), N, din, dout, G, p.cols,
            p.kslices, p.grid[0], p.grid[1], p.splits, p.per_split, stream)
    else:
        # Partial sums of each split; a second pass adds them in a fixed
        # order, so two runs give the same result.
        ws = (torch.empty((p.splits, N, dout), dtype=torch.float32,
                          device=x.device) if p.splits > 1 else out)
        rc = lib.pst_int4_matmul(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            _colmap(x.device).data_ptr(), out.data_ptr(), ws.data_ptr(), N,
            din, dout, G, p.grid[0], p.grid[1], p.splits, p.per_split,
            stream)
    if rc != 0:
        raise RuntimeError(f"int4 matmul kernel ({name}) failed: "
                           f"cudaError {rc}")
    launch_counts["int4"] += 1
    route_counts[name] += 1
    if name == "wgmma" and p.splits > 1:
        route_counts["sum"] += 1
    return out
