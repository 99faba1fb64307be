"""Matmul over packed int4 weights with group-wise scales (W4A16).

``int4_matmul`` replaces the JAX package's Pallas ``_kernel``
(``production_stack_tpu/ops/int4_matmul.py``) with a CUDA C++ kernel for
Hopper (``csrc/int4_matmul.cu``). It reads the packed weights from device
memory at 0.5 byte per weight and never writes a dequantized weight
matrix back. ``int4_matmul_plain`` beside it is the JAX package's XLA
fallback: ``dequant_int4`` in the activation dtype, then a product with
an fp32 result. The wrapper runs the plain version only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.

Layouts (the JAX package's, ``quantize_leaf_int4``):
  x       [N, din]        bf16 or fp32 activations
  packed  [din/2, dout]   int8; original row 2i in the low nibble of packed
                          row i, row 2i+1 in the high nibble, both signed
  scales  [din/G, dout]   fp32, one per G-row group and output column
Returns [N, dout] fp32.

``launch_counts["int4"]`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

launch_counts: Dict[str, int] = {"int4": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Block tiles of the kernel (csrc/int4_matmul.cu): output columns per block,
# and rows per block for each route.
_BLOCK_COLS = 128
_MMA_ROWS_SMALL, _MMA_ROWS_LARGE, _SIMT_ROWS = 16, 64, 8
# Blocks the kernel aims to start: four per SM of an H100 (132 SMs). Measured
# at Llama-3-8B's decode shapes, two per SM left the byte stream short of
# loads in flight, and eight added more split-sum traffic than they saved.
_TARGET_BLOCKS = 528


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def _plan(N: int, din: int, dout: int, G: int, mma: bool):
    """(splits of the contraction, groups per split): enough blocks for the
    card at decode shapes, where the output tiles alone leave most SMs
    idle. Splits end on group boundaries."""
    if mma:
        rows = _MMA_ROWS_SMALL if N <= _MMA_ROWS_SMALL else _MMA_ROWS_LARGE
    else:
        rows = _SIMT_ROWS
    tiles = math.ceil(dout / _BLOCK_COLS) * math.ceil(N / rows)
    groups = din // G
    splits = min(groups, max(1, math.ceil(_TARGET_BLOCKS / tiles)))
    per_split = math.ceil(groups / splits)
    return math.ceil(groups / per_split), per_split


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(packed, scales)`` in fp32. Any N >= 1, any dout, any
    even group size G dividing din."""
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scales)
    G = _check(x, packed, scales)
    from ._build import load

    lib = load()
    N, din = x.shape
    dout = packed.shape[1]
    out = torch.empty((N, dout), dtype=torch.float32, device=x.device)
    if N == 0 or dout == 0:
        return out
    mma = x.dtype == torch.bfloat16 and G % 16 == 0
    splits, per_split = _plan(N, din, dout, G, mma)
    # Partial sums of each split; a second pass adds them in a fixed order,
    # so two runs give the same result.
    ws = (torch.empty((splits, N, dout), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    rc = lib.pst_int4_matmul(
        _DTYPES[x.dtype], x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        out.data_ptr(), ws.data_ptr(), N, din, dout, G, splits, per_split,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"int4 matmul kernel failed: cudaError {rc}")
    launch_counts["int4"] += 1
    return out
