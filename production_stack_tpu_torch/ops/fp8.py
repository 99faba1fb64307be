"""The fp8 (e4m3) KV cache's element type: the cast that writes it, and
the byte view that moves it.

Every write into an e4m3 cache goes through :func:`cast_e4m3`, so the
bytes the port stores are the JAX package's (``astype(float8_e4m3fn)``)
bit for bit. PyTorch's own cast differs from it past e4m3's range: it
saturates to +-448 where JAX writes NaN. Both round to nearest even, so
they agree on every finite |x| <= 464 (464 rounds down to 448, any larger
value up past 448) and on NaN.
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
# The largest |x| that rounds to a finite e4m3 value: 448 (0x7e) plus half
# its step, a tie that rounds to the even 448.
_E4M3_ROUNDS_FINITE = 464.0


def cast_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to ``float8_e4m3fn`` as the JAX package casts it: round to
    nearest even, and NaN carrying x's sign where |x| rounds past 448 or x
    is +-inf. PyTorch's cast gives those +-448 (0x7e / 0xfe; or NaN), so
    setting the low bit makes them NaN (0x7f / 0xff). No host sync."""
    y = x.to(E4M3).view(torch.uint8)
    return (y | (x.abs() > _E4M3_ROUNDS_FINITE)).view(E4M3)


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the cache's element type: :func:`cast_e4m3` for an e4m3
    cache, a plain cast otherwise."""
    return cast_e4m3(x) if dtype == E4M3 else x.to(dtype)


def raw(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its uint8 view where it holds e4m3: the index, gather and
    scatter kernels move bytes through it whatever their fp8 support."""
    return t.view(torch.uint8) if t.dtype == E4M3 else t
