"""Paged attention over a block-table KV cache (PyTorch).

Two interchangeable implementations, as in the JAX package:

- ``gather``: plain PyTorch. Gathers the sequence's pages into a contiguous
  ``[B, S, ...]`` view and runs masked attention; the CPU path, and the
  oracle both CUDA kernels are held against.
- ``cuda``: the hand-written Hopper kernels
  (:mod:`production_stack_tpu_torch.ops.paged_attention_cuda`) — decode at
  T == 1, chunked prefill at T > 1. They read only the live pages.

Shapes (the JAX package's layouts):
  q            [B, T, H, hd]
  kv_pages     [L, nb, 2, bs, KH*hd]   row 0 = K, row 1 = V; the FULL
                                       stacked cache plus a layer index;
                                       q's type or float8_e4m3fn
  block_tables [B, W] int32
  kv_lens      [B] int32
  q_positions  [B, T] int32            absolute position of each query
  layer        int                     layer to attend against
"""

from __future__ import annotations

import torch

from .fp8 import raw

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def window_eff(window: int) -> int:
    """Effective sliding window: the configured one, or a past-any-context
    sentinel when 0/negative (= unlimited). Keys satisfy
    ``key_pos > q_pos - window_eff``."""
    return int(window) if window > 0 else 1 << 30


def gather_pages(kv_pages: torch.Tensor, layer: int,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """``kv_pages[layer][block_tables]``: [B, W, 2, bs, KH*hd] in the
    cache's type (an e4m3 cache is gathered as bytes)."""
    return raw(kv_pages[layer])[block_tables.long()].view(kv_pages.dtype)


def resolve_impl(impl: str, is_cuda: bool) -> str:
    """``auto`` is ``cuda`` on a CUDA tensor and ``gather`` on a CPU one;
    ``gather`` and ``cuda`` pass through; anything else raises."""
    if impl == "auto":
        return "cuda" if is_cuda else "gather"
    if impl not in ("gather", "cuda"):
        raise ValueError(f"unknown attention impl {impl!r} (auto|gather|cuda)")
    return impl


def paged_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    q_positions: torch.Tensor,
    layer: int = 0,
    *,
    scale: float,
    impl: str = "auto",
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Causal attention of ``q`` against paged KV. Returns [B, T, H, hd].

    ``impl``: ``auto`` (``cuda`` for a CUDA tensor, ``gather`` for a CPU
    tensor), ``gather`` or ``cuda``. ``cuda`` on a CPU tensor raises.

    A row with no live key (``kv_len == 0`` padding) gets zeros from the
    kernels and the mean of its gathered V rows from ``gather`` (the JAX
    package's two paths differ the same way); the engine discards such
    rows."""
    impl = resolve_impl(impl, q.is_cuda)
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        from .paged_attention_cuda import (
            paged_attention_decode,
            paged_attention_prefill,
        )

        if q.shape[1] == 1:
            out = paged_attention_decode(
                q[:, 0], kv_pages, block_tables, kv_lens, layer,
                scale=scale, window=window, softcap=softcap,
            )
            return out[:, None]
        # Chunk positions are consecutive from row 0's position (the
        # runner's contract), so the kernel derives causality from starts.
        return paged_attention_prefill(
            q, kv_pages, block_tables, kv_lens,
            q_positions[:, 0].to(torch.int32).contiguous(), layer,
            scale=scale, window=window, softcap=softcap,
        )
    return gather_paged_attention(
        q, kv_pages, block_tables, kv_lens, q_positions, layer,
        scale=scale, window=window, softcap=softcap,
    )


def gather_paged_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    q_positions: torch.Tensor,
    layer: int = 0,
    *,
    scale: float,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, T, H, hd = q.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH = lanes // hd
    W = block_tables.shape[1]
    S = W * bs
    G = H // KH

    kv = gather_pages(kv_pages, layer, block_tables)  # [B, W, 2, bs, lanes]
    k = kv[:, :, 0].reshape(B, S, KH, hd)
    v = kv[:, :, 1].reshape(B, S, KH, hd)

    qg = q.reshape(B, T, KH, G, hd)
    # Products of the working dtype are exact in fp32, so casting first
    # equals the JAX einsum's fp32 accumulation.
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap

    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    qp = q_positions.to(torch.int32)
    valid = kv_pos < kv_lens.to(torch.int32)[:, None]  # [B, S]
    causal = kv_pos[:, None, :] <= qp[..., None]  # [B, T, S]
    in_window = kv_pos[:, None, :] > qp[..., None] - window_eff(window)
    mask = (valid[:, None, :] & causal & in_window)[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))

    probs = torch.softmax(scores, dim=-1)
    # 1-byte caches: the PV product runs in the query dtype (casting probs
    # to the cache dtype would quantize the softmax weights themselves).
    dt = q.dtype if v.element_size() == 1 else v.dtype
    out = torch.einsum(
        "bkgts,bskd->btkgd", probs.to(dt).float(), v.to(dt).float()
    )
    return out.reshape(B, T, H, hd).to(q.dtype)
