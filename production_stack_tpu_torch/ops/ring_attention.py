"""Ring attention: the encode's causal attention with its sequence cut
over the ``sp`` ranks (the JAX package's ``ops/ring_attention.py``).

Rank ``r`` of ``sp`` holds query block ``r`` and K/V block ``r``, ``S/sp``
rows each. The ring runs ``sp`` hops: in each, the rank computes one
flash block (:func:`flash_block`) of its stationary queries against the
K/V block it holds, merges it into its running ``(m, l, acc)`` state
(:func:`merge`), and then passes that block on to rank ``r + 1`` while it
takes rank ``r - 1``'s. Causality holds a block at a time (block ``src``
counts for query block ``r`` only when ``src <= r``) and element by
element inside the diagonal block; keys at or past a row's length are
masked. A block wholly above the queries (``src > r``) is not computed:
JAX computes it and discards it, so the result is the same.

The per-hop products are plain PyTorch (``bmm_f32``), as JAX's are
``jnp.einsum`` outside any Pallas kernel, with JAX's arithmetic: fp32
scores of the operands' exact products, the ``-0.7 * finfo(f32).max``
mask value (a fully masked block then merges with weight zero, never a
NaN), the probabilities cast to v's type before their fp32 product with
v. Query rows run in blocks whose fp32 scores take at most
``SCORE_BYTES``; a row's merge is the same in any block.

The rotation (:func:`ring_rotate`) follows the group's backend
(:func:`ring_transport`), never an error path: over NCCL the send to the
next rank and the receive from the previous one are posted together
(``batch_isend_irecv``) on the device tensors, so a ring of blocking
calls cannot deadlock; over gloo, whose point-to-point calls take host
tensors, the same pair moves a host copy of a device block.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from .int4_matmul import bmm_f32

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# The most bytes the fp32 scores of one block of query rows take in a hop
# (the probabilities beside them take as much again): the encode's own
# block (``models/llama.py::ENCODE_SCORE_BYTES``).
SCORE_BYTES = 256 << 20

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flash_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, scale: float) -> State:
    """One ``(m, l, acc)`` flash contribution of the K/V block ``(k, v)``
    to queries ``q`` (JAX ``_flash_block``). q [B, Tq, H, hd]; k, v [B, Tk,
    KH, hd]; mask [B, Tq, Tk] bool. Returns m, l [B, H, Tq] and acc [B, H,
    Tq, hd], fp32."""
    B, Tq, H, hd = q.shape
    Tk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, Tq, KH, G, hd).permute(0, 2, 3, 1, 4).reshape(
        B * KH, G * Tq, hd)
    kt = k.permute(0, 2, 3, 1).reshape(B * KH, hd, Tk)
    s = bmm_f32(qg, kt).view(B, KH, G, Tq, Tk).mul_(scale)
    s.masked_fill_(~mask[:, None, None], NEG_INF)
    m = s.amax(dim=-1)  # [B, KH, G, Tq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    vt = v.permute(0, 2, 1, 3).reshape(B * KH, Tk, hd)
    acc = bmm_f32(p.to(v.dtype).view(B * KH, G * Tq, Tk), vt)
    return (m.reshape(B, H, Tq), l.reshape(B, H, Tq),
            acc.view(B, H, Tq, hd))


def merge(state: State, update: State) -> State:
    """The numerically stable merge of two flash partial states (JAX
    ``_merge``)."""
    m0, l0, a0 = state
    m1, l1, a1 = update
    m = torch.maximum(m0, m1)
    w0 = torch.exp(m0 - m)
    w1 = torch.exp(m1 - m)
    return m, l0 * w0 + l1 * w1, a0 * w0[..., None] + a1 * w1[..., None]


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, *, scale: float, rank: int,
                        size: int,
                        rotate: Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Causal self-attention of rank ``rank`` of a ring of ``size``: q
    [B, Sl, H, hd] is query block ``rank`` of a sequence of ``size * Sl``
    rows, k and v [B, Sl, KH, hd] its K/V block, ``lengths`` [B] each
    row's valid length in the whole sequence. ``rotate(kv)`` passes this
    rank's K/V block (k and v stacked) to the next rank and returns the
    previous rank's (:func:`ring_rotate`); unused at one rank. Returns
    [B, Sl, H, hd] in q's type; rows at or past their length hold
    garbage, as in JAX."""
    B, Sl, H, hd = q.shape
    pos_q = rank * Sl + torch.arange(Sl, device=q.device)
    lengths = lengths.to(q.device).long()
    m = torch.full((B, H, Sl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sl, hd), dtype=torch.float32, device=q.device)
    rows = max(1, min(Sl, SCORE_BYTES // (B * H * Sl * 4)))
    kv = torch.stack([k, v])
    for h in range(size):
        src = (rank - h) % size
        if src <= rank:  # a block above the queries adds nothing
            pos_k = src * Sl + torch.arange(Sl, device=q.device)
            keys = (pos_k[None, :] < lengths[:, None])[:, None, :]  # [B,1,Sk]
            for t0 in range(0, Sl, rows):
                t1 = min(Sl, t0 + rows)
                mask = (pos_k[None, :] <= pos_q[t0:t1, None])[None] & keys
                part = flash_block(q[:, t0:t1], kv[0], kv[1], mask, scale)
                new = merge((m[..., t0:t1], l[..., t0:t1],
                             acc[..., t0:t1, :]), part)
                m[..., t0:t1], l[..., t0:t1], acc[..., t0:t1, :] = new
        if h + 1 < size:
            kv = rotate(kv)
    out = acc / torch.clamp_min(l, 1e-20)[..., None]  # [B, H, Sl, hd]
    return out.transpose(1, 2).to(q.dtype)


def ring_transport(backend: str, device_type: str) -> str:
    """How the ring's blocks move over a group of ``backend`` holding
    tensors on ``device_type``: ``"device"`` (posted on the tensors
    themselves: NCCL, or gloo on the CPU) or ``"host-staged"`` (gloo with
    device tensors: a host copy moves)."""
    if backend == "nccl" or device_type == "cpu":
        return "device"
    return "host-staged"


def ring_rotate(group) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's hop over the ring ``group``: send a block to the next
    rank and receive the previous rank's, the pair posted together
    (``batch_isend_irecv``), by :func:`ring_transport` of the group's
    backend."""
    n = group.size()
    me = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    backend = dist.get_backend(group)

    def rotate(t: torch.Tensor) -> torch.Tensor:
        staged = ring_transport(backend, t.device.type) == "host-staged"
        send = t.cpu() if staged else t.contiguous()
        recv = torch.empty_like(send)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]):
            work.wait()
        return recv.to(t.device) if staged else recv

    return rotate
