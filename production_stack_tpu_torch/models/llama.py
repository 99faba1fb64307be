"""Llama-architecture decoder in PyTorch with a paged KV cache.

The port of the JAX package's ``models/llama.py`` dense path: embed,
RMSNorm, rotary embeddings (with Llama-3.1 "llama3" scaling), grouped-query
attention with optional Qwen2 QKV biases, SwiGLU MLP, tied or untied
unembed; and the knobs of the Qwen3, Gemma and Gemma-2 families: per-head
q/k RMSNorm (``qk_norm``), ``(1 + w)`` norms (``norm_unit_offset``), the
``sqrt(D)`` embedding scale (``embed_scale``), GeGLU
(``hidden_act="gelu_tanh"``), post-attention and post-MLP norms
(``post_block_norms``), the ``query_pre_attn_scalar`` attention scale,
attention and final logit softcaps, and alternating sliding-window layers.
Layouts are the JAX package's, so the two can be held against each other
on the same weights:

- params: a plain dict; per-layer weights stacked on a leading axis,
  matmul weights ``[L, in, out]``, embeddings ``[V, D]``;
- KV cache: ``[L, nb, 2, bs, KH*hd]`` (a page holds its K rows then its V
  rows, each token row spanning all kv heads).

One forward serves prefill and decode: tokens are ``[B, T]``; the step's
K/V rows are written into their cache slots first, then attention reads
through the block table (under ``PST_FUSED_KV_WRITE=1`` a decode step does
both in one kernel).

Weight-only quantization, as the JAX package's: ``int8`` (per output
channel) or ``int4`` (group-wise, packed two to a byte) for the seven
per-layer matmuls, per-row ``int8`` for ``embed``/``lm_head``; scales are
sibling leaves ``<name>_qs`` / ``<name>_q4s``. The quantizers are
bit-identical to the JAX ones, so a JAX ``quantize_tree`` output serves as
is.

Local HF checkpoints: ``config_from_hf_json`` reads a ``config.json`` as
the JAX one does, and ``load_hf_params`` builds the JAX ``load_hf_params``
tree from its safetensors (``models/safetensors.py``), bit for bit, one
stacked leaf at a time on the target device.

LoRA (the JAX package's stacked adapter bank): ``init_lora_bank`` builds
``lora_a_<t>`` ``[L, slots, in, r]`` and ``lora_b_<t>`` ``[L, slots, r,
out]`` for t in wq, wk, wv, wo, zero-filled in the model dtype and never
quantized; slot 0 stays zero ("no adapter"). Given a bank in
``params["layers"]``, ``forward`` adds each row's delta
``lora_scale[row] * (x @ A[slot]) @ B[slot]`` (``lora_idx``,
``lora_scale``; every row on slot 0 when not given) with the JAX dtypes:
q, k and v after their own cast, wo to the fp32 product before its one
cast.

The embedding path (``encode``, the JAX ``encode``): the same layers over
a whole prompt with causal attention and no cache
(:func:`encode_attention`, in blocks of query rows), then a mean pool and
an L2 norm.

Mixture-of-experts (Mixtral; ``num_experts`` > 0): the MLP is
:func:`_moe_mlp` over the expert banks ``w_gate``/``w_up`` ``[L, E, D,
F]``, ``w_down`` ``[L, E, F, D]`` and the unquantized router ``w_router``
``[L, D, E]``: every expert over every token, then the one-hot combine.
The JAX ``moe_impl`` names (``auto``, ``ragged``, ``dense``) all take
this one body, which gives the result of either JAX form. Its shapes
are fixed, so a step with experts is captured into a CUDA graph like
any other: no expert's row count is read on the host. Each expert's
products go one slice at a time through the rules of the dense
projections (an int4 bank through :func:`int4_matmul`).

Tensor parallelism (Megatron, the JAX ``param_pspecs``, ``lora_pspecs``
and ``cache_pspec``): :func:`shard_params` cuts a tree for one of ``tp``
ranks. ``wq``/``wk``/``wv`` (and their biases) are column-parallel by
whole heads, ``w_gate``/``w_up`` (an expert bank's too) by the FFN hidden
dim; ``wo`` and ``w_down`` are row-parallel. A quantized tree is sliced,
never quantized again: int8 scales follow their weight's output
channels (a row-parallel weight's stay whole), int4 packed rows and
group scales are cut on whole groups. The LoRA bank's B of q/k/v is cut
on its output dim and the A of ``wo`` on its input dim; ``embed`` and
``lm_head`` on their hidden dim (:func:`shard_top_axis`, the JAX
``P(None, tensor)``), a rank holding ``D/tp`` columns of each table;
norms, the router and the tables' int8 per-row scales stay whole on
every rank. ``init_params`` and ``load_hf_params`` take
``shard=(rank, tp)`` and keep only the rank's slice of each leaf, which
equals the same slice of the whole tree. ``forward`` and ``encode`` take
the ranks' device group (``tp_group``; None for one rank): each rank
looks up its columns of the embedding and the slices are gathered into
whole rows, runs its heads (a cache of ``[L, nb, 2, bs, (KH/tp)*hd]``)
and its slice of the FFN, and the fp32 products of ``wo`` and ``w_down``
(or the experts' combine) are summed over the group before their one
cast; the unembed multiplies each rank's columns of the final hidden
state by its columns of the table and sums the fp32 partial logits over
the group, before the int8 row scale and the softcap.

Pipeline parallelism (the JAX ``param_pspecs(pipeline=True)``,
``lora_pspecs`` and ``cache_pspec``, and ``pp_compose``): a stage of
``pp`` holds ``L/pp`` consecutive layers, every layer leaf (the LoRA
bank and the expert banks too) cut on its leading layer axis
(:func:`stage_params`; ``init_params`` and ``load_hf_params`` take
``stage=(stage, pp)``), and a cache of its own ``L/pp`` layers;
``embed``, ``lm_head`` and ``final_norm`` stay whole on every stage, as
JAX replicates them. ``forward`` and ``encode`` take the stages' device
group (``pp_group``) and the rank's stage: stage 0 embeds, each stage
runs its layers (the cache and the kernels get the stage-local layer
index, the window pattern the global one), and after stage ``s`` runs
its output is broadcast over the group, so stage ``s + 1`` runs on it
and, after the last stage, every rank holds the final activation and
computes the same logits (the JAX ``ppermute`` hops and the masked
``psum``). A broadcast rides on NCCL and on gloo alike, CUDA tensors
included.

Data-parallel replicas hold the whole cache each; a step's rows split
among them write only their own rows, and :func:`share_kv_writes` then
copies every replica's new K/V rows into the others' caches (JAX keeps
the replicated cache equal through XLA).

Sequence parallelism (the JAX ring encode, ``sp_size > 1``): ``encode``
takes the ``sp`` ranks' device group and the rank's place on it. Each
rank runs the whole layer stack on its ``T/sp`` contiguous rows (JAX
shards only the attention's rows; the other layers' products are row-wise
either way), the attention through the ring
(``ops/ring_attention.py``) at each row's global position, and the mean
pool sums each rank's masked rows and counts over the group. Outside the
encode, ``sp`` ranks replicate every step.

Expert parallelism (the JAX ``param_pspecs`` of an expert bank,
``P(pp, ep, ., tp)``): :func:`expert_params` keeps a rank's ``E/ep``
experts of every bank leaf and its scales, cut on the expert axis, and
``w_router`` whole; ``init_params`` and ``load_hf_params`` take
``experts=(rank, ep)``. ``forward`` and ``encode`` take the ``ep`` group:
the router picks among every expert by global id, each rank runs its own
experts and reads their combine columns, and the fp32 sum is added over
``ep`` (after ``tp``) before its one cast, where XLA all-reduces the
combine's reduction over E. Attention, the cache and the rows are
replicated over ``ep``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.attention import paged_attention, resolve_impl
from ..ops.fp8 import E4M3, raw, to_cache_dtype
from ..ops.int4_matmul import bmm_f32, int4_matmul, mm_f32
from ..ops.paged_attention_cuda import paged_attention_decode_write
from ..ops.ring_attention import ring_rotate, ring_self_attention
from .safetensors import Checkpoint

Params = Dict[str, Any]

# ----------------------------------------------------------------------------
# Weight-only quantization (the JAX package's, bit for bit). Matmul weights
# ([..., in, out]) quantize over their input dim; embedding tables ([V, D])
# over the hidden dim, so one per-row scale serves the lookup and the
# unembed. int4 quantizes the per-layer matmuls only: embed/lm_head stay
# per-row int8 in both modes.
# ----------------------------------------------------------------------------

QUANT_SUFFIX = "_qs"
QUANT4_SUFFIX = "_q4s"
QUANT4_GROUP = 128
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANT_TOP_KEYS = ("embed", "lm_head")
QUANT_MODES = ("int8", "int4")
# The JAX quantizers divide by 127 and 7; XLA compiles each division by a
# constant into a product with the float32 reciprocal, so the port writes
# that product, and its scales equal the compiled JAX ones bit for bit.
# The JAX checkpoint loader quantizes in numpy, which divides: with
# ``divide=True`` the port divides too, and matches it bit for bit. The
# divisor is a tensor on amax's device: PyTorch's CUDA division by a
# host scalar multiplies by its reciprocal.


def _scale(amax: torch.Tensor, qmax: float, divide: bool) -> torch.Tensor:
    amax = torch.clamp_min(amax, 1e-8)
    if divide:
        return amax / torch.full((), qmax, dtype=amax.dtype,
                                 device=amax.device)
    return amax * (1.0 / qmax)


def quantize_leaf(w: torch.Tensor, axis: int = -2, divide: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 over ``axis``: (int8 weights, fp32
    scales)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis)
    s = _scale(amax, 127.0, divide)
    q = torch.clamp(torch.round(wf / s.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), s


def q4_group(din: int) -> int:
    """Largest group size <= 128 dividing the contraction dim (128 at real
    widths, smaller in tiny debug models)."""
    g = QUANT4_GROUP
    while din % g:
        g //= 2
        if g < 2:
            raise ValueError(f"int4 needs an even contraction dim, got {din}")
    return g


def quantize_leaf_int4(w: torch.Tensor, divide: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric group-wise int4 over the contraction axis (-2): (packed int8
    [..., in/2, out] — even rows in the low nibble, odd in the high — and
    fp32 scales [..., in/G, out])."""
    wf = w.float()
    *lead, din, dout = wf.shape
    g = q4_group(din)
    wg = wf.reshape(*lead, din // g, g, dout)
    s = _scale(wg.abs().amax(dim=-2), 7.0, divide)
    q = torch.clamp(torch.round(wg / s[..., :, None, :]), -7, 7).to(torch.int8)
    q = q.reshape(*lead, din, dout)
    packed = (q[..., 0::2, :] & 0x0F) | torch.bitwise_left_shift(q[..., 1::2, :], 4)
    return packed, s


def _quantizer(name: str, mode: str, divide: bool = False
               ) -> Tuple[Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]], str]:
    """(quantizer of one 2-D slice, scale-leaf suffix) of leaf ``name``."""
    if name in QUANT_TOP_KEYS:
        return (lambda w: quantize_leaf(w, axis=-1, divide=divide)), \
            QUANT_SUFFIX
    if mode == "int4":
        return (lambda w: quantize_leaf_int4(w, divide=divide)), QUANT4_SUFFIX
    return (lambda w: quantize_leaf(w, axis=-2, divide=divide)), QUANT_SUFFIX


def _stack_slices(lead: Tuple[int, ...], make) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack ``make(i) -> (q, s)`` of the ``prod(lead)`` trailing 2-D
    slices of a leaf, one slice at a time: a full-precision copy of the
    whole leaf never exists."""
    n = math.prod(lead)
    q0, s0 = make(0)
    q = q0.new_empty((n, *q0.shape))
    s = s0.new_empty((n, *s0.shape))
    q[0], s[0] = q0, s0
    for i in range(1, n):
        q[i], s[i] = make(i)
    return q.reshape(*lead, *q0.shape), s.reshape(*lead, *s0.shape)


def quantize_tree(params: Params, mode: str = "int8") -> Params:
    """Quantize the matmul weights and embeddings of ``params`` in place
    (the JAX ``quantize_tree``), a layer's slice at a time."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unsupported quantization {mode!r} (int8 or int4)")
    for tree, keys in ((params["layers"], QUANT_LAYER_KEYS),
                       (params, QUANT_TOP_KEYS)):
        for k in keys:
            if k not in tree:
                continue
            fn, suffix = _quantizer(k, mode)
            w = tree[k]
            slices = w.reshape(-1, *w.shape[-2:])
            tree[k], tree[k + suffix] = _stack_slices(
                tuple(w.shape[:-2]), lambda i: fn(slices[i]))
    return params


def quant_mode(params: Params) -> Optional[str]:
    """The quantization a parameter tree carries: "int4", "int8" or None."""
    layers = params.get("layers", {})
    if any(k.endswith(QUANT4_SUFFIX) for k in layers):
        return "int4"
    if any(k.endswith(QUANT_SUFFIX) for k in layers):
        return "int8"
    return None


# ----------------------------------------------------------------------------
# Tensor-parallel shards (Megatron; the JAX param_pspecs and lora_pspecs)
# ----------------------------------------------------------------------------

# Leaves cut on their output dim (-1) and on their input dim (-2).
_COLUMN_PARALLEL = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up",
                    "lora_b_wq", "lora_b_wk", "lora_b_wv")
_ROW_PARALLEL = ("wo", "w_down", "lora_a_wo")


def shard_axis(name: str) -> Optional[int]:
    """The axis a layer leaf is cut on across tensor-parallel ranks (-1:
    output channels, -2: input rows), or None where every rank holds it
    whole. A scale leaf follows its weight, but a row-parallel weight's
    int8 scales (one an output channel) stay whole."""
    if name.endswith(QUANT4_SUFFIX):
        base = name[: -len(QUANT4_SUFFIX)]
    elif name.endswith(QUANT_SUFFIX):
        base = name[: -len(QUANT_SUFFIX)]
        if base in _ROW_PARALLEL:
            return None
    else:
        base = name
    if base in _COLUMN_PARALLEL:
        return -1
    if base in _ROW_PARALLEL:
        return -2
    return None


def shard_leaf(name: str, t, rank: int, tp: int):
    """Rank ``rank``'s contiguous slice of layer leaf ``name`` (a tensor,
    or a numpy array) of ``tp``: ``t`` itself where it stays whole."""
    return _cut(name, t, shard_axis(name), rank, tp)


def _cut(name: str, t, axis: Optional[int], rank: int, tp: int):
    """Rank ``rank``'s contiguous slice of ``t`` on ``axis`` (-1 or -2)
    of ``tp``: ``t`` itself where ``axis`` is None."""
    if tp == 1 or axis is None:
        return t
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"{name}: dim {n} does not split over {tp} ranks")
    k = n // tp
    if isinstance(t, torch.Tensor):
        return t.narrow(axis, rank * k, k).contiguous()
    return t[(..., slice(rank * k, (rank + 1) * k))
             + ((slice(None),) if axis == -2 else ())].copy()


def shard_top_axis(name: str) -> Optional[int]:
    """The axis a top leaf is cut on across tensor-parallel ranks: -1 (the
    hidden dim, the JAX ``P(None, tensor)``) for ``embed`` and
    ``lm_head``; None for their int8 per-row scales (one a vocabulary
    row, over the whole row) and ``final_norm``, which every rank holds
    whole."""
    return -1 if name in QUANT_TOP_KEYS else None


def shard_top(name: str, t, rank: int, tp: int):
    """Rank ``rank``'s columns of top leaf ``name`` of ``tp`` (a tensor or
    a numpy array): ``t`` itself where it stays whole."""
    return _cut(name, t, shard_top_axis(name), rank, tp)


def check_tp(cfg: "LlamaConfig", tp: int,
             quantization: Optional[str] = None) -> None:
    """Raise ``ValueError`` unless ``cfg`` splits over ``tp`` ranks: whole
    query and kv heads, an FFN hidden dim and a hidden dim (the tables'
    columns) a rank, and under int4 a
    whole number of the full weight's groups in each row-parallel
    contraction (the kernels read the group from the shapes)."""
    if tp < 1:
        raise ValueError(f"tensor_parallel_size must be >= 1, got {tp}")
    for what, n in (("num_heads", cfg.num_heads),
                    ("num_kv_heads", cfg.num_kv_heads),
                    ("intermediate_size", cfg.intermediate_size),
                    ("hidden_size", cfg.hidden_size)):
        if n % tp:
            raise ValueError(f"{what}={n} is not divisible by "
                             f"tensor_parallel_size={tp}")
    if quantization == "int4":
        for what, din in (("wo", cfg.q_size),
                          ("w_down", cfg.intermediate_size)):
            g = q4_group(din)
            if (din // tp) % g:
                raise ValueError(
                    f"int4 {what}: a rank's {din // tp} input rows are not "
                    f"a whole number of the weight's {g}-row groups at "
                    f"tensor_parallel_size={tp}")


def check_pp(cfg: "LlamaConfig", pp: int) -> None:
    """Raise ``ValueError`` unless ``cfg``'s layers split into ``pp``
    stages of equal depth (the JAX runner's start check)."""
    if pp < 1:
        raise ValueError(f"pipeline_parallel_size must be >= 1, got {pp}")
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pipeline_parallel_size={pp}")


def check_ep(cfg: "LlamaConfig", ep: int) -> None:
    """Raise ``ValueError`` unless the experts split over ``ep`` ranks:
    a model with experts, ``num_experts % ep == 0`` (the JAX runner's
    start check)."""
    if ep < 1:
        raise ValueError(f"expert_parallel_size must be >= 1, got {ep}")
    if ep > 1 and (not cfg.num_experts or cfg.num_experts % ep):
        raise ValueError(
            f"expert_parallel_size={ep} needs a MoE model with num_experts "
            f"divisible by it (model has {cfg.num_experts})")


def check_sp(sp: int, pp: int) -> None:
    """Raise ``ValueError`` on a ring encode over a pipeline (the JAX
    runner's start check)."""
    if sp < 1:
        raise ValueError(f"sequence_parallel_size must be >= 1, got {sp}")
    if sp > 1 and pp > 1:
        raise ValueError(
            "sequence_parallel_size > 1 (ring encode) does not compose "
            "with pipeline_parallel_size > 1 yet")


def check_ring_encode(cfg: "LlamaConfig") -> None:
    """Raise ``ValueError`` on a ring encode of a sliding-window or
    softcapped model (JAX raises it at the encode)."""
    if cfg.sliding_window or cfg.attn_logit_softcap:
        raise ValueError("ring (sp) encode does not support sliding-window/"
                         "softcap models yet")


# Expert bank leaves, cut on their expert axis (1, after the layer axis)
# across expert-parallel ranks, with their scale leaves.
_EXPERT_BANKS = ("w_gate", "w_up", "w_down")


def is_expert_leaf(name: str) -> bool:
    """Whether layer leaf ``name`` is an expert bank or a bank's scales
    (given a model with experts)."""
    for suffix in (QUANT4_SUFFIX, QUANT_SUFFIX):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
            break
    return name in _EXPERT_BANKS


def expert_span(cfg: "LlamaConfig", rank: int, ep: int) -> range:
    """The global ids of rank ``rank``'s experts of ``ep``."""
    check_ep(cfg, ep)
    n = cfg.num_experts // ep
    return range(rank * n, (rank + 1) * n)


def expert_params(params: "Params", cfg: "LlamaConfig", rank: int,
                  ep: int) -> "Params":
    """Rank ``rank``'s cut of a tree with expert banks (quantized or not,
    stage-cut or tensor-sharded or not): its ``E/ep`` experts of every
    bank leaf and its scales, on the expert axis; ``w_router`` and every
    other leaf whole."""
    span = expert_span(cfg, rank, ep)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {
        k: (v[:, span.start:span.stop].contiguous()
            if isinstance(v, torch.Tensor) else
            v[:, span.start:span.stop].copy())
        if ep > 1 and is_expert_leaf(k) else v
        for k, v in params["layers"].items()}
    return out


def stage_layers(cfg: "LlamaConfig", stage: int, pp: int) -> range:
    """The global indices of stage ``stage``'s layers of ``pp``."""
    check_pp(cfg, pp)
    n = cfg.num_layers // pp
    return range(stage * n, (stage + 1) * n)


def stage_leaf(t, stage: int, pp: int):
    """Stage ``stage``'s layers (a contiguous cut of the leading layer
    axis) of a stacked layer leaf ``t`` (a tensor or a numpy array)."""
    if pp == 1:
        return t
    n = t.shape[0] // pp
    if isinstance(t, torch.Tensor):
        return t.narrow(0, stage * n, n).contiguous()
    return t[stage * n:(stage + 1) * n].copy()


def stage_params(params: "Params", cfg: "LlamaConfig", stage: int,
                 pp: int) -> "Params":
    """Stage ``stage``'s cut of a tree (quantized or not, with or without
    a LoRA bank or expert banks): every layer leaf on its leading axis,
    the top leaves whole."""
    check_pp(cfg, pp)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {k: stage_leaf(v, stage, pp)
                     for k, v in params["layers"].items()}
    return out


def rank_local_config(cfg: "LlamaConfig", tp: int = 1, pp: int = 1,
                      ep: int = 1) -> "LlamaConfig":
    """The geometry one rank holds: :func:`tp_local_config`'s heads and
    FFN slice, its stage's ``L/pp`` layers (what sizes its KV pages and
    its LoRA bank) and its ``E/ep`` experts. The forward runs the whole
    model's config: its router picks among every expert."""
    local = tp_local_config(cfg, tp)
    if pp > 1:
        check_pp(cfg, pp)
        local = dataclasses.replace(local, num_layers=cfg.num_layers // pp)
    if ep > 1:
        check_ep(cfg, ep)
        local = dataclasses.replace(local,
                                    num_experts=cfg.num_experts // ep)
    return local


def tp_local_config(cfg: "LlamaConfig", tp: int) -> "LlamaConfig":
    """The geometry one of ``tp`` ranks runs: its query and kv heads and
    its slice of the FFN (what sizes its KV pages and its LoRA bank)."""
    if tp == 1:
        return cfg
    check_tp(cfg, tp)
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp)


def shard_params(params: "Params", cfg: "LlamaConfig", rank: int,
                 tp: int) -> "Params":
    """Rank ``rank``'s shard of a whole tree (quantized or not, with or
    without a LoRA bank): each layer leaf cut per :func:`shard_axis`, each
    top leaf per :func:`shard_top_axis` (``embed`` and ``lm_head`` on their
    hidden dim; their scales and ``final_norm`` whole)."""
    check_tp(cfg, tp, quant_mode(params))
    out = {k: shard_top(k, v, rank, tp) for k, v in params.items()
           if k != "layers"}
    out["layers"] = {k: shard_leaf(k, v, rank, tp)
                     for k, v in params["layers"].items()}
    return out


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over the tensor-parallel group (None: one
    rank, nothing to sum)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _tp_heads(cfg: "LlamaConfig", group) -> Tuple[int, int]:
    """(query heads, kv heads) of one rank of ``group``."""
    tp = 1 if group is None else group.size()
    return cfg.num_heads // tp, cfg.num_kv_heads // tp


# What this process's pipeline hand-offs, dp K/V exchanges, ring hops,
# ep combines and tp table traffic moved: calls, bytes (a hand-off's
# broadcast tensor; an exchange's gathered rows and slots; a hop's K/V
# block sent; an all-reduced combine; the lookup's gathered [B, T, D]
# rows and the unembed's all-reduced fp32 logits, under ``tp_vocab``)
# and the host seconds inside the collective calls
# (under gloo a call returns once its bytes moved, a receiver's wait for
# its peer included; under NCCL once they are queued). Eager calls only:
# a captured step's replays run no Python. Read by the runner's rank
# report.
PARALLEL_TRAFFIC: Dict[str, Dict[str, float]] = {
    kind: {"calls": 0, "bytes": 0, "seconds": 0.0}
    for kind in ("handoff", "dp_share", "sp_ring", "ep_reduce", "tp_vocab")
}


def _count_traffic(kind: str, nbytes: int, t0: float) -> None:
    rec = PARALLEL_TRAFFIC[kind]
    rec["calls"] += 1
    rec["bytes"] += nbytes
    rec["seconds"] += time.perf_counter() - t0


def _stage_span(cfg: "LlamaConfig", group, stage: int) -> Tuple[int, int]:
    """(stages, global index of stage ``stage``'s first layer) of one
    rank of the pipeline ``group`` (None: one stage)."""
    pp = 1 if group is None else group.size()
    if not 0 <= stage < pp:
        raise ValueError(f"stage {stage} of a {pp}-stage pipeline")
    return pp, stage_layers(cfg, stage, pp).start


def _run_stages(x: torch.Tensor, group, stage: int, pp: int,
                run: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The pipeline's hops: stage ``s`` applies ``run`` (its layers) to
    the activation, then broadcasts its output over ``group``; the other
    stages receive it in place. After the last hop every rank holds the
    final activation. One stage: ``run(x)``."""
    if group is None:
        return run(x)
    for s in range(pp):
        if s == stage:
            x = run(x).contiguous()
        t0 = time.perf_counter()
        dist.broadcast(x, src=dist.get_global_rank(group, s), group=group)
        _count_traffic("handoff", x.numel() * x.element_size(), t0)
    return x


def _stage_input(params: "Params", cfg: "LlamaConfig", tokens: torch.Tensor,
                 stage: int, tp_group=None) -> torch.Tensor:
    """The residual stream entering the layers: stage 0's embedding (its
    ``sqrt(D)`` scale rounded to the model dtype first, the HF-Gemma
    convention); on a later stage an empty buffer of the same shape and
    type, which the hand-off fills. Across ``tp_group`` each rank looks up
    its ``D/tp`` columns and the slices are gathered, in rank order, into
    the whole rows: a gather moves bits, so the stream equals one rank's."""
    B, T = tokens.shape
    if stage:
        return torch.empty((B, T, cfg.hidden_size), dtype=cfg.torch_dtype,
                           device=tokens.device)
    x = _embed_lookup(params, tokens.long(), cfg.torch_dtype)  # [B, T, D/tp]
    if tp_group is not None:
        t0 = time.perf_counter()
        parts = [torch.empty_like(x) for _ in range(tp_group.size())]
        dist.all_gather(parts, x, group=tp_group)
        x = torch.cat(parts, dim=-1)  # [B, T, D]
        _count_traffic("tp_vocab", x.numel() * x.element_size(), t0)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=x.dtype)
    return x


def _write_targets(write_idx: torch.Tensor, L: int, nb: int, bs: int,
                   spare: int) -> torch.Tensor:
    """The flat ``[L*nb*2*bs (+1), KH*hd]`` cache rows that the K and V
    rows of flat slots ``write_idx`` fill in each of ``L`` layers:
    ``[L, 2N]``, the N K rows then the N V rows. Slot (blk, pos) of layer
    li holds its K row at (li*nb + blk)*2*bs + pos and its V row bs rows
    later. A slot at or past nb*bs is DROPPED (padding rows, the runner's
    drop slot): it must not wrap into the next layer's first page, so its
    rows go to the cache's spare row ``spare`` instead, on the device."""
    flat = write_idx.reshape(-1).long()
    rows = (flat // bs) * (2 * bs) + flat % bs  # layer-0 K
    rows = torch.cat([rows, rows + bs])  # K rows, then V rows
    dropped = (flat >= nb * bs).repeat(2)
    layer_base = torch.arange(L, device=rows.device)[:, None] * (nb * 2 * bs)
    return torch.where(dropped, spare, rows + layer_base)


def share_kv_writes(kv_cache: torch.Tensor, write_idx: torch.Tensor,
                    group) -> None:
    """Keep the data-parallel replicas' caches equal after a step whose
    rows were split among them: every replica's K/V rows of the step
    (written into its own cache at its rows' slots ``write_idx``) are
    gathered over ``group`` with their slots, as bytes, and written into
    every other replica's cache, in place. Valid because within a step no
    row reads a page that another row writes (the fused write's engine
    rule), so no replica read a row another one wrote. None: one replica,
    nothing to share."""
    if group is None:
        return
    L, nb, _, bs, _ = kv_cache.shape
    flat_cache = _rows_with_spare(kv_cache).view(torch.uint8)
    spare = flat_cache.shape[0] - 1
    idx = write_idx.reshape(-1).to(torch.int32).contiguous()
    mine = flat_cache[_write_targets(idx, L, nb, bs, spare).reshape(-1)]
    n = group.size()
    t0 = time.perf_counter()
    idxs = [torch.empty_like(idx) for _ in range(n)]
    dist.all_gather(idxs, idx, group=group)
    rows = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(rows, mine, group=group)
    _count_traffic("dp_share", n * (idx.numel() * 4 + mine.numel()), t0)
    me = dist.get_group_rank(group, dist.get_rank())
    for r, (i, v) in enumerate(zip(idxs, rows)):
        if r != me:
            flat_cache.index_copy_(
                0, _write_targets(i, L, nb, bs, spare).reshape(-1), v)


# The CUDA caching allocator rounds a large allocation's segment up to a
# multiple of this and splits off a free tail of more than 1 MiB.
_SEGMENT_GRANULE = 2 << 20

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    # Llama-3.1 "llama3" rope scaling; factor 0 = disabled.
    rope_scaling_factor: float = 0.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style QKV biases
    num_experts: int = 0
    num_experts_per_tok: int = 2
    qk_norm: bool = False
    hidden_act: str = "silu"
    norm_unit_offset: bool = False
    embed_scale: bool = False
    query_pre_attn_scalar: float = 0.0  # attention scale override (0 = hd)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_block_norms: bool = False
    sliding_window: int = 0
    sliding_window_pattern: int = 1
    dtype: str = "bfloat16"
    name: str = "llama"
    eos_token_ids: Tuple[int, ...] = (2,)
    bos_token_id: Optional[int] = 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def attn_scale(self) -> float:
        base = self.query_pre_attn_scalar or self.head_dim
        return 1.0 / math.sqrt(base)

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim


class Llama:
    """Stateless model functions bound to a config."""

    def __init__(self, cfg: LlamaConfig):
        if cfg.hidden_act not in _ACTS:
            raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def param_shapes(self) -> Dict[str, Any]:
        """Leaf name -> shape, the same tree as the JAX ``init_params``."""
        cfg = self.cfg
        D, Fi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        layers = {
            "attn_norm": (L, D),
            "wq": (L, D, cfg.q_size),
            "wk": (L, D, cfg.kv_size),
            "wv": (L, D, cfg.kv_size),
            "wo": (L, cfg.q_size, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, Fi),
            "w_up": (L, D, Fi),
            "w_down": (L, Fi, D),
        }
        if cfg.num_experts:  # the expert banks, stacked on their own axis
            E = cfg.num_experts
            layers.update(w_router=(L, D, E), w_gate=(L, E, D, Fi),
                          w_up=(L, E, D, Fi), w_down=(L, E, Fi, D))
        if cfg.attention_bias:
            layers["bq"] = (L, cfg.q_size)
            layers["bk"] = (L, cfg.kv_size)
            layers["bv"] = (L, cfg.kv_size)
        if cfg.qk_norm:
            layers["q_norm"] = (L, cfg.head_dim)
            layers["k_norm"] = (L, cfg.head_dim)
        if cfg.post_block_norms:
            layers["post_attn_norm"] = (L, D)
            layers["post_mlp_norm"] = (L, D)
        shapes: Dict[str, Any] = {
            "embed": (cfg.vocab_size, D),
            "layers": layers,
            "final_norm": (D,),
        }
        if not cfg.tie_word_embeddings:
            shapes["lm_head"] = (cfg.vocab_size, D)
        return shapes

    def init_params(
        self, generator: torch.Generator, device: torch.device,
        quantization: Optional[str] = None,
        shard: Optional[Tuple[int, int]] = None,
        stage: Optional[Tuple[int, int]] = None,
        experts: Optional[Tuple[int, int]] = None,
    ) -> Params:
        """Random init with the JAX package's distributions (norms 1,
        biases 0, matmul weights N(0, 1/fan_in)); not its values — the
        generators differ. Drawn on ``device`` leaf by leaf, a layer at a
        time, so no full-precision copy of a large model is ever built.

        ``quantization`` ("int8" | "int4"): each slice is quantized on the
        device as soon as it is drawn and freed before the next, so only
        the quantized tree stays resident; the result equals
        ``quantize_tree(init_params(...), quantization)`` from the same
        generator state, bit for bit.

        ``shard=(rank, tp)``: each slice is still drawn (and quantized)
        whole, so the generator advances as for the whole tree and a
        table's int8 row scales see its whole rows, and only the rank's
        cut of it is kept (of ``embed`` and ``lm_head``, its ``D/tp``
        columns): the result equals
        ``shard_params(init_params(...), cfg, rank, tp)``.

        ``stage=(stage, pp)``: every slice is still drawn, in order, and
        only the stage's layers are kept (and quantized): the result
        equals ``stage_params(init_params(...), cfg, stage, pp)``, and so
        composes with ``shard``.

        ``experts=(rank, ep)``: every expert's slices are still drawn, in
        order, and only the rank's experts are kept (and quantized): the
        result equals ``expert_params(init_params(...), cfg, rank, ep)``,
        and composes with ``shard`` and ``stage``."""
        if quantization not in (None, *QUANT_MODES):
            raise ValueError(
                f"unsupported quantization {quantization!r} (int8 or int4)")
        dtype = self.cfg.torch_dtype
        rank, tp = shard or (0, 1)
        if tp > 1:
            check_tp(self.cfg, tp, quantization)
        span = stage_layers(self.cfg, *(stage or (0, 1)))
        ep = experts[1] if experts else 1
        mine_e = (expert_span(self.cfg, *experts) if ep > 1 else None)

        def cut(name: str, t: torch.Tensor, layer: bool) -> torch.Tensor:
            return (shard_leaf if layer else shard_top)(name, t, rank, tp)

        def banked(name: str, layer: bool) -> bool:
            return layer and mine_e is not None and is_expert_leaf(name)

        def local(name: str, shape, layer: bool) -> Tuple[int, ...]:
            out = list(shape)
            axis = shard_axis(name) if layer else shard_top_axis(name)
            if tp > 1 and axis is not None:
                out[axis] //= tp
            if layer:
                out[0] = len(span)
            if banked(name, layer):
                out[1] = len(mine_e)
            return tuple(out)

        def fill(params: Params, name: str, shape, layer: bool) -> None:
            mine = local(name, shape, layer)
            if "norm" in name:
                params[name] = torch.ones(mine, dtype=dtype, device=device)
                return
            if name.startswith("b"):
                params[name] = torch.zeros(mine, dtype=dtype, device=device)
                return
            fan_in = shape[-1] if name in QUANT_TOP_KEYS else shape[-2]

            def draw() -> torch.Tensor:
                return (torch.randn(shape[-2:], generator=generator,
                                    device=device, dtype=torch.float32)
                        / math.sqrt(fan_in)).to(dtype)

            # The kept slices of the leaf's prod(shape[:-2]), in order: the
            # stage's layers (of a bank, the rank's experts); every other
            # slice is drawn and dropped.
            n_all = math.prod(shape[:-2])
            per = n_all // shape[0] if layer else n_all
            lo, hi = ((span.start * per, span.stop * per) if layer
                      else (0, n_all))
            E = shape[1] if banked(name, layer) else 0

            def kept():
                for i in range(n_all):
                    w = draw()
                    if lo <= i < hi and (not E or i % E in mine_e):
                        yield w

            slices = kept()
            quantized = name in QUANT_LAYER_KEYS + QUANT_TOP_KEYS
            if quantization is None or not quantized:
                out = torch.empty(mine, dtype=dtype, device=device)
                for part in out.view(-1, *mine[-2:]):
                    part.copy_(cut(name, next(slices), layer))
                params[name] = out
            else:
                fn, suffix = _quantizer(name, quantization)

                def make(i: int) -> Tuple[torch.Tensor, torch.Tensor]:
                    q, s = fn(next(slices))
                    return cut(name, q, layer), cut(name + suffix, s, layer)

                params[name], params[name + suffix] = _stack_slices(
                    mine[:-2], make)
            for _ in slices:  # the slices after the last kept one
                raise AssertionError(f"{name}: a kept slice left unused")

        shapes = self.param_shapes()
        params: Params = {"layers": {}}
        for k, v in shapes.items():
            if k != "layers":
                fill(params, k, v, False)
        for k, v in shapes["layers"].items():
            fill(params["layers"], k, v, True)
        return params

    # ------------------------------------------------------------------
    # LoRA bank (stacked adapter slots; engine/lora.py owns the registry)
    # ------------------------------------------------------------------

    LORA_TARGETS = ("wq", "wk", "wv", "wo")

    def init_lora_bank(self, max_loras: int, max_rank: int,
                       device: Optional[torch.device] = None) -> Params:
        """The zero-filled bank to merge into ``params["layers"]``:
        ``lora_a_<t>`` [L, slots, in, r], ``lora_b_<t>`` [L, slots, r,
        out] in the model dtype, slots = ``max_loras + 1``. A captured
        step graph reads the bank's address, so adapters are written into
        these tensors in place (``ModelRunner.install_adapter``)."""
        cfg = self.cfg
        L, S, R = cfg.num_layers, max_loras + 1, max_rank
        dims = {
            "wq": (cfg.hidden_size, cfg.q_size),
            "wk": (cfg.hidden_size, cfg.kv_size),
            "wv": (cfg.hidden_size, cfg.kv_size),
            "wo": (cfg.q_size, cfg.hidden_size),
        }
        bank: Params = {}
        for t in self.LORA_TARGETS:
            din, dout = dims[t]
            bank[f"lora_a_{t}"] = torch.zeros(
                (L, S, din, R), dtype=cfg.torch_dtype, device=device)
            bank[f"lora_b_{t}"] = torch.zeros(
                (L, S, R, dout), dtype=cfg.torch_dtype, device=device)
        return bank

    # ------------------------------------------------------------------
    # KV cache
    # ------------------------------------------------------------------

    def make_kv_cache(
        self,
        num_blocks: int,
        block_size: int,
        dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> torch.Tensor:
        """A zeroed ``[L, nb, 2, bs, KH*hd]`` cache of ``dtype`` (default:
        the model's; or ``torch.float8_e4m3fn``): a view over a flat row
        buffer with one spare row past its end, where ``forward`` sends the
        writes it drops (so dropping them needs no host sync)."""
        cfg = self.cfg
        dtype = dtype or cfg.torch_dtype
        shape = (cfg.num_layers, num_blocks, 2, block_size, cfg.kv_size)
        rows = math.prod(shape[:-1])
        # The spare row, then spare rows up to a whole number of the CUDA
        # caching allocator's 2 MiB segment granules (less than a row
        # short): a buffer that ends a granule short leaves a free tail in
        # its segment, where a later tensor can land and keep the whole
        # segment reserved once the cache is freed (a level-2 sleep).
        row_bytes = cfg.kv_size * dtype.itemsize
        granules = -(-(rows + 1) * row_bytes // _SEGMENT_GRANULE)
        flat = torch.zeros((granules * _SEGMENT_GRANULE // row_bytes,
                            cfg.kv_size), device=device,
                           dtype=torch.uint8 if dtype == E4M3 else dtype)
        return flat.view(dtype)[:rows].view(shape)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    @torch.no_grad()
    def forward(
        self,
        params: Params,
        tokens: torch.Tensor,  # [B, T] int
        positions: torch.Tensor,  # [B, T] int absolute positions
        write_idx: torch.Tensor,  # [B, T] int flat slot (>= nb*bs: dropped)
        block_tables: torch.Tensor,  # [B, W] int32
        kv_lens: torch.Tensor,  # [B] int32 valid kv len AFTER this step
        last_idx: torch.Tensor,  # [B] int index in T of each row's last token
        kv_cache: torch.Tensor,  # [L, nb, 2, bs, KH*hd], updated in place
        *,
        attn_impl: str = "auto",
        all_logits: bool = False,
        lora_idx: Optional[torch.Tensor] = None,  # [B] int bank slot
        lora_scale: Optional[torch.Tensor] = None,  # [B] float32
        moe_impl: str = "auto",
        tp_group=None,
        pp_group=None,
        pp_stage: int = 0,
        ep_group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One engine step. Returns (last-token logits [B, V] float32, the
        cache); with ``all_logits`` the logits of every position [B, T, V]
        (the speculative verify step; ``last_idx`` is ignored). The cache
        is updated IN PLACE — the JAX package donates the buffer to get
        the same effect — and returned for symmetry. With a LoRA bank in
        ``params["layers"]`` each row adds its slot's delta (slot 0 and
        scale 0 for every row when ``lora_idx`` is None). ``moe_impl``:
        a JAX name of the mixture-of-experts form, checked by
        :func:`_moe_mlp` (every name runs its one body). ``tp_group``: the
        tensor-parallel ranks' device group, each rank holding its
        :func:`shard_params` shard and its heads' cache; None for one
        rank. ``pp_group``: the pipeline stages' device group, this rank
        stage ``pp_stage`` of it, holding its :func:`stage_params` cut and
        a cache of its ``L/pp`` layers; None for one stage. ``ep_group``:
        the expert-parallel ranks' device group, each rank holding its
        :func:`expert_params` experts; None for one rank. Every rank
        returns the same logits."""
        cfg = self.cfg
        H, KH = _tp_heads(cfg, tp_group)
        pp, li_base = _stage_span(cfg, pp_group, pp_stage)
        q_size, kv_size = H * cfg.head_dim, KH * cfg.head_dim
        B, T = tokens.shape
        L, nb, _, bs, _ = kv_cache.shape
        if L * pp != cfg.num_layers:
            raise ValueError(f"a cache of {L} layers for a stage of "
                             f"{cfg.num_layers // pp}")
        layers = params["layers"]
        ep_first = _expert_first(cfg, layers, ep_group)
        has_lora = "lora_a_wq" in layers
        if has_lora:
            if lora_idx is None:
                lora_idx = torch.zeros(B, dtype=torch.long,
                                       device=tokens.device)
                lora_scale = torch.zeros(B, dtype=torch.float32,
                                         device=tokens.device)
            lora_idx = lora_idx.long()
            lora_scale = lora_scale.float()[:, None, None]

        offset = cfg.norm_unit_offset
        x = _stage_input(params, cfg, tokens, pp_stage, tp_group)  # [B, T, D]
        rope_cos, rope_sin = _rope_tables(positions, cfg)

        fused = _decode_write_fused(attn_impl, tokens.is_cuda, T)
        if fused:  # the attention kernel writes the rows itself
            write_flat = write_idx.reshape(-1).to(torch.int32).contiguous()
        else:
            # KV write: one scatter per layer over the flat
            # [L*nb*2*bs, KH*hd] row view (:func:`_write_targets`).
            flat_cache = _rows_with_spare(kv_cache)
            targets = _write_targets(write_idx, L, nb, bs,
                                     flat_cache.shape[0] - 1)  # [L, 2*B*T]

        positions_i = positions.to(torch.int32)
        tables = block_tables.to(torch.int32).contiguous()
        lens = kv_lens.to(torch.int32).contiguous()

        def layer(x: torch.Tensor, li: int) -> torch.Tensor:
            """Stage-local layer ``li``: its leaves, cache layer and
            kernels' ``layer`` argument; ``li_base + li`` is its global
            index, which sets its window."""
            window = _layer_window(cfg, li_base + li)
            lp = {k: v[li] for k, v in layers.items()}
            h = _rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps, offset)
            q = _proj(h, lp, "wq", lp.get("bq"))
            k = _proj(h, lp, "wk", lp.get("bk"))
            v = _proj(h, lp, "wv", lp.get("bv"))
            if has_lora:  # each rounded on its own, then added (as JAX)
                q = q + lora_delta(lp, "wq", h, lora_idx, lora_scale).to(q.dtype)
                k = k + lora_delta(lp, "wk", h, lora_idx, lora_scale).to(k.dtype)
                v = v + lora_delta(lp, "wv", h, lora_idx, lora_scale).to(v.dtype)
            q = q.reshape(B, T, H, cfg.head_dim)
            k = k.reshape(B, T, KH, cfg.head_dim)
            if cfg.qk_norm:  # Qwen3: per-head RMSNorm over hd, pre-rope
                q = _rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
                k = _rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
            q = _apply_rope(q, rope_cos, rope_sin)
            k = _apply_rope(k, rope_cos, rope_sin)

            if fused:
                attn = paged_attention_decode_write(
                    q[:, 0], kv_cache, tables, lens, li,
                    k.reshape(B, kv_size), v.reshape(B, kv_size),
                    write_flat, scale=cfg.attn_scale,
                    window=window,
                    softcap=cfg.attn_logit_softcap,
                )[:, None]
            else:
                kvd = to_cache_dtype(torch.cat(
                    [k.reshape(B * T, kv_size), v.reshape(B * T, kv_size)]
                ), kv_cache.dtype)
                raw(flat_cache).index_copy_(0, targets[li], raw(kvd))
                attn = paged_attention(
                    q, kv_cache, tables, lens, positions_i, li,
                    scale=cfg.attn_scale, impl=attn_impl,
                    window=window,
                    softcap=cfg.attn_logit_softcap,
                )
            attn = attn.reshape(B, T, q_size).to(x.dtype)
            if has_lora or tp_group is not None:
                # wo's fp32 product (int8 scale applied, or the int4
                # kernel's result), summed over the ranks, and the LoRA
                # delta join before its one cast.
                o = _all_reduce(_qdot_scaled(attn, lp, "wo"), tp_group)
                if has_lora:
                    o = o + lora_delta(lp, "wo", attn, lora_idx, lora_scale,
                                       tp_group)
                o = o.to(x.dtype)
            else:
                o = _proj(attn, lp, "wo")
            if cfg.post_block_norms:  # Gemma-2 post-attention norm
                o = _rms_norm(o, lp["post_attn_norm"], cfg.rms_norm_eps,
                              offset)
            x = x + o
            h = _rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps, offset)
            ff = _mlp(h, lp, cfg, moe_impl, tp_group, ep_group, ep_first)
            if cfg.post_block_norms:  # Gemma-2 post-feedforward norm
                ff = _rms_norm(ff, lp["post_mlp_norm"], cfg.rms_norm_eps,
                               offset)
            x = x + ff
            return x

        def run(x: torch.Tensor) -> torch.Tensor:
            for li in range(L):
                x = layer(x, li)
            return x

        x = _run_stages(x, pp_group, pp_stage, pp, run)

        x = _rms_norm(x, params["final_norm"], cfg.rms_norm_eps, offset)
        head = "lm_head" if "lm_head" in params else "embed"
        unembed = params[head]  # [V, D/tp], bf16 or int8
        if all_logits:
            logits = unembed_logits(x.reshape(B * T, -1), unembed,
                                    tp_group).view(B, T, -1)
        else:
            last = x[torch.arange(B, device=x.device), last_idx.long()]
            logits = unembed_logits(last, unembed, tp_group)  # [B, V]
        uqs = params.get(head + QUANT_SUFFIX)
        if uqs is not None:
            logits = logits * uqs  # per-vocab-row scale
        return _softcap(logits, cfg.final_logit_softcap), kv_cache

    @torch.no_grad()
    def encode(
        self,
        params: Params,
        tokens: torch.Tensor,  # [B, T] int
        lengths: torch.Tensor,  # [B] int valid lengths
        moe_impl: str = "auto",
        tp_group=None,
        pp_group=None,
        pp_stage: int = 0,
        sp_group=None,
        sp_rank: int = 0,
        ep_group=None,
    ) -> torch.Tensor:
        """The embedding path (``/v1/embeddings``), the JAX ``encode``:
        causal attention over the whole prompt at positions ``0..T-1``, no
        KV cache; returns the L2-normalized mean over each row's valid
        positions of the final hidden states, ``[B, D]`` float32. The
        layers are the forward's (embed scale, unit-offset norms, qk norm
        before rope, llama3 rope, each layer's window and softcap,
        post-block norms); the LoRA bank is not applied, as in JAX.
        Attention runs in blocks of query rows (:func:`encode_attention`).
        ``tp_group``, ``pp_group``, ``pp_stage`` and ``ep_group`` as in
        :meth:`forward`.

        ``sp_group``: the sequence-parallel ranks' device group, this rank
        ``sp_rank`` of it (None: one rank). The rank runs every layer on
        its ``T/sp`` contiguous rows, the attention through the ring over
        the group (``ops/ring_attention.py``), and the pool's masked sums
        and counts are summed over the group: every rank returns the same
        embeddings. A length ``sp`` does not divide, a pipeline, and a
        sliding-window or softcapped model raise, as in JAX."""
        cfg = self.cfg
        H, KH = _tp_heads(cfg, tp_group)
        pp, li_base = _stage_span(cfg, pp_group, pp_stage)
        B, T = tokens.shape
        dev = tokens.device
        sp = 1 if sp_group is None else sp_group.size()
        if sp > 1:
            check_sp(sp, pp)
            check_ring_encode(cfg)
        if T % sp:
            raise ValueError(f"sequence length {T} not divisible by sp={sp}")
        Tl = T // sp
        mine = slice(sp_rank * Tl, (sp_rank + 1) * Tl)
        rotate = ring_rotate(sp_group) if sp > 1 else None
        offset = cfg.norm_unit_offset
        positions = torch.arange(T, device=dev)[None, mine].expand(B, Tl)
        x = _stage_input(params, cfg, tokens[:, mine], pp_stage, tp_group)
        rope_cos, rope_sin = _rope_tables(positions, cfg)
        lengths = lengths.to(dev).long()
        layers = params["layers"]
        ep_first = _expert_first(cfg, layers, ep_group)

        def hop(kv: torch.Tensor) -> torch.Tensor:
            t0 = time.perf_counter()
            out = rotate(kv)
            _count_traffic("sp_ring", kv.numel() * kv.element_size(), t0)
            return out

        def layer(x: torch.Tensor, li: int) -> torch.Tensor:
            lp = {k: v[li] for k, v in layers.items()}
            h = _rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps, offset)
            q = _proj(h, lp, "wq", lp.get("bq")).reshape(
                B, Tl, H, cfg.head_dim)
            k = _proj(h, lp, "wk", lp.get("bk")).reshape(
                B, Tl, KH, cfg.head_dim)
            v = _proj(h, lp, "wv", lp.get("bv")).reshape(
                B, Tl, KH, cfg.head_dim)
            if cfg.qk_norm:  # Qwen3: per-head RMSNorm over hd, pre-rope
                q = _rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
                k = _rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
            q = _apply_rope(q, rope_cos, rope_sin)
            k = _apply_rope(k, rope_cos, rope_sin)
            if sp > 1:
                attn = ring_self_attention(
                    q, k, v, lengths, scale=cfg.attn_scale, rank=sp_rank,
                    size=sp, rotate=hop).reshape(B, Tl, H * cfg.head_dim)
            else:
                attn = encode_attention(
                    q, k, v, lengths, scale=cfg.attn_scale,
                    window=_layer_window(cfg, li_base + li),
                    softcap=cfg.attn_logit_softcap,
                )
            o = _row_proj(attn.to(x.dtype), lp, "wo", tp_group)
            if cfg.post_block_norms:
                o = _rms_norm(o, lp["post_attn_norm"], cfg.rms_norm_eps,
                              offset)
            x = x + o
            h = _rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps, offset)
            ff = _mlp(h, lp, cfg, moe_impl, tp_group, ep_group, ep_first)
            if cfg.post_block_norms:
                ff = _rms_norm(ff, lp["post_mlp_norm"], cfg.rms_norm_eps,
                               offset)
            x = x + ff
            return x

        def run(x: torch.Tensor) -> torch.Tensor:
            for li in range(cfg.num_layers // pp):
                x = layer(x, li)
            return x

        x = _run_stages(x, pp_group, pp_stage, pp, run)
        x = _rms_norm(x, params["final_norm"], cfg.rms_norm_eps, offset)
        mask = (positions < lengths[:, None]).float()[..., None]  # [B, Tl, 1]
        sums, count = (x.float() * mask).sum(1), mask.sum(1)
        if sp > 1:  # every rank's rows: one all-reduce of sums and counts
            both = torch.cat([sums, count], dim=-1)
            dist.all_reduce(both, group=sp_group)
            sums, count = both[:, :-1], both[:, -1:]
        pooled = sums / torch.clamp(count, min=1.0)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)


# The most bytes the fp32 scores of one block of query rows take in
# ``encode_attention`` (the probabilities beside them take as much again):
# 512 of Llama-3-8B's rows at T = 4096, where the whole [H, T, T] tensor
# would take 2 GiB a layer outside the KV budget.
ENCODE_SCORE_BYTES = 256 << 20


def encode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Causal self-attention of the encode path: q [B, T, H, hd] against k
    and v [B, T, KH, hd] at positions ``0..T-1``, keys masked to each row's
    ``lengths``, to the causal past and to ``window`` (0 = global), the
    scores soft-capped. Returns [B, T, H*hd] float32.

    The JAX encode's arithmetic: fp32 scores of the operands' exact
    products, the mask value -1e30, an fp32 softmax, the probabilities
    cast to v's dtype and an fp32 product with v (a plain product in JAX,
    ``jnp.einsum``, so here ``torch.bmm`` with an fp32 result). Query rows
    run in blocks whose scores take at most ``ENCODE_SCORE_BYTES``: a
    row's softmax over all its keys is the same in any block."""
    B, T, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    rows = max(1, min(T, ENCODE_SCORE_BYTES // (B * H * T * 4)))
    kt = k.permute(0, 2, 3, 1).reshape(B * KH, hd, T)  # [B*KH, hd, S]
    vt = v.permute(0, 2, 1, 3).reshape(B * KH, T, hd)  # [B*KH, S, hd]
    keys = torch.arange(T, device=q.device)
    valid = keys[None, :] < lengths[:, None]  # [B, S]
    win = window if window > 0 else 1 << 30
    out = torch.empty((B, T, H * hd), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, rows):
        t1 = min(T, t0 + rows)
        R = t1 - t0
        qg = q[:, t0:t1].reshape(B, R, KH, G, hd).permute(0, 2, 3, 1, 4)
        scores = bmm_f32(qg.reshape(B * KH, G * R, hd), kt).view(
            B, KH, G, R, T).mul_(scale)
        scores = _softcap(scores, softcap)
        qpos = keys[t0:t1, None]
        mask = ((keys[None, :] <= qpos) & (keys[None, :] > qpos - win))
        mask = (mask[None] & valid[:, None, :])[:, None, None]  # [B,1,1,R,S]
        scores.masked_fill_(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        o = bmm_f32(probs.view(B * KH, G * R, T), vt)  # [B*KH, G*R, hd]
        out[:, t0:t1] = o.view(B, KH, G, R, hd).permute(0, 3, 1, 2, 4) \
            .reshape(B, R, H * hd)
    return out


# ----------------------------------------------------------------------------
# Layer primitives
# ----------------------------------------------------------------------------


def _rows_with_spare(kv_cache: torch.Tensor) -> torch.Tensor:
    """The cache's flat ``[L*nb*2*bs + 1, KH*hd]`` row view; its last row is
    the spare that :meth:`Llama.make_kv_cache` allocates for dropped
    writes."""
    lanes = kv_cache.shape[-1]
    n = kv_cache.numel() // lanes
    end = (kv_cache.storage_offset() + (n + 1) * lanes) * kv_cache.element_size()
    if not kv_cache.is_contiguous() or end > kv_cache.untyped_storage().nbytes():
        raise ValueError(
            "the KV cache must come from Llama.make_kv_cache (dropped writes "
            "go to its spare row)"
        )
    return kv_cache.as_strided((n + 1, lanes), (lanes, 1))


# Bytes of x's dtype that an int8 table's unembed converts at a time. The
# whole table at once would be a temporary of V x D in every step and in
# every captured graph's pool: 1.96 GiB for llama-3-70b's lm_head, which
# the memory budget's headroom beside its KV pages does not hold.
UNEMBED_CHUNK_BYTES = 256 * 2**20


def unembed_logits(x: torch.Tensor, w: torch.Tensor,
                   tp_group=None) -> torch.Tensor:
    """Logits ``x @ w.T`` in float32. bf16 products keep their float32
    accumulator, as the JAX package's ``preferred_element_type`` does. An
    int8 table (its row scale applied after) is converted to x's dtype a
    block of rows at a time, at most ``UNEMBED_CHUNK_BYTES``, where XLA
    fuses the convert into the product's read; each logit is still one
    row's product, so the blocks change no value's reduction.
    Across ``tp_group`` ``w`` is the rank's ``[V, D/tp]`` columns: each
    rank multiplies its columns of ``x`` and the fp32 partial logits are
    summed over the group, before any scale or softcap, where XLA sums
    the sharded contraction."""
    if tp_group is not None:
        k = w.shape[-1]
        rank = dist.get_group_rank(tp_group, dist.get_rank())
        x = x[:, rank * k:(rank + 1) * k]
    if w.dtype != torch.int8:
        logits = mm_f32(x, w.t())
    else:
        rows = max(1, UNEMBED_CHUNK_BYTES // (w.shape[-1] * x.element_size()))
        logits = torch.cat([mm_f32(x, _wcast(w[i:i + rows], x.dtype).t())
                            for i in range(0, w.shape[0], rows)], dim=-1)
    if tp_group is None:
        return logits
    t0 = time.perf_counter()
    _all_reduce(logits, tp_group)
    _count_traffic("tp_vocab", logits.numel() * logits.element_size(), t0)
    return logits


def _decode_write_fused(attn_impl: str, on_cuda: bool, T: int) -> bool:
    """Whether a single-token decode step folds each layer's KV write into
    the attention kernel (no ``index_copy_`` scatter). Read at call time,
    as the JAX package reads it at trace time: ``PST_FUSED_KV_WRITE=1``,
    an attention impl that resolves to the CUDA kernels, and T == 1;
    ``gather`` never fuses. The JAX package keeps it off on the TPU, where
    a sub-row write into a tiled page is not expressible; on the GPU the
    kernel writes the row itself. Like ``impl='cuda'``, it refuses CPU
    tensors."""
    if T != 1 or os.environ.get("PST_FUSED_KV_WRITE") != "1":
        return False
    if resolve_impl(attn_impl, on_cuda) != "cuda":
        return False
    if not on_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return True


def _wcast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A matmul operand in the compute dtype: int8 leaves are converted
    (the scale is applied after the product). XLA fused this convert into
    the product's read; eager PyTorch materialises the converted weight —
    one extra write and read of it in ``dtype`` per use (PERF.md)."""
    return w.to(dtype) if w.dtype == torch.int8 else w


def _qdot(x: torch.Tensor, p: Params, name: str
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x [..., din] @ p[name]`` in fp32 under any quantization mode;
    returns (product, int8 scale to apply after it, or None). An int4 leaf
    goes through :func:`int4_matmul` for every shape (the W4A16 kernel on
    the GPU, its plain version on the CPU); an int8 leaf is converted to
    x's dtype and multiplied."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    q4s = p.get(name + QUANT4_SUFFIX)
    if q4s is not None:
        out = int4_matmul(x2, p[name], q4s)
        return out.reshape(*lead, out.shape[-1]), None
    out = mm_f32(x2, _wcast(p[name], x.dtype))
    return out.reshape(*lead, out.shape[-1]), p.get(name + QUANT_SUFFIX)


def lora_delta(lp: Params, t: str, x: torch.Tensor, lora_idx: torch.Tensor,
               lora_scale: torch.Tensor, tp_group=None) -> torch.Tensor:
    """``scale * (x @ A[slot]) @ B[slot]`` of each row of ``x`` [B, T, in]
    in fp32 (``lora_scale`` [B, 1, 1]): the first product cast to the
    bank's dtype before the second, as the JAX ``lora_delta``. Slot 0 is
    zeros, so a row without an adapter gets an exact zero. ``wo``'s A is
    cut on its input rows across tensor-parallel ranks: its fp32 product
    is summed over ``tp_group`` before the cast, as XLA sums it."""
    a = lp[f"lora_a_{t}"][lora_idx]  # [B, in, r]
    b = lp[f"lora_b_{t}"][lora_idx]  # [B, r, out]
    d = bmm_f32(x, a)
    if t == "wo":
        d = _all_reduce(d, tp_group)
    return bmm_f32(d.to(b.dtype), b) * lora_scale


def _embed_lookup(params: Params, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Token embedding gather (of the rank's columns of a sharded table);
    an int8 table dequantizes its rows with their per-row scale, which
    every rank holds whole."""
    x = params["embed"][tokens]
    s = params.get("embed" + QUANT_SUFFIX)
    if s is not None:
        x = (x.float() * s[tokens][..., None]).to(dtype)
    return x


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
              unit_offset: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    if unit_offset:  # Gemma stores w with effective weight (1 + w), fp32 math
        return (normed * (1.0 + w.float())).to(x.dtype)
    return normed.to(x.dtype) * w


def _qdot_scaled(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """``x @ p[name]`` in fp32 with its int8 scale applied."""
    out, s = _qdot(x, p, name)
    return out if s is None else out * s


def _row_proj(x: torch.Tensor, p: Params, name: str, group) -> torch.Tensor:
    """A row-parallel projection in x's dtype: each rank's fp32 product of
    its input rows, summed over ``group``, then one cast; ``_proj`` on one
    rank."""
    if group is None:
        return _proj(x, p, name)
    return _all_reduce(_qdot_scaled(x, p, name), group).to(x.dtype)


def _proj(x: torch.Tensor, p: Params, name: str,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ p[name]`` (+ bias) in x's dtype, as the JAX ``_proj``: the
    product in fp32, then the int8 scale and the bias in fp32, then one
    cast. An unquantized, bias-free product stays ``x @ w``: the same one
    rounding of the fp32 accumulator, with no extra launch."""
    w = p[name]
    if b is None and w.dtype == x.dtype:
        return x @ w
    out = _qdot_scaled(x, p, name)
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


# The MLP's gate activation by ``hidden_act``: SwiGLU, or Gemma's GeGLU.
_ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu_tanh": functools.partial(F.gelu, approximate="tanh"),
}


def _mlp(h: torch.Tensor, lp: Params, cfg: LlamaConfig,
         moe_impl: str = "auto", tp_group=None, ep_group=None,
         ep_first: int = 0) -> torch.Tensor:
    """The MLP block in h's dtype. Dense: act(h @ w_gate) * (h @ w_up) in
    float32, then w_down. With experts: :func:`_moe_mlp` over the
    flattened tokens, its fp32 result cast once (as the JAX forward casts
    ``_mlp``'s). Across tensor-parallel ranks each holds a slice of the
    hidden dim (of every expert's), and the fp32 result is summed over
    ``tp_group`` before the cast; across expert-parallel ranks each runs
    its experts (the first of them global expert ``ep_first``) and the
    sum goes on over ``ep_group``."""
    if cfg.num_experts:
        lead = h.shape[:-1]
        out = _moe_mlp(cfg, lp, h.reshape(-1, h.shape[-1]), moe_impl,
                       ep_first)
        out = _all_reduce(out, tp_group)
        if ep_group is not None:
            t0 = time.perf_counter()
            dist.all_reduce(out, group=ep_group)
            _count_traffic("ep_reduce", out.numel() * out.element_size(), t0)
        return out.reshape(*lead, out.shape[-1]).to(h.dtype)
    gate = _proj(h, lp, "w_gate")
    up = _proj(h, lp, "w_up")
    ff = (_ACTS[cfg.hidden_act](gate.float()) * up.float()).to(h.dtype)
    return _row_proj(ff, lp, "w_down", tp_group)


MOE_IMPLS = ("auto", "ragged", "dense")


def moe_route(cfg: LlamaConfig, lp: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router of a layer over tokens ``x`` [N, D], in fp32 (the HF
    Mixtral convention): softmax over the experts, the top k, their
    weights renormalized. Returns (weights [N, k] fp32, expert ids [N,
    k]), best first."""
    logits = mm_f32(x.float(), lp["w_router"].float())  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    return weights / weights.sum(dim=-1, keepdim=True), ids


def _expert_dot(x: torch.Tensor, lp: Params, name: str, e: int
                ) -> torch.Tensor:
    """``x @ lp[name][e]`` in fp32 (its int8 scale applied): one expert's
    slice of a bank through :func:`_qdot`'s rules, so an int4 slice goes
    through :func:`int4_matmul` and no bank is ever dequantized whole."""
    p = {k: lp[k][e] for k in (name, name + QUANT_SUFFIX,
                               name + QUANT4_SUFFIX) if k in lp}
    return _qdot_scaled(x, p, name)


def _expert_ffn(cfg: LlamaConfig, lp: Params, x: torch.Tensor, e: int
                ) -> torch.Tensor:
    """Expert ``e``'s SwiGLU over rows ``x`` [n, D]: [n, D] fp32."""
    g = _expert_dot(x, lp, "w_gate", e)
    u = _expert_dot(x, lp, "w_up", e)
    h = (_ACTS[cfg.hidden_act](g) * u).to(x.dtype)
    return _expert_dot(h, lp, "w_down", e)


def _moe_mlp(cfg: LlamaConfig, lp: Params, x: torch.Tensor,
             impl: str, first: int = 0) -> torch.Tensor:
    """The sparse mixture-of-experts MLP over tokens ``x`` [N, D] -> fp32
    [N, D] (the JAX ``_moe_mlp``): every expert over every token, then
    the one-hot combine of the routing weights.

    Every name of ``MOE_IMPLS`` runs this one body. It is the JAX
    ``dense`` form, and it equals the JAX ``ragged`` form too: a token's
    rows are added in expert order, as the JAX scatter of the sorted pairs
    adds them, and the experts it did not pick add exact zeros. No shape
    depends on the routing, so the step needs no host sync and is
    captured like any other. A sorted-pair form would still run every
    expert over N rows here (its group sizes cannot size a product
    without a host read), so it would cost the same FLOPs plus the sort;
    it comes back with a grouped int4 kernel that reads the expert
    offsets on the device (ROADMAP queue 2, item 10).

    Banks that hold an expert-parallel rank's experts (global ids
    ``first ..``) run only those; the router and the combine work on
    global ids, and the ranks' partial sums are added by the caller."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {impl!r} (ragged|dense|auto)")
    weights, ids = moe_route(cfg, lp, x)
    experts = torch.arange(cfg.num_experts, device=x.device)
    combine = ((ids[..., None] == experts).float()
               * weights[..., None]).sum(dim=1)  # [N, E]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(lp["w_gate"].shape[0]):
        g = first + e
        out += _expert_ffn(cfg, lp, x, e) * combine[:, g:g + 1]
    return out


def _expert_first(cfg: LlamaConfig, layers: Params, group) -> int:
    """The global id of the first expert this rank's banks hold: its
    place on the expert-parallel ``group`` times the experts a bank holds
    (0 without experts or a group)."""
    if not cfg.num_experts:
        return 0
    local = layers["w_gate"].shape[1]
    ep = 1 if group is None else group.size()
    if local * ep != cfg.num_experts:
        raise ValueError(f"banks of {local} experts on {ep} expert ranks "
                         f"for a model of {cfg.num_experts}")
    if group is None:
        return 0
    return dist.get_group_rank(group, dist.get_rank()) * local


def _layer_window(cfg: LlamaConfig, li: int) -> int:
    """Sliding window of layer ``li``: 0 = global."""
    if not cfg.sliding_window:
        return 0
    pat = cfg.sliding_window_pattern
    if pat > 1 and (li + 1) % pat == 0:
        return 0
    return cfg.sliding_window


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(logits / cap) * cap if cap else logits


def _rope_tables(
    positions: torch.Tensor, cfg: LlamaConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, T, hd/2] for the given absolute positions, with
    the Llama-3.1 "llama3" frequency ramp when configured."""
    half = cfg.head_dim // 2
    dev = positions.device
    freqs = 1.0 / (
        cfg.rope_theta
        ** (torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    )
    if cfg.rope_scaling_factor:
        wavelen = 2.0 * math.pi / freqs
        low_w = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high_w = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        smooth = (
            cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor
        ) / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        scaled = (1.0 - smooth) * freqs / cfg.rope_scaling_factor + smooth * freqs
        freqs = torch.where(
            wavelen > low_w,
            freqs / cfg.rope_scaling_factor,
            torch.where(wavelen < high_w, freqs, scaled),
        )
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """HF-Llama rotate-half convention; x [B, T, H, hd]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------------
# Local HF checkpoints (the JAX package's loader; no download, no
# ``safetensors`` or ``transformers`` package)
# ----------------------------------------------------------------------------

_HF_LAYER_MAP = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
    "input_layernorm": "attn_norm",
    "post_attention_layernorm": "mlp_norm",
}
_HF_BIAS_MAP = {
    "self_attn.q_proj": "bq",
    "self_attn.k_proj": "bk",
    "self_attn.v_proj": "bv",
}
_HF_MODEL_TYPES = ("llama", "mistral", "qwen2", "qwen3", "mixtral", "gemma",
                   "gemma2")


def load_hf_params(cfg: LlamaConfig, model_dir: str, quantize=None,
                   device: Optional[torch.device] = None,
                   shard: Optional[Tuple[int, int]] = None,
                   stage: Optional[Tuple[int, int]] = None,
                   experts: Optional[Tuple[int, int]] = None) -> Params:
    """The parameter tree of a local HF checkpoint directory: the JAX
    ``load_hf_params`` tree, bit for bit. HF linear weights are stored
    ``[out, in]`` and become ``[in, out]``; layers are stacked on axis 0;
    the Gemma-2 and qk-norm names map as there, Qwen2's q/k/v biases are
    read, and a checkpoint without ``lm_head.weight`` serves its tied
    embeddings. Mixtral's ``block_sparse_moe.experts.{e}.w1/w3/w2`` become
    the expert banks ``w_gate``/``w_up``/``w_down`` (stacked on the expert
    axis after the layer axis) and its ``block_sparse_moe.gate`` the
    router ``w_router``.

    Each layer's tensor (each expert's, in a bank) is copied from the
    mapped file to ``device`` and written into its stacked leaf there, so
    no leaf is ever whole on the host. ``quantize`` ("int8" or True,
    "int4"): each slice is quantized on ``device`` from the stored values
    as soon as it lands, with the numpy loader's division
    (``divide=True``), and only the quantized leaf stays.

    ``shard=(rank, tp)``: each layer's tensor, and ``embed`` and
    ``lm_head`` (to their ``D/tp`` columns), is cut to the rank's slice as
    it lands (after its quantization, which sees the whole tensor): the
    result equals ``shard_params`` of the whole tree.

    ``stage=(stage, pp)``: only the stage's layers are read: the result
    equals ``stage_params`` of the whole tree.

    ``experts=(rank, ep)``: only the rank's experts of each bank are read
    (``block_sparse_moe.experts.{e}`` of its span; the router whole): the
    result equals ``expert_params`` of the whole tree."""
    qmode = "int8" if quantize is True else (quantize or None)
    if qmode not in (None, *QUANT_MODES):
        raise ValueError(f"unsupported quantization {quantize!r} (int8 or int4)")
    rank, tp = shard or (0, 1)
    if tp > 1:
        check_tp(cfg, tp, qmode)
    span = stage_layers(cfg, *(stage or (0, 1)))
    mine_e = (expert_span(cfg, *experts) if experts
              else range(cfg.num_experts))
    device = torch.device(device or "cpu")
    dtype = cfg.torch_dtype
    ck = Checkpoint(model_dir)

    def read(name: str) -> torch.Tensor:
        """A stored tensor on ``device``, ``[in, out]`` when it is 2-D."""
        t = ck.tensor(name).to(device)
        return t.T.contiguous() if t.dim() == 2 else t

    def put(tree: Params, ours: str, names, lead: Tuple[int, ...] = ()
            ) -> None:
        """Leaf ``ours`` from the stored tensor ``names`` (a top leaf, as
        stored) or from the ``prod(lead)`` tensors listed in ``names``,
        stacked into leading dims ``lead`` (default: one a layer): cast to
        the model dtype, or quantized."""
        if isinstance(names, str):
            w = ck.tensor(names).to(device)
            if qmode and ours in QUANT_TOP_KEYS:
                fn, suffix = _quantizer(ours, qmode, divide=True)
                q, s = fn(w)
                tree[ours] = shard_top(ours, q, rank, tp)
                tree[ours + suffix] = shard_top(ours + suffix, s, rank, tp)
            else:
                tree[ours] = shard_top(ours, w.to(dtype), rank, tp)
            return
        lead = lead or (len(names),)
        if qmode and ours in QUANT_LAYER_KEYS:
            fn, suffix = _quantizer(ours, qmode, divide=True)

            def make(i: int) -> Tuple[torch.Tensor, torch.Tensor]:
                q, s = fn(read(names[i]))
                return (shard_leaf(ours, q, rank, tp),
                        shard_leaf(ours + suffix, s, rank, tp))

            tree[ours], tree[ours + suffix] = _stack_slices(lead, make)
            return
        first = shard_leaf(ours, read(names[0]), rank, tp)
        out = torch.empty((len(names), *first.shape), dtype=dtype,
                          device=device)
        out[0].copy_(first)
        for i in range(1, len(names)):
            out[i].copy_(shard_leaf(ours, read(names[i]), rank, tp))
        tree[ours] = out.view(*lead, *first.shape)

    params: Params = {"layers": {}}
    put(params, "embed", "model.embed_tokens.weight")
    put(params, "final_norm", "model.norm.weight")
    if "lm_head.weight" in ck:
        put(params, "lm_head", "lm_head.weight")
    layer_map = dict(_HF_LAYER_MAP)
    if cfg.qk_norm:
        layer_map["self_attn.q_norm"] = "q_norm"
        layer_map["self_attn.k_norm"] = "k_norm"
    if cfg.post_block_norms:
        # Gemma-2: post_attention_layernorm is the norm AFTER attention;
        # the MLP has its own pre and post norms.
        layer_map["post_attention_layernorm"] = "post_attn_norm"
        layer_map["pre_feedforward_layernorm"] = "mlp_norm"
        layer_map["post_feedforward_layernorm"] = "post_mlp_norm"
    L = len(span)
    if cfg.num_experts:
        # Mixtral: one w1/w3/w2 (gate/up/down) an expert (the rank's
        # experts), and the router.
        for hf_name in ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
            del layer_map[hf_name]
        for ours, wname in (("w_gate", "w1"), ("w_up", "w3"),
                            ("w_down", "w2")):
            put(params["layers"], ours,
                [f"model.layers.{i}.block_sparse_moe.experts.{e}."
                 f"{wname}.weight" for i in span for e in mine_e],
                lead=(L, len(mine_e)))
        layer_map["block_sparse_moe.gate"] = "w_router"
    for hf_name, ours in layer_map.items():
        put(params["layers"], ours,
            [f"model.layers.{i}.{hf_name}.weight" for i in span])
    if cfg.attention_bias:
        for hf_name, ours in _HF_BIAS_MAP.items():
            put(params["layers"], ours,
                [f"model.layers.{i}.{hf_name}.bias" for i in span])
    return params


def config_from_hf_json(config_path: str, name: str = "") -> LlamaConfig:
    """A :class:`LlamaConfig` from an HF ``config.json``, field for field
    as the JAX package builds it."""
    with open(config_path) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt not in _HF_MODEL_TYPES:
        raise ValueError(f"unsupported model_type {mt!r} "
                         f"({'/'.join(_HF_MODEL_TYPES)})")
    eos = hf.get("eos_token_id", 2)
    eos_ids = tuple(eos) if isinstance(eos, list) else (eos,)
    heads = hf["num_attention_heads"]
    gemma = mt in ("gemma", "gemma2")
    act = hf.get("hidden_activation") or hf.get("hidden_act") or "silu"
    act = "gelu_tanh" if act.startswith("gelu") else act
    # Sliding window: Mistral v0.1 (all layers), Gemma-2 (alternating).
    sliding = int(hf.get("sliding_window") or 0)
    if mt not in ("mistral", "gemma2"):
        sliding = 0
    # Llama-3.1 "llama3" rope scaling; other kinds are refused rather than
    # served with the wrong long-context rotation.
    rs = hf.get("rope_scaling") or {}
    rs_kind = rs.get("rope_type") or rs.get("type") or ""
    if rs and rs_kind not in ("llama3", "default", ""):
        raise ValueError(
            f"unsupported rope_scaling type {rs_kind!r} (llama3 only)")
    return LlamaConfig(
        rope_scaling_factor=(float(rs.get("factor", 0.0))
                             if rs_kind == "llama3" else 0.0),
        rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
        rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
        rope_original_max_position=int(
            rs.get("original_max_position_embeddings", 8192)),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim", hf["hidden_size"] // heads),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        tie_word_embeddings=hf.get("tie_word_embeddings", gemma),
        attention_bias=mt == "qwen2" or hf.get("attention_bias", False),
        qk_norm=mt == "qwen3",
        num_experts=hf.get("num_local_experts", 0) if mt == "mixtral" else 0,
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        hidden_act=act,
        norm_unit_offset=gemma,
        embed_scale=gemma,
        query_pre_attn_scalar=(float(hf.get("query_pre_attn_scalar", 0.0))
                               if mt == "gemma2" else 0.0),
        attn_logit_softcap=(float(hf.get("attn_logit_softcapping") or 0.0)
                            if mt == "gemma2" else 0.0),
        final_logit_softcap=(float(hf.get("final_logit_softcapping") or 0.0)
                             if mt == "gemma2" else 0.0),
        post_block_norms=mt == "gemma2",
        sliding_window=sliding,
        sliding_window_pattern=2 if mt == "gemma2" else 1,
        name=name or hf.get("_name_or_path", mt),
        eos_token_ids=eos_ids,
        bos_token_id=hf.get("bos_token_id"),
    )
