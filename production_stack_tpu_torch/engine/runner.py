"""Model runner: marshals scheduler output into device steps (PyTorch).

Owns the device state (params + the stacked KV cache) and builds each
step's batch on the host with the JAX package's padding contract, so the
two engines feed their models the same arrays: power-of-two row, chunk
and table-width buckets; padding rows carry ``kv_len = 0`` and write to
the dropped slot ``nb * bs``; padding positions of a prefill chunk hold
``end - 1``. Sampling runs on the device; only the packed sample rows
come back to the host.

Each step's inputs are copied into static buffers, one flat buffer an
input name, allocated at init for the largest bucket of the lattice
(``engine/precompile.py``); a bucket's inputs are prefix views of them.
On the GPU each step key (its kind, input names and shapes, flags and
the fused-write switch) is captured into one ``torch.cuda.CUDAGraph`` the
first time it runs — as ``jax.jit`` compiles on the first call — and
every later step of the key fills the buffers and replays the graph;
``warmup_bucket`` captures a bucket ahead of traffic from an all-padding
batch. Steps on CPU tensors run eagerly. ``drop_kv_cache`` (sleep level
2) frees the cache with every graph, each of which holds its address;
``restore_kv_cache`` allocates a zeroed cache, and steps capture afresh.

Pipelined decode bursts (``burst_start`` / ``burst_continue`` /
``burst_drain``): one burst stays in flight while the host applies the
previous one. A burst step returns its carry beside its rows — the next
tokens, positions, seeds and penalty counts — and a continuation feeds
the carry back on the device: only the block tables and ``kv_lens`` come
from the host. As a graph's output is rewritten by the next replay of
its key, and another graph of the shared pool may place its
intermediates where that output lies, each dispatched burst's output
leaves the pool before anything else is enqueued: the carry into the
static inputs, the rows to a pinned host slot with an event the fetch
waits on. ``prefill_dispatch`` / ``prefill_fetch`` let a prefill run
behind an in-flight burst.

The speculative verify step (``execute_spec_verify``) scores each row's
last committed token and its K drafts in one forward over ``[Bb, K+1]``
tokens with every position's logits (``Llama.forward(all_logits=True)``),
so its attention is a T = K+1 prefill launch at decode-time context. It
returns the argmax of every position and position 0 fully sampled, in
one packed ``[Bb, K+2]`` array fetched once, and captures one graph per
(rows, table width) bucket like every other step.

A ``model`` that names a local HF checkpoint directory is loaded from
its safetensors (``models/llama.py::load_hf_params``).

A mixture-of-experts model's steps and encodes take the name
``moe_impl`` (``EngineConfig.moe_impl``, ``auto`` resolved to ``ragged``
as the JAX runner resolves it on one device); every name runs
``_moe_mlp``'s one body, which reads no routing on the host, so its
steps are captured like the others.

With ``enable_lora`` the LoRA bank (``Llama.init_lora_bank``) joins the
layers after the weights, before the KV cache is sized, and every batch
(warmup's too) carries ``lora_idx`` and ``lora_scale`` (slot 0 for
padding rows). A captured graph reads the bank's address, so
``install_adapter`` and ``uninstall_adapter`` write its slots in place.

Tensor parallelism (``tensor_parallel_size`` > 1, ``ranks`` given): the
runner holds its rank's Megatron shard (``models/llama.py::shard_params``;
random weights drawn whole and cut, a checkpoint cut on read; ``embed``
and ``lm_head`` cut to ``D/tp`` columns) and its kv heads of the cache,
and passes the ranks' device group to the model, which gathers the
embedding's columns over it, sums the fp32 products of ``wo`` and
``w_down`` and the partial logits over it. Every
device call is split into a dispatch function a follower rank can call
with the same arguments; on rank 0 it is announced to the followers
first (``publisher``, ``engine/multihost.py``) and runs under the
publisher's lock, so every rank issues the same collectives in the same
order. The KV block count is agreed across ranks: each sizes its budget
(split among the ranks on its card) after a barrier that follows every
rank's weights, and all take the least. A page leaves the engine whole,
``[L, bs, KH, hd]`` as at one rank (each rank's heads gathered on rank 0
over the control group) and is split back on upload, so swap, the tiers
and the handoff run unchanged. Every rank samples: the logits after the
all-reduce are the same on every rank and each row's seed comes from
rank 0's batch, so a follower draws rank 0's tokens, which a burst feeds
back on its own device (``rank_reports`` carries a digest of each rank's
sampled rows to check it). Steps are captured only where the device group
can be (NCCL); under gloo, whose collectives wait on the host, they run
eagerly and count as ``eager``.

Pipeline and data parallelism (``pipeline_parallel_size``,
``data_parallel_size``; the ranks laid out ``dp x pp x tp`` by
``parallel/mesh.py``): a rank holds its stage's ``L/pp`` layers of its
tensor shard (``stage_params``; drawn or read a stage at a time) and a
cache of those layers, and the model hands the activation from stage to
stage over the ranks' ``pp`` group (``models/llama.py``), so every rank
ends a forward with the same logits. A ``dp`` rank is a whole replica: a
step of ``Bb`` rows with ``Bb % dp == 0`` is split, each replica taking
its contiguous ``Bb/dp`` rows of the announced batch (any other batch,
a one-row prefill or encode, runs whole on every replica: the JAX rule);
after each forward the replicas exchange the step's new K/V rows
(``share_kv_writes``), so their caches stay equal, and the packed rows
each samples (with rank 0's seeds) are gathered over ``dp``, so every
rank, rank 0 too, returns every row. A pipelined burst's carry stays on
the replica that holds its rows. The decode and verify row bucket has
``dp`` as its floor, as in JAX, so they always split.

Sequence and expert parallelism (``sequence_parallel_size``,
``expert_parallel_size``; the grid ``dp x pp x sp x ep x tp``): an ``sp``
rank runs an encode on its ``T/sp`` rows, the attention over the ring of
its ``sp`` group (``ops/ring_attention.py``; the encode's bucket is
rounded up to a multiple of ``sp``, as in JAX), and every other step
whole, as a replica. An ``ep`` rank holds its ``E/ep`` experts of every
bank (``expert_params``; drawn or read an expert at a time) and the
router whole; every forward and encode sums the experts' combine over
its ``ep`` group. ``sp`` and ``ep`` replicas run the same arithmetic on
the same rows, so their caches stay equal without an exchange; pages
leave from the ``sp = ep = 0`` ranks.

``encode`` (``/v1/embeddings``) runs ``Llama.encode`` over one prompt
padded into its pow2 bucket, eagerly on the stream the steps use: the
async engine calls it on its step thread between two steps, never beside
a replay or a burst's refresh. It captures no graph.

Every step is recorded in the runner's ``telemetry``
(``obs/engine_telemetry.py``): a step that captured its key counts as a
compile, the others as steps, and the wall from a decode step's fetch to
the next decode dispatch as a host gap (0 for a pipelined continuation,
whose dispatch precedes the previous burst's fetch).

With ``cost_attribution`` each live step's wall, the seconds its record
gets, is charged to the sequences it served (``_charge_prefill``,
``_charge_decode``): the shares of a step sum to its wall, so the
requests' device seconds sum to ``pst_engine_device_busy_seconds``. A
pipelined burst is charged once for each of its wall segments, the start
and each continuation, to the members still alive; finished members and
padding rows cost nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..logging_utils import init_logger
from ..models.llama import (
    PARALLEL_TRAFFIC,
    Llama,
    LlamaConfig,
    expert_params,
    load_hf_params,
    quant_mode,
    rank_local_config,
    shard_leaf,
    shard_params,
    share_kv_writes,
    stage_leaf,
    stage_params,
)
from ..models.registry import get_model_config
from ..obs.engine_telemetry import EngineTelemetry
from ..ops import _build, int4_matmul, paged_attention_cuda
from ..ops.ring_attention import ring_transport
from ..parallel.distributed import HostBridge, RankContext
from ..parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
)
from ..ops.sampling import (
    apply_allowed_mask,
    apply_logit_bias,
    apply_penalties,
    apply_penalties_counts,
    sample_tokens_packed,
)
from .config import (
    EngineConfig,
    check_parallel,
    kv_cache_torch_dtype,
    resolve_device,
    resolve_num_kv_blocks,
)
from .precompile import enumerate_lattice
from .scheduler import PrefillItem
from .sequence import Sequence

logger = init_logger(__name__)


def _pow2(n: int, cap: Optional[int] = None) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap) if cap else b


# Block tables below this width share one bucket (as in the JAX runner).
_MIN_TABLE_BUCKET = 64

# The device calls rank 0 announces (by the JAX step kinds) and the
# runner method a follower calls with the announced arguments
# (``engine/multihost.py::run_follower``): the one map of the mirror.
MIRRORED = {
    "step": "_step",
    "step_nofetch": "_step",
    "multi_step": "_multi_step",
    "burst_start": "_dispatch_burst_start",
    "burst_cont": "_dispatch_burst_continue",
    "spec_verify": "_spec_verify",
    "forward": "forward_logits",
    "encode": "_encode",
    "download_page": "_gather_page",
    "upload_page": "_dispatch_upload_page",
    "drop_kv": "_drop_kv_cache",
    "restore_kv": "restore_kv_cache",
    "install_adapter": "install_adapter",
    "uninstall_adapter": "uninstall_adapter",
    "report": "rank_reports",
}

def _launch_counters() -> tuple:
    """The kernel wrappers' launch counters, which count in Python and so
    not on a graph's replay: the runner adds each replay's launches."""
    return (paged_attention_cuda.launch_counts,
            paged_attention_cuda.route_counts,
            int4_matmul.launch_counts, int4_matmul.route_counts)


def _counts_now() -> List[Dict[str, int]]:
    return [dict(c) for c in _launch_counters()]


def _counts_since(before: List[Dict[str, int]]) -> List[Dict[str, int]]:
    return [{k: n - b[k] for k, n in c.items() if n != b[k]}
            for c, b in zip(_launch_counters(), before)]


@contextlib.contextmanager
def on_stream(stream):
    """Run the block on ``stream`` (None: the current stream), after the
    current stream's work so far and before its later work."""
    if stream is None:
        yield
        return
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


def capture(graph, fn: Callable[[], Any], pool=None) -> Any:
    """Record ``fn``'s launches on the current stream (not the legacy
    default stream) into ``graph`` and return its output, which each
    ``graph.replay()`` rewrites in place. Thread-local capture mode: the
    server's threads may use CUDA while the step thread captures."""
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        return fn()
    finally:
        graph.capture_end()


@dataclasses.dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph
    # Static output, rewritten by each replay: a step's packed rows, or a
    # burst's {"rows", carry...}. Read or copy it before the next replay.
    out: Any
    launches: List[Dict[str, int]]  # counter changes one replay makes


def _seed_for(seq: Sequence) -> int:
    base = seq.sampling.seed
    if base is None:
        digest = hashlib.blake2b(seq.request_id.encode(), digest_size=4).digest()
        base = int.from_bytes(digest, "little")
    return (base + len(seq.output_token_ids)) & 0x7FFF_FFFF


class ModelRunner:
    def __init__(
        self,
        cfg: EngineConfig,
        model_cfg: Optional[LlamaConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        ranks: Optional[RankContext] = None,
        publisher=None,
    ):
        """``ranks``: this rank's place and groups when the engine has
        more than one rank (``parallel/distributed.py``); ``publisher``:
        rank 0's ``StepPublisher``, which announces each device call to
        the followers (None on a follower, and at one rank). A given
        ``params`` is the whole tree: each rank keeps its stage of its
        shard (of its experts)."""
        t0 = time.perf_counter()
        self.cfg = cfg
        self.tp = cfg.tensor_parallel_size
        self.pp = cfg.pipeline_parallel_size
        self.dp = cfg.data_parallel_size
        self.sp = cfg.sequence_parallel_size
        self.ep = cfg.expert_parallel_size
        if (ranks.world_size if ranks else 1) != cfg.num_ranks:
            raise ValueError(
                f"dp {self.dp} x pp {self.pp} x sp {self.sp} x ep {self.ep} "
                f"x tp {self.tp} needs a rank context of {cfg.num_ranks} "
                "ranks")
        self.ranks = ranks
        self.rank = ranks.rank if ranks else 0
        coords = ranks.coords if ranks else {}
        self.tp_rank = coords.get(AXIS_TENSOR, 0)
        self.stage = coords.get(AXIS_PIPELINE, 0)
        self.dp_rank = coords.get(AXIS_DATA, 0)
        self.sp_rank = coords.get(AXIS_SEQUENCE, 0)
        self.ep_rank = coords.get(AXIS_EXPERT, 0)
        self.publisher = publisher
        self.tp_group = ranks.group(AXIS_TENSOR) if ranks else None
        self.pp_group = ranks.group(AXIS_PIPELINE) if ranks else None
        self.dp_group = ranks.group(AXIS_DATA) if ranks else None
        self.sp_group = ranks.group(AXIS_SEQUENCE) if ranks else None
        self.ep_group = ranks.group(AXIS_EXPERT) if ranks else None
        self._bridge = HostBridge(ranks) if ranks else None
        self.device = ranks.device if ranks else resolve_device(cfg.device)
        if cfg.model_attn_impl == "cuda" and self.device.type != "cuda":
            raise ValueError(f"attn_impl={cfg.attn_impl!r} runs the CUDA "
                             "kernels, which need device='cuda'")
        self.model_cfg = model_cfg or get_model_config(cfg.model)
        check_parallel(cfg, self.model_cfg)
        self.model = Llama(self.model_cfg)
        # This rank's heads, FFN slice, stage's layers and experts: its
        # cache pages and LoRA bank (the forward's router keeps every
        # expert: it runs ``self.model``).
        self.local_cfg = rank_local_config(self.model_cfg, self.tp, self.pp,
                                           self.ep)
        self._local_model = Llama(self.local_cfg)
        shard = (self.tp_rank, self.tp) if self.tp > 1 else None
        stage = (self.stage, self.pp) if self.pp > 1 else None
        experts = (self.ep_rank, self.ep) if self.ep > 1 else None
        # The MoE name every forward and encode takes: "auto" is ragged
        # on one rank and dense on an ep, tp or pp split, as the JAX
        # runner resolves it (both run ``_moe_mlp``'s one body).
        split = self.ep > 1 or self.tp > 1 or self.pp > 1
        self.moe_impl = (("dense" if split else "ragged")
                         if cfg.moe_impl == "auto" else cfg.moe_impl)
        self.kv_dtype = kv_cache_torch_dtype(cfg, self.model_cfg)
        if params is None and os.path.isdir(cfg.model):
            # One stacked leaf at a time onto the device, quantized there.
            params = load_hf_params(self.model_cfg, cfg.model,
                                    quantize=cfg.quantization,
                                    device=self.device, shard=shard,
                                    stage=stage, experts=experts)
        elif params is None:
            # Quantized presets are drawn and quantized a layer's slice at a
            # time on the device: the bf16 tree never exists whole.
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            params = self.model.init_params(gen, self.device,
                                            quantization=cfg.quantization,
                                            shard=shard, stage=stage,
                                            experts=experts)
        else:
            # A given tree is served as it is (a converted JAX
            # quantize_tree output is already quantized), cut to the
            # rank's stage of its shard of its experts first.
            if experts:
                params = expert_params(params, self.model_cfg, *experts)
            if stage:
                params = stage_params(params, self.model_cfg, *stage)
            if shard:
                params = shard_params(params, self.model_cfg, *shard)
            params = _to_device(params, self.device)
            if cfg.quantization and quant_mode(params) != cfg.quantization:
                raise ValueError(
                    f"quantization={cfg.quantization!r} but the given params "
                    f"are {quant_mode(params) or 'not quantized'}")
        # The LoRA bank joins the layers after the weights and before the
        # KV cache is sized from what is left. It is allocated once: every
        # captured graph reads it in place (``install_adapter``). A given
        # tree's bank leaves are dropped.
        for k in [k for k in params["layers"] if k.startswith("lora_")]:
            del params["layers"][k]
        if cfg.enable_lora:
            params["layers"].update(self._local_model.init_lora_bank(
                cfg.max_loras, cfg.max_lora_rank, self.device))
        self.params = params
        self.lora_bank_bytes = sum(
            t.numel() * t.element_size()
            for k, t in params["layers"].items() if k.startswith("lora_"))
        # Resident bytes, quantized leaves as stored (the bank included).
        self.param_bytes = sum(
            t.numel() * t.element_size() for t in _leaves(params)
        )
        self.telemetry = EngineTelemetry(startup_phases=cfg.startup_phases)
        t_load = time.perf_counter()
        self.telemetry.record_startup_phase("load", t_load - t0)
        self.telemetry.set_model_info(
            sum(t.numel() for t in _leaves(params)),
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else None)
        logger.info(
            "params ready (%s): %.2f GiB on %s, %.1fs",
            quant_mode(params) or self.model_cfg.dtype,
            self.param_bytes / 2**30, self.device, time.perf_counter() - t0,
        )
        if ranks is None:
            self.num_blocks = resolve_num_kv_blocks(cfg, self.model_cfg,
                                                    self.device)
        else:
            self.num_blocks = self._agree_num_blocks()
            # One transport for each, whatever the backend: gloo's and
            # NCCL's broadcast and all-gather both take CUDA tensors.
            logger.info(
                "rank %d: stage %d of %d (%d layers), hand-off by broadcast "
                "over the pp group (%s); replica %d of %d, rows and K/V "
                "rows by all-gather over the dp group (%s)", self.rank,
                self.stage, self.pp, self.local_cfg.num_layers,
                ranks.backends.get(AXIS_PIPELINE, "none"), self.dp_rank,
                self.dp, ranks.backends.get(AXIS_DATA, "none"))
            sp_backend = ranks.backends.get(AXIS_SEQUENCE)
            logger.info(
                "rank %d: sequence rank %d of %d, the ring encode's K/V "
                "rotation %s over the sp group (%s); expert rank %d of %d "
                "(%d experts), the combine by all-reduce over the ep group "
                "(%s)", self.rank, self.sp_rank, self.sp,
                ring_transport(sp_backend, self.device.type)
                if sp_backend else "none", sp_backend or "none",
                self.ep_rank, self.ep, self.local_cfg.num_experts,
                ranks.backends.get(AXIS_EXPERT, "none"))
        self.max_table_width = -(-cfg.max_model_len // cfg.block_size)
        self.kv_cache = self._local_model.make_kv_cache(
            self.num_blocks, cfg.block_size, dtype=self.kv_dtype,
            device=self.device
        )
        logger.info(
            "KV cache: %d pages x %d tokens in %s (%.1f MiB)",
            self.num_blocks, cfg.block_size, self.kv_dtype,
            self.kv_cache.numel() * self.kv_dtype.itemsize / 2**20,
        )
        self._drop_slot = self.num_blocks * cfg.block_size

        # Static inputs, one flat buffer a name, sized for the largest
        # bucket of the lattice and allocated here, outside any graph's
        # pool (dtypes from the warmup batches, which carry live dtypes).
        # Encodes run eagerly on tensors of their own (``encode``).
        lattice = [b for b in enumerate_lattice(cfg) if b.kind != "encode"]
        need: Dict[str, np.ndarray] = {}
        for bucket in lattice:
            for name, v in self._warmup_batch(bucket).items():
                if name not in need or v.size > need[name].size:
                    need[name] = v
        self._bufs: Dict[Any, torch.Tensor] = {
            name: torch.empty(v.size, dtype=torch.from_numpy(v).dtype,
                              device=self.device)
            for name, v in need.items()
        }
        # Graphs by step key, all in one memory pool. Sharing the pool is
        # safe only because each graph's output is read (or dropped)
        # before the next replay: a later capture may place its tensors
        # where an earlier graph keeps its intermediates.
        self._graphs: Dict[tuple, _Graph] = {}
        self.graph_counts = {"captured": 0, "replayed": 0, "eager": 0,
                             "dropped": 0}
        self.graph_pool_bytes = 0  # device memory the captures reserved
        # None: steps run eagerly (CPU tensors, and a device group whose
        # collectives no graph can hold).
        self._graph_cls = None
        self._capture_stream = self._pool = None
        if self.device.type == "cuda" and (ranks is None or ranks.capturable):
            self._graph_cls = torch.cuda.CUDAGraph
            self._capture_stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        if self.device.type == "cuda":
            # The split kernels' tickets for the largest launch of the
            # lattice, before any capture (a graph keeps the buffer it saw).
            # A dp replica launches over its own rows of a split batch.
            mc = self.local_cfg
            paged_attention_cuda.reserve_tickets(self.device, max(
                paged_attention_cuda.ticket_count(
                    mc.torch_dtype, self.kv_dtype, mc.num_heads,
                    mc.num_kv_heads, mc.head_dim,
                    b.rows // self.dp if self._split(b.rows) else b.rows,
                    _step_tokens(b))
                for b in lattice))
        # When the last decode step's rows reached the host (None after a
        # prefill): the next decode dispatch closes the host gap.
        self._host_gap_t0: Optional[float] = None
        # The pipelined burst in flight (burst_start .. burst_drain), on
        # rank 0; its static inputs, graph key, eager function and the
        # whole batch's row count, on every rank (set by each
        # burst_start).
        self._burst: Optional[Dict[str, Any]] = None
        self._pipe: Optional[tuple] = None
        # The decode batch's rows and their row bucket, kept while rows
        # only leave the batch (``_decode_rows``).
        self._decode_cohort: Tuple[List[Sequence], frozenset, int] = (
            [], frozenset(), 0)
        # A digest of every step's sampled rows on this rank (more than
        # one rank only): every rank holds every row after the dp
        # gather, so the digests are equal on every rank while the ranks
        # draw alike.
        self._rows_digest = (torch.zeros((), dtype=torch.int64,
                                         device=self.device)
                             if ranks else None)
        # The last encode's peak device memory above what it found
        # allocated, and the process's peak before encodes reset it.
        self.encode_peak_bytes = 0
        self._peak_floor = 0
        self.telemetry.record_startup_phase(
            "shard", time.perf_counter() - t_load)

    def _agree_num_blocks(self) -> int:
        """The KV block count every rank allocates: each rank's budget
        (its card's, split among the ranks on it) sized after a barrier
        that follows every rank's weights (and, on the card, the kernel
        library rank 0 built before it), and the least of them. Each rank
        first returns the blocks its weights' draws left cached, which
        ranks sharing the card would otherwise count as used."""
        on_gpu = self.device.type == "cuda"
        if on_gpu:
            torch.cuda.empty_cache()
        if on_gpu and self.rank == 0:
            _build.load()
        self._bridge.barrier()
        if on_gpu and self.rank != 0:
            _build.load()
        n = resolve_num_kv_blocks(self.cfg, self.local_cfg, self.device,
                                  share=self.ranks.ranks_on_device())
        n = self._bridge.all_min(n)
        logger.info("rank %d %s: %d KV blocks of %d layers agreed across "
                    "%d ranks", self.rank, self.ranks.coords, n,
                    self.local_cfg.num_layers, self.ranks.world_size)
        return n

    def _split(self, rows: int) -> bool:
        """Whether a step of ``rows`` rows is split over the ``dp``
        replicas: JAX's rule, rows sharded when ``rows % dp == 0``, the
        batch replicated otherwise."""
        return self.dp > 1 and rows % self.dp == 0

    def _my_rows(self, batch: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, np.ndarray], bool]:
        """(this replica's rows of an announced batch, whether it was
        split): the ``dp_rank``-th contiguous ``Bb/dp`` rows of every
        array (all are row-major), or the whole batch."""
        B = batch["kv_lens"].shape[0]
        if not self._split(B):
            return batch, False
        n = B // self.dp
        rows = slice(self.dp_rank * n, (self.dp_rank + 1) * n)
        return {k: v[rows] for k, v in batch.items()}, True

    def _all_rows(self, t: torch.Tensor, split: bool) -> torch.Tensor:
        """Every replica's rows of ``t`` (its leading axis), gathered over
        ``dp`` in row order, where the step was split: every rank returns
        the whole batch's."""
        if not split:
            return t
        parts = [torch.empty_like(t) for _ in range(self.dp)]
        torch.distributed.all_gather(parts, t.contiguous(),
                                     group=self.dp_group)
        return torch.cat(parts)

    @contextlib.contextmanager
    def _mirror(self, kind: str, *args):
        """Announce device call ``kind`` with ``args`` to the followers,
        which call ``MIRRORED[kind]`` with them, and hold the publisher's
        lock while the block dispatches it: no other announcement (a
        keepalive) comes between. A no-op on a follower and at one rank;
        a kind outside ``MIRRORED`` raises on every rank."""
        if kind not in MIRRORED:
            raise KeyError(f"device call {kind!r} is not mirrored")
        pub = self.publisher
        if pub is None:
            yield
            return
        with pub.lock:
            pub.announce(kind, args)
            yield

    def _note_rows(self, rows: torch.Tensor) -> None:
        """Fold a step's sampled rows into this rank's digest, on the
        device (no host sync); more than one rank only."""
        if self._rows_digest is None:
            return
        r = rows.reshape(-1)
        if r.dtype.is_floating_point:
            r = r.view(torch.int32)
        w = torch.arange(1, r.numel() + 1, dtype=torch.int64, device=r.device)
        self._rows_digest.mul_(1_000_003).add_((r.long() * w).sum())

    def rank_report(self) -> Dict[str, Any]:
        """This rank's coordinates, device, device groups' backends,
        weight bytes, graph counts, kernel launch counts, peak device
        memory (and the last encode's, above what it found), KV blocks
        and rows digest."""
        cuda = self.device.type == "cuda"
        return {
            "rank": self.rank,
            "coords": self.ranks.coords if self.ranks else {},
            "device": str(self.device),
            "backend": self.ranks.backend if self.ranks else None,
            "backends": dict(self.ranks.backends) if self.ranks else {},
            "layers": self.local_cfg.num_layers,
            # This rank's resident weights, as stored (its shard).
            "param_bytes": self.param_bytes,
            "graph_counts": dict(self.graph_counts),
            # The kernels' launch counters that moved, the int4 routes
            # named ``int4_<route>``.
            "launches": {k: n for k, n in {
                **paged_attention_cuda.launch_counts,
                **paged_attention_cuda.route_counts,
                **int4_matmul.launch_counts,
                **{f"int4_{r}": n
                   for r, n in int4_matmul.route_counts.items()}}.items()
                if n},
            "peak_memory_bytes": (max(
                self._peak_floor,
                torch.cuda.max_memory_allocated(self.device)) if cuda else 0),
            "encode_peak_bytes": self.encode_peak_bytes,
            "num_blocks": self.num_blocks,
            # This process's hand-offs, dp exchanges, ring hops, ep
            # combines and tp table traffic (eager calls).
            "traffic": {k: dict(v) for k, v in PARALLEL_TRAFFIC.items()},
            "rows_digest": (int(self._rows_digest)
                            if self._rows_digest is not None else None),
        }

    def rank_reports(self) -> List[Dict[str, Any]]:
        """Every rank's ``rank_report``, by rank (on rank 0; a mirrored
        call, made between steps)."""
        if self.ranks is None:
            return [self.rank_report()]
        with self._mirror("report"):
            return self._bridge.gather(self.rank_report())

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------

    @staticmethod
    def _want_lp(seqs: List[Sequence]) -> bool:
        return any(s.sampling.logprobs is not None for s in seqs)

    @staticmethod
    def _all_greedy(seqs: List[Sequence]) -> bool:
        return all(s.sampling.greedy for s in seqs)

    def execute_prefill_batch(self, items: List[PrefillItem]) -> np.ndarray:
        """Prefill several chunks in one step (rows padded to a common
        chunk bucket). Returns packed sample rows
        [len(items), 1 or PACKED_WIDTH]."""
        seqs = [i.seq for i in items]
        batch = self._prefill_batch(items)
        want_lp, greedy = self._want_lp(seqs), self._all_greedy(seqs)
        rows = self._timed("prefill", *self._prefill_tel(items, batch),
                           lambda: self._step(batch, want_lp, greedy).cpu(),
                           charge=lambda dt: self._charge_prefill(items, dt))
        return rows.numpy()[: len(items)]

    def execute_prefill_batch_nofetch(self, items: List[PrefillItem]) -> None:
        """A prefill step whose sampled tokens nobody reads (intermediate
        chunks): the cheapest sampling variant, no host copy."""
        batch = self._prefill_batch(items)
        self._timed("prefill", *self._prefill_tel(items, batch),
                    lambda: self._step(batch, False, True, "step_nofetch"),
                    charge=lambda dt: self._charge_prefill(items, dt))

    def execute_decode(self, seqs: List[Sequence]) -> np.ndarray:
        """One decode step per sequence. Returns packed sample rows
        [len(seqs), 1 or PACKED_WIDTH]."""
        batch = self._decode_batch(seqs)
        want_lp, greedy = self._want_lp(seqs), self._all_greedy(seqs)
        rows = self._timed_decode(
            seqs, batch, 1, lambda: self._step(batch, want_lp, greedy).cpu())
        return rows.numpy()[: len(seqs)]

    def execute_decode_multi(self, seqs: List[Sequence], n_steps: int) -> np.ndarray:
        """Decode burst: ``n_steps`` tokens per sequence. Returns packed rows
        [len(seqs), n_steps, W] (the host trims at stops)."""
        if n_steps == 1:
            return self.execute_decode(seqs)[:, None]
        batch = self._decode_batch(seqs, multi=True)
        if "allowed_ids" in batch:
            raise RuntimeError("guided-choice rows reached a multi-step decode burst")
        if any(s.sampling.has_penalties for s in seqs):
            self._dense_penalties(seqs, batch)
        want_lp, greedy = self._want_lp(seqs), self._all_greedy(seqs)
        rows = self._timed_decode(
            seqs, batch, n_steps,
            lambda: self._multi_step(batch, n_steps, want_lp,
                                     greedy)["rows"].cpu())
        return rows.numpy()[: len(seqs)]

    def execute_spec_verify(self, seqs: List[Sequence], drafts: np.ndarray
                            ) -> "tuple[np.ndarray, np.ndarray]":
        """The speculative verify step: each sequence's last committed
        token and its K draft tokens (``drafts`` [B, K] int32) scored in
        one forward pass. Returns ``(argmax_ids [B, K+1], sampled0
        [B])``: position j's argmax is the token the model emits after
        positions <= p0 + j, and ``sampled0`` is position 0 through the
        full sampler (temperature, top-p/k, seeds, logit_bias, a guided
        mask), so a draftless row gets the token a plain decode step
        gives it. KV is written for all K+1 positions; rejected ones lie
        past the committed length and are overwritten by real decode."""
        B, K = drafts.shape
        batch = self._spec_batch(seqs, drafts)
        Bb = batch["kv_lens"].shape[0]
        self._host_gap_t0 = None  # a verify step is no plain decode step
        rows = self._timed("spec_verify", f"b{Bb}xk{K}", B * (K + 1), B / Bb,
                           lambda: self._spec_verify(batch).cpu(),
                           charge=lambda dt: self._charge_decode(seqs, dt))
        rows = rows.numpy()[:B]
        return rows[:, :-1], rows[:, -1]

    # ------------------------------------------------------------------
    # Pipelined decode bursts: one burst in flight, its rows fetched while
    # the next one runs (the JAX runner's burst_* contract)
    # ------------------------------------------------------------------

    @property
    def burst_in_flight(self) -> bool:
        return self._burst is not None

    def burst_start(self, seqs: List[Sequence], n_steps: int) -> None:
        """Dispatch the first burst of a pipeline; nothing is fetched."""
        if self._burst is not None:
            raise RuntimeError("burst already in flight (drain first)")
        batch = self._decode_batch(seqs, multi=True)
        if "allowed_ids" in batch:
            raise RuntimeError(
                "guided-choice rows reached a pipelined decode burst")
        if any(s.sampling.has_penalties for s in seqs):
            self._dense_penalties(seqs, batch)
        want_lp, greedy = self._want_lp(seqs), self._all_greedy(seqs)
        Bb = batch["kv_lens"].shape[0]
        label = f"b{Bb}xn{n_steps}"
        if self._host_gap_t0 is not None:
            self.telemetry.record_host_gap(
                label, time.perf_counter() - self._host_gap_t0)
            self._host_gap_t0 = None

        def step():
            rows = self._dispatch_burst_start(batch, n_steps, want_lp,
                                              greedy)
            slots = [self._host_slot(rows) for _ in range(2)]
            self._burst = {"n": n_steps, "label": label,
                           "members": len(seqs), "slots": slots, "count": 1,
                           "pending": self._stage(rows, slots[0])}

        self._timed("decode", label, len(seqs) * n_steps, len(seqs) / Bb,
                    step, charge=lambda dt: self._charge_decode(seqs, dt))

    def burst_width_stable(self, members: List[Sequence]) -> bool:
        """True while the members' block tables still fit the table width
        the in-flight burst was dispatched with (growth needs a drain)."""
        if self._burst is None:
            return False
        Wb = self._pipe[0]["block_tables"].shape[1]
        return max(len(s.block_ids) for s in members) <= Wb

    def burst_continue(self, members: List[Sequence]) -> np.ndarray:
        """Dispatch the NEXT burst, then fetch and return the PREVIOUS
        burst's rows [len(members), n, W]: the fetch waits while the new
        burst runs. ``members`` is the pipeline's membership in its
        original order: their block tables are refreshed (the scheduler
        reserved lookahead pages on the host) and members that finished
        on the host get ``kv_len`` 0, so their rows stop writing KV."""
        st = self._burst
        if st is None:
            raise RuntimeError("no burst in flight")
        Bb, Wb = self._pipe[3], self._pipe[0]["block_tables"].shape[1]
        tables = np.zeros((Bb, Wb), np.int32)
        kv_lens = np.zeros(Bb, np.int32)
        for i, s in enumerate(members):
            tables[i] = self._table_row(s, Wb)
            kv_lens[i] = 0 if s.is_finished else max(s.num_tokens, 1)
        alive = sum(1 for s in members if not s.is_finished)

        def step():
            rows = self._dispatch_burst_continue(tables, kv_lens)
            slot = st["slots"][st["count"] % 2]
            st["count"] += 1
            prev, st["pending"] = st["pending"], self._stage(rows, slot)
            return self._fetch(prev)

        # Dispatched before the previous burst's rows were read: the
        # device runs the two back to back, so this step's host gap is 0.
        self.telemetry.record_host_gap(st["label"], 0.0)
        # This wall segment (the next burst's dispatch and the previous
        # one's fetch) is charged once, to the members still alive.
        rows = self._timed("decode", st["label"], alive * st["n"],
                           alive / Bb, step,
                           charge=lambda dt: self._charge_decode(members, dt))
        return rows[: len(members)]

    def burst_drain(self) -> np.ndarray:
        """Fetch the in-flight burst's rows and end the pipeline."""
        st, self._burst = self._burst, None
        if st is None:
            raise RuntimeError("no burst in flight")
        rows = self._fetch(st["pending"])
        # A drain is a transition (an arrival or a shape change broke the
        # pipeline; a prefill may be queued behind it): the wall up to the
        # next decode dispatch is not steady-state host bookkeeping.
        self._host_gap_t0 = None
        return rows[: st["members"]]

    def prefill_dispatch(self, items: List[PrefillItem]):
        """The dispatch half of a prefill step, whose fetch
        (``prefill_fetch``) comes later: a new arrival's prefill runs
        behind an in-flight burst, and the burst's drain waits while the
        prefill runs."""
        seqs = [i.seq for i in items]
        batch = self._prefill_batch(items)
        want_lp, greedy = self._want_lp(seqs), self._all_greedy(seqs)

        def step():
            out = self._step(batch, want_lp, greedy)
            return self._stage(out, self._host_slot(out))

        return self._timed("prefill", *self._prefill_tel(items, batch), step,
                           charge=lambda dt: self._charge_prefill(items, dt))

    def prefill_fetch(self, handle, n_items: int) -> np.ndarray:
        return self._fetch(handle)[:n_items]

    def _dispatch_burst_start(self, batch: Dict[str, np.ndarray],
                              n_steps: int, want_lp: bool, greedy: bool
                              ) -> torch.Tensor:
        """A pipeline's first burst on the device; returns its rows. The
        pipeline (static inputs, graph key, eager function) is kept in
        ``_pipe`` for its continuations, and the burst's carry is moved
        into the static inputs before anything else is enqueued.
        Mirrored as ``burst_start``."""
        with self._mirror("burst_start", batch, n_steps, want_lp, greedy):
            mine, split = self._my_rows(batch)
            dev = self._put(mine)
            key = self._key("burst", dev, want_lp, greedy, n_steps, split)
            fn = lambda: self.eager_multi_step(  # noqa: E731
                dev, n_steps, want_lp, greedy, split)
            self._pipe = (dev, key, fn, batch["kv_lens"].shape[0])
            return self._burst_out(self._run(key, fn))

    def _dispatch_burst_continue(self, tables: np.ndarray,
                                 kv_lens: np.ndarray) -> torch.Tensor:
        """The next burst of the pipeline in ``_pipe``: fresh block tables
        and ``kv_lens``, the carry already in the static inputs; returns
        its rows. Mirrored as ``burst_cont``, before rank 0 fetches the
        previous burst. A ``dp`` replica takes the rows it started with."""
        with self._mirror("burst_cont", tables, kv_lens):
            _, key, fn, _ = self._pipe
            self._put(self._my_rows({"block_tables": tables,
                                     "kv_lens": kv_lens})[0])
            return self._burst_out(self._run(key, fn))

    def _burst_out(self, out: Dict[str, torch.Tensor]) -> torch.Tensor:
        """A pipelined burst's carry (every output but the rows) into the
        static inputs its continuation reads; its rows."""
        dev = self._pipe[0]
        for k, v in out.items():
            if k != "rows":
                dev[k].copy_(v)
        self._note_rows(out["rows"])
        return out["rows"]

    def _host_slot(self, like: torch.Tensor) -> torch.Tensor:
        """A host tensor for a step's rows: pinned on the GPU, so the
        copy into it runs on the stream without holding the host."""
        return torch.empty(like.shape, dtype=like.dtype,
                           pin_memory=self.device.type == "cuda")

    def _stage(self, rows: torch.Tensor, slot: torch.Tensor) -> tuple:
        """Move a dispatched step's rows out of the graph pool, into the
        host ``slot``, before anything else is enqueued. Returns (slot,
        the event the fetch waits on)."""
        slot.copy_(rows, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return slot, event

    @staticmethod
    def _fetch(pending: tuple) -> np.ndarray:
        slot, event = pending
        if event is not None:
            event.synchronize()
        return slot.numpy().copy()  # the slot is written again later

    def warmup_bucket(self, bucket) -> None:
        """Capture one lattice bucket from an all-padding dummy batch.

        Every row carries ``kv_len = 0`` and writes to the drop slot, so
        the step touches no real KV state; its input names, shapes and
        flags are exactly what live traffic produces, so the first live
        batch of the bucket replays its graph. An encode bucket runs once,
        uncaptured."""
        if bucket.kind == "encode":
            # One all-padding encode, eager and uncaptured; length 1, not
            # 0, as the JAX warmup (the mean pool divides by it).
            toks = np.zeros((1, bucket.tokens), np.int32)
            self._host_gap_t0 = None
            self._timed("encode", bucket.label, 0, None,
                        lambda: self._encode(toks, 1), live=False)
            return
        batch = self._warmup_batch(bucket)
        if bucket.kind == "decode_burst":
            step = lambda: self._multi_step(  # noqa: E731
                batch, bucket.n_steps, bucket.want_lp, bucket.greedy)
        elif bucket.kind == "spec_verify":
            step = lambda: self._spec_verify(batch)  # noqa: E731
        elif bucket.kind in ("decode", "prefill"):
            step = lambda: self._step(  # noqa: E731
                batch, bucket.want_lp, bucket.greedy)
        else:
            raise ValueError(f"unknown warmup bucket kind {bucket.kind!r}")
        self._host_gap_t0 = None
        # Serves no request: no tokens, no device-busy seconds.
        kind = "decode" if bucket.kind.startswith("decode") else bucket.kind
        self._timed(kind, bucket.label, 0, None, step, live=False)

    # ------------------------------------------------------------------
    # Embeddings (/v1/embeddings): the whole-prompt encode, mean-pooled
    # ------------------------------------------------------------------

    def encode(self, token_ids) -> np.ndarray:
        """The L2-normalized mean-pooled final hidden states of one prompt
        ([D] float32), padded into the pow2 bucket of its length, as the
        JAX runner pads it. Run eagerly, never captured, between steps
        (the async engine calls ``encode_dispatch`` on its step thread)."""
        return self.encode_dispatch(*self.encode_input(token_ids))

    def encode_input(self, token_ids) -> Tuple[np.ndarray, int]:
        """(the padded ``[1, T]`` ids, the prompt's length) of an encode. A
        prompt longer than ``max_model_len``, or holding an id outside the
        vocabulary, raises ``ValueError``: the JAX runner fails inside
        numpy on the first and clamps the second."""
        ids = [int(t) for t in token_ids]
        n, V = len(ids), self.model_cfg.vocab_size
        if n > self.cfg.max_model_len:
            raise ValueError(
                f"input of {n} tokens exceeds max_model_len "
                f"({self.cfg.max_model_len})")
        if any(t < 0 or t >= V for t in ids):
            raise ValueError(f"token ids must lie in [0, {V})")
        T = _pow2(max(n, 1), cap=_pow2(self.cfg.max_model_len))
        # The ring shards T over sp: the bucket rounded up to a multiple.
        T = -(-T // self.sp) * self.sp
        toks = np.zeros((1, T), np.int32)
        toks[0, :n] = ids
        return toks, n

    def encode_dispatch(self, toks: np.ndarray, n: int) -> np.ndarray:
        """Run and record one encode of ``encode_input``'s arrays: a
        flight row of kind ``encode`` at bucket ``t{T}``."""
        T = toks.shape[1]
        self._host_gap_t0 = None  # an encode between decode steps
        return self._timed("encode", f"t{T}", n, n / T,
                           lambda: self._encode(toks, n))

    def _encode(self, toks: np.ndarray, length: int) -> np.ndarray:
        with self._mirror("encode", toks, length):
            cuda = self.device.type == "cuda"
            if cuda:  # the encode's own peak, above what it found
                self._peak_floor = max(
                    self._peak_floor,
                    torch.cuda.max_memory_allocated(self.device))
                base = torch.cuda.memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            tokens = torch.from_numpy(toks).to(self.device)
            lengths = torch.tensor([length], dtype=torch.int32,
                                   device=self.device)
            out = self.model.encode(self.params, tokens, lengths,
                                    moe_impl=self.moe_impl,
                                    tp_group=self.tp_group,
                                    pp_group=self.pp_group,
                                    pp_stage=self.stage,
                                    sp_group=self.sp_group,
                                    sp_rank=self.sp_rank,
                                    ep_group=self.ep_group)
            if cuda:
                self.encode_peak_bytes = (
                    torch.cuda.max_memory_allocated(self.device) - base)
        return out[0].cpu().numpy()

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------

    def _timed(self, kind: str, label: str, tokens: int,
               fill: Optional[float], step: Callable[[], Any],
               live: bool = True,
               charge: Optional[Callable[[float], None]] = None) -> Any:
        """Run ``step`` (a device step, and its fetch where it has one)
        and record it: as a compile when it captured its graph key. A
        live step's wall is passed to ``charge``."""
        captured = self.graph_counts["captured"]
        t0 = time.perf_counter()
        out = step()
        dt = time.perf_counter() - t0
        if live and charge is not None and self.cfg.cost_attribution:
            charge(dt)
        self.telemetry.record_dispatch(
            kind, label, dt,
            first_use=self.graph_counts["captured"] > captured,
            tokens=tokens, fill_ratio=fill, count_busy=live)
        return out

    @staticmethod
    def _charge_decode(seqs: List[Sequence], seconds: float) -> None:
        """Split a decode step's or burst's wall equally over its live
        rows (padding rows and finished pipeline members cost nothing)."""
        alive = [s for s in seqs if not s.is_finished]
        if seconds <= 0 or not alive:
            return
        share = seconds / len(alive)
        now = time.monotonic()
        for s in alive:
            s.cost_decode_s += share
            s.charge_kv_pages(now)

    @staticmethod
    def _charge_prefill(items: List[PrefillItem], seconds: float) -> None:
        """Split a prefill step's wall over its chunks by their real
        tokens."""
        total = sum(it.end - it.start for it in items)
        if seconds <= 0 or total <= 0:
            return
        now = time.monotonic()
        for it in items:
            it.seq.cost_prefill_s += seconds * (it.end - it.start) / total
            it.seq.charge_kv_pages(now)

    def _timed_decode(self, seqs: List[Sequence],
                      batch: Dict[str, np.ndarray], n_steps: int,
                      step: Callable[[], torch.Tensor]) -> torch.Tensor:
        """A decode step or burst, timed and recorded, and the host gap
        since the last decode step's fetch (serial: bursts are not
        pipelined, so none records 0)."""
        Bb = batch["kv_lens"].shape[0]
        label = f"b{Bb}" if n_steps == 1 else f"b{Bb}xn{n_steps}"
        if self._host_gap_t0 is not None:
            self.telemetry.record_host_gap(
                label, time.perf_counter() - self._host_gap_t0)
        rows = self._timed("decode", label, len(seqs) * n_steps,
                           len(seqs) / Bb, step,
                           charge=lambda dt: self._charge_decode(seqs, dt))
        self._host_gap_t0 = time.perf_counter()
        return rows

    def _prefill_tel(self, items: List[PrefillItem],
                     batch: Dict[str, np.ndarray]) -> tuple:
        """(bucket label, real tokens, fill ratio) of a prefill step; a
        prefill between two decode steps ends the host gap unrecorded."""
        self._host_gap_t0 = None
        Bb, Tb = batch["tokens"].shape
        real = sum(it.end - it.start for it in items)
        return f"b{Bb}xt{Tb}", real, real / max(Bb * Tb, 1)

    # ------------------------------------------------------------------
    # LoRA bank slots (engine/lora.py owns name -> slot)
    # ------------------------------------------------------------------

    def install_adapter(self, slot: int, arrays: Dict[str, Any]) -> None:
        """Write one adapter's matrices into bank slot ``slot`` (``arrays``:
        {target: (A [L, in, r_max], B [L, r_max, out])} host float32,
        cast to the bank's dtype). In place: the captured graphs read the
        bank's address, and a rebound leaf would leave them reading the
        old one. Queued on the current stream, behind any step in
        flight; the engine calls it on the step thread between
        dispatches. Across ranks every rank gets the whole arrays and
        writes its stage's layers of its cut of each (``lora_pspecs``)."""
        with self._mirror("install_adapter", slot, arrays):
            layers = self.params["layers"]
            for t, (a, b) in arrays.items():
                for name, x in ((f"lora_a_{t}", a), (f"lora_b_{t}", b)):
                    x = shard_leaf(name, stage_leaf(x, self.stage, self.pp),
                                   self.tp_rank, self.tp)
                    layers[name][:, slot].copy_(torch.from_numpy(x))

    def uninstall_adapter(self, slot: int) -> None:
        """Zero bank slot ``slot`` in place, so its id can be reused."""
        with self._mirror("uninstall_adapter", slot):
            for k, t in self.params["layers"].items():
                if k.startswith("lora_"):
                    t[:, slot].zero_()

    # ------------------------------------------------------------------
    # Sleep (level 2): the KV cache and the graphs that hold its address
    # ------------------------------------------------------------------

    def drop_kv_cache(self) -> None:
        """Free the KV cache, and with it every captured graph, its
        static output and its pool: a graph replays into the addresses it
        captured, so none captured before the drop may replay after it.
        The static inputs and the split kernels' tickets stay (neither
        refers to the cache)."""
        if self._burst is not None:
            raise RuntimeError("a decode burst is in flight (drain first)")
        with self._mirror("drop_kv"):
            self._drop_kv_cache()

    def _drop_kv_cache(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no replay still runs
        n_graphs = len(self._graphs)
        self.graph_counts["dropped"] += n_graphs
        self._graphs.clear()
        self.kv_cache = None
        self._pool = None
        self.graph_pool_bytes = 0
        self._host_gap_t0 = None
        gc.collect()  # a cycle holding a graph or the cache keeps its memory
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # the freed segments go back (cudaFree)
        logger.info("KV cache and %d step graphs dropped", n_graphs)

    def restore_kv_cache(self) -> None:
        """A zeroed cache of the dropped one's shape and type, and a new
        graph pool: every step key captures afresh on first use."""
        with self._mirror("restore_kv"):
            self.kv_cache = self._local_model.make_kv_cache(
                self.num_blocks, self.cfg.block_size, dtype=self.kv_dtype,
                device=self.device)
            if self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()

    # ------------------------------------------------------------------
    # Page I/O for KV swap (engine/swap.py): one page's K and V of every
    # layer, device <-> host, queued on the step stream
    # ------------------------------------------------------------------

    def download_page(self, blk: int) -> tuple:
        """Page ``blk``'s K and V, each ``[L, bs, KH, hd]`` in the cache's
        type, on the host. On the GPU the copies are queued on the current
        stream into pinned memory and nothing waits for them: they run
        after the steps queued before (an in-flight burst included), and
        an upload of the same tensors queued later reads them only after
        they landed. A host reader synchronizes first.

        Across ranks (a mirrored call) each rank copies its stage's layers
        of its heads of the page to the host and rank 0 gathers them over
        the control group: the page it returns is whole (the first ``dp``
        replica's), and the copies have landed on return."""
        mc = self.model_cfg
        L, bs = mc.num_layers, self.cfg.block_size
        if self.ranks is not None:
            with self._mirror("download_page", blk):
                return self._gather_page(blk)
        pin = self.device.type == "cuda"
        out = []
        for kv in (0, 1):
            host = torch.empty((L, bs, mc.num_kv_heads, mc.head_dim),
                               dtype=self.kv_dtype, pin_memory=pin)
            host.view(L, bs, -1).copy_(self.kv_cache[:, blk, kv],
                                       non_blocking=pin)
            out.append(host)
        return out[0], out[1]

    def page_replicas(self, blocks: List[int]) -> List[torch.Tensor]:
        """Every rank's own bytes of pages ``blocks``, by global rank, on
        rank 0: ``[Ll, len(blocks), 2, bs, KHl*hd*itemsize]`` uint8 (its
        stage's layers of its heads), which ranks that differ only in
        ``dp`` hold equal. A mirrored call, made between steps."""
        if self.ranks is None:
            return [self._local_pages(blocks)]
        with self._mirror("download_page", blocks, True):
            return self._gather_page(blocks, True)

    def _local_pages(self, blk) -> torch.Tensor:
        return self.kv_cache[:, blk].to("cpu").view(torch.uint8)

    def _gather_page(self, blk, replicas: bool = False):
        """Page ``blk``'s K and V ``[L, bs, KH, hd]`` gathered from every
        stage's layers and every ``tp`` rank's heads (of the first ``dp``
        replica), on rank 0 (None on a follower); with ``replicas``, every
        rank's bytes of pages ``blk`` (``page_replicas``). The heads
        travel as bytes, whatever the cache's type."""
        # [Ll, (n,) 2, bs, KHl*hd*isz] on every rank
        parts = self._bridge.gather_tensor(self._local_pages(blk))
        if parts is None or replicas:
            return parts
        L, bs, hd = (self.model_cfg.num_layers, self.cfg.block_size,
                     self.model_cfg.head_dim)
        Ll, khl = self.local_cfg.num_layers, self.local_cfg.num_kv_heads
        grid = self.ranks.grid

        def stage(s: int, kv: int) -> torch.Tensor:
            return torch.cat([parts[grid.rank(pp=s, tp=t)][:, kv].reshape(
                Ll, bs, khl, -1) for t in range(self.tp)], dim=2)

        return tuple(
            torch.cat([stage(s, kv) for s in range(self.pp)])
            .view(self.kv_dtype).reshape(L, bs, -1, hd) for kv in (0, 1))

    def upload_page(self, blk: int, k, v) -> None:
        """Write K and V (``download_page``'s shapes and type) into page
        ``blk`` of the existing cache, in place and queued on the current
        stream: every captured step graph holds the cache's address, so
        the cache is never rebound. Across ranks the whole page is
        announced as bytes and each rank writes its stage's layers of its
        heads (every ``dp`` replica the same)."""
        if self.ranks is not None:
            raw = tuple(t.contiguous().view(torch.uint8) for t in (k, v))
            with self._mirror("upload_page", blk, *raw):
                self._dispatch_upload_page(blk, *raw)
            return
        L, bs = self.model_cfg.num_layers, self.cfg.block_size
        pin = self.device.type == "cuda"
        for kv, host in ((0, k), (1, v)):
            self.kv_cache[:, blk, kv].copy_(
                host.reshape(L, bs, -1), non_blocking=pin)

    def _dispatch_upload_page(self, blk: int, k_raw: torch.Tensor,
                              v_raw: torch.Tensor) -> None:
        """Write this rank's stage's layers of its heads of a whole page's
        bytes (``[L, bs, KH, hd * itemsize]`` uint8) into page ``blk``."""
        Ll, bs = self.local_cfg.num_layers, self.cfg.block_size
        khl = self.local_cfg.num_kv_heads
        layers = slice(self.stage * Ll, (self.stage + 1) * Ll)
        heads = slice(self.tp_rank * khl, (self.tp_rank + 1) * khl)
        for kv, raw in ((0, k_raw), (1, v_raw)):
            mine = raw[layers, :, heads].contiguous().view(self.kv_dtype)
            self.kv_cache[:, blk, kv].copy_(mine.reshape(Ll, bs, -1))

    def page_event(self):
        """A CUDA event recorded on the current stream after the page
        copies queued so far (None on the CPU, whose copies are done on
        return): a host reader of ``download_page``'s tensors on another
        thread waits on it (``cache_tiering.wait_landed``), never on the
        whole device."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Copy the batch into the static buffers; returns their views.
        Allocates only for a width the lattice cannot enumerate. On the
        GPU each array is staged in pinned memory, so the copy is queued
        on the stream (behind an in-flight burst) without holding the
        host; the pinned allocator keeps the block until the copy ran."""
        pin = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            host = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                host = host.pin_memory()
            buf = self._bufs.get(k)
            if buf is None or buf.numel() < host.numel():
                # The single-step penalty ids, allowed_ids and bias_*
                # arrays (pow2 widths from the requests): a buffer a
                # width, made on first use and kept for the graphs that
                # read it, as the JAX runner compiles such a shape on
                # first use.
                buf = self._bufs.get((k, host.numel()))
                if buf is None:
                    buf = self._bufs[(k, host.numel())] = torch.empty(
                        host.numel(), dtype=host.dtype, device=self.device)
            view = buf[: host.numel()].view(host.shape)
            view.copy_(host, non_blocking=True)
            out[k] = view
        return out

    def _key(self, kind: str, dev: Dict[str, torch.Tensor], want_lp: bool,
             greedy: bool, n_steps: int, split: bool = False) -> tuple:
        """A step's graph key. ``PST_FUSED_KV_WRITE`` is in it: the model
        reads it on every call and a graph fixes the choice at capture;
        so is the ``dp`` split (a replica's rows of a split batch and a
        whole smaller batch may have one shape)."""
        shapes = tuple(sorted((k, tuple(v.shape)) for k, v in dev.items()))
        return (kind, shapes, want_lp, greedy, n_steps,
                os.environ.get("PST_FUSED_KV_WRITE") == "1", split)

    def _run(self, key: tuple, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """A step: replayed from its key's graph, or run eagerly — on CPU
        tensors, and on the first use of a key on the card, which then
        captures the key (the eager run also loads what the kernels load
        lazily, outside the capture). A capture or replay error raises."""
        rec = self._graphs.get(key)
        if rec is not None:
            rec.graph.replay()
            for c, d in zip(_launch_counters(), rec.launches):
                for k, n in d.items():
                    c[k] += n
            self.graph_counts["replayed"] += 1
            return rec.out
        self.graph_counts["eager"] += 1
        if self._graph_cls is None:
            return fn()
        before = _counts_now()
        with on_stream(self._capture_stream):
            out = fn()
        self._graphs[key] = self._capture(fn, _counts_since(before))
        return out

    def _capture(self, fn: Callable[[], torch.Tensor],
                 launches: List[Dict[str, int]]) -> _Graph:
        graph = self._graph_cls()
        before = _counts_now()
        reserved = self._reserved_bytes()
        try:
            with on_stream(self._capture_stream):
                out = capture(graph, fn, self._pool)
            held = _counts_since(before)
        finally:
            # Capturing launches nothing: only replays count.
            for c, b in zip(_launch_counters(), before):
                c.update(b)
        if held != launches:
            raise RuntimeError(f"a captured step holds launches {held}, its "
                               f"eager run made {launches}")
        self.graph_pool_bytes += self._reserved_bytes() - reserved
        self.graph_counts["captured"] += 1
        return _Graph(graph, out, launches)

    def _reserved_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.memory_reserved(self.device)

    def _forward(self, dev, tokens, positions, write_idx, kv_lens, last_idx,
                 all_logits=False, split=False):
        """The model's forward over this rank's rows, its groups and
        stage; after a split step the replicas share its K/V rows."""
        logits, self.kv_cache = self.model.forward(
            self.params, tokens, positions, write_idx, dev["block_tables"],
            kv_lens, last_idx, self.kv_cache, all_logits=all_logits,
            attn_impl=self.cfg.model_attn_impl, moe_impl=self.moe_impl,
            lora_idx=dev.get("lora_idx"), lora_scale=dev.get("lora_scale"),
            tp_group=self.tp_group, pp_group=self.pp_group,
            pp_stage=self.stage, ep_group=self.ep_group,
        )
        if split:
            share_kv_writes(self.kv_cache, write_idx, self.dp_group)
        return logits

    def forward_logits(self, batch: Dict[str, np.ndarray],
                       all_logits: bool = False) -> torch.Tensor:
        """The fp32 logits of one forward over ``batch`` (a prefill step's
        ``tokens``, ``positions``, ``write_idx``, ``block_tables``,
        ``kv_lens`` and ``last_idx`` int32 arrays), its K/V written to
        the cache: uncaptured and unsampled, the teacher-forced scoring
        that holds a rank layout against one rank. Mirrored as
        ``forward``."""
        with self._mirror("forward", batch, all_logits):
            mine, split = self._my_rows(batch)
            dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                   for k, v in mine.items()}
            return self._all_rows(self._forward(
                dev, dev["tokens"], dev["positions"], dev["write_idx"],
                dev["kv_lens"], dev["last_idx"], all_logits=all_logits,
                split=split), split)

    def _step(self, batch: Dict[str, np.ndarray], want_lp: bool,
              greedy: bool, kind: str = "step") -> torch.Tensor:
        """One step on the device; mirrored as ``kind`` (``step``, or
        ``step_nofetch`` for a prefill whose rows nobody reads)."""
        with self._mirror(kind, batch, want_lp, greedy):
            mine, split = self._my_rows(batch)
            dev = self._put(mine)
            out = self._run(self._key("step", dev, want_lp, greedy, 1, split),
                            lambda: self.eager_step(dev, want_lp, greedy,
                                                    split))
            self._note_rows(out)
        return out

    def eager_step(self, dev: Dict[str, torch.Tensor], want_lp: bool,
                   greedy: bool, split: bool = False) -> torch.Tensor:
        """The forward and the sampler of one step on the inputs ``dev``
        (``_put``'s views), run eagerly: what a step's graph captures.
        ``split``: ``dev`` holds this replica's rows of a split batch,
        whose sampled rows are gathered over ``dp``."""
        logits = self._forward(
            dev, dev["tokens"], dev["positions"], dev["write_idx"],
            dev["kv_lens"], dev["last_idx"], split=split,
        )
        if "penalty_prompt" in dev:
            logits = apply_penalties(
                logits, dev["penalty_prompt"], dev["penalty_output"],
                dev["presence"], dev["frequency"], dev["repetition"],
            )
        if "bias_ids" in dev:
            logits = apply_logit_bias(logits, dev["bias_ids"], dev["bias_vals"])
        if "allowed_ids" in dev:
            logits = apply_allowed_mask(
                logits, dev["allowed_ids"], dev["allow_free"]
            )
        return self._all_rows(sample_tokens_packed(
            logits, dev["temps"], dev["top_ps"], dev["top_ks"], dev["min_ps"],
            dev["seeds"], with_logprobs=want_lp, greedy_only=greedy,
        ), split)

    def _spec_verify(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        with self._mirror("spec_verify", batch):
            mine, split = self._my_rows(batch)
            dev = self._put(mine)
            K = dev["tokens"].shape[1] - 1
            out = self._run(
                self._key("spec_verify", dev, False, False, K, split),
                lambda: self.eager_spec_verify(dev, split))
            self._note_rows(out)
        return out

    def eager_spec_verify(self, dev: Dict[str, torch.Tensor],
                          split: bool = False) -> torch.Tensor:
        """The verify step on ``_put``'s views, run eagerly (what its graph
        captures): logits of all K+1 positions, ``logit_bias`` at every
        position (a biased greedy row's accept chain follows the biased
        argmax), the guided mask at position 0 only (guided rows carry no
        drafts). Returns int32 ``[Bb, K+2]``: the K+1 argmax ids, then
        position 0's sampled token (every replica's rows, where
        ``split``)."""
        logits = self._forward(
            dev, dev["tokens"], dev["positions"], dev["write_idx"],
            dev["kv_lens"], dev["last_idx"], all_logits=True, split=split,
        )  # [Bb, K+1, V] float32
        B, T, V = logits.shape
        if "bias_ids" in dev:
            logits = apply_logit_bias(
                logits.reshape(B * T, V),
                dev["bias_ids"].repeat_interleave(T, 0),
                dev["bias_vals"].repeat_interleave(T, 0)).view(B, T, V)
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        logits0 = logits[:, 0]
        if "allowed_ids" in dev:
            logits0 = apply_allowed_mask(logits0, dev["allowed_ids"],
                                         dev["allow_free"])
        sampled0 = sample_tokens_packed(
            logits0, dev["temps"], dev["top_ps"], dev["top_ks"],
            dev["min_ps"], dev["seeds"])[:, 0].to(torch.int32)
        return self._all_rows(torch.cat([ids, sampled0[:, None]], dim=1),
                              split)

    def _multi_step(self, batch: Dict[str, np.ndarray], n_steps: int,
                    want_lp: bool, greedy: bool) -> Dict[str, torch.Tensor]:
        with self._mirror("multi_step", batch, n_steps, want_lp, greedy):
            mine, split = self._my_rows(batch)
            dev = self._put(mine)
            out = self._run(
                self._key("burst", dev, want_lp, greedy, n_steps, split),
                lambda: self.eager_multi_step(dev, n_steps, want_lp, greedy,
                                              split))
            self._note_rows(out["rows"])
        return out

    def eager_multi_step(self, dev: Dict[str, torch.Tensor], n_steps: int,
                         want_lp: bool, greedy: bool, split: bool = False
                         ) -> Dict[str, torch.Tensor]:
        """Decode ``n_steps`` tokens per sequence without a host round trip:
        each sampled token, its position, its page write slot and the seed
        offset are derived on the device and feed the next forward (the
        JAX package runs the same chain inside one ``lax.scan``). Run
        eagerly on ``_put``'s views, which it leaves as they were.

        Returns the packed rows [B, n, W] under ``"rows"`` and the carry a
        continuation feeds back under the input names it replaces: the
        next ``tokens`` and ``positions``, the ``seeds`` advanced by n (the
        JAX ``seed_off``; the draw masks each seed to 32 bits, as JAX's
        uint32 sum wraps) and, with penalties, ``pen_counts``. Where
        ``split``, the rows are every replica's (gathered over ``dp``) and
        the carry this replica's own."""
        bs = self.cfg.block_size
        tables = dev["block_tables"]
        active = dev["kv_lens"] > 0  # padding rows never write
        tokens = dev["tokens"].to(torch.int32)
        positions = dev["positions"].to(torch.int32)
        with_pen = "penalty_seen" in dev
        pen_counts = dev["pen_counts"].clone() if with_pen else None
        zeros = torch.zeros_like(positions)
        rows = []
        for i in range(n_steps):
            blk = torch.gather(tables, 1, (positions // bs)[:, None].long())[:, 0]
            flat = torch.where(
                active, blk * bs + positions % bs,
                torch.full_like(positions, self._drop_slot),
            )
            logits = self._forward(
                dev, tokens[:, None], positions[:, None], flat[:, None],
                positions + 1,  # kv valid through the just-written slot
                zeros, split=split,
            )
            if with_pen:
                logits = apply_penalties_counts(
                    logits, dev["penalty_seen"], pen_counts, dev["presence"],
                    dev["frequency"], dev["repetition"],
                )
            if "bias_ids" in dev:
                logits = apply_logit_bias(logits, dev["bias_ids"], dev["bias_vals"])
            packed = sample_tokens_packed(
                logits, dev["temps"], dev["top_ps"], dev["top_ks"],
                dev["min_ps"], dev["seeds"] + i, with_logprobs=want_lp,
                greedy_only=greedy,
            )
            tokens = packed[:, 0].to(torch.int32)
            if with_pen:
                pen_counts[torch.arange(len(tokens), device=self.device),
                           tokens.long()] += active.float()
            positions = positions + 1
            rows.append(packed)
        out = {"rows": self._all_rows(torch.stack(rows, dim=1),  # [B, n, W]
                                      split),
               "tokens": tokens, "positions": positions,
               "seeds": dev["seeds"] + n_steps}
        if with_pen:
            out["pen_counts"] = pen_counts
        return out

    def _dense_penalties(
        self, seqs: List[Sequence], batch: Dict[str, np.ndarray]
    ) -> None:
        """Dense penalty state for a burst, in place of the id arrays:
        ``penalty_seen`` [Bb, V] and the [Bb, V] output-token counts
        ``pen_counts``, which advance on the device step by step."""
        Bb = batch["kv_lens"].shape[0]
        V = self.model_cfg.vocab_size
        seen = np.zeros((Bb, V), bool)
        counts = np.zeros((Bb, V), np.float32)
        for i, s in enumerate(seqs):
            ids = np.asarray(s.prompt_token_ids, np.int64)
            seen[i, ids[(ids >= 0) & (ids < V)]] = True
            if s.output_token_ids:
                out = np.asarray(s.output_token_ids, np.int64)
                uniq, cnt = np.unique(
                    out[(out >= 0) & (out < V)], return_counts=True
                )
                counts[i, uniq] = cnt
        batch.pop("penalty_prompt", None)
        batch.pop("penalty_output", None)
        batch["penalty_seen"] = seen
        batch["pen_counts"] = counts

    def _warmup_batch(self, bucket) -> Dict[str, np.ndarray]:
        """The all-padding batch of a lattice bucket, with the names,
        shapes and dtypes live traffic gives it and neutral sampling and
        penalty values."""
        B, W = bucket.rows, bucket.width

        def zeros(*shape):
            return np.zeros(shape, np.int32)

        if bucket.kind == "decode_burst":
            batch = {"tokens": zeros(B), "positions": zeros(B),
                     "block_tables": zeros(B, W), "kv_lens": zeros(B)}
        else:
            T = _step_tokens(bucket)
            batch = {"tokens": zeros(B, T), "positions": zeros(B, T),
                     "write_idx": np.full((B, T), self._drop_slot, np.int32),
                     "block_tables": zeros(B, W), "kv_lens": zeros(B),
                     "last_idx": zeros(B)}
        batch.update(self._sampling_arrays([], B))
        if bucket.penalized:
            V = self.model_cfg.vocab_size
            batch.update(
                penalty_seen=np.zeros((B, V), bool),
                presence=np.zeros(B, np.float32),
                frequency=np.zeros(B, np.float32),
                repetition=np.ones(B, np.float32),
                pen_counts=np.zeros((B, V), np.float32),
            )
        return batch

    # ------------------------------------------------------------------
    # Batch construction (host side, numpy) — the JAX runner's contract
    # ------------------------------------------------------------------

    def _table_row(self, seq: Sequence, width: int) -> np.ndarray:
        row = np.zeros(width, np.int32)
        n = min(len(seq.block_ids), width)
        row[:n] = seq.block_ids[:n]
        return row

    def _row_bucket(self, B: int) -> int:
        """Decode/verify batch-row bucket: pow2, floored by ``dp`` (so
        every replica gets rows) and the compile-stability floor."""
        Bb = _pow2(B, cap=_pow2(self.cfg.max_num_seqs))
        return max(Bb, B, self.dp, self.cfg.min_decode_bucket)

    def _table_bucket(self, seqs: List[Sequence]) -> int:
        W = max(max(len(s.block_ids) for s in seqs), 1)
        return max(
            _pow2(W, cap=_pow2(self.max_table_width)),
            min(_MIN_TABLE_BUCKET, _pow2(self.max_table_width)),
        )

    def _decode_rows(self, seqs: List[Sequence]) -> int:
        """A decode batch's row bucket: ``_row_bucket`` of its rows when a
        row joins the batch, then kept while rows only leave it (finish,
        abort, preemption). A row's rounding follows the bucket (the
        split-KV decode plans its splits by it; a GEMM's algorithm may
        follow its row count), and a pipelined burst keeps the bucket it
        was dispatched at until it drains: a bucket that shrank as rows
        finished would round the rows left by when the pipeline engaged
        (ROADMAP fault 3.9). The JAX runner buckets each step by its own
        rows."""
        now = frozenset(map(id, seqs))
        if not now <= self._decode_cohort[1]:
            # The cohort's sequences are kept alive with it, so none of
            # its ids is reused by a new sequence.
            self._decode_cohort = (list(seqs), now,
                                   self._row_bucket(len(seqs)))
        return self._decode_cohort[2]

    def _decode_batch(
        self, seqs: List[Sequence], multi: bool = False
    ) -> Dict[str, np.ndarray]:
        B = len(seqs)
        Bb = self._decode_rows(seqs)
        Wb = self._table_bucket(seqs)
        bs = self.cfg.block_size

        shape = (Bb,) if multi else (Bb, 1)
        tokens = np.zeros(shape, np.int32)
        positions = np.zeros(shape, np.int32)
        tables = np.zeros((Bb, Wb), np.int32)
        kv_lens = np.zeros(Bb, np.int32)
        if not multi:
            write_idx = np.full((Bb, 1), self._drop_slot, np.int32)
            last_idx = np.zeros(Bb, np.int32)
        for i, s in enumerate(seqs):
            pos = s.num_tokens - 1
            tokens[i, ...] = s.all_token_ids[-1]
            positions[i, ...] = pos
            tables[i] = self._table_row(s, Wb)
            kv_lens[i] = s.num_tokens
            if not multi:
                write_idx[i, 0] = s.block_ids[pos // bs] * bs + pos % bs
        batch = {
            "tokens": tokens,
            "positions": positions,
            "block_tables": tables,
            "kv_lens": kv_lens,
        }
        if not multi:
            batch["write_idx"] = write_idx
            batch["last_idx"] = last_idx
        batch.update(self._sampling_arrays(seqs, Bb))
        return batch

    def _spec_batch(self, seqs: List[Sequence], drafts: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        """The verify step's batch (the JAX runner's): tokens [Bb, K+1] —
        the last committed token, then the drafts — at positions p0 + j
        (p0 = num_tokens - 1); a position writes its slot only where a
        page covers it (a draftless row near its last page may lack the
        last K), else the drop slot; ``kv_lens = min(num_tokens + K,
        covered)``. Padding rows have ``kv_len`` 0."""
        B, K = drafts.shape
        T = K + 1
        Bb = self._row_bucket(B)
        Wb = self._table_bucket(seqs)
        bs = self.cfg.block_size
        tokens = np.zeros((Bb, T), np.int32)
        positions = np.zeros((Bb, T), np.int32)
        write_idx = np.full((Bb, T), self._drop_slot, np.int32)
        tables = np.zeros((Bb, Wb), np.int32)
        kv_lens = np.zeros(Bb, np.int32)
        for i, s in enumerate(seqs):
            p0 = s.num_tokens - 1
            tokens[i, 0] = (s.output_token_ids[-1] if s.output_token_ids
                            else s.prompt_token_ids[-1])
            tokens[i, 1:] = drafts[i]
            positions[i] = p0 + np.arange(T, dtype=np.int32)
            covered = len(s.block_ids) * bs
            for j in range(T):
                pos = p0 + j
                if pos < covered:
                    write_idx[i, j] = s.block_ids[pos // bs] * bs + pos % bs
            tables[i] = self._table_row(s, Wb)
            kv_lens[i] = min(s.num_tokens + K, covered)
        batch = {
            "tokens": tokens,
            "positions": positions,
            "write_idx": write_idx,
            "block_tables": tables,
            "kv_lens": kv_lens,
            "last_idx": np.zeros(Bb, np.int32),
        }
        # Full sampling arrays: position 0 is sampled as a plain decode
        # step samples it (penalized rows never reach a verify step).
        batch.update(self._sampling_arrays(seqs, Bb))
        return batch

    def _prefill_batch(self, items: List[PrefillItem]) -> Dict[str, np.ndarray]:
        B = len(items)
        Bb = _pow2(B)
        chunk_max = max(it.end - it.start for it in items)
        Tb = _pow2(chunk_max, cap=_pow2(self.cfg.max_prefill_tokens))
        Tb = max(Tb, chunk_max)
        Wb = self._table_bucket([it.seq for it in items])
        bs = self.cfg.block_size

        tokens = np.zeros((Bb, Tb), np.int32)
        positions = np.zeros((Bb, Tb), np.int32)
        write_idx = np.full((Bb, Tb), self._drop_slot, np.int32)
        tables = np.zeros((Bb, Wb), np.int32)
        kv_lens = np.zeros(Bb, np.int32)
        last_idx = np.zeros(Bb, np.int32)
        for i, it in enumerate(items):
            s, start, end = it.seq, it.start, it.end
            chunk = end - start
            ids = s.all_token_ids
            pos = np.arange(start, end)
            blocks = np.asarray(s.block_ids, np.int64)
            tokens[i, :chunk] = ids[start:end]
            positions[i, :chunk] = pos
            write_idx[i, :chunk] = blocks[pos // bs] * bs + pos % bs
            positions[i, chunk:] = max(end - 1, 0)
            tables[i] = self._table_row(s, Wb)
            kv_lens[i] = end
            last_idx[i] = chunk - 1
        batch = {
            "tokens": tokens,
            "positions": positions,
            "write_idx": write_idx,
            "block_tables": tables,
            "kv_lens": kv_lens,
            "last_idx": last_idx,
        }
        batch.update(self._sampling_arrays([it.seq for it in items], Bb))
        return batch

    def _sampling_arrays(
        self, seqs: List[Sequence], B: int
    ) -> Dict[str, np.ndarray]:
        temps = np.zeros(B, np.float32)
        top_ps = np.ones(B, np.float32)
        top_ks = np.zeros(B, np.int32)
        min_ps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int64)
        for i, s in enumerate(seqs):
            sp = s.sampling
            temps[i] = sp.temperature
            top_ps[i] = sp.top_p
            top_ks[i] = sp.top_k
            min_ps[i] = sp.min_p
            seeds[i] = _seed_for(s)
        out = {
            "temps": temps,
            "top_ps": top_ps,
            "top_ks": top_ks,
            "min_ps": min_ps,
            "seeds": seeds,
        }
        if self.cfg.enable_lora:
            # In every batch, warmup's included: padding rows (and a held
            # decode bucket's) take slot 0.
            lora_idx = np.zeros(B, np.int32)
            lora_scale = np.zeros(B, np.float32)
            for i, s in enumerate(seqs):
                lora_idx[i] = s.lora_idx
                lora_scale[i] = s.lora_scale
            out["lora_idx"] = lora_idx
            out["lora_scale"] = lora_scale
        if any(s.sampling.has_penalties for s in seqs):
            out.update(self._penalty_arrays(seqs, B))
        if any(s.sampling.guided_choice for s in seqs):
            V = self.model_cfg.vocab_size  # pad id: dropped
            per_row = [
                s.sampling.guided_allowed(
                    s.output_token_ids, self.model_cfg.eos_token_ids
                )
                for s in seqs
            ]
            Na = _pow2(max(max((len(a) for a in per_row if a), default=1), 1))
            allowed_ids = np.full((B, Na), V, np.int32)
            allow_free = np.ones(B, bool)
            for i, allowed in enumerate(per_row):
                if allowed is None:
                    continue
                allow_free[i] = False
                for j, tid in enumerate(allowed[:Na]):
                    allowed_ids[i, j] = tid
            out["allowed_ids"] = allowed_ids
            out["allow_free"] = allow_free
        if any(s.sampling.logit_bias for s in seqs):
            V = self.model_cfg.vocab_size  # pad id: dropped
            Nb = _pow2(max(max(len(s.sampling.logit_bias) for s in seqs), 1))
            bias_ids = np.full((B, Nb), V, np.int32)
            bias_vals = np.zeros((B, Nb), np.float32)
            for i, s in enumerate(seqs):
                for j, (tid, bv) in enumerate(s.sampling.logit_bias[:Nb]):
                    if 0 <= tid < V:
                        bias_ids[i, j] = tid
                        bias_vals[i, j] = bv
            out["bias_ids"] = bias_ids
            out["bias_vals"] = bias_vals
        return out

    def _penalty_arrays(
        self, seqs: List[Sequence], B: int
    ) -> Dict[str, np.ndarray]:
        V = self.model_cfg.vocab_size  # pad value: dropped
        Pp = _pow2(max(max(s.num_prompt_tokens for s in seqs), 1))
        Po = _pow2(max(max(len(s.output_token_ids) for s in seqs), 1))
        prompt = np.full((B, Pp), V, np.int32)
        output = np.full((B, Po), V, np.int32)
        presence = np.zeros(B, np.float32)
        frequency = np.zeros(B, np.float32)
        repetition = np.ones(B, np.float32)
        for i, s in enumerate(seqs):
            sp = s.sampling
            prompt[i, : s.num_prompt_tokens] = s.prompt_token_ids
            output[i, : len(s.output_token_ids)] = s.output_token_ids
            presence[i] = sp.presence_penalty
            frequency[i] = sp.frequency_penalty
            repetition[i] = sp.repetition_penalty
        return {
            "penalty_prompt": prompt,
            "penalty_output": output,
            "presence": presence,
            "frequency": frequency,
            "repetition": repetition,
        }


def _step_tokens(bucket) -> int:
    """Query tokens a row of a lattice bucket's step carries: a prefill
    chunk's, K+1 for a verify step, 1 for decode."""
    if bucket.kind == "prefill":
        return bucket.tokens
    if bucket.kind == "spec_verify":
        return bucket.tokens + 1
    return 1


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to_device(tree, device):
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
