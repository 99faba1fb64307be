"""Engine configuration for the PyTorch engine.

The fields of the JAX package's ``EngineConfig`` that this slice reads,
plus ``device``. Every engine runs on the
GPU (``device="cuda"``) unless the caller asks for the CPU.

Of the JAX package's five parallel sizes the tensor, pipeline and data
sizes may exceed 1 (``dp x pp x tp`` ranks, one process each,
``engine/multihost.py``); a sequence or expert size above 1 is refused
here, at start (ROADMAP.md queue 1, items 15.iii and 15.iv).
:func:`check_parallel` holds the model to the tensor-parallel split and
its layers to the pipeline's stages, as the JAX runner does at start.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.llama import MOE_IMPLS, LlamaConfig, check_pp, check_tp


@dataclasses.dataclass
class EngineConfig:
    model: str = "tiny-llama-debug"
    tokenizer: Optional[str] = None  # local HF dir; default: byte tokenizer
    served_model_name: Optional[str] = None
    max_model_len: int = 4096
    block_size: int = 32
    num_kv_blocks: Optional[int] = None  # None: size from device memory
    hbm_utilization: float = 0.9  # --gpu-memory-utilization
    max_num_seqs: int = 64
    max_prefill_tokens: int = 2048
    # Parallelism, one process a rank over dp x pp x tp: tensor ranks
    # hold a Megatron shard of the weights and their kv heads of the
    # cache; pipeline ranks a stage of the layers; data ranks a replica
    # each, a batch's rows split among them. Sequence and expert sizes
    # are refused above 1 (ROADMAP.md queue 1, items 15.iii and 15.iv).
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    sequence_parallel_size: int = 1
    expert_parallel_size: int = 1
    # None (the model dtype), the model dtype, or "float8_e4m3fn" (half
    # the bytes of a bf16 page; the kernels up-convert K and V exactly).
    kv_cache_dtype: Optional[str] = None
    # Weight-only quantization: None, "int8" (per channel) or "int4"
    # (group-wise; embed/lm_head stay int8).
    quantization: Optional[str] = None
    # Paged attention: "auto" (the hand-written CUDA kernels on the card,
    # the gather path on the CPU), "gather" (the plain PyTorch path) or
    # "pallas" (the JAX spelling of the kernels; refused on the CPU).
    attn_impl: str = "auto"
    # Mixture-of-experts form, by its JAX name: "auto", "ragged" or
    # "dense". All three run models/llama.py::_moe_mlp's one body (every
    # expert on every token, then the one-hot combine), which gives
    # either JAX form's result.
    moe_impl: str = "auto"
    enable_prefix_caching: bool = True
    # Decode tokens generated per engine step (a device-side loop that
    # chains sampled tokens without a host round trip). 1 = per token.
    num_decode_steps: int = 1
    # Adaptive burst depth: when nothing waits, at least
    # ``adaptive_decode_min_running`` sequences run and no request arrived
    # for ``adaptive_decode_quiet_s``, decode bursts deepen to this many
    # steps. Gated on past arrivals only, so a live stream keeps bursts at
    # num_decode_steps. 0 = off.
    adaptive_decode_steps: int = 0
    adaptive_decode_quiet_s: float = 0.5
    adaptive_decode_min_running: int = 0
    # Floor for the decode-batch row bucket.
    min_decode_bucket: int = 1
    # Speculative decoding via n-gram prompt lookup (engine/spec.py): draft
    # up to this many tokens per greedy sequence per step and verify them
    # in one forward pass. 0 = off. Sampled (temperature>0) rows ride the
    # verify step undrafted.
    speculative_ngram: int = 0
    ngram_min: int = 1  # shortest suffix n-gram to match
    ngram_max: int = 3  # longest suffix n-gram to match
    # Cap the prompt-lookup scan to the last N tokens (0 = whole history).
    ngram_lookback: int = 8192
    # Pipelined decode: keep one burst in flight and fetch its rows while
    # the next burst runs, unconditionally (batch serving: a new arrival's
    # prefill may wait behind one in-flight burst).
    async_decode: bool = False
    # The arrival-gated form of pipelining: a pipeline starts only under
    # the adaptive depth's three gates (nothing waiting, the running
    # floor met, the arrival stream quiet), so live traffic keeps the
    # synchronous loop's latency and saturated decode gets the overlap.
    overlap_decode: bool = True
    # Step capture before /ready flips (engine/precompile.py): "full"
    # captures the whole padded shape-bucket lattice, "lazy" the core set
    # the first requests hit; "off" captures each bucket on first use.
    warmup: str = "off"  # off | lazy | full
    # Cap on buckets captured at warmup (0 = the entire lattice). Buckets
    # are walked most-likely-first, so a budget keeps the hot shapes.
    warmup_bucket_budget: int = 0
    # LoRA serving (engine/lora.py): adapters loaded into a stacked bank
    # of max_loras slots of rank up to max_lora_rank, any mix of them in
    # one step; an adapter named at load without a path is read from
    # lora_dir/<name>.
    enable_lora: bool = False
    max_loras: int = 8
    max_lora_rank: int = 16
    lora_dir: str = "/adapters"
    # Live-sequence KV swap (engine/swap.py): preemption parks a
    # sequence's KV instead of recomputing it. Committed pages stay
    # addressed in place; only the uncommitted tail goes to a host stash.
    kv_swap: bool = True
    # Rotate a running sequence out after this many decoded tokens when
    # parked or queued work exists (0 = swap only under page pressure).
    swap_quantum_tokens: int = 256
    # Host budget for stashed tail pages, in KV pages.
    swap_stash_blocks: int = 4096
    # KV tiering (engine/cache_tiering.py): host-memory pages an evicted
    # page spills into (0: no host tier unless a consumer needs staging).
    cpu_offload_blocks: int = 0
    # One kvserver base URL, or a comma-separated shard list (the
    # replicated ShardedKVClient over the consistent-hash ring).
    remote_kv_url: Optional[str] = None
    # Replicas a block or manifest on the kvserver ring (clamped to the
    # shard count).
    kv_replication: int = 2
    # Cache-controller registration (KV-aware routing); engine_url is the
    # URL this engine reports itself as.
    cache_controller_url: Optional[str] = None
    engine_url: Optional[str] = None
    # Disaggregated prefill role: a producer publishes each prefill's
    # pages to the remote store under the router's transfer id (and
    # pushes a finished request's pages); a consumer prefetches them
    # before admission.
    kv_role: str = "none"  # none | producer | consumer | both
    # Consumer prefetch: most pages a batched GET while following a
    # manifest, and the seconds it waits for the completion marker before
    # the fused fallback (recompute the prefill here).
    kv_prefetch_depth: int = 64
    kv_transfer_timeout_s: float = 10.0
    # Honor the router-propagated X-PST-Deadline-Ms budget: 504 expired
    # work at admission, drop expired queued sequences before a prefill
    # step, and stop decoding expired running ones.
    deadline_shedding: bool = True
    # Honor the router-stamped X-PST-Tenant / X-PST-Tenant-Class headers:
    # admit weighted-fair across tenants with strict tier priority, and
    # preempt batch-tier sequences first. Untagged traffic is plain FIFO.
    tenant_fairness: bool = True
    # Flight recorder (obs/flight.py): the ring's capacity in device
    # steps, served at GET /debug/flight and snapshotted on tail outliers,
    # captures, SIGTERM and a failed step. 0 records nothing.
    flight_buffer: int = 512
    # Write every retained snapshot under this directory as well (bounded,
    # oldest first out) and read them back after a restart. None: memory
    # only.
    flight_snapshot_dir: Optional[str] = None
    # Per-request cost attribution: each request's share of the device
    # steps it rode (prefill by tokens, decode by live rows), its KV
    # page-seconds and queue wait, on the X-PST-Cost header, the usage
    # extension and pst_request_device_seconds / pst_tenant_device_seconds.
    cost_attribution: bool = True
    # Export pst_engine_startup_seconds (the load, shard, warmup and
    # precompile phases); --no-startup-phases leaves the family empty.
    startup_phases: bool = True
    # The kernel library's compile cache (ops/_build.py): built into and
    # loaded from <dir>/<key>, so a restart on the same volume loads it
    # instead of building it. None: the checkout's build/torch_kernels/.
    compile_cache_dir: Optional[str] = None
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.quantization not in (None, "int8", "int4"):
            raise ValueError(
                f"unsupported quantization {self.quantization!r} (int8 or int4)"
            )
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r} "
                             f"({'|'.join(ATTN_IMPLS)})")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {self.moe_impl!r} "
                             f"({'|'.join(MOE_IMPLS)})")
        for axis in ("tensor", "pipeline", "data"):
            size = getattr(self, f"{axis}_parallel_size")
            if size < 1:
                raise ValueError(f"{axis}_parallel_size must be >= 1, got "
                                 f"{size}")
        for axis, item in UNSERVED_AXES.items():
            size = getattr(self, f"{axis}_parallel_size")
            if size != 1:
                raise ValueError(
                    f"{axis}_parallel_size={size}: the PyTorch engine "
                    "serves the tensor, pipeline and data axes (the "
                    f"{axis} axis is queue 1, item {item} of ROADMAP.md); "
                    "pass 1")

    @property
    def num_ranks(self) -> int:
        """The engine's ranks, one process each: ``dp x pp x tp``."""
        return (self.data_parallel_size * self.pipeline_parallel_size
                * self.tensor_parallel_size)

    @property
    def model_attn_impl(self) -> str:
        """``Llama.forward``'s ``attn_impl``: ``pallas`` names the CUDA
        kernels, the port's ``cuda``."""
        return ATTN_IMPLS[self.attn_impl]


# The parallel axes the port refuses above 1, with their ROADMAP.md item.
UNSERVED_AXES = {"sequence": "15.iii", "expert": "15.iv"}

# The JAX engine's attention impls and the port's name for each.
ATTN_IMPLS = {"auto": "auto", "gather": "gather", "pallas": "cuda"}


def kv_cache_torch_dtype(cfg: EngineConfig,
                         model_cfg: LlamaConfig) -> torch.dtype:
    """The cache's element type: the model's, or e4m3. Any other
    ``kv_cache_dtype`` raises."""
    name = cfg.kv_cache_dtype or model_cfg.dtype
    if name not in (model_cfg.dtype, "float8_e4m3fn"):
        raise ValueError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r}: the cache holds the "
            f"model dtype ({model_cfg.dtype}) or float8_e4m3fn")
    return getattr(torch, name)


def resolve_device(name: str) -> torch.device:
    """The engine's device. Asking for CUDA without a GPU raises: the
    engine never carries on silently on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA GPU is available "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev


def check_parallel(cfg: EngineConfig, model_cfg: LlamaConfig) -> None:
    """The JAX runner's start-time checks of the parallel layout: raise
    ``ValueError`` unless the model splits over ``tensor_parallel_size``
    ranks (whole heads and FFN slices, whole int4 groups a rank) and its
    layers over ``pipeline_parallel_size`` stages."""
    check_tp(model_cfg, cfg.tensor_parallel_size, cfg.quantization)
    check_pp(model_cfg, cfg.pipeline_parallel_size)


def resolve_num_kv_blocks(
    cfg: EngineConfig, model_cfg: LlamaConfig, device: torch.device,
    share: int = 1,
) -> int:
    """Page count from the device-memory budget (the
    ``--gpu-memory-utilization`` analogue): what is left of
    ``total * hbm_utilization`` once everything already allocated (the
    weights included) is taken out, per ``torch.cuda.mem_get_info``,
    divided among the ``share`` ranks that hold a cache on the device.

    bytes/page = 2 (K+V) * L * bs * KH * hd * itemsize, the itemsize of
    the cache's element type (1 for e4m3); ``model_cfg`` is one rank's
    geometry (``rank_local_config``: its ``KH/tp`` kv heads and its
    stage's ``L/pp`` layers)."""
    if cfg.num_kv_blocks is not None:
        return cfg.num_kv_blocks
    itemsize = kv_cache_torch_dtype(cfg, model_cfg).itemsize
    page_bytes = (
        2 * model_cfg.num_layers * cfg.block_size * model_cfg.num_kv_heads
        * model_cfg.head_dim * itemsize
    )
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        budget = (int(total * cfg.hbm_utilization) - (total - free)) // share
    else:
        budget = 512 * 1024 * 1024  # CPU: keep the cache modest
    n = max(budget // page_bytes, cfg.max_num_seqs * 2)
    # Never fewer pages than one full-length sequence needs.
    n = max(n, -(-cfg.max_model_len // cfg.block_size) + 1)
    return int(n)
