"""LLMEngine: the synchronous serving core (add_request / step / outputs).

The port of the JAX package's ``engine/engine.py`` for the main serving
path: one ``step()`` is one scheduler decision, one device step (a batch
of prefill chunks, or a decode burst) and the host-side bookkeeping —
detokenization, stop handling, prefix-block commitment.

Pipelined decode (``overlap_decode``, the default, and ``async_decode``):
a step with a burst in flight dispatches the next burst and then applies
the previous one's rows, so the host's bookkeeping runs while the device
decodes. ``overlap_decode`` starts a pipeline only under the adaptive
depth's arrival gates (``_arrival_safe``); ``adaptive_decode_steps``
deepens bursts under the same gates. A sequence that finishes or is
aborted while a burst still writes through its pages is detached, and
its pages are released when the burst drains.

The JAX engine's default scheduling (``engine/scheduler.py``): KV swap
(``kv_swap``, through the runner's page I/O, ``engine/swap.py``),
deadline shedding (a request's ``deadline``; a shed ends with
``finish_reason="deadline"``) and tenant-fair admission (its ``tenant``
and ``tenant_class``).

``stats()`` feeds the server's ``/metrics``; the runner's ``telemetry``
records every device step, and forwards each live one to the engine's
flight recorder (``flight_buffer``, ``obs/flight.py``), whose records
carry the scheduler's depths. ``clear_kv_state`` (sleep level 2) forgets
every page the prefix map points at.

Diagnostics on the outputs, as the JAX engine's: each carries the
request's queue wait and prefill time (``queue_time``, ``prefill_time``;
the finish also ``decode_time``), and the outputs of a step that
captured a graph key carry it as ``compile_events``. With
``cost_attribution`` a request's account closes exactly once, on its
finish, abort or deadline shed, before its pages are released; the
finished output carries it as ``cost``.

KV tiering and the disaggregated handoff (``engine/cache_tiering.py``,
``engine/kv_handoff.py``): with ``cpu_offload_blocks`` or
``remote_kv_url`` the allocator is a ``TieredAllocator`` (evicted pages
spill to host memory and the remote store, prefix hits fault them back
up); a producer (``kv_role``) publishes each prefill chunk's pages under
the router's transfer id and pushes a finished request's unpublished
pages, a consumer's server prefetches them before admission. Committed
256-token chunks are kept in ``resident_chunk_hashes`` (with a TTL and a
cap) for the cache controller's registration.

N-gram speculative decoding (``speculative_ngram``, ``engine/spec.py``):
a decode pass whose greedy rows find prompt-lookup drafts scores each
row's last token and its K drafts in one verify step
(``ModelRunner.execute_spec_verify``) and commits every row's accepted
draft prefix plus the model's own next token; sampled and guided rows
ride the step undrafted, their position 0 sampled as a plain decode step
samples it. A speculative engine never pipelines (``_pipeline_ok``), as
the JAX engine's; ``async_decode`` turns speculation off.

LoRA (``enable_lora``, ``engine/lora.py``): ``load_lora`` parses a PEFT
directory into a free bank slot and writes it in place; a request's
``lora_name`` gives its rows that slot and scale and salts its prefix-hash
chain with ``xxh64(name)``, so its KV is never a hit for the base model
or another adapter. ``unload_lora`` removes the name at once and retires
the slot: it is zeroed and freed only once no live sequence holds it and
no in-flight burst read it (``_sweep_retiring_slots``, after every step).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence as Seq, Tuple, Union

import numpy as np

from ..kvcache.hashing import CHUNK_TOKENS
from ..kvcache.xxh64 import xxh64
from ..logging_utils import init_logger
from ..models.registry import get_model_config
from ..obs.flight import NULL_FLIGHT_RECORDER, FlightRecorder
from ..ops import _build
from ..ops.sampling import unpack_sampled
from .cache_tiering import TieredAllocator, create_remote_client, wait_landed
from .config import EngineConfig
from .kv_handoff import KVHandoffPrefetcher, KVHandoffPublisher
from .kv_manager import BlockAllocator
from .lora import LoadedAdapter, LoraManager
from .multihost import Ranks, start_ranks
from .runner import ModelRunner
from .scheduler import Scheduler, SchedulerConfig
from .sequence import SamplingParams, Sequence
from .spec import count_accepted, propose_ngram
from .swap import KVSwapper
from .tokenizer import get_tokenizer

logger = init_logger(__name__)


def _no_stage(stage: str, seconds: float) -> None:
    pass


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    text_delta: str = ""
    new_token_ids: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None
    num_prompt_tokens: int = 0
    num_output_tokens: int = 0
    num_cached_prompt_tokens: int = 0
    ttft: Optional[float] = None
    # The TTFT's parts (monotonic seconds): queued before the first
    # admission, first admission to first token, and on the finished
    # output first token to finish. The server lays them out as the
    # engine_queue, prefill and decode spans.
    queue_time: Optional[float] = None
    prefill_time: Optional[float] = None
    decode_time: Optional[float] = None
    # One entry per new token when SamplingParams.logprobs is set:
    # {"token_id", "logprob", "top": [(token_id, logprob), ...]}.
    logprobs: Optional[List[dict]] = None
    # The graph captures the step that produced this output absorbed
    # ({"kind", "shape_bucket", "seconds"}): `compile` events on the
    # request's trace.
    compile_events: Optional[List[dict]] = None
    # The closed cost account (finished outputs, with cost_attribution):
    # the X-PST-Cost payload.
    cost: Optional[dict] = None


class LLMEngine:
    def __init__(self, cfg: EngineConfig, params: Optional[Dict[str, Any]] = None,
                 ranks: Optional[Ranks] = None):
        """``params``: an existing parameter tree (e.g. converted from the
        JAX package's, see ``models/convert.py``); random init from
        ``cfg.seed`` when None. ``ranks``: the ``dp x pp x tp`` ranks
        (``engine/multihost.py``) to build on; with more than one rank
        (``cfg.num_ranks``) and none given the engine starts its own,
        and stops them at ``shutdown``."""
        self.cfg = cfg
        self.model_cfg = get_model_config(cfg.model)
        if cfg.compile_cache_dir:
            # Before the first kernel use (the runner's, on the card).
            path = _build.set_compile_cache_dir(cfg.compile_cache_dir)
            logger.info("kernel library compile cache: %s", path)
        self._own_ranks = ranks is None and cfg.num_ranks > 1
        self.ranks = start_ranks(cfg) if self._own_ranks else ranks
        self._shut = False
        try:
            self.runner = (
                ModelRunner(cfg, self.model_cfg, params) if self.ranks is None
                else self.ranks.build_runner(cfg, self.model_cfg, params))
        except BaseException:
            if self._own_ranks:
                self.ranks.close()
            raise
        if cfg.compile_cache_dir and self.runner.device.type == "cuda":
            # A warm restart loads the library here, a cold one builds it:
            # at start, not on the first request.
            _build.load()
        t_runner = time.perf_counter()
        # A checkpoint directory carries its own tokenizer files.
        tok_spec = cfg.tokenizer or (
            cfg.model if os.path.isdir(cfg.model) else None)
        self.tokenizer = get_tokenizer(tok_spec, self.model_cfg.vocab_size)
        # Stage durations the tiers observe (kv_fetch_host,
        # kv_fetch_remote); the server points this at its recorder.
        self.observe_stage = _no_stage
        self.allocator = self._make_allocator()
        # The streamed handoff: a producer ships each prefill chunk's
        # committed pages under the request's transfer id; a consumer's
        # prefetcher stages published pages in the host pool.
        self.kv_publisher: Optional[KVHandoffPublisher] = None
        self.kv_prefetcher: Optional[KVHandoffPrefetcher] = None
        remote = self.remote
        if remote is not None and cfg.kv_role in ("producer", "both"):
            self.kv_publisher = KVHandoffPublisher(remote)
        host_pool = getattr(self.allocator, "host_pool", None)
        if (remote is not None and host_pool is not None
                and cfg.kv_role in ("consumer", "both")):
            self.kv_prefetcher = KVHandoffPrefetcher(
                remote, host_pool, timeout_s=cfg.kv_transfer_timeout_s,
                depth=cfg.kv_prefetch_depth)
        # Chunk hashes committed here (hash -> last commit time): the
        # controller registration's claims.
        self.resident_chunk_hashes: Dict[int, float] = {}
        self.kv_published_blocks_total = 0
        self.swapper: Optional[KVSwapper] = (
            KVSwapper(self.runner, max_stash_blocks=cfg.swap_stash_blocks)
            if cfg.kv_swap else None)
        self.scheduler = Scheduler(
            SchedulerConfig(
                max_num_seqs=cfg.max_num_seqs,
                max_prefill_tokens=cfg.max_prefill_tokens,
                max_model_len=cfg.max_model_len,
                num_decode_steps=cfg.num_decode_steps,
                # A continuation writes one burst past the host's view, so
                # its pages must exist at dispatch: whenever a pipeline can
                # engage. Spec engines never pipeline (_pipeline_ok defers
                # to speculation) and reserve the verify step's K instead.
                decode_lookahead=(
                    2 if cfg.async_decode
                    or (cfg.overlap_decode and not cfg.speculative_ngram)
                    else 1),
                spec_tokens=0 if cfg.async_decode else cfg.speculative_ngram,
                swap_quantum=cfg.swap_quantum_tokens,
                deadline_shedding=cfg.deadline_shedding,
                tenant_fairness=cfg.tenant_fairness,
            ),
            self.allocator,
            swapper=self.swapper,
        )
        if cfg.async_decode and cfg.speculative_ngram:
            # Pipelined bursts win every decode step, so the spec branch
            # would never run: say so rather than reserve pages for it.
            logger.warning(
                "speculative_ngram is disabled while async_decode is on "
                "(pipelined bursts preempt the speculation path)")
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self._seqs: Dict[str, Sequence] = {}
        # Incremental detokenizer state per request:
        # emitted text + [prefix_offset, read_offset) decode window.
        self._detok: Dict[str, Dict[str, object]] = {}
        self.num_preempted_total = 0
        self.prompt_tokens_total = 0
        self.generation_tokens_total = 0
        # Pipelined bursts: the in-flight burst's members (original order,
        # finished ones included), its depth, and the sequences whose page
        # release waits for its drain.
        self._burst_seqs: List[Sequence] = []
        self._burst_n = 0
        self._burst_deferred: List[Sequence] = []
        self.lora_manager: Optional[LoraManager] = (
            LoraManager(self.model_cfg, cfg.max_loras, cfg.max_lora_rank,
                        cfg.lora_dir) if cfg.enable_lora else None)
        # Unloaded adapters' slots awaiting their last reader.
        self._retiring_slots: set = set()
        # Last arrival (the adaptive-depth and overlap gates) and the
        # bursts each mode ran.
        self._last_arrival = 0.0
        self.adaptive_deep_bursts_total = 0
        self.pipelined_bursts_total = 0
        # The flight recorder, fed by the telemetry's live steps; only a
        # live ring takes the probe.
        self.flight = (
            FlightRecorder(
                cfg.flight_buffer, snapshot_dir=cfg.flight_snapshot_dir,
                on_persist=self.telemetry.flight_snapshots_persisted.inc)
            if cfg.flight_buffer > 0 else NULL_FLIGHT_RECORDER)
        if self.flight.enabled:
            self.flight.set_probe(self._flight_probe)
        self.telemetry.attach_flight(self.flight)
        # Compile events awaiting a step that emits outputs (see step()).
        self._pending_compile_events: List[dict] = []
        # Warmup summary (engine/precompile.py): set by precompile(); the
        # server's /ready payload carries it.
        self.warmup_summary: Optional[dict] = None
        # Startup around the runner (which records load and shard):
        # tokenizer, allocator, scheduler.
        self.telemetry.record_startup_phase(
            "warmup", time.perf_counter() - t_runner)

    @property
    def telemetry(self):
        return self.runner.telemetry

    @property
    def remote(self):
        """The remote KV client (plain or sharded), or None."""
        return getattr(self.allocator, "remote", None)

    def _make_allocator(self, remote=None, host_pool=None) -> BlockAllocator:
        """The JAX engine's choice: a ``TieredAllocator`` when a host or
        remote tier is configured, else the device-only allocator. A
        consumer without ``cpu_offload_blocks`` still gets a host pool to
        stage prefetched pages in (``max(num_blocks // 2, 1024)`` pages,
        each allocated only when a page arrives). ``remote`` and
        ``host_pool`` carry existing tiers over a rebuild."""
        cfg = self.cfg
        if not (cfg.cpu_offload_blocks > 0 or cfg.remote_kv_url):
            return BlockAllocator(self.runner.num_blocks, cfg.block_size,
                                  cfg.enable_prefix_caching)
        host_blocks = cfg.cpu_offload_blocks
        if (host_blocks == 0 and cfg.remote_kv_url
                and cfg.kv_role in ("consumer", "both")):
            host_blocks = max(self.runner.num_blocks // 2, 1024)
        if remote is None and cfg.remote_kv_url:
            remote = create_remote_client(cfg.remote_kv_url,
                                          replication=cfg.kv_replication)
        return TieredAllocator(
            self.runner.num_blocks, cfg.block_size, page_io=self.runner,
            host_blocks=host_blocks, host_pool=host_pool,
            remote=remote, enable_prefix_caching=cfg.enable_prefix_caching,
            observe_stage=lambda stage, s: self.observe_stage(stage, s))

    def shutdown(self) -> None:
        """Stop the tiers' worker threads (the remote push and the
        handoff publisher); across ranks, end the
        followers' mirror (each logs its ``rank report``, as rank 0 does
        here) and stop the ranks this engine started. Idempotent."""
        if self._shut:
            return
        self._shut = True
        if self.kv_publisher is not None:
            self.kv_publisher.shutdown()
        shutdown = getattr(self.allocator, "shutdown", None)
        if shutdown is not None:
            shutdown()
        if self.ranks is not None:
            logger.info("rank report %s",
                        json.dumps(self.runner.rank_report()))
            self.runner.publisher.shutdown()
            if self._own_ranks:
                self.ranks.close()


    def rank_layout(self) -> List[Dict[str, Any]]:
        """Each rank's ``rank``, ``dp``/``pp``/``tp`` coordinates and
        device, by rank (none at one rank), from the grid and the device
        map rank 0 holds: no collective."""
        if self.ranks is None:
            return []
        ctx = self.ranks.ctx
        return [{"rank": r, "device": ctx.devices[r],
                 **{a: ctx.grid.coords(r)[a] for a in ("dp", "pp", "tp")}}
                for r in range(ctx.world_size)]

    @property
    def model_name(self) -> str:
        return self.cfg.served_model_name or self.model_cfg.name

    def _flight_probe(self) -> dict:
        """The scheduler and KV state each flight record carries. Runs on
        the step thread, right after a dispatch."""
        waiting, running, swapped, batch = self.scheduler.flight_depths()
        return {
            "waiting": waiting,
            "running": running,
            "swapped": swapped,
            "batch_tier_rows": batch,
            "kv_occupancy": self.allocator.usage,
            "preemptions": self.num_preempted_total,
        }

    def _finalize_cost(self, seq: Sequence) -> Optional[dict]:
        """Close a request's cost account, once: integrate its KV pages up
        to now, export the per-phase histogram and the tenant's meter,
        and return the X-PST-Cost payload."""
        if not self.cfg.cost_attribution:
            return None
        if seq.cost_final is None:
            now = time.monotonic()
            # Before the scheduler releases block_ids: the residency
            # since the last charge point is still this request's.
            seq.charge_kv_pages(now)
            seq.cost_final = seq.cost_snapshot(now)
            self.telemetry.record_request_cost(
                seq.tenant, seq.cost_prefill_s, seq.cost_decode_s)
        return seq.cost_final

    # ------------------------------------------------------------------
    # Requests
    # ------------------------------------------------------------------

    def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[Seq[int]] = None,
        sampling: Optional[SamplingParams] = None,
        arrival_time: Optional[float] = None,
        lora_name: Optional[str] = None,
        deadline: Optional[float] = None,
        tenant: Optional[str] = None,
        tenant_class: Optional[str] = None,
        kv_transfer: Optional[dict] = None,
    ) -> Sequence:
        """``lora_name``: a loaded adapter to serve the request under
        (ValueError when LoRA is off or the name is not loaded);
        ``deadline``: the monotonic expiry of the request's budget
        (ignored with ``deadline_shedding`` off); ``tenant`` and
        ``tenant_class`` (``"interactive"`` or ``"batch"``) order its
        admission under ``tenant_fairness``; ``kv_transfer`` is the
        router's ``{"request_id", "role"}`` handoff stamp."""
        if prompt_token_ids is None:
            prompt_token_ids = self.tokenizer.encode(prompt or "")
        if not prompt_token_ids:
            prompt_token_ids = [0]
        lora_idx, lora_scale, salt = 0, 0.0, 0
        if lora_name:
            if self.lora_manager is None:
                raise ValueError("LoRA not enabled on this engine")
            ad = self.lora_manager.get(lora_name)
            if ad is None:
                raise ValueError(f"LoRA adapter {lora_name!r} not loaded")
            lora_idx, lora_scale = ad.slot, ad.scaling
            # The JAX engine's salt, bit for bit: a mixed ring of port and
            # JAX engines keeps an adapter's KV under the same keys.
            salt = xxh64(lora_name.encode()) & 0x7FFF_FFFF_FFFF_FFFF
        seq = Sequence(
            request_id, prompt_token_ids, sampling or SamplingParams(),
            arrival_time=arrival_time,
            lora_idx=lora_idx, lora_scale=lora_scale, cache_salt=salt,
            deadline=deadline if self.cfg.deadline_shedding else None,
            tenant=tenant or "default",
            tenant_class=tenant_class or "interactive",
            kv_transfer=kv_transfer,
        )
        self._last_arrival = time.time()
        self.scheduler.add(seq)
        self._seqs[request_id] = seq
        self._detok[request_id] = {"emitted": "", "prefix": 0, "read": 0}
        self.prompt_tokens_total += len(prompt_token_ids)
        return seq

    def load_lora(self, name: str, path: Optional[str] = None
                  ) -> LoadedAdapter:
        """Parse a PEFT adapter into a free bank slot and write it there
        (the operator's ``POST /v1/load_lora_adapter``); a resident name
        is returned as it is. Call on the step thread, between steps."""
        if self.lora_manager is None:
            raise ValueError("LoRA not enabled on this engine (--enable-lora)")
        ad, arrays = self.lora_manager.load(name, path)
        if arrays is not None:
            self.runner.install_adapter(ad.slot, arrays)
        return ad

    def unload_lora(self, name: str) -> bool:
        """Remove the adapter's name: new requests for it fail at once,
        and the sequences in flight finish under its weights. Its slot is
        zeroed and reused once they are gone (``_sweep_retiring_slots``).
        Call on the step thread, between steps."""
        if self.lora_manager is None:
            return False
        ad = self.lora_manager.unload(name)
        if ad is None:
            return False
        self._retiring_slots.add(ad.slot)
        self._sweep_retiring_slots()
        return True

    def _sweep_retiring_slots(self) -> None:
        """Zero and free each retiring slot that nothing reads any more:
        no live sequence holds it, and no member of an in-flight burst
        (a finished member's row still runs in it until the drain). A slot
        leaves the retiring set only once it is free, so ``stats()``, read
        from other threads, never shows it neither retiring nor free."""
        if not self._retiring_slots:
            return
        live = {s.lora_idx for s in self._seqs.values()}
        if self.runner.burst_in_flight:
            live |= {s.lora_idx for s in self._burst_seqs}
        for slot in sorted(self._retiring_slots - live):
            self.runner.uninstall_adapter(slot)
            self.lora_manager.release_slot(slot)
            self._retiring_slots.discard(slot)

    def abort_request(self, request_id: str) -> bool:
        # An aborted request is billed for the device time it took, while
        # it still owns its pages.
        live = self._seqs.get(request_id)
        if live is not None:
            self._finalize_cost(live)
        if self.runner.burst_in_flight and any(
            s.request_id == request_id for s in self._burst_seqs
        ):
            # The in-flight burst writes through its pages: release them
            # at the drain.
            seq = self.scheduler.detach(request_id)
            if seq is not None:
                self._burst_deferred.append(seq)
        else:
            seq = self.scheduler.abort(request_id)
        self._seqs.pop(request_id, None)
        self._detok.pop(request_id, None)
        return seq is not None

    def abort_all_requests(self) -> int:
        if self.runner.burst_in_flight:
            self.runner.burst_drain()  # discarded: everything goes away
            self._burst_seqs = []
            self._burst_n = 0
            self._release_burst_deferred()
        rids = list(self._seqs)
        for rid in rids:
            self.abort_request(rid)
        return len(rids)

    def has_work(self) -> bool:
        # An in-flight burst is work with empty queues too: its rows must
        # be applied and its deferred pages released.
        return self.scheduler.has_work() or self.runner.burst_in_flight

    def clear_kv_state(self) -> None:
        """Forget every page the cache held (sleep level 2 drops them):
        abort every request in flight (a parked one's abort drops its
        stash) and start an empty allocator, which the scheduler hands the
        swapper from then on, so no later prompt adopts a dropped (zeroed)
        page as a prefix hit. The lower tiers keep their pages (written
        before the drop, still valid): the rebuilt allocator takes over
        the warm host pool and the remote client, and the old push
        thread stops."""
        self.abort_all_requests()
        old = self.allocator
        shutdown = getattr(old, "shutdown", None)
        if shutdown is not None:
            shutdown()
        self.allocator = self._make_allocator(
            remote=self.remote, host_pool=getattr(old, "host_pool", None))
        self.scheduler.allocator = self.allocator
        self.resident_chunk_hashes.clear()

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    def _arrival_safe(self) -> bool:
        """The three arrival-safety rules of adaptive deepening and overlap
        engagement, from PAST observations only: nothing waits, at least
        ``adaptive_decode_min_running`` sequences run, and no request
        arrived for ``adaptive_decode_quiet_s``."""
        if self.scheduler.num_waiting:
            return False
        if self.scheduler.num_running < self.cfg.adaptive_decode_min_running:
            return False
        return (time.time() - self._last_arrival
                >= self.cfg.adaptive_decode_quiet_s)

    def _decode_depth_hint(self) -> Optional[int]:
        """The adaptive burst depth when the gates hold, else None (the
        configured depth)."""
        cap = self.cfg.adaptive_decode_steps
        if not cap or cap <= self.cfg.num_decode_steps:
            return None
        if not self._arrival_safe():
            return None
        return cap

    def step(self) -> List[RequestOutput]:
        outputs = self._step_impl()
        self._sweep_retiring_slots()
        # A capture in this step delayed every request the step served:
        # its outputs carry the events. A step that emits nothing (an
        # intermediate prefill chunk) holds them for the next one that
        # does, which serves the requests that waited on it.
        events = (self._pending_compile_events
                  + self.telemetry.drain_compile_events())
        if outputs:
            if events:
                for out in outputs:
                    out.compile_events = list(events)
            self._pending_compile_events = []
        else:
            self._pending_compile_events = events[-8:]  # bounded
        return outputs

    def _step_impl(self) -> List[RequestOutput]:
        outputs: List[RequestOutput] = []
        hint = self._decode_depth_hint()
        if self.runner.burst_in_flight:
            locked = frozenset(s.request_id for s in self._burst_seqs)
            sched = self.scheduler.schedule(locked=locked, n_decode=hint)
            self.num_preempted_total += len(sched.preempted)
            outputs += self._finish_expired(sched.expired)
            if self._can_continue_burst(sched):
                self.pipelined_bursts_total += 1
                if self._burst_n > self.cfg.num_decode_steps:
                    self.adaptive_deep_bursts_total += 1
                rows = self.runner.burst_continue(self._burst_seqs)
                return outputs + self._process_burst_rows(rows)
            # A new arrival's prefill slips in BEHIND the in-flight burst:
            # dispatched first, it runs while the burst's rows are fetched
            # (it touches only its own fresh pages; locked members were not
            # evicted for them).
            handle = None
            if sched.prefills and not sched.blocked_on_locked:
                handle = self.runner.prefill_dispatch(sched.prefills)
            outputs += self._process_burst_rows(self.runner.burst_drain())
            self._release_burst_deferred()
            if handle is not None:
                rows = self.runner.prefill_fetch(handle, len(sched.prefills))
                return outputs + self._process_prefill_rows(
                    sched.prefills, rows)
        sched = self.scheduler.schedule(n_decode=hint)
        self.num_preempted_total += len(sched.preempted)
        outputs += self._finish_expired(sched.expired)
        if sched.is_empty:
            return outputs
        if sched.prefills:
            # Intermediate chunks sample nothing anyone reads: no fetch.
            # Only a chunk that completes a fresh prompt needs its token.
            any_completes = any(
                it.end == it.seq.num_prompt_tokens and not it.seq.output_token_ids
                for it in sched.prefills
            )
            rows = None
            if any_completes:
                rows = self.runner.execute_prefill_batch(sched.prefills)
            else:
                self.runner.execute_prefill_batch_nofetch(sched.prefills)
            return outputs + self._process_prefill_rows(sched.prefills, rows)
        spec = self._spec_drafts(sched.decodes, sched.n_decode_steps)
        if spec is not None:
            # Speculation first: when it engages it beats a burst on tokens
            # per round trip.
            return outputs + self._spec_step(sched.decodes, spec)
        deep = (hint is not None
                and sched.n_decode_steps > self.cfg.num_decode_steps)
        if self._pipeline_ok(sched):
            # The first burst of a pipeline: dispatched only; its rows are
            # applied on the NEXT step, while the following burst runs.
            self._burst_seqs = list(sched.decodes)
            self._burst_n = sched.n_decode_steps
            self.pipelined_bursts_total += 1
            self.adaptive_deep_bursts_total += deep
            self.runner.burst_start(sched.decodes, sched.n_decode_steps)
            return outputs
        self.adaptive_deep_bursts_total += deep
        bursts = self.runner.execute_decode_multi(
            sched.decodes, sched.n_decode_steps
        )
        for seq, seq_rows in zip(sched.decodes, bursts):
            for row in seq_rows:
                seq.num_computed_tokens += 1
                self._commit(seq, decoded=True)
                out = self._append_token(seq, int(row[0]), lp_row=row)
                if out is not None:
                    outputs.append(out)
                if seq.is_finished:
                    break  # trim the burst's tail past a stop
        return outputs

    def _finish_expired(self, expired) -> List[RequestOutput]:
        """The terminal output of each sequence the scheduler shed on its
        deadline (already finished, pages released), so the server can
        answer a 504 or end the stream."""
        outs: List[RequestOutput] = []
        for seq in expired:
            if self._seqs.pop(seq.request_id, None) is None:
                continue
            self._detok.pop(seq.request_id, None)
            outs.append(RequestOutput(
                request_id=seq.request_id, finished=True,
                finish_reason="deadline",
                num_prompt_tokens=seq.num_prompt_tokens,
                num_output_tokens=len(seq.output_token_ids),
                num_cached_prompt_tokens=seq.num_cached_prompt_tokens,
                # Shed work still took device time: bill it.
                cost=self._finalize_cost(seq),
            ))
        return outs

    def _process_prefill_rows(self, prefills, rows) -> List[RequestOutput]:
        """``rows is None`` for a step that fetched nothing (no chunk
        completed a fresh prompt)."""
        outputs: List[RequestOutput] = []
        for i, item in enumerate(prefills):
            seq = item.seq
            seq.num_computed_tokens = item.end
            self._commit(seq)
            # The streamed handoff: this chunk's committed pages go out
            # now, overlapped with the next chunk's compute.
            self._stream_publish(
                seq, prefill_complete=item.end == seq.num_prompt_tokens)
            # Sample only when this chunk completes a *fresh* prompt;
            # recompute chunks (post-preemption) must not re-emit.
            if item.end == seq.num_prompt_tokens and not seq.output_token_ids:
                out = self._append_token(seq, int(rows[i][0]), lp_row=rows[i])
                if out is not None:
                    outputs.append(out)
        return outputs

    # -- pipelined decode ------------------------------------------------

    def _pipeline_ok(self, sched) -> bool:
        """May this pass start a pipeline? ``async_decode`` always;
        ``overlap_decode`` only under the arrival gates, so no arrival
        waits behind a burst it did not already have. Guided rows never
        (their allowed-token mask is rebuilt per token on the host);
        penalized rows do (their counts ride the burst's carry)."""
        if not sched.decodes:
            return False
        if any(s.sampling.guided_choice for s in sched.decodes):
            return False
        if self.cfg.async_decode:
            return True
        # Speculation and overlap are alternative round-trip amortizers:
        # with n-gram speculation configured, overlap stays out of its way.
        if self.cfg.speculative_ngram:
            return False
        return self.cfg.overlap_decode and self._arrival_safe()

    def _can_continue_burst(self, sched) -> bool:
        """The in-flight burst may chain iff the step's shape is unchanged
        and the NEXT burst's writes are covered by pages."""
        alive = [s for s in self._burst_seqs if not s.is_finished]
        n = self._burst_n
        return bool(
            not sched.prefills
            and not sched.blocked_on_locked
            and self.scheduler.num_waiting == 0  # drain so admission runs
            and alive
            and sched.decodes == alive
            and sched.n_decode_steps == n
            and self.runner.burst_width_stable(self._burst_seqs)
            # The continuation writes up to num_tokens + 2n (the host's
            # view lags one burst): past max_model_len no page exists.
            and all(s.num_tokens + 2 * n <= self.cfg.max_model_len
                    for s in alive)
        )

    def _process_burst_rows(self, rows) -> List[RequestOutput]:
        """Apply one fetched burst's rows, aligned with ``_burst_seqs``;
        the rows of members that finished earlier are skipped. While the
        next burst is in flight, page releases wait: the device writes
        through these page ids."""
        outputs: List[RequestOutput] = []
        inflight = self.runner.burst_in_flight
        for seq, seq_rows in zip(self._burst_seqs, rows):
            if seq.is_finished:
                continue
            for row in seq_rows:
                seq.num_computed_tokens += 1
                self._commit(seq, decoded=True)
                out = self._append_token(seq, int(row[0]), lp_row=row)
                if out is not None:
                    outputs.append(out)
                if seq.is_finished:
                    break  # trim the burst's tail past a stop
        if not inflight:
            self._burst_seqs = []
            self._burst_n = 0
        return outputs

    # -- speculative decoding (n-gram prompt lookup; engine/spec.py) ----

    def _spec_drafts(self, decodes, n_burst: int = 1
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Draft tokens [B, K] and their lengths [B] for this decode batch,
        or None when speculation should not engage (the JAX engine's
        gating). Per row: only greedy, unguided rows with room for K more
        tokens get drafts; the others ride the verify step, their position
        0 sampled as a plain decode step samples it. Per batch: penalties
        (accepted tokens would change the counts mid-step) or logprobs
        (verify returns no logprob rows) bail out, as do too few drafted
        rows to beat the n-step burst the pass replaces."""
        K = self.cfg.speculative_ngram
        if not K or self.cfg.async_decode or not decodes:
            return None
        for s in decodes:
            if s.sampling.has_penalties or s.sampling.logprobs is not None:
                return None
        drafts = np.zeros((len(decodes), K), np.int32)
        lens = np.zeros(len(decodes), np.int32)
        for i, s in enumerate(decodes):
            if not s.sampling.greedy or s.sampling.guided_choice:
                continue
            if s.num_tokens + K > self.cfg.max_model_len:
                continue  # verify writes would run past the last page
            d = propose_ngram(self._spec_token_arr(s), K, self.cfg.ngram_min,
                              self.cfg.ngram_max,
                              lookback=self.cfg.ngram_lookback)
            if d:
                drafts[i, : len(d)] = d
                lens[i] = len(d)
        B = len(decodes)
        hits = int(np.count_nonzero(lens))
        if hits * 2 < B or hits * (K + 1) + (B - hits) < n_burst * B:
            return None
        return drafts, lens

    @staticmethod
    def _spec_token_arr(s: Sequence) -> np.ndarray:
        """The sequence's token ids for the n-gram scan, grown in place
        (tokens are append-only): rebuilding the whole array every decode
        step is O(context) host work per sequence."""
        total = s.num_tokens
        buf = getattr(s, "_spec_buf", None)
        n = getattr(s, "_spec_buf_n", 0)
        if buf is None or n > total:
            buf = np.empty(max(total * 2, 256), np.int64)
            n = 0
        elif buf.shape[0] < total:
            grown = np.empty(max(total * 2, buf.shape[0] * 2), np.int64)
            grown[:n] = buf[:n]
            buf = grown
        P = s.num_prompt_tokens
        prompt, output = s.prompt_token_ids, s.output_token_ids
        for idx in range(n, total):
            buf[idx] = prompt[idx] if idx < P else output[idx - P]
        s._spec_buf, s._spec_buf_n = buf, total
        return buf[:total]

    def _spec_step(self, decodes, spec) -> List[RequestOutput]:
        """One verify pass: commit each row's accepted draft prefix plus
        the model's own next token (a draftless row: its sampled position
        0, exactly one plain decode step)."""
        drafts, lens = spec
        rows, sampled0 = self.runner.execute_spec_verify(decodes, drafts)
        outputs: List[RequestOutput] = []
        for i, seq in enumerate(decodes):
            if lens[i] == 0:
                emitted = [int(sampled0[i])]
            else:
                draft = [int(t) for t in drafts[i][: lens[i]]]
                a = count_accepted(draft, rows[i])
                # Never emit past max_model_len.
                a = min(a, self.cfg.max_model_len - seq.num_tokens - 1)
                self.spec_proposed_total += len(draft)
                self.spec_accepted_total += a
                emitted = draft[:a] + [int(rows[i][a])]
            for tok in emitted:
                seq.num_computed_tokens += 1
                self._commit(seq, decoded=True)
                out = self._append_token(seq, tok)
                if out is not None:
                    outputs.append(out)
                if seq.is_finished:
                    break
        return outputs

    def _release_burst_deferred(self) -> None:
        for seq in self._burst_deferred:
            self.allocator.release_all(seq.block_ids)
            seq.block_ids = []
        self._burst_deferred = []

    # Controller-registration hygiene: chunk claims older than the TTL
    # (or past the cap) are dropped, so KV-aware routing does not chase KV
    # that eviction reclaimed, and the dict stays bounded.
    CHUNK_CLAIM_TTL = 20 * 60.0
    CHUNK_CLAIM_CAP = 200_000

    def _commit(self, seq: Sequence, decoded: bool = False) -> None:
        """Content-address ``seq``'s newly full pages. A page a prefill
        filled swaps to an existing copy of the same tokens, as in the
        JAX engine. A page that decoding filled does not: it stays
        un-addressed (the prefix map keeps the first copy, for later
        prompts) and is released with the sequence, so a live row keeps
        reading the bits it wrote. The first copy was computed by other
        steps (another round's prefill chunks), and the swap could happen
        only while no burst was in flight: the pipeline's engagement step
        chose the row's rounding (ROADMAP fault 3.9). The JAX engine
        swaps a decoded page whenever no burst is in flight."""
        seq.commit_full_blocks(self.allocator, allow_swap=not decoded)
        now = time.time()
        for h in seq.commit_full_chunks(CHUNK_TOKENS):
            self.resident_chunk_hashes.pop(h, None)  # refresh its order
            self.resident_chunk_hashes[h] = now
        if len(self.resident_chunk_hashes) > self.CHUNK_CLAIM_CAP:
            self._prune_chunk_claims(now)

    def _prune_chunk_claims(self, now: float) -> None:
        cutoff = now - self.CHUNK_CLAIM_TTL
        fresh = {h: t for h, t in self.resident_chunk_hashes.items()
                 if t >= cutoff}
        if len(fresh) > self.CHUNK_CLAIM_CAP:
            # Insertion order is recency (refreshed on re-commit).
            fresh = dict(list(fresh.items())[-self.CHUNK_CLAIM_CAP:])
        self.resident_chunk_hashes = fresh

    def registered_chunk_hashes(self) -> List[int]:
        """The chunk hashes to register with the controller: those
        committed within ``CHUNK_CLAIM_TTL``. Called off the step thread:
        ``dict.copy`` takes the snapshot in one step."""
        cutoff = time.time() - self.CHUNK_CLAIM_TTL
        return [h for h, t in self.resident_chunk_hashes.copy().items()
                if t >= cutoff]

    # -- the disaggregated handoff ---------------------------------------

    def _stream_publish(self, seq: Sequence, prefill_complete: bool) -> None:
        """Hand ``seq``'s newly committed pages to the publisher (on this
        thread: queued copies and a deque append). The completion marker
        carries the prompt's full-block count, what the consumer's
        ``match_prefix`` can adopt."""
        pub = self.kv_publisher
        transfer = seq.kv_transfer
        if pub is None or not transfer:
            return
        if transfer.get("role") == "consumer":
            # The decode leg on a kv_role="both" engine: its prompt pages
            # came from the store; re-publishing would copy each again.
            return
        rid = transfer.get("request_id")
        if not rid:
            return
        n = seq._committed_blocks
        if n > seq.kv_published_cursor:
            pages = [(seq.block_hashes[i],
                      *self.runner.download_page(seq.block_ids[i]))
                     for i in range(seq.kv_published_cursor, n)]
            pub.publish(rid, pages, self.runner.page_event())
            self.kv_published_blocks_total += len(pages)
            seq.kv_published_cursor = n
        if prefill_complete and not transfer.get("_completed"):
            transfer["_completed"] = True
            pub.complete(rid, seq.num_prompt_tokens // self.cfg.block_size)

    def _push_kv_to_remote(self, seq: Sequence) -> int:
        """A producer's push at a request's finish: the committed pages the
        publisher has not sent (``kv_published_cursor``), in one batched
        round trip (a request without ``kv_transfer_params``, and the
        decode-produced tail of a streamed one). One copy a page, ever.
        Runs on the step thread, as the JAX engine's, and waits for the
        pages' copies (their event) before the serde reads them."""
        remote = self.remote
        if remote is None:
            return 0
        start = seq.kv_published_cursor
        if seq.kv_transfer and seq.kv_transfer.get("role") == "consumer":
            # A consumer leg's cached prefix came from the store: only
            # pages computed here are new.
            start = max(start,
                        seq.num_cached_prompt_tokens // self.cfg.block_size)
        pages = [(h, *self.runner.download_page(blk))
                 for blk, h in zip(seq.block_ids[start:],
                                   seq.block_hashes[start:])]
        if not pages:
            return 0
        wait_landed(self.runner.page_event())
        if not remote.put_blocks(pages):
            return 0
        seq.kv_published_cursor = start + len(pages)
        return len(pages)

    # ------------------------------------------------------------------
    # Token bookkeeping
    # ------------------------------------------------------------------

    def _append_token(
        self, seq: Sequence, token: int, lp_row=None
    ) -> Optional[RequestOutput]:
        sp = seq.sampling
        seq.output_token_ids.append(token)
        self.generation_tokens_total += 1
        now = time.monotonic()
        if seq.first_token_time is None:
            seq.first_token_time = now

        finish_reason: Optional[str] = None
        is_stop_token = False
        if not sp.ignore_eos and token in self.model_cfg.eos_token_ids:
            finish_reason = "stop"
            is_stop_token = True
        elif token in sp.stop_token_ids:
            finish_reason = "stop"
            is_stop_token = True
        elif sp.guided_done(seq.output_token_ids):
            finish_reason = "stop"
        elif len(seq.output_token_ids) >= sp.max_tokens:
            finish_reason = "length"
        elif seq.num_tokens >= self.cfg.max_model_len:
            finish_reason = "length"

        # Incremental detokenization over a sliding window; hold text back
        # while the window ends in a partial multi-byte character.
        delta = "" if is_stop_token else self._detok_delta(seq)
        st = self._detok[seq.request_id]
        if delta and sp.stop_strings():
            emitted = st["emitted"]
            full = emitted + delta
            for stop_s in sp.stop_strings():
                idx = full.find(stop_s, max(len(emitted) - len(stop_s), 0))
                if idx >= 0:
                    delta = full[:idx][len(emitted):]
                    finish_reason = "stop"
                    break
        st["emitted"] += delta

        logprobs_entry = None
        if sp.logprobs is not None and lp_row is not None and lp_row.shape[-1] > 1:
            _, chosen, top_lps, top_ids = unpack_sampled(lp_row)
            k = min(int(sp.logprobs), top_ids.shape[-1])
            logprobs_entry = {
                "token_id": token,
                "logprob": float(chosen),
                "top": [(int(top_ids[j]), float(top_lps[j])) for j in range(k)],
            }

        scheduled = seq.first_scheduled_time
        out = RequestOutput(
            request_id=seq.request_id,
            text_delta=delta,
            new_token_ids=[token],
            num_prompt_tokens=seq.num_prompt_tokens,
            num_output_tokens=len(seq.output_token_ids),
            num_cached_prompt_tokens=seq.num_cached_prompt_tokens,
            ttft=seq.first_token_time - seq.arrival_time,
            queue_time=(scheduled - seq.arrival_time
                        if scheduled is not None else None),
            prefill_time=(seq.first_token_time - scheduled
                          if scheduled is not None else None),
            logprobs=[logprobs_entry] if logprobs_entry else None,
        )
        if finish_reason is not None:
            out.decode_time = now - seq.first_token_time
            # The account closes while the pages are still owned (the
            # scheduler releases them just below).
            out.cost = self._finalize_cost(seq)
            if self.cfg.kv_role in ("producer", "both"):
                sent = self._push_kv_to_remote(seq)
                if sent:
                    logger.debug("disagg: pushed %d KV pages for %s", sent,
                                 seq.request_id)
            if self.runner.burst_in_flight and seq in self._burst_seqs:
                # The in-flight burst still writes through its pages:
                # detach now, release at the drain.
                self.scheduler.detach(seq.request_id, finish_reason)
                self._burst_deferred.append(seq)
            else:
                self.scheduler.finish(seq, finish_reason)
            out.finished = True
            out.finish_reason = finish_reason
            self._seqs.pop(seq.request_id, None)
            self._detok.pop(seq.request_id, None)
        return out

    def _detok_delta(self, seq: Sequence) -> str:
        """vLLM-style incremental detokenization over a bounded window."""
        st = self._detok[seq.request_id]
        ids = seq.output_token_ids
        prefix, read = int(st["prefix"]), int(st["read"])  # type: ignore[arg-type]
        prefix_text = self.tokenizer.decode(ids[prefix:read])
        new_text = self.tokenizer.decode(ids[prefix:])
        if new_text.endswith("�") and len(ids) - read < 16:
            return ""  # partial character: hold until it completes
        delta = new_text[len(prefix_text):]
        st["prefix"], st["read"] = read, len(ids)
        return delta

    # ------------------------------------------------------------------
    # Convenience (tests / scripts)
    # ------------------------------------------------------------------

    def generate(
        self,
        prompts: Union[List[str], List[List[int]]],
        sampling: Optional[SamplingParams] = None,
    ) -> List[Dict[str, object]]:
        """Run prompts to completion; returns list of dicts with text/ids."""
        results: Dict[str, Dict[str, object]] = {}
        for i, p in enumerate(prompts):
            rid = f"gen-{i}"
            kwargs = {"prompt_token_ids": p} if isinstance(p, list) else {"prompt": p}
            self.add_request(rid, sampling=sampling, **kwargs)
            results[rid] = {"text": "", "token_ids": [], "finish_reason": None}
        while self.has_work():
            for out in self.step():
                r = results[out.request_id]
                r["text"] = str(r["text"]) + out.text_delta
                r["token_ids"].extend(out.new_token_ids)  # type: ignore[union-attr]
                if out.finished:
                    r["finish_reason"] = out.finish_reason
        return [results[f"gen-{i}"] for i in range(len(prompts))]

    def stats(self) -> Dict[str, float]:
        sched, swapper = self.scheduler, self.swapper
        return {
            "num_requests_running": float(sched.num_running),
            "num_requests_waiting": float(sched.num_waiting),
            "num_requests_swapped": float(sched.num_swapped),
            "num_preemptions_total": float(self.num_preempted_total),
            "prompt_tokens_total": float(self.prompt_tokens_total),
            "generation_tokens_total": float(self.generation_tokens_total),
            "kv_cache_usage_perc": self.allocator.usage,
            "prefix_cache_hit_rate": self.allocator.hit_rate,
            "prefix_cache_hits_total": float(self.allocator.hit_tokens),
            "prefix_cache_queries_total": float(self.allocator.query_tokens),
            "deadline_sheds_queued_total": float(sched.deadline_sheds_queued),
            "deadline_sheds_running_total": float(
                sched.deadline_sheds_running),
            "device_busy_seconds_total": self.telemetry.device_busy(),
            **{f"graphs_{k}": float(n)
               for k, n in self.runner.graph_counts.items()},
            "graph_pool_bytes": float(self.runner.graph_pool_bytes),
            "compile_cache_hits_total": float(_build.cache_counts["hits"]),
            "compile_cache_misses_total": float(
                _build.cache_counts["misses"]),
            "kernel_build_seconds": float(_build.last_build_seconds),
            **({"adaptive_deep_bursts_total":
                float(self.adaptive_deep_bursts_total)}
               if self.cfg.adaptive_decode_steps else {}),
            **({"pipelined_bursts_total": float(self.pipelined_bursts_total)}
               if self.cfg.async_decode or self.cfg.overlap_decode else {}),
            **({"spec_decode_num_draft_tokens_total":
                float(self.spec_proposed_total),
                "spec_decode_num_accepted_tokens_total":
                float(self.spec_accepted_total)}
               if self.cfg.speculative_ngram else {}),
            **(self._tenant_stats() if self.cfg.tenant_fairness else {}),
            **({"lora_adapters_loaded": float(
                len(self.lora_manager.list_adapters())),
                "lora_free_slots": float(self.lora_manager.free_slots),
                "lora_retiring_slots": float(len(self._retiring_slots))}
               if self.lora_manager is not None else {}),
            **self._tier_stats(),
            **({"tensor_parallel_size": float(self.cfg.tensor_parallel_size),
                "pipeline_parallel_size": float(
                    self.cfg.pipeline_parallel_size),
                "data_parallel_size": float(self.cfg.data_parallel_size),
                "tp_device_backend": self.ranks.ctx.backend,
                "tp_rank_devices": ",".join(self.ranks.ctx.devices)}
               if self.ranks is not None else {}),
            **({"kv_swap_out_total": float(swapper.swap_out_total),
                "kv_swap_in_total": float(swapper.swap_in_total),
                "kv_swap_tail_pages_total": float(swapper.tail_pages_moved),
                "kv_swap_fallback_recompute_total": float(
                    swapper.fallback_recompute_total),
                "kv_swap_stash_blocks": float(swapper.stash_blocks)}
               if swapper is not None else {}),
        }

    def _tier_stats(self) -> Dict[str, float]:
        """The JAX engine's tier entries: the tiers' page counts, the
        handoff's, and the remote client's audit counters (digest
        failures, read repairs, GET retries), each only where its layer
        is on."""
        out: Dict[str, float] = {}
        alloc = self.allocator
        for attr in ("host_hit_blocks", "remote_hit_blocks", "spilled_blocks"):
            if hasattr(alloc, attr):
                out[f"kv_offload_{attr}"] = float(getattr(alloc, attr))
        pub, pre = self.kv_publisher, self.kv_prefetcher
        if pub is not None or pre is not None:
            out["kv_published_blocks_total"] = float(
                self.kv_published_blocks_total)
        if pub is not None:
            out["kv_publish_failures_total"] = float(pub.publish_failures)
        if pre is not None:
            out["kv_prefetched_blocks_total"] = float(pre.prefetched_blocks)
            out["kv_transfer_fallbacks_total"] = float(pre.fallbacks)
        remote = self.remote
        if remote is not None:
            if hasattr(remote, "refresh_counters"):
                remote.refresh_counters()
            counters = remote.counters
            out["kv_integrity_failures_total"] = float(
                counters.get("integrity_failures", 0))
            out["kv_read_repairs_total"] = float(counters.get("read_repairs", 0))
            out["kv_remote_retries_total"] = float(counters.get("retries", 0))
        return out

    def _tenant_stats(self) -> Dict[str, float]:
        ages = self.scheduler.queue_age_by_tier()
        return {
            "tenant_queue_age_interactive": ages["interactive"],
            "tenant_queue_age_batch": ages["batch"],
            "tenant_batch_preemptions_total": float(
                self.scheduler.batch_preemptions),
        }

    # ------------------------------------------------------------------
    # Warmup (engine/precompile.py)
    # ------------------------------------------------------------------

    def precompile(
        self, mode: Optional[str] = None, bucket_budget: Optional[int] = None
    ) -> dict:
        """Capture the padded shape-bucket lattice ahead of traffic (mode
        and budget default to the config's ``warmup`` and
        ``warmup_bucket_budget``). Runs on whatever thread calls it (the
        async engine's step thread, so HTTP probes stay responsive);
        returns the summary the server's ``/ready`` payload carries."""
        from .precompile import Precompiler

        t0 = time.perf_counter()
        summary = Precompiler(
            self.runner, self.cfg, mode=mode, bucket_budget=bucket_budget
        ).run()
        self.telemetry.record_startup_phase(
            "precompile", time.perf_counter() - t0)
        self.telemetry.set_warmup_coverage(summary["buckets_compiled"],
                                           summary["buckets_total"])
        gc = self.runner.graph_counts
        logger.info("warmup done: %d graphs captured, %.1f MiB in their pool",
                    gc["captured"], self.runner.graph_pool_bytes / 2**20)
        self.warmup_summary = summary
        return summary
