"""Engine telemetry: step captures, step durations, host gaps, MFU, KV
pressure, startup phases, per-request cost.

The port's copy of the engine side of the JAX package's
``obs/engine_telemetry.py``, with its family names, help strings, labels
and buckets, rendered by :mod:`.prometheus_text`. The runner feeds it at
every device step and the server appends it to ``/metrics``.

What differs:

- A "compile" is a graph key's first use on the card: its eager run plus
  its capture into a CUDA graph (``engine/runner.py::_run``). Steps on
  CPU tensors capture nothing and are all counted as steps.
- Each runner owns its telemetry (one registry an engine), where the JAX
  package keeps one for the process.
- ``pst_engine_mfu`` divides by the peak of the card's name in
  ``_PEAK_FLOPS_BY_DEVICE_NAME``; for a device the table lacks it stays
  0, rather than taking another device's peak.
- Compile events (a step that captured its key) are queued for the
  engine to attach to the requests it served only for live steps: a
  warmup capture delays no request.
- ``pst_engine_compile_cache_hits_total`` and ``..._misses_total`` keep
  the JAX names and help, and count the kernel library's loads from, and
  builds into, ``--compile-cache-dir`` (``ops/_build.py``): one library a
  process, where the JAX package counts each compiled program. The
  engine's ``stats()`` carries them.

Every live step also goes to the engine's flight recorder
(``attach_flight``, ``obs/flight.py``), and each finished request's
device seconds to ``pst_request_device_seconds{phase}`` and
``pst_tenant_device_seconds_total{tenant}`` (``record_request_cost``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from .flight import NULL_FLIGHT_RECORDER
from .prometheus_text import Registry

_COMPILE_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                    120.0, 300.0)
_STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)
_FILL_BUCKETS = (0.1, 0.25, 0.5, 0.625, 0.75, 0.875, 1.0)
_HOST_GAP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25)
_REQUEST_DEVICE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                           0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)

# Dense bf16 tensor-core peak by ``torch.cuda.get_device_name()``: the
# H100 SXM5's 989.4 TFLOP/s (NVIDIA H100 Tensor Core GPU datasheet).
_PEAK_FLOPS_BY_DEVICE_NAME = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


class EngineTelemetry:
    """The ``pst_engine_*`` families of one engine. Thread-safe: the step
    thread records while HTTP threads render."""

    _TOKEN_WINDOW_S = 10.0

    def __init__(self, startup_phases: bool = True) -> None:
        # False (--no-startup-phases): pst_engine_startup_seconds stays
        # without a sample.
        self.startup_phases = startup_phases
        self.registry = r = Registry()
        self._lock = threading.Lock()
        self.compile_total = r.counter(
            "pst_engine_compile",
            "XLA compilations observed at jitted dispatch (first call per "
            "shape bucket), by step kind and padded shape bucket",
            ["kind", "shape_bucket"])
        self.compile_seconds = r.histogram(
            "pst_engine_compile_seconds",
            "Wall time of compile-bearing dispatches (trace + XLA build + "
            "first execution), by step kind",
            _COMPILE_BUCKETS, ["kind"])
        self.step_duration = r.histogram(
            "pst_engine_step_duration_seconds",
            "Device step wall time (dispatch to fetch), by step kind and "
            "padded batch bucket; compile-bearing first calls excluded",
            _STEP_BUCKETS, ["kind", "batch_bucket"])
        self.host_gap_seconds = r.histogram(
            "pst_engine_host_gap_seconds",
            "Serial host wall between a decode step's device completion and "
            "the next decode dispatch (batch build, detokenization, stop "
            "scans, scheduler accounting on the critical path), by padded "
            "batch bucket; pipelined continuations record 0 — the device "
            "never idled",
            _HOST_GAP_BUCKETS, ["batch_bucket"])
        self.batch_fill_ratio = r.histogram(
            "pst_engine_batch_fill_ratio",
            "Useful fraction of each padded device step (real rows*tokens "
            "over padded rows*tokens) — 1.0 means zero padding waste",
            _FILL_BUCKETS, ["kind"])
        self.tokens_per_second = r.gauge(
            "pst_engine_tokens_per_second",
            "Engine token throughput over a short sliding window, by step "
            "kind", ["kind"])
        self.mfu = r.gauge(
            "pst_engine_mfu",
            "Model-FLOPs utilization estimate: 2 * params * tokens/s over "
            "the accelerator's peak FLOPs")
        self.kv_page_occupancy = r.gauge(
            "pst_engine_kv_page_occupancy", "Fraction of HBM KV pages in use")
        self.kv_page_high_watermark = r.gauge(
            "pst_engine_kv_page_high_watermark",
            "Highest KV page occupancy fraction observed since engine start")
        self.preemptions = r.counter(
            "pst_engine_preemptions",
            "Scheduler recompute preemptions (out of KV pages)")
        self.swap_out = r.counter(
            "pst_engine_swap_out",
            "Sequences swapped out by the scheduler (KV parked host-side)")
        self.swap_in = r.counter(
            "pst_engine_swap_in",
            "Sequences swapped back in by the scheduler (KV resumed)")
        self.start_time_seconds = r.gauge(
            "pst_engine_start_time_seconds",
            "Wall-clock time the engine's runner initialized (the alert "
            "rules gate recompile alerts on uptime so cold-start compiles "
            "never page)")
        self.startup_seconds = r.gauge(
            "pst_engine_startup_seconds",
            "Engine startup decomposition: load (param materialization), "
            "shard (device placement + KV alloc + jit wiring), warmup "
            "(tokenizer, allocator, scheduler), precompile (ahead-of-time "
            "shape-bucket lattice compilation)", ["phase"])
        self.warmup_coverage = r.gauge(
            "pst_engine_warmup_coverage",
            "Warmup precompile coverage: shape buckets compiled over buckets "
            "in the enumerated lattice (1.0 = every padded shape live "
            "traffic can produce is already compiled)")
        self.warmup_buckets = r.gauge(
            "pst_engine_warmup_buckets",
            "Warmup lattice size, by state: total (enumerated) vs compiled "
            "(dispatched at warmup)", ["state"])
        self.device_busy_seconds = r.counter(
            "pst_engine_device_busy_seconds",
            "Cumulative wall the device spent executing live-traffic "
            "dispatches (warmup precompilation excluded) — the denominator "
            "per-request cost attribution is audited against (sum of "
            "request device-seconds must cover >= 90% of this)")
        self.request_device_seconds = r.histogram(
            "pst_request_device_seconds",
            "Device-seconds attributed to one finished request, by phase: "
            "prefill (token-weighted share of its prefill steps) or decode "
            "(active-row share of its decode bursts/spec verifies)",
            _REQUEST_DEVICE_BUCKETS, ["phase"])
        self.tenant_device_seconds = r.counter(
            "pst_tenant_device_seconds",
            "Device-seconds attributed to finished requests, per tenant — "
            "the chip-time billing meter beside pst_tenant_usage_tokens",
            ["tenant"])
        self.compile_cache_hits = r.counter(
            "pst_engine_compile_cache_hits",
            "Persistent JAX compilation-cache hits (executable deserialized "
            "instead of rebuilt by XLA)")
        self.compile_cache_misses = r.counter(
            "pst_engine_compile_cache_misses",
            "Persistent JAX compilation-cache misses (fresh XLA build, entry "
            "written for the next restart)")
        self.flight_snapshots_persisted = r.counter(
            "pst_engine_flight_snapshots_persisted",
            "Flight-recorder snapshots written to --flight-snapshot-dir "
            "(bounded, oldest-first eviction) so tail-outlier post-mortems "
            "survive process death and restart (docs/observability.md "
            "\"Flight recorder\")")
        self._flight = NULL_FLIGHT_RECORDER
        # Compile events of live steps, until the engine attaches them to
        # the outputs of the step that absorbed them.
        self._pending_compile_events: list = []
        self._compiles = 0
        self._device_busy_s = 0.0
        self._kv_hwm = 0.0
        # (monotonic, kind, tokens) samples of the throughput window.
        self._tok_samples: Deque[Tuple[float, str, int]] = deque()
        self._tok_kinds: set = set()
        self.param_count = 0
        self.peak_flops = 0.0

    # -- model / startup ------------------------------------------------

    def set_model_info(self, param_count: int,
                       device_name: Optional[str] = None) -> None:
        self.param_count = int(param_count)
        self.peak_flops = _PEAK_FLOPS_BY_DEVICE_NAME.get(device_name or "",
                                                         0.0)
        self.start_time_seconds.set(time.time())

    def record_startup_phase(self, phase: str, seconds: float) -> None:
        if self.startup_phases:
            self.startup_seconds.labels(phase=phase).set(max(seconds, 0.0))

    def set_warmup_coverage(self, compiled: int, total: int) -> None:
        self.warmup_buckets.labels(state="total").set(max(total, 0))
        self.warmup_buckets.labels(state="compiled").set(max(compiled, 0))
        self.warmup_coverage.set(compiled / total if total > 0 else 0.0)

    # -- device steps ---------------------------------------------------

    def record_dispatch(self, kind: str, batch_bucket: str, seconds: float,
                        *, first_use: bool, tokens: int = 0,
                        fill_ratio: Optional[float] = None,
                        count_busy: bool = True) -> None:
        """One device step. ``first_use``: the step captured its graph key
        (a compile in the JAX package's terms), timed apart from the
        steady-state steps. ``count_busy=False`` marks warmup steps, which
        serve no request."""
        seconds = max(seconds, 0.0)
        with self._lock:
            if first_use:
                self._compiles += 1
                if count_busy:
                    self._pending_compile_events.append({
                        "kind": kind, "shape_bucket": batch_bucket,
                        "seconds": round(seconds, 3)})
            if tokens > 0:
                now = time.monotonic()
                self._tok_samples.append((now, kind, tokens))
                self._refresh_throughput_locked(now)
            if count_busy:
                self._device_busy_s += seconds
        if count_busy:
            self.device_busy_seconds.inc(seconds)
            self._flight.record_step(kind, batch_bucket, seconds,
                                     compiled=first_use, tokens=tokens)
        if first_use:
            self.compile_total.labels(kind=kind,
                                      shape_bucket=batch_bucket).inc()
            self.compile_seconds.labels(kind=kind).observe(seconds)
        else:
            self.step_duration.labels(kind=kind,
                                      batch_bucket=batch_bucket).observe(
                seconds)
        if fill_ratio is not None:
            self.batch_fill_ratio.labels(kind=kind).observe(
                min(max(fill_ratio, 0.0), 1.0))

    def record_host_gap(self, batch_bucket: str, seconds: float) -> None:
        """The serial host wall between a decode step's fetch and the next
        decode dispatch, which the flight ring's next record carries."""
        self._flight.note_host_gap(seconds)
        self.host_gap_seconds.labels(batch_bucket=batch_bucket).observe(
            max(seconds, 0.0))

    def drain_compile_events(self) -> list:
        """The live compile events since the last drain."""
        with self._lock:
            events, self._pending_compile_events = (
                self._pending_compile_events, [])
        return events

    # -- flight recorder / cost attribution -----------------------------

    def attach_flight(self, recorder) -> None:
        """Make ``recorder`` (``obs/flight.py``) the sink of every live
        step."""
        self._flight = recorder

    def record_request_cost(self, tenant: str, prefill_s: float,
                            decode_s: float) -> None:
        """One finished request's device seconds: the per-phase histogram
        and the tenant's chip-time meter."""
        prefill_s = max(prefill_s, 0.0)
        decode_s = max(decode_s, 0.0)
        if prefill_s > 0:
            self.request_device_seconds.labels(phase="prefill").observe(
                prefill_s)
        if decode_s > 0:
            self.request_device_seconds.labels(phase="decode").observe(
                decode_s)
        total = prefill_s + decode_s
        if total > 0:
            self.tenant_device_seconds.labels(
                tenant=str(tenant or "default")[:64]).inc(total)

    def compile_count(self) -> int:
        with self._lock:
            return self._compiles

    def device_busy(self) -> float:
        """Seconds of live-traffic steps (warmup excluded)."""
        with self._lock:
            return self._device_busy_s

    def _refresh_throughput_locked(self, now: float) -> None:
        cutoff = now - self._TOKEN_WINDOW_S
        while self._tok_samples and self._tok_samples[0][0] < cutoff:
            self._tok_samples.popleft()
        per_kind: Dict[str, int] = {}
        total = 0
        for _, kind, toks in self._tok_samples:
            self._tok_kinds.add(kind)
            per_kind[kind] = per_kind.get(kind, 0) + toks
            total += toks
        span = (max(now - self._tok_samples[0][0], 0.5)
                if self._tok_samples else 1.0)
        # An idle engine reads 0, not its last burst's rate.
        for kind in self._tok_kinds:
            self.tokens_per_second.labels(kind=kind).set(
                per_kind.get(kind, 0) / span)
        if self.param_count and self.peak_flops:
            self.mfu.set(2.0 * self.param_count * (total / span)
                         / self.peak_flops)

    # -- scheduler / KV refresh (from LLMEngine.stats()) ----------------

    def refresh_from_stats(self, stats: dict) -> None:
        occ = float(stats.get("kv_cache_usage_perc", 0.0))
        self.kv_page_occupancy.set(occ)
        with self._lock:
            self._refresh_throughput_locked(time.monotonic())
            self._kv_hwm = max(self._kv_hwm, occ)
            hwm = self._kv_hwm
        self.kv_page_high_watermark.set(hwm)
        self.preemptions.to_total(
            float(stats.get("num_preemptions_total", 0.0)))
        self.swap_out.to_total(float(stats.get("kv_swap_out_total", 0.0)))
        self.swap_in.to_total(float(stats.get("kv_swap_in_total", 0.0)))
        self.compile_cache_hits.to_total(
            float(stats.get("compile_cache_hits_total", 0.0)))
        self.compile_cache_misses.to_total(
            float(stats.get("compile_cache_misses_total", 0.0)))

    def render(self) -> str:
        return self.registry.render()
