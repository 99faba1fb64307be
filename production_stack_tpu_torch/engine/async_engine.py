"""Thread-safe façade over :class:`LLMEngine` for the HTTP server.

The device step loop runs on a dedicated thread; each request gets a
``queue.Queue`` the step thread feeds with its :class:`RequestOutput`s,
which a server thread consumes as an iterator. Submissions and aborts go
through mailboxes the step thread drains, so a server thread never waits
on a device step to enqueue work.

Sleep and wake (the JAX package's ``/sleep`` and ``/wake_up``): sleeping
pauses the step loop; level 2 also drops the KV cache and the step graphs
that hold its address, and forgets the prefix map. The step thread owns
the stream, the captures and the cache, so a sleep or a wake is posted to
it through a mailbox and the caller waits for it: no step or capture
interleaves with a drop or a restore. A wake from level 2 runs the
configured warmup again. Draining only closes the HTTP admission gate.
LoRA loads and unloads run on the step thread the same way: an adapter's
write into the bank (or a retired slot's zeroing) queues between two
dispatches, never beside a capture. So does an encode
(``/v1/embeddings``): it runs eagerly on the steps' stream, and never
interleaves with a graph replay or a pipelined burst's refresh.

The loop steps while the engine has work, and an in-flight pipelined
burst is work: its rows are applied even once every queue is empty. A
step that raises snapshots the flight recorder before every request is
failed.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional, Sequence as Seq

import numpy as np

from ..logging_utils import init_logger
from .config import EngineConfig
from .engine import LLMEngine, RequestOutput
from .sequence import SamplingParams

logger = init_logger(__name__)

# Ends a request's stream without a finish: the request was aborted, by
# its caller or a level-2 sleep (the JAX engine's sentinel).
_SENTINEL = object()


class AsyncLLMEngine:
    def __init__(self, cfg: EngineConfig, params: Optional[Dict[str, Any]] = None):
        self.engine = LLMEngine(cfg, params)
        self._work = threading.Event()
        self._stop = False
        self._queues: Dict[str, "queue.Queue"] = {}
        self._thread: Optional[threading.Thread] = None
        self._submit_lock = threading.Lock()
        self._pending_adds: list = []
        self._pending_aborts: list = []
        # (fn, done event, [exception]) run on the step thread: sleep, wake.
        self._pending_calls: list = []
        self.step_error: Optional[str] = None
        # Warmup gate (engine/precompile.py): the step thread captures the
        # shape-bucket lattice before its first step (and again on a wake
        # from level 2); /ready answers 503 until this flips. /health
        # stays green (liveness != readiness).
        self._warming = cfg.warmup != "off"
        self.warmup_error: Optional[str] = None
        self._sleeping = False
        self._sleep_level = 0
        self._draining = False

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="engine-step-loop", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._stop = True
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self.engine.shutdown()  # the tiers' worker threads

    def is_healthy(self) -> bool:
        return (
            self.step_error is None
            and self._thread is not None
            and self._thread.is_alive()
        )

    @property
    def warming(self) -> bool:
        """True while the startup warmup pass is still running."""
        return self._warming

    @property
    def ready(self) -> bool:
        """Readiness (the /ready contract): healthy, warmed, awake and
        accepting work."""
        return (self.is_healthy() and not self._warming
                and not self._sleeping and not self._draining)

    # -- sleep / wake -----------------------------------------------------

    @property
    def sleeping(self) -> bool:
        return self._sleeping

    def sleep(self, level: int = 1) -> None:
        """Pause the step loop; level 2 also frees the KV cache and the
        step graphs, aborts every request in flight and ends their
        streams. Returns once the step thread has done so."""
        self.on_step_thread(lambda: self._sleep(level))
        logger.info("engine sleeping (level %d)", level)

    def wake_up(self) -> None:
        """Resume the step loop. After level 2 the cache is restored
        (zeroed) before this returns, and the configured warmup runs
        next on the step thread (``warming`` meanwhile)."""
        self.on_step_thread(self._wake_up)
        logger.info("engine awake")

    def _sleep(self, level: int) -> None:
        self._sleeping = True
        if level >= 2 and self._sleep_level < 2:
            # The dropped pages are what the prefix map points at: forget
            # them, or a later prompt adopts zeroed pages as cache hits.
            # This drains an in-flight burst first, which writes into the
            # cache about to be dropped.
            self.engine.clear_kv_state()
            self.engine.runner.drop_kv_cache()
            for q in list(self._queues.values()):
                q.put(_SENTINEL)
        self._sleep_level = max(self._sleep_level, level)

    def _wake_up(self) -> None:
        if self._sleep_level >= 2:
            self.engine.runner.restore_kv_cache()
            # Before sleeping flips: /ready never reads ready in between.
            self._warming = self.engine.cfg.warmup != "off"
        self._sleep_level = 0
        self._sleeping = False
        self._work.set()

    def on_step_thread(self, fn) -> None:
        """Run ``fn`` on the step thread between two steps and wait for it
        (inline when no step thread runs); its exception is raised here.
        Sleep, wake and the server's profiler start and stop run so."""
        thread = self._thread
        if thread is None or not thread.is_alive():
            fn()
            return
        done, error = threading.Event(), []
        with self._submit_lock:
            self._pending_calls.append((fn, done, error))
        self._work.set()
        while not done.wait(timeout=0.1):
            if not thread.is_alive():
                raise RuntimeError("the engine step loop stopped")
        if error:
            raise error[0]

    # -- LoRA -------------------------------------------------------------

    def load_lora(self, name: str, path: Optional[str] = None):
        """``LLMEngine.load_lora`` on the step thread; its errors raise
        here."""
        out = []
        self.on_step_thread(lambda: out.append(self.engine.load_lora(name, path)))
        return out[0]

    def unload_lora(self, name: str) -> bool:
        """``LLMEngine.unload_lora`` on the step thread."""
        out = []
        self.on_step_thread(lambda: out.append(self.engine.unload_lora(name)))
        return out[0]

    # -- embeddings -------------------------------------------------------

    def encode(self, token_ids) -> np.ndarray:
        """``ModelRunner.encode`` of one prompt, its input checked here
        (``ValueError``) and its dispatch run on the step thread between
        two steps, as the JAX runner holds its device lock around one."""
        runner = self.engine.runner
        toks, n = runner.encode_input(token_ids)
        out = []
        self.on_step_thread(lambda: out.append(runner.encode_dispatch(toks, n)))
        return out[0]

    # -- drain ------------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Stop admitting new requests (the server's gate); those in
        flight run to completion."""
        self._draining = True
        logger.info("engine draining (in-flight requests will finish)")

    def undrain(self) -> None:
        self._draining = False
        logger.info("engine accepting new requests again")

    def num_inflight(self) -> int:
        """Requests running, waiting, parked (swapped out: a drain that
        ignored them would end with generations parked mid-flight), or
        submitted and not yet taken by the step thread."""
        sched = self.engine.scheduler
        with self._submit_lock:
            pending = len(self._pending_adds)
        return int(sched.num_running + sched.num_waiting + sched.num_swapped
                   + pending)

    # -- submission -------------------------------------------------------

    def generate(
        self,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[Seq[int]] = None,
        sampling: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        lora_name: Optional[str] = None,
        deadline: Optional[float] = None,
        tenant: Optional[str] = None,
        tenant_class: Optional[str] = None,
        kv_transfer: Optional[dict] = None,
    ) -> Iterator[RequestOutput]:
        """Submit one request now and return the iterator of its outputs,
        which ends with its finish (``lora_name``, ``deadline``,
        ``tenant``, ``tenant_class`` and ``kv_transfer`` as
        ``LLMEngine.add_request`` takes them). Requests
        submitted back to back reach the same step's admission. The
        iterator raises ValueError if the engine refuses the request (e.g.
        a prompt that does not fit) and RuntimeError if an engine step
        failed; closed early, it aborts the request."""
        rid = request_id or f"req-{uuid.uuid4().hex[:16]}"
        q: "queue.Queue" = queue.Queue()
        if self.step_error is not None:
            q.put(RuntimeError(f"engine is failed: {self.step_error}"))
            return self._outputs(rid, q)
        self._queues[rid] = q
        with self._submit_lock:
            self._pending_adds.append(
                (rid, dict(prompt=prompt, prompt_token_ids=prompt_token_ids,
                           sampling=sampling, arrival_time=time.monotonic(),
                           lora_name=lora_name, deadline=deadline,
                           tenant=tenant,
                           tenant_class=tenant_class,
                           kv_transfer=kv_transfer))
            )
        self._work.set()
        return self._outputs(rid, q)

    def _outputs(self, rid: str, q: "queue.Queue") -> Iterator[RequestOutput]:
        finished = False
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    finished = True  # aborted: nothing to reclaim
                    break
                if isinstance(item, Exception):
                    finished = True  # refused or failed: nothing to reclaim
                    raise item
                yield item
                if item.finished:
                    finished = True
                    break
        finally:
            self._queues.pop(rid, None)
            if not finished:  # the consumer went away mid-stream
                self.abort(rid)

    def abort(self, request_id: str) -> None:
        """Abort a request; its iterator, if still read, ends."""
        with self._submit_lock:
            self._pending_aborts.append(request_id)
        self._work.set()
        q = self._queues.pop(request_id, None)
        if q is not None:
            q.put(_SENTINEL)

    # -- engine thread ----------------------------------------------------

    def _drain_mailboxes(self) -> None:
        with self._submit_lock:
            adds, self._pending_adds = self._pending_adds, []
            aborts, self._pending_aborts = self._pending_aborts, []
            calls, self._pending_calls = self._pending_calls, []
        for rid in aborts:
            self.engine.abort_request(rid)
        for rid, kwargs in adds:
            q = self._queues.get(rid)
            if q is None:  # the client already left
                continue
            try:
                self.engine.add_request(rid, **kwargs)
            except Exception as e:  # noqa: BLE001 — per-request error
                logger.warning("add_request %s failed: %s", rid, e)
                q.put(e)
        for fn, done, error in calls:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — raised to the caller
                logger.exception("engine call failed")
                error.append(e)
            done.set()

    def _warm_up(self) -> None:
        # On the step thread: the HTTP threads keep answering /health and
        # /ready, and no step interleaves with a warmup capture.
        self.warmup_error = None
        try:
            self.engine.precompile()
        except Exception as e:  # noqa: BLE001 — serve anyway: the
            # buckets that were captured replay, the rest capture on
            # first use (where an error fails the step); readiness still
            # flips so the server is not wedged.
            logger.exception("warmup failed")
            self.warmup_error = str(e)
        self._warming = False

    def _run(self) -> None:
        logger.info("engine step loop started")
        while not self._stop:
            if self._warming:
                self._warm_up()
            self._drain_mailboxes()
            if self._sleeping or not self.engine.has_work():
                self._work.wait(timeout=0.05)
                self._work.clear()
                continue
            try:
                outputs = self.engine.step()
            except Exception as e:  # noqa: BLE001 — surface via /health
                logger.exception("engine step failed")
                # The post-mortem before the teardown: the ring's tail
                # ends with the failing step (served at /debug/flight
                # while the process lives, and in the log after).
                try:
                    snap = self.engine.flight.snapshot(
                        "fatal", detail={"error": str(e)})
                    logger.error(
                        "flight snapshot (fatal): %d steps recorded, tail=%s",
                        snap["total_steps"], snap["records"][-3:])
                except Exception:  # noqa: BLE001 — never mask the error
                    logger.exception("flight snapshot failed")
                self.step_error = str(e)
                self.engine.abort_all_requests()
                # Every waiting request fails loudly (its generate raises),
                # rather than ending as if it had finished.
                err = RuntimeError(f"engine step failed: {e}")
                for q in list(self._queues.values()):
                    q.put(err)
                continue
            for out in outputs:
                q = self._queues.get(out.request_id)
                if q is not None:
                    q.put(out)
