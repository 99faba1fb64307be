"""Thread-safe façade over :class:`LLMEngine` for the HTTP server.

The device step loop runs on a dedicated thread; each request gets a
``queue.Queue`` the step thread feeds with its :class:`RequestOutput`s,
which a server thread consumes as an iterator. Submissions and aborts go
through mailboxes the step thread drains, so a server thread never waits
on a device step to enqueue work.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional, Sequence as Seq

from ..logging_utils import init_logger
from .config import EngineConfig
from .engine import LLMEngine, RequestOutput
from .sequence import SamplingParams

logger = init_logger(__name__)

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
        self.step_error: Optional[str] = None
        # Warmup gate (engine/precompile.py): the step thread captures the
        # shape-bucket lattice before its first step; /ready answers 503
        # until this flips. /health stays green (liveness != readiness).
        self._warming = cfg.warmup != "off"
        self.warmup_error: Optional[str] = None

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
        """Readiness (the /ready contract): healthy and warmed."""
        return self.is_healthy() and not self._warming

    # -- submission -------------------------------------------------------

    def generate(
        self,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[Seq[int]] = None,
        sampling: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
    ) -> Iterator[RequestOutput]:
        """Submit one request and yield its outputs until it finishes.
        Raises ValueError if the engine refuses the request (e.g. a prompt
        that does not fit) and RuntimeError if an engine step failed."""
        if self.step_error is not None:
            raise RuntimeError(f"engine is failed: {self.step_error}")
        rid = request_id or f"req-{uuid.uuid4().hex[:16]}"
        q: "queue.Queue" = queue.Queue()
        self._queues[rid] = q
        finished = False
        try:
            with self._submit_lock:
                self._pending_adds.append(
                    (rid, dict(prompt=prompt, prompt_token_ids=prompt_token_ids,
                               sampling=sampling, arrival_time=time.monotonic()))
                )
            self._work.set()
            while True:
                item = q.get()
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
        with self._submit_lock:
            self._pending_aborts.append(request_id)
        self._work.set()

    # -- engine thread ----------------------------------------------------

    def _drain_mailboxes(self) -> None:
        with self._submit_lock:
            adds, self._pending_adds = self._pending_adds, []
            aborts, self._pending_aborts = self._pending_aborts, []
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

    def _run(self) -> None:
        logger.info("engine step loop started")
        if self._warming:
            # Warm up on the step thread: the HTTP threads keep answering
            # /health and /ready, and no step interleaves with a warmup
            # capture.
            try:
                self.engine.precompile()
            except Exception as e:  # noqa: BLE001 — serve anyway: the
                # buckets that were captured replay, the rest capture on
                # first use (where an error fails the step); readiness
                # still flips so the server is not wedged.
                logger.exception("warmup failed")
                self.warmup_error = str(e)
            self._warming = False
        while not self._stop:
            self._drain_mailboxes()
            if not self.engine.has_work():
                self._work.wait(timeout=0.05)
                self._work.clear()
                continue
            try:
                outputs = self.engine.step()
            except Exception as e:  # noqa: BLE001 — surface via /health
                logger.exception("engine step failed")
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
