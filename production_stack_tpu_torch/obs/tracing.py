"""In-process request tracing (the Dapper/OTel span model).

A copy of the JAX package's ``obs/tracing.py``: spans are plain objects
recorded into a bounded ring of completed request timelines (served at
``GET /debug/requests``) and fed into the
``pst_stage_duration_seconds{component,stage}`` histogram, in the
recorder's own :class:`~.prometheus_text.Registry` (the engine server
renders it on ``/metrics``).

Propagation is W3C Trace Context: a ``traceparent``
(``00-<32 hex trace id>-<16 hex span id>-01``) and ``X-Request-Id`` ride
every hop, so the router's trace continues into the engine's admission,
queue, prefill and decode spans.

Span starts and ends read ``time.monotonic()``; each trace anchors one
wall-clock time at creation for display.

Once ``utils_tracing.init_otel`` installed an OpenTelemetry SDK
provider, every completed span is mirrored into it
(``SpanRecorder._mirror_otel``) with the recorder's own trace and span
ids (``MirroredIdGenerator``), so the exported parent links resolve.

Not ported: the OpenMetrics exemplar that carries the trace id on the
histogram (the port's text exposition has none).
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..logging_utils import init_logger
from .prometheus_text import Registry

logger = init_logger(__name__)

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "X-Request-Id"

# Bounds so a pathological request can never balloon a timeline.
_MAX_SPANS_PER_TRACE = 128
_MAX_EVENTS_PER_SPAN = 32

# Buckets span sub-ms stages (admission) to minutes (long decodes).
STAGE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def error_headers(source=None,
                  extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Headers for an error response: ``X-Request-Id`` plus ``extra``.

    ``source`` is the request id, anything with ``.get`` (a mapping that
    may hold ``"request_id"``) and ``.headers``, or None; with no id to
    be found the header is left out."""
    headers: Dict[str, str] = dict(extra) if extra else {}
    request_id: Optional[str] = None
    if isinstance(source, str):
        request_id = source
    elif source is not None:
        getter = getattr(source, "get", None)
        if getter is not None:
            request_id = getter("request_id")
        if not request_id:
            req_headers = getattr(source, "headers", None)
            if req_headers is not None:
                request_id = req_headers.get(REQUEST_ID_HEADER)
    if request_id:
        headers.setdefault(REQUEST_ID_HEADER, request_id)
    return headers


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C traceparent header, or
    None for anything malformed (a bad header starts a fresh trace, it
    never fails the request)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    _, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace_id.lower(), span_id.lower()


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


# The (trace_id, span_id) ints the OTel mirror forces onto the next SDK
# span, so an exported span carries the recorder's ids.
_FORCED_OTEL_IDS: "contextvars.ContextVar[Optional[Tuple[int, int]]]" = (
    contextvars.ContextVar("pst_forced_otel_ids", default=None))


class MirroredIdGenerator:
    """An OTel SDK id generator (duck-typed ``IdGenerator``): the
    recorder's ids while the mirror replays a span, random ids otherwise.
    ``utils_tracing.init_otel`` installs it."""

    def __init__(self):
        self._rand = random.Random()

    def generate_trace_id(self) -> int:
        forced = _FORCED_OTEL_IDS.get()
        if forced is not None:
            return forced[0]
        return self._rand.getrandbits(128) or 1

    def generate_span_id(self) -> int:
        forced = _FORCED_OTEL_IDS.get()
        if forced is not None:
            return forced[1]
        return self._rand.getrandbits(64) or 1


class Span:
    """One named stage of a request. ``end()`` is idempotent and feeds the
    stage-duration histogram."""

    __slots__ = (
        "name", "span_id", "parent_id", "start_mono", "end_mono",
        "attributes", "events", "_trace",
    )

    def __init__(
        self,
        trace: "RequestTrace",
        name: str,
        parent_id: Optional[str],
        attributes: Optional[dict] = None,
        start_mono: Optional[float] = None,
    ):
        self._trace = trace
        self.name = name
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.start_mono = (start_mono if start_mono is not None
                           else time.monotonic())
        self.end_mono: Optional[float] = None
        self.attributes: dict = dict(attributes) if attributes else {}
        self.events: List[dict] = []

    def set_attribute(self, key: str, value) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attrs) -> None:
        if len(self.events) >= _MAX_EVENTS_PER_SPAN:
            return
        self.events.append({
            "name": name,
            "at_ms": round((time.monotonic() - self._trace.t0_mono) * 1000.0,
                           3),
            "attributes": attrs,
        })

    @property
    def duration_s(self) -> Optional[float]:
        if self.end_mono is None:
            return None
        return self.end_mono - self.start_mono

    def end(self, end_mono: Optional[float] = None) -> None:
        if self.end_mono is not None:
            return
        self.end_mono = end_mono if end_mono is not None else time.monotonic()
        self._trace._on_span_end(self)

    def to_dict(self, t0_mono: float) -> dict:
        end = self.end_mono if self.end_mono is not None else time.monotonic()
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ms": round((self.start_mono - t0_mono) * 1000.0, 3),
            "duration_ms": round((end - self.start_mono) * 1000.0, 3),
            "attributes": self.attributes,
            "events": self.events,
        }


class RequestTrace:
    """All spans of one request on this component, rooted at ``root``.

    ``finish()`` ends the root span and flushes the timeline to the
    recorder's ring; it is idempotent, so a handler may call it in a
    ``finally`` however it exited."""

    def __init__(
        self,
        recorder: "SpanRecorder",
        request_id: str,
        name: str = "request",
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        attributes: Optional[dict] = None,
    ):
        self.recorder = recorder
        self.request_id = request_id
        self.trace_id = trace_id or new_trace_id()
        self.t0_mono = time.monotonic()
        self.t0_wall = time.time()
        self.spans: List[Span] = []
        self._finished = False
        self.root = self.span(
            name, parent_id=parent_span_id, attributes=attributes
        )

    def span(
        self,
        name: str,
        parent: Optional[Span] = None,
        attributes: Optional[dict] = None,
        parent_id: Optional[str] = None,
    ) -> Span:
        """Start a child span (of ``parent``, by default the root)."""
        if parent_id is None:
            parent_id = (
                parent.span_id if parent is not None
                else (self.root.span_id if self.spans else None)
            )
        s = Span(self, name, parent_id, attributes)
        if len(self.spans) < _MAX_SPANS_PER_TRACE:
            self.spans.append(s)
        return s

    def record_span(
        self,
        name: str,
        duration_s: float,
        end_mono: Optional[float] = None,
        parent: Optional[Span] = None,
        attributes: Optional[dict] = None,
    ) -> Span:
        """Record a stage that already elapsed (the server lays queue,
        prefill and decode out from the engine's timings after the
        fact)."""
        end = end_mono if end_mono is not None else time.monotonic()
        s = self.span(name, parent=parent, attributes=attributes)
        s.start_mono = end - max(duration_s, 0.0)
        s.end(end_mono=end)
        return s

    def add_event(self, name: str, **attrs) -> None:
        self.root.add_event(name, **attrs)

    def _on_span_end(self, span: Span) -> None:
        self.recorder.observe_stage(span.name, span.duration_s or 0.0)
        self.recorder._mirror_otel(self, span)

    def finish(self, status: Optional[int] = None) -> None:
        if self._finished:
            return
        self._finished = True
        if status is not None:
            self.root.set_attribute("http.status_code", status)
        self.root.end()
        self.recorder._flush(self)

    def to_dict(self) -> dict:
        end = self.root.end_mono or time.monotonic()
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "component": self.recorder.component,
            "start_time": self.t0_wall,
            "duration_ms": round((end - self.root.start_mono) * 1000.0, 3),
            "status": self.root.attributes.get("http.status_code"),
            "spans": [s.to_dict(self.t0_mono) for s in self.spans],
        }


class _NoopSpan:
    """Inert span: call sites need no ``if span is not None`` guards."""

    __slots__ = ()
    name = ""
    span_id = ""
    parent_id = None
    attributes: dict = {}
    events: list = []
    duration_s = None

    def set_attribute(self, key, value):
        return self

    def add_event(self, name, **attrs):
        pass

    def end(self, end_mono=None):
        pass


class _NoopTrace:
    """Inert trace, returned when tracing is off."""

    __slots__ = ()
    trace_id = ""
    request_id = ""
    root = _NoopSpan()
    spans: list = []

    def span(self, name, parent=None, attributes=None, parent_id=None):
        return NOOP_SPAN

    def record_span(self, name, duration_s, end_mono=None, parent=None,
                    attributes=None):
        return NOOP_SPAN

    def add_event(self, name, **attrs):
        pass

    def finish(self, status=None):
        pass


NOOP_SPAN = _NoopSpan()
NOOP_TRACE = _NoopTrace()


class SpanRecorder:
    """A component's span sink: the stage histogram and a bounded ring of
    completed request timelines for ``/debug/requests``.

    ``enabled`` gates tracing wholesale (spans, the histogram); ``buffer``
    sizes the ring only: 0 turns the endpoint off while tracing runs on."""

    def __init__(self, component: str, buffer: int = 256,
                 enabled: bool = True):
        self.component = component
        self.enabled = bool(enabled)
        self.buffer_size = max(buffer, 0)
        self._ring: "deque[dict]" = deque(maxlen=max(self.buffer_size, 1))
        self._lock = threading.Lock()
        self.registry = Registry()
        self.stage_duration = self.registry.histogram(
            "pst_stage_duration_seconds",
            "Per-stage request latency decomposition (span durations by "
            "stage)", STAGE_BUCKETS, ["component", "stage"])

    @property
    def debug_endpoint_enabled(self) -> bool:
        """Whether ``GET /debug/requests`` serves (else 404): tracing on
        and a ring of at least one timeline."""
        return self.enabled and self.buffer_size > 0

    def observe_stage(self, stage: str, seconds: float) -> None:
        """One stage duration (a negative one counts as 0)."""
        self.stage_duration.labels(component=self.component,
                                   stage=stage).observe(max(seconds, 0.0))

    def trace(
        self,
        request_id: str,
        headers=None,
        name: str = "request",
        attributes: Optional[dict] = None,
    ) -> RequestTrace:
        """The root trace of one request, joining the caller's trace when
        ``headers`` carry a valid ``traceparent``."""
        if not self.enabled:
            return NOOP_TRACE
        trace_id = parent_span = None
        if headers is not None:
            parsed = parse_traceparent(headers.get(TRACEPARENT_HEADER))
            if parsed is not None:
                trace_id, parent_span = parsed
        return RequestTrace(
            self, request_id, name=name, trace_id=trace_id,
            parent_span_id=parent_span, attributes=attributes,
        )

    def _flush(self, trace: RequestTrace) -> None:
        if self.buffer_size <= 0:
            return
        with self._lock:
            self._ring.append(trace.to_dict())

    def timelines(
        self, limit: Optional[int] = None, request_id: Optional[str] = None
    ) -> List[dict]:
        """Completed request timelines, most recent first."""
        with self._lock:
            items = list(self._ring)
        items.reverse()
        if request_id is not None:
            items = [t for t in items if t["request_id"] == request_id]
        if limit is not None and limit >= 0:
            items = items[:limit]
        return items

    # -- the OTel mirror ---------------------------------------------------

    def _mirror_otel(self, trace: RequestTrace, span: Span) -> None:
        """Replay a completed span into the OTel SDK, once
        ``utils_tracing.init_otel`` installed it. Best effort: an SDK
        failure is logged and swallowed, the recorder stays the record."""
        from ..utils_tracing import otel_active

        if not otel_active():
            return
        try:
            from opentelemetry import trace as ot
            from opentelemetry.trace import (
                NonRecordingSpan,
                SpanContext,
                TraceFlags,
                set_span_in_context,
            )

            ctx = None
            if span.parent_id:
                ctx = set_span_in_context(NonRecordingSpan(SpanContext(
                    trace_id=int(trace.trace_id, 16),
                    span_id=int(span.parent_id, 16),
                    is_remote=False, trace_flags=TraceFlags(0x01))))
            start_wall = trace.t0_wall + (span.start_mono - trace.t0_mono)
            end_wall = trace.t0_wall + (
                (span.end_mono or span.start_mono) - trace.t0_mono)
            attrs = {k: v for k, v in span.attributes.items()
                     if isinstance(v, (str, bool, int, float))}
            attrs["pst.request_id"] = trace.request_id
            attrs["pst.trace_id"] = trace.trace_id
            token = _FORCED_OTEL_IDS.set(
                (int(trace.trace_id, 16), int(span.span_id, 16)))
            try:
                otspan = ot.get_tracer("production_stack_tpu").start_span(
                    span.name, context=ctx,
                    start_time=int(start_wall * 1e9), attributes=attrs)
            finally:
                _FORCED_OTEL_IDS.reset(token)
            for ev in span.events:
                otspan.add_event(
                    ev["name"],
                    {k: v for k, v in ev["attributes"].items()
                     if isinstance(v, (str, bool, int, float))},
                    # The event's own wall time, not the span's end.
                    timestamp=int((trace.t0_wall + ev["at_ms"] / 1000.0)
                                  * 1e9))
            otspan.end(end_time=int(end_wall * 1e9))
        except Exception as e:  # mirroring is best effort
            logger.debug("otel span mirror failed: %s", e)


def debug_requests_payload(recorder: SpanRecorder, query: dict) -> tuple:
    """``(status, body)`` of ``GET /debug/requests`` (the JAX
    ``obs/http.py::debug_requests_response`` contract): 404 with tracing
    off or a ring of 0; else the timelines, most recent first, at most
    ``limit`` (default 50) and only ``request_id``'s when given."""
    if not recorder.debug_endpoint_enabled:
        return 404, {"error": {
            "message": "request tracing timelines are disabled "
                       "(--no-tracing or --debug-requests-buffer 0)",
            "type": "not_found_error", "code": 404}}
    try:
        limit = int(query.get("limit", "50"))
    except ValueError:
        limit = 50
    return 200, {
        "component": recorder.component,
        "buffer_size": recorder.buffer_size,
        "requests": recorder.timelines(
            limit=limit, request_id=query.get("request_id")),
    }
