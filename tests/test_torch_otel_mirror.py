"""The OpenTelemetry and Sentry mirrors, the port's against the JAX
package's.

A fake OpenTelemetry SDK (``tests/test_observability.py``'s, with a
provider that takes the ``id_generator`` and spans that draw their ids
from it, as the SDK's do) stands in for the real one, which neither
this machine nor the card's has. One traced completion through each
package's server exports spans of the same names, in the traceparent's
trace, whose parent links resolve to exported spans (the root's to the
caller's span). Without an endpoint or an SDK neither package installs
a provider; a fake ``sentry_sdk`` is called with the JAX package's
arguments, from the port's ``main`` too. Both packages' OTel state is
reset around each test.
"""

import sys
import time
import types

import pytest

from production_stack_tpu import utils_tracing as jax_tracing
from production_stack_tpu.obs.tracing import SpanRecorder as JaxRecorder
from production_stack_tpu_torch import utils_tracing as port_tracing
from production_stack_tpu_torch.engine import server as port_server
from production_stack_tpu_torch.obs.tracing import (
    MirroredIdGenerator,
    SpanRecorder,
)

from .test_observability import _install_fake_otel
from .test_torch_tracing import BODY, PARENT, TRACE_ID, TRACEPARENT, _call
from .test_torch_tracing import servers  # noqa: F401 (a fixture)

ENDPOINT = "http://collector.invalid:4317"


@pytest.fixture(autouse=True)
def fresh_otel_state():
    for pkg in (jax_tracing, port_tracing):
        pkg.reset_otel_state_for_tests()
    yield
    for pkg in (jax_tracing, port_tracing):
        pkg.reset_otel_state_for_tests()


def _install_sdk(monkeypatch) -> dict:
    """The fake SDK, its provider keeping the id generator it is given,
    its spans drawing their ids from it: a child keeps its parent's trace
    id, a root draws one."""
    record = {"spans": [], "providers": []}
    _install_fake_otel(monkeypatch, record)
    trace_mod = sys.modules["opentelemetry.trace"]
    ids = {}

    class TracerProvider:
        def __init__(self, resource=None, id_generator=None):
            self.resource, self.processors = resource, []
            ids["gen"] = id_generator

        def add_span_processor(self, p):
            self.processors.append(p)

    class Tracer:
        def start_span(self, name, context=None, start_time=None,
                       attributes=None):
            span = types.SimpleNamespace(
                name=name, context=context, start_time=start_time,
                attributes=attributes, events=[], end_time=None)
            gen = ids["gen"]
            parent = context["parent"].ctx if context else None
            span.trace_id = (parent.trace_id if parent
                             else gen.generate_trace_id())
            span.span_id = gen.generate_span_id()
            span.parent_id = parent.span_id if parent else None
            span.add_event = lambda n, a=None, timestamp=None: (
                span.events.append((n, a, timestamp)))
            span.end = lambda end_time=None: setattr(span, "end_time",
                                                     end_time)
            record["spans"].append(span)
            return span

    monkeypatch.setattr(sys.modules["opentelemetry.sdk.trace"],
                        "TracerProvider", TracerProvider)
    monkeypatch.setattr(trace_mod, "get_tracer", lambda name: Tracer())
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", ENDPOINT)
    return record


def _exported(record, port: int) -> list:
    """The spans one traced completion on ``port`` exports (its root,
    ``engine_request``, ends last)."""
    record["spans"].clear()
    status, _, _ = _call(port, "POST", "/v1/completions", BODY,
                         {"traceparent": TRACEPARENT})
    assert status == 200
    t0 = time.monotonic()
    while time.monotonic() - t0 < 10:
        if any(s.name == "engine_request" for s in record["spans"]):
            break
        time.sleep(0.01)
    return list(record["spans"])


def test_a_traced_request_exports_the_jax_servers_spans(servers,  # noqa: F811
                                                        monkeypatch):
    ports, _ = servers
    record = _install_sdk(monkeypatch)
    got = {}
    # One package's provider at a time, as in a serving process.
    for side, pkg in (("jax", jax_tracing), ("port", port_tracing)):
        pkg.reset_otel_state_for_tests()
        assert pkg.init_otel("pst-engine")
        got[side] = _exported(record, ports[side]["traced"])
        pkg.reset_otel_state_for_tests()
    assert len(record["providers"]) == 2
    names = {side: sorted(s.name for s in spans)
             for side, spans in got.items()}
    assert names["port"] == names["jax"]
    assert {"engine_request", "engine_queue", "prefill",
            "decode"} <= set(names["port"])
    for side, spans in got.items():
        own = {s.span_id for s in spans}
        for s in spans:
            assert s.trace_id == int(TRACE_ID, 16), side
            assert s.attributes["pst.trace_id"] == TRACE_ID, side
            if s.name == "engine_request":
                assert s.parent_id == int(PARENT, 16), side
            else:
                assert s.parent_id in own, (side, s.name)
            assert s.start_time <= s.end_time, (side, s.name)


def test_no_endpoint_or_no_sdk_installs_nothing(monkeypatch):
    record = {"spans": [], "providers": []}
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    _install_fake_otel(monkeypatch, record)
    for pkg in (jax_tracing, port_tracing):
        assert pkg.init_otel("pst-engine") is False
        assert pkg.otel_active() is False
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", ENDPOINT)
    monkeypatch.setitem(sys.modules, "opentelemetry", None)
    for pkg in (jax_tracing, port_tracing):
        assert pkg.init_otel("pst-engine") is False
        assert pkg.otel_active() is False
    assert record["providers"] == []
    # Spans end without touching an SDK.
    for recorder in (JaxRecorder("engine", buffer=4),
                     SpanRecorder("engine", buffer=4)):
        trace = recorder.trace("req-quiet")
        trace.span("prefill").end()
        trace.finish(status=200)
    assert record["spans"] == []


def test_init_sentry_calls_the_sdk_as_the_jax_package(monkeypatch):
    calls = []
    fake = types.ModuleType("sentry_sdk")
    fake.init = lambda **kw: calls.append(kw)
    monkeypatch.setitem(sys.modules, "sentry_sdk", fake)
    for pkg in (jax_tracing, port_tracing):
        assert pkg.init_sentry(None) is False
        assert pkg.init_sentry("https://key@sentry.invalid/1") is True
    assert len(calls) == 2 and calls[0] == calls[1] == {
        "dsn": "https://key@sentry.invalid/1", "traces_sample_rate": 0.0,
        "profile_session_sample_rate": 0.0}
    monkeypatch.setitem(sys.modules, "sentry_sdk", None)
    assert port_tracing.init_sentry("https://key@sentry.invalid/1") is False
    # The port's main starts both mirrors before it builds the engine.
    started = []
    monkeypatch.setattr(port_server, "init_sentry", started.append)
    monkeypatch.setattr(port_server, "init_otel", started.append)

    class Built(Exception):
        pass

    def engine(cfg):
        raise Built

    monkeypatch.setattr(port_server, "AsyncLLMEngine", engine)
    monkeypatch.setattr(port_server, "configure_logging",
                        lambda *a, **kw: None)  # process-wide otherwise
    with pytest.raises(Built):
        port_server.main(["--device", "cpu", "--model", "tiny-llama-debug",
                          "--sentry-dsn", "https://key@sentry.invalid/1"])
    assert started == ["https://key@sentry.invalid/1", "pst-engine"]


def test_the_id_generator_replays_forced_ids():
    from production_stack_tpu_torch.obs import tracing

    gen = MirroredIdGenerator()
    assert gen.generate_trace_id() > 0 and gen.generate_span_id() > 0
    token = tracing._FORCED_OTEL_IDS.set((5, 7))
    try:
        assert (gen.generate_trace_id(), gen.generate_span_id()) == (5, 7)
    finally:
        tracing._FORCED_OTEL_IDS.reset(token)
