"""The port's request tracing, ``/debug/requests``, ``/debug/profile`` and
JSON log lines against the JAX server's, on the CPU.

A JAX server (aiohttp, on its own event loop thread) and the port's
server serve ``tiny-llama-debug`` from the same weights
(``params_from_jax``), each under three sets of flags: the defaults with
``--profiling``, ``--no-tracing``, and ``--debug-requests-buffer 0``. The
same requests to both must give the same timelines (span names and
parentage, the joined trace id, attributes, statuses), the same
``X-Request-Id`` answers, the same growth of
``pst_stage_duration_seconds_count`` and the same answers of the debug
routes. On the CPU the JAX engine compiles on a shape's first use and
the port's captures nothing, so ``compile`` events are left out.
"""

import asyncio
import http.client
import json
import logging
import re
import threading

import jax
import numpy as np
import pytest
from aiohttp import web

from production_stack_tpu.engine import server as jax_server
from production_stack_tpu.engine.async_engine import (
    AsyncLLMEngine as JaxAsyncLLMEngine,
)
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.server import create_engine_app as jax_app
from production_stack_tpu.obs import logging as jax_logging
from production_stack_tpu.obs import render_obs_metrics
from production_stack_tpu.obs.tracing import (
    parse_traceparent as jax_parse_traceparent,
)
from production_stack_tpu_torch.engine import server as port_server
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.obs import logging as port_logging
from production_stack_tpu_torch.obs.tracing import (
    format_traceparent,
    parse_traceparent,
)

from .test_torch_admin_routes import COMMON, MODEL

TRACE_ID, PARENT = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
TRACEPARENT = format_traceparent(TRACE_ID, PARENT)
BODY = {"model": MODEL, "prompt": "Trace me.", "max_tokens": 4,
        "temperature": 0.0, "ignore_eos": True}
# (name, create_engine_app keywords) of each server on each side.
APPS = (("traced", dict(profiling=True)), ("off", dict(tracing=False)),
        ("no_ring", dict(debug_requests_buffer=0)))


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    out = json.loads(raw) if raw.startswith((b"{", b"[")) else raw
    return resp.status, out, {k.lower(): v for k, v in resp.getheaders()}


@pytest.fixture(scope="module")
def servers():
    """({"jax": {app name: port}, "port": {...}}, {side: LLMEngine}): the
    servers of each side over one engine."""
    jeng = JaxAsyncLLMEngine(JaxEngineConfig(**COMMON))
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jeng.engine.runner.params))
    loop = asyncio.new_event_loop()
    started, ports, runners = threading.Event(), {}, []

    def run_jax():
        asyncio.set_event_loop(loop)
        jeng.start(loop)
        for name, kw in APPS:
            runner = web.AppRunner(jax_app(jeng, **kw))
            loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "127.0.0.1", 0)
            loop.run_until_complete(site.start())
            ports[name] = site._server.sockets[0].getsockname()[1]
            runners.append(runner)
        started.set()
        loop.run_forever()
        for runner in runners:
            loop.run_until_complete(runner.cleanup())

    jthread = threading.Thread(target=run_jax, daemon=True)
    jthread.start()
    assert started.wait(timeout=60)
    engine = AsyncLLMEngine(EngineConfig(device="cpu", **COMMON),
                            params=params)
    served = {name: serve_in_thread(engine, **kw) for name, kw in APPS}
    yield ({"jax": ports,
            "port": {n: s.server_address[1] for n, (s, _) in served.items()}},
           {"jax": jeng.engine, "port": engine.engine})
    for server, thread in served.values():
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    engine.shutdown()
    loop.call_soon_threadsafe(loop.stop)
    jthread.join(timeout=10)
    jeng.shutdown()


def _stage_counts(text: str) -> dict:
    pat = re.compile(r'^pst_stage_duration_seconds_count\{component="engine",'
                     r'stage="([a-z_]+)"\} ([0-9.e+]+)$', re.M)
    return {stage: float(n) for stage, n in pat.findall(text)}


def _error(body: dict) -> tuple:
    """(message, type) of an error answer: the JAX server's flat body or
    the port's OpenAI one."""
    err = body.get("error", body)
    return err["message"], err["type"]


def _counts(side: str, ports: dict) -> dict:
    if side == "jax":  # the JAX package's shared registry
        return _stage_counts(render_obs_metrics().decode())
    return _stage_counts(_call(ports["traced"], "GET", "/metrics")[1].decode())


def _shape(timeline: dict) -> dict:
    """A timeline without its ids, times and compile events."""
    spans = timeline["spans"]
    ids = {s["span_id"]: s["name"] for s in spans}
    return {
        "request_id": timeline["request_id"],
        "trace_id": timeline["trace_id"],
        "component": timeline["component"],
        "status": timeline["status"],
        "spans": [(s["name"], ids.get(s["parent_id"], s["parent_id"]),
                   s["attributes"],
                   [(e["name"], e["attributes"]) for e in s["events"]
                    if e["name"] != "compile"])
                  for s in spans],
    }


def test_a_joined_trace_equals_the_jax_servers(servers):
    """One completion with a fixed traceparent, X-Request-Id and tenant;
    then a spent deadline with the id (504) and without one."""
    shapes, sheds = {}, {}
    for side, ports in servers[0].items():
        port = ports["traced"]
        before = _counts(side, ports)
        status, body, headers = _call(port, "POST", "/v1/completions", BODY, {
            "traceparent": TRACEPARENT, "X-Request-Id": f"rid-{side}-1",
            "X-PST-Tenant": "acme"})
        assert status == 200
        # A collected answer's id is the completion's; the timeline is
        # filed under the caller's.
        assert headers["x-request-id"] == body["id"]
        # Only the stages whose count grew: the JAX registry is the
        # process's, so a stage another test file observed earlier in
        # this worker is there too, grown by 0.
        grew = {k: n - before.get(k, 0.0)
                for k, n in _counts(side, ports).items()
                if n != before.get(k, 0.0)}
        assert grew == {"engine_request": 1.0, "engine_admission": 1.0,
                        "engine_queue": 1.0, "prefill": 1.0, "decode": 1.0}
        status, shed, headers = _call(port, "POST", "/v1/completions", BODY, {
            "X-Request-Id": f"rid-{side}-2", "X-PST-Deadline-Ms": "0"})
        assert status == 504 and headers["x-request-id"] == f"rid-{side}-2"
        status, _, fresh = _call(port, "POST", "/v1/completions", BODY,
                                 {"X-PST-Deadline-Ms": "0"})
        assert status == 504 and fresh["x-request-id"].startswith("req-")
        sheds[side] = _error(shed)
        status, ring, _ = _call(port, "GET", "/debug/requests?limit=3")
        assert status == 200
        first, second, third = ring["requests"][::-1]
        assert third["request_id"] == fresh["x-request-id"]
        timeline = first
        # The root joins the caller's trace under its span.
        root = timeline["spans"][0]
        assert timeline["trace_id"] == TRACE_ID
        assert root["parent_id"] == PARENT
        assert all(s["parent_id"] == root["span_id"]
                   for s in timeline["spans"][1:])
        # engine_queue, prefill and decode lie back to back inside it.
        q, p, d = timeline["spans"][2:]
        assert q["start_ms"] + q["duration_ms"] == pytest.approx(
            p["start_ms"], abs=2e-3)
        assert p["start_ms"] + p["duration_ms"] == pytest.approx(
            d["start_ms"], abs=2e-3)
        assert (q["duration_ms"] + p["duration_ms"] + d["duration_ms"]
                <= root["duration_ms"] + 1.0)
        shapes[side] = [_shape(t) for t in (first, second)]
    for side in shapes:  # the request ids were per side
        for t in shapes[side]:
            t["request_id"] = t["request_id"].replace(f"-{side}-", "-")
        shapes[side][1]["trace_id"] = None  # a fresh trace each
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"][0]["spans"][0][2] == {
        "http.target": "/v1/completions", "http.status_code": 200}
    assert shapes["port"][1]["spans"] == [(
        "engine_request", None,
        {"http.target": "/v1/completions", "http.status_code": 504},
        [("deadline_shed", {"stage": "engine_admission"})])]
    assert sheds["port"] == sheds["jax"] == ("deadline exceeded",
                                             "deadline_exceeded")


def test_debug_requests_answers_as_the_jax_server(servers):
    got = {}
    for side, ports in servers[0].items():
        port = ports["traced"]
        rids = [f"ring-{side}-{i}" for i in range(3)]
        for rid in rids:
            status, _, _ = _call(port, "POST", "/v1/chat/completions", {
                "model": MODEL, "max_tokens": 2, "temperature": 0.0,
                "messages": [{"role": "user", "content": rid}]},
                {"X-Request-Id": rid})
            assert status == 200
        status, ring, _ = _call(port, "GET", "/debug/requests?limit=2")
        assert status == 200 and set(ring) == {"component", "buffer_size",
                                               "requests"}
        assert [t["request_id"] for t in ring["requests"]] == rids[::-1][:2]
        _, one, _ = _call(port, "GET", f"/debug/requests?request_id={rids[0]}")
        assert [t["request_id"] for t in one["requests"]] == [rids[0]]
        _, default, _ = _call(port, "GET", "/debug/requests?limit=x")
        assert 3 <= len(default["requests"]) <= 50
        got[side] = [ring["component"], ring["buffer_size"],
                     [s["name"] for s in one["requests"][0]["spans"]],
                     one["requests"][0]["spans"][0]["attributes"]]
        for name in ("off", "no_ring"):
            status, body, _ = _call(ports[name], "GET", "/debug/requests")
            got[side].append((status, body))
            # Tracing off: no id on the answers; the ring off: ids still.
            _, _, h = _call(ports[name], "POST", "/v1/completions", BODY,
                            {"X-PST-Deadline-Ms": "0", "X-Request-Id": "x"})
            got[side].append(h.get("x-request-id"))
    assert got["port"] == got["jax"]
    assert got["port"][2] == ["engine_request", "engine_admission",
                              "engine_queue", "prefill", "decode"]
    assert got["port"][4][0] == 404 and got["port"][5] is None
    assert got["port"][7] == "x"


def test_debug_profile_answers_as_the_jax_server(servers):
    ports = servers[0]
    for name, body, status in (
            ("off", {"duration_ms": 20}, 403),  # without --profiling
            ("traced", {"duration_ms": "soon"}, 400),
            ("traced", {"duration_ms": 5}, 200),  # clamped to 10; skipped
            ("traced", {}, 200)):  # the default 1000 ms; skipped
        want, got = (_call(ports[s][name], "POST", "/debug/profile", body)
                     for s in ("jax", "port"))
        assert got[0] == want[0] == status, (name, body, got, want)
        if status != 200:
            assert _error(got[1]) == _error(want[1])
        else:
            assert got[1] == want[1]
            assert got[1]["status"] == "skipped"
            assert got[1]["duration_ms"] == max(body.get("duration_ms", 1000),
                                                10)


def test_json_log_lines_carry_the_trace(servers):
    """A line logged while a request is served carries its trace id,
    request id and tenant, with the engine's identity, on both sides."""
    lines = {}
    sides = {"jax": (jax_server, jax_logging),
             "port": (port_server, port_logging)}
    ports, engines = servers
    for side, (srv, obs_logging) in sides.items():
        # The identity is process-wide: another test's (a router's
        # replica_id) would ride this one's lines.
        saved = dict(obs_logging._IDENTITY)
        obs_logging._IDENTITY.clear()
        obs_logging.configure_logging("json", component="engine",
                                      engine_id="127.0.0.1:8000")
        seen = []

        class Capture(logging.Handler):
            def emit(self, record):
                seen.append(json.loads(self.format(record)))

        handler = Capture()
        handler.setFormatter(obs_logging.JsonLineFormatter())
        srv.logger.addHandler(handler)
        # A line the handler's task or thread logs while it serves: here,
        # one from the tokenizer it calls.
        tok = engines[side].tokenizer
        encode = tok.encode

        def logged_encode(*a, **kw):
            srv.logger.info("tokenizing")
            return encode(*a, **kw)

        tok.encode = logged_encode
        try:
            status, _, _ = _call(ports[side]["traced"], "POST",
                                 "/v1/completions", BODY, {
                                     "traceparent": TRACEPARENT,
                                     "X-Request-Id": "log-1",
                                     "X-PST-Tenant": "acme"})
            assert status == 200
        finally:
            del tok.encode
            srv.logger.removeHandler(handler)
            obs_logging.configure_logging("text")
            obs_logging._IDENTITY.clear()
            obs_logging._IDENTITY.update(saved)
        [line] = [ln for ln in seen if ln["msg"] == "tokenizing"]
        assert line["logger"] == srv.__name__
        lines[side] = {k: v for k, v in line.items() if k not in ("ts",
                                                                  "logger")}
    assert lines["port"] == lines["jax"]
    assert lines["port"]["trace_id"] == TRACE_ID
    assert lines["port"]["request_id"] == "log-1"
    assert lines["port"]["tenant"] == "acme"


def test_traceparent_parses_as_the_jax_package():
    tid, sid = "ab" * 16, "cd" * 8
    for value in (
        None, "", "garbage", "00-short-span-01",
        "00-" + "g" * 32 + "-" + "cd" * 8 + "-01",      # non-hex trace id
        "00-" + "ab" * 16 + "-" + "cd" * 4 + "-01",     # short span id
        "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",      # all-zero trace id
        "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",     # all-zero span id
        format_traceparent(tid, sid),
        f"00-{tid}-{sid}-01-extra",                     # future fields
        f"00-{tid.upper()}-{sid}-01",
    ):
        assert parse_traceparent(value) == jax_parse_traceparent(value), value
    assert parse_traceparent(f"00-{tid}-{sid}-01") == (tid, sid)
