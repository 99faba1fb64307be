"""``/ready`` of the PyTorch engine's server gates on warmup, as the JAX
server's does (``tests/test_precompile.py::test_ready_gates_on_warmup``
and ``test_ready_immediate_when_warmup_off``): while the step thread
warms up, ``/ready`` answers 503 ``"warming"``, ``/health`` 200
``"warming"`` and a completion 503 with ``X-PST-Warming: 1``; afterwards
``/ready`` answers 200 with the warmup summary."""

import http.client
import json
import threading
import time

from production_stack_tpu_torch.engine import engine as engine_mod
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import serve_in_thread

CFG = dict(model="tiny-llama-debug", device="cpu", block_size=8,
           max_model_len=64, num_kv_blocks=32, max_num_seqs=2,
           max_prefill_tokens=8, num_decode_steps=2)
BODY = {"prompt": [5, 6, 7], "max_tokens": 2, "temperature": 0.0,
        "ignore_eos": True}


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw), resp.getheader("X-PST-Warming")


def _serve(cfg):
    engine = AsyncLLMEngine(EngineConfig(**cfg))
    server, thread = serve_in_thread(engine)
    return engine, server, thread


def _stop(engine, server, thread):
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _ready_body(port):
    for _ in range(200):
        status, body, _ = _request(port, "GET", "/ready")
        if status == 200:
            return body
        time.sleep(0.05)
    raise AssertionError(f"/ready never answered 200: {body}")


def test_ready_gates_on_warmup(monkeypatch):
    entered, release = threading.Event(), threading.Event()
    precompile = engine_mod.LLMEngine.precompile

    def held_precompile(self, mode=None, bucket_budget=None):
        entered.set()
        assert release.wait(timeout=30)
        return precompile(self, mode, bucket_budget)

    monkeypatch.setattr(engine_mod.LLMEngine, "precompile", held_precompile)
    engine, server, thread = _serve(dict(CFG, warmup="lazy"))
    port = server.server_address[1]
    try:
        assert entered.wait(timeout=30)
        status, body, _ = _request(port, "GET", "/ready")
        assert status == 503
        assert body["ready"] is False and body["reason"] == "warming"
        assert body["warmup"] == {"mode": "lazy"}
        # Liveness stays green while warming.
        assert _request(port, "GET", "/health")[:2] == (
            200, {"status": "warming"})
        status, body, warming = _request(port, "POST", "/v1/completions",
                                         BODY)
        assert status == 503 and warming == "1"
        assert body["error"]["type"] == "service_unavailable"
        release.set()
        body = _ready_body(port)
        assert body["ready"] is True
        warmup = body["warmup"]
        assert warmup["mode"] == "lazy" and "error" not in warmup
        assert 0 < warmup["buckets_compiled"] < warmup["buckets_total"]
        assert warmup["buckets_skipped"] == (
            warmup["buckets_total"] - warmup["buckets_compiled"])
        assert _request(port, "GET", "/health")[:2] == (200, {"status": "ok"})
        status, body, warming = _request(port, "POST", "/v1/completions",
                                         BODY)
        assert status == 200 and warming is None
        assert body["usage"]["completion_tokens"] == 2
    finally:
        release.set()
        _stop(engine, server, thread)


def test_ready_immediate_when_warmup_off():
    engine, server, thread = _serve(CFG)
    try:
        body = _ready_body(server.server_address[1])
        assert body == {"ready": True, "warmup": {"mode": "off"}}
        assert engine.warmup_error is None
    finally:
        _stop(engine, server, thread)
