"""Deadlines and tenants through the port's server, on the CPU.

A tiny-preset server honors the router's ``X-PST-Deadline-Ms``: a spent
budget gets an instant 504 tagged ``X-PST-Deadline-Exceeded: 1`` and
never reaches a prefill step; a budget that runs out mid-decode ends in
the same 504, or, streamed, in a frame whose ``finish_reason`` is
``"deadline"``; a malformed budget is ignored. ``X-PST-Tenant`` and
``X-PST-Tenant-Class`` reach the scheduler, whose admission order under
tenants equals the JAX engine's. ``/metrics`` counts sheds and swaps as
the JAX ``EngineMetrics`` and telemetry do for the same stats, and the
repo's router passes the port's tagged 504 through without counting an
upstream failure.
"""

import http.client
import json

import aiohttp
import jax
import numpy as np
import pytest
from aiohttp import web
from prometheus_client import generate_latest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.engine.server import EngineMetrics as JaxMetrics
from production_stack_tpu.obs import engine_telemetry as jax_tel
from production_stack_tpu.router.app import create_app
from production_stack_tpu.router.parser import parse_args
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.resilience.deadline import (
    DEADLINE_EXCEEDED_HEADER,
    DEADLINE_HEADER,
)

from .router_utils import reset_router_singletons
from .test_torch_metrics import _families

MODEL = "tiny-llama-debug"
SERVED = dict(model=MODEL, device="cpu", block_size=8, max_model_len=1024,
              num_kv_blocks=160, max_num_seqs=4, max_prefill_tokens=64)
LONG = {"model": MODEL, "prompt": "Keep going.", "max_tokens": 1000,
        "temperature": 0.0, "ignore_eos": True}


def _post(port, body, headers=None, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw, {k.lower(): v for k, v in resp.getheaders()}


def _scrape(port) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    return text


def _value(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not exported")


@pytest.fixture(scope="module")
def served():
    engine = AsyncLLMEngine(EngineConfig(**SERVED))
    server, thread = serve_in_thread(engine)
    yield server.server_address[1], engine
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)


def test_spent_budget_gets_a_tagged_504_before_any_prefill(served):
    port, engine = served
    tel = engine.engine.telemetry
    before = (engine.engine.prompt_tokens_total, tel.device_busy(),
              _value(_scrape(port), "pst:deadline_shed_admission_total"))
    for budget in ("0", "0.0"):
        status, raw, headers = _post(port, LONG, {DEADLINE_HEADER: budget})
        assert status == 504
        assert headers[DEADLINE_EXCEEDED_HEADER.lower()] == "1"
        assert json.loads(raw)["error"]["type"] == "deadline_exceeded"
    assert engine.engine.prompt_tokens_total == before[0]  # never added
    assert tel.device_busy() == before[1]  # no step ran
    assert _value(_scrape(port), "pst:deadline_shed_admission_total") == (
        before[2] + 2)


def test_budget_spent_mid_decode_ends_in_504_or_a_deadline_frame(served):
    port, engine = served
    text = _scrape(port)
    shed = (_value(text, "pst:deadline_shed_queued_total")
            + _value(text, "pst:deadline_shed_running_total"))
    status, _, headers = _post(port, LONG, {DEADLINE_HEADER: "300"})
    assert status == 504 and headers[DEADLINE_EXCEEDED_HEADER.lower()] == "1"
    status, raw, _ = _post(port, {**LONG, "stream": True},
                           {DEADLINE_HEADER: "300"})
    assert status == 200
    frames = [json.loads(ln[6:]) for ln in raw.split(b"\n")
              if ln.startswith(b"data: {")]
    assert raw.rstrip().endswith(b"data: [DONE]")
    assert frames[-1]["choices"][0]["finish_reason"] == "deadline"
    assert all(f["choices"][0]["finish_reason"] is None for f in frames[:-1])
    assert len(frames) < LONG["max_tokens"]
    text = _scrape(port)
    assert _value(text, "pst:deadline_shed_queued_total") + _value(
        text, "pst:deadline_shed_running_total") == shed + 2
    stats = engine.engine.stats()
    assert stats["num_requests_running"] == stats["num_requests_waiting"] == 0


def test_malformed_budget_is_ignored(served):
    port, _ = served
    for budget in ("abc", "-5", "", "1e"):
        status, raw, headers = _post(port, {**LONG, "max_tokens": 4},
                                     {DEADLINE_HEADER: budget})
        assert status == 200, budget
        assert DEADLINE_EXCEEDED_HEADER.lower() not in headers
        assert json.loads(raw)["usage"]["completion_tokens"] == 4


# (request id, prompt length, tenant, tier) in arrival order; one running
# sequence at a time, so the order of first tokens is the admission order.
TENANTS = [("b0", 9, "bulk", "batch"), ("a0", 7, "acme", None),
           ("a1", 8, "acme", "interactive"), ("a2", 6, "acme", None),
           ("z0", 5, "zed", "interactive"), ("z1", 9, "zed", None),
           ("b1", 7, "bulk", "batch"), ("n0", 6, None, None)]


def _admission_order(engine, sp_cls) -> list:
    rng = np.random.default_rng(3)
    for rid, n, tenant, tier in TENANTS:
        engine.add_request(rid, prompt_token_ids=rng.integers(
            1, 500, n).tolist(), sampling=sp_cls(max_tokens=3,
                                                 temperature=0.0,
                                                 ignore_eos=True),
            tenant=tenant, tenant_class=tier)
    order = []
    while engine.has_work():
        for out in engine.step():
            if out.num_output_tokens == 1:
                order.append(out.request_id)
    return order


def test_tenant_headers_reach_the_scheduler_and_order_it_as_jax(served):
    port, engine = served
    seen = []
    add = engine.engine.add_request

    def spy(rid, **kw):
        seen.append((kw["tenant"], kw["tenant_class"]))
        return add(rid, **kw)

    engine.engine.add_request = spy
    try:
        status, _, _ = _post(port, {**LONG, "max_tokens": 2},
                             {"X-PST-Tenant": "acme",
                              "X-PST-Tenant-Class": "batch"})
    finally:
        engine.engine.add_request = add
    assert status == 200 and seen == [("acme", "batch")]
    cfg = dict(model=MODEL, block_size=8, max_model_len=128, num_kv_blocks=32,
               max_num_seqs=1, max_prefill_tokens=32, overlap_decode=False)
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather", **cfg))
    port_eng = LLMEngine(EngineConfig(device="cpu", **cfg),
                         params=params_from_jax(jax.tree.map(
                             np.asarray, jeng.runner.params)))
    want = _admission_order(jeng, JaxSamplingParams)
    got = _admission_order(port_eng, SamplingParams)
    assert got == want
    # Interactive tenants take turns; batch work admits last.
    assert got[-2:] == ["b0", "b1"] and got.index("z0") < got.index("a2")


def test_metrics_count_sheds_and_swaps_as_the_jax_metrics():
    engine = AsyncLLMEngine(EngineConfig(
        **{**SERVED, "max_model_len": 256, "num_kv_blocks": 28,
           "num_decode_steps": 2, "overlap_decode": False}))
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    try:
        # Four requests outgrow the pool (swaps); one budget is spent.
        rng = np.random.default_rng(11)
        eng = engine.engine
        for i, n in enumerate((30, 34, 27, 38)):
            eng.add_request(f"r{i}", prompt_token_ids=rng.integers(
                1, 500, n).tolist(), sampling=SamplingParams(
                    max_tokens=40, temperature=0.0, ignore_eos=True))
        assert _post(port, LONG, {DEADLINE_HEADER: "0"})[0] == 504
        while eng.has_work() or engine.num_inflight():
            thread.join(timeout=0.05)
        text = _scrape(port)
        stats = eng.stats()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    assert stats["kv_swap_out_total"] > 0
    jax_metrics = JaxMetrics(MODEL)
    jax_metrics.refresh(stats)
    jax_metrics.deadline_shed_admission.inc()
    want = _families(generate_latest(jax_metrics.registry).decode())
    got = _families(text)
    names = [n for n in want if n.startswith(("pst:deadline", "pst:kv_swap",
                                              "pst:tenant",
                                              "vllm:num_requests_swapped",
                                              "vllm:num_preemptions"))]
    assert len(names) == 13
    for name in names:
        assert got[name] == want[name], name
    # The engine telemetry's swap families, as the JAX telemetry's.
    for key, fam in (("kv_swap_out_total", "pst_engine_swap_out"),
                     ("kv_swap_in_total", "pst_engine_swap_in")):
        ref = {c._name: c for c in jax_tel.ENGINE_TELEMETRY_REGISTRY
               ._collector_to_names}[fam]
        assert got[fam][:2] == ("counter", ref._documentation)
        assert got[fam][2][0][2] == stats[key]


@pytest.fixture
def _router_reset():
    reset_router_singletons()
    yield
    reset_router_singletons()


async def test_router_passes_the_tagged_504_through_without_breaker_feed(
        served, _router_reset):
    port, _ = served
    url = f"http://127.0.0.1:{port}"
    args = parse_args([
        "--service-discovery", "static", "--static-backends", url,
        "--static-models", MODEL, "--routing-logic", "roundrobin",
        "--engine-stats-interval", "0.2", "--proxy-retries", "3",
        "--retry-backoff", "0.01", "--breaker-failure-threshold", "2",
        "--breaker-recovery-time", "0.4"])
    runner = web.AppRunner(create_app(args))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    router = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    try:
        async with aiohttp.ClientSession() as s:
            for _ in range(2):  # the breaker's threshold, were it fed
                async with s.post(f"{router}/v1/completions", json=LONG,
                                  headers={DEADLINE_HEADER: "300"}) as resp:
                    assert resp.status == 504
                    assert resp.headers.get(DEADLINE_EXCEEDED_HEADER) == "1"
            async with s.get(f"{router}/metrics") as resp:
                text = await resp.text()
            failures = [ln for ln in text.splitlines() if ln.startswith(
                "pst_resilience_upstream_failures_total") and url in ln]
            assert all(float(ln.rsplit(" ", 1)[1]) == 0 for ln in failures)
            async with s.get(f"{router}/engines") as resp:
                info = {e["url"]: e["breaker"] for e in await resp.json()}
            assert info[url] == "closed"
            # And the engine still serves through the router.
            async with s.post(f"{router}/v1/completions",
                              json={**LONG, "max_tokens": 2}) as resp:
                assert resp.status == 200
    finally:
        await runner.cleanup()
