"""The repo's router in front of the PyTorch engine's server.

The router app (``production_stack_tpu.router.app.create_app``, static
discovery, set up as ``tests/test_router_e2e.py`` sets it up) proxies to
the port's server on ``tiny-llama-debug`` on the CPU. Completions and
chats through the router must equal the same requests sent directly; the
router's scraper reads the port's ``/metrics``; its health loop reads
``/is_draining`` and ``/ready``, so an engine drained at its own
``/drain`` leaves the rotation and comes back after ``/undrain``. The
router forwards ``/v1/embeddings`` and ``/rerank`` to the port and their
bodies come back as the port answers them directly.
"""

import asyncio

import aiohttp
import pytest
from aiohttp import web

from production_stack_tpu.router.app import create_app
from production_stack_tpu.router.parser import parse_args
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import serve_in_thread

from .router_utils import reset_router_singletons

MODEL = "tiny-llama-debug"
COMPLETION = {"model": MODEL, "prompt": "The router in front", "max_tokens": 6,
              "temperature": 0.0, "ignore_eos": True}
CHAT = {"model": MODEL, "max_tokens": 6, "temperature": 0.0,
        "ignore_eos": True, "messages": [{"role": "user", "content": "Hi"}]}


@pytest.fixture(autouse=True)
def _reset():
    reset_router_singletons()
    yield
    reset_router_singletons()


@pytest.fixture
def port_engine():
    # Prefix caching off: every request is a fresh prefill, so a request
    # and its repeat take the same path.
    engine = AsyncLLMEngine(EngineConfig(
        model=MODEL, device="cpu", block_size=8, max_model_len=128,
        num_kv_blocks=64, max_num_seqs=4, max_prefill_tokens=32,
        enable_prefix_caching=False))
    server, thread = serve_in_thread(engine)
    yield f"http://127.0.0.1:{server.server_address[1]}", engine
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()


async def _router(engine_url: str, health_checks: bool = False):
    """The router app on a free port. Its health loop, when on, probes the
    engine with completions of its own every 0.2 s, which would share
    batches with a test's requests."""
    argv = ["--service-discovery", "static", "--static-backends", engine_url,
            "--static-models", MODEL, "--routing-logic", "roundrobin",
            "--engine-stats-interval", "0.2"]
    if health_checks:
        argv += ["--static-backend-health-checks", "--static-model-types",
                 "completion", "--health-check-interval", "0.2"]
    args = parse_args(argv)
    runner = web.AppRunner(create_app(args))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"


def _without_ids(body: dict) -> dict:
    """The body, ids and timestamps aside, and of a usage's ``pst_cost``
    its fields only (each request bills its own device seconds)."""
    out = {k: v for k, v in body.items() if k not in ("id", "created")}
    if "pst_cost" in out.get("usage", {}):
        out["usage"] = {**out["usage"],
                        "pst_cost": sorted(out["usage"]["pst_cost"])}
    return out


async def _post(s, url, body):
    async with s.post(url, json=body) as resp:
        return resp.status, await resp.json(), resp.headers


async def _until(predicate, timeout=20.0):
    """Poll an async predicate until it holds."""
    deadline = asyncio.get_running_loop().time() + timeout
    while not await predicate():
        assert asyncio.get_running_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.05)


async def test_router_serves_the_port_as_directly(port_engine):
    engine_url, _ = port_engine
    runner, router_url = await _router(engine_url)
    try:
        async with aiohttp.ClientSession() as s:
            for path, body in (("/v1/completions", COMPLETION),
                               ("/v1/chat/completions", CHAT)):
                direct = await _post(s, engine_url + path, body)
                routed = await _post(s, router_url + path, body)
                assert routed[0] == direct[0] == 200
                assert _without_ids(routed[1]) == _without_ids(direct[1])
                assert routed[1]["usage"]["completion_tokens"] == 6
            # Streamed through the router: the port's frames, then [DONE].
            async with s.post(router_url + "/v1/chat/completions",
                              json=dict(CHAT, stream=True)) as resp:
                assert resp.status == 200
                raw = await resp.read()
            frames = [ln for ln in raw.split(b"\n") if ln.startswith(b"data: ")]
            assert len(frames) == 6 + 2 and frames[-1] == b"data: [DONE]"

            async def scraped():
                async with s.get(router_url + "/engines") as resp:
                    stats = (await resp.json())[0]["engine_stats"]
                return bool(stats) and stats["gpu_prefix_cache_queries_total"] > 0

            await _until(scraped)  # the router read the port's /metrics
    finally:
        await runner.cleanup()


async def test_drained_port_leaves_the_rotation(port_engine):
    engine_url, engine = port_engine
    runner, router_url = await _router(engine_url, health_checks=True)
    try:
        async with aiohttp.ClientSession() as s:

            async def draining(flag):
                # A drain that lands between a health cycle's /is_draining
                # and its generation probe fails that probe: the router
                # lists the engine as unhealthy, not at all, until the
                # next cycle reads /is_draining. Absent is not yet known.
                async with s.get(router_url + "/engines") as resp:
                    eps = await resp.json()
                return bool(eps) and eps[0]["draining"] is flag

            async def idle():
                return engine.num_inflight() == 0

            def admitted():  # grows only when the engine admits a request
                return engine.engine.prompt_tokens_total

            assert (await _post(s, router_url + "/v1/completions",
                                COMPLETION))[0] == 200
            # Drained at the engine itself: the router learns it from the
            # engine's /is_draining.
            status, body, _ = await _post(s, engine_url + "/drain", {})
            assert status == 200 and body["status"] == "draining"
            await _until(lambda: draining(True))
            # A health probe admitted just before the drain runs to its
            # end (a drain finishes what is in flight).
            await _until(idle)
            before = admitted()
            status, _, _ = await _post(s, router_url + "/v1/completions",
                                       COMPLETION)
            assert status == 503
            # Nothing reached the engine.
            assert admitted() == before and engine.num_inflight() == 0
            status, body, _ = await _post(s, engine_url + "/undrain", {})
            assert status == 200 and body["status"] == "accepting"
            await _until(lambda: draining(False))
            status, body, _ = await _post(s, router_url + "/v1/completions",
                                          COMPLETION)
            assert status == 200 and body["usage"]["completion_tokens"] == 6
    finally:
        await runner.cleanup()


async def test_router_admin_proxy_sleeps_and_drains_the_port(port_engine):
    """The router's admin fan-out (the operator's scale-to-zero) drives
    the port's ``/sleep?level=2``, ``/wake_up``, ``/drain?wait=1`` and
    ``/undrain`` through their query strings."""
    engine_url, engine = port_engine
    runner, router_url = await _router(engine_url)
    q = f"url={engine_url}"
    try:
        async with aiohttp.ClientSession() as s:
            before = (await _post(s, router_url + "/v1/completions",
                                  COMPLETION))[1]
            status, body, _ = await _post(
                s, f"{router_url}/sleep?{q}&level=2", {})
            assert status == 200 and engine.sleeping
            assert engine.engine.runner.kv_cache is None
            async with s.get(f"{router_url}/is_sleeping?{q}") as resp:
                assert await resp.json() == {engine_url: {"is_sleeping": True}}
            assert (await _post(s, router_url + "/v1/completions",
                                COMPLETION))[0] == 503
            status, body, _ = await _post(s, f"{router_url}/wake_up?{q}", {})
            assert status == 200 and not engine.sleeping
            status, after, _ = await _post(s, router_url + "/v1/completions",
                                           COMPLETION)
            assert status == 200
            assert _without_ids(after) == _without_ids(before)

            status, body, _ = await _post(
                s, f"{router_url}/drain?{q}&wait=1&timeout=5", {})
            assert status == 200 and body == {engine_url: {
                "status": "draining", "in_flight": 0}}
            async with s.get(f"{router_url}/is_draining?{q}") as resp:
                assert await resp.json() == {engine_url: {
                    "is_draining": True, "in_flight": 0}}
            assert (await _post(s, router_url + "/v1/completions",
                                COMPLETION))[0] == 503
            status, body, _ = await _post(s, f"{router_url}/undrain?{q}", {})
            assert status == 200 and not engine.draining
            assert (await _post(s, router_url + "/v1/completions",
                                COMPLETION))[0] == 200
    finally:
        await runner.cleanup()


@pytest.mark.parametrize("path,body", [
    ("/v1/embeddings", {"model": MODEL, "input": ["paged", "attention"]}),
    ("/rerank", {"model": MODEL, "query": "which block?",
                 "documents": ["block one", "block two", "a third"],
                 "top_n": 2}),
])
async def test_router_forwards_the_encode_routes(port_engine, path, body):
    """``/v1/embeddings`` and ``/rerank`` through the router (which sends
    ``/rerank`` on as ``/v1/rerank``) come back as the port answers them
    directly, ids aside."""
    engine_url, _ = port_engine
    runner, router_url = await _router(engine_url)
    try:
        async with aiohttp.ClientSession() as s:
            direct = await _post(s, engine_url + path, body)
            routed = await _post(s, router_url + path, body)
            assert routed[0] == direct[0] == 200
            assert _without_ids(routed[1]) == _without_ids(direct[1])
            assert routed[1].get("data") or routed[1].get("results")
    finally:
        await runner.cleanup()
