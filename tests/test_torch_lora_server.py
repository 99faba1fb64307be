"""The PyTorch server's LoRA surface against the JAX server's.

A JAX server (aiohttp, on its own event loop thread) and the port's serve
``tiny-llama-debug`` on the CPU from the same weights with
``--enable-lora`` (two slots, rank up to 8) over one adapter directory:

- ``POST /v1/load_lora_adapter`` and ``/v1/unload_lora_adapter`` answer
  the same statuses and bodies (a load, a resident reload, a load from
  the adapter directory, the 400s of a missing name, a rank too large and
  a full bank, the 404 of a missing directory), and ``/v1/models`` lists
  the adapters with ``parent`` set to the served model;
- a completion and a chat whose ``model`` names an adapter are served
  under it, with the JAX server's tokens, which differ from the base
  model's;
- with ``--api-key`` (the chart's LoRA render: ``--enable-lora
  --lora-dir``) both routes answer 401 without the key;
- speculation with an adapter gives the non-speculative adapter tokens
  (the port's counterpart of ``tests/test_spec_decode.py::
  test_spec_with_lora_adapter_identical``): the verify step runs each row
  with its adapter;
- the repo's router, as ``tests/test_torch_router_port.py`` sets it up,
  finds the adapter in the port's ``/v1/models`` (the Kubernetes
  discovery's parse) and routes a request for it to the port.
"""

import asyncio
import threading

import aiohttp
import jax
import numpy as np
import pytest
from aiohttp import web

from production_stack_tpu.engine.async_engine import (
    AsyncLLMEngine as JaxAsyncLLMEngine,
)
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.server import create_engine_app as jax_app
from production_stack_tpu.router.app import create_app
from production_stack_tpu.router.parser import parse_args
from production_stack_tpu.router.service_discovery import (
    K8sPodIPServiceDiscovery,
)
from production_stack_tpu_torch.engine import server as port_server
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.models.convert import params_from_jax

from .router_utils import reset_router_singletons
from .test_torch_lora import make_adapter
from .test_torch_router_port import _post, _without_ids
from .test_torch_tracing import _call, _error

MODEL = "tiny-llama-debug"
COMMON = dict(model=MODEL, block_size=8, max_prefill_tokens=32,
              max_model_len=256, num_kv_blocks=128, max_num_seqs=4,
              enable_lora=True, max_loras=2, max_lora_rank=8)
REPEAT = [11, 22, 33, 44, 55, 66, 77, 88, 11, 22, 33, 44, 55, 66, 77, 88,
          11, 22, 33, 44]


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapters")
    return root, {"ad1": make_adapter(root, "ad1"),
                  "ad2": make_adapter(root, "ad2", seed=2,
                                      targets=("q_proj", "v_proj")),
                  "big": make_adapter(root, "big", rank=16)}


@pytest.fixture(scope="module")
def servers(adapters):
    """{"jax": port, "port": port} over one tiny engine's weights, and the
    port's params."""
    root, _ = adapters
    kw = dict(COMMON, lora_dir=str(root), cost_attribution=False)
    jeng = JaxAsyncLLMEngine(JaxEngineConfig(**kw))
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jeng.engine.runner.params))
    loop = asyncio.new_event_loop()
    started, ports = threading.Event(), {}

    def run_jax():
        asyncio.set_event_loop(loop)
        jeng.start(loop)
        runner = web.AppRunner(jax_app(jeng, tracing=False))
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        ports["jax"] = site._server.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())

    jthread = threading.Thread(target=run_jax, daemon=True)
    jthread.start()
    assert started.wait(timeout=60)
    engine = AsyncLLMEngine(EngineConfig(device="cpu", overlap_decode=False,
                                         **kw), params=params)
    server, thread = serve_in_thread(engine, tracing=False)
    ports["port"] = server.server_address[1]
    yield ports, params
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    engine.shutdown()
    loop.call_soon_threadsafe(loop.stop)
    jthread.join(timeout=10)
    jeng.shutdown()


def _both(ports, method, path, body=None):
    """(status, body) of each server; the same status on both."""
    got = {side: _call(port, method, path, body)[:2]
           for side, port in ports.items()}
    assert got["port"][0] == got["jax"][0], (path, body, got)
    return got


def _models(body):
    return [(m["id"], m["parent"], m["root"], m["object"], m["owned_by"])
            for m in body["data"]]


def test_load_and_unload_answer_as_the_jax_server(servers, adapters):
    ports, _ = servers
    _, paths = adapters
    steps = [
        ({}, 400), ({"lora_name": "nope", "lora_path": "/no/such/dir"}, 404),
        ({"lora_name": "big", "lora_path": paths["big"]}, 400),
        ({"lora_name": "ad1", "lora_path": paths["ad1"]}, 200),
        ({"lora_name": "ad1", "lora_path": paths["ad1"]}, 200),  # resident
        ({"lora_name": "ad2"}, 200),  # from --lora-dir
        ({"lora_name": "ad3", "lora_path": paths["ad1"]}, 400),  # bank full
    ]
    for body, status in steps:
        got = _both(ports, "POST", "/v1/load_lora_adapter", body)
        (ps, pb), (_, jb) = got["port"], got["jax"]
        assert ps == status, (body, pb)
        if status == 200:
            assert pb == jb
        else:
            assert _error(pb) == _error(jb), body
    got = _both(ports, "GET", "/v1/models")
    assert _models(got["port"][1]) == _models(got["jax"][1]) == [
        (MODEL, None, None, "model", "production-stack-tpu"),
        ("ad1", MODEL, None, "model", "production-stack-tpu"),
        ("ad2", MODEL, None, "model", "production-stack-tpu")]
    for body, removed in (({"lora_name": "ad2"}, True),
                          ({"lora_name": "ad2"}, False)):
        got = _both(ports, "POST", "/v1/unload_lora_adapter", body)
        assert got["port"][1] == got["jax"][1] == {"status": "ok",
                                                   "removed": removed}
    got = _both(ports, "POST", "/v1/unload_lora_adapter", {})
    assert got["port"][0] == 400
    assert _error(got["port"][1]) == _error(got["jax"][1])
    got = _both(ports, "GET", "/v1/models")
    assert [m["id"] for m in got["port"][1]["data"]] == [MODEL, "ad1"]
    # A request naming an unloaded adapter is served by the base model,
    # as the JAX server serves it.
    req = {"model": "ad2", "prompt": "Hello", "max_tokens": 4,
           "temperature": 0.0, "ignore_eos": True}
    got = _both(ports, "POST", "/v1/completions", req)
    base = _both(ports, "POST", "/v1/completions", dict(req, model=MODEL))
    assert got["port"][1]["choices"] == got["jax"][1]["choices"] == \
        base["port"][1]["choices"]


def test_model_name_selects_the_adapter(servers, adapters):
    ports, _ = servers
    _, paths = adapters
    _both(ports, "POST", "/v1/load_lora_adapter",
          {"lora_name": "ad1", "lora_path": paths["ad1"]})
    for path, body in (
            ("/v1/completions", {"prompt": "The adapter speaks",
                                 "max_tokens": 8}),
            ("/v1/chat/completions", {"messages": [
                {"role": "user", "content": "Hi adapter"}],
                "max_tokens": 8})):
        body = dict(body, temperature=0.0, ignore_eos=True)
        lora = _both(ports, "POST", path, dict(body, model="ad1"))
        base = _both(ports, "POST", path, dict(body, model=MODEL))
        assert lora["port"][0] == base["port"][0] == 200
        assert lora["port"][1]["model"] == lora["jax"][1]["model"] == "ad1"
        assert lora["port"][1]["choices"] == lora["jax"][1]["choices"]
        assert base["port"][1]["choices"] == base["jax"][1]["choices"]
        assert lora["port"][1]["choices"] != base["port"][1]["choices"]


def test_lora_routes_need_the_api_key(servers, adapters):
    root, paths = adapters
    _, params = servers
    argv = ["--device", "cpu", "--model", MODEL, "--num-kv-blocks", "64",
            "--attn-impl", "gather", "--api-key", "k", "--enable-lora",
            "--lora-dir", str(root), "--max-loras", "2",
            "--max-lora-rank", "8"]
    args = port_server.parse_engine_args(argv)
    cfg = port_server.engine_config_from_args(args)
    assert (cfg.enable_lora, cfg.max_loras, cfg.max_lora_rank,
            cfg.lora_dir) == (True, 2, 8, str(root))
    engine = AsyncLLMEngine(cfg, params=params)
    server, thread = serve_in_thread(
        engine, **port_server.app_options_from_args(args))
    port = server.server_address[1]
    key = {"Authorization": "Bearer k"}
    try:
        for path in ("/v1/load_lora_adapter", "/v1/unload_lora_adapter"):
            status, body, _ = _call(port, "POST", path, {"lora_name": "ad1"})
            assert status == 401 and _error(body) == (
                "invalid API key", "authentication_error")
        status, body, _ = _call(port, "POST", "/v1/load_lora_adapter",
                                {"lora_name": "ad1"}, key)
        assert status == 200 and body["slot"] == 1
        assert engine.engine.lora_manager.get("ad1").path == paths["ad1"]
        status, body, _ = _call(port, "POST", "/v1/completions", {
            "model": "ad1", "prompt": "Hi", "max_tokens": 2}, key)
        assert status == 200 and body["model"] == "ad1"
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)


def test_spec_with_lora_adapter_identical(servers, adapters):
    """Verify scores a row's drafts WITH its adapter: speculative adapter
    tokens equal the plain engine's, and differ from the base model's."""
    _, params = servers
    _, paths = adapters
    tokens, stats = {}, {}
    for spec, lora in ((False, "ad2"), (True, "ad2"), (False, None)):
        eng = LLMEngine(EngineConfig(
            device="cpu", overlap_decode=False,
            **({"speculative_ngram": 4} if spec else {}), **COMMON),
            params=params)
        eng.load_lora("ad2", paths["ad2"])
        eng.add_request("L0", prompt_token_ids=list(REPEAT),
                        sampling=SamplingParams(max_tokens=16, temperature=0.0,
                                                ignore_eos=True),
                        lora_name=lora)
        out = []
        while eng.has_work():
            for o in eng.step():
                out.extend(o.new_token_ids)
        tokens[spec, lora] = out
        stats[spec, lora] = eng.stats()
    assert tokens[True, "ad2"] == tokens[False, "ad2"]
    assert tokens[False, "ad2"] != tokens[False, None]
    assert len(tokens[True, "ad2"]) == 16
    assert stats[True, "ad2"]["spec_decode_num_draft_tokens_total"] > 0


@pytest.fixture
def lora_port(servers, adapters):
    """A port server with ``ad1`` loaded, prefix caching off (a request
    and its repeat take the same path)."""
    _, params = servers
    root, paths = adapters
    reset_router_singletons()
    engine = AsyncLLMEngine(EngineConfig(
        device="cpu", lora_dir=str(root), enable_prefix_caching=False,
        **COMMON), params=params)
    server, thread = serve_in_thread(engine)
    engine.load_lora("ad1", paths["ad1"])
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)
    reset_router_singletons()


async def test_router_routes_an_adapter_to_the_port(lora_port):
    # The Kubernetes discovery's read of an engine: the adapter is a model
    # of the endpoint, with its base as parent.
    info = await K8sPodIPServiceDiscovery()._fetch_models(lora_port)
    assert sorted(info) == ["ad1", MODEL]
    assert info["ad1"].is_adapter and info["ad1"].parent == MODEL
    assert not info[MODEL].is_adapter
    argv = ["--service-discovery", "static", "--static-backends",
            f"{lora_port},{lora_port}", "--static-models", f"{MODEL},ad1",
            "--routing-logic", "roundrobin", "--engine-stats-interval", "0.2"]
    runner = web.AppRunner(create_app(parse_args(argv)))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    router = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    body = {"model": "ad1", "prompt": "Routed to the adapter",
            "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
    try:
        async with aiohttp.ClientSession() as s:
            direct = await _post(s, lora_port + "/v1/completions", body)
            routed = await _post(s, router + "/v1/completions", body)
            base = await _post(s, lora_port + "/v1/completions",
                               dict(body, model=MODEL))
            assert routed[0] == direct[0] == 200
            assert _without_ids(routed[1]) == _without_ids(direct[1])
            assert routed[1]["model"] == "ad1"
            assert routed[1]["choices"] != base[1]["choices"]
            async with s.get(router + "/v1/models") as resp:
                ids = {m["id"] for m in (await resp.json())["data"]}
            assert {"ad1", MODEL} <= ids
    finally:
        await runner.cleanup()
