"""The port started from the repo's own deployment argv.

The chart's engine template (``helm/templates/deployment-engine.yaml``)
and the operator's ``build_engine_deployment``
(``operator/src/reconcilers.cc``) emit the JAX server's flags. Here: the
port's ``parse_engine_args`` takes every flag either emits (no module
waits in ROADMAP.md: ``WAITING`` is empty) and ``--moe-impl``, which
reaches an engine through ``extraArgs``; for the chart's default render,
the operator's default argv and one argv a new flag, the
port's ``EngineConfig`` equals the JAX one on every field both have; a
parallel size above 1 is refused at start; and with ``--api-key`` every
port route answers as the JAX server's does (status, the error's message
and type, and a traced 401's ``X-Request-Id``), the probes and
``/metrics`` open.
"""

import asyncio
import dataclasses
import re
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp import web

from production_stack_tpu.engine import server as jax_server
from production_stack_tpu.engine.async_engine import (
    AsyncLLMEngine as JaxAsyncLLMEngine,
)
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu_torch.engine import server as port_server
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import (
    EngineConfig,
    check_parallel,
)
from production_stack_tpu_torch.engine.multihost import start_ranks
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.registry import get_model_config
from production_stack_tpu_torch.parallel.distributed import DistributedConfig

from .test_torch_admin_routes import CHAT, COMMON, MODEL
from .test_torch_tracing import _call, _error

REPO = Path(__file__).resolve().parent.parent
# Flags the deploy layer may emit whose module the port has not yet, each
# with its ROADMAP.md item; the port's parser refuses them. None is left:
# --moe-impl, the last, parses since mixture-of-experts was ported (the
# chart and the operator emit it only through extraArgs).
WAITING: dict = {}
# A value each flag that takes one accepts in both parsers.
VALUES = {"--model": MODEL, "--attn-impl": "pallas", "--warmup": "full",
          "--kv-role": "producer", "--log-format": "json",
          "--quantization": "int4", "--kv-cache-dtype": "float8_e4m3fn",
          "--served-model-name": "served/name", "--host": "0.0.0.0",
          "--remote-kv-url": "http://kv-0:8100,http://kv-1:8100",
          "--cache-controller-url": "http://ctrl:9000", "--api-key": "k",
          "--profile-dir": "/tmp/p", "--flight-snapshot-dir": "/tmp/f",
          "--gpu-memory-utilization": "0.85", "--lora-dir": "/adapters",
          "--scoring-model": "bge", "--compile-cache-dir": "/tmp/c",
          "--kv-transfer-timeout-s": "5", "--moe-impl": "dense"}
# The chart's engine args at its default values (helm/values.yaml's first
# modelSpec, a release named "pst"), written out.
CHART_DEFAULT = [
    "--model", "llama-3-8b",
    "--served-model-name", "meta-llama/Llama-3-8B-Instruct",
    "--host", "0.0.0.0", "--port", "8000",
    "--max-model-len", "8192", "--max-num-seqs", "64",
    "--max-num-batched-tokens", "2048", "--tensor-parallel-size", "8",
    "--pipeline-parallel-size", "1", "--data-parallel-size", "1",
    "--block-size", "32", "--gpu-memory-utilization", "0.9",
    "--attn-impl", "pallas", "--num-decode-steps", "8",
    "--warmup", "full", "--debug-requests-buffer", "256",
    "--log-format", "text", "--flight-buffer", "512",
    "--cpu-offload-blocks", "4096",
    "--remote-kv-url", "http://pst-cache-server-0.pst-cache-server:8100",
    "--kv-replication", "2", "--kv-prefetch-depth", "64",
    "--kv-transfer-timeout-s", "10", "--cache-controller-url",
    "http://pst-kv-controller:9000",
]
# build_engine_deployment's argv for a TPURuntime without engineConfig.
OPERATOR_DEFAULT = [
    "--model", "tiny-llama-debug", "--host", "0.0.0.0", "--port", "8000",
    "--max-model-len", "4096", "--max-num-seqs", "64",
    "--max-num-batched-tokens", "2048", "--tensor-parallel-size", "1",
    "--block-size", "32", "--attn-impl", "auto",
]
AXES = ("tensor", "pipeline", "data", "sequence", "expert")
NEW_FLAGS = [
    ["--served-model-name", "served/name"],
    ["--gpu-memory-utilization", "0.5"], ["--hbm-utilization", "0.7"],
    ["--no-enable-prefix-caching"], ["--enable-prefix-caching"],
    ["--min-decode-bucket", "8"], ["--attn-impl", "gather"],
    ["--attn-impl", "pallas"], ["--no-startup-phases"],
    ["--api-key", "k"], ["--sentry-dsn", "https://key@sentry.invalid/1"],
    *[[f"--{axis}-parallel-size", "1"] for axis in AXES],
    ["--enable-lora", "--max-loras", "4", "--max-lora-rank", "32"],
    *[["--moe-impl", impl] for impl in ("auto", "ragged", "dense")],
]
# The chart's engine args for a modelSpec with lora.enabled.
CHART_LORA = ["--enable-lora", "--lora-dir", "/adapters"]
# ... with scoringModel, and with warmup.cacheDir.
CHART_SCORING = ["--scoring-model", "bge-reranker-base",
                 "--compile-cache-dir", "/var/cache/pst"]


def _flags(text: str) -> set:
    return set(re.findall(r'"(--[a-z0-9][a-z0-9-]*)"', text))


def _deploy_flags() -> set:
    chart = (REPO / "helm/templates/deployment-engine.yaml").read_text()
    operator = (REPO / "operator/src/reconcilers.cc").read_text()
    body = operator.split("Json build_engine_deployment(", 1)[1]
    body = body.split("\n}\n", 1)[0]
    return _flags(chart) | _flags(body)


def _argv(flag: str) -> list:
    """``flag`` alone, or with a value when the JAX parser needs one."""
    try:
        jax_server.parse_engine_args([flag])
        return [flag]
    except SystemExit:
        return [flag, VALUES.get(flag, "1")]


def _refused(argv) -> bool:
    try:
        port_server.parse_engine_args(argv)
    except SystemExit:
        return True
    return False


def test_every_deploy_flag_parses_but_the_waiting_list(capsys):
    flags = _deploy_flags()
    assert {"--tensor-parallel-size", "--gpu-memory-utilization",
            "--attn-impl", "--api-key", "--no-startup-phases",
            "--served-model-name", "--no-enable-prefix-caching"} <= flags
    assert {"--enable-lora", "--lora-dir", "--scoring-model",
            "--compile-cache-dir"} <= flags
    assert WAITING == {}
    # --moe-impl reaches an engine through extraArgs only.
    assert "--moe-impl" not in flags
    for flag in sorted(flags | {"--moe-impl"}):
        argv = _argv(flag)
        assert not _refused(argv), argv
        jax_server.parse_engine_args(argv)
    assert _refused(["--moe-impl", "sparse"])  # the JAX choices only
    capsys.readouterr()  # argparse's usage lines of the refusals


def _shared(a, b) -> tuple:
    names = ({f.name for f in dataclasses.fields(a)}
             & {f.name for f in dataclasses.fields(b)})
    return ({n: getattr(a, n) for n in names},
            {n: getattr(b, n) for n in names})


def test_the_config_equals_the_jax_config():
    """The chart's default render (at one GPU's tensor-parallel size), the
    operator's default argv, and the operator's with each new flag."""
    chart = list(CHART_DEFAULT)
    chart[chart.index("--tensor-parallel-size") + 1] = "1"
    for argv in [chart, chart + CHART_LORA, chart + CHART_SCORING,
                 OPERATOR_DEFAULT,
                 *[OPERATOR_DEFAULT + extra for extra in NEW_FLAGS]]:
        jargs = jax_server.parse_engine_args(argv)
        pargs = port_server.parse_engine_args(argv)
        got, want = _shared(port_server.engine_config_from_args(pargs),
                            jax_server.engine_config_from_args(jargs))
        assert got == want, argv
        # Every field but device (and JAX-only ones), the five parallel
        # sizes included.
        assert len(got) == 54
        assert "moe_impl" in got
        for name in ("api_key", "sentry_dsn", "startup_phases",
                     "scoring_model"):
            assert getattr(pargs, name) == getattr(jargs, name), name
    assert got["compile_cache_dir"] is None
    assert port_server.engine_config_from_args(port_server.parse_engine_args(
        chart + CHART_SCORING)).compile_cache_dir == "/var/cache/pst"


@pytest.mark.parametrize("axis", AXES)
def test_a_parallel_size_above_one_is_refused_at_start(axis):
    """Tensor parallelism parses into the config: the chart's default
    render (tp 8) passes the model's split and fails only on the start's
    checks of the rank count and the devices. The pipeline and data
    sizes parse into the config the same way (the model's layers split
    into 2 stages). The sequence and expert axes above 1 are
    refused with their ROADMAP items' message (15.iii, 15.iv)."""
    if axis in ("sequence", "expert"):
        item = {"sequence": "15.iii", "expert": "15.iv"}[axis]
        with pytest.raises(ValueError, match=f"--{axis}-parallel-size 2.*"
                                             f"item {re.escape(item)} "):
            port_server.engine_config_from_args(port_server.parse_engine_args(
                [*OPERATOR_DEFAULT, f"--{axis}-parallel-size", "2"]))
        return
    if axis != "tensor":
        cfg = port_server.engine_config_from_args(
            port_server.parse_engine_args(
                [*OPERATOR_DEFAULT, f"--{axis}-parallel-size", "2"]))
        assert getattr(cfg, f"{axis}_parallel_size") == 2
        assert cfg.num_ranks == 2 and cfg.device == "cuda"
        check_parallel(cfg, get_model_config(cfg.model))
        with pytest.raises(ValueError, match="does not split over 3"):
            start_ranks(cfg, DistributedConfig("pst-engine-0:1234", 3, 0))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                AsyncLLMEngine(cfg)
        return
    tp = CHART_DEFAULT.index("--tensor-parallel-size")
    assert CHART_DEFAULT[tp + 1] == "8"
    cfg = port_server.engine_config_from_args(
        port_server.parse_engine_args(CHART_DEFAULT))
    assert cfg.tensor_parallel_size == 8 and cfg.device == "cuda"
    check_parallel(cfg, get_model_config(cfg.model))
    with pytest.raises(ValueError, match="does not split over 3"):
        start_ranks(cfg, DistributedConfig("pst-engine-0:1234", 3, 0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            AsyncLLMEngine(cfg)
    # The CUDA kernels are refused on the CPU; the gather path serves there.
    with pytest.raises(ValueError, match="device='cuda'"):
        AsyncLLMEngine(EngineConfig(device="cpu", attn_impl="pallas",
                                    **COMMON))


KEY = "sekrit"
# Every port route, the sleep and drain answered by wake and undrain.
REQUESTS = [
    ("GET", "/health", None), ("GET", "/ready", None),
    ("GET", "/v1/models", None), ("GET", "/metrics", None),
    ("GET", "/version", None), ("GET", "/debug/state", None),
    ("GET", "/debug/requests", None), ("GET", "/debug/flight", None),
    ("GET", "/is_sleeping", None), ("GET", "/is_draining", None),
    ("GET", "/no/such/route", None),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": "Hi",
                                 "max_tokens": 3, "temperature": 0.0}),
    ("POST", "/v1/chat/completions", CHAT),
    ("POST", "/tokenize", {"model": MODEL, "prompt": "Hi"}),
    ("POST", "/detokenize", {"model": MODEL, "tokens": [72, 105]}),
    ("POST", "/debug/profile", {"duration_ms": 10}),
    ("POST", "/sleep?level=1", None), ("POST", "/wake_up", None),
    ("POST", "/drain", None), ("POST", "/undrain", None),
    # LoRA is off on these engines: a load answers 400, an unload
    # removes nothing.
    ("POST", "/v1/load_lora_adapter", {"lora_name": "ad1"}),
    ("POST", "/v1/unload_lora_adapter", {"lora_name": "ad1"}),
    # The encode routes (no scoring model: embedding similarity).
    ("POST", "/v1/embeddings", {"model": MODEL, "input": "Hi"}),
    *[("POST", path, {"model": MODEL, "query": "Hi",
                      "documents": ["a", "b"]})
      for path in ("/rerank", "/v1/rerank", "/v2/rerank")],
    *[("POST", path, {"model": MODEL, "text_1": "Hi", "text_2": "a"})
      for path in ("/score", "/v1/score")],
]


@pytest.fixture(scope="module")
def keyed():
    """{"jax": port, "port": port}: each package's server with
    ``api_key=KEY`` over one tiny engine's weights, and the port's
    server."""
    jeng = JaxAsyncLLMEngine(JaxEngineConfig(**COMMON))
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jeng.engine.runner.params))
    loop = asyncio.new_event_loop()
    started, ports = threading.Event(), {}

    def run_jax():
        asyncio.set_event_loop(loop)
        jeng.start(loop)
        runner = web.AppRunner(jax_server.create_engine_app(jeng,
                                                            api_key=KEY))
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
    engine = AsyncLLMEngine(EngineConfig(device="cpu", **COMMON),
                            params=params)
    server, thread = serve_in_thread(engine, api_key=KEY)
    ports["port"] = server.server_address[1]
    yield ports, server
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    engine.shutdown()
    loop.call_soon_threadsafe(loop.stop)
    jthread.join(timeout=10)
    jeng.shutdown()


def test_api_key_guards_every_route_as_the_jax_server(keyed):
    ports, server = keyed
    for method in ("GET", "POST"):
        assert {p.split("?")[0] for m, p, _ in REQUESTS if m == method} \
            == set(server.routes[method]) | ({"/no/such/route"}
                                            if method == "GET" else set())
    auths = {"none": {}, "wrong": {"Authorization": "Bearer nope"},
             "key": {"Authorization": f"Bearer {KEY}"}}
    answers = {}
    for who, headers in auths.items():
        for method, path, body in REQUESTS:
            got = {side: _call(port, method, path, body, headers)
                   for side, port in ports.items()}
            (js, jb, _), (ps, pb, _) = got["jax"], got["port"]
            assert ps == js, (who, method, path, ps, js, pb, jb)
            if ps >= 400 and isinstance(jb, dict):  # aiohttp's 404 is text
                assert _error(pb) == _error(jb), (who, path)
            answers[who, path] = ps
    open_paths = {"/health", "/ready", "/metrics", "/version",
                  "/is_sleeping", "/is_draining"}
    for method, path, _ in REQUESTS:
        for who in ("none", "wrong"):
            assert (answers[who, path] == 401) == (path not in open_paths)
        if path != "/no/such/route":
            assert answers["key", path] != 401
    assert _error(_call(ports["port"], "GET", "/v1/models")[1]) == (
        "invalid API key", "authentication_error")
    # A traced path's 401 is answered inside its root span: the caller's
    # request id, or a fresh one, rides it on both servers.
    for rid in ({"X-Request-Id": "auth-probe-1"}, {}):
        ids = {}
        for side, port in ports.items():
            status, _, headers = _call(port, "POST", "/v1/completions",
                                       REQUESTS[11][2], rid)
            assert status == 401
            ids[side] = headers.get("x-request-id")
        if rid:
            assert ids == {"jax": "auth-probe-1", "port": "auth-probe-1"}
        else:
            assert all(ids.values())


def test_served_name_and_startup_phases_follow_their_flags():
    argv = ["--device", "cpu", "--model", MODEL, "--num-kv-blocks", "64",
            "--served-model-name", "served/tiny", "--no-startup-phases",
            "--attn-impl", "gather"]
    args = port_server.parse_engine_args(argv)
    engine = AsyncLLMEngine(port_server.engine_config_from_args(args))
    server, thread = serve_in_thread(engine,
                                     **port_server.app_options_from_args(args))
    try:
        port = server.server_address[1]
        status, models, _ = _call(port, "GET", "/v1/models")
        assert status == 200
        assert [m["id"] for m in models["data"]] == ["served/tiny"]
        status, out, _ = _call(port, "POST", "/v1/completions", {
            "model": "served/tiny", "prompt": "Hi", "max_tokens": 2})
        assert status == 200 and out["model"] == "served/tiny"
        text = _call(port, "GET", "/metrics")[1].decode()
        assert "# TYPE pst_engine_startup_seconds gauge" in text
        assert "pst_engine_startup_seconds{" not in text
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    eng = AsyncLLMEngine(EngineConfig(device="cpu", num_kv_blocks=64,
                                      model=MODEL))
    assert eng.engine.telemetry.startup_seconds._children
