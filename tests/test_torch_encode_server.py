"""The encode path's engine and server surface against the JAX package's:
``ModelRunner.encode``, ``/v1/embeddings``, ``/rerank`` (and
``/v1/rerank``, ``/v2/rerank``), ``/score`` (and ``/v1/score``), and the
kernel library's compile cache.

A JAX engine and the port's serve ``tiny-llama-debug`` on the CPU from
the same weights (``params_from_jax``), each behind two apps: one without
a scoring model (pairs scored as the dot product of two embeddings) and
one with a ``tiny-bert-debug`` cross-encoder, the port's built from the
JAX one's weights (``bert_params_from_jax``). Vectors and embedding
scores agree under ``_agree``'s numeric rule (fp32 here), cross-encoder
scores within 1e-4; keys, rankings and statuses are equal. The API key's
401 on each route is ``test_torch_deploy_flags.py``'s.

The runner encodes into the JAX runner's bucket and flight row, and the
lattice holds the JAX encode buckets. A prompt longer than
``max_model_len`` answers 400 on the port (the JAX runner fails inside
numpy: a deliberate difference). ``--compile-cache-dir`` keys the kernel
library's path under ``<dir>/<key>`` without ``nvcc``; a load from it
counts a hit, a build a miss, and both reach ``/metrics``.
"""

import asyncio
import threading

import jax
import numpy as np
import pytest
from aiohttp import web

from production_stack_tpu.engine import precompile as jpre
from production_stack_tpu.engine.async_engine import (
    AsyncLLMEngine as JaxAsyncLLMEngine,
)
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.cross_encoder import (
    CrossEncoder as JaxCrossEncoder,
)
from production_stack_tpu.engine.server import create_engine_app as jax_app
from production_stack_tpu_torch.engine import precompile as tpre
from production_stack_tpu_torch.engine import server as port_server
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.cross_encoder import CrossEncoder
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.models.convert import (
    bert_params_from_jax,
    params_from_jax,
)
from production_stack_tpu_torch.ops import _build

from .test_torch_tracing import _call, _error

MODEL = "tiny-llama-debug"
COMMON = dict(model=MODEL, block_size=8, max_prefill_tokens=32,
              max_model_len=64, num_kv_blocks=64, max_num_seqs=4)
# Every text of the requests below is 9 to 16 bytes: one encode bucket.
EMBED_INPUTS = ["paged attention", ["one kv block", "a second block",
                                    "and a third"], list(range(40, 52)),
                [list(range(60, 70)), list(range(80, 96))]]
RERANK = {"model": MODEL, "query": "which block?",
          "documents": ["block number 1", "the second one", "a third doc"],
          "top_n": 2}
SCORE = {"model": MODEL, "text_1": "which block?",
         "text_2": ["block number 1", "the second one"]}
ROUTES = [("/v1/embeddings", {"model": MODEL, "input": EMBED_INPUTS[0]}),
          ("/rerank", RERANK), ("/v1/rerank", RERANK), ("/v2/rerank", RERANK),
          ("/score", SCORE), ("/v1/score", SCORE)]
CE = "tiny-bert-debug"


@pytest.fixture(scope="module")
def servers():
    """({"jax"|"port": {"plain"|"scoring": port}}, {side: async engine}):
    each side's two apps over one engine."""
    jeng = JaxAsyncLLMEngine(JaxEngineConfig(**COMMON))
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jeng.engine.runner.params))
    jce = JaxCrossEncoder(CE, max_len=64, max_batch=4)
    ce = CrossEncoder(CE, max_len=64, max_batch=4, device="cpu",
                      params=bert_params_from_jax(jax.tree.map(np.asarray,
                                                               jce.params)))
    loop = asyncio.new_event_loop()
    started, ports, runners = threading.Event(), {}, []

    def run_jax():
        asyncio.set_event_loop(loop)
        jeng.start(loop)
        for name, kw in (("plain", {}), ("scoring", {"cross_encoder": jce})):
            runner = web.AppRunner(jax_app(jeng, tracing=False, **kw))
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
    served = {"plain": serve_in_thread(engine, tracing=False),
              "scoring": serve_in_thread(engine, tracing=False,
                                         cross_encoder=ce)}
    yield ({"jax": ports,
            "port": {n: s.server_address[1] for n, (s, _) in served.items()}},
           {"jax": jeng, "port": engine})
    for server, thread in served.values():
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    engine.shutdown()
    loop.call_soon_threadsafe(loop.stop)
    jthread.join(timeout=10)
    jeng.shutdown()


def _agree(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-3 * float(np.abs(want).max()),
                               err_msg=label)


def test_runner_encode_matches_the_jax_runner(servers):
    engines = servers[1]
    jrunner = engines["jax"].engine.runner
    port = engines["port"]
    for ids in ([7], list(range(3, 15))):
        want = jrunner.encode(ids)
        got = port.encode(ids)
        assert got.dtype == np.float32
        _agree(got, want, f"{len(ids)} tokens")
        rows = port.engine.flight.to_payload(n=1)["records"]
        bucket = 1 if len(ids) == 1 else 16
        assert rows[-1]["kind"] == "encode"
        assert rows[-1]["bucket"] == f"t{bucket}"
        assert rows[-1]["tokens"] == len(ids)
    cfg = port.engine.cfg
    jcfg = engines["jax"].engine.cfg
    assert tpre.encode_buckets(cfg) == jpre.encode_buckets(jcfg) == [
        1, 2, 4, 8, 16, 32, 64]
    assert [b.label for b in tpre.enumerate_lattice(cfg)
            if b.kind == "encode"] == [b.label for b in
                                       jpre.enumerate_lattice(jcfg)
                                       if b.kind == "encode"]
    for bad in (list(range(65)), [512], [-1]):
        with pytest.raises(ValueError):
            port.encode(bad)


def _strip(body, approx: str):
    """The body without its id, and its vectors or scores apart."""
    body = {k: v for k, v in body.items() if k != "id"}
    if approx == "embedding":
        vecs = [d.pop("embedding") for d in body["data"]]
        return body, vecs
    if "results" in body:
        scores = [r.pop("relevance_score") for r in body["results"]]
    else:
        scores = [d.pop("score") for d in body["data"]]
    return body, scores


@pytest.mark.parametrize("app", ["plain", "scoring"])
def test_routes_answer_as_the_jax_server(servers, app):
    ports = {side: p[app] for side, p in servers[0].items()}
    method = "cross_encoder" if app == "scoring" else \
        "embedding_cosine_similarity"
    requests = list(ROUTES) + [("/v1/embeddings", {"model": MODEL,
                                                    "input": inp})
                               for inp in EMBED_INPUTS[1:]]
    for path, body in requests:
        got = {side: _call(port, "POST", path, body)
               for side, port in ports.items()}
        (js, jb, _), (ps, pb, _) = got["jax"], got["port"]
        assert ps == js == 200, (path, ps, js, pb)
        kind = "embedding" if path == "/v1/embeddings" else "score"
        (jrest, jvals), (prest, pvals) = _strip(jb, kind), _strip(pb, kind)
        assert prest == jrest, path
        if kind == "embedding":
            _agree(pvals, jvals, f"{path} {body['input']}")
            assert pb["usage"]["prompt_tokens"] == sum(
                len(x) if isinstance(x, list) else len(x.encode())
                for x in port_server.embedding_inputs(body["input"]))
            continue
        assert pb["scoring_method"] == method
        if app == "scoring":
            np.testing.assert_allclose(pvals, jvals, rtol=1e-4, atol=1e-4)
        else:
            _agree(pvals, jvals, path)
        if "results" in pb:  # the ranking, and top_n of it
            assert len(pvals) == 2 and pvals == sorted(pvals, reverse=True)
    # Past max_model_len: a 400 on the port (the JAX server fails in numpy).
    status, body, _ = _call(ports["port"], "POST", "/v1/embeddings",
                            {"model": MODEL, "input": list(range(1, 66))})
    assert status == 400 and "max_model_len" in _error(body)[0]
    status, body, _ = _call(ports["port"], "POST", "/v1/embeddings",
                            {"model": MODEL, "input": {"not": "text"}})
    assert status == 400 and _error(body)[1] == "invalid_request_error"


def test_gates_answer_as_the_jax_server(servers, monkeypatch):
    ports = {side: p["plain"] for side, p in servers[0].items()}
    engines = servers[1]
    spent = {"X-PST-Deadline-Ms": "0"}
    for path, body in ROUTES:
        for side, port in ports.items():
            status, out, headers = _call(port, "POST", path, body, spent)
            assert status == 504, (side, path)
            assert headers.get("x-pst-deadline-exceeded") == "1"
    # Warming: the JAX engine warms only before its loop starts, so its
    # flag is set; the port's step thread warms when its flag is set, so
    # its warmup is held until the requests are answered.
    entered, release = threading.Event(), threading.Event()

    def held_precompile(*args, **kwargs):
        entered.set()
        assert release.wait(timeout=30)
        return {}

    monkeypatch.setattr(engines["port"].engine, "precompile",
                        held_precompile)
    for gate, header in (("drain", "x-pst-draining"),
                         ("warming", "x-pst-warming")):
        for eng in engines.values():
            if gate == "drain":
                eng.drain()
            else:
                eng._warming = True
        engines["port"]._work.set()
        if gate == "warming":
            assert entered.wait(timeout=30)
        try:
            for path, body in ROUTES:
                answers = {side: _call(port, "POST", path, body)
                           for side, port in ports.items()}
                for side, (status, out, headers) in answers.items():
                    assert status == 503, (gate, side, path)
                    assert headers.get(header) == "1", (gate, side, path)
                    assert _error(out)[1] == "service_unavailable"
        finally:
            engines["port"].undrain()
            engines["jax"].undrain()
            if gate == "warming":
                engines["jax"]._warming = False
                release.set()
    for _ in range(300):  # the port's held warmup has returned
        if not engines["port"].warming:
            break
        threading.Event().wait(0.01)
    assert not engines["port"].warming


def test_compile_cache_dir_keys_the_library_and_counts(tmp_path, servers,
                                                       monkeypatch):
    argv = ["--model", MODEL, "--device", "cpu", "--compile-cache-dir",
            str(tmp_path), "--scoring-model", CE]
    args = port_server.parse_engine_args(argv)
    assert port_server.engine_config_from_args(args).compile_cache_dir == \
        str(tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/no/such/nvcc")
    counts = dict(_build.cache_counts)
    try:
        key = _build.compile_cache_key()
        assert len(key) == 16 and int(key, 16) >= 0
        path = _build.set_compile_cache_dir(str(tmp_path))
        assert path == tmp_path / key
        lib = _build.library_path()
        assert lib.parent == tmp_path / key
        assert lib.name == f"libpst_torch_kernels_{_build._digest()}.so"
        # No library there: a build, which counts a miss (and fails here,
        # without nvcc). Then a library in place: a load, a hit.
        with pytest.raises(OSError):
            _build.build()
        lib.parent.mkdir(parents=True, exist_ok=True)
        lib.write_bytes(b"")
        assert _build.build() == lib and _build.last_build_seconds == 0.0
        assert _build.cache_counts == {"hits": counts["hits"] + 1,
                                       "misses": counts["misses"] + 1}
        port = servers[0]["port"]["plain"]
        text = _call(port, "GET", "/metrics")[1].decode()
        for name in ("hits", "misses"):
            assert (f"pst_engine_compile_cache_{name}_total "
                    f"{float(_build.cache_counts[name])}") in text, name
        state = _call(port, "GET", "/debug/state")[1]["stats"]
        assert state["kernel_build_seconds"] == 0.0
    finally:
        _build.set_compile_cache_dir(None)
        _build.cache_counts.update(counts)
    assert _build.library_path().parent == _build.BUILD_DIR
