"""The PyTorch engine server's chat, token and admin routes against the
JAX server's, and a level-2 sleep that drops every step graph.

A JAX server (aiohttp, on its own event loop thread) and the port's
server serve ``tiny-llama-debug`` on the CPU from the same weights
(``params_from_jax``), each with cost attribution and tracing off (two
engines bill their own device seconds). The same requests to both must
give the same status codes, headers and bodies, ids and timestamps
aside. The sleep test puts
a stand-in for ``torch.cuda.CUDAGraph`` into the port's runner, whose
replay reruns the captured step, and holds the greedy tokens of a prompt
that filled the prefix cache before a level-2 sleep to its first, fresh
run's and to the JAX engine's.
"""

import asyncio
import http.client
import json
import threading

import jax
import numpy as np
import pytest
from aiohttp import web

from production_stack_tpu.engine.async_engine import (
    AsyncLLMEngine as JaxAsyncLLMEngine,
)
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.engine.server import create_engine_app as jax_app
from production_stack_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from production_stack_tpu.protocols import ChatMessage as JaxChatMessage
from production_stack_tpu_torch.engine import runner as runner_mod
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    ChatMessage,
)
from production_stack_tpu_torch.models.convert import params_from_jax

from .test_torch_precompile import StandInGraph

MODEL = "tiny-llama-debug"
COMMON = dict(model=MODEL, block_size=8, max_prefill_tokens=32,
              max_model_len=256, num_kv_blocks=128, max_num_seqs=4)
MESSAGES = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": [{"type": "text", "text": "Hi "},
                                         {"type": "image_url"},
                                         {"type": "text", "text": "there"}]}]
CHAT = {"model": MODEL, "messages": MESSAGES, "max_tokens": 6,
        "temperature": 0.0, "ignore_eos": True}


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw, {k.lower(): v for k, v in resp.getheaders()}


def _json(port, method, path, body=None):
    status, raw, headers = _call(port, method, path, body)
    return status, json.loads(raw), headers


def _frames(raw: bytes) -> list:
    return [json.loads(ln[6:]) if ln[6:] != b"[DONE]" else "[DONE]"
            for ln in raw.split(b"\n") if ln.startswith(b"data: ")]


# Logprobs are float32 sums in another order on each side.
LOGPROB_ATOL = 1e-5


def _same(got, want) -> bool:
    """Equal bodies, ids and timestamps aside, floats within
    ``LOGPROB_ATOL``."""
    if isinstance(want, dict):
        keys = set(want) - {"id", "created"}
        return (isinstance(got, dict) and set(got) - {"id", "created"} == keys
                and all(_same(got[k], want[k]) for k in keys))
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(_same(g, w) for g, w in zip(got, want)))
    if isinstance(want, float) and not isinstance(got, bool):
        return isinstance(got, (int, float)) and abs(got - want) <= LOGPROB_ATOL
    return got == want


@pytest.fixture(scope="module")
def jax_params():
    engine = JaxLLMEngine(JaxEngineConfig(num_decode_steps=1, **COMMON))
    return engine, params_from_jax(jax.tree.map(np.asarray,
                                                engine.runner.params))


@pytest.fixture(scope="module")
def servers(jax_params):
    """(JAX port, port's port) of two servers of the same weights."""
    _, params = jax_params
    loop = asyncio.new_event_loop()
    # The same seed as the first JAX engine's: the same weights.
    jeng = JaxAsyncLLMEngine(JaxEngineConfig(cost_attribution=False,
                                             **COMMON))
    started, box = threading.Event(), {}

    def run_jax():
        asyncio.set_event_loop(loop)
        jeng.start(loop)
        runner = web.AppRunner(jax_app(jeng, tracing=False))
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        box["port"], box["runner"] = site._server.sockets[0].getsockname()[1], runner
        started.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())

    jthread = threading.Thread(target=run_jax, daemon=True)
    jthread.start()
    assert started.wait(timeout=60)
    # Cost attribution and tracing off, as the JAX server's above.
    engine = AsyncLLMEngine(EngineConfig(device="cpu", num_decode_steps=2,
                                         cost_attribution=False, **COMMON),
                            params=params)
    server, thread = serve_in_thread(engine, tracing=False)
    yield box["port"], server.server_address[1], engine
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)
    loop.call_soon_threadsafe(loop.stop)
    jthread.join(timeout=10)
    jeng.shutdown()
    assert not thread.is_alive() and not jthread.is_alive()


def test_chat_template_equals_jax():
    cases = [
        (MESSAGES, {}),
        ([{"role": "user", "content": "plain"}], {}),
        (MESSAGES, dict(add_generation_prompt=False)),
        (MESSAGES + [{"role": "assistant", "content": "Hello, w"}],
         dict(add_generation_prompt=False, continue_final_message=True)),
        ([{"role": "tool", "content": None, "name": "x"}], {}),
    ]
    for messages, kw in cases:
        want = JaxBytes().apply_chat_template(
            [JaxChatMessage(**m) for m in messages], **kw)
        got = ByteTokenizer().apply_chat_template(
            [ChatMessage.from_dict(m) for m in messages], **kw)
        assert got == want, (messages, kw)
    assert got == "<|tool|>\n\n<|assistant|>\n"
    # The continued turn stays open: no terminator, no new turn.
    assert ByteTokenizer().apply_chat_template(
        [ChatMessage.from_dict(m) for m in cases[3][0]],
        continue_final_message=True).endswith("<|assistant|>\nHello, w")
    with pytest.raises(ValueError):
        ChatMessage.from_dict({"role": "robot", "content": "x"})


def test_chat_and_tokens_answer_as_the_jax_server(servers):
    jport, port, _ = servers
    for body in (CHAT, dict(CHAT, logprobs=True, top_logprobs=2),
                 dict(CHAT, continue_final_message=True, messages=MESSAGES + [
                     {"role": "assistant", "content": "Sure"}])):
        want, got = (_json(p, "POST", "/v1/chat/completions", body)
                     for p in (jport, port))
        assert got[0] == want[0] == 200
        assert _same(got[1], want[1]), (got[1], want[1])
        assert got[1]["object"] == "chat.completion"
        assert got[1]["id"].startswith("chatcmpl-")
        assert got[2]["x-request-id"] == got[1]["id"]
    stream = dict(CHAT, stream=True, stream_options={"include_usage": True})
    want, got = (_call(p, "POST", "/v1/chat/completions", stream)
                 for p in (jport, port))
    assert got[0] == want[0] == 200
    assert got[2]["content-type"].startswith("text/event-stream")
    frames = _frames(got[1])
    assert _same(frames, _frames(want[1]))
    assert frames[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert frames[-1] == "[DONE]" and len(frames) == 6 + 2
    assert {f["object"] for f in frames[:-1]} == {"chat.completion.chunk"}
    for body in ({"prompt": "héllo"}, {"messages": MESSAGES},
                 {"prompt": "x", "add_special_tokens": False}):
        want, got = (_json(p, "POST", "/tokenize", body)
                     for p in (jport, port))
        assert got[:2] == want[:2] and got[0] == 200
    ids = got[1]["tokens"]
    want, got = (_json(p, "POST", "/detokenize", {"tokens": ids})
                 for p in (jport, port))
    assert got[:2] == want[:2] and got[1] == {"prompt": "x"}
    # The chat's prompt is /tokenize of its messages.
    usage = _json(port, "POST", "/v1/chat/completions", CHAT)[1]["usage"]
    count = _json(port, "POST", "/tokenize", {"messages": MESSAGES})[1]
    assert usage["prompt_tokens"] == count["count"]


def test_drain_and_sleep_answer_as_the_jax_server(servers):
    jport, port, _ = servers
    steps = [
        ("POST", "/drain?wait=1&timeout=5"), ("GET", "/is_draining"),
        ("GET", "/health"), ("GET", "/ready"),
        ("POST", "/v1/completions"), ("POST", "/v1/chat/completions"),
        ("POST", "/undrain"), ("GET", "/is_draining"), ("GET", "/ready"),
        ("POST", "/sleep?level=1"), ("GET", "/is_sleeping"),
        ("GET", "/ready"), ("POST", "/v1/completions"),
        ("POST", "/wake_up"), ("GET", "/is_sleeping"), ("GET", "/ready"),
        ("POST", "/sleep"), ("POST", "/wake_up"), ("GET", "/health"),
    ]
    body = {"model": MODEL, "prompt": "a", "max_tokens": 1,
            "messages": MESSAGES}
    for method, path in steps:
        answers = []
        for p in (jport, port):
            status, raw, headers = _call(
                p, method, path, body if method == "POST" else None)
            answers.append((status, json.loads(raw),
                            headers.get("x-pst-draining")))
        want, got = answers
        assert got[0] == want[0] and got[2] == want[2], (path, got, want)
        if "error" in got[1]:  # the port's errors keep the OpenAI shape
            assert got[1]["error"]["message"] == want[1]["message"]
            assert got[1]["error"]["type"] == want[1]["type"]
        else:
            assert got[1] == want[1], (path, got, want)
    for path in ("/version", "/debug/state"):
        want, got = (_json(p, "GET", path) for p in (jport, port))
        assert got[0] == want[0] == 200
        assert set(got[1]) == set(want[1]), path
    state = got[1]
    # The flight recorder's stats: the JAX ring's size and fields.
    assert set(state["flight"]) == set(want[1]["flight"])
    assert state["flight"]["capacity"] == want[1]["flight"]["capacity"] == 512
    assert state["in_flight"] == 0
    assert state["compiles_total"] == state["stats"]["graphs_captured"] == 0


class ReplayingGraph(StandInGraph):
    """The stand-in graph, whose replay reruns the captured step into the
    captured output (a step's rows, or a burst's rows and carry: the
    engine's tokens stay right), and which records every replay."""

    made: list = []

    def __init__(self):
        self.replays = 0
        ReplayingGraph.made.append(self)

    def replay(self):
        self.replays += 1
        new = self.fn()
        if isinstance(self.out, dict):
            for k, v in self.out.items():
                v.copy_(new[k])
        else:
            self.out.copy_(new)


def _capture(graph, fn, pool=None):
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    graph.fn, graph.out = fn, fn()
    graph.capture_end()
    return graph.out


P = np.random.default_rng(13).integers(1, 512, 40).tolist()
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)


def test_level2_sleep_drops_every_graph_and_the_prefix_map(
        jax_params, monkeypatch):
    jax_engine, params = jax_params
    want = jax_engine.generate([list(P)], JaxSamplingParams(**GREEDY))[0]
    monkeypatch.setattr(runner_mod, "capture", _capture)
    ReplayingGraph.made = []
    # Synchronous decode: the graphs it captures do not depend on the
    # wall clock.
    engine = AsyncLLMEngine(EngineConfig(device="cpu", num_decode_steps=2,
                                         warmup="lazy", overlap_decode=False,
                                         **COMMON),
                            params=params)
    runner = engine.engine.runner
    runner._graph_cls = ReplayingGraph
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]

    def run():
        hits = engine.engine.stats()["prefix_cache_hits_total"]
        toks = [t for out in engine.generate(
            prompt_token_ids=list(P), sampling=SamplingParams(**GREEDY))
            for t in out.new_token_ids]
        return toks, engine.engine.stats()["prefix_cache_hits_total"] - hits

    try:
        assert _json(port, "GET", "/ready")[0] in (200, 503)
        while engine.warming:
            threading.Event().wait(0.01)
        fresh, hits = run()
        assert hits == 0 and fresh == want["token_ids"]
        hit, hits = run()
        assert hits > 0 and len(hit) == 8
        before = list(ReplayingGraph.made)
        assert before and runner.graph_counts["replayed"] > 0
        captured = runner.graph_counts["captured"]
        assert captured == len(runner._graphs) == len(before)

        assert _json(port, "POST", "/sleep?level=2")[1] == {
            "status": "sleeping", "level": 2}
        assert runner.kv_cache is None and not runner._graphs
        assert not engine.engine.allocator._block_of_hash
        stats = engine.engine.stats()
        assert stats["graphs_dropped"] == captured
        assert stats["graph_pool_bytes"] == 0
        replays = [g.replays for g in before]

        assert _json(port, "POST", "/wake_up")[1] == {"status": "awake"}
        status, body, _ = _json(port, "GET", "/ready")
        assert body["ready"] or body["reason"] == "warming"
        while not _json(port, "GET", "/ready")[1]["ready"]:
            threading.Event().wait(0.01)
        again, hits = run()
        assert hits == 0, "a prompt adopted a dropped page as a cache hit"
        assert again == fresh == want["token_ids"]
        assert [g.replays for g in before] == replays, (
            "a graph captured before the sleep replayed after it")
        assert runner.graph_counts["captured"] > captured
        assert len(runner._graphs) == len(ReplayingGraph.made) - len(before)
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_routes_take_query_strings(servers):
    _, port, engine = servers
    assert _json(port, "GET", "/health?verbose=1")[:2] == (
        200, {"status": "ok"})
    status, body, _ = _json(port, "GET", "/no/such/route?x=1")
    assert status == 404 and body["error"]["message"] == "no route /no/such/route"
    assert _json(port, "POST", "/sleep?level=two")[0] == 400
    assert not engine.sleeping
    # A drain with wait=1 holds its answer until the request in flight ends.
    done = threading.Event()

    def slow():
        _json(port, "POST", "/v1/completions", {
            "prompt": list(P), "max_tokens": 40, "temperature": 0.0,
            "ignore_eos": True})
        done.set()

    t = threading.Thread(target=slow)
    t.start()
    while engine.num_inflight() == 0 and not done.is_set():
        threading.Event().wait(0.001)
    status, body, _ = _json(port, "POST", "/drain?wait=1&timeout=30")
    assert status == 200 and body == {"status": "draining", "in_flight": 0}
    assert done.wait(timeout=30)
    t.join(timeout=10)
    assert _json(port, "POST", "/undrain")[1]["status"] == "accepting"
    status, body, _ = _json(port, "POST", "/sleep?level=1&unused=x")
    assert body == {"status": "sleeping", "level": 1} and engine.sleeping
    assert _json(port, "POST", "/wake_up?now=1")[1] == {"status": "awake"}
    assert not engine.sleeping
