"""The port's KV tiers, disaggregated handoff and controller registration
against the JAX engine's, on the CPU (``tiny-llama-debug``, the same
weights through ``params_from_jax``).

- A small-pool engine with a host tier, or a remote tier on a kvserver,
  serves the JAX engine's greedy tokens on one trace (a prompt, two
  others that evict its pages, the prompt again) with the same spilled,
  host-hit and remote-hit counts.
- With a host tier, a swap-in whose committed pages were evicted faults
  them back up instead of recomputing, in both engines.
- A JAX producer engine publishes a prefill to the port's kvserver; the
  port's consumer engine prefetches it and serves the JAX fused run's
  tokens.
- The chunk hashes a port server registers with the port's controller
  are the JAX engine's, and ``/lookup`` finds them.
- Two port servers run the router's handoff: ``kv_transfer_params``
  read as the JAX server reads them, the consumer's prefetch counted in
  ``/metrics`` and the ``kv_prefetch`` stage, and a dropped manifest
  degrading to the fused path with one fallback and a 200.
"""

import http.client
import json
import time
import types

import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.engine.server import (
    _kv_transfer_params as jax_kv_transfer_params,
)
from production_stack_tpu.kvcache.hashing import chunk_hashes as jax_chunks
from production_stack_tpu.kvserver.controller import (
    ControllerState as JaxControllerState,
)
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import (
    _kv_transfer_params,
    register_with_controller,
    serve_in_thread,
)
from production_stack_tpu_torch.kvcache.hashing import CHUNK_TOKENS
from production_stack_tpu_torch.kvserver.controller import ControllerServer
from production_stack_tpu_torch.kvserver.server import KVServer, start_in_thread
from production_stack_tpu_torch.models.convert import params_from_jax

from .test_torch_kv_swap import LENGTHS, MAX_TOKENS, SMALL, SWAP_KEYS
from .test_torch_overlap_decode import _reqs, _run

# 24 eight-token pages: a 64-token prompt takes 9, two more evict it.
TIER = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
            num_kv_blocks=24, max_num_seqs=4, max_prefill_tokens=64,
            overlap_decode=False)
BIG = dict(TIER, num_kv_blocks=96)
TIER_KEYS = ("kv_offload_host_hit_blocks", "kv_offload_remote_hit_blocks",
             "kv_offload_spilled_blocks")


def _jax(cfg, **over):
    return JaxLLMEngine(JaxEngineConfig(**{**cfg, "attn_impl": "gather",
                                           "async_decode": False, **over}))


def _params(jax_engine):
    return params_from_jax(jax.tree.map(np.asarray, jax_engine.runner.params))


def _port(cfg, params, **over):
    return LLMEngine(EngineConfig(**{**cfg, "device": "cpu", **over}),
                     params=params)


@pytest.fixture
def kv_store():
    server = KVServer(("127.0.0.1", 0), 1 << 30)
    thread = start_in_thread(server)
    yield server
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _pushed(engine, store, timeout: float = 30.0) -> None:
    """Wait until every spilled page reached the store (the push worker
    runs on its own thread)."""
    t0 = time.monotonic()
    while store.stats()["blocks_put"] < engine.allocator.spilled_blocks:
        assert time.monotonic() - t0 < timeout, "spills never reached the store"
        time.sleep(0.01)


def _evicting_trace(engine, sp_cls, store=None) -> list:
    rng = np.random.default_rng(1)
    a, b, c = (rng.integers(1, 500, 64).tolist() for _ in range(3))
    sp = sp_cls(max_tokens=4, temperature=0.0, ignore_eos=True)
    out = [engine.generate([a], sp)[0]["token_ids"]]
    out += [r["token_ids"] for r in engine.generate([b, c], sp)]
    if store is not None:
        _pushed(engine, store)
    out.append(engine.generate([a], sp)[0]["token_ids"])
    return out


@pytest.mark.parametrize("tier", ["host", "remote"])
def test_tiered_engine_serves_the_jax_engines_tokens(tier):
    stores = [KVServer(("127.0.0.1", 0), 1 << 30) for _ in range(2)]
    threads = [start_in_thread(s) for s in stores]
    try:
        over = [dict(cpu_offload_blocks=64) if tier == "host"
                else dict(remote_kv_url=s.url) for s in stores]
        jeng = _jax(TIER, **over[0])
        want = _evicting_trace(jeng, JaxSamplingParams,
                               stores[0] if tier == "remote" else None)
        port = _port(TIER, _params(jeng), **over[1])
        got = _evicting_trace(port, SamplingParams,
                              stores[1] if tier == "remote" else None)
        assert got == want
        assert got[0] == got[-1]  # the refetched prefix serves A again
        js, ps = jeng.stats(), port.stats()
        for key in TIER_KEYS:
            assert ps[key] == js[key], key
        hit = "kv_offload_host_hit_blocks" if tier == "host" else \
            "kv_offload_remote_hit_blocks"
        assert ps["kv_offload_spilled_blocks"] > 0 and ps[hit] > 0
        if tier == "remote":
            assert ps["kv_integrity_failures_total"] == 0
            assert stores[1].stats()["num_blocks"] == \
                stores[0].stats()["num_blocks"] > 0
        port.shutdown()
        assert port.allocator._push_thread is None
    finally:
        for s, t in zip(stores, threads):
            s.shutdown()
            s.server_close()
            t.join(timeout=10)


def test_swap_in_faults_evicted_pages_up_instead_of_recomputing():
    """test_torch_kv_swap's trace, where committed pages of parked
    sequences are taken by others' growth (recompute fallbacks without a
    lower tier), with a host tier: every swap-in resumes."""
    over = dict(kv_swap=True, swap_quantum_tokens=16, cpu_offload_blocks=64)
    jeng = _jax(SMALL, **over)
    port = _port(SMALL, _params(jeng), **over)
    _, want = _run(jeng, _reqs(LENGTHS, MAX_TOKENS, JaxSamplingParams,
                               temperature=0.0))
    _, got = _run(port, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                              temperature=0.0))
    assert got == want
    js, ps = jeng.stats(), port.stats()
    for key in SWAP_KEYS + TIER_KEYS:
        assert ps.get(key) == js.get(key), key
    assert ps["kv_swap_out_total"] > 0
    assert ps["kv_swap_fallback_recompute_total"] == 0
    assert ps["kv_swap_in_total"] == ps["kv_swap_out_total"]
    assert ps["kv_offload_host_hit_blocks"] > 0
    assert port.allocator.num_free == port.allocator.num_blocks


def test_port_consumer_of_a_jax_producer(kv_store):
    prompt = np.random.default_rng(2).integers(1, 500, 60).tolist()
    producer = _jax(BIG, remote_kv_url=kv_store.url, kv_role="producer")
    producer.add_request("p", prompt_token_ids=prompt,
                         sampling=JaxSamplingParams(max_tokens=1,
                                                    temperature=0.0),
                         kv_transfer={"request_id": "x1", "role": "producer"})
    while producer.has_work():
        producer.step()
    consumer = _port(BIG, _params(producer), remote_kv_url=kv_store.url,
                     kv_role="consumer")
    assert consumer.kv_publisher is None
    assert consumer.allocator.host_pool.max_blocks == 1024  # staging only
    fetch = consumer.kv_prefetcher.prefetch("x1")
    assert fetch["complete"] and fetch["blocks"] == fetch["total_blocks"] == 7
    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    consumer.add_request("c", prompt_token_ids=prompt,
                         sampling=SamplingParams(**sp),
                         kv_transfer={"request_id": "x1", "role": "consumer"})
    toks = []
    while consumer.has_work():
        for out in consumer.step():
            toks += out.new_token_ids
    fused = _jax(BIG).generate([prompt], JaxSamplingParams(**sp))
    assert toks == fused[0]["token_ids"]
    stats = consumer.stats()
    assert stats["kv_prefetched_blocks_total"] == 7
    assert stats["kv_transfer_fallbacks_total"] == 0
    # (60 - 1) // 8 pages matched, all from the staging pool.
    assert stats["kv_offload_host_hit_blocks"] == 7
    assert stats["prefix_cache_hits_total"] == 56
    consumer.shutdown()
    producer.kv_publisher.shutdown()


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, (json.loads(raw) if raw.startswith(b"{") else
                         raw.decode())


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rpartition(" ")[2])
    raise AssertionError(f"{name} not in /metrics")


def test_registered_chunk_hashes_are_the_jax_engines():
    controller = ControllerServer(("127.0.0.1", 0))
    cthread = start_in_thread(controller)
    prompt = np.random.default_rng(3).integers(
        1, 500, 2 * CHUNK_TOKENS + 8).tolist()
    cfg = dict(TIER, num_kv_blocks=96, max_model_len=1024)
    jeng = _jax(cfg)
    engine = AsyncLLMEngine(EngineConfig(
        **cfg, device="cpu", cache_controller_url=controller.url,
        engine_url="http://engine-a:8000"), params=_params(jeng))
    server, thread = serve_in_thread(engine)
    try:
        status, _ = _call(server.server_address[1], "POST", "/v1/completions",
                          {"prompt": prompt, "max_tokens": 2,
                           "temperature": 0.0})
        assert status == 200
        jeng.generate([prompt], JaxSamplingParams(max_tokens=2))
        got = engine.engine.registered_chunk_hashes()
        assert got == list(jeng.resident_chunk_hashes) == jax_chunks(prompt)
        assert register_with_controller(engine, controller.url,
                                        "http://engine-a:8000")
        status, body = _call(controller.server_address[1], "POST", "/lookup",
                             {"model": engine.engine.model_name,
                              "hashes": jax_chunks(prompt)})
        ref = JaxControllerState()
        ref.register("http://engine-a:8000", engine.engine.model_name,
                     list(jeng.resident_chunk_hashes), True)
        assert body == {"matches": ref.lookup(engine.engine.model_name,
                                              jax_chunks(prompt))}
        assert body["matches"] == {"http://engine-a:8000": 2 * CHUNK_TOKENS}
        # A level-2 sleep forgets the claims, as the JAX engine does.
        engine.sleep(level=2)
        assert engine.engine.registered_chunk_hashes() == []
        engine.wake_up()
        assert not register_with_controller(
            types.SimpleNamespace(engine=engine.engine),
            "http://127.0.0.1:9", "http://engine-a:8000")  # refused: False
    finally:
        server.controller_reports.set()
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
        controller.shutdown()
        controller.server_close()
        cthread.join(timeout=10)


def _recording(engine: AsyncLLMEngine) -> list:
    """Record each request's token ids as the server collects them."""
    seen, generate = [], engine.generate

    def recording(*args, **kw):
        toks = []
        seen.append(toks)
        for out in generate(*args, **kw):
            toks.extend(out.new_token_ids)
            yield out

    engine.generate = recording
    return seen


def test_router_handoff_between_port_servers(kv_store):
    for raw in ({"request_id": "r1", "role": "consumer", "pool": "d"},
                {"request_id": 7}, {"role": "producer"}, "x", None,
                {"request_id": "r2", "role": ""}):
        assert _kv_transfer_params({"kv_transfer_params": raw}) == \
            jax_kv_transfer_params(types.SimpleNamespace(
                kv_transfer_params=raw))
    jeng = _jax(BIG)
    params = _params(jeng)
    common = dict(BIG, device="cpu", remote_kv_url=kv_store.url,
                  kv_transfer_timeout_s=1.0)
    producer = AsyncLLMEngine(EngineConfig(**common, kv_role="producer"),
                              params=params)
    consumer = AsyncLLMEngine(EngineConfig(**common, kv_role="consumer"),
                              params=params)
    ptoks, ctoks = _recording(producer), _recording(consumer)
    served = [serve_in_thread(e) for e in (producer, consumer)]
    pport, cport = (s.server_address[1] for s, _ in served)
    rng = np.random.default_rng(4)
    body = dict(max_tokens=6, temperature=0.0, ignore_eos=True)

    def leg(port, prompt, rid, role, max_tokens=None):
        status, out = _call(port, "POST", "/v1/completions", {
            **body, "prompt": prompt, "max_tokens": max_tokens or 6,
            "kv_transfer_params": {"request_id": rid, "role": role,
                                   "pool": "p"}})
        assert status == 200, out
        return out["usage"]

    try:
        for i, rid in enumerate(("t1", "t2")):
            prompt = rng.integers(1, 500, 60).tolist()
            if i:  # the manifest is lost: the consumer computes it all
                _call(kv_store.server_address[1], "POST", "/admin/fail",
                      {"mode": "drop_manifest"})
            assert leg(pport, prompt, rid, "producer",
                       max_tokens=1)["completion_tokens"] == 1
            leg(cport, prompt, rid, "consumer")
            # The producer's answer over its own (published) pages.
            assert _call(pport, "POST", "/v1/completions",
                         {**body, "prompt": prompt})[0] == 200
            assert ctoks[-1] == ptoks[-1] and len(ctoks[-1]) == 6
            metrics = _call(cport, "GET", "/metrics")[1]
            assert _metric(metrics, "pst:kv_prefetched_blocks_total") == 7
            assert _metric(metrics, "pst:kv_transfer_fallbacks_total") == i
            assert _metric(
                metrics, 'pst_stage_duration_seconds_count{component='
                '"engine",stage="kv_prefetch"}') == i + 1
            assert _metric(metrics, 'pst_kv_integrity_failures_total{'
                                    'source="prefetch"}') == 0
        # The second prompt's pages came from the store's blocks (the
        # manifest was lost, the pages were not).
        stats = consumer.engine.stats()
        assert stats["kv_offload_host_hit_blocks"] == 7
        assert stats["kv_offload_remote_hit_blocks"] == 7
        assert _metric(metrics, 'pst_stage_duration_seconds_count{component='
                                '"engine",stage="kv_fetch_host"}') == 7
        assert _metric(metrics, "pst_kv_read_repairs_total") == 0
        pm = _call(pport, "GET", "/metrics")[1]
        assert _metric(pm, "pst:kv_published_blocks_total") == 14
    finally:
        _call(kv_store.server_address[1], "POST", "/admin/heal")
        for (server, thread), engine in zip(served, (producer, consumer)):
            server.shutdown()
            server.server_close()
            engine.shutdown()
            thread.join(timeout=10)
