"""The port's flight recorder and per-request cost attribution against the
JAX package's, on the CPU (the cases of ``tests/test_flight_cost.py``).

- The port's ``FlightRecorder`` and the JAX one, fed the same steps, keep
  the same rings, outlier and compile snapshots and stats; the null
  recorder records nothing and a probe that raises never fails a step.
- Snapshots persisted under ``--flight-snapshot-dir`` come back at
  ``GET /debug/flight?snapshots=1`` after a restart, and the JAX reader
  reads the port's files.
- Finished requests' device seconds sum to
  ``pst_engine_device_busy_seconds`` within the JAX test's 0.9-1.1 with
  pipelined decode on and off, and the payload has its five fields.
- The per-tenant meter, an abort's bill, ``--no-cost-attribution``, and
  the defaults of the config and the flags, which are the JAX ones.
- The flight rows of a tiny engine equal the JAX engine's for the same
  requests with pipelining off.
"""

import json
import math

import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.engine.server import (
    parse_engine_args as jax_parse_engine_args,
)
from production_stack_tpu.obs.flight import FlightRecorder as JaxRecorder
from production_stack_tpu.obs.flight import load_snapshot_dir as jax_load
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import (
    app_options_from_args,
    engine_config_from_args,
    parse_engine_args,
    serve_in_thread,
)
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.obs.flight import (
    NULL_FLIGHT_RECORDER,
    FlightRecorder,
)

from .test_torch_tracing import _call

TINY = dict(model="tiny-llama-debug", max_model_len=256, block_size=16,
            num_kv_blocks=128, max_num_seqs=8)
COST_FIELDS = {"prefill_device_s", "decode_device_s", "device_s",
               "kv_page_s", "queue_s"}


def _feed(rec) -> dict:
    """The JAX test's steps: a bounded ring under load, a stall past its
    bucket's median, a compile, small steps under the floor, and a probe
    that raises. Returns what the recorder shows, times aside."""
    state = {"waiting": 3, "running": 7, "swapped": 1, "batch_tier_rows": 2,
             "kv_occupancy": 0.83, "preemptions": 4}
    rec.set_probe(lambda: state)
    for _ in range(100):
        rec.record_step("decode", "b8", 0.001, tokens=8)
    for _ in range(16):
        rec.record_step("decode", "b8xn4", 0.03, tokens=32)
    rec.record_step("decode", "b8xn4", 1.5, tokens=32)  # the stall
    rec.record_step("prefill", "b1xt512", 0.8, compiled=True)
    for _ in range(16):  # the compile set no baseline
        rec.record_step("prefill", "b1xt512", 0.01)
    rec.record_step("prefill", "b1xt512", 0.2)
    for _ in range(16):
        rec.record_step("decode", "b4", 0.002)
    rec.record_step("decode", "b4", 0.02)  # 10x the median, under 50 ms

    def bad_probe():
        raise RuntimeError("scheduler went away")

    rec.set_probe(bad_probe)
    rec.note_host_gap(0.004)
    rec.record_step("decode", "b2", 0.001)

    def timeless(rows):
        return [{k: v for k, v in r.items() if k != "ts"} for r in rows]

    payload = rec.to_payload(n=40)
    return {
        "stats": rec.stats(), "fields": payload["fields"],
        "records": timeless(payload["records"]),
        "window": len(rec.records(window_s=60.0)),
        "empty_window": rec.records(window_s=1e-9),
        "ring": len(rec._ring),
        "snapshots": [(s["reason"], s["detail"], s["total_steps"],
                       timeless(s["records"])) for s in rec.snapshots()],
    }


def test_flight_recorder_keeps_what_the_jax_one_keeps():
    got, want = _feed(FlightRecorder(capacity=32)), _feed(JaxRecorder(
        capacity=32))
    assert got == want
    assert got["ring"] == 32 and got["stats"]["resident"] == 32
    assert [s[0] for s in got["snapshots"]] == ["tail_outlier", "compile",
                                                "tail_outlier"]
    assert got["snapshots"][0][1]["bucket"] == "b8xn4"
    assert got["records"][-1]["waiting"] == 0  # the probe raised
    assert got["records"][-1]["host_gap_s"] == 0.004
    NULL_FLIGHT_RECORDER.record_step("decode", "b8", 1e9)
    assert NULL_FLIGHT_RECORDER.records() == []
    assert NULL_FLIGHT_RECORDER.stats()["capacity"] == 0


def test_persisted_snapshots_come_back_after_a_restart(tmp_path):
    cfg = EngineConfig(device="cpu", flight_snapshot_dir=str(tmp_path),
                       max_prefill_tokens=64, **TINY)
    engine = AsyncLLMEngine(cfg)
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    try:
        status, _, _ = _call(port, "POST", "/v1/completions", {
            "prompt": "hello world", "max_tokens": 6, "temperature": 0.0})
        assert status == 200
        engine.engine.flight.snapshot("sigterm")
        status, flight, _ = _call(port, "GET", "/debug/flight?n=2")
        assert status == 200 and len(flight["records"]) == 2
        assert flight["total_steps"] > 2
        assert [s["reason"] for s in flight["snapshot_log"]] == ["sigterm"]
        metrics = _call(port, "GET", "/metrics")[1].decode()
        assert "pst_engine_flight_snapshots_persisted_total 1.0" in metrics
        status, _, _ = _call(port, "GET", "/debug/flight?n=x")
        assert status == 400
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    # The JAX reader reads the port's files.
    [snap] = jax_load(str(tmp_path))
    assert snap["reason"] == "sigterm" and snap["persisted_as"].startswith(
        "flight_")
    engine = AsyncLLMEngine(cfg)
    server, thread = serve_in_thread(engine)
    try:
        _, flight, _ = _call(server.server_address[1], "GET",
                             "/debug/flight?snapshots=1")
        assert flight["total_steps"] == 0
        assert flight["snapshot_dir"] == str(tmp_path)
        assert [s["reason"] for s in flight["restored_snapshots"]] == [
            "sigterm"]
        _, plain, _ = _call(server.server_address[1], "GET", "/debug/flight")
        assert "restored_snapshots" not in plain
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)


def _drive_mixed(eng, tag, sp_cls=SamplingParams) -> dict:
    """The JAX test's mixed two-tenant workload: {rid: (tenant, cost)}."""
    tenants = {}
    for i in range(4):
        rid = f"{tag}-a{i}"
        eng.add_request(rid, prompt=f"question {i}",
                        sampling=sp_cls(max_tokens=4, temperature=0.0),
                        tenant="acme", tenant_class="interactive")
        tenants[rid] = "acme"
    for i in range(3):
        rid = f"{tag}-b{i}"
        eng.add_request(rid, prompt=f"batch {i} " * (2 * i + 3),
                        sampling=sp_cls(max_tokens=14, temperature=0.0),
                        tenant="batchcorp", tenant_class="batch")
        tenants[rid] = "batchcorp"
    costs = {}
    while eng.has_work():
        for out in eng.step():
            if out.finished and out.cost is not None:
                costs[out.request_id] = (tenants[out.request_id], out.cost)
    return costs


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["unpipelined", "overlap"])
def test_cost_sums_to_device_busy(overlap):
    """Request device seconds sum to the device-busy wall within 10% in
    both pipeline modes: a pipelined burst's shares neither drop a wall
    segment nor charge one twice."""
    eng = LLMEngine(EngineConfig(
        device="cpu", overlap_decode=overlap,
        num_decode_steps=4 if overlap else 1, adaptive_decode_quiet_s=0.0,
        **TINY))
    _drive_mixed(eng, "warm")
    busy0 = eng.telemetry.device_busy()
    bursts0 = eng.pipelined_bursts_total
    costs = _drive_mixed(eng, "run")
    busy = eng.telemetry.device_busy() - busy0
    assert len(costs) == 7 and busy > 0
    assert (eng.pipelined_bursts_total > bursts0) == overlap
    frac = sum(c["device_s"] for _, c in costs.values()) / busy
    assert 0.9 <= frac <= 1.1, frac
    for _, c in costs.values():
        assert set(c) == COST_FIELDS
        assert c["device_s"] == pytest.approx(
            c["prefill_device_s"] + c["decode_device_s"], abs=2e-6)
        assert c["kv_page_s"] >= 0 and c["prefill_device_s"] > 0
    # Each finished request observed its phases once.
    hist = eng.telemetry.request_device_seconds
    n = {ph: sum(hist.labels(phase=ph).counts) for ph in ("prefill",
                                                          "decode")}
    assert n == {"prefill": 14, "decode": 14}


def _tenant_meter(eng, tenant: str) -> float:
    return eng.telemetry.tenant_device_seconds.labels(tenant=tenant).value


def test_tenants_aborts_and_the_switch_bill_as_jax():
    # The defaults are the JAX engine's, in the config and the flags.
    names = ("flight_buffer", "flight_snapshot_dir", "cost_attribution")
    args, jargs = parse_engine_args([]), jax_parse_engine_args([])
    flags = engine_config_from_args(args)
    for name in names:
        want = getattr(JaxEngineConfig(), name)
        assert getattr(EngineConfig(), name) == getattr(flags, name) == want
    options = app_options_from_args(args)
    for key in ("tracing", "debug_requests_buffer", "profiling"):
        assert options[key] == getattr(jargs, key), key
    assert options["tracing"] and not options["profiling"]
    assert args.log_format == jargs.log_format == "text"

    # The flood: a batch tenant with 4x the tokens pays more than the
    # interactive victim, and the meter moves by the per-request sums.
    eng = LLMEngine(EngineConfig(device="cpu", **TINY))
    tenants = {}
    for i in range(8):
        eng.add_request(f"fl-{i}", prompt=f"flood job {i} " * 4,
                        sampling=SamplingParams(max_tokens=16,
                                                temperature=0.0),
                        tenant="flooder", tenant_class="batch")
        tenants[f"fl-{i}"] = "flooder"
    for i in range(4):
        eng.add_request(f"vi-{i}", prompt=f"victim {i}",
                        sampling=SamplingParams(max_tokens=4,
                                                temperature=0.0),
                        tenant="victim", tenant_class="interactive")
        tenants[f"vi-{i}"] = "victim"
    sums = {"victim": 0.0, "flooder": 0.0}
    while eng.has_work():
        for out in eng.step():
            if out.finished:
                sums[tenants[out.request_id]] += out.cost["device_s"]
    assert sums["flooder"] > sums["victim"] > 0
    for t, total in sums.items():
        assert _tenant_meter(eng, t) == pytest.approx(total, abs=1e-4)

    # An abort bills what the request took, once.
    eng.add_request("ab-1", prompt="work then abort",
                    sampling=SamplingParams(max_tokens=64, temperature=0.0),
                    tenant="aborter")
    for _ in range(3):
        eng.step()
    seq = eng._seqs["ab-1"]
    eng.abort_request("ab-1")
    billed = _tenant_meter(eng, "aborter")
    assert billed > 0 and seq.cost_final["device_s"] == pytest.approx(
        billed, abs=2e-6)

    # Off: no account, no header, no usage extension, no meter.
    off = AsyncLLMEngine(EngineConfig(device="cpu", cost_attribution=False,
                                      **TINY))
    server, thread = serve_in_thread(off)
    try:
        status, body, headers = _call(
            server.server_address[1], "POST", "/v1/completions",
            {"prompt": "hello", "max_tokens": 4, "temperature": 0.0})
        assert status == 200 and "x-pst-cost" not in headers
        assert "pst_cost" not in body["usage"]
        assert off.engine.telemetry.tenant_device_seconds._children == {}
    finally:
        server.shutdown()
        server.server_close()
        off.shutdown()
        thread.join(timeout=10)


def _held_decode_buckets(rows):
    """The JAX engine's flight rows with each decode row's bucket as the
    port's runner holds it: the bucket of a decode batch's first step,
    kept while its rows only finish (``ModelRunner._decode_rows``,
    ROADMAP fault 3.9)."""
    out, held, running = [], None, 0
    for r in rows:
        if r["kind"] != "decode":
            held = None
        else:
            if held is None or r["running"] > running:
                held = r["bucket"]
            running = r["running"]
            r = dict(r, bucket=held)
        out.append(r)
    return out


def test_flight_rows_and_cost_surface_equal_the_jax_engines():
    """The flight rows of the same greedy requests through the JAX tiny
    engine and the port's, pipelining off (step walls, host gaps and
    compile flags aside; a decode row's bucket held while rows finish);
    then the cost on a served answer: the header, the usage extension and
    a stream's last usage chunk."""
    cfg = dict(TINY, overlap_decode=False, max_prefill_tokens=16)
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather", **cfg))
    port = LLMEngine(EngineConfig(device="cpu", **cfg), params=params_from_jax(
        jax.tree.map(np.asarray, jeng.runner.params)))
    rows = {}
    for eng, sp in ((jeng, JaxSamplingParams), (port, SamplingParams)):
        for i, (n, mt) in enumerate(((40, 6), (9, 12), (23, 3))):
            eng.add_request(f"f{i}", prompt_token_ids=list(range(1, n + 1)),
                            sampling=sp(max_tokens=mt, temperature=0.0,
                                        ignore_eos=True),
                            tenant_class="batch" if i == 1 else None)
        while eng.has_work():
            eng.step()
        rows[eng is port] = [
            {k: v for k, v in r.items()
             if k not in ("ts", "device_s", "host_gap_s", "compiled")}
            for r in eng.flight.records()]
    assert rows[True] == _held_decode_buckets(rows[False])
    assert rows[True] != rows[False]  # rows finished: a bucket was held
    assert {r["kind"] for r in rows[True]} == {"prefill", "decode"}
    assert any(r["batch_tier_rows"] for r in rows[True])

    served = AsyncLLMEngine(EngineConfig(device="cpu", **TINY),
                            params=port.runner.params)
    server, thread = serve_in_thread(served)
    try:
        p = server.server_address[1]
        status, body, headers = _call(p, "POST", "/v1/completions", {
            "prompt": "hello world", "max_tokens": 6, "temperature": 0.0})
        cost = json.loads(headers["x-pst-cost"])
        assert status == 200 and cost == body["usage"]["pst_cost"]
        assert set(cost) == COST_FIELDS and cost["device_s"] > 0
        status, raw, _ = _call(p, "POST", "/v1/completions", {
            "prompt": "stream me", "max_tokens": 4, "temperature": 0.0,
            "stream": True, "stream_options": {"include_usage": True}})
        frames = [json.loads(ln[6:]) for ln in raw.split(b"\n")
                  if ln.startswith(b"data: {")]
        usage = [f["usage"] for f in frames if f.get("usage")]
        assert status == 200 and len(usage) == 1
        assert usage[0]["pst_cost"]["device_s"] > 0
        assert math.isfinite(usage[0]["pst_cost"]["kv_page_s"])
        _, state, _ = _call(p, "GET", "/debug/state")
        assert state["flight"]["total_steps"] == served.engine.flight.stats()[
            "total_steps"] > 0
    finally:
        server.shutdown()
        server.server_close()
        served.shutdown()
        thread.join(timeout=10)
