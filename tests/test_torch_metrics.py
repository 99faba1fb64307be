"""The PyTorch engine's ``/metrics`` text against the JAX server's.

The port renders Prometheus text with its own code
(``production_stack_tpu_torch/obs``), since the card's machine has no
``prometheus_client``. The same ``stats()`` dicts and the same request
observations go into the JAX server's ``EngineMetrics`` (rendered by
``prometheus_client``) and into the port's; both texts, parsed by
``prometheus_client``'s parser, must give the same families, types, help,
label sets and values (``_created`` timestamps aside, which the port does
not emit). The port's ``pst_engine_*`` families carry the JAX telemetry's
names, help, labels and buckets, and the router's own scraper reads the
port's text.
"""

import ast
import math
import pathlib
import types

from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine.server import EngineMetrics as JaxMetrics
from production_stack_tpu.obs import engine_telemetry as jax_tel
from production_stack_tpu.obs import metrics as jax_metrics
from production_stack_tpu.router.stats.engine_stats import (
    _METRIC_FIELDS,
    EngineStats,
)
from production_stack_tpu_torch.engine.server import (
    EngineMetrics,
    KVTierMetrics,
)
from production_stack_tpu_torch.obs.engine_telemetry import EngineTelemetry
from production_stack_tpu_torch.obs.prometheus_text import Registry

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _stats(**over):
    base = {
        "num_requests_running": 3.0, "num_requests_waiting": 1.0,
        "num_preemptions_total": 2.0, "prompt_tokens_total": 40.0,
        "generation_tokens_total": 12.0, "kv_cache_usage_perc": 0.25,
        "prefix_cache_hit_rate": 0.5, "prefix_cache_hits_total": 16.0,
        "prefix_cache_queries_total": 32.0,
        "device_busy_seconds_total": 0.125, "graphs_captured": 4.0,
    }
    base.update(over)
    return base


def _families(text: str) -> dict:
    """{family: (type, help, sorted (sample, labels, value))}, the
    ``_created`` samples left out (``prometheus_client`` writes them as
    families of their own)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):
            continue
        samples = sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value)
            for s in fam.samples if not s.name.endswith("_created"))
        out[fam.name] = (fam.type, fam.documentation, samples)
    return out


def test_vllm_families_parse_as_the_jax_servers():
    jax, port = JaxMetrics("tiny-llama-debug"), EngineMetrics(
        "tiny-llama-debug")
    # Totals grow, then the preemption total falls (an in-process reset):
    # both re-baseline the same way.
    for stats in (_stats(), _stats(num_preemptions_total=5.0,
                                   prefix_cache_hits_total=24.0),
                  _stats(num_preemptions_total=1.0)):
        jax.refresh(stats)
        port.refresh(stats)
    for m in (jax, port):  # what the handlers record
        for ttft in (0.004, 0.03, 0.3, 9.0):
            m.ttft.observe(ttft)
        m.e2e.observe(1.5)
        m.success.inc()
        m.prompt_tokens.inc(27)
        m.generation_tokens.inc(16)
    want = _families(generate_latest(jax.registry).decode())
    got = _families(port.registry.render())
    assert got == want
    assert want["vllm:num_preemptions"][2] == [
        ("vllm:num_preemptions_total", (("model_name", "tiny-llama-debug"),),
         6.0)]


def _jax_collectors():
    reg = jax_tel.ENGINE_TELEMETRY_REGISTRY
    out = {c._name: c for c in reg._collector_to_names}
    # The JAX package keeps this one engine family in its shared registry.
    persisted = jax_metrics.flight_snapshots_persisted
    out[persisted._name] = persisted
    return out


def test_engine_telemetry_families_are_the_jax_ones():
    """Name, type, help, label names and buckets of every ``pst_engine_*``
    family, the compile cache's hits and misses included: the port has
    every JAX family."""
    jax = _jax_collectors()
    port = {f.name: f for f in EngineTelemetry().registry._families}
    assert set(port) == set(jax)
    for name, fam in port.items():
        ref = jax[name]
        assert fam.kind == ref._type, name
        assert fam.doc == ref._documentation, name
        assert fam.labelnames == tuple(ref._labelnames), name
        if fam.kind == "histogram":
            assert fam.bounds == tuple(ref._upper_bounds), name


def _port_text(stats, telemetry):
    metrics = EngineMetrics("tiny-llama-debug")
    metrics.refresh(stats)
    telemetry.refresh_from_stats(stats)
    return metrics.registry.render() + telemetry.render()


def test_router_scraper_reads_the_port_text():
    tel = EngineTelemetry()
    for label in ("b1", "b1xt8"):  # two captures
        tel.record_dispatch("decode", label, 0.2, first_use=True)
    tel.record_dispatch("decode", "b4xn4", 0.01, first_use=False, tokens=16,
                        fill_ratio=1.0)
    for gap in (0.0007, 0.0007, 0.0007, 0.02):
        tel.record_host_gap("b4xn4", gap)
    text = _port_text(_stats(kv_cache_usage_perc=0.375), tel)
    stats = EngineStats.from_scrape(text)
    assert stats.num_running_requests == 3
    assert stats.num_queuing_requests == 1
    assert stats.gpu_cache_usage_perc == 0.375
    assert stats.engine_kv_page_occupancy == 0.375
    assert stats.engine_kv_page_high_watermark == 0.375
    assert stats.gpu_prefix_cache_queries_total == 32
    assert stats.engine_host_gap_p50 == 0.001  # the bucket of 3 of 4 gaps
    assert stats.engine_compiles_total == 2
    assert stats.engine_mfu == 0.0  # no peak for a CPU


def test_counter_totals_rebaseline_as_jax():
    """``to_total`` follows a cumulative total as the JAX server's
    ``_counter_to`` does, a fall included."""
    jax = JaxMetrics("m")
    counter = Registry().counter("c", "doc")
    for total in (5.0, 7.0, 7.0, 3.0, 0.0, 4.0, 9.0):
        jax._counter_to(jax.spec_draft, "draft", total)
        counter.to_total(total)
        assert counter.labels().value == jax.spec_draft._value.get(), total
    assert counter.labels().value == 5 + 2 + 3 + 4 + 5


def test_router_names_are_exported():
    """Every name the router's scraper reads but one, which belongs to the
    remote KV tier, is in the port's text; ``chip_smoke.py`` checks the
    same list on the card. With a remote tier the server adds that one
    (``KVTierMetrics``, the JAX shared registry's families). Labels and
    help escape."""
    tel = EngineTelemetry()
    tel.record_dispatch("prefill", "b1xt8", 0.1, first_use=True)
    tel.record_host_gap("b1", 0.001)
    tel.startup_seconds.labels(phase='pre"comp\\ile\n').set(math.pi)
    text = _port_text(_stats(), tel)
    names = {s.name for fam in text_string_to_metric_families(text)
             for s in fam.samples}
    want = set(_METRIC_FIELDS) - {"pst_kv_integrity_failures_total"}
    assert want <= names
    assert "pst_engine_host_gap_seconds_bucket" in names
    smoke = ast.parse((ROOT / "chip_smoke.py").read_text())
    listed = next(ast.literal_eval(node.value) for node in smoke.body
                  if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", "") == "ROUTER_METRICS")
    assert set(listed) == want
    phases = [s for fam in text_string_to_metric_families(text)
              for s in fam.samples if s.name == "pst_engine_startup_seconds"]
    assert [(s.labels, s.value) for s in phases] == [
        ({"phase": 'pre"comp\\ile\n'}, math.pi)]
    kv = KVTierMetrics()
    kv.refresh(types.SimpleNamespace(
        integrity_by_source={"prefetch": 2, "restore": 1},
        counters={"read_repairs": 3}))
    tiered = text + kv.registry.render()
    assert set(_METRIC_FIELDS) <= {
        s.name for fam in text_string_to_metric_families(tiered)
        for s in fam.samples}
    assert EngineStats.from_scrape(tiered).kv_integrity_failures_total == 3
    fams = {f.name: f for f in text_string_to_metric_families(tiered)}
    for ref in (jax_metrics.kv_integrity_failures, jax_metrics.kv_read_repairs):
        assert (fams[ref._name].type, fams[ref._name].documentation) == (
            ref._type, ref._documentation)
    assert {s.labels["source"]: s.value for s in fams[
        "pst_kv_integrity_failures"].samples} == {
        "prefetch": 2.0, "match_prefix": 0.0, "restore": 1.0}
