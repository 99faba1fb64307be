"""OpenAI-compatible HTTP server for the PyTorch engine (standard library).

The JAX package's engine server, route for route where the port has the
module behind it, with its status codes, response keys and headers:

- ``POST /v1/completions`` and ``POST /v1/chat/completions``, streamed
  as server-sent events or not, ``logprobs`` included, every sampling
  field mapped as the JAX ``build_sampling`` maps it. A completion's
  prompt takes the four OpenAI forms (a string, a list of token ids, a
  list of either: one choice a prompt); ``n`` and ``best_of`` sample
  candidates seeded ``seed + i`` (ranked by mean token logprob when
  ``best_of > n``), ``echo`` prepends the prompt, ``suffix`` is accepted
  and ignored.
- ``POST /tokenize`` (a ``prompt`` or chat ``messages``) and
  ``POST /detokenize``.
- ``POST /v1/embeddings`` (a string, a list of strings, a token-id list
  or a list of them: one L2-normalized mean-pooled vector a prompt,
  ``ModelRunner.encode`` on the step thread; a prompt past
  ``max_model_len`` answers 400), ``POST /rerank`` (also ``/v1/rerank``,
  ``/v2/rerank``: the documents by score, descending, ``top_n`` of them)
  and ``POST /score`` (also ``/v1/score``; a single ``text_1`` is paired
  with every ``text_2``). With ``--scoring-model`` a pair is scored by
  the cross-encoder (``scoring_method: "cross_encoder"``), else as the
  dot product of its two embeddings (``"embedding_cosine_similarity"``).
  They keep the generation routes' drain, warming and deadline gates.
- ``GET /metrics``: the ``vllm:`` families the router's scraper reads
  and the engine's ``pst_engine_*`` telemetry, as Prometheus text.
- ``GET /health``, ``GET /ready``, ``GET /v1/models``, ``GET /version``,
  ``GET /debug/state``.
- ``POST /sleep?level=``, ``POST /wake_up``, ``GET /is_sleeping``;
  ``POST /drain?wait=&timeout=``, ``POST /undrain``, ``GET /is_draining``.
- Diagnostics, on by default as in the JAX server: ``GET /debug/requests``
  (``limit``, ``request_id``: the ring of request timelines),
  ``GET /debug/flight`` (``n``, ``window_s``, ``snapshots=1``: the flight
  recorder), ``POST /debug/profile`` (``duration_ms``, ``dir``; with
  ``--profiling``: a ``torch.profiler`` trace of the CPU and the card,
  written as Chrome/Perfetto JSON).

Tracing (``--tracing``): a completion or chat request gets a root span
``engine_request`` that joins the caller's ``traceparent``, and the
spans ``engine_admission``, ``engine_queue``, ``prefill`` and
``decode``, with ``compile`` and ``deadline_shed`` events; every span
feeds ``pst_stage_duration_seconds``. ``X-Request-Id`` (the caller's, or
a fresh one) names the timeline and rides every error answer; the
handler thread binds it, with the trace id and tenant, to the JSON log
lines (``--log-format json``). With ``--cost-attribution`` a collected
answer carries the request's device seconds as ``X-PST-Cost`` and
``usage.pst_cost``, a stream's final usage chunk as ``usage.pst_cost``.

Bodies are plain JSON dicts. While the engine warms up, sleeps or drains
it answers a generation request with a 503 (``X-PST-Warming: 1``, or
``X-PST-Draining: 1``) that lets a router fail over.

KV tiers and the disaggregated handoff (``--cpu-offload-blocks``,
``--remote-kv-url``, ``--kv-role``): a request's ``kv_transfer_params``
(the router's ``{"request_id", "role", "pool"}`` stamp) names its
transfer; on a consumer the handler thread follows the producer's
manifest and stages the published pages in the host tier before
admission (a ``kv_prefetch`` trace event and stage; a timeout admits
anyway, the fused fallback). With ``--cache-controller-url`` a daemon
thread registers the engine's resident chunk hashes with the cache
controller every 10 s (``register_with_controller``). With a remote tier
``/metrics`` adds ``pst_kv_integrity_failures_total{source}`` and
``pst_kv_read_repairs_total``.

The deploy layer's argv: the chart's and the operator's engine flags
parse (``--served-model-name``, ``--gpu-memory-utilization``,
``--attn-impl``, ``--moe-impl``, ``--no-enable-prefix-caching``,
``--no-startup-phases``, ...). ``--tensor-parallel-size``,
``--pipeline-parallel-size`` and ``--data-parallel-size`` serve on
``dp x pp x tp`` ranks, one process each (``engine/multihost.py``):
``main`` starts them (under the chart's multi-host ``PST_*``
environment, each pod its own, and a pod other than the first mirrors
rank 0 and serves nothing), rank 0 serves HTTP, ``/debug/state`` lists
each rank's ``dp``/``pp``/``tp`` coordinates and device (``ranks``), and
a SIGTERM stops every local rank. ``--sequence-parallel-size`` and
``--expert-parallel-size`` take 1 only (refused at start above 1,
ROADMAP.md queue 1, items 15.iii and 15.iv). With
``--api-key`` every route but the probes and ``/metrics``
(``_OPEN_PATHS``) answers 401 ``invalid API key`` to a request without
``Authorization: Bearer <key>``; a traced path's 401 carries its
``X-Request-Id``. ``main`` starts the Sentry (``--sentry-dsn``) and
OpenTelemetry mirrors, no-ops without their SDKs.

LoRA (``--enable-lora``, ``--max-loras``, ``--max-lora-rank``,
``--lora-dir``): ``POST /v1/load_lora_adapter`` (``{"lora_name",
"lora_path"}``; the path defaults to ``<lora-dir>/<name>``) parses a PEFT
directory into a bank slot and answers ``{status, name, rank, slot}``, a
missing directory 404 ``not_found_error``, a bad adapter or a full bank
400; ``POST /v1/unload_lora_adapter`` answers ``{status, removed}``.
Both run on the engine's step thread and need the API key. ``/v1/models``
lists each loaded adapter with ``parent`` set to the served model, and a
completion or chat whose ``model`` names one is served under it.

The router's hop headers: ``X-PST-Deadline-Ms`` (a budget already spent
gets an instant 504 tagged ``X-PST-Deadline-Exceeded: 1``, as does a
request the scheduler sheds later; a streamed one ends with a frame whose
``finish_reason`` is ``"deadline"``), ``X-PST-Tenant`` and
``X-PST-Tenant-Class`` (the scheduler's admission order).

    python -m production_stack_tpu_torch.engine.server --model llama-3-8b --port 8011 \
        [--quantization int4] [--warmup lazy|full] [--no-overlap-decode] \
        [--speculative-ngram 4] [--enable-lora --lora-dir DIR] \
        [--no-kv-swap] [--no-deadline-shedding] [--no-tenant-fairness] \
        [--no-tracing] [--log-format json] [--profiling] \
        [--flight-buffer 0] [--no-cost-attribution] \
        [--cpu-offload-blocks N] [--remote-kv-url URL[,URL...]] \
        [--kv-role producer|consumer|both] [--cache-controller-url URL] \
        [--api-key KEY] [--served-model-name NAME] [--attn-impl gather] \
        [--scoring-model bge-reranker-base] [--compile-cache-dir DIR] \
        [--model mixtral-8x7b --quantization int4 --moe-impl auto|ragged|dense]

``--model`` takes a preset name or a local HF checkpoint directory (its
``config.json`` and safetensors; its tokenizer files unless
``--tokenizer`` names others).
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import os
import signal
import sys
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from .. import __version__
from ..logging_utils import init_logger
from ..obs.logging import (
    LOG_FORMATS,
    LOG_REGISTRY,
    bind_log_context,
    configure_logging,
    unbind_log_context,
)
from ..obs.prometheus_text import CONTENT_TYPE, Registry
from ..obs.tracing import (
    NOOP_TRACE,
    REQUEST_ID_HEADER,
    SpanRecorder,
    debug_requests_payload,
    error_headers,
)
from ..parallel.distributed import DistributedConfig
from ..resilience.deadline import DEADLINE_EXCEEDED_HEADER, parse_deadline
from ..utils_tracing import init_otel, init_sentry
from .async_engine import AsyncLLMEngine
from .cache_tiering import INTEGRITY_SOURCES
from .config import UNSERVED_AXES, EngineConfig
from .multihost import start_ranks
from .sequence import SamplingParams
from .tokenizer import ChatMessage

logger = init_logger(__name__)

# The JAX server's --<axis>-parallel-size flags.
PARALLEL_AXES = ("tensor", "pipeline", "data", "sequence", "expert")


def _parse_logit_bias(raw) -> tuple:
    """OpenAI logit_bias keys are stringified token ids; a non-numeric key
    must surface as a 400, not a 500 (callers catch ValueError). Values are
    validated to OpenAI's documented [-100, 100] range."""
    if not raw:
        return ()
    try:
        parsed = tuple((int(k), float(v)) for k, v in raw.items())
    except (AttributeError, TypeError, ValueError):
        raise ValueError("logit_bias keys must be integer token ids")
    for _, v in parsed:
        if not (-100.0 <= v <= 100.0):
            raise ValueError("logit_bias values must be in [-100, 100]")
    return parsed


def _parse_guided_choice(raw, tok) -> tuple:
    """Tokenize guided_choice strings (no special tokens: the choices are
    output continuations). Invalid shapes raise ValueError (a 400)."""
    if not raw:
        return ()
    if tok is None:
        raise ValueError("guided_choice is not supported on this endpoint")
    if not isinstance(raw, list) or not all(
        isinstance(c, str) and c for c in raw
    ):
        raise ValueError("guided_choice must be a list of non-empty strings")
    if len(raw) > 64:
        raise ValueError("guided_choice supports at most 64 choices")
    choices = []
    for c in raw:
        ids = tuple(tok.encode(c, add_special_tokens=False))
        if not ids or len(ids) > 256:
            raise ValueError(
                f"guided_choice entry tokenizes to {len(ids)} tokens "
                "(must be 1..256)"
            )
        choices.append(ids)
    return tuple(choices)


def _opt(req: dict, name: str, cast, default):
    value = req.get(name)
    return default if value is None else cast(value)


def build_sampling(req: dict, max_model_len: int, prompt_len: int,
                   tok=None) -> SamplingParams:
    """SamplingParams from a completion request body, field by field as
    the JAX server's ``build_sampling`` maps its ``CompletionRequest``
    (OpenAI defaults; ``max_completion_tokens`` before ``max_tokens``; an
    int ``logprobs``, or a bool with ``top_logprobs``). ``tok`` tokenizes
    ``guided_choice``."""
    limit = max(max_model_len - prompt_len - 1, 1)
    want = req.get("max_completion_tokens") or req.get("max_tokens")
    stop = req.get("stop")
    if stop is not None and not isinstance(stop, (str, list)):
        raise ValueError("stop must be a string or a list of strings")
    lp = req.get("logprobs")
    if isinstance(lp, bool):
        lp = _opt(req, "top_logprobs", int, 0) if lp else None
    gc = _parse_guided_choice(req.get("guided_choice"), tok)
    return SamplingParams(
        max_tokens=min(int(want), limit) if want else limit,
        temperature=_opt(req, "temperature", float, 1.0),
        top_p=_opt(req, "top_p", float, 1.0),
        top_k=_opt(req, "top_k", int, -1),
        min_p=_opt(req, "min_p", float, 0.0),
        stop=stop,
        stop_token_ids=tuple(int(t) for t in req.get("stop_token_ids") or ()),
        # Guided requests end by EOS at a completed choice: ignore_eos would
        # deadlock the mask.
        ignore_eos=bool(req.get("ignore_eos", False)) and not gc,
        seed=_opt(req, "seed", int, None),
        presence_penalty=_opt(req, "presence_penalty", float, 0.0),
        frequency_penalty=_opt(req, "frequency_penalty", float, 0.0),
        repetition_penalty=_opt(req, "repetition_penalty", float, 1.0),
        logprobs=int(lp) if lp is not None else None,
        logit_bias=_parse_logit_bias(req.get("logit_bias")),
        guided_choice=gc,
    )


def fmt_completion_logprobs(tok, entries, echo_ids=None,
                            base_offset: int = 0) -> dict:
    """The OpenAI completions ``logprobs`` object of the JAX server's
    ``_fmt_completion_logprobs``. Echoed prompt tokens (``echo_ids``)
    carry null logprobs (no prefill logits are kept). ``base_offset``
    anchors ``text_offset`` in the whole completion text for streamed
    chunks."""
    tokens, token_lps, top_lps, offsets = [], [], [], []
    off = base_offset
    for tid in echo_ids or []:
        s = tok.decode([tid])
        tokens.append(s)
        token_lps.append(None)
        top_lps.append(None)
        offsets.append(off)
        off += len(s)
    for e in entries:
        s = tok.decode([e["token_id"]])
        tokens.append(s)
        token_lps.append(e["logprob"])
        top_lps.append({tok.decode([t]): lp for t, lp in e["top"]})
        offsets.append(off)
        off += len(s)
    return {
        "tokens": tokens,
        "token_logprobs": token_lps,
        "top_logprobs": top_lps,
        "text_offset": offsets,
    }


def fmt_chat_logprobs(tok, entries) -> dict:
    """The OpenAI chat ``logprobs`` object (``content`` entries) of the
    JAX server's ``_fmt_chat_logprobs``."""
    def one(tid, lp):
        s = tok.decode([tid])
        return {"token": s, "logprob": lp, "bytes": list(s.encode())}

    return {"content": [
        dict(one(e["token_id"], e["logprob"]),
             top_logprobs=[one(t, lp) for t, lp in e["top"]])
        for e in entries
    ]}


def completion_prompts(prompt) -> list:
    """A completion's ``prompt`` in the four OpenAI forms — a string, a
    list of token ids, a list of strings, a list of token-id lists — as a
    list of prompts (each a string or a list of ids). Any other shape
    raises ValueError."""
    if isinstance(prompt, str):
        return [prompt]
    if not isinstance(prompt, list):
        raise ValueError("prompt must be a string, a list of token ids or "
                         "a list of either")
    if prompt and all(isinstance(x, int) for x in prompt):
        return [prompt]
    if all(isinstance(x, str) for x in prompt) or all(
            isinstance(x, list) and all(isinstance(t, int) for t in x)
            for x in prompt):
        return list(prompt)
    raise ValueError("prompt must be a string, a list of token ids or a "
                     "list of either")


def parse_messages(raw) -> List[ChatMessage]:
    """A chat request's ``messages``; raises ValueError on a bad shape."""
    if not isinstance(raw, list):
        raise ValueError("messages must be a list")
    return [ChatMessage.from_dict(m) for m in raw]


def _kv_transfer_params(req: dict) -> Optional[dict]:
    """The request's ``kv_transfer_params`` (the router's handoff stamp),
    as the JAX server reads it: a dict with a ``request_id``, else
    ignored (never a 400)."""
    raw = req.get("kv_transfer_params")
    if not isinstance(raw, dict) or not raw.get("request_id"):
        return None
    return {"request_id": str(raw["request_id"]),
            "role": str(raw["role"]) if raw.get("role") else None}


class KVTierMetrics:
    """The remote KV tier's audit families of the JAX package's shared
    registry (``obs/metrics.py``), with its names and help: digest
    failures by read path and read repairs, exported by an engine with a
    remote tier (each source's sample from 0)."""

    def __init__(self):
        self.registry = r = Registry()
        self.integrity = r.counter(
            "pst_kv_integrity_failures",
            "KV pages whose BLAKE2 digest failed verification on a read "
            "path, by source (prefetch = disagg consumer manifest-following,"
            " match_prefix = the remote leg of prefix matching, restore = "
            "single-page fault-up). Each count is a quarantined replica copy"
            " and a failover/recompute — a corrupt page is never decoded "
            "(docs/kvserver.md)", ["source"])
        self.read_repairs = r.counter(
            "pst_kv_read_repairs",
            "KV pages found on fewer than R ring owners during a read and "
            "re-pushed to the owners that missed (client-side read-repair, "
            "docs/kvserver.md)")

    def refresh(self, remote) -> None:
        """From the remote client's counters (their totals)."""
        for source in INTEGRITY_SOURCES:
            self.integrity.labels(source=source).to_total(
                remote.integrity_by_source.get(source, 0))
        self.read_repairs.labels().to_total(
            remote.counters.get("read_repairs", 0))


class EngineMetrics:
    """The ``vllm:`` families of the JAX server's ``EngineMetrics``, with
    its names, help strings, label and buckets. A family whose feature is
    off (speculation without ``--speculative-ngram``) is exported at 0,
    as a JAX engine with that feature off exports it."""

    def __init__(self, model: str):
        self.registry = r = Registry()
        label = {"model_name": model}

        def gauge(name, doc):
            return r.gauge(name, doc, ["model_name"]).labels(**label)

        def counter(name, doc):
            return r.counter(name, doc, ["model_name"]).labels(**label)

        def hist(name, doc, buckets):
            return r.histogram(name, doc, buckets,
                               ["model_name"]).labels(**label)

        self.running = gauge("vllm:num_requests_running", "running requests")
        self.waiting = gauge("vllm:num_requests_waiting", "waiting requests")
        self.swapped = gauge("vllm:num_requests_swapped",
                             "sequences with KV parked host-side")
        self.preemptions = counter("vllm:num_preemptions",
                                   "recompute preemptions")
        self.cache_usage = gauge("vllm:gpu_cache_usage_perc",
                                 "KV page usage (HBM)")
        self.hit_rate = gauge("vllm:gpu_prefix_cache_hit_rate",
                              "prefix cache hit rate")
        self.hits = gauge("vllm:gpu_prefix_cache_hits_total",
                          "prefix cache hit tokens")
        self.queries = gauge("vllm:gpu_prefix_cache_queries_total",
                             "prefix cache query tokens")
        self.prompt_tokens = counter("vllm:prompt_tokens_total",
                                     "prompt tokens processed")
        self.generation_tokens = counter("vllm:generation_tokens_total",
                                         "tokens generated")
        self.ttft = hist("vllm:time_to_first_token_seconds", "TTFT",
                         (0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2,
                          6.4))
        self.e2e = hist("vllm:e2e_request_latency_seconds", "request latency",
                        (0.1, 0.25, 0.5, 1, 2, 4, 8, 16, 32, 64))
        self.success = counter("vllm:request_success_total",
                               "finished requests")
        self.spec_draft = counter("vllm:spec_decode_num_draft_tokens",
                                  "speculative draft tokens proposed")
        self.spec_accepted = counter("vllm:spec_decode_num_accepted_tokens",
                                     "speculative draft tokens accepted")
        self.adaptive_deep = counter(
            "pst:adaptive_deep_bursts",
            "decode bursts executed at the adaptive deep depth")
        self.pipelined_bursts = counter(
            "pst:pipelined_bursts",
            "decode bursts dispatched as part of an overlapped pipeline "
            "(one burst in flight, host bookkeeping off the critical path)")
        self.deadline_shed_admission = counter(
            "pst:deadline_shed_admission",
            "requests shed at HTTP admission (budget already expired)")
        self.deadline_shed_queued = counter(
            "pst:deadline_shed_queued",
            "queued sequences shed before consuming a prefill step")
        self.deadline_shed_running = counter(
            "pst:deadline_shed_running",
            "running sequences shed between decode steps")
        self.swap_out = counter("pst:kv_swap_out",
                                "sequences swapped out (KV parked)")
        self.swap_in = counter("pst:kv_swap_in",
                               "sequences swapped back in (KV resumed)")
        self.swap_tail_pages = counter(
            "pst:kv_swap_tail_pages",
            "uncommitted tail pages physically moved by swap")
        self.swap_fallback = counter(
            "pst:kv_swap_fallback_recompute",
            "swap-ins that degraded to recompute (committed pages lost)")
        self.swap_stash = gauge("pst:kv_swap_stash_blocks",
                                "host-DRAM stash occupancy (pages)")
        self.kv_published_blocks = counter(
            "pst:kv_published_blocks",
            "KV pages published to the remote store by the streamed "
            "disagg handoff (per prefill chunk, batched)")
        self.kv_prefetched_blocks = counter(
            "pst:kv_prefetched_blocks",
            "KV pages prefetched from a disagg prefill's manifest while "
            "the prefill was still running")
        self.kv_transfer_fallbacks = counter(
            "pst:kv_transfer_fallbacks",
            "disagg transfers that degraded to the fused path "
            "(manifest timeout or kvserver failure)")
        self.kv_remote_retries = counter(
            "pst:kv_remote_retries",
            "remote-KV GET attempts retried after a transient shard "
            "error (bounded, jittered — docs/kvserver.md)")
        self.tenant_queue_age_interactive = gauge(
            "pst:tenant_queue_age_interactive_seconds",
            "oldest interactive-tier queued sequence's wait (seconds)")
        self.tenant_queue_age_batch = gauge(
            "pst:tenant_queue_age_batch_seconds",
            "oldest batch-tier queued sequence's wait (seconds)")
        self.tenant_batch_preemptions = counter(
            "pst:tenant_batch_preemptions",
            "batch-tier sequences preempted (swap/shed) so a waiting "
            "interactive sequence could admit")

    def refresh(self, stats: dict) -> None:
        """The JAX server's mapping from ``stats()``, key for key (the
        totals the engine does not keep read 0)."""
        self.running.set(stats["num_requests_running"])
        self.waiting.set(stats["num_requests_waiting"])
        self.swapped.set(
            stats.get("num_requests_swapped", stats["num_preemptions_total"]))
        self.preemptions.to_total(stats["num_preemptions_total"])
        self.swap_out.to_total(stats.get("kv_swap_out_total", 0))
        self.swap_in.to_total(stats.get("kv_swap_in_total", 0))
        self.swap_tail_pages.to_total(stats.get("kv_swap_tail_pages_total", 0))
        self.swap_fallback.to_total(
            stats.get("kv_swap_fallback_recompute_total", 0))
        self.swap_stash.set(stats.get("kv_swap_stash_blocks", 0))
        self.cache_usage.set(stats["kv_cache_usage_perc"])
        self.hit_rate.set(stats["prefix_cache_hit_rate"])
        self.hits.set(stats["prefix_cache_hits_total"])
        self.queries.set(stats["prefix_cache_queries_total"])
        self.spec_draft.to_total(
            stats.get("spec_decode_num_draft_tokens_total", 0))
        self.spec_accepted.to_total(
            stats.get("spec_decode_num_accepted_tokens_total", 0))
        self.adaptive_deep.to_total(stats.get("adaptive_deep_bursts_total", 0))
        self.pipelined_bursts.to_total(stats.get("pipelined_bursts_total", 0))
        self.deadline_shed_queued.to_total(
            stats.get("deadline_sheds_queued_total", 0))
        self.deadline_shed_running.to_total(
            stats.get("deadline_sheds_running_total", 0))
        self.kv_published_blocks.to_total(
            stats.get("kv_published_blocks_total", 0))
        self.kv_prefetched_blocks.to_total(
            stats.get("kv_prefetched_blocks_total", 0))
        self.kv_transfer_fallbacks.to_total(
            stats.get("kv_transfer_fallbacks_total", 0))
        self.kv_remote_retries.to_total(
            stats.get("kv_remote_retries_total", 0))
        self.tenant_queue_age_interactive.set(
            stats.get("tenant_queue_age_interactive", 0.0))
        self.tenant_queue_age_batch.set(
            stats.get("tenant_queue_age_batch", 0.0))
        self.tenant_batch_preemptions.to_total(
            stats.get("tenant_batch_preemptions_total", 0))


# The paths that get a root span and a timeline: the work a router
# proxies (probes and admin routes are not traced).
_TRACED_PATHS = frozenset({"/v1/completions", "/v1/chat/completions"})
# The probe and scrape paths that stay open under --api-key; every other
# path (/sleep, /drain and /debug/* included) needs the bearer key.
_OPEN_PATHS = frozenset({"/health", "/ready", "/metrics", "/version",
                         "/is_sleeping", "/is_draining"})

DEFAULT_PROFILE_DIR = os.path.join(tempfile.gettempdir(), "pst_profiles")


def embedding_inputs(raw) -> list:
    """The prompts of an embeddings request's ``input``: a string, a list
    of strings, a list of token ids (one prompt) or a list of token-id
    lists, as the JAX ``EmbeddingRequest`` takes it; anything else raises
    ``ValueError``."""
    if isinstance(raw, str):
        return [raw]
    if not isinstance(raw, list):
        raise ValueError("input must be a string, a list of strings or "
                         "token ids, or a list of token-id lists")
    if all(isinstance(x, int) and not isinstance(x, bool) for x in raw):
        return [raw] if raw else []
    if all(isinstance(x, str) for x in raw):
        return raw
    if all(isinstance(x, list) and all(isinstance(t, int) for t in x)
           for x in raw):
        return raw
    raise ValueError("input must be a string, a list of strings or token "
                     "ids, or a list of token-id lists")


def _texts(raw, name: str) -> List[str]:
    """A text field of a rerank or score body, as a list of strings."""
    items = raw if isinstance(raw, list) else [raw]
    if not all(isinstance(x, str) for x in items):
        raise ValueError(f"{name} must be a string or a list of strings")
    return items


def create_engine_app(
    engine: AsyncLLMEngine, host: str = "127.0.0.1", port: int = 0, *,
    tracing: bool = True, debug_requests_buffer: int = 256,
    profiling: bool = False, profile_dir: str = DEFAULT_PROFILE_DIR,
    api_key: Optional[str] = None, cross_encoder=None,
) -> ThreadingHTTPServer:
    """An HTTP server bound to ``(host, port)`` (port 0: any free port)
    serving ``engine``; call ``serve_forever()`` on it. ``tracing`` and
    ``debug_requests_buffer`` size the request tracing (the JAX server's
    ``--tracing`` and ``--debug-requests-buffer``); ``profiling`` opens
    ``POST /debug/profile``, which writes under ``profile_dir`` unless the
    request names a ``dir``. With ``api_key`` every route outside
    ``_OPEN_PATHS`` needs ``Authorization: Bearer <api_key>``.
    ``cross_encoder`` (``engine/cross_encoder.py``, the ``--scoring-model``)
    scores ``/rerank`` and ``/score`` pairs; without one a pair scores the
    dot product of its two texts' embeddings."""
    model_name = engine.engine.model_name
    # Surfaced in rerank and score answers, so a client can tell the
    # embedding approximation from a real reranker.
    scoring_method = ("cross_encoder" if cross_encoder is not None
                      else "embedding_cosine_similarity")

    def _pair_scores(texts_a: List[str], texts_b: List[str]) -> List[float]:
        if cross_encoder is not None:
            return cross_encoder.score_pairs(list(zip(texts_a, texts_b)))
        tok = engine.engine.tokenizer
        return [float(np.dot(engine.encode(tok.encode(a)),
                             engine.encode(tok.encode(b))))
                for a, b in zip(texts_a, texts_b)]
    metrics = EngineMetrics(model_name)
    recorder = SpanRecorder("engine", buffer=debug_requests_buffer,
                            enabled=tracing)
    # The tiers' fetch stages land in this app's stage histogram.
    engine.engine.observe_stage = recorder.observe_stage
    kv_metrics = KVTierMetrics() if engine.engine.remote is not None else None
    # One capture at a time: a second one while it runs answers 409.
    profile_lock = threading.Lock()
    if profiling and engine.engine.runner.device.type == "cuda":
        _prime_profiler()  # before main() or serve_in_thread starts steps

    def _lora_names() -> List[str]:
        mgr = engine.engine.lora_manager
        return [a.name for a in mgr.list_adapters()] if mgr else []

    def _resolve_lora(requested_model) -> Optional[str]:
        """A request whose ``model`` is a loaded adapter's name is served
        under that adapter."""
        mgr = engine.engine.lora_manager
        if (mgr is not None and isinstance(requested_model, str)
                and requested_model != model_name
                and mgr.get(requested_model) is not None):
            return requested_model
        return None

    class Handler(BaseHTTPRequestHandler):
        # The traced request's trace and id (do_POST sets them).
        trace = NOOP_TRACE
        request_id: Optional[str] = None
        status: Optional[int] = None

        def log_message(self, fmt, *args):  # route access logs to our logger
            logger.debug("%s %s", self.address_string(), fmt % args)

        def send_response(self, code, message=None) -> None:
            self.status = code
            super().send_response(code, message)

        # -- plumbing ----------------------------------------------------

        def _send(self, status: int, body: bytes, content_type: str,
                  headers: Optional[dict] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, payload: dict,
                  headers: Optional[dict] = None) -> None:
            self._send(status, json.dumps(payload).encode(),
                       "application/json", headers)

        def _error(self, message: str, status: int = 400,
                   etype: str = "invalid_request_error",
                   headers: Optional[dict] = None) -> None:
            # A traced request's id rides every error answer: 503 drain
            # and 504 deadline sheds included.
            self._json(status, {"error": {"message": message, "type": etype,
                                          "code": status}},
                       error_headers(self.request_id, headers))

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            return req

        def _route(self, routes: dict) -> None:
            url = urlsplit(self.path)
            self.query = {k: v[-1] for k, v in parse_qs(url.query).items()}
            # The one place the key is checked, before any handler (an
            # unknown path too, as the JAX middleware does). On a traced
            # path the 401 is answered inside the root span and carries
            # its X-Request-Id.
            if (api_key is not None and url.path not in _OPEN_PATHS
                    and self.headers.get("Authorization", "")
                    != f"Bearer {api_key}"):
                self._error("invalid API key", 401, "authentication_error")
                return
            handler = routes.get(url.path)
            if handler is None:
                self._error(f"no route {url.path}", 404)
                return
            handler(self)

        def do_GET(self) -> None:
            self._route(GET_ROUTES)

        def do_POST(self) -> None:
            path = urlsplit(self.path).path
            self.trace, self.request_id = NOOP_TRACE, None
            if not (recorder.enabled and path in _TRACED_PATHS):
                self._route(POST_ROUTES)
                return
            # The JAX middleware's work: a root span joining the caller's
            # traceparent, the request id, and the log context of this
            # handler thread for as long as it serves the request.
            self.request_id = (self.headers.get(REQUEST_ID_HEADER)
                               or f"req-{uuid.uuid4().hex}")
            self.trace = recorder.trace(
                self.request_id, headers=self.headers, name="engine_request",
                attributes={"http.target": path})
            token = bind_log_context(
                request_id=self.request_id, trace_id=self.trace.trace_id,
                tenant=self.headers.get("X-PST-Tenant"))
            self.status = None
            try:
                self._route(POST_ROUTES)
            finally:
                unbind_log_context(token)
                self.trace.finish(status=self.status)

        # -- probes and introspection ------------------------------------

        def health(self) -> None:
            if engine.is_healthy():
                # Draining and warming are alive (liveness): the status
                # string tells them apart from a routable engine.
                self._json(200, {"status": "draining" if engine.draining
                                 else "warming" if engine.warming else "ok"})
            else:
                self._json(503, {"status": "unhealthy",
                                 "error": engine.step_error})

        def ready(self) -> None:
            # Readiness: 200 only once warmup has finished and the engine
            # takes work (liveness is /health).
            warmup = dict(engine.engine.warmup_summary or {})
            warmup["mode"] = engine.engine.cfg.warmup
            if engine.warmup_error:
                warmup["error"] = engine.warmup_error
            if engine.ready:
                self._json(200, {"ready": True, "warmup": warmup})
                return
            reason = ("unhealthy" if not engine.is_healthy()
                      else "warming" if engine.warming
                      else "sleeping" if engine.sleeping
                      else "draining")
            self._json(503, {"ready": False, "reason": reason,
                             "warmup": warmup})

        def models(self) -> None:
            now = int(time.time())
            self._json(200, {"object": "list", "data": [
                {"id": name, "object": "model", "created": now,
                 "owned_by": "production-stack-tpu", "root": None,
                 "parent": parent}
                for name, parent in [(model_name, None)] + [
                    (a, model_name) for a in _lora_names()]
            ]})

        def metrics(self) -> None:
            stats = engine.engine.stats()
            metrics.refresh(stats)
            telemetry = engine.engine.telemetry
            telemetry.refresh_from_stats(stats)
            text = (metrics.registry.render() + telemetry.render()
                    + recorder.registry.render() + LOG_REGISTRY.render())
            remote = engine.engine.remote
            if kv_metrics is not None and remote is not None:
                kv_metrics.refresh(remote)  # stats() folded shard counters
                text += kv_metrics.registry.render()
            self._send(200, text.encode(), CONTENT_TYPE)

        def version(self) -> None:
            self._json(200, {"version": __version__})

        def debug_state(self) -> None:
            stats = engine.engine.stats()
            # Each rank's coordinates and device, where there are ranks
            # (at one rank the keys are the JAX server's).
            layout = engine.engine.rank_layout()
            self._json(200, {
                "model": model_name,
                "ready": engine.ready,
                "draining": engine.draining,
                "warming": engine.warming,
                "sleeping": engine.sleeping,
                "in_flight": engine.num_inflight(),
                # Captures stand in for compiles.
                "compiles_total": engine.engine.telemetry.compile_count(),
                "flight": engine.engine.flight.stats(),
                "stats": {k: v for k, v in stats.items()
                          if isinstance(v, (int, float, str, bool))},
                **({"ranks": layout} if layout else {}),
            })

        def debug_requests(self) -> None:
            """The ring of completed request timelines, most recent first
            (404 under ``--no-tracing`` or ``--debug-requests-buffer 0``)."""
            status, body = debug_requests_payload(recorder, self.query)
            self._json(status, body)

        def debug_flight(self) -> None:
            """The flight recorder: the last ``n`` step records or those of
            the last ``window_s`` seconds, the retained snapshots, and
            with ``snapshots=1`` those a previous process persisted."""
            try:
                n = int(self.query["n"]) if "n" in self.query else None
                window_s = (float(self.query["window_s"])
                            if "window_s" in self.query else None)
            except ValueError:
                self._error("n and window_s must be numbers")
                return
            self._json(200, engine.engine.flight.to_payload(
                n=n, window_s=window_s,
                include_restored=self.query.get("snapshots") in ("1",
                                                                 "true")))

        def debug_profile(self) -> None:
            """A ``torch.profiler`` capture of the CPU and the card for
            ``duration_ms`` (10 ms to 60 s), written as a Chrome/Perfetto
            trace into ``dir`` (default ``--profile-dir``). 403 without
            ``--profiling``; 409 while a capture runs; skipped on an
            engine whose device is the CPU. The capture starts and stops
            on the engine's step thread, between two steps (see
            ``_capture_profile``); the card's kernels are recorded
            process-wide in between."""
            if not profiling:
                self._error("profiling is disabled (start the engine with "
                            "--profiling)", 403, "permission_error")
                return
            try:
                body = self._body()
            except ValueError:  # an empty or garbled body: the defaults
                body = {}
            try:
                duration_ms = float(body.get("duration_ms")
                                    or self.query.get("duration_ms", 1000))
            except (TypeError, ValueError):
                self._error("duration_ms must be a number")
                return
            duration_ms = min(max(duration_ms, 10.0), 60_000.0)
            out_dir = str(body.get("dir") or profile_dir)
            if engine.engine.runner.device.type != "cuda":
                self._json(200, {"status": "skipped",
                                 "reason": "no accelerator backend (cpu) "
                                           "— nothing to profile",
                                 "duration_ms": duration_ms})
                return
            if not profile_lock.acquire(blocking=False):
                self._error("a profile capture is already running", 409,
                            "conflict_error")
                return
            try:
                path = _capture_profile(engine, out_dir, duration_ms)
            finally:
                profile_lock.release()
            logger.info("profile captured: %.0f ms -> %s", duration_ms, path)
            self._json(200, {"status": "ok", "dir": out_dir,
                             "duration_ms": duration_ms, "trace": path})

        # -- admin -------------------------------------------------------

        def is_sleeping(self) -> None:
            self._json(200, {"is_sleeping": engine.sleeping})

        def sleep(self) -> None:
            try:
                level = int(self.query.get("level", "1"))
            except ValueError:
                self._error("level must be an integer")
                return
            engine.sleep(level)
            self._json(200, {"status": "sleeping", "level": level})

        def wake_up(self) -> None:
            engine.wake_up()
            self._json(200, {"status": "awake"})

        def drain(self) -> None:
            """Stop admitting new requests; those in flight finish.
            ``?wait=1`` holds the answer (up to ``?timeout=`` seconds,
            default 30) until none is left; this thread polls, the step
            thread runs on."""
            engine.drain()
            if self.query.get("wait"):
                try:
                    timeout = float(self.query.get("timeout", "30"))
                except ValueError:
                    timeout = 30.0
                deadline = time.monotonic() + timeout
                while (time.monotonic() < deadline
                       and engine.num_inflight() > 0):
                    time.sleep(0.1)
            self._json(200, {"status": "draining",
                             "in_flight": engine.num_inflight()})

        def undrain(self) -> None:
            engine.undrain()
            self._json(200, {"status": "accepting",
                             "in_flight": engine.num_inflight()})

        def is_draining(self) -> None:
            self._json(200, {"is_draining": engine.draining,
                             "in_flight": engine.num_inflight()})

        # -- LoRA ----------------------------------------------------------

        def load_lora_adapter(self) -> None:
            """Parse the PEFT directory and write it into a bank slot, on
            the step thread (the operator's adapter reconciler)."""
            try:
                body = self._body()
            except ValueError as e:
                self._error(f"invalid request body: {e}")
                return
            name = body.get("lora_name")
            if not name:
                self._error("lora_name required")
                return
            if engine.engine.lora_manager is None:
                self._error("LoRA not enabled (--enable-lora)")
                return
            try:
                ad = engine.load_lora(name, body.get("lora_path"))
            except FileNotFoundError as e:
                self._error(str(e), 404, "not_found_error")
                return
            except (ValueError, RuntimeError) as e:
                self._error(str(e))
                return
            self._json(200, {"status": "ok", "name": ad.name,
                             "rank": ad.rank, "slot": ad.slot})

        def unload_lora_adapter(self) -> None:
            try:
                body = self._body()
            except ValueError as e:
                self._error(f"invalid request body: {e}")
                return
            name = body.get("lora_name")
            if not name:
                self._error("lora_name required")
                return
            removed = engine.unload_lora(name)
            self._json(200, {"status": "ok", "removed": bool(removed)})

        # -- tokens ------------------------------------------------------

        def tokenize(self) -> None:
            tok = engine.engine.tokenizer
            try:
                body = self._body()
                if body.get("messages"):
                    text = tok.apply_chat_template(
                        parse_messages(body["messages"]))
                else:
                    text = body.get("prompt") or ""
                    if not isinstance(text, str):
                        raise ValueError("prompt must be a string")
                ids = tok.encode(text, add_special_tokens=bool(
                    body.get("add_special_tokens", True)))
            except ValueError as e:
                self._error(f"invalid request body: {e}")
                return
            self._json(200, {"tokens": ids, "count": len(ids),
                             "max_model_len": engine.engine.cfg.max_model_len})

        def detokenize(self) -> None:
            try:
                ids = [int(t) for t in self._body().get("tokens", [])]
            except (TypeError, ValueError) as e:
                self._error(f"invalid request body: {e}")
                return
            self._json(200, {"prompt": engine.engine.tokenizer.decode(ids)})

        # -- embeddings, rerank, score ------------------------------------

        def _encode_refused(self) -> bool:
            """The generation routes' drain and warming gates and a spent
            deadline (504), as the JAX server's encode routes keep them.
            True when it answered."""
            if self._gate_refused():
                return True
            if self._request_deadline()[0]:
                self._deadline_error()
                return True
            return False

        def embeddings(self) -> None:
            """One vector a prompt: ``ModelRunner.encode`` on the step
            thread, between two steps. A prompt past ``max_model_len`` (or
            with an id outside the vocabulary) answers 400."""
            try:
                req = self._body()
                if not isinstance(req.get("model"), str):
                    raise ValueError("model: a string is required")
                inputs = embedding_inputs(req.get("input", ""))
            except (TypeError, ValueError) as e:
                self._error(f"invalid request body: {e}")
                return
            if self._encode_refused():
                return
            tok = engine.engine.tokenizer
            data, total = [], 0
            for i, item in enumerate(inputs):
                ids = item if isinstance(item, list) else tok.encode(item)
                total += len(ids)
                try:
                    vec = engine.encode(ids)
                except ValueError as e:
                    self._error(str(e))
                    return
                data.append({"object": "embedding", "index": i,
                             "embedding": vec.tolist()})
            self._json(200, {"object": "list", "data": data,
                             "model": req["model"],
                             "usage": {"prompt_tokens": total,
                                       "total_tokens": total}})

        def rerank(self) -> None:
            """The documents by relevance to the query, descending, the
            first ``top_n``."""
            if self._encode_refused():
                return
            try:
                body = self._body()
                query = _texts(body.get("query", ""), "query")[0]
                docs = _texts(body.get("documents", []), "documents")
                top_n = int(body.get("top_n") or len(docs))
                scores = _pair_scores([query] * len(docs), docs)
            except (TypeError, ValueError) as e:
                self._error(f"invalid request body: {e}")
                return
            order = sorted(range(len(docs)), key=lambda i: -scores[i])[:top_n]
            self._json(200, {
                "id": f"rerank-{uuid.uuid4().hex}",
                "model": body.get("model", model_name),
                "scoring_method": scoring_method,
                "results": [{"index": i, "document": {"text": docs[i]},
                             "relevance_score": scores[i]} for i in order],
            })

        def score(self) -> None:
            """The score of each (text_1, text_2) pair; a single
            ``text_1`` is paired with every ``text_2``."""
            if self._encode_refused():
                return
            try:
                body = self._body()
                l1 = _texts(body.get("text_1", ""), "text_1")
                l2 = _texts(body.get("text_2", ""), "text_2")
                if len(l1) == 1 and len(l2) > 1:
                    l1 = l1 * len(l2)
                scores = _pair_scores(l1, l2)
            except (TypeError, ValueError) as e:
                self._error(f"invalid request body: {e}")
                return
            self._json(200, {
                "id": f"score-{uuid.uuid4().hex}", "object": "list",
                "model": body.get("model", model_name),
                "scoring_method": scoring_method,
                "data": [{"index": i, "object": "score", "score": v}
                         for i, v in enumerate(scores)],
                "usage": {},
            })

        # -- generation --------------------------------------------------

        def completions(self) -> None:
            self._generation(is_chat=False)

        def chat_completions(self) -> None:
            self._generation(is_chat=True)

        def _generation(self, is_chat: bool) -> None:
            try:
                req = self._body()
            except ValueError as e:  # json.JSONDecodeError included
                self._error(f"invalid request body: {e}")
                return
            if engine.sleeping:
                self._error("engine is sleeping", 503, "service_unavailable")
                return
            if self._gate_refused():
                return
            tok = engine.engine.tokenizer
            if is_chat:
                try:
                    # continue_final_message renders the final turn open,
                    # so generation continues it instead of a new turn.
                    cfm = bool(req.get("continue_final_message", False))
                    ids = tok.encode(tok.apply_chat_template(
                        parse_messages(req.get("messages", [])),
                        add_generation_prompt=not cfm,
                        continue_final_message=cfm))
                except (TypeError, ValueError) as e:
                    self._error(f"invalid request body: {e}")
                    return
                self._serve(req, ids, is_chat=True)
                return
            try:
                prompts = completion_prompts(req.get("prompt", ""))
                fan_out = max(_opt(req, "n", int, 1),
                              _opt(req, "best_of", int, 1))
            except (TypeError, ValueError) as e:
                self._error(f"invalid request body: {e}")
                return
            if not prompts:
                self._error("prompt must not be empty")
                return
            if len(prompts) == 1:
                self._serve(req, prompts[0], is_chat=False)
                return
            if req.get("stream"):
                self._error("streaming is not supported for batched prompts")
                return
            if fan_out > 1:
                self._error(
                    "n/best_of > 1 is not supported for batched prompts")
                return
            self._serve_batch(req, prompts)

        # -- admission: gates, token ids, deadline, tenant ----------------

        def _gate_refused(self) -> bool:
            """Drain and warming: a 503 whose marker tells a router this is
            deliberate, not a failure (it fails over without a breaker
            penalty; accepting while warming would queue the request
            behind the warmup pass). True when it answered."""
            if engine.draining:
                self._error("engine is draining", 503, "service_unavailable",
                            headers={"X-PST-Draining": "1"})
                return True
            if engine.warming:
                self._error("engine is warming up (capturing step graphs)",
                            503, "service_unavailable",
                            headers={"X-PST-Warming": "1"})
                return True
            return False

        def _deadline_error(self) -> None:
            # A budget shed, not an engine failure: the marker keeps the
            # router's breaker out of it.
            self._error("deadline exceeded", 504, "deadline_exceeded",
                        headers={DEADLINE_EXCEEDED_HEADER: "1"})

        def _request_deadline(self):
            """``(expired, deadline)`` from ``X-PST-Deadline-Ms``: an
            already spent budget is shed here, before tokenization's work
            reaches the scheduler; else the monotonic expiry the
            scheduler sheds on (None without a header)."""
            if not engine.engine.cfg.deadline_shedding:
                return False, None
            d = parse_deadline(self.headers)
            if d is None:
                return False, None
            if d.expired():
                metrics.deadline_shed_admission.inc()
                self.trace.add_event("deadline_shed", stage="engine_admission")
                return True, None
            return False, d.expires_at

        def _request_tenant(self) -> dict:
            """The router-stamped tenant and tier (trusted: the router
            overwrites what clients send); an engine reached directly
            treats the caller as the default interactive tenant unless it
            declares itself."""
            if not engine.engine.cfg.tenant_fairness:
                return {}
            return {"tenant": self.headers.get("X-PST-Tenant"),
                    "tenant_class": self.headers.get("X-PST-Tenant-Class")}

        @staticmethod
        def _ids(prompt) -> List[int]:
            """A prompt of ``completion_prompts``: its ids, or its text's."""
            if isinstance(prompt, list):
                return prompt
            return engine.engine.tokenizer.encode(prompt)

        # -- one prompt ----------------------------------------------------

        def _serve(self, req: dict, prompt, is_chat: bool) -> None:
            """One prompt (text, or token ids) with its ``n``/``best_of``
            candidates, streamed or collected: the JAX server's
            ``_serve_generation``."""
            t_admission = time.monotonic()
            tok = engine.engine.tokenizer
            max_len = engine.engine.cfg.max_model_len
            try:
                ids = prompt if is_chat else self._ids(prompt)
                if len(ids) >= max_len:
                    raise ValueError(
                        f"prompt has {len(ids)} tokens, exceeds "
                        f"max_model_len={max_len}")
                if not engine.engine.scheduler.prompt_fits(len(ids)):
                    raise ValueError(
                        f"prompt of {len(ids)} tokens needs more KV pages "
                        f"than the engine has "
                        f"({engine.engine.allocator.num_blocks})")
                sampling = build_sampling(req, max_len, len(ids), tok)
                n = max(int(req.get("n") or 1), 1)
                # best_of is a completions field; a chat ignores it.
                best_of = n if is_chat else int(req.get("best_of") or n)
            except (TypeError, ValueError) as e:
                self._error(str(e))
                return
            expired, deadline = self._request_deadline()
            if expired:
                self._deadline_error()
                return
            # Tokenization, validation and the budget: engine admission.
            self.trace.record_span(
                "engine_admission", time.monotonic() - t_admission,
                attributes={"prompt_tokens": len(ids)})
            if best_of < n:
                self._error("best_of must be >= n")
                return
            # OpenAI's ceilings, and this server's fan-out bound.
            if best_of > 20 and best_of > n:
                self._error("best_of must be <= 20")
                return
            if n > 128 or best_of > 128:
                self._error("n must be <= 128")
                return
            echo = bool(req.get("echo")) and not is_chat
            rid = f"{'chatcmpl' if is_chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
            meta = dict(rid=rid, created=int(time.time()),
                        model=req.get("model", model_name), is_chat=is_chat,
                        ids=ids, echo=echo, start=time.time())
            admit = dict(deadline=deadline,
                         lora_name=_resolve_lora(req.get("model")),
                         **self._request_tenant())
            if n > 1 or best_of > 1:
                if req.get("stream"):
                    self._error(
                        "streaming with n/best_of > 1 is not supported")
                    return
                self._serve_choices(sampling, meta, admit, n, best_of)
                return
            kv_transfer = _kv_transfer_params(req)
            if kv_transfer is not None:
                self._prefetch(kv_transfer, deadline)
            gen = engine.generate(prompt_token_ids=ids, sampling=sampling,
                                  request_id=rid, kv_transfer=kv_transfer,
                                  **admit)
            if req.get("stream"):
                usage = bool((req.get("stream_options") or {}).get(
                    "include_usage"))
                self._stream(gen, meta, usage)
                return
            result = self._collect(gen)
            if result is None:
                return
            if result["finish_reason"] == "deadline":
                # Shed by the scheduler, queued past its budget or expired
                # mid-decode: nothing useful to return.
                self.trace.add_event("deadline_shed", stage="engine_scheduler")
                self._deadline_error()
                return
            self._record_stages(result)
            n_out = len(result["token_ids"])
            self._finished(meta, len(ids), n_out)
            self._reply(meta, [self._choice(meta, result, 0)], n_out,
                        cost=result["cost"])

        def _prefetch(self, kv_transfer: dict, deadline) -> None:
            """The consumer leg of a handoff: follow the producer's
            manifest and stage its pages in the host tier, on this thread,
            within the request's deadline; admission then finds the
            prompt a host-tier prefix hit. A timeout or a dead kvserver
            admits anyway (the fused fallback, counted)."""
            prefetcher = engine.engine.kv_prefetcher
            if prefetcher is None or kv_transfer.get("role") != "consumer":
                return
            t0 = time.monotonic()
            fetch = prefetcher.prefetch(kv_transfer["request_id"],
                                        deadline=deadline)
            self.trace.add_event("kv_prefetch", complete=fetch["complete"],
                                 blocks=fetch["blocks"])
            recorder.observe_stage("kv_prefetch", time.monotonic() - t0)

        def _serve_choices(self, sampling: SamplingParams, meta: dict,
                           admit: dict, n: int, best_of: int) -> None:
            """``best_of`` candidates of one prompt, candidate ``i`` seeded
            ``seed + i``, all submitted together; with ``best_of > n`` the
            ``n`` of highest mean token logprob are kept (so logprobs are
            asked for internally). Every candidate's tokens are billed."""
            rank = best_of > n
            lp = 0 if rank and sampling.logprobs is None else sampling.logprobs
            rid = meta["rid"]
            gens = [engine.generate(
                prompt_token_ids=meta["ids"], request_id=f"{rid}-{i}",
                sampling=dataclasses.replace(
                    sampling, logprobs=lp,
                    seed=None if sampling.seed is None else sampling.seed + i),
                **admit) for i in range(best_of)]
            results = self._collect_all(gens, rid)
            if results is None:
                return
            # The first candidate's stages: all share admission and the
            # prompt's prefill, and the stage counts stay one a request.
            self._record_stages(results[0])
            n_out = sum(len(r["token_ids"]) for r in results)
            if rank:
                def mean_lp(r):
                    lps = [e["logprob"] for e in r["logprobs"]]
                    return sum(lps) / max(len(lps), 1)

                results.sort(key=mean_lp, reverse=True)
                results = results[:n]
                if sampling.logprobs is None:  # not asked for: strip
                    for r in results:
                        r["logprobs"] = []
            self._finished(meta, len(meta["ids"]), n_out)
            self._reply(meta, [self._choice(meta, r, i)
                               for i, r in enumerate(results)], n_out)

        # -- a batch of prompts --------------------------------------------

        def _serve_batch(self, req: dict, prompts: list) -> None:
            """One choice a prompt, index-aligned (no logprobs, as the JAX
            server's ``_serve_completion_batch``)."""
            tok = engine.engine.tokenizer
            max_len = engine.engine.cfg.max_model_len
            expired, deadline = self._request_deadline()
            if expired:
                self._deadline_error()
                return
            batch = []
            try:
                for p in prompts:
                    ids = self._ids(p)
                    if len(ids) >= max_len:
                        raise ValueError(
                            f"prompt has {len(ids)} tokens (max {max_len})")
                    batch.append((ids, build_sampling(req, max_len, len(ids),
                                                      tok)))
            except (TypeError, ValueError) as e:
                self._error(str(e))
                return
            rid = f"cmpl-{uuid.uuid4().hex[:24]}"
            meta = dict(rid=rid, created=int(time.time()),
                        model=req.get("model", model_name), is_chat=False,
                        echo=False, start=time.time())
            admit = dict(deadline=deadline, **self._request_tenant())
            gens = [engine.generate(prompt_token_ids=ids, sampling=sp,
                                    request_id=f"{rid}-{i}", **admit)
                    for i, (ids, sp) in enumerate(batch)]
            results = self._collect_all(gens, rid)
            if results is None:
                return
            n_in = sum(len(ids) for ids, _ in batch)
            n_out = sum(len(r["token_ids"]) for r in results)
            self._finished(meta, n_in, n_out)
            self._reply(meta, [
                {"index": i, "text": r["text"], "logprobs": None,
                 "finish_reason": r["finish_reason"]}
                for i, r in enumerate(results)], n_out, n_in)

        # -- answers -------------------------------------------------------

        def _finished(self, meta: dict, n_in: int, n_out: int) -> None:
            metrics.e2e.observe(time.time() - meta["start"])
            metrics.success.inc()
            metrics.prompt_tokens.inc(n_in)
            metrics.generation_tokens.inc(n_out)

        def _collect(self, gen) -> Optional[dict]:
            """Drain one request's outputs into its text, token ids,
            logprob entries, finish, stage timings, compile events and
            cost; None once an error was answered (a refusal on the
            engine thread: 400; a failed engine: 500)."""
            text, token_ids, entries, compiles = [], [], [], []
            last = dict.fromkeys(("finish_reason", "queue_time",
                                  "prefill_time", "decode_time", "cost"))
            try:
                for out in gen:
                    if out.num_output_tokens == 1 and out.ttft is not None:
                        metrics.ttft.observe(out.ttft)
                    text.append(out.text_delta)
                    token_ids.extend(out.new_token_ids)
                    entries.extend(out.logprobs or ())
                    compiles.extend(out.compile_events or ())
                    for k in last:
                        if getattr(out, k) is not None:
                            last[k] = getattr(out, k)
            except ValueError as e:  # refused on the engine thread
                self._error(str(e))
                return None
            except RuntimeError as e:  # the engine failed
                self._error(str(e), 500)
                return None
            return {"text": "".join(text), "token_ids": token_ids,
                    "logprobs": entries, "compile_events": compiles, **last}

        def _record_stages(self, result: dict) -> None:
            """The request's queue wait, prefill and decode as spans laid
            back to back and ending now (after the fact, so the step
            thread never touches the recorder), and its compile events."""
            now = time.monotonic()
            end_prefill = now - (result["decode_time"] or 0.0)
            end_queue = end_prefill - (result["prefill_time"] or 0.0)
            if result["queue_time"] is not None:
                self.trace.record_span("engine_queue", result["queue_time"],
                                       end_mono=end_queue)
            if result["prefill_time"] is not None:
                self.trace.record_span("prefill", result["prefill_time"],
                                       end_mono=end_prefill)
            if result["decode_time"] is not None:
                self.trace.record_span("decode", result["decode_time"],
                                       end_mono=now)
            for ev in result["compile_events"]:
                self.trace.add_event("compile", **ev)

        def _collect_all(self, gens: list, rid: str) -> Optional[list]:
            """The results of requests ``{rid}-{i}`` submitted together;
            None once an answer was sent: an error (the others aborted),
            or a 504 when any ran out of its budget (the whole answer
            cannot come within it)."""
            results = []
            for gen in gens:
                result = self._collect(gen)
                if result is None:
                    for i in range(len(gens)):
                        engine.abort(f"{rid}-{i}")
                    return None
                results.append(result)
            if any(r["finish_reason"] == "deadline" for r in results):
                self._deadline_error()
                return None
            return results

        def _choice(self, meta: dict, result: dict, index: int) -> dict:
            """A choice of the JAX server's ``_build_choice``: an echoed
            prompt leads the text, and its tokens the logprobs."""
            tok = engine.engine.tokenizer
            entries, echo = result["logprobs"], meta["echo"]
            if meta["is_chat"]:
                return {"index": index,
                        "message": {"role": "assistant",
                                    "content": result["text"]},
                        "logprobs": fmt_chat_logprobs(tok, entries)
                        if entries else None,
                        "finish_reason": result["finish_reason"]}
            text = result["text"]
            if echo:
                text = tok.decode(meta["ids"]) + text
            return {"index": index, "text": text,
                    "logprobs": fmt_completion_logprobs(
                        tok, entries, meta["ids"] if echo else None)
                    if entries else None,
                    "finish_reason": result["finish_reason"]}

        def _reply(self, meta: dict, choices: list, n_out: int,
                   n_in: Optional[int] = None,
                   cost: Optional[dict] = None) -> None:
            n_in = len(meta["ids"]) if n_in is None else n_in
            usage = {"prompt_tokens": n_in, "completion_tokens": n_out,
                     "total_tokens": n_in + n_out}
            headers = {"X-Request-Id": meta["rid"]}
            if cost is not None:
                # The request's device seconds, as a header a router
                # passes on and as a usage extension.
                usage["pst_cost"] = cost
                headers["X-PST-Cost"] = json.dumps(cost, separators=(",", ":"))
            self._json(200, {
                "id": meta["rid"],
                "object": "chat.completion" if meta["is_chat"]
                else "text_completion",
                "created": meta["created"], "model": meta["model"],
                "choices": choices, "usage": usage,
            }, headers=headers)

        def _stream(self, gen, meta: dict, usage: bool) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Request-Id", meta["rid"])
            self.end_headers()

            def frame(payload) -> None:
                data = payload if isinstance(payload, str) else json.dumps(payload)
                self.wfile.write(f"data: {data}\n\n".encode())
                self.wfile.flush()

            tok = engine.engine.tokenizer
            is_chat = meta["is_chat"]
            head = {"id": meta["rid"],
                    "object": "chat.completion.chunk" if is_chat
                    else "text_completion",
                    "created": meta["created"], "model": meta["model"]}
            n_prompt, n_out = len(meta["ids"]), 0
            # text_offset runs over the whole completion, an echoed prompt
            # included; the echo leads the first chunk's text.
            echo = tok.decode(meta["ids"]) if meta["echo"] else ""
            char_off = len(echo)
            last = None
            try:
                if is_chat:
                    frame({**head, "choices": [{
                        "index": 0, "delta": {"role": "assistant"},
                        "finish_reason": None}]})
                for out in gen:
                    n_out = out.num_output_tokens
                    last = out
                    for ev in out.compile_events or ():
                        self.trace.add_event("compile", **ev)
                    if out.num_output_tokens == 1 and out.ttft is not None:
                        metrics.ttft.observe(out.ttft)
                    if is_chat:
                        choice = {"index": 0,
                                  "delta": {"content": out.text_delta}
                                  if out.text_delta else {},
                                  "logprobs": fmt_chat_logprobs(
                                      tok, out.logprobs)
                                  if out.logprobs else None,
                                  "finish_reason": out.finish_reason}
                    else:
                        choice = {"index": 0, "text": echo + out.text_delta,
                                  "logprobs": fmt_completion_logprobs(
                                      tok, out.logprobs,
                                      base_offset=char_off)
                                  if out.logprobs else None,
                                  "finish_reason": out.finish_reason}
                        echo = ""
                    char_off += len(out.text_delta)
                    chunk = {**head, "choices": [choice]}
                    if out.finished and usage:
                        chunk["usage"] = {"prompt_tokens": n_prompt,
                                          "completion_tokens": n_out,
                                          "total_tokens": n_prompt + n_out}
                        # A stream learns its cost at its end, after its
                        # headers: the usage chunk carries it.
                        if out.cost is not None:
                            chunk["usage"]["pst_cost"] = out.cost
                    frame(chunk)
            except ValueError as e:  # refused on the engine thread
                frame({"error": {"message": str(e),
                                 "type": "invalid_request_error",
                                 "code": "engine_rejected"}})
            except RuntimeError as e:  # the engine failed
                frame({"error": {"message": str(e), "type": "server_error",
                                 "code": "engine_failed"}})
            except (BrokenPipeError, ConnectionResetError):
                gen.close()  # aborts the request on the engine
                return
            else:
                if last is not None:
                    self._record_stages({
                        "queue_time": last.queue_time,
                        "prefill_time": last.prefill_time,
                        "decode_time": last.decode_time,
                        "compile_events": ()})
                self._finished(meta, n_prompt, n_out)
            frame("[DONE]")

    GET_ROUTES = {
        "/health": Handler.health,
        "/ready": Handler.ready,
        "/v1/models": Handler.models,
        "/metrics": Handler.metrics,
        "/version": Handler.version,
        "/debug/state": Handler.debug_state,
        "/debug/requests": Handler.debug_requests,
        "/debug/flight": Handler.debug_flight,
        "/is_sleeping": Handler.is_sleeping,
        "/is_draining": Handler.is_draining,
    }
    POST_ROUTES = {
        "/v1/completions": Handler.completions,
        "/v1/chat/completions": Handler.chat_completions,
        "/tokenize": Handler.tokenize,
        "/detokenize": Handler.detokenize,
        "/sleep": Handler.sleep,
        "/wake_up": Handler.wake_up,
        "/drain": Handler.drain,
        "/undrain": Handler.undrain,
        "/debug/profile": Handler.debug_profile,
        "/v1/load_lora_adapter": Handler.load_lora_adapter,
        "/v1/unload_lora_adapter": Handler.unload_lora_adapter,
        "/v1/embeddings": Handler.embeddings,
        "/rerank": Handler.rerank,
        "/v1/rerank": Handler.rerank,
        "/v2/rerank": Handler.rerank,
        "/score": Handler.score,
        "/v1/score": Handler.score,
    }

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    server.routes = {"GET": sorted(GET_ROUTES), "POST": sorted(POST_ROUTES)}
    cfg = engine.engine.cfg
    # The controller registration's stop switch (None without one): a
    # daemon thread registers every 10 s until it is set.
    server.controller_reports = None
    if cfg.cache_controller_url:
        engine_url = (cfg.engine_url
                      or f"http://{host}:{server.server_address[1]}")
        server.controller_reports = threading.Event()
        threading.Thread(
            target=controller_report_loop, name="engine-controller-report",
            args=(engine, cfg.cache_controller_url, engine_url, 10.0,
                  server.controller_reports), daemon=True).start()
    return server


def register_with_controller(engine: AsyncLLMEngine, controller_url: str,
                             engine_url: str, timeout: float = 5.0) -> bool:
    """One snapshot registration of the engine's resident chunk hashes
    with the cache controller (``replace``: the snapshot is the engine's
    whole claim). Best effort: False when the controller did not take
    it."""
    eng = engine.engine
    parts = urlsplit(controller_url.rstrip("/"))
    body = json.dumps({"url": engine_url, "model": eng.model_name,
                       "hashes": eng.registered_chunk_hashes(),
                       "replace": True}).encode()
    try:
        conn = http.client.HTTPConnection(parts.hostname, parts.port or 80,
                                          timeout=timeout)
        try:
            conn.request("POST", parts.path + "/register", body,
                         {"Content-Type": "application/json"})
            return conn.getresponse().status == 200
        finally:
            conn.close()
    except (OSError, http.client.HTTPException) as e:
        logger.debug("controller registration failed: %s", e)
        return False


def controller_report_loop(engine: AsyncLLMEngine, controller_url: str,
                           engine_url: str, interval: float,
                           stop: threading.Event) -> None:
    """Register every ``interval`` seconds until ``stop`` is set (the
    JAX server's heartbeat; it feeds KV-aware routing)."""
    while True:
        register_with_controller(engine, controller_url, engine_url)
        if stop.wait(interval):
            return


def _prime_profiler() -> None:
    """Initialize the profiler's tracing library on this thread (the one
    that builds the app, which imported torch), before the engine's step
    thread runs: the library refuses to initialize from another thread
    (``External init callback must run in same thread as
    registerClient``) and then records no kernel, and a capture runs on
    the step thread."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass
    torch.cuda.synchronize()


def _capture_profile(engine: AsyncLLMEngine, out_dir: str,
                     duration_ms: float) -> str:
    """Profile the step thread's CPU work and the card for
    ``duration_ms`` and write the Chrome/Perfetto trace under
    ``out_dir``; returns its path. The profiler starts and stops on the
    step thread between two steps: stopping it on another thread while
    the step thread launches a CUDA graph can deadlock the two."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    engine.on_step_thread(prof.start)
    try:
        time.sleep(duration_ms / 1000.0)
    finally:
        engine.on_step_thread(prof.stop)
    path = os.path.join(out_dir, f"pst_profile_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def parse_engine_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="production-stack-tpu PyTorch serving engine"
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model", default="llama-3-8b",
                   help="a preset name or a local HF checkpoint directory")
    p.add_argument("--served-model-name", default=None,
                   help="the model name /v1/models and the answers carry "
                        "(default: the preset's)")
    p.add_argument("--tokenizer", default=None,
                   help="a local HF tokenizer directory (default: the "
                        "checkpoint directory, else the byte tokenizer)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--num-kv-blocks", type=int, default=None)
    p.add_argument("--gpu-memory-utilization", "--hbm-utilization",
                   dest="hbm_utilization", type=float, default=0.9,
                   help="share of the card's memory the weights, the "
                        "step graphs and the KV cache may take")
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-num-batched-tokens", dest="max_prefill_tokens",
                   type=int, default=2048)
    # The JAX server's mesh axes. The port serves tensor parallelism; the
    # other four take 1, a larger size is refused at start
    # (engine_config_from_args).
    for axis in PARALLEL_AXES:
        p.add_argument(f"--{axis}-parallel-size", type=int, default=1)
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "gather", "pallas"],
                   help="paged attention: the CUDA kernels on the card "
                        "(auto, pallas) or the plain PyTorch path (gather)")
    p.add_argument("--moe-impl", default="auto",
                   choices=["auto", "ragged", "dense"],
                   help="mixture-of-experts form, by its JAX name; "
                        "all three run every expert on every token, "
                        "then the one-hot combine")
    p.add_argument("--enable-prefix-caching", action="store_true",
                   default=True)
    p.add_argument("--no-enable-prefix-caching",
                   dest="enable_prefix_caching", action="store_false")
    p.add_argument("--api-key", default=None,
                   help="require 'Authorization: Bearer <key>' on every "
                        "route but the probes and /metrics")
    p.add_argument("--sentry-dsn", default=None,
                   help="report errors to Sentry (needs sentry_sdk)")
    # LoRA serving (the chart emits --enable-lora --lora-dir for a
    # modelSpec with lora.enabled).
    p.add_argument("--enable-lora", action="store_true", default=False)
    p.add_argument("--max-loras", type=int, default=8)
    p.add_argument("--max-lora-rank", type=int, default=16)
    p.add_argument("--lora-dir", default="/adapters")
    # Cross-encoder scoring for /rerank and /score (the chart emits it for
    # a modelSpec with scoringModel): a preset (random weights) or a local
    # HF sequence-classification checkpoint.
    p.add_argument("--scoring-model", default=None)
    # The kernel library's compile cache (the chart's warmup.cacheDir).
    p.add_argument("--compile-cache-dir", default=None,
                   help="build the CUDA kernel library into, and load it "
                        "from, <dir>/<key> (key: the sources, the nvcc "
                        "version and the arch), so a restart on the same "
                        "volume skips the build")
    p.add_argument("--num-decode-steps", type=int, default=1)
    p.add_argument("--adaptive-decode-steps", type=int, default=0,
                   help="deep burst cap when the arrival stream is quiet")
    p.add_argument("--adaptive-decode-quiet-s", type=float, default=0.5)
    p.add_argument("--adaptive-decode-min-running", type=int, default=0)
    p.add_argument("--min-decode-bucket", type=int, default=1,
                   help="floor of a decode batch's row bucket")
    # Overlapped decode pipeline: burst N+1 is dispatched before burst N's
    # rows are applied, under the adaptive depth's arrival gates.
    p.add_argument("--overlap-decode", dest="overlap_decode",
                   action="store_true", default=True)
    p.add_argument("--no-overlap-decode", dest="overlap_decode",
                   action="store_false",
                   help="disable the arrival-gated overlapped decode "
                        "pipeline (synchronous loop)")
    # Speculative decoding (n-gram prompt lookup; 0 = off).
    p.add_argument("--speculative-ngram", type=int, default=0,
                   help="max draft tokens per step via n-gram prompt lookup")
    p.add_argument("--ngram-min", type=int, default=1)
    p.add_argument("--ngram-max", type=int, default=3)
    p.add_argument("--ngram-lookback", type=int, default=8192,
                   help="cap prompt-lookup scan to last N tokens (0 = all)")
    p.add_argument("--quantization", choices=("int8", "int4"), default=None,
                   help="weight-only quantization (int4: W4A16 kernel)")
    p.add_argument("--kv-cache-dtype", default=None,
                   help="KV cache element type: the model dtype (default) "
                        "or float8_e4m3fn")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", default="off", choices=["off", "lazy", "full"],
                   help="step capture before /ready flips: full = entire "
                        "shape-bucket lattice, lazy = the core set the first "
                        "requests hit, off = capture each bucket on first use")
    p.add_argument("--warmup-bucket-budget", type=int, default=0,
                   help="cap warmup to this many lattice buckets, "
                        "most-likely-first (0 = whole lattice)")
    # Live-sequence KV swap: preemption parks KV instead of recomputing.
    p.add_argument("--kv-swap", action="store_true", default=True)
    p.add_argument("--no-kv-swap", dest="kv_swap", action="store_false")
    p.add_argument("--swap-quantum-tokens", type=int, default=256,
                   help="decode tokens before a running seq may rotate out "
                        "for parked/queued work (0 = only under pressure)")
    p.add_argument("--swap-stash-blocks", type=int, default=4096,
                   help="host budget for stashed tail pages (KV pages)")
    # KV tiering, the remote store and the cache controller.
    p.add_argument("--cpu-offload-blocks", type=int, default=0)
    p.add_argument("--remote-kv-url", default=None,
                   help="kvserver base URL; a comma-separated list makes "
                        "the engine a sharded-ring client")
    p.add_argument("--kv-replication", type=int, default=2,
                   help="replicas per KV block/manifest on the kvserver "
                        "ring (clamped to the shard count)")
    p.add_argument("--cache-controller-url", default=None)
    p.add_argument("--engine-url", default=None)
    p.add_argument("--kv-role", default="none",
                   choices=["none", "producer", "consumer", "both"])
    # The streamed handoff: the consumer's prefetch batch depth, and the
    # seconds it waits for a manifest's completion before recomputing
    # the prefill here (the fused fallback).
    p.add_argument("--kv-prefetch-depth", type=int, default=64,
                   help="max KV pages per batched GET while following a "
                        "disagg prefill's manifest")
    p.add_argument("--kv-transfer-timeout-s", type=float, default=10.0,
                   help="seconds the decode engine waits for a disagg "
                        "manifest's completion marker before recomputing "
                        "the prefill locally (fused fallback)")
    # Honor the router-propagated X-PST-Deadline-Ms budget.
    p.add_argument("--deadline-shedding", dest="deadline_shedding",
                   action="store_true", default=True)
    p.add_argument("--no-deadline-shedding", dest="deadline_shedding",
                   action="store_false")
    # Honor the router-stamped X-PST-Tenant / X-PST-Tenant-Class headers
    # (weighted-fair admission, batch preempted first).
    p.add_argument("--tenant-fairness", dest="tenant_fairness",
                   action="store_true", default=True)
    p.add_argument("--no-tenant-fairness", dest="tenant_fairness",
                   action="store_false")
    # Request tracing: engine spans for admission, queue wait, prefill and
    # decode, joined to the router's trace by the propagated traceparent.
    p.add_argument("--tracing", dest="tracing", action="store_true",
                   default=True)
    p.add_argument("--no-tracing", dest="tracing", action="store_false")
    p.add_argument("--debug-requests-buffer", type=int, default=256,
                   help="completed request timelines kept for "
                        "GET /debug/requests (0 disables the endpoint)")
    p.add_argument("--log-format", choices=list(LOG_FORMATS),
                   default="text",
                   help="log output format: 'json' emits one JSON object "
                        "per line with trace_id/request_id/tenant/"
                        "engine_id")
    p.add_argument("--profiling", dest="profiling", action="store_true",
                   default=False,
                   help="enable POST /debug/profile (an on-demand "
                        "torch.profiler trace; skipped on a CPU engine)")
    p.add_argument("--profile-dir", default=DEFAULT_PROFILE_DIR,
                   help="directory POST /debug/profile writes traces to")
    p.add_argument("--startup-phases", dest="startup_phases",
                   action="store_true", default=True)
    p.add_argument("--no-startup-phases", dest="startup_phases",
                   action="store_false",
                   help="do not export pst_engine_startup_seconds")
    # Flight recorder and cost attribution.
    p.add_argument("--flight-buffer", type=int, default=512,
                   help="per-step flight-recorder ring capacity (GET "
                        "/debug/flight; auto-snapshots on tail outliers "
                        "and SIGTERM/fatal; 0 disables recording)")
    p.add_argument("--flight-snapshot-dir", default=None,
                   help="persist retained flight snapshots as JSON files "
                        "under this directory (bounded, oldest-first "
                        "eviction) and load them back into GET "
                        "/debug/flight?snapshots=1 after a restart")
    p.add_argument("--cost-attribution", dest="cost_attribution",
                   action="store_true", default=True)
    p.add_argument("--no-cost-attribution", dest="cost_attribution",
                   action="store_false",
                   help="disable per-request device-seconds attribution "
                        "(X-PST-Cost header, pst_request_device_seconds, "
                        "pst_tenant_device_seconds)")
    return p.parse_args(argv)


def engine_config_from_args(args: argparse.Namespace) -> EngineConfig:
    """The engine's config from the server's flags. A sequence or expert
    size above 1 raises: the port serves the tensor, pipeline and data
    axes, and those two are queue 1, items 15.iii and 15.iv of
    ROADMAP.md."""
    for axis, item in UNSERVED_AXES.items():
        size = getattr(args, f"{axis}_parallel_size")
        if size != 1:
            raise ValueError(
                f"--{axis}-parallel-size {size}: the PyTorch engine serves "
                f"the tensor, pipeline and data axes (the {axis} axis is "
                f"queue 1, item {item} of ROADMAP.md); pass 1")
    return EngineConfig(
        tensor_parallel_size=args.tensor_parallel_size,
        pipeline_parallel_size=args.pipeline_parallel_size,
        data_parallel_size=args.data_parallel_size,
        model=args.model,
        tokenizer=args.tokenizer,
        served_model_name=args.served_model_name,
        device=args.device,
        max_model_len=args.max_model_len,
        block_size=args.block_size,
        num_kv_blocks=args.num_kv_blocks,
        hbm_utilization=args.hbm_utilization,
        max_num_seqs=args.max_num_seqs,
        max_prefill_tokens=args.max_prefill_tokens,
        attn_impl=args.attn_impl,
        moe_impl=args.moe_impl,
        enable_prefix_caching=args.enable_prefix_caching,
        enable_lora=args.enable_lora,
        max_loras=args.max_loras,
        max_lora_rank=args.max_lora_rank,
        lora_dir=args.lora_dir,
        num_decode_steps=args.num_decode_steps,
        adaptive_decode_steps=args.adaptive_decode_steps,
        adaptive_decode_quiet_s=args.adaptive_decode_quiet_s,
        adaptive_decode_min_running=args.adaptive_decode_min_running,
        min_decode_bucket=args.min_decode_bucket,
        overlap_decode=args.overlap_decode,
        speculative_ngram=args.speculative_ngram,
        ngram_min=args.ngram_min,
        ngram_max=args.ngram_max,
        ngram_lookback=args.ngram_lookback,
        quantization=args.quantization,
        kv_cache_dtype=args.kv_cache_dtype,
        seed=args.seed,
        warmup=args.warmup,
        warmup_bucket_budget=args.warmup_bucket_budget,
        kv_swap=args.kv_swap,
        swap_quantum_tokens=args.swap_quantum_tokens,
        swap_stash_blocks=args.swap_stash_blocks,
        cpu_offload_blocks=args.cpu_offload_blocks,
        remote_kv_url=args.remote_kv_url,
        kv_replication=args.kv_replication,
        cache_controller_url=args.cache_controller_url,
        engine_url=args.engine_url,
        kv_role=args.kv_role,
        kv_prefetch_depth=args.kv_prefetch_depth,
        kv_transfer_timeout_s=args.kv_transfer_timeout_s,
        deadline_shedding=args.deadline_shedding,
        tenant_fairness=args.tenant_fairness,
        flight_buffer=args.flight_buffer,
        flight_snapshot_dir=args.flight_snapshot_dir,
        cost_attribution=args.cost_attribution,
        startup_phases=args.startup_phases,
        compile_cache_dir=args.compile_cache_dir,
    )


def app_options_from_args(args: argparse.Namespace) -> dict:
    """``create_engine_app``'s keywords from the server's flags (the
    cross-encoder is ``cross_encoder_from_args``'s)."""
    return dict(tracing=args.tracing,
                debug_requests_buffer=args.debug_requests_buffer,
                profiling=args.profiling, profile_dir=args.profile_dir,
                api_key=args.api_key)


def cross_encoder_from_args(args: argparse.Namespace):
    """The ``--scoring-model``'s cross-encoder on ``--device``, or None."""
    if not args.scoring_model:
        return None
    from .cross_encoder import CrossEncoder

    ce = CrossEncoder(args.scoring_model, device=args.device)
    logger.info("cross-encoder scoring model loaded: %s", ce.cfg.name)
    return ce


class _Terminated(Exception):
    """Raised in the main thread by SIGTERM, to leave ``serve_forever``."""


def _on_sigterm(signum, frame):
    raise _Terminated


def main(argv=None) -> None:
    args = parse_engine_args(argv)
    configure_logging(args.log_format, component="engine",
                      engine_id=f"{args.host}:{args.port}")
    cfg = engine_config_from_args(args)
    # Error reporting and span export, no-ops without their SDKs (OTel
    # also needs OTEL_EXPORTER_OTLP_ENDPOINT), as in the JAX server.
    init_sentry(args.sentry_dsn)
    init_otel("pst-engine")
    if cfg.num_ranks > 1 and DistributedConfig.from_env().process_id != 0:
        # A pod other than the first: mirror rank 0, serve nothing.
        sys.exit(start_ranks(cfg).follow())
    # With more than one rank the engine starts this host's ranks and
    # stops them at its shutdown.
    engine = AsyncLLMEngine(cfg)
    server = create_engine_app(engine, args.host, args.port,
                               cross_encoder=cross_encoder_from_args(args),
                               **app_options_from_args(args))
    engine.start()
    logger.info("serving %s on %s:%d (%s)", engine.engine.model_name,
                args.host, server.server_address[1], args.device)
    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, _Terminated):
        pass
    finally:
        # Freeze the flight ring so a terminated server leaves a
        # post-mortem in its log (/debug/flight dies with the process).
        snap = engine.engine.flight.snapshot("sigterm")
        if snap["records"]:
            logger.info("flight snapshot (sigterm): %d steps recorded, "
                        "tail=%s", snap["total_steps"], snap["records"][-3:])
        if server.controller_reports is not None:
            server.controller_reports.set()
        server.server_close()
        engine.shutdown()  # every local rank stopped, or killed


def serve_in_thread(engine: AsyncLLMEngine, host: str = "127.0.0.1",
                    port: int = 0, **app_options
                    ) -> "tuple[ThreadingHTTPServer, threading.Thread]":
    """Start the engine loop and an HTTP server on a background thread
    (``app_options``: ``create_engine_app``'s keywords); returns (server,
    thread). Stop with ``server.shutdown()`` and ``engine.shutdown()``."""
    server = create_engine_app(engine, host, port, **app_options)
    if engine._thread is None:
        engine.start()
    t = threading.Thread(target=server.serve_forever, name="http", daemon=True)
    t.start()
    return server, t


if __name__ == "__main__":
    main()
