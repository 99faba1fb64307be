"""The port's completion route maps the sampling fields as the JAX server.

Every field of ``production_stack_tpu.protocols.SamplingFields`` goes
through both ``build_sampling``s, the JAX one fed ``CompletionRequest(
**body)``, and the two ``SamplingParams`` must agree field by field. A
tiny-preset server then answers ``logprobs`` in the JAX server's shape
(its ``_fmt_completion_logprobs`` over the port engine's own entries) and
``max_completion_tokens``.
"""

import dataclasses
import http.client
import json

import pytest

from production_stack_tpu.engine.server import (
    _fmt_completion_logprobs as jax_fmt_logprobs,
)
from production_stack_tpu.engine.server import build_sampling as jax_build
from production_stack_tpu.engine.tokenizer import ByteTokenizer as JaxByteTok
from production_stack_tpu.protocols import CompletionRequest, SamplingFields
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import build_sampling, serve_in_thread
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

# One body per field of SamplingFields (and some of their combinations);
# the fields that change no SamplingParams (n, stream, stream_options,
# user) ride along at values the port serves.
BODIES = [
    {},
    {"max_tokens": 7},
    {"max_completion_tokens": 5, "max_tokens": 9},
    {"max_tokens": 10_000},
    {"temperature": 0.3, "top_p": 0.8, "top_k": 12, "min_p": 0.05},
    {"n": 1, "stream": True, "stream_options": {"include_usage": True},
     "user": "u-1"},
    {"stop": "\n\n"},
    {"stop": ["a", "bc"], "stop_token_ids": [3, 4]},
    {"presence_penalty": 0.5, "frequency_penalty": -0.2,
     "repetition_penalty": 1.3},
    {"seed": 1234},
    {"logprobs": 3},
    {"logprobs": 0},
    {"logprobs": True, "top_logprobs": 4},
    {"logprobs": True},
    {"logprobs": False, "top_logprobs": 2},
    {"logit_bias": {"5": 4.0, "17": -2.5}},
    {"guided_choice": ["yes", "no", "maybe"], "ignore_eos": True},
    {"ignore_eos": True},
]


def test_build_sampling_matches_jax_for_every_field():
    covered = set().union(*BODIES)
    assert covered == set(SamplingFields.model_fields), (
        set(SamplingFields.model_fields) - covered)
    names = [f.name for f in dataclasses.fields(SamplingParams)]
    for body in BODIES:
        want = jax_build(CompletionRequest(model="m", **body), 256, 20,
                         JaxByteTok(512))
        got = build_sampling(body, 256, 20, ByteTokenizer(512))
        for name in names:
            assert getattr(got, name) == getattr(want, name), (body, name)
    # The JAX server's refusals are the port's: a 400 (ValueError) each.
    for body in ({"logit_bias": {"x": 1.0}}, {"logit_bias": {"3": 101.0}},
                 {"guided_choice": ["ok", ""]}):
        with pytest.raises(ValueError):
            jax_build(CompletionRequest(model="m", **body), 256, 20,
                      JaxByteTok(512))
        with pytest.raises(ValueError):
            build_sampling(body, 256, 20, ByteTokenizer(512))


PROMPT = "Logprobs, token by token."


@pytest.fixture(scope="module")
def served():
    cfg = EngineConfig(model="tiny-llama-debug", device="cpu", block_size=8,
                       max_model_len=128, num_kv_blocks=64,
                       max_prefill_tokens=16)
    engine = AsyncLLMEngine(cfg)
    # The engine's own logprob entries for the request, before the step
    # thread starts.
    eng = engine.engine
    eng.add_request("ref", prompt=PROMPT, sampling=SamplingParams(
        max_tokens=6, temperature=0.0, ignore_eos=True, logprobs=2))
    entries = []
    while eng.has_work():
        for out in eng.step():
            entries.extend(out.logprobs or ())
    server, thread = serve_in_thread(engine)
    yield server.server_address[1], entries
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _same_logprobs(got, want):
    """The same object, logprob values to 1e-5: the served request reuses
    the reference run's cached prefix pages, so its prefill is chunked
    differently and its float sums differ in the last bits."""
    assert set(got) == set(want)
    assert got["tokens"] == want["tokens"]
    assert got["text_offset"] == want["text_offset"]
    assert got["token_logprobs"] == pytest.approx(want["token_logprobs"],
                                                  abs=1e-5)
    for g, w in zip(got["top_logprobs"], want["top_logprobs"], strict=True):
        assert g.keys() == w.keys()
        assert list(g.values()) == pytest.approx(list(w.values()), abs=1e-5)


def test_logprobs_and_max_completion_tokens_are_served(served):
    port, entries = served
    body = {"prompt": PROMPT, "max_tokens": 6, "temperature": 0.0,
            "ignore_eos": True, "logprobs": 2}
    want = jax_fmt_logprobs(JaxByteTok(512), entries)
    assert len(want["tokens"]) == 6
    assert all(len(e["top"]) == 2 for e in entries)
    status, raw = _post(port, body)
    assert status == 200
    _same_logprobs(json.loads(raw)["choices"][0]["logprobs"], want)
    # Streamed: one entry a frame, whose text_offset starts at the length
    # of the text streamed before it (as the JAX server's base_offset), and
    # the usage frame asked for by stream_options.
    status, raw = _post(port, {**body, "stream": True,
                               "stream_options": {"include_usage": True}})
    assert status == 200
    frames = [json.loads(ln[6:]) for ln in raw.split(b"\n")
              if ln.startswith(b"data: {")]
    merged = {k: [] for k in want}
    streamed = 0
    for f in frames:
        lp = f["choices"][0]["logprobs"]
        assert lp["text_offset"] == [streamed]
        for k, v in lp.items():
            merged[k].extend(v)
        streamed += len(f["choices"][0]["text"])
    merged["text_offset"] = want["text_offset"]
    _same_logprobs(merged, want)
    assert frames[-1]["usage"]["completion_tokens"] == 6
    status, raw = _post(port, {"prompt": PROMPT, "temperature": 0.0,
                               "ignore_eos": True,
                               "max_completion_tokens": 5})
    out = json.loads(raw)
    assert status == 200 and out["usage"]["completion_tokens"] == 5
    assert out["choices"][0]["logprobs"] is None
