"""The PyTorch engine's OpenAI server, on the CPU, on an ephemeral port."""

import http.client
import json

import pytest

from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import (
    engine_config_from_args,
    parse_engine_args,
    serve_in_thread,
)

PROMPT = "Paged attention, one block at a time."
BODY = {"prompt": PROMPT, "max_tokens": 10, "temperature": 0.0,
        "ignore_eos": True}


@pytest.fixture(scope="module")
def served():
    cfg = EngineConfig(model="tiny-llama-debug", device="cpu", block_size=8,
                       max_model_len=256, num_kv_blocks=64,
                       max_prefill_tokens=16)
    engine = AsyncLLMEngine(cfg)
    # What the engine's own generate gives, before the step thread starts.
    expected = engine.engine.generate(
        [PROMPT], SamplingParams(max_tokens=10, temperature=0.0,
                                 ignore_eos=True))[0]
    server, thread = serve_in_thread(engine)
    yield server.server_address[1], expected
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body))
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def test_health_and_models(served):
    port, _ = served
    status, raw = _request(port, "GET", "/health")
    assert status == 200 and json.loads(raw) == {"status": "ok"}
    status, raw = _request(port, "GET", "/v1/models")
    assert status == 200
    assert [m["id"] for m in json.loads(raw)["data"]] == ["tiny-llama-debug"]


def test_completion_matches_engine_generate(served):
    port, expected = served
    status, raw = _request(port, "POST", "/v1/completions", BODY)
    assert status == 200
    out = json.loads(raw)
    assert out["object"] == "text_completion"
    choice = out["choices"][0]
    assert choice["text"] == expected["text"]
    assert choice["finish_reason"] == "length"
    # Cost attribution is on by default, as in the JAX server: the usage
    # carries the request's device seconds.
    cost = out["usage"].pop("pst_cost")
    assert set(cost) == {"prefill_device_s", "decode_device_s", "device_s",
                         "kv_page_s", "queue_s"} and cost["device_s"] > 0
    assert out["usage"] == {"prompt_tokens": len(PROMPT.encode()),
                            "completion_tokens": 10,
                            "total_tokens": len(PROMPT.encode()) + 10}


def test_streaming_sends_sse_frames_ending_in_done(served):
    port, expected = served
    status, raw = _request(port, "POST", "/v1/completions",
                           {**BODY, "stream": True})
    assert status == 200
    frames = [ln[len(b"data: "):] for ln in raw.split(b"\n")
              if ln.startswith(b"data: ")]
    assert frames[-1] == b"[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert len(chunks) == 10
    assert "".join(c["choices"][0]["text"] for c in chunks) == expected["text"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert all(c["choices"][0]["finish_reason"] is None for c in chunks[:-1])


def test_bad_requests_are_refused(served):
    port, _ = served
    assert _request(port, "POST", "/v1/completions", b"not json")[0] == 400
    assert _request(port, "POST", "/v1/completions", {"prompt": 3})[0] == 400
    too_long = {"prompt": "x" * 300, "max_tokens": 4}
    assert _request(port, "POST", "/v1/completions", too_long)[0] == 400
    assert _request(port, "GET", "/v1/chat/completions")[0] == 404


def test_main_defaults_to_the_gpu():
    args = parse_engine_args(["--model", "tiny-llama-debug"])
    assert engine_config_from_args(args).device == "cuda"
    assert engine_config_from_args(args).quantization is None
    args = parse_engine_args(["--device", "cpu", "--max-model-len", "128",
                              "--block-size", "8", "--num-kv-blocks", "32",
                              "--max-num-seqs", "4", "--port", "0",
                              "--quantization", "int4"])
    cfg = engine_config_from_args(args)
    assert (cfg.device, cfg.max_model_len, cfg.block_size, cfg.num_kv_blocks,
            cfg.max_num_seqs, cfg.quantization) == ("cpu", 128, 8, 32, 4, "int4")


def test_failed_engine_step_answers_500_and_unhealthy():
    cfg = EngineConfig(model="tiny-llama-debug", device="cpu", block_size=8,
                       max_model_len=64, num_kv_blocks=16)
    engine = AsyncLLMEngine(cfg)

    def boom():
        raise RuntimeError("device lost")

    engine.engine.step = boom
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    try:
        status, raw = _request(port, "POST", "/v1/completions", BODY)
        assert status == 500 and b"device lost" in raw
        assert _request(port, "GET", "/health")[0] == 503
        status, raw = _request(port, "POST", "/v1/completions",
                               {**BODY, "stream": True})
        assert status == 200 and b"engine is failed" in raw
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()
