"""OpenAI-compatible HTTP server for the PyTorch engine (standard library).

Routes: ``GET /health``, ``GET /ready``, ``GET /v1/models`` and
``POST /v1/completions`` (streamed as server-sent events, or not), with
the JAX package's response
schema, ``logprobs`` included, and its mapping of every sampling field
(``build_sampling``). Bodies are plain JSON dicts. A value the port does
not serve yet (``n`` or ``best_of`` above 1, ``echo``, a ``suffix``, a
list of prompts) gets a 400 that names the field. The other routes of the
JAX server are not ported yet.

    python -m production_stack_tpu_torch.engine.server --model llama-3-8b --port 8011 \
        [--quantization int4] [--warmup lazy|full]

With ``--warmup`` the engine captures its step graphs before it takes
traffic: meanwhile ``/ready`` answers 503 ``"warming"``, ``/health`` 200
``"warming"`` and a completion 503 with ``X-PST-Warming: 1``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..logging_utils import init_logger
from .async_engine import AsyncLLMEngine
from .config import EngineConfig
from .sequence import SamplingParams

logger = init_logger(__name__)


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


def unserved_field(req: dict) -> Optional[str]:
    """The first field of a completion request whose value the port does
    not serve yet, as a 400's message; None when it serves them all."""
    for name in ("n", "best_of"):
        if _opt(req, name, int, 1) > 1:
            return f"{name}={req[name]} is not served yet (only 1)"
    if req.get("echo"):
        return "echo is not served yet"
    if req.get("suffix") is not None:
        return "suffix is not served yet"
    return None


def fmt_completion_logprobs(tok, entries, base_offset: int = 0) -> dict:
    """The OpenAI completions ``logprobs`` object of the JAX server's
    ``_fmt_completion_logprobs`` (no echoed prompt: echo is not served).
    ``base_offset`` anchors ``text_offset`` in the whole completion text
    for streamed chunks."""
    tokens, token_lps, top_lps, offsets = [], [], [], []
    off = base_offset
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


def create_engine_app(
    engine: AsyncLLMEngine, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """An HTTP server bound to ``(host, port)`` (port 0: any free port)
    serving ``engine``; call ``serve_forever()`` on it."""
    model_name = engine.engine.model_name

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route access logs to our logger
            logger.debug("%s %s", self.address_string(), fmt % args)

        def _json(self, status: int, payload: dict,
                  headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, message: str, status: int = 400) -> None:
            self._json(status, {"error": {"message": message,
                                          "type": "invalid_request_error",
                                          "code": status}})

        def do_GET(self) -> None:
            if self.path == "/health":
                if engine.is_healthy():
                    self._json(200, {"status": "warming" if engine.warming
                                     else "ok"})
                else:
                    self._json(503, {"status": "unhealthy",
                                     "error": engine.step_error})
            elif self.path == "/ready":
                # Readiness: 200 only once warmup has finished and the
                # engine takes work (liveness is /health).
                warmup = dict(engine.engine.warmup_summary or {})
                warmup["mode"] = engine.engine.cfg.warmup
                if engine.warmup_error:
                    warmup["error"] = engine.warmup_error
                if engine.ready:
                    self._json(200, {"ready": True, "warmup": warmup})
                else:
                    self._json(503, {"ready": False, "warmup": warmup,
                                     "reason": "warming" if engine.is_healthy()
                                     else "unhealthy"})
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": model_name, "object": "model",
                     "created": int(time.time()),
                     "owned_by": "production-stack-tpu",
                     "root": None, "parent": None}
                ]})
            else:
                self._error(f"no route {self.path}", 404)

        def do_POST(self) -> None:
            if self.path != "/v1/completions":
                self._error(f"no route {self.path}", 404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._error(f"invalid request body: {e}")
                return
            if engine.warming:
                # Accepting would queue the request behind the warmup
                # pass; the marker lets a router fail over.
                self._json(503, {"error": {
                    "message": "engine is warming up (capturing step graphs)",
                    "type": "service_unavailable", "code": 503}},
                    headers={"X-PST-Warming": "1"})
                return
            self._completion(req)

        def _completion(self, req: dict) -> None:
            tok = engine.engine.tokenizer
            prompt = req.get("prompt", "")
            try:
                unserved = unserved_field(req)
                if unserved:
                    raise ValueError(unserved)
                if isinstance(prompt, list) and all(isinstance(x, int) for x in prompt):
                    ids = [int(x) for x in prompt]
                elif isinstance(prompt, str):
                    ids = tok.encode(prompt)
                else:
                    raise ValueError(
                        "prompt must be a string or a list of token ids "
                        "(a list of prompts is not served yet)"
                    )
                max_len = engine.engine.cfg.max_model_len
                if len(ids) >= max_len:
                    raise ValueError(
                        f"prompt has {len(ids)} tokens, exceeds "
                        f"max_model_len={max_len}"
                    )
                sampling = build_sampling(req, max_len, len(ids), tok)
            except (TypeError, ValueError) as e:
                self._error(str(e))
                return
            rid = f"cmpl-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            model = req.get("model", model_name)
            gen = engine.generate(
                prompt_token_ids=ids, sampling=sampling, request_id=rid
            )
            if req.get("stream"):
                usage = bool((req.get("stream_options") or {}).get(
                    "include_usage"))
                self._stream(gen, rid, created, model, len(ids), usage)
                return
            text, n_out, finish, entries = [], 0, None, []
            try:
                for out in gen:
                    text.append(out.text_delta)
                    n_out = out.num_output_tokens
                    finish = out.finish_reason or finish
                    entries.extend(out.logprobs or ())
            except ValueError as e:  # refused on the engine thread
                self._error(str(e))
                return
            except RuntimeError as e:  # the engine failed
                self._error(str(e), 500)
                return
            self._json(200, {
                "id": rid, "object": "text_completion", "created": created,
                "model": model,
                "choices": [{"index": 0, "text": "".join(text),
                             "logprobs": fmt_completion_logprobs(tok, entries)
                             if entries else None,
                             "finish_reason": finish}],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": n_out,
                          "total_tokens": len(ids) + n_out},
            }, headers={"X-Request-Id": rid})

        def _stream(self, gen, rid: str, created: int, model: str,
                    n_prompt: int, usage: bool) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Request-Id", rid)
            self.end_headers()

            def frame(payload) -> None:
                data = payload if isinstance(payload, str) else json.dumps(payload)
                self.wfile.write(f"data: {data}\n\n".encode())
                self.wfile.flush()

            tok = engine.engine.tokenizer
            char_off = 0  # text_offset runs over the whole completion
            try:
                for out in gen:
                    chunk = {"id": rid, "object": "text_completion",
                             "created": created, "model": model,
                             "choices": [{
                                 "index": 0, "text": out.text_delta,
                                 "logprobs": fmt_completion_logprobs(
                                     tok, out.logprobs, char_off)
                                 if out.logprobs else None,
                                 "finish_reason": out.finish_reason}]}
                    char_off += len(out.text_delta)
                    if out.finished and usage:
                        n = out.num_output_tokens
                        chunk["usage"] = {"prompt_tokens": n_prompt,
                                          "completion_tokens": n,
                                          "total_tokens": n_prompt + n}
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
            frame("[DONE]")

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server


def parse_engine_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="production-stack-tpu PyTorch serving engine"
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model", default="llama-3-8b")
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--num-kv-blocks", type=int, default=None)
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-num-batched-tokens", dest="max_prefill_tokens",
                   type=int, default=2048)
    p.add_argument("--num-decode-steps", type=int, default=1)
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
    return p.parse_args(argv)


def engine_config_from_args(args: argparse.Namespace) -> EngineConfig:
    return EngineConfig(
        model=args.model,
        device=args.device,
        max_model_len=args.max_model_len,
        block_size=args.block_size,
        num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs,
        max_prefill_tokens=args.max_prefill_tokens,
        num_decode_steps=args.num_decode_steps,
        quantization=args.quantization,
        kv_cache_dtype=args.kv_cache_dtype,
        seed=args.seed,
        warmup=args.warmup,
        warmup_bucket_budget=args.warmup_bucket_budget,
    )


def main(argv=None) -> None:
    args = parse_engine_args(argv)
    engine = AsyncLLMEngine(engine_config_from_args(args))
    engine.start()
    server = create_engine_app(engine, args.host, args.port)
    logger.info("serving %s on %s:%d (%s)", engine.engine.model_name,
                args.host, server.server_address[1], args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.shutdown()


def serve_in_thread(engine: AsyncLLMEngine, host: str = "127.0.0.1",
                    port: int = 0) -> "tuple[ThreadingHTTPServer, threading.Thread]":
    """Start the engine loop and an HTTP server on a background thread;
    returns (server, thread). Stop with ``server.shutdown()`` and
    ``engine.shutdown()``."""
    if engine._thread is None:
        engine.start()
    server = create_engine_app(engine, host, port)
    t = threading.Thread(target=server.serve_forever, name="http", daemon=True)
    t.start()
    return server, t


if __name__ == "__main__":
    main()
