"""Cache controller: the fleet-wide KV location index, on ``http.server``.

The JAX package's ``kvserver/controller.py``: engines report the chunk
hashes their caches hold; the router asks which engine holds the longest
prefix of a prompt's chunk hashes.

Endpoints:
  POST /register    {"url", "model", "hashes": [...], "replace": bool}
  POST /deregister  {"url"}
  POST /lookup      {"model", "hashes": [...]} (or {"model", "text"}) ->
                    {"matches": {url: matched_token_count}}
  GET  /instances   {model: {url: hash count}}
  GET  /health

Matching walks the prompt's chunk-hash chain in order and counts the
consecutive chunks each engine holds: a chunk hash commits to its whole
prefix (``kvcache/hashing.py``). An engine not heard from for
``instance_ttl`` seconds is dropped (on every lookup and listing, and by
a sweep every ``instance_ttl / 2``).

    python -m production_stack_tpu_torch.kvserver.controller --port 9000
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Set, Tuple

from ..kvcache.hashing import CHUNK_TOKENS
from ..logging_utils import init_logger

logger = init_logger(__name__)


class ControllerState:
    def __init__(self, instance_ttl: float = 120.0):
        # model -> url -> chunk hashes
        self.instances: Dict[str, Dict[str, Set[int]]] = {}
        self.last_seen: Dict[str, float] = {}
        self.instance_ttl = instance_ttl

    def register(self, url: str, model: str, hashes, replace: bool) -> None:
        per_model = self.instances.setdefault(model, {})
        if replace or url not in per_model:
            per_model[url] = set()
        per_model[url].update(int(h) for h in hashes)
        self.last_seen[url] = time.time()

    def deregister(self, url: str) -> None:
        for per_model in self.instances.values():
            per_model.pop(url, None)
        self.last_seen.pop(url, None)

    def expire(self) -> None:
        cutoff = time.time() - self.instance_ttl
        for u in [u for u, t in self.last_seen.items() if t < cutoff]:
            self.deregister(u)

    def lookup(self, model: str, hashes) -> Dict[str, int]:
        self.expire()
        matches: Dict[str, int] = {}
        for url, have in (self.instances.get(model) or {}).items():
            n = 0
            for h in hashes:
                if int(h) not in have:
                    break
                n += 1
            if n:
                matches[url] = n * CHUNK_TOKENS
        return matches

    def listing(self) -> dict:
        self.expire()
        return {model: {url: len(h) for url, h in per_model.items()}
                for model, per_model in self.instances.items()}


class ControllerServer(ThreadingHTTPServer):
    """The controller; ``serve_forever()`` serves it and a daemon thread
    expires silent engines. ``state`` is guarded by ``lock``."""

    daemon_threads = True

    def __init__(self, address: Tuple[str, int], instance_ttl: float = 120.0):
        self.state = ControllerState(instance_ttl)
        self.lock = threading.Lock()
        self._stop = threading.Event()
        super().__init__(address, _Handler)
        threading.Thread(target=self._expire_loop, name="kv-controller-expiry",
                         daemon=True).start()

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def _expire_loop(self) -> None:
        interval = max(1.0, self.state.instance_ttl / 2)
        while not self._stop.wait(interval):
            with self.lock:
                self.state.expire()

    def server_close(self) -> None:
        self._stop.set()
        super().server_close()


class _Handler(BaseHTTPRequestHandler):
    server: ControllerServer

    def log_message(self, fmt, *args):
        logger.debug("%s %s", self.address_string(), fmt % args)

    def _json(self, status: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        if not isinstance(body, dict):
            raise ValueError("body must be an object")
        return body

    def do_GET(self) -> None:
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/instances":
            with self.server.lock:
                self._json(200, self.server.state.listing())
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self) -> None:
        handler = {"/register": self._register,
                   "/deregister": self._deregister,
                   "/lookup": self._lookup}.get(self.path)
        if handler is None:
            self._json(404, {"error": "not found"})
            return
        try:
            body = self._body()
            with self.server.lock:
                payload = handler(body)
        except (KeyError, TypeError, ValueError) as e:
            self._json(400, {"error": f"invalid body: {e}"})
            return
        self._json(200, payload)

    def _register(self, body: dict) -> dict:
        self.server.state.register(body["url"], body.get("model", ""),
                                   body.get("hashes", []),
                                   bool(body.get("replace", False)))
        return {"status": "ok"}

    def _deregister(self, body: dict) -> dict:
        self.server.state.deregister(body["url"])
        return {"status": "ok"}

    def _lookup(self, body: dict) -> dict:
        hashes = body.get("hashes")
        if not hashes and body.get("text"):
            # Gateway pickers hold text: byte-tokenize (the fleet's
            # fallback tokenizer) and chunk-hash here.
            from ..engine.tokenizer import ByteTokenizer
            from ..kvcache.hashing import chunk_hashes

            hashes = chunk_hashes(ByteTokenizer().encode(body["text"]))
        return {"matches": self.server.state.lookup(body.get("model", ""),
                                                    hashes or [])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="production-stack-tpu KV cache controller (PyTorch port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--instance-ttl", type=float, default=120.0)
    args = p.parse_args(argv)
    server = ControllerServer((args.host, args.port), args.instance_ttl)
    logger.info("cache controller on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
