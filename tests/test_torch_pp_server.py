"""The port's server over a dp2 x pp2 grid on the CPU, through its
``main``: ``python -m production_stack_tpu_torch.engine.server
--pipeline-parallel-size 2 --data-parallel-size 2 --device cpu`` answers
a greedy completion with the one-rank engine's text on the same seed, a
streamed one, a batch of prompts (split over the replicas) and a seeded
sampled one twice alike; ``/debug/state`` lists each rank's coordinates
and device; a SIGTERM stops it and its three follower ranks, whose
reports agree (rows digests, KV blocks, each stage's layer count).

This module imports no JAX: its primary runs in a subprocess.
"""

import json
import re
import signal
import subprocess
import sys

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams

from .test_torch_tp_server import (
    ENGINE,
    ROOT,
    _call,
    _children,
    _free_port,
    _gone,
    _wait,
)


def test_server_serves_a_dp2_pp2_grid_and_sigterm_stops_every_rank():
    port = _free_port()
    argv = ["--device", "cpu", "--pipeline-parallel-size", "2",
            "--data-parallel-size", "2", "--port", str(port), "--host",
            "127.0.0.1", "--model", "tiny-llama-debug", "--block-size", "8",
            "--num-kv-blocks", "64", "--max-model-len", "128",
            "--max-num-seqs", "4"]
    code = ("import sys; from production_stack_tpu_torch.engine import "
            "multihost, server; multihost.DISTRIBUTED_TIMEOUT_S = 30.0; "
            "server.main(sys.argv[1:])")
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    followers = []
    try:
        def up():
            assert proc.poll() is None, proc.stdout.read()
            try:
                return _call(port, "GET", "/health")[0] == 200
            except OSError:
                return False

        _wait(up, 60, "the server answers /health")
        followers = _children(proc.pid)
        assert len(followers) >= 3, followers  # and the spawn tracker
        one = LLMEngine(EngineConfig(device="cpu", **ENGINE))
        greedy = SamplingParams(max_tokens=8, temperature=0.0,
                                ignore_eos=True)
        prompts = ["pipeline stages", "data replicas", "a third", "fourth"]
        want = [o["text"] for o in one.generate(prompts, greedy)]
        body = {"model": "tiny-llama-debug", "prompt": prompts[0],
                "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}
        status, raw = _call(port, "POST", "/v1/completions", body)
        assert status == 200, raw
        assert json.loads(raw)["choices"][0]["text"] == want[0]
        status, raw = _call(port, "POST", "/v1/completions",
                            {**body, "prompt": prompts})
        assert status == 200, raw
        assert [c["text"] for c in sorted(json.loads(raw)["choices"],
                                          key=lambda c: c["index"])] == want
        status, raw = _call(port, "POST", "/v1/completions",
                            {**body, "stream": True})
        frames = [ln for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        assert status == 200 and frames[-1] == "data: [DONE]"
        assert "".join(json.loads(f[6:])["choices"][0]["text"]
                       for f in frames[:-1]) == want[0]
        sampled = {**body, "temperature": 0.8, "seed": 11}
        a = _call(port, "POST", "/v1/completions", sampled)
        b = _call(port, "POST", "/v1/completions", sampled)
        assert a[0] == 200 and json.loads(a[1])["choices"] == json.loads(
            b[1])["choices"]
        status, raw = _call(port, "GET", "/debug/state")
        state = json.loads(raw)
        assert [(r["rank"], r["dp"], r["pp"], r["tp"], r["device"])
                for r in state["ranks"]] == [
            (0, 0, 0, 0, "0/cpu"), (1, 0, 1, 0, "0/cpu"),
            (2, 1, 0, 0, "0/cpu"), (3, 1, 1, 0, "0/cpu")]
        assert state["stats"]["pipeline_parallel_size"] == 2.0
        assert state["stats"]["data_parallel_size"] == 2.0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=45)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode is not None
    for pid in followers:
        _wait(lambda: _gone(pid), 10, f"follower {pid} exits")
    reports = sorted((json.loads(m) for m in re.findall(
        r"rank report (\{.*\})", out)), key=lambda r: r["rank"])
    assert [r["rank"] for r in reports] == [0, 1, 2, 3], out[-2000:]
    assert len({r["rows_digest"] for r in reports}) == 1
    assert len({r["num_blocks"] for r in reports}) == 1
    assert [r["layers"] for r in reports] == [1, 1, 1, 1]
