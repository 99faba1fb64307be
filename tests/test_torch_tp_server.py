"""The port's tensor-parallel server and rank runtime on the CPU.

- ``python -m production_stack_tpu_torch.engine.server
  --tensor-parallel-size 2 --device cpu`` (its normal ``main``) answers a
  greedy completion with the one-rank engine's text on the same seed, a
  streamed and a seeded sampled one, ``/metrics`` and ``/debug/state``
  (the size, the device group's backend, each rank's device), and a
  SIGTERM stops it and its follower rank: no pid is left.
- Under the chart's multi-host environment (two pods, a rank each), the
  second pod mirrors the first, and exits within the control group's
  timeout once the first hangs (stopped: its keepalives stop, its
  sockets stay open).
- Every kind the runner announces is one the follower loop handles, and
  an unknown kind is fatal.
- ``DistributedConfig.from_env``, the rank grid, the device group's
  backend by placement and the start's refusals.

This module imports no JAX: its primary runs in a spawned process that
imports it.
"""

import http.client
import json
import multiprocessing
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine.config import EngineConfig, check_parallel
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.multihost import (
    UnknownStepKind,
    run_follower,
    start_ranks,
)
from production_stack_tpu_torch.engine.runner import MIRRORED, ModelRunner
from production_stack_tpu_torch.models.registry import get_model_config
from production_stack_tpu_torch.parallel.distributed import (
    DistributedConfig,
    device_backend,
)
from production_stack_tpu_torch.parallel.mesh import MeshConfig, RankGrid

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE = dict(model="tiny-llama-debug", block_size=8, num_kv_blocks=64,
              max_model_len=128, max_num_seqs=4)
TIMEOUT_S = 3.0  # the hung-primary case's group timeout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _children(pid: int) -> list:
    path = pathlib.Path(f"/proc/{pid}/task/{pid}/children")
    return [int(p) for p in path.read_text().split()]


def _gone(pid: int) -> bool:
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return True
    return stat.rsplit(")", 1)[1].split()[0] == "Z"


def _wait(cond, limit: float, what: str) -> None:
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"{what} within {limit}s")


def test_server_serves_at_tp2_and_sigterm_stops_every_rank():
    port = _free_port()
    argv = ["--device", "cpu", "--tensor-parallel-size", "2", "--port",
            str(port), "--host", "127.0.0.1", "--model", "tiny-llama-debug",
            "--block-size", "8", "--num-kv-blocks", "64", "--max-model-len",
            "128", "--max-num-seqs", "4"]
    # The server's main, in a process whose ranks' collectives wait at
    # most 30 s on a peer.
    code = ("import sys; from production_stack_tpu_torch.engine import "
            "multihost, server; multihost.DISTRIBUTED_TIMEOUT_S = 30.0; "
            "server.main(sys.argv[1:])")
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        def up():
            assert proc.poll() is None, proc.stdout.read()
            try:
                return _call(port, "GET", "/health")[0] == 200
            except OSError:
                return False

        _wait(up, 60, "the server answers /health")
        followers = _children(proc.pid)
        assert followers, "no follower rank process"
        body = {"model": "tiny-llama-debug", "prompt": "tensor parallel",
                "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}
        status, raw = _call(port, "POST", "/v1/completions", body)
        assert status == 200, raw
        text = json.loads(raw)["choices"][0]["text"]
        one = LLMEngine(EngineConfig(device="cpu", **ENGINE))
        from production_stack_tpu_torch.engine.sequence import SamplingParams
        want = one.generate(["tensor parallel"], SamplingParams(
            max_tokens=8, temperature=0.0, ignore_eos=True))[0]["text"]
        assert text == want
        status, raw = _call(port, "POST", "/v1/completions",
                            {**body, "stream": True})
        frames = [ln for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        assert status == 200 and frames[-1] == "data: [DONE]"
        assert "".join(json.loads(f[6:])["choices"][0]["text"]
                       for f in frames[:-1]) == want
        sampled = {**body, "temperature": 0.8, "seed": 11}
        a = _call(port, "POST", "/v1/completions", sampled)
        b = _call(port, "POST", "/v1/completions", sampled)
        assert a[0] == 200 and json.loads(a[1])["choices"] == json.loads(
            b[1])["choices"]
        status, raw = _call(port, "GET", "/metrics")
        assert status == 200 and b"pst" in raw
        status, raw = _call(port, "GET", "/debug/state")
        stats = json.loads(raw)["stats"]
        assert stats["tensor_parallel_size"] == 2.0
        assert stats["tp_device_backend"] == "gloo"
        assert stats["tp_rank_devices"] == "0/cpu,0/cpu"
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
    reports = [json.loads(m) for m in re.findall(r"rank report (\{.*\})",
                                                 out)]
    assert sorted(r["rank"] for r in reports) == [0, 1], out[-2000:]
    assert reports[0]["rows_digest"] == reports[1]["rows_digest"]


def _pod(queue, process_id: int, coordinator: str) -> None:
    """Pod ``process_id`` of a two-pod engine under the chart's multi-host
    environment, a rank each: pod 0 builds the engine, reports the pid
    and idles (the test stops it); pod 1 follows and exits with the loop's
    code."""
    os.environ.update(PST_COORDINATOR_ADDRESS=coordinator,
                      PST_NUM_PROCESSES="2", PST_PROCESS_ID=str(process_id))
    multihost.DISTRIBUTED_TIMEOUT_S = TIMEOUT_S
    cfg = EngineConfig(tensor_parallel_size=2, device="cpu", **ENGINE)
    if process_id:
        sys.exit(start_ranks(cfg).follow())
    eng = LLMEngine(cfg)
    assert eng.ranks.pids == [] and eng.ranks.ctx.devices == ["0/cpu",
                                                              "1/cpu"]
    queue.put(os.getpid())
    time.sleep(600)


def test_a_follower_exits_when_its_primary_hangs():
    """Two pods of the chart's multi-host environment: the second mirrors
    the first until the first stops (SIGSTOP: no keepalive comes, its
    sockets stay open), then exits within the control group's timeout
    with the lost-primary code."""
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    coordinator = f"127.0.0.1:{_free_port()}"
    pods = [mp.Process(target=_pod, args=(queue, i, coordinator))
            for i in (0, 1)]
    for p in pods:
        p.start()
    primary, follower = pods
    try:
        assert queue.get(timeout=30) == primary.pid
        time.sleep(1.5 * TIMEOUT_S / 4)  # a keepalive or two go through
        assert follower.is_alive()
        os.kill(primary.pid, signal.SIGSTOP)
        t0 = time.monotonic()
        follower.join(timeout=TIMEOUT_S + 15)
        assert follower.exitcode == 1
        assert time.monotonic() - t0 >= TIMEOUT_S / 4
    finally:
        for p in pods:
            p.kill()
            p.join(timeout=10)
    assert not any(p.is_alive() for p in pods)


class _Bridge:
    def __init__(self, kinds):
        self.kinds = list(kinds)

    def publish(self, obj=None):
        return self.kinds.pop(0)


class _Runner:
    """Records the runner methods a follower calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args))


class _Publisher:
    def __init__(self):
        self.lock = threading.RLock()
        self.announced = []

    def announce(self, kind, payload=None):
        self.announced.append((kind, payload))


def test_every_announced_kind_is_mirrored_and_an_unknown_one_is_fatal():
    # JAX's step kinds and the port's own, each a runner method.
    assert set(MIRRORED) == {
        "step", "step_nofetch", "multi_step", "burst_start", "burst_cont",
        "spec_verify", "encode", "download_page", "upload_page", "drop_kv",
        "restore_kv", "install_adapter", "uninstall_adapter", "forward",
        "report"}
    assert all(callable(getattr(ModelRunner, m)) for m in MIRRORED.values())
    # Rank 0 announces a kind with its arguments; the follower calls the
    # method the map names with them.
    fake = types.SimpleNamespace(publisher=_Publisher())
    with ModelRunner._mirror(fake, "burst_cont", "tables", "kv_lens"):
        pass
    with pytest.raises(KeyError, match="bogus"):  # never announced
        with ModelRunner._mirror(fake, "bogus"):
            pass
    assert fake.publisher.announced == [("burst_cont", ("tables", "kv_lens"))]
    runner = _Runner()
    run_follower(runner, _Bridge([("keepalive", None),
                                  *fake.publisher.announced,
                                  ("download_page", (3,)),
                                  ("shutdown", None)]))
    assert runner.calls == [("_dispatch_burst_continue", ("tables",
                                                          "kv_lens")),
                            ("_gather_page", (3,))]
    with pytest.raises(UnknownStepKind, match="bogus"):
        run_follower(runner, _Bridge([("bogus", ())]))


def test_the_multihost_env_the_grid_and_the_start_refusals(monkeypatch):
    monkeypatch.setenv("PST_COORDINATOR_ADDRESS", "pst-engine-0.svc:1234")
    monkeypatch.setenv("PST_NUM_PROCESSES", "2")
    monkeypatch.setenv("PST_PROCESS_ID", "1")
    d = DistributedConfig.from_env()
    assert d == DistributedConfig("pst-engine-0.svc:1234", 2, 1) and d.enabled
    with pytest.raises(ValueError, match="does not split over 3"):
        start_ranks(EngineConfig(tensor_parallel_size=4, device="cpu"),
                    DistributedConfig(d.coordinator_address, 3, 1))
    with pytest.raises(ValueError, match="num_heads=8 is not divisible"):
        start_ranks(EngineConfig(tensor_parallel_size=3, device="cpu"))
    grid = RankGrid(MeshConfig(tensor_parallel_size=4, data_parallel_size=2))
    assert grid.coords(5) == {"dp": 1, "pp": 0, "sp": 0, "ep": 0, "tp": 1}
    assert grid.group(5, "tp") == [4, 5, 6, 7]
    assert grid.group(5, "dp") == [1, 5]
    assert grid.host_ranks(1, 2) == [4, 5, 6, 7]  # a host's whole tp group
    with pytest.raises(ValueError, match="does not split over 3"):
        grid.host_ranks(0, 3)
    assert device_backend(["0/cuda:0", "0/cuda:1"]) == "nccl"
    assert device_backend(["0/cuda:0", "0/cuda:0"]) == "gloo"
    assert device_backend(["0/cuda:0", "1/cuda:0"]) == "nccl"
    assert device_backend(["0/cpu", "0/cpu"]) == "gloo"
    for axis in ("pipeline", "data"):  # accepted: dp x pp x tp ranks
        assert EngineConfig(**{f"{axis}_parallel_size": 2}).num_ranks == 2
    for axis in ("sequence", "expert"):  # accepted; the model's checks
        cfg = EngineConfig(model="tiny-mixtral-debug",
                           **{f"{axis}_parallel_size": 2})
        assert cfg.num_ranks == 2
        check_parallel(cfg, get_model_config(cfg.model))
    with pytest.raises(ValueError, match="does not compose with pipeline"):
        start_ranks(EngineConfig(sequence_parallel_size=2,
                                 pipeline_parallel_size=2, device="cpu"))
    with pytest.raises(ValueError, match="needs a MoE model"):
        start_ranks(EngineConfig(expert_parallel_size=2, device="cpu"))
    with pytest.raises(ValueError, match=r"num_experts divisible.*model has 4"):
        start_ranks(EngineConfig(model="tiny-mixtral-debug",
                                 expert_parallel_size=3, device="cpu"))
    if not torch.cuda.is_available():  # the card is checked before a spawn
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            start_ranks(EngineConfig(tensor_parallel_size=2),
                        DistributedConfig())
    assert multihost.JOIN_DEADLINE_S <= 30
