"""Multi-rank engine execution: rank 0 announces steps, followers mirror.

The port of the JAX package's ``engine/multihost.py``. There, a multi-host
engine is one jitted SPMD program over a mesh that spans hosts, and host 0
publishes each step's description so every process enters the same XLA
computation. The port runs one process a rank (``parallel/distributed.py``)
with the same asymmetry:

- **Rank 0** runs the scheduler, the HTTP server and the KV bookkeeping.
  Immediately before each device call its runner announces the call's
  kind and host-side arguments (:class:`StepPublisher`), and dispatches
  it under the publisher's lock.
- **Ranks 1..N-1** run :func:`run_follower`: receive each announcement
  and make the same dispatch on their shard, so every rank issues the
  same collectives in the same order (a diverged order deadlocks them;
  the groups' timeout turns that into an error).

An engine of ``dp x pp x sp x ep x tp`` ranks (``EngineConfig.num_ranks``)
lays them out by the rank grid (``parallel/mesh.py``): every rank mirrors
every announced call, whatever its coordinates, and takes its own part
of it (its stage's layers, its heads, its ``dp`` rows, its ``sp`` rows of
an encode, its experts).

Only step descriptions cross the control group: token ids, tables and
sampling arrays, a page's bytes on upload, an adapter's matrices.

A rank process lives longer than one engine (:func:`follower_loop`): it
waits for a ``runner`` announcement (the engine's config, and a given
weight tree), builds its runner (:func:`make_follower_runner`), mirrors
it until ``shutdown``, and waits for the next, until ``close``. While
rank 0 is idle its publisher announces a ``keepalive`` every quarter of
the timeout, so a follower whose primary is gone (dead or hung) exits
within the control group's timeout instead of waiting in a dead
collective; a closed connection ends it at once.

Rank 0 starts the ranks of its host itself (:func:`start_ranks`, the
``spawn`` start method); under the chart's multi-host environment
(``PST_*``) each pod starts its own local ranks, and a pod other than
the first runs the follower loop in its main process (:meth:`Ranks.follow`).
"""

from __future__ import annotations

import gc
import json
import logging
import multiprocessing
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..logging_utils import init_logger
from ..models.registry import get_model_config
from ..ops import _build
from ..parallel.distributed import (
    DistributedConfig,
    HostBridge,
    RankContext,
    maybe_init_distributed,
    rank_device,
)
from ..parallel.mesh import MeshConfig, RankGrid
from .config import check_parallel

logger = init_logger(__name__)

# Seconds a rank's collective (a step's all-reduce, the follower's wait
# for the next step) may wait on its peers before it raises; read by
# :func:`start_ranks`, which hands it to every rank it starts.
DISTRIBUTED_TIMEOUT_S = 600.0
# Seconds a rank process gets to leave after ``close`` before it is
# killed.
JOIN_DEADLINE_S = 30.0
# Intra-op threads of a rank on the CPU: a rank waiting in a collective
# spins its threads, and threads that spin beside another rank's compute
# on the same cores slow both (a tiny two-rank engine ran 15x slower at 8
# threads a rank than at 1 on 8 cores).
CPU_RANK_THREADS = 1


class UnknownStepKind(Exception):
    """An announcement no follower handles: the ranks' orders may have
    diverged, so the follower stops (never a ``RuntimeError``, which
    :func:`follower_loop` reads as a lost primary)."""


class StepPublisher:
    """Rank-0 hook that mirrors every runner device call to the followers.

    Installed on the runner as ``runner.publisher``; the runner calls
    :meth:`announce` immediately before each dispatch, under :attr:`lock`,
    which it holds until the dispatch is queued. With ``keepalive_s`` a
    thread announces ``keepalive`` whenever nothing was announced for
    that long."""

    def __init__(self, bridge: HostBridge, keepalive_s: Optional[float] = None):
        self.bridge = bridge
        self.lock = threading.RLock()
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if keepalive_s:
            self._thread = threading.Thread(
                target=self._keepalive, args=(keepalive_s,),
                name="pst-rank-keepalive", daemon=True)
            self._thread.start()

    def announce(self, kind: str, payload: Any = None) -> None:
        with self.lock:
            self.bridge.publish((kind, payload))
            self._last = time.monotonic()

    def shutdown(self) -> None:
        """End the followers' mirror of the current runner."""
        try:
            self.announce("shutdown")
        except RuntimeError as e:  # a follower already gone
            logger.warning("follower shutdown broadcast failed: %s", e)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=JOIN_DEADLINE_S)

    def _keepalive(self, interval: float) -> None:
        while not self._stop.wait(interval / 4):
            with self.lock:
                if self._stop.is_set():
                    return
                if time.monotonic() - self._last < interval:
                    continue
                try:
                    self.announce("keepalive")
                except RuntimeError:
                    logger.error("keepalive broadcast failed (a follower "
                                 "lost?)", exc_info=True)
                    return


def run_follower(runner, bridge: HostBridge) -> None:
    """Mirror rank 0's device calls on ``runner`` until ``shutdown``.

    ``runner`` must be built as rank 0's (the same config and weights,
    this rank's shard), which :func:`make_follower_runner` does. Each
    kind calls the runner method ``runner.MIRRORED`` names for it, the
    one rank 0 called, with its arguments; the results are discarded (a
    pipelined burst's carry stays in the runner, as on rank 0). An
    unknown kind is fatal."""
    from .runner import MIRRORED

    while True:
        kind, args = bridge.publish(None)
        if kind == "shutdown":
            return
        if kind == "keepalive":
            continue
        if kind not in MIRRORED:  # the order contract: fatal
            raise UnknownStepKind(kind)
        getattr(runner, MIRRORED[kind])(*args)


def make_follower_runner(cfg, ctx: RankContext, model_cfg=None,
                         params: Optional[Dict[str, Any]] = None):
    """Build a follower's runner as rank 0 builds its own (no scheduler,
    no server): ``params`` is the whole tree rank 0 was given, or None
    for the seed or the checkpoint directory."""
    from .runner import ModelRunner

    if cfg.compile_cache_dir:
        _build.set_compile_cache_dir(cfg.compile_cache_dir)
    return ModelRunner(cfg, model_cfg, params, ranks=ctx)


def follower_loop(ctx: RankContext) -> int:
    """A follower rank's life: build each runner rank 0 announces, mirror
    it until ``shutdown`` (then log this rank's report), until ``close``.
    Returns 0 on ``close``, 1 when the primary is lost (a collective
    raised: the connection closed, or nothing came within the timeout)."""
    bridge = HostBridge(ctx)
    while True:
        try:
            kind, payload = bridge.publish(None)
            if kind == "close":
                return 0
            if kind == "keepalive":
                continue
            if kind != "runner":
                raise UnknownStepKind(kind)
            runner = make_follower_runner(ctx=ctx, **payload)
            run_follower(runner, bridge)
        except RuntimeError:
            logger.error("rank %d: primary lost, exiting", ctx.rank,
                         exc_info=True)
            return 1
        logger.info("rank report %s", json.dumps(runner.rank_report()))
        del runner
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def _rank_process(rank: int, world: int, local_rank: int, init_method: str,
                  device_type: str, timeout_s: float, node: int,
                  mesh: MeshConfig) -> None:
    """A spawned follower rank's entry point."""
    if device_type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    ctx = maybe_init_distributed(world, rank, local_rank, init_method,
                                 device_type, timeout_s, node, mesh)
    code = follower_loop(ctx)
    if code == 0:
        ctx.close()
        return
    # The groups' peers are gone: leave without their teardown.
    logging.shutdown()
    os._exit(code)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """One host's ranks, seen from its first process: its
    rank context, the rank processes it started and, on rank 0, the
    publisher that announces device calls."""

    def __init__(self, ctx: RankContext, procs: List[Any],
                 threads: Optional[int] = None):
        self.ctx = ctx
        self.procs = procs
        self._threads = threads  # this process's own, restored on close
        self.bridge = HostBridge(ctx)
        self.publisher = (StepPublisher(self.bridge,
                                        keepalive_s=ctx.timeout_s / 4)
                          if ctx.is_primary else None)
        self._closed = False

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def build_runner(self, cfg, model_cfg=None,
                     params: Optional[Dict[str, Any]] = None):
        """Rank 0's runner: announced (with the whole ``params`` on the
        CPU, when given) and built beside every follower's."""
        from .runner import ModelRunner, _to_device

        if params is not None:
            params = _to_device(params, torch.device("cpu"))
        with self.publisher.lock:
            self.publisher.announce("runner", {
                "cfg": cfg, "model_cfg": model_cfg, "params": params})
            return ModelRunner(cfg, model_cfg, params, ranks=self.ctx,
                               publisher=self.publisher)

    def follow(self) -> int:
        """A first process that is not rank 0 (a multi-host pod): run the
        follower loop here, then stop this host's other ranks."""
        code = follower_loop(self.ctx)
        self._join()
        if code == 0:
            self.ctx.close()
        self._closed = True
        return code

    def close(self) -> None:
        """Rank 0: end every rank process (``close``), join them within
        ``JOIN_DEADLINE_S`` and kill what is left, then leave the groups.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self.publisher.announce("close")
        except RuntimeError as e:
            logger.warning("rank close broadcast failed: %s", e)
        self.publisher.close()
        self._join()
        self.ctx.close()
        if self._threads is not None:
            torch.set_num_threads(self._threads)

    def _join(self) -> None:
        deadline = time.monotonic() + JOIN_DEADLINE_S
        for p in self.procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        for p in self.procs:
            if p.is_alive():
                logger.warning("rank process %d did not exit: killed", p.pid)
                p.kill()
                p.join(timeout=5)


def mesh_config(cfg) -> MeshConfig:
    """The engine's rank layout: its five parallel sizes."""
    return MeshConfig(data_parallel_size=cfg.data_parallel_size,
                      pipeline_parallel_size=cfg.pipeline_parallel_size,
                      sequence_parallel_size=cfg.sequence_parallel_size,
                      expert_parallel_size=cfg.expert_parallel_size,
                      tensor_parallel_size=cfg.tensor_parallel_size)


def start_ranks(cfg, dist_cfg: Optional[DistributedConfig] = None) -> Ranks:
    """Start this host's ranks of a ``dp x pp x sp x ep x tp`` engine
    (``cfg.num_ranks``) and join them: the first process of the host
    (this one) is its first rank, the others are spawned. On one host rank
    0 serves the rendezvous on a free local port; under the multi-host
    environment (``PST_*``) each of ``num_processes`` pods holds
    ``num_ranks / num_processes`` ranks, the ``process_id``-th contiguous
    block of the rank grid (``RankGrid.host_ranks``: global rank
    ``process_id * local + local_rank``, so a host keeps whole ``tp``
    groups, then whole stages), and the rendezvous is the coordinator
    address."""
    dist_cfg = dist_cfg or DistributedConfig.from_env()
    world = cfg.num_ranks
    if world < 2:
        raise ValueError("start_ranks needs more than one rank (a "
                         "parallel size above 1)")
    check_parallel(cfg, get_model_config(cfg.model))  # before any process
    mesh = mesh_config(cfg)
    grid = RankGrid(mesh)
    host = grid.host_ranks(dist_cfg.process_id, dist_cfg.num_processes)
    base, local = host[0], len(host)
    device_type = torch.device(cfg.device).type
    rank_device(device_type, 0)  # no card: raise before any process starts
    if dist_cfg.enabled:
        if not dist_cfg.coordinator_address:
            raise ValueError("PST_NUM_PROCESSES > 1 needs "
                             "PST_COORDINATOR_ADDRESS")
        init_method = f"tcp://{dist_cfg.coordinator_address}"
    else:
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    timeout = DISTRIBUTED_TIMEOUT_S
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_rank_process, daemon=True,
                        name=f"pst-rank-{host[i]}",
                        args=(host[i], world, i, init_method, device_type,
                              timeout, dist_cfg.process_id, mesh))
             for i in range(1, local)]
    for p in procs:
        p.start()
    threads = None
    if device_type == "cpu":
        threads = torch.get_num_threads()
        torch.set_num_threads(CPU_RANK_THREADS)
    try:
        ctx = maybe_init_distributed(world, base, 0, init_method,
                                     device_type, timeout,
                                     dist_cfg.process_id, mesh)
    except BaseException:
        for p in procs:
            p.kill()
        if threads is not None:
            torch.set_num_threads(threads)
        raise
    logger.info("ranks: dp %d x pp %d x sp %d x ep %d x tp %d = %d (%d on "
                "this host, pids %s), device groups %s",
                *mesh.sizes(), world, local, [p.pid for p in procs],
                ctx.backends)
    return Ranks(ctx, procs, threads)
