"""The rank runtime: process groups, host-0 serving, the control bridge.

The port of the JAX package's ``parallel/distributed.py``. There, every
host runs one SPMD program under ``jax.distributed`` and XLA moves the
tensors; the only extra machinery is a control plane that ships each
step's description from host 0 to the others. The port runs one process
a rank and moves the tensors itself, so each rank holds two process
groups (:func:`maybe_init_distributed`):

- the **control group** (the default group, gloo over CPU tensors): the
  step descriptions (:class:`HostBridge`), the page gathers, barriers and
  the KV block count's agreement;
- the **device groups**, one a parallel axis in use (``tp``, ``pp``,
  ``dp``, ``sp``, ``ep``; :class:`~..parallel.mesh.RankGrid` lays the
  ranks out): the activations' all-reduces over ``tp``, the stage
  hand-off over ``pp``, the replicas' row and KV exchange over ``dp``,
  the ring encode's K/V rotation and pooled sums over ``sp`` and the
  experts' combine over ``ep``. Each group's
  backend is NCCL when each of its members has a card of its own, gloo
  when members share one card (NCCL refuses two ranks on one device) or
  run on the CPU. The choice follows from the rank -> device map every
  rank gathers, is logged, and is kept in :class:`RankContext`
  (``backends``); it is never a fallback. Every rank creates every group,
  in the grid's order, as ``torch.distributed.new_group`` requires, even
  the groups it is not in.

Every group gets the bounded ``timeout_s``: a collective whose peer is
gone raises within it instead of waiting for ever.

Rank 0 (``RankContext.is_primary``) binds the HTTP server and runs the
scheduler; the others run the follower loop (``engine/multihost.py``). A
rank's device is ``cuda:(local_rank % torch.cuda.device_count())`` on the
GPU (:func:`rank_device`).

The chart's multi-host template sets ``PST_COORDINATOR_ADDRESS``,
``PST_NUM_PROCESSES`` and ``PST_PROCESS_ID`` (one process a pod):
:class:`DistributedConfig` reads them. Each pod starts its own local
ranks; the rendezvous is the coordinator address.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..logging_utils import init_logger
from .mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    MeshConfig,
    RankGrid,
)

logger = init_logger(__name__)

# The axes that may exceed 1, each with a device group of its own, in
# the order every rank creates the groups.
DEVICE_AXES = (AXIS_TENSOR, AXIS_PIPELINE, AXIS_DATA, AXIS_SEQUENCE,
               AXIS_EXPERT)

# Env surface (set by the Helm multi-host template / JobSet downward API).
ENV_COORDINATOR = "PST_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "PST_NUM_PROCESSES"
ENV_PROCESS_ID = "PST_PROCESS_ID"


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """The pod's place in a multi-host engine (one process a pod)."""

    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        return cls(
            coordinator_address=os.environ.get(ENV_COORDINATOR),
            num_processes=int(os.environ.get(ENV_NUM_PROCESSES, "1")),
            process_id=int(os.environ.get(ENV_PROCESS_ID, "0")),
        )

    @property
    def enabled(self) -> bool:
        return self.num_processes > 1


@dataclasses.dataclass
class RankContext:
    """One rank's place and groups."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    control: Any  # the default group: gloo, CPU tensors
    backend: str  # every rank's devices': "nccl" or "gloo"
    devices: List[str]  # every rank's "node/device", by rank
    timeout_s: float
    grid: RankGrid
    # This rank's device group on each axis above 1 (None: a group of
    # one), and the backend of each.
    groups: Dict[str, Any]
    backends: Dict[str, str]

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        return self.grid.coords(self.rank)

    def group(self, axis: str) -> Any:
        """This rank's device group on ``axis``; None where it has one
        member."""
        return self.groups.get(axis)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may hold this rank's collectives: NCCL's
        run on the stream; gloo's wait on the host."""
        return all(b == "nccl" for b in self.backends.values())

    def ranks_on_device(self) -> int:
        """Ranks that share this rank's card (its KV budget's divisor)."""
        return self.devices.count(self.devices[self.rank])

    def close(self) -> None:
        """Destroy both groups (each rank, after its last collective)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:(local_rank % device_count)``, or the CPU.
    Asking for CUDA without a card raises."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a rank runs on 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "device 'cuda' requested but no CUDA GPU is available (pass "
            "device='cpu' to run on the CPU)")
    return torch.device("cuda", local_rank % n)


def device_backend(devices: List[str]) -> str:
    """The device group's backend for the rank -> ``node/device`` map:
    NCCL when every rank has a card of its own, else gloo (ranks on the
    CPU, or sharing a card)."""
    on_gpu = all("/cuda" in d for d in devices)
    return "nccl" if on_gpu and len(set(devices)) == len(devices) else "gloo"


def maybe_init_distributed(world_size: int, rank: int, local_rank: int,
                           init_method: str, device_type: str = "cuda",
                           timeout_s: float = 600.0, node: int = 0,
                           mesh: Optional[MeshConfig] = None
                           ) -> Optional[RankContext]:
    """Join rank ``rank`` of ``world_size`` at ``init_method`` (a
    ``tcp://host:port`` rendezvous that rank 0 serves) and create the
    control group and every device group of the ``mesh`` layout (default:
    all ranks on ``tp``) with ``timeout_s``. None for a world of one:
    nothing to join. ``node`` tells ranks of different hosts apart in the
    device map."""
    if world_size <= 1:
        return None
    grid = RankGrid(mesh or MeshConfig(tensor_parallel_size=world_size))
    if grid.world_size != world_size:
        raise ValueError(f"a grid of {grid.world_size} ranks for a world of "
                         f"{world_size}")
    device = rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    devices: List[Optional[str]] = [None] * world_size
    dist.all_gather_object(devices, f"{node}/{device}")
    groups: Dict[str, Any] = {}
    backends: Dict[str, str] = {}
    for axis in DEVICE_AXES:
        for members in grid.groups(axis):
            if len(members) == 1:
                break  # the axis is 1: no group
            backend = device_backend([devices[m] for m in members])
            group = dist.new_group(members, backend=backend, timeout=timeout)
            if rank in members:
                groups[axis], backends[axis] = group, backend
    ctx = RankContext(rank=rank, world_size=world_size,
                      local_rank=local_rank, device=device,
                      control=dist.group.WORLD,
                      backend=device_backend(devices), devices=list(devices),
                      timeout_s=timeout_s, grid=grid, groups=groups,
                      backends=backends)
    logger.info("rank %d/%d %s on %s: control group gloo, device groups %s "
                "(ranks on %s), timeout %.0fs", rank, world_size,
                ctx.coords, device, backends, devices, timeout_s)
    return ctx


class HostBridge:
    """Rank 0 -> every rank control broadcast for per-step batch metadata,
    over the control group: rank 0's object is pickled and broadcast
    (``broadcast_object_list``), the others unpickle it. Every rank issues
    the same bridge calls in the same order."""

    def __init__(self, ctx: RankContext):
        self.ctx = ctx

    def publish(self, obj: Any = None) -> Any:
        """On rank 0: broadcast ``obj`` and return it; on the others:
        receive it."""
        box = [obj if self.ctx.is_primary else None]
        dist.broadcast_object_list(box, src=0, group=self.ctx.control)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.ctx.control)

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj``, by rank, on rank 0 (None elsewhere)."""
        out = [None] * self.ctx.world_size if self.ctx.is_primary else None
        dist.gather_object(obj, out, dst=0, group=self.ctx.control)
        return out

    def gather_tensor(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's CPU tensor ``t`` (one shape and type on every
        rank), by rank, on rank 0 (None elsewhere): as its bytes, which
        gloo moves whatever the element type."""
        raw = t.contiguous().view(torch.uint8)
        out = ([torch.empty_like(raw) for _ in range(self.ctx.world_size)]
               if self.ctx.is_primary else None)
        dist.gather(raw, out, dst=0, group=self.ctx.control)
        if out is None:
            return None
        return [o.view(t.dtype).view(t.shape) for o in out]

    def all_min(self, n: int) -> int:
        """The least of every rank's ``n``."""
        t = torch.tensor([n], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.ctx.control)
        return int(t.item())
