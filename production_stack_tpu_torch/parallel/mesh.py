"""The parallel axes of a multi-GPU engine (the JAX ``parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over its devices, its
axes in the order ``dp, pp, sp, ep, tp`` (outer to inner, so that the
tensor-parallel collectives stay between neighbouring devices). The port
runs one process a rank, so in place of the mesh a :class:`RankGrid`
lays the global ranks out in the same order and gives each rank its
coordinate on each axis: the ``tp`` group of a rank is the ranks that
differ from it only on ``tp``, which are contiguous.

``dp``, ``pp`` and ``tp`` may exceed 1 (``dp x pp x tp`` ranks, one
process each); ``sp`` and ``ep`` are refused above 1 at start
(``engine/config.py``; ROADMAP.md queue 1, items 15.iii and 15.iv).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

AXIS_DATA = "dp"
AXIS_PIPELINE = "pp"
AXIS_TENSOR = "tp"
AXIS_SEQUENCE = "sp"
AXIS_EXPERT = "ep"

# Outer -> inner, the JAX package's order.
MESH_AXIS_ORDER = (AXIS_DATA, AXIS_PIPELINE, AXIS_SEQUENCE, AXIS_EXPERT,
                   AXIS_TENSOR)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees; ``total()`` ranks in all."""

    data_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    sequence_parallel_size: int = 1
    expert_parallel_size: int = 1
    tensor_parallel_size: int = 1

    def total(self) -> int:
        return math.prod(self.sizes())

    def sizes(self) -> List[int]:
        """The sizes in ``MESH_AXIS_ORDER``."""
        return [
            self.data_parallel_size,
            self.pipeline_parallel_size,
            self.sequence_parallel_size,
            self.expert_parallel_size,
            self.tensor_parallel_size,
        ]


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """The global ranks ``0 .. total()-1`` laid out over the axes in
    ``MESH_AXIS_ORDER``, row-major (``tp`` fastest): the port's
    counterpart of the JAX ``build_mesh`` device grid."""

    config: MeshConfig

    @property
    def world_size(self) -> int:
        return self.config.total()

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on each axis."""
        if not 0 <= rank < self.world_size:
            raise ValueError(f"rank {rank} outside a grid of "
                             f"{self.world_size}")
        out: Dict[str, int] = {}
        for axis, size in zip(reversed(MESH_AXIS_ORDER),
                              reversed(self.config.sizes())):
            rank, out[axis] = divmod(rank, size)
        return {axis: out[axis] for axis in MESH_AXIS_ORDER}

    def rank(self, **coords: int) -> int:
        """The global rank at ``coords`` (an axis left out is at 0): the
        inverse of :meth:`coords`."""
        out = 0
        for axis, size in zip(MESH_AXIS_ORDER, self.config.sizes()):
            c = coords.get(axis, 0)
            if not 0 <= c < size:
                raise ValueError(f"{axis}={c} outside an axis of {size}")
            out = out * size + c
        return out

    def groups(self, axis: str) -> List[List[int]]:
        """Every group along ``axis``, each in order along it, the groups
        by their first rank: the order in which every rank creates them."""
        seen: Dict[int, List[int]] = {}
        for r in range(self.world_size):
            g = self.group(r, axis)
            seen.setdefault(g[0], g)
        return [seen[k] for k in sorted(seen)]

    def group(self, rank: int, axis: str) -> List[int]:
        """The ranks that share every coordinate of ``rank`` but
        ``axis``'s, in order along ``axis``."""
        c = self.coords(rank)
        return [r for r in range(self.world_size)
                if all(v == c[a] for a, v in self.coords(r).items()
                       if a != axis)]

    def host_ranks(self, process_id: int, num_processes: int) -> List[int]:
        """The global ranks host ``process_id`` of ``num_processes``
        holds: the ``process_id``-th of equal contiguous blocks, so the
        inner axes (``tp`` first) stay within a host where they fit."""
        if self.world_size % num_processes:
            raise ValueError(f"a grid of {self.world_size} ranks does not "
                             f"split over {num_processes} processes")
        local = self.world_size // num_processes
        return list(range(process_id * local, (process_id + 1) * local))
