"""Consistent-hash ring shared by the sharded KV client and its tests.

A copy of the JAX package's ``hashring.py``, trimmed to the placement the
sharded remote-KV client reads (``update``, ``get_node``, ``get_nodes``),
over this package's xxh64: for the same node URLs every process, the JAX
router and kvservers included, computes the same (key -> owner set).
Virtual nodes are hashed as ``f"{node}#{v}"`` and keys as given, with
the unmasked 64-bit digest.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from .kvcache.xxh64 import xxh64


def _hash(key: str) -> int:
    return xxh64(key.encode())


class ConsistentHashRing:
    """xxh64 ring with virtual nodes; minimal remapping on membership
    change."""

    def __init__(self, vnodes: int = 160):
        self.vnodes = vnodes
        self._nodes: set = set()
        self._ring: List[Tuple[int, str]] = []
        self._hashes: List[int] = []

    def _rebuild(self) -> None:
        ring = sorted((_hash(f"{node}#{v}"), node)
                      for node in self._nodes for v in range(self.vnodes))
        self._ring = ring
        self._hashes = [h for h, _ in ring]

    def update(self, nodes: Sequence[str]) -> None:
        new = set(nodes)
        if new != self._nodes:
            self._nodes = new
            self._rebuild()

    def get_node(self, key: str) -> Optional[str]:
        if not self._ring:
            return None
        idx = bisect.bisect(self._hashes, _hash(key)) % len(self._ring)
        return self._ring[idx][1]

    def get_nodes(self, key: str, n: int) -> List[str]:
        """The first ``n`` DISTINCT nodes clockwise from ``key``'s ring
        position: the replica owner set for replication factor ``n``
        (``get_nodes(key, 1)[0] == get_node(key)``)."""
        if not self._ring or n <= 0:
            return []
        start = bisect.bisect(self._hashes, _hash(key)) % len(self._ring)
        owners: List[str] = []
        seen: set = set()
        for i in range(len(self._ring)):
            node = self._ring[(start + i) % len(self._ring)][1]
            if node in seen:
                continue
            seen.add(node)
            owners.append(node)
            if len(owners) >= n or len(seen) == len(self._nodes):
                break
        return owners
