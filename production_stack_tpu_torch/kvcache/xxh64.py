"""xxHash64 (XXH64) in the standard library and numpy.

The block and chunk hashes leave the engine (the kvserver keys pages by
them, the cache controller and the router's KV-aware lookup compare
them), so they must equal the JAX package's ``xxhash.xxh64`` digests bit
for bit; the card's machine has no ``xxhash``.

:func:`xxh64` is the plain algorithm over any bytes. :func:`chained_xxh64`
hashes many equal-length token blocks, each message being the block's
int64 tokens followed by an 8-byte parent hash that chains the blocks:
the 32-byte stripes of the body do not depend on the chain, so they run
for every block at once as one ``uint64`` numpy pass (numpy's ``uint64``
products wrap modulo 2**64, as XXH64 needs), and only the parent lane and
the final avalanche run per block, in Python.
"""

from __future__ import annotations

from typing import List

import numpy as np

M64 = (1 << 64) - 1
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5

_U = np.uint64
_NP1, _NP2, _NP4 = _U(P1), _U(P2), _U(P4)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & M64
    return (_rotl(acc, 31) * P1) & M64


def _merge(h: int, v: int) -> int:
    return ((h ^ _round(0, v)) * P1 + P4) & M64


def _converge(v1: int, v2: int, v3: int, v4: int) -> int:
    h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & M64
    for v in (v1, v2, v3, v4):
        h = _merge(h, v)
    return h


def _lane8(h: int, lane: int) -> int:
    return (_rotl(h ^ _round(0, lane), 27) * P1 + P4) & M64


def _avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * P2) & M64
    h ^= h >> 29
    h = (h * P3) & M64
    return h ^ (h >> 32)


def _init(seed: int) -> List[int]:
    return [(seed + P1 + P2) & M64, (seed + P2) & M64, seed & M64,
            (seed - P1) & M64]


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (``xxhash.xxh64_intdigest``)."""
    n = len(data)
    i = 0
    if n >= 32:
        v = _init(seed)
        while i + 32 <= n:
            for j in range(4):
                v[j] = _round(v[j], int.from_bytes(data[i:i + 8], "little"))
                i += 8
        h = _converge(*v)
    else:
        h = (seed + P5) & M64
    h = (h + n) & M64
    while i + 8 <= n:
        h = _lane8(h, int.from_bytes(data[i:i + 8], "little"))
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * P1) & M64
        h = (_rotl(h, 23) * P2 + P3) & M64
        i += 4
    while i < n:
        h ^= (data[i] * P5) & M64
        h = (_rotl(h, 11) * P1) & M64
        i += 1
    return _avalanche(h)


def _v_rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U(r)) | (x >> _U(64 - r))


def _v_round(acc: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _v_rotl(acc + lane * _NP2, 31) * _NP1


def _v_lane8(h: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _v_rotl(h ^ _v_round(np.zeros_like(h), lane), 27) * _NP1 + _NP4


def chained_xxh64(tokens: np.ndarray, parent: int, mask: int) -> List[int]:
    """``h_i = xxh64(tokens[i].tobytes() + h_{i-1}.to_bytes(8, "little"))
    & mask`` over the rows of ``tokens`` (``[N, bs]`` int64), with
    ``h_{-1} = parent``."""
    n_blocks, bs = tokens.shape
    if n_blocks == 0:
        return []
    lanes = np.ascontiguousarray(tokens, dtype=np.int64).view(np.uint64)
    total = 8 * (bs + 1)
    n_stripes = (bs + 1) // 4
    body_stripes = bs // 4
    out: List[int] = []
    prev = parent
    if n_stripes > body_stripes:
        # bs % 4 == 3: the parent is the last lane of the last stripe, so
        # that stripe is chained; the stripes before it are not.
        with np.errstate(over="ignore"):
            v = np.broadcast_to(np.array(_init(0), dtype=np.uint64),
                                (n_blocks, 4)).copy()
            for s in range(body_stripes):
                v = _v_round(v, lanes[:, 4 * s:4 * s + 4])
        heads = v.tolist()
        rests = lanes[:, 4 * body_stripes:].tolist()
        for row, rest in zip(heads, rests):
            v4 = [_round(a, b) for a, b in zip(row, rest + [prev])]
            prev = _avalanche((_converge(*v4) + total) & M64) & mask
            out.append(prev)
        return out
    with np.errstate(over="ignore"):
        if n_stripes:
            v = np.broadcast_to(np.array(_init(0), dtype=np.uint64),
                                (n_blocks, 4)).copy()
            for s in range(n_stripes):
                v = _v_round(v, lanes[:, 4 * s:4 * s + 4])
            h = (_v_rotl(v[:, 0], 1) + _v_rotl(v[:, 1], 7)
                 + _v_rotl(v[:, 2], 12) + _v_rotl(v[:, 3], 18))
            for j in range(4):
                h = (h ^ _v_round(np.zeros_like(h), v[:, j])) * _NP1 + _NP4
        else:
            h = np.full(n_blocks, P5, dtype=np.uint64)
        h = h + _U(total)
        # Body lanes past the stripes (bs % 4 in {1, 2}, or bs <= 2).
        for j in range(4 * n_stripes, bs):
            h = _v_lane8(h, lanes[:, j])
    # The chained part, inlined (per block: one lane round and the
    # avalanche).
    append = out.append
    for hb in h.tolist():
        acc = (prev * P2) & M64
        acc = (((acc << 31) | (acc >> 33)) & M64) * P1 & M64
        x = hb ^ acc
        x = ((((x << 27) | (x >> 37)) & M64) * P1 + P4) & M64
        x ^= x >> 33
        x = (x * P2) & M64
        x ^= x >> 29
        x = (x * P3) & M64
        prev = (x ^ (x >> 32)) & mask
        append(prev)
    return out
