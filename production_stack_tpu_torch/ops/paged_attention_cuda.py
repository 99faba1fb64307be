"""Wrappers of the hand-written CUDA paged-attention kernels.

``paged_attention_decode`` replaces the JAX package's Pallas
``_decode_kernel``, ``paged_attention_decode_write`` its
``_decode_write_kernel`` and ``paged_attention_prefill`` its
``_prefill_kernel`` (``production_stack_tpu/ops/paged_attention_pallas.py``).
``kernel_route`` picks the kernel from the types and the head geometry:
bf16 q at head_dim 128 or 256 runs the split-KV decode of
``csrc/decode_splitkv.cuh`` (``decode_plan`` picks its split count) and the
tensor-core prefill of ``csrc/prefill_wgmma.cuh`` (``prefill_plan`` picks
how many blocks share each q-tile's keys); fp32 q, or head_dim 16,
32 or 64, the CUDA-core kernels of ``csrc/paged_attention.cuh``
(``simt_decode_plan`` and ``simt_prefill_plan`` pick their splits). Every
kernel takes 1 to 8 query heads per kv head and a cache in q's type or in
e4m3 (``kv_cache_dtype="float8_e4m3fn"``: the kernels up-convert K and V
exactly, every e4m3 value being a bf16 value). Each wrapper has a plain
PyTorch version beside it (``*_plain``: gather + masked softmax in fp32,
the same function), which it runs only for tensors on the CPU. On a CUDA
tensor a wrapper launches its kernel or raises — there is no fallback.

``launch_counts`` counts kernel launches per wrapper, so a run can show
that its path went through the kernels; ``route_counts`` splits them by
kernel, cache form and head_dim 256.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .attention import gather_pages, window_eff
from .fp8 import E4M3, raw, to_cache_dtype

launch_counts: Dict[str, int] = {"decode": 0, "decode_write": 0,
                                 "prefill": 0}
# Launches by kernel, cache form and head_dim: "<wrapper>_<route>", with
# "_e4m3" appended for an e4m3 cache, then "_hd256" at head_dim 256.
route_counts: Dict[str, int] = {
    f"{kind}_{route}{form}{hd}": 0
    for kind, routes in (("prefill", ("wgmma", "simt")),
                         ("decode", ("split", "simt")),
                         ("decode_write", ("split", "simt")))
    for route in routes for form in ("", "_e4m3") for hd in ("", "_hd256")
}

# Element types by the code the launches pass.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, E4M3: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)  # every kernel's; fp32 q: CUDA cores
TENSOR_CORE_HEAD_DIMS = (128, 256)  # bf16 q: the split-KV and wgmma kernels
MAX_GROUP = 8  # query heads per kv head, 1 to 8 in every kernel


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for k in counts:
            counts[k] = 0


def kernel_route(kind: str, q_dtype: torch.dtype, cache_dtype: torch.dtype,
                 H: int, KH: int, hd: int) -> str:
    """The kernel a ``kind`` call (``"decode"``, ``"decode_write"`` or
    ``"prefill"``) takes for these types and this head geometry:
    ``"split"`` (``decode_split_kernel``) or ``"wgmma"``
    (``paged_prefill_wgmma_kernel``) for bf16 q at head_dim 128 or 256,
    ``"simt"`` (the CUDA-core kernels of ``paged_attention.cuh``) for fp32 q
    (head_dim 16 to 256) or head_dim 16, 32 or 64. The cache holds q's
    type, or e4m3 under either. Raises where no kernel exists; needs no
    GPU."""
    if kind not in ("decode", "decode_write", "prefill"):
        raise ValueError(f"unknown attention kind {kind!r}")
    if cache_dtype not in DTYPE_CODES:
        raise TypeError(f"no kernel takes a {cache_dtype} cache (float32, "
                        "bfloat16 or float8_e4m3fn)")
    if q_dtype not in (torch.float32, torch.bfloat16) or (
            cache_dtype != E4M3 and q_dtype != cache_dtype):
        raise TypeError(f"q is {q_dtype} but the cache is {cache_dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"no kernel for head_dim={hd}: the kernels take {HEAD_DIMS} "
            "(other head geometries: ROADMAP queue 2 item 2)")
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")
    if H // KH > MAX_GROUP:
        raise ValueError(
            f"H/KH = {H // KH}: the kernels take 1 to {MAX_GROUP} query heads "
            "per kv head (ROADMAP queue 2 item 2)")
    if q_dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        return "wgmma" if kind == "prefill" else "split"
    return "simt"


def _count(kind: str, route: str, cache_dtype: torch.dtype, hd: int) -> None:
    launch_counts[kind] += 1
    route_counts[f"{kind}_{route}{'_e4m3' if cache_dtype == E4M3 else ''}"
                 f"{'_hd256' if hd == 256 else ''}"] += 1


# decode_splitkv.cuh: keys a tile holds (16 a warp, 8 in bf16 at head_dim
# 256), and the blocks an SM holds by head_dim and cache form (bf16: a 96
# KB ring at either head dim, two; e4m3 at head_dim 128: a 48 KB ring and
# at most 128 registers, so four; at 256, 96 KB, two). On an NVIDIA H100
# 80GB HBM3, at Llama-3-8B's heads and B in {1, 8, 16, 32, 64}, the bf16
# kernel was fastest with the grid one wave of them (B*KH*S = 2 * 132) and
# no split under two tiles: a shorter one pays its merge for too few keys.
SPLIT_TILES = {128: 64, 256: 32}
SPLIT_TILES_E4M3 = {128: 64, 256: 64}
_SPLIT_BLOCKS_PER_SM = {(128, False): 2, (256, False): 2, (128, True): 4,
                        (256, True): 2}
_SPLIT_MIN_TILES = 2
_MAX_SPLITS = 64  # kMaxSplits


def split_tile(hd: int, e4m3: bool = False) -> int:
    """Keys a tile of the split-KV kernel holds over this cache form."""
    return (SPLIT_TILES_E4M3 if e4m3 else SPLIT_TILES)[hd]


def decode_plan(B: int, KH: int, W: int, bs: int, n_sm: int, hd: int,
                e4m3: bool = False) -> int:
    """Splits of each (sequence, kv head)'s keys for the split-KV kernel,
    from what the host knows (never ``kv_lens``): as many as keep B*KH*S
    within one wave of the blocks an SM holds (``_SPLIT_BLOCKS_PER_SM[hd,
    e4m3]``), at most one split per two key tiles (``split_tile(hd,
    e4m3)`` keys each) the table can hold, and at most 64."""
    tiles = -(-W * bs // split_tile(hd, e4m3))
    fit = _SPLIT_BLOCKS_PER_SM[hd, e4m3] * n_sm // max(B * KH, 1)
    return max(1, min(fit, tiles // _SPLIT_MIN_TILES, _MAX_SPLITS))


def _split_keys(lo: int, hi: int, tile: int, splits: int,
                s: int) -> Tuple[int, int]:
    """Run ``s`` of ``splits`` over the keys ``[lo, hi)``
    (``csrc/splits.cuh::split_run``): the tiles ``[lo // tile,
    ceil(hi / tile))`` cut at ``n * s // splits``, clipped to ``[lo, hi)``;
    an empty run is ``(k0, k0)``."""
    ta = lo // tile
    n = -(-hi // tile) - ta if hi > lo else 0
    t0 = ta + n * s // splits
    t1 = ta + n * (s + 1) // splits
    k0 = max(t0 * tile, lo)
    k1 = min(t1 * tile, hi)
    return (k0, k1) if k1 > k0 else (k0, k0)


def decode_split_keys(kv_len: int, window: int, splits: int, s: int,
                      hd: int, e4m3: bool = False) -> Tuple[int, int]:
    """The keys ``[k0, k1)`` that split ``s`` of ``splits`` reads for a row
    of ``kv_len`` (the kernel's partition at head dim ``hd`` over this
    cache form, for the tests): with tiles of ``tile = split_tile(hd,
    e4m3)`` keys, the row's live tiles ``[lo // tile, ceil(kv_len /
    tile))`` cut into runs at ``n * s // splits``, clipped to ``[lo,
    kv_len)``."""
    lo = max(kv_len - window_eff(window), 0)
    return _split_keys(lo, kv_len, split_tile(hd, e4m3), splits, s)


# The bf16 form's staging layout and Oᵀ map at head_dim 256
# (csrc/decode_splitkv.cuh), for the tests. A warp owns 8 keys of a tile;
# lane = 4 grp + tig.

def bf16_stage_offset(r: int, c: int, hd: int = 256) -> int:
    """Byte offset of 16-byte chunk ``c`` (8 dims) of staged bf16 key row
    ``r`` in a head_dim-256 tile: a whole row from the bulk copy engine,
    rows 2 hd + 16 bytes apart (``Geo::kRowStride``)."""
    return r * (2 * hd + 16) + 16 * c


def bf16_o_dims(grp: int, t: int) -> Tuple[int, int]:
    """The dims of rows ``grp`` and ``grp + 8`` of Oᵀ's m-tile ``t`` at
    head_dim 256: chunks 2 t and 2 t + 1 of a V row, whose ldmatrix.trans
    rows are the warp's 8 keys."""
    return 16 * t + grp, 16 * t + grp + 8


# The e4m3 form's fragment maps (csrc/decode_splitkv.cuh), for the tests.
# A warp owns 16 keys of a tile; lane = 4 grp + tig.

def e4m3_stage_offset(r: int, c: int, hd: int) -> int:
    """Byte offset of 16-byte chunk ``c`` of staged e4m3 key row ``r`` in
    a tile (``swz8``): chunk c ^ sig(r), sig(r) = 4 ((r ^ r >> 2) & 1) +
    2 ((r >> 3) & 1)."""
    sig = (((r ^ (r >> 2)) & 1) << 2) | (((r >> 3) & 1) << 1)
    return r * hd + ((c ^ sig) << 4)


def e4m3_k_dims(tig: int, kk: int) -> Tuple[int, int, int, int]:
    """The dims of k-step ``kk`` of S = Q Kᵀ that lane ``tig`` (mod 4)
    holds at its k positions 2 tig, 2 tig + 1 (register b0 of K, a0 of Q)
    and 2 tig + 8, 2 tig + 9 (b1, a2): bytes 4 (kk % 4) .. + 3 of chunk
    tig + 4 (kk // 4) of a K row."""
    d = 16 * (tig + 4 * (kk // 4)) + 4 * (kk % 4)
    return d, d + 1, d + 2, d + 3


def e4m3_s_key(n: int, j: int) -> int:
    """The key (of the warp's 16) that column ``n`` of S's n8 tile ``j``
    stands for: the K row lane 4 n + tig reads for tile j. A lane's scores
    (columns 2 tig, 2 tig + 1 of both tiles) are keys 4 tig .. 4 tig + 3,
    which are the k positions 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of
    Oᵀ += Vᵀ Pᵀ."""
    return 4 * (n // 2) + 2 * j + n % 2


def e4m3_o_dims(grp: int, t: int) -> Tuple[int, int]:
    """The dims of rows ``grp`` and ``grp + 8`` of Oᵀ's m-tile ``t``: bytes
    2 (t % 2), + 1 of word (t % 8) // 2 of chunk grp + 8 (t // 8) of a V
    row. Its columns are the heads."""
    d = 128 * (t // 8) + 16 * grp + 2 * (t % 8)
    return d, d + 1


# paged_attention.cuh's CUDA-core decode: a key row is LPK lanes of VPL
# values, a warp takes KPW keys a step, 8 warps a block; a tile holds about
# 16 KB of K rows (at most 8 steps a warp and 128 keys), 3 tiles of K and
# V in the ring. Blocks an SM: as many rings as fit 227 KB, at most 4. A
# split reads at least 256 KB of K and V: on an NVIDIA H100 80GB HBM3 a
# shorter one paid its merge (a fence, a ticket and a reload) for too few
# bytes (PERF.md).
SIMT_WARPS = 8
_SIMT_STAGES = 3
_SIMT_BLOCKS_PER_SM = 4
_SMEM_PER_SM = 227 * 1024
_SIMT_MIN_SPLIT_BYTES = 256 * 1024


def simt_lanes(hd: int) -> Tuple[int, int, int]:
    """(VPL, LPK, KPW) of the CUDA-core decode at head_dim ``hd``: values a
    lane, lanes a key row, keys a warp step."""
    vpl = hd // 32 if hd // 4 > 32 else 4
    return vpl, hd // vpl, 32 // (hd // vpl)


def simt_tile(hd: int, itemsize: int) -> int:
    """Keys a tile of the CUDA-core decode holds over a cache of
    ``itemsize``-byte values (``SimtGeo::kKeys``)."""
    step = SIMT_WARPS * simt_lanes(hd)[2]
    return max(step, min(16384 // (hd * itemsize), 8 * step, 128))


def simt_decode_plan(B: int, KH: int, W: int, bs: int, n_sm: int, hd: int,
                     itemsize: int) -> int:
    """Splits of each (sequence, kv head)'s keys for the CUDA-core decode,
    from shapes only (never ``kv_lens``): as many as keep B*KH*S within one
    wave of the blocks an SM holds (as many rings as fit, at most 4), at
    most one split a tile and one per 256 KB of K and V the table can
    hold, and at most 64."""
    tile = simt_tile(hd, itemsize)
    ring = _SIMT_STAGES * 2 * tile * hd * itemsize
    per_sm = max(1, min(_SIMT_BLOCKS_PER_SM, _SMEM_PER_SM // ring))
    fit = per_sm * n_sm // max(B * KH, 1)
    by_bytes = W * bs * 2 * hd * itemsize // _SIMT_MIN_SPLIT_BYTES
    return max(1, min(fit, -(-W * bs // tile), by_bytes, _MAX_SPLITS))


def simt_split_keys(kv_len: int, window: int, splits: int, s: int, hd: int,
                    itemsize: int) -> Tuple[int, int]:
    """The keys ``[k0, k1)`` that split ``s`` of ``splits`` of the CUDA-core
    decode reads for a row of ``kv_len``: :func:`_split_keys` in tiles of
    ``simt_tile(hd, itemsize)`` keys."""
    lo = max(kv_len - window_eff(window), 0)
    return _split_keys(lo, kv_len, simt_tile(hd, itemsize), splits, s)


# paged_attention.cuh's CUDA-core prefill (PrefillGeo): query rows a block
# takes (a q-tile: rows // G positions of the G heads of one kv head) and
# keys a tile, by head_dim; the blocks an SM its launch bounds promise
# (kMinBlocks: two at head_dim 16; one above, where 128 registers a thread
# spill or an fp32 ring and Q take 166-169 KB). 8 warps a block.
SIMT_PREFILL_TILES = {16: (128, 32), 32: (128, 32), 64: (128, 32),
                      128: (128, 32), 256: (64, 16)}
_SIMT_PREFILL_BLOCKS_PER_SM = {16: 2, 32: 1, 64: 1, 128: 1, 256: 1}
_SIMT_PREFILL_MAX_SPLITS = 16  # kPrefillMaxSplits


def simt_prefill_qtiles(T: int, G: int, hd: int) -> int:
    """q-tiles of a T-row chunk at G query heads per kv head in the
    CUDA-core prefill at head_dim ``hd``."""
    return -(-T // (SIMT_PREFILL_TILES[hd][0] // G))


def simt_prefill_plan(B: int, KH: int, T: int, G: int, W: int, bs: int,
                      n_sm: int, hd: int) -> int:
    """Blocks that share each q-tile's keys in the CUDA-core prefill, from
    shapes only (never ``kv_lens`` or ``starts``): as many as keep the
    grid, B*KH*q-tiles*S blocks, within one wave of the blocks an SM holds
    (``_SIMT_PREFILL_BLOCKS_PER_SM[hd]``), at most one split per two key
    tiles the table can hold, and at most 16. tiny-llama-debug's heads (KH
    8, G 1, hd 16) at T=256 over a 256-key table: 16 q-tile blocks, 4
    splits; fp32 Llama-3-8B heads (KH 8, G 4, hd 128) at T=512: 128, one."""
    keys = SIMT_PREFILL_TILES[hd][1]
    tiles = -(-W * bs // keys)
    fit = (_SIMT_PREFILL_BLOCKS_PER_SM[hd] * n_sm
           // max(B * KH * simt_prefill_qtiles(T, G, hd), 1))
    return max(1, min(fit, tiles // _SPLIT_MIN_TILES,
                      _SIMT_PREFILL_MAX_SPLITS))


def simt_prefill_split_keys(kv_len: int, start: int, T: int, G: int, qt: int,
                            window: int, splits: int, s: int,
                            hd: int) -> Tuple[int, int]:
    """The keys ``[k0, k1)`` that split ``s`` of ``splits`` of the CUDA-core
    prefill reads for q-tile ``qt`` of a T-row chunk at ``start``: the
    q-tile's positions ``start + [t0, t_end)`` see keys ``[max(start + t0
    + 1 - window, 0), min(kv_len, start + t_end))``, cut as
    :func:`_split_keys` cuts, in tiles of ``SIMT_PREFILL_TILES[hd][1]``
    keys."""
    rows, keys = SIMT_PREFILL_TILES[hd]
    tq = rows // G
    t0, t_end = qt * tq, min(qt * tq + tq, T)
    lo = max(start + t0 + 1 - window_eff(window), 0)
    hi = min(kv_len, start + t_end)
    return _split_keys(lo, hi, keys, splits, s)


# prefill_wgmma.cuh: query rows a block takes (128 // G positions of the G
# heads of one kv head: a q-tile) and keys a tile holds by head_dim
# (kKeys). One block an SM (161-225 KB of shared memory), so the plan aims
# at one block an SM.
PREFILL_ROWS = 128
PREFILL_TILES = {128: 64, 256: 64}
_PREFILL_MAX_SPLITS = 32  # kMaxSplits: the merge's weights in shared memory


def prefill_qtiles(T: int, G: int) -> int:
    """q-tiles of a T-row chunk at G query heads per kv head."""
    return -(-T // (PREFILL_ROWS // G))


def prefill_plan(B: int, KH: int, T: int, G: int, W: int, bs: int,
                 n_sm: int, hd: int) -> int:
    """Blocks that share each q-tile's keys in the wgmma prefill, from what
    the host knows (never ``kv_lens`` or ``starts``): as many as keep the
    grid, B*KH*q-tiles*S blocks, within one wave of one block an SM, at
    most one split per two key tiles (``PREFILL_TILES[hd]`` keys each) the
    table can hold, and at most 32. At gemma2-9b's heads (KH 8, G 2) a
    512-token chunk has 64 q-tiles, so S = 2 on 132 SMs; Llama-3-8B's (KH
    8, G 4) has 128, so S = 1."""
    tiles = -(-W * bs // PREFILL_TILES[hd])
    fit = n_sm // max(B * KH * prefill_qtiles(T, G), 1)
    return max(1, min(fit, tiles // _SPLIT_MIN_TILES, _PREFILL_MAX_SPLITS))


def prefill_split_keys(kv_len: int, start: int, T: int, G: int, qt: int,
                       window: int, splits: int, s: int,
                       hd: int) -> Tuple[int, int]:
    """The keys ``[k0, k1)`` that split ``s`` of ``splits`` reads for
    q-tile ``qt`` of a T-row chunk at ``start`` (the kernel's partition at
    head dim ``hd``, for the tests): the q-tile's positions ``start + [t0,
    t_end)`` see keys from its first row's window start to its last row's
    causal bound, ``[max(start + t0 + 1 - window, 0), min(kv_len, start +
    t_end))``, cut as :func:`_split_keys` cuts, in tiles of
    ``PREFILL_TILES[hd]`` keys."""
    tq = PREFILL_ROWS // G
    t0, t_end = qt * tq, min(qt * tq + tq, T)
    lo = max(start + t0 + 1 - window_eff(window), 0)
    hi = min(kv_len, start + t_end)
    return _split_keys(lo, hi, PREFILL_TILES[hd], splits, s)


_SM_COUNTS: Dict[torch.device, int] = {}
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
# Ticket buffers outgrown by a later launch: a CUDA graph captured before
# the growth still reads and writes the old one, so it is never freed.
_RETIRED: List[torch.Tensor] = []


def _sm_count(device: torch.device) -> int:
    if device not in _SM_COUNTS:
        _SM_COUNTS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNTS[device]


def ticket_count(q_dtype: torch.dtype, cache_dtype: torch.dtype, H: int,
                 KH: int, hd: int, B: int, T: int = 1) -> int:
    """The tickets a launch over B sequences of T query tokens takes when
    its plan splits: one a (sequence, kv head) in decode (T = 1), one a
    q-tile of each (sequence, kv head) in prefill. Needs no GPU."""
    if T == 1:
        return B * KH
    G = H // KH
    if kernel_route("prefill", q_dtype, cache_dtype, H, KH, hd) == "wgmma":
        return B * KH * prefill_qtiles(T, G)
    return B * KH * simt_prefill_qtiles(T, G, hd)


def reserve_tickets(device: torch.device, n: int) -> None:
    """Grow the split kernels' tickets on ``device`` to ``n`` now, before
    any CUDA graph is captured: a growth under capture raises."""
    _counters(device, n)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The split kernels' tickets, one per (sequence, kv head) in decode
    and per q-tile in prefill: zeros, left zero by every launch (the
    launches that share them are ordered on one stream); grown (never
    shrunk) to the largest count so far. Under stream capture the buffer
    must already be large enough: one allocated there would come from
    the graph's pool."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a captured launch needs {n} split tickets but "
                f"{0 if buf is None else buf.numel()} are reserved: call "
                "reserve_tickets before capturing")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _ptr(t):
    """A tensor's address, or a null pointer for what a launch does not
    use."""
    return None if t is None else t.data_ptr()


def decode_launch_splits(route, q3, kv_pages, block_tables,
                         n_sm: int) -> int:
    """The split count of a decode launch on ``route``: its plan taken at
    the cache's page count, never at the block table's width. A row's
    split count sets how its keys are partitioned, so its rounding; the
    table's width is a bucket of the pages its sequences hold, and a
    pipelined burst holds the next page a step earlier than the
    synchronous loop, so a plan by the width made one request's tokens
    depend on when the pipeline engaged (ROADMAP, fault 3.8)."""
    B, _, hd = q3.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH = lanes // hd
    if route == "split":
        return decode_plan(B, KH, nb, bs, n_sm, hd, kv_pages.dtype == E4M3)
    return simt_decode_plan(B, KH, nb, bs, n_sm, hd, kv_pages.dtype.itemsize)


def prefill_launch_splits(route, q, kv_pages, n_sm: int) -> int:
    """The split count of a prefill launch on ``route``, its plan taken at
    the cache's page count and never at the block table's width, as
    :func:`decode_launch_splits` takes a decode's. The speculative verify
    step is a prefill launch at decode-time context (B rows of K+1
    positions): planned by the width of its table bucket, one row's
    rounding would hang on which other rows share its step, and a greedy
    token on the rows around it."""
    B, T, H, hd = q.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH = lanes // hd
    if route == "wgmma":
        return prefill_plan(B, KH, T, H // KH, nb, bs, n_sm, hd)
    return simt_prefill_plan(B, KH, T, H // KH, nb, bs, n_sm, hd)


def _launch_decode(route, q3, kv_pages, block_tables, kv_lens, layer, write,
                   scale, window, softcap):
    """A decode (``write`` None) or decode-write (``write`` = (k_new, v_new,
    write_flat), the rows in q's type; the kernel casts them into the
    cache's) on ``route``: ``"split"`` (``decode_split_kernel``, bf16 q) or
    ``"simt"`` (``paged_decode_kernel``). Both split each (sequence, kv
    head)'s keys over blocks from a plan of shapes only and merge the
    splits in the launch. Returns [B, H, hd]."""
    from ._build import load

    lib = load()
    B, H, hd = q3.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH = lanes // hd
    W = block_tables.shape[1]
    splits = decode_launch_splits(route, q3, kv_pages, block_tables,
                                  _sm_count(q3.device))
    out = torch.empty_like(q3)
    ws = counters = None
    if splits > 1:
        ws = torch.empty(B * H * splits * (hd + 2),
                         dtype=torch.float32, device=q3.device)
        counters = _counters(q3.device, B * KH)
    k_new, v_new, write_flat = write if write is not None else (None,) * 3
    head = (q3.data_ptr(), kv_pages.data_ptr())
    tail = (block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            _ptr(ws), _ptr(counters), B, H, KH, hd, nb, bs, W, int(layer),
            int(window), float(scale), float(softcap), splits,
            torch.cuda.current_stream(q3.device).cuda_stream)
    if route == "split":
        rc = lib.pst_decode_split(DTYPE_CODES[kv_pages.dtype], *head,
                                  _ptr(k_new), _ptr(v_new), _ptr(write_flat),
                                  *tail)
    elif write is None:
        rc = lib.pst_paged_decode(DTYPE_CODES[q3.dtype],
                                  DTYPE_CODES[kv_pages.dtype], *head, *tail)
    else:
        rc = lib.pst_paged_decode_write(
            DTYPE_CODES[q3.dtype], DTYPE_CODES[kv_pages.dtype], *head,
            k_new.data_ptr(), v_new.data_ptr(), write_flat.data_ptr(), *tail)
    if rc != 0:
        kind = "decode" if write is None else "decode-write"
        raise RuntimeError(f"{kind} kernel ({route}) failed: cudaError {rc}")
    return out


def _plain(q, kv_pages, block_tables, kv_lens, q_positions, layer, scale,
           window, softcap):
    """Masked paged attention in fp32 with the kernels' empty-row rule:
    a row with no live key outputs zeros. q [B, T, H, hd]; an e4m3 cache is
    up-converted exactly."""
    B, T, H, hd = q.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH = lanes // hd
    W = block_tables.shape[1]
    S = W * bs
    kv = gather_pages(kv_pages, layer, block_tables).float()
    k = kv[:, :, 0].reshape(B, S, KH, hd)
    v = kv[:, :, 1].reshape(B, S, KH, hd)
    qg = q.float().reshape(B, T, KH, H // KH, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)[None, None, :]
    qp = q_positions.long()[..., None]  # [B, T, 1]
    live = (
        (pos < kv_lens.long()[:, None, None])
        & (pos <= qp)
        & (pos > qp - window_eff(window))
    )  # [B, T, S]
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    any_live = live.any(-1)[:, None, None, :, None]  # [B, 1, 1, T, 1]
    p = torch.softmax(s, dim=-1)
    p = torch.where(any_live, p, torch.zeros_like(p))
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(B, T, H, hd).to(q.dtype)


def paged_attention_decode_plain(q3, kv_pages, block_tables, kv_lens, layer,
                                 *, scale, window=0, softcap=0.0):
    """[B, H, hd] query at position kv_len - 1 against its paged KV."""
    q_pos = (kv_lens.long() - 1)[:, None]
    return _plain(q3[:, None], kv_pages, block_tables, kv_lens, q_pos, layer,
                  scale, window, softcap)[:, 0]


def paged_attention_decode_write_plain(q3, kv_pages, block_tables, kv_lens,
                                       layer, k_new, v_new, write_flat, *,
                                       scale, window=0, softcap=0.0):
    """Write this step's K/V rows, then decode: ``index_copy_`` of the rows
    of ``k_new``/``v_new`` [B, KH*hd], cast to the cache's type
    (``to_cache_dtype``), into slot ``write_flat`` [B] (page
    ``write_flat // bs``, row ``write_flat % bs``) of ``layer``, dropping a
    slot outside ``[0, nb*bs)``; then :func:`paged_attention_decode_plain`.
    Updates ``kv_pages`` in place; returns [B, H, hd]."""
    _, nb, _, bs, lanes = kv_pages.shape
    wf = write_flat.long()
    keep = torch.nonzero((wf >= 0) & (wf < nb * bs))[:, 0]
    wf = wf[keep]
    rows = ((layer * nb + wf // bs) * 2 * bs + wf % bs)
    flat = raw(kv_pages.view(-1, lanes))
    flat.index_copy_(0, rows, raw(to_cache_dtype(k_new[keep], kv_pages.dtype)))
    flat.index_copy_(0, rows + bs,
                     raw(to_cache_dtype(v_new[keep], kv_pages.dtype)))
    return paged_attention_decode_plain(
        q3, kv_pages, block_tables, kv_lens, layer, scale=scale,
        window=window, softcap=softcap,
    )


def paged_attention_prefill_plain(q, kv_pages, block_tables, kv_lens, starts,
                                  layer, *, scale, window=0, softcap=0.0):
    """[B, T, H, hd] chunk whose row t sits at position starts + t."""
    T = q.shape[1]
    q_pos = starts.long()[:, None] + torch.arange(T, device=q.device)[None]
    return _plain(q, kv_pages, block_tables, kv_lens, q_pos, layer, scale,
                  window, softcap)


def _check(kind, q, q_dim, kv_pages, block_tables, kv_lens, layer,
           extra=()) -> str:
    """Everything a launch needs of its arguments; returns the route."""
    if q.dim() != q_dim:
        raise ValueError(f"q must have {q_dim} dims, got {tuple(q.shape)}")
    hd = q.shape[-1]
    H = q.shape[-2]
    lanes = kv_pages.shape[-1]
    if kv_pages.dim() != 5 or kv_pages.shape[2] != 2 or lanes % hd:
        raise ValueError(f"cache shape {tuple(kv_pages.shape)} is not "
                         "[L, nb, 2, bs, KH*hd]")
    route = kernel_route(kind, q.dtype, kv_pages.dtype, H, lanes // hd, hd)
    if not 0 <= layer < kv_pages.shape[0]:
        raise IndexError(f"layer {layer} outside the cache")
    B = q.shape[0]
    for name, t in (("block_tables", block_tables), ("kv_lens", kv_lens),
                    *extra):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != (2 if name == "block_tables" else 1) or t.shape[0] != B:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q has "
                             f"{B} rows")
    for name, t in (("q", q), ("kv_pages", kv_pages),
                    ("block_tables", block_tables), ("kv_lens", kv_lens),
                    *extra):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kv_pages", kv_pages)):
        if t.data_ptr() % 16:  # the kernels load 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    return route


def paged_attention_decode(q3, kv_pages, block_tables, kv_lens, layer, *,
                           scale, window=0, softcap=0.0):
    """One query token per sequence. q3 [B, H, hd] -> [B, H, hd]."""
    if not q3.is_cuda:
        return paged_attention_decode_plain(
            q3, kv_pages, block_tables, kv_lens, layer, scale=scale,
            window=window, softcap=softcap,
        )
    route = _check("decode", q3, 3, kv_pages, block_tables, kv_lens, layer)
    out = _launch_decode(route, q3, kv_pages, block_tables, kv_lens, layer,
                         None, scale, window, softcap)
    _count("decode", route, kv_pages.dtype, q3.shape[-1])
    return out


def paged_attention_decode_write(q3, kv_pages, block_tables, kv_lens, layer,
                                 k_new, v_new, write_flat, *, scale,
                                 window=0, softcap=0.0):
    """Decode with this step's KV write folded in. q3 [B, H, hd]; k_new,
    v_new [B, KH*hd], cast to q's type here and by the kernel into the
    cache's (into e4m3 as ``cast_e4m3`` casts, bit for bit); write_flat [B]
    int32 flat slot ``blk * bs + pos`` (outside ``[0, nb*bs)``: dropped);
    kv_lens include the new row. Updates ``kv_pages`` in place; returns
    [B, H, hd]."""
    if not q3.is_cuda:
        return paged_attention_decode_write_plain(
            q3, kv_pages, block_tables, kv_lens, layer, k_new, v_new,
            write_flat, scale=scale, window=window, softcap=softcap,
        )
    route = _check("decode_write", q3, 3, kv_pages, block_tables, kv_lens,
                   layer, extra=(("write_flat", write_flat),))
    B, _, hd = q3.shape
    lanes = kv_pages.shape[-1]
    k_new = k_new.to(q3.dtype).contiguous()
    v_new = v_new.to(q3.dtype).contiguous()
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, lanes) or t.device != q3.device:
            raise ValueError(f"{name} must be [{B}, {lanes}] on {q3.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:  # the kernels copy 16-byte pieces
            raise ValueError(f"{name} must be 16-byte aligned")
    out = _launch_decode(route, q3, kv_pages, block_tables, kv_lens, layer,
                         (k_new, v_new, write_flat), scale, window, softcap)
    _count("decode_write", route, kv_pages.dtype, hd)
    return out


def paged_attention_prefill(q, kv_pages, block_tables, kv_lens, starts,
                            layer, *, scale, window=0, softcap=0.0):
    """Chunked prefill. q [B, T, H, hd] -> [B, T, H, hd]; row t of
    sequence b sits at position starts[b] + t and sees keys
    < min(starts[b] + t + 1, kv_lens[b])."""
    if not q.is_cuda:
        return paged_attention_prefill_plain(
            q, kv_pages, block_tables, kv_lens, starts, layer, scale=scale,
            window=window, softcap=softcap,
        )
    route = _check("prefill", q, 4, kv_pages, block_tables, kv_lens, layer,
                   extra=(("starts", starts),))
    from ._build import load

    lib = load()
    B, T, H, hd = q.shape
    _, nb, _, bs, lanes = kv_pages.shape
    KH, W = lanes // hd, block_tables.shape[1]
    out = torch.empty_like(q)
    head = (DTYPE_CODES[kv_pages.dtype], q.data_ptr(), kv_pages.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), starts.data_ptr(),
            out.data_ptr())
    tail = (B, T, H, KH, hd, nb, bs, W, int(layer), int(window),
            float(scale), float(softcap))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    splits = prefill_launch_splits(route, q, kv_pages, _sm_count(q.device))
    rows = PREFILL_ROWS if route == "wgmma" else SIMT_PREFILL_TILES[hd][0]
    n = ticket_count(q.dtype, kv_pages.dtype, H, KH, hd, B, T)
    ws = counters = None
    if splits > 1:
        ws = torch.empty(n * splits * rows * (hd + 2), dtype=torch.float32,
                         device=q.device)
        counters = _counters(q.device, n)
    if route == "wgmma":
        rc = lib.pst_paged_prefill_wgmma(*head, _ptr(ws), _ptr(counters),
                                         *tail, splits, stream)
    else:
        rc = lib.pst_paged_prefill(DTYPE_CODES[q.dtype], *head, _ptr(ws),
                                   _ptr(counters), *tail, splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged prefill kernel ({route}) failed: "
                           f"cudaError {rc}")
    _count("prefill", route, kv_pages.dtype, hd)
    return out
