"""Ahead-of-time step capture over the padded shape-bucket lattice.

The port of the JAX package's ``engine/precompile.py``. The runner pads
every device step into a small set of power-of-two bucket shapes, which
makes the full set of steps live traffic can ever demand *enumerable from
config alone*. This module enumerates that lattice — prefill (rows x
chunk), decode rows, decode bursts, with ``speculative_ngram`` the verify
step (rows x K), and the encode lengths of ``/v1/embeddings`` — and
drives each bucket through :meth:`ModelRunner.warmup_bucket` with an
all-padding dummy batch before the server's ``/ready`` flips. Where the
JAX runner compiles one XLA program a bucket, the port's runner captures
one ``torch.cuda.CUDAGraph`` a step bucket, so after a ``full`` warmup no
live step of a covered shape runs eagerly or captures: every one
replays. An encode bucket is run once and captured never (a graph of the
T = 4096 encode would hold its activations in the shared pool): its
warmup loads what its kernels load lazily, and counts toward ``/ready``'s
coverage as the JAX package counts it.

The JAX module's persistent compilation cache becomes the kernel
library's (``EngineConfig.compile_cache_dir``, ``ops/_build.py``): a CUDA
graph cannot be written to disk, so each process captures its own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from ..logging_utils import init_logger
from .config import EngineConfig

logger = init_logger(__name__)

# Kind walk order when a bucket budget truncates the lattice: decode
# shapes serve every live token, prefill shapes gate TTFT, bursts and
# verify steps are the throughput paths, encode only serves
# /v1/embeddings.
_KIND_RANK = {
    "decode": 0,
    "decode_burst": 1,
    "prefill": 2,
    "spec_verify": 3,
    "encode": 4,
}


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One captured-graph-worth of padded shape + static step flags."""

    kind: str  # decode | decode_burst | prefill | spec_verify | encode
    rows: int = 0  # padded batch rows (decode/prefill/spec)
    tokens: int = 0  # prefill chunk bucket / encode length / spec K
    width: int = 0  # block-table width bucket
    n_steps: int = 0  # burst depth (decode_burst)
    want_lp: bool = False
    greedy: bool = True
    # Penalty-bearing multi-step variant (decode_burst only): the dense
    # [rows, V] penalty_seen/counts state keeps these shapes derivable
    # from config alone, so — unlike the pow2-length id arrays of the
    # single-step path — they ARE enumerable and warmed.
    penalized: bool = False

    @property
    def label(self) -> str:
        """The bucket's shape label (the JAX package's ``shape_bucket``)."""
        if self.kind == "decode":
            return f"b{self.rows}"
        if self.kind == "decode_burst":
            return f"b{self.rows}xn{self.n_steps}"
        if self.kind == "prefill":
            return f"b{self.rows}xt{self.tokens}"
        if self.kind == "spec_verify":
            return f"b{self.rows}xk{self.tokens}"
        return f"t{self.tokens}"

    def sort_key(self) -> tuple:
        # Greedy-no-logprobs-unpenalized first (the overwhelmingly common
        # flag set), then ascending size so coverage climbs fastest per
        # second.
        return (
            _KIND_RANK[self.kind],
            (self.want_lp, not self.greedy, self.penalized),
            self.rows,
            self.n_steps,
            self.tokens,
            self.width,
        )


def _pow2_buckets(n: int) -> List[int]:
    """Every power-of-two bucket a real count in 1..n can pad into."""
    out, b = [], 1
    while True:
        out.append(b)
        if b >= n:
            return out
        b <<= 1


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def decode_row_buckets(cfg: EngineConfig) -> List[int]:
    """Mirror of ``ModelRunner._row_bucket`` over all batch sizes: ``dp``
    is a floor, as in the JAX module."""
    floor = max(cfg.data_parallel_size, cfg.min_decode_bucket, 1)
    return sorted({max(p, floor) for p in _pow2_buckets(cfg.max_num_seqs)})


def table_width_buckets(cfg: EngineConfig) -> List[int]:
    """Mirror of ``ModelRunner._table_bucket`` over all sequence lengths."""
    from .runner import _MIN_TABLE_BUCKET

    max_table_width = -(-cfg.max_model_len // cfg.block_size)
    cap = _pow2(max_table_width)
    floor = min(_MIN_TABLE_BUCKET, cap)
    return sorted({max(p, floor) for p in _pow2_buckets(max_table_width)})


def prefill_shape_buckets(cfg: EngineConfig) -> List[tuple]:
    """Feasible (row bucket, chunk bucket) pairs under the scheduler's
    per-step token budget: a batch of B chunks with the longest C has
    B-1 (one-token rows) + C real tokens at minimum, which must fit
    ``max_prefill_tokens`` — infeasible bucket pairs can never be emitted
    and are excluded so coverage means what it says."""
    budget = cfg.max_prefill_tokens
    pairs = []
    for rb in _pow2_buckets(min(cfg.max_num_seqs, budget)):
        min_rows = 1 if rb == 1 else rb // 2 + 1
        for cb in _pow2_buckets(budget):
            min_chunk = 1 if cb == 1 else cb // 2 + 1
            if min_rows - 1 + min_chunk <= budget:
                pairs.append((rb, cb))
    return pairs


def encode_buckets(cfg: EngineConfig) -> List[int]:
    """Mirror of ``ModelRunner.encode``: every pow2 length up to
    ``max_model_len``'s, rounded up to a multiple of the ring encode's
    ``sequence_parallel_size`` (the JAX ``encode_buckets``)."""
    sp = cfg.sequence_parallel_size
    return sorted({-(-p // sp) * sp for p in _pow2_buckets(cfg.max_model_len)})


def burst_depths(cfg: EngineConfig) -> List[int]:
    """Burst depths the engine dispatches at steady state: the configured
    depth and the adaptive deep depth — plus, when a pipelining mode is on
    (``async_decode`` or the default arrival-gated ``overlap_decode``),
    the configured depth even at 1: the pipeline runs the multi-step
    graph (``b{B}xn{n}``) at whatever depth the scheduler emits. (The
    per-sequence clamp near max_model_len can shrink n through arbitrary
    values on the last few tokens of a context-limit sequence — that long
    tail is deliberately NOT enumerated; it is one capture per engine
    lifetime at worst.)"""
    depths = {
        n
        for n in (cfg.num_decode_steps, cfg.adaptive_decode_steps)
        if n and n > 1
    }
    # Overlap defers to n-gram speculation (LLMEngine._pipeline_ok), so
    # spec engines never dispatch the depth-1 variant.
    if cfg.async_decode or (cfg.overlap_decode and not cfg.speculative_ngram):
        depths.add(max(cfg.num_decode_steps, 1))
    return sorted(depths)


# The (want_lp, greedy) static-flag sets warmed by default. Logprob
# variants capture distinct graphs too but are rare enough in live
# traffic that doubling warmup for them is the wrong default; a logprobs
# request pays one capture on first use.
_FLAG_SETS = ((False, True), (False, False))


def enumerate_lattice(cfg: EngineConfig) -> List[Bucket]:
    """The full padded shape-bucket lattice for this engine config, in
    priority order (what a bucket budget truncates from the tail)."""
    rows = decode_row_buckets(cfg)
    widths = table_width_buckets(cfg)
    buckets: List[Bucket] = []
    for lp, greedy in _FLAG_SETS:
        for r in rows:
            for w in widths:
                buckets.append(
                    Bucket("decode", rows=r, width=w, want_lp=lp, greedy=greedy)
                )
        for n in burst_depths(cfg):
            for r in rows:
                for w in widths:
                    for pen in (False, True):
                        buckets.append(
                            Bucket(
                                "decode_burst", rows=r, width=w, n_steps=n,
                                want_lp=lp, greedy=greedy, penalized=pen,
                            )
                        )
        for rb, cb in prefill_shape_buckets(cfg):
            for w in widths:
                buckets.append(
                    Bucket(
                        "prefill", rows=rb, tokens=cb, width=w,
                        want_lp=lp, greedy=greedy,
                    )
                )
    if cfg.speculative_ngram:
        for r in rows:
            for w in widths:
                buckets.append(Bucket("spec_verify", rows=r,
                                      tokens=cfg.speculative_ngram, width=w))
    for t in encode_buckets(cfg):
        buckets.append(Bucket("encode", tokens=t))
    buckets.sort(key=Bucket.sort_key)
    return buckets


_LAZY_CAP = 8


def lazy_core(lattice: List[Bucket], cfg: EngineConfig) -> List[Bucket]:
    """The minimal set the very first requests hit: smallest decode
    row/table buckets (single step + configured burst) and the single-row
    full-chunk prefill shapes — dev runs come up in seconds with the cold
    paths still covered."""
    decode_rows = [b.rows for b in lattice if b.kind == "decode"]
    if not decode_rows:
        return lattice[:_LAZY_CAP]
    min_r = min(decode_rows)
    min_w = min(b.width for b in lattice if b.kind == "decode")
    max_chunk = max(
        (b.tokens for b in lattice if b.kind == "prefill"), default=0
    )
    core = [
        b
        for b in lattice
        if b.greedy
        and not b.want_lp
        and not b.penalized
        and (
            (b.kind in ("decode", "decode_burst") and b.rows == min_r
             and b.width == min_w)
            or (b.kind == "prefill" and b.rows == 1 and b.width == min_w
                and b.tokens == max_chunk)
        )
    ]
    return core[:_LAZY_CAP]


class Precompiler:
    """Walks the lattice through the runner's warmup steps."""

    def __init__(
        self,
        runner,
        cfg: EngineConfig,
        mode: Optional[str] = None,
        bucket_budget: Optional[int] = None,
    ):
        self.runner = runner
        self.cfg = cfg
        self.mode = mode if mode is not None else cfg.warmup
        if self.mode not in ("off", "lazy", "full"):
            raise ValueError(f"unknown warmup mode {self.mode!r}")
        self.bucket_budget = (
            cfg.warmup_bucket_budget if bucket_budget is None else bucket_budget
        )

    def select(self, lattice: List[Bucket]) -> List[Bucket]:
        if self.mode == "off":
            return []
        selected = (
            lazy_core(lattice, self.cfg) if self.mode == "lazy" else lattice
        )
        if self.bucket_budget and len(selected) > self.bucket_budget:
            selected = selected[: self.bucket_budget]
        return selected

    def run(self) -> dict:
        lattice = enumerate_lattice(self.cfg)
        total = len(lattice)
        selected = self.select(lattice)
        t0 = time.perf_counter()
        compiled = 0
        for bucket in selected:
            self.runner.warmup_bucket(bucket)
            compiled += 1
        seconds = time.perf_counter() - t0
        skipped = total - compiled
        if skipped:
            # No silent caps: an uncaptured bucket is a future live-traffic
            # capture — say so at startup. A truncated FULL warmup warns
            # (the operator asked for complete coverage and is not getting
            # it); lazy/off skip by design and log at info.
            done = set(selected)
            log = (
                logger.warning
                if self.mode == "full" and self.bucket_budget
                else logger.info
            )
            log(
                "warmup left %d/%d lattice buckets uncaptured "
                "(mode=%s, budget=%d): first skipped %s",
                skipped, total, self.mode, self.bucket_budget,
                next((b.label for b in lattice if b not in done), "-"),
            )
        logger.info(
            "precompile: %d/%d buckets in %.1fs (mode=%s, tp=%d, dp=%d, "
            "pp=%d, sp=%d, ep=%d)", compiled, total, seconds, self.mode,
            self.cfg.tensor_parallel_size, self.cfg.data_parallel_size,
            self.cfg.pipeline_parallel_size, self.cfg.sequence_parallel_size,
            self.cfg.expert_parallel_size,
        )
        return {
            "mode": self.mode,
            "buckets_total": total,
            "buckets_compiled": compiled,
            "buckets_skipped": skipped,
            "coverage": round(compiled / total, 4) if total else 1.0,
            "seconds": round(seconds, 3),
        }
