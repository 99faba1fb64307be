"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` expose a plain C interface, so they are
compiled by ``nvcc`` straight into a shared library and bound with
``ctypes`` — no PyTorch headers, which keeps a cold build to seconds. Each
source compiles in its own ``nvcc`` process, all started together, and
one more links the objects. The library lands in ``build/torch_kernels/``
at the repository root, named by a hash of the sources and flags, and is
built at first use (never at import: machines without ``nvcc`` import this
module fine).

The engine's ``--compile-cache-dir`` (``set_compile_cache_dir``, before
the first kernel use) moves it to ``<dir>/<key>``, the key a digest of
the sources, the ``nvcc`` version and the target arch
(``compile_cache_key``): a restart, or a replacement pod on the same
volume, loads the library instead of building it. ``cache_counts``
counts the loads from that directory (``hits``) and the builds into it
(``misses``), once a process: the library is one artifact, where the JAX
package counts each compiled program.

Kernels, each replacing a Pallas TPU kernel of the JAX package:

- ``paged_attention.cuh`` (built as ``paged_attention.cu``,
  ``paged_attention_write.cu`` and ``paged_attention_prefill.cu``, one
  kernel form each), on the CUDA cores for fp32 q (head_dim 16 to 256), or
  bf16 q at head_dim 16, 32 or 64: ``paged_decode_kernel`` (split-KV;
  ``_decode_kernel`` and, as its decode-write form,
  ``_decode_write_kernel``) and ``paged_prefill_kernel``
  (``_prefill_kernel``; each q-tile's keys split over blocks), all of
  ``production_stack_tpu/ops/paged_attention_pallas.py``;
- ``decode_splitkv.cuh`` (built as ``decode_splitkv.cu`` at head_dim 128
  and ``decode_splitkv_hd256.cu`` at 256): ``decode_split_kernel``,
  ``_decode_kernel`` and ``_decode_write_kernel`` for bf16 q (split-KV);
- ``prefill_wgmma.cuh`` (built as ``prefill_wgmma.cu`` and
  ``prefill_wgmma_hd256.cu``): ``paged_prefill_wgmma_kernel``,
  ``_prefill_kernel`` for bf16 q at head_dim 128 and 256 on the tensor
  cores (wgmma), each q-tile's keys split over blocks where the grid
  would not fill the card;
- each attention kernel over a cache in q's type or in e4m3, at 1 to 8
  query heads per kv head;
- ``int4_matmul.cu``: ``int4_wgmma_kernel`` (bf16, prefill rows) and
  ``int4_simt_kernel`` (fp32, small groups; one launch, its splits one
  thread block cluster); ``int4_decode.cu``:
  ``int4_decode_kernel`` (bf16 decode rows, the swapped product on
  mma.sync, split-K merged in the launch); all
  ``production_stack_tpu/ops/int4_matmul.py::_kernel``.

``sm90.cuh`` holds the wgmma, descriptor, cp.async, bulk-copy and barrier
helpers the Hopper kernels share; ``splits.cuh`` the key split and
in-launch merge of the split-KV decodes and both prefills; ``fp8.cuh`` the e4m3
cache's conversions (up to bf16/fp32, and the JAX package's cast down);
``int4_bits.cuh`` the int4 -> bf16 conversion of both bf16 int4 routes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from ..logging_utils import init_logger

logger = init_logger(__name__)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu", "paged_attention_write.cu",
           "paged_attention_prefill.cu", "decode_splitkv.cu",
           "decode_splitkv_hd256.cu", "prefill_wgmma.cu",
           "prefill_wgmma_hd256.cu", "int4_matmul.cu", "int4_decode.cu")
HEADERS = ("paged_attention.cuh", "decode_splitkv.cuh", "prefill_wgmma.cuh",
           "splits.cuh", "fp8.cuh", "sm90.cuh", "int4_bits.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_{ARCH[3:]},code={ARCH}",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Seconds the last build in this process took (0.0 when it was cached).
last_build_seconds = 0.0
# The compile cache's keyed directory (None: BUILD_DIR) and its outcomes.
_cache_dir: Optional[Path] = None
cache_counts = {"hits": 0, "misses": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on the machine with the "
        "GPU (CUDA toolkit on PATH or under /usr/local/cuda)"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def nvcc_version() -> str:
    """``nvcc --version``'s release line, or ``"no nvcc"`` where there is
    none (a machine without the toolkit still resolves its paths)."""
    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, check=True).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return "no nvcc"
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return (lines or out.splitlines() or ["unknown"])[-1].strip()


def compile_cache_key() -> str:
    """The compile cache's directory name: a digest of the kernel sources
    and flags (``_digest``), the nvcc version and the target arch."""
    parts = (f"sources={_digest()}", f"nvcc={nvcc_version()}",
             f"arch={ARCH}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def set_compile_cache_dir(root: Optional[str]) -> Optional[Path]:
    """Build into, and load from, ``<root>/<compile_cache_key()>`` (None:
    ``BUILD_DIR`` again). Takes effect at the first kernel use: a library
    this process already loaded stays loaded. Returns the directory."""
    global _cache_dir
    with _lock:
        _cache_dir = (Path(root) / compile_cache_key()) if root else None
        return _cache_dir


def library_path() -> Path:
    return (_cache_dir or BUILD_DIR) / f"libpst_torch_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources if no library for their hash exists yet.
    ptxas's register/shared-memory report goes to ``build.log`` beside it.
    In the compile cache's directory a load counts as a hit and a build
    as a miss."""
    global last_build_seconds
    out = library_path()
    cached = _cache_dir is not None
    if out.exists():
        last_build_seconds = 0.0
        cache_counts["hits"] += cached
        return out
    cache_counts["misses"] += cached
    build_dir = out.parent
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [build_dir / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = build_dir / f"{tag}.so.tmp"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []  # (command, output, return code)
    for c, p in zip(cmds, procs):
        output, _ = p.communicate()
        logs.append((c, output, p.returncode))
    if all(rc == 0 for *_, rc in logs):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append((link, proc.stdout, proc.returncode))
    last_build_seconds = time.perf_counter() - t0
    text = "".join(" ".join(c) + "\n" + (o or "") for c, o, _ in logs)
    (build_dir / "build.log").write_text(text)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [rc for *_, rc in logs if rc != 0]
    if failed or len(logs) != len(SOURCES) + 1:
        raise RuntimeError(f"nvcc failed ({failed}):\n{text}")
    os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    logger.info("built %s in %.1fs", out.name, last_build_seconds)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call. Every pointer and the
    stream are ``c_void_p``: a bare Python int would be passed as a 32-bit
    C int and cut."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        # Type codes (paged_attention_cuda.DTYPE_CODES): q's, then the
        # cache's.
        lib.pst_paged_decode.argtypes = [
            _I, _I, _P, _P, _P, _P, _P,  # types, q, cache, tables, kv_lens, out
            _P, _P,  # ws, counters
            _I, _I, _I, _I,  # B, H, KH, HD
            _I, _I, _I, _I, _I,  # nb, bs, W, layer, window
            _F, _F, _I, _P,  # scale, softcap, splits, stream
        ]
        lib.pst_paged_decode.restype = _I
        lib.pst_paged_prefill.argtypes = [
            _I, _I, _P, _P, _P, _P, _P, _P,  # types, q, cache, tables, lens, starts, out
            _P, _P,  # ws, counters
            _I, _I, _I, _I, _I,  # B, T, H, KH, HD
            _I, _I, _I, _I, _I,  # nb, bs, W, layer, window
            _F, _F, _I, _P,  # scale, softcap, splits, stream
        ]
        lib.pst_paged_prefill.restype = _I
        lib.pst_paged_prefill_wgmma.argtypes = [
            _I, _P, _P, _P, _P, _P, _P,  # cache type, q, cache, tables, lens, starts, out
            _P, _P,  # ws, counters
            _I, _I, _I, _I, _I,  # B, T, H, KH, HD
            _I, _I, _I, _I, _I,  # nb, bs, W, layer, window
            _F, _F, _I, _P,  # scale, softcap, splits, stream
        ]
        lib.pst_paged_prefill_wgmma.restype = _I
        lib.pst_paged_decode_write.argtypes = [
            _I, _I, _P, _P, _P, _P, _P,  # types, q, cache, k_new, v_new, write_flat
            _P, _P, _P, _P, _P,  # tables, kv_lens, out, ws, counters
            _I, _I, _I, _I,  # B, H, KH, HD
            _I, _I, _I, _I, _I,  # nb, bs, W, layer, window
            _F, _F, _I, _P,  # scale, softcap, splits, stream
        ]
        lib.pst_paged_decode_write.restype = _I
        lib.pst_decode_split.argtypes = [
            _I, _P, _P, _P, _P, _P,  # cache type, q, cache, k_new, v_new, write_flat
            _P, _P, _P, _P, _P,  # tables, kv_lens, out, ws, counters
            _I, _I, _I, _I,  # B, H, KH, HD
            _I, _I, _I, _I, _I,  # nb, bs, W, layer, window
            _F, _F, _I, _P,  # scale, softcap, splits, stream
        ]
        lib.pst_decode_split.restype = _I
        lib.pst_int4_matmul.argtypes = [
            _P, _P, _P,  # x, packed, scales
            _P, _P, _P,  # colmap, out, ws
            _I, _I, _I, _I,  # N, din, dout, G
            _I, _I, _I, _I, _P,  # grid x, grid y, splits, per_split, stream
        ]
        lib.pst_int4_matmul.restype = _I
        lib.pst_int4_simt.argtypes = [
            _I, _P, _P, _P, _P,  # dtype, x, packed, scales, out
            _I, _I, _I, _I, _I, _I,  # N, din, dout, G, cols, kslices
            _I, _I, _I, _I, _P,  # grid x, grid y, splits, per_split, stream
        ]
        lib.pst_int4_simt.restype = _I
        lib.pst_int4_decode.argtypes = [
            _P, _P, _P, _P,  # x, packed, scales, out
            _I, _I, _I, _I, _I, _I,  # N, din, dout, G, n8 tiles, m16 tiles
            _I, _I, _I, _I, _P,  # grid x, grid y, splits, per_split, stream
        ]
        lib.pst_int4_decode.restype = _I
        lib.pst_int4_decode_occupancy.argtypes = [_I, _I, _I, _P]
        lib.pst_int4_decode_occupancy.restype = _I
        _lib = lib
        return lib
