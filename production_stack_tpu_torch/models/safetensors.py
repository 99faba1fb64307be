"""A reader of local safetensors checkpoints, with numpy alone.

A safetensors file is an 8-byte little-endian header length, a JSON
header that gives each tensor's dtype, shape and ``[begin, end)`` byte
offsets into the data that follows, and the raw little-endian buffers.
Each file is memory-mapped (``np.memmap``, copy-on-write, so the arrays
are writable and the file never is): a tensor's bytes are read from disk
when it is copied, not when the file opens. A checkpoint directory with
a ``model.safetensors.index.json`` is read through its ``weight_map``;
one without it, through every ``*.safetensors`` file in it.

``BF16`` buffers are returned as ``uint16`` arrays (numpy has no
bfloat16) and :meth:`Checkpoint.tensor` views them as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List

import numpy as np
import torch

INDEX_FILE = "model.safetensors.index.json"

_NP_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.uint16,  # raw bit patterns; viewed as torch.bfloat16
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U64": np.uint64,
    "U32": np.uint32,
    "U16": np.uint16,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


class SafetensorsFile:
    """One ``.safetensors`` file: its header parsed, its data mapped."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.entries: Dict[str, dict] = header
        size = os.path.getsize(path) - 8 - n
        self._data = (np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
                      if size > 0 else np.zeros(0, np.uint8))

    def keys(self) -> List[str]:
        return list(self.entries)

    def dtype(self, name: str) -> str:
        return self.entries[name]["dtype"]

    def get(self, name: str) -> np.ndarray:
        """The tensor as a numpy array over the mapped file (BF16 as
        uint16)."""
        e = self.entries[name]
        if e["dtype"] not in _NP_DTYPES:
            raise ValueError(f"{name}: unsupported dtype {e['dtype']!r}")
        dt = np.dtype(_NP_DTYPES[e["dtype"]]).newbyteorder("<")
        begin, end = e["data_offsets"]
        arr = self._data[begin:end].view(dt).reshape(e["shape"])
        if arr.ctypes.data % dt.itemsize:
            arr = arr.copy()  # torch.from_numpy needs aligned elements
        return arr


class Checkpoint:
    """The tensors of a checkpoint directory, across its shards."""

    def __init__(self, model_dir: str):
        index = os.path.join(model_dir, INDEX_FILE)
        if os.path.isfile(index):
            with open(index) as f:
                weight_map: Dict[str, str] = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(f for f in os.listdir(model_dir)
                           if f.endswith(".safetensors"))
            weight_map = {}
        if not files:
            raise FileNotFoundError(f"no .safetensors files in {model_dir}")
        self.files = {f: SafetensorsFile(os.path.join(model_dir, f))
                      for f in files}
        self._where: Dict[str, SafetensorsFile] = {}
        for f, st in self.files.items():
            for name in st.keys():
                self._where[name] = st
        for name, f in weight_map.items():
            if name not in self.files[f].entries:
                raise KeyError(f"{INDEX_FILE} maps {name} to {f}, "
                               "which does not hold it")
            self._where[name] = self.files[f]

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def get(self, name: str) -> np.ndarray:
        return self._where[name].get(name)

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor on the host, over the mapped file, in its stored
        type (BF16 viewed as ``torch.bfloat16``)."""
        st = self._where[name]
        t = torch.from_numpy(st.get(name))
        return t.view(torch.bfloat16) if st.dtype(name) == "BF16" else t

