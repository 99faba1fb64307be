"""LoRA adapters: PEFT checkpoint parsing and the bank's slot registry.

The port of the JAX package's ``engine/lora.py``. Every loaded adapter
lives in the model's stacked bank (``Llama.init_lora_bank``): for each
targeted projection ``t``

    lora_a_<t>  [L, slots, in_dim,  r_max]
    lora_b_<t>  [L, slots, r_max, out_dim]

where slot 0 is all zeros ("no adapter"). A step's rows each gather their
slot, so any mix of adapters serves in one step (one captured graph) with
no merged weights; a rank below ``r_max`` is padded with zeros (exact).

A checkpoint is a local directory in PEFT layout: ``adapter_config.json``
(``r``, ``lora_alpha``) and ``adapter_model.safetensors`` with keys
``...layers.{i}.self_attn.{q,k,v,o}_proj.lora_{A,B}.weight``, A stored
``[r, in]`` and B ``[out, r]``; other target modules are skipped. The
file is read with the port's own reader (``models/safetensors.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..logging_utils import init_logger
from ..models.safetensors import SafetensorsFile

logger = init_logger(__name__)

# HF module name -> the stacked leaf it adapts (llama._HF_LAYER_MAP's).
TARGETS = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
}


@dataclasses.dataclass
class LoadedAdapter:
    name: str
    slot: int
    rank: int
    scaling: float
    path: str


class LoraManager:
    """The host-side slot registry; the runner owns the device bank."""

    def __init__(self, model_cfg, max_loras: int, max_rank: int,
                 adapter_dir: str = "/adapters"):
        self.model_cfg = model_cfg
        self.max_loras = max_loras
        self.max_rank = max_rank
        self.adapter_dir = adapter_dir
        self._adapters: Dict[str, LoadedAdapter] = {}
        self._free_slots: List[int] = list(range(max_loras, 0, -1))  # 1-based
        self._lock = threading.Lock()

    # -- queries -----------------------------------------------------------

    def get(self, name: str) -> Optional[LoadedAdapter]:
        return self._adapters.get(name)

    def list_adapters(self) -> List[LoadedAdapter]:
        # Under the lock: HTTP threads list while the step thread loads.
        with self._lock:
            return sorted(self._adapters.values(), key=lambda a: a.slot)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def bank_shapes(self) -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
        """(A, B) shapes of each target's bank, without the layer axis."""
        cfg = self.model_cfg
        dims = {
            "wq": (cfg.hidden_size, cfg.q_size),
            "wk": (cfg.hidden_size, cfg.kv_size),
            "wv": (cfg.hidden_size, cfg.kv_size),
            "wo": (cfg.q_size, cfg.hidden_size),
        }
        return {t: ((self.max_loras + 1, din, self.max_rank),
                    (self.max_loras + 1, self.max_rank, dout))
                for t, (din, dout) in dims.items()}

    # -- load / unload -----------------------------------------------------

    def resolve_path(self, name: str, path: Optional[str]) -> str:
        return path or os.path.join(self.adapter_dir, name)

    def load(self, name: str, path: Optional[str] = None):
        """Parse a PEFT checkpoint into a free slot: (adapter, {target: (A
        [L, in, r_max], B [L, r_max, out]) float32 numpy}), or (adapter,
        None) when the name is already resident. The caller writes the
        arrays into the bank."""
        with self._lock:
            if name in self._adapters:
                return self._adapters[name], None
            if not self._free_slots:
                raise RuntimeError(
                    f"no free LoRA slots (max_loras={self.max_loras})")
            adapter_path = self.resolve_path(name, path)
            arrays, rank, scaling = self._parse_peft(adapter_path)
            slot = self._free_slots.pop()
            ad = LoadedAdapter(name=name, slot=slot, rank=rank,
                               scaling=scaling, path=adapter_path)
            self._adapters[name] = ad
            logger.info("loaded LoRA %r (rank %d, scaling %.3f) into slot %d",
                        name, rank, scaling, slot)
            return ad, arrays

    def unload(self, name: str) -> Optional[LoadedAdapter]:
        """Remove the name. Its slot is NOT freed here: sequences in flight
        may still read it, and the engine calls :meth:`release_slot` once
        the last of them is done."""
        with self._lock:
            return self._adapters.pop(name, None)

    def release_slot(self, slot: int) -> None:
        with self._lock:
            if slot not in self._free_slots:
                self._free_slots.append(slot)

    # -- PEFT parsing ------------------------------------------------------

    def _parse_peft(self, path: str):
        cfg_path = os.path.join(path, "adapter_config.json")
        st_path = os.path.join(path, "adapter_model.safetensors")
        if not os.path.isfile(cfg_path) or not os.path.isfile(st_path):
            raise FileNotFoundError(
                f"not a PEFT adapter dir (need adapter_config.json + "
                f"adapter_model.safetensors): {path}")
        with open(cfg_path) as f:
            acfg = json.load(f)
        rank = int(acfg.get("r", 8))
        alpha = float(acfg.get("lora_alpha", rank))
        scaling = alpha / rank
        if rank > self.max_rank:
            raise ValueError(
                f"adapter rank {rank} exceeds max_lora_rank={self.max_rank}")

        L = self.model_cfg.num_layers
        arrays = {t: (np.zeros((L,) + a[1:], np.float32),
                      np.zeros((L,) + b[1:], np.float32))
                  for t, (a, b) in self.bank_shapes().items()}
        st = SafetensorsFile(st_path)
        found = 0
        for key in st.keys():
            # ...model.layers.{i}.self_attn.{q_proj}.lora_{A,B}.weight
            parts = key.split(".")
            try:
                li = parts.index("layers")
            except ValueError:
                continue
            layer = int(parts[li + 1])
            module = parts[li + 3] if parts[li + 2] == "self_attn" else None
            if module not in TARGETS or layer >= L:
                continue
            ours = TARGETS[module]
            w = torch.from_numpy(st.get(key))
            if st.dtype(key) == "BF16":
                w = w.view(torch.bfloat16)
            w = w.float().numpy()
            if ".lora_A." in key:  # [r, in]; the forward takes x @ A
                arrays[ours][0][layer, :, : w.shape[0]] = w.T
                found += 1
            elif ".lora_B." in key:  # [out, r]
                arrays[ours][1][layer, : w.shape[1], :] = w.T
                found += 1
        if not found:
            raise ValueError(f"no LoRA tensors for {list(TARGETS)} in {st_path}")
        return arrays, rank, scaling
