"""Cross-encoder scoring for ``/rerank`` and ``/score``.

The port of the JAX package's ``engine/cross_encoder.py``: wraps
:class:`production_stack_tpu_torch.models.bert.BertClassifier` with pair
tokenization and batching. Pairs are padded into pow-2 (B, T) buckets
with ``pad_token_id``, as the JAX module pads them for its compiled
programs; here they bound the shapes a dispatch can take. Enabled by the
engine server's ``--scoring-model`` (a preset, drawn from a generator
seeded 0, or a local HF checkpoint directory).

The encoder has its own weights and runs on its own CUDA stream, on the
HTTP thread that asks: it never touches the engine's step thread, its
captures or its stream. One dispatch runs at a time, under a lock.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.bert import BertClassifier, get_bert_config, load_hf_bert_params
from .config import resolve_device
from .runner import _pow2, _to_device
from .tokenizer import get_tokenizer



class CrossEncoder:
    """Jointly scores (query, document) pairs with a classification head.
    ``params`` (a tree of ``models/bert.py``'s layout, for instance
    ``bert_params_from_jax``'s) replaces the preset's random weights."""

    def __init__(self, model: str, max_len: int = 512, max_batch: int = 32,
                 device: str = "cuda",
                 params: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        self.cfg = get_bert_config(model)
        self.model = BertClassifier(self.cfg)
        self.max_len = min(
            max_len,
            self.cfg.max_position_embeddings - self.cfg.position_offset,
        )
        self.max_batch = max_batch
        local = os.path.isdir(model)
        if params is not None:
            self.params = _to_device(params, self.device)
        elif local:
            self.params = load_hf_bert_params(self.cfg, model, self.device)
        else:  # preset: random weights (tests, the chip smoke)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            self.params = self.model.init_params(gen, self.device)
        self.tokenizer = get_tokenizer(model if local else None,
                                       self.cfg.vocab_size)
        self._stream = None
        if self.device.type == "cuda":
            # The weights were written on this thread's stream; the
            # dispatches read them from their own.
            torch.cuda.synchronize(self.device)
            self._stream = torch.cuda.Stream(self.device)
        self._lock = threading.Lock()  # one scoring dispatch at a time

    def score_pairs(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        """Relevance logits for each (query, document) pair."""
        out: List[float] = []
        for i in range(0, len(pairs), self.max_batch):
            out.extend(self._score_chunk(pairs[i : i + self.max_batch]))
        return out

    def _score_chunk(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        encoded = [self.tokenizer.encode_pair(a, b, max_len=self.max_len)
                   for a, b in pairs]
        B = len(encoded)
        Bb = _pow2(B, self.max_batch)
        Tb = _pow2(max(len(x) for x, _ in encoded), self.max_len)
        tokens = np.full((Bb, Tb), self.cfg.pad_token_id, np.int32)
        type_ids = np.zeros((Bb, Tb), np.int32)
        lengths = np.zeros(Bb, np.int32)
        for i, (x, ty) in enumerate(encoded):
            x = [min(t, self.cfg.vocab_size - 1) for t in x]
            tokens[i, : len(x)] = x
            type_ids[i, : len(ty)] = ty
            lengths[i] = len(x)
        with self._lock, _on(self._stream):
            scores = self.model.forward(
                self.params, *(torch.from_numpy(a).to(self.device)
                               for a in (tokens, lengths, type_ids)))
            scores = scores.cpu().numpy()
        return [float(s) for s in scores[:B]]


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing on the CPU."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(
        stream)
