"""Convert a parameter tree given as numpy arrays into the port's tensors.

``params_from_jax(tree)`` takes the JAX package's ``Llama.init_params``
tree after ``np.asarray`` on every leaf (the caller does that; this module
never imports JAX) and returns the same names and layouts as torch
tensors, so both packages can run on identical weights.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses: they cross as their raw 16-bit patterns
(``.view(np.uint16)``) and are reinterpreted as ``torch.bfloat16``. The
int8 weights and fp32 ``*_qs`` / ``*_q4s`` scales of a JAX
``quantize_tree`` output cross as they are.

``bert_params_from_jax(tree)`` does the same for the cross-encoder's tree
(the JAX ``BertClassifier.init_params``, or ``load_hf_bert_params``), whose
nested layer norms keep their nesting.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def tensor_from_numpy(
    a: np.ndarray, device: Optional[torch.device] = None
) -> torch.Tensor:
    # A writable C-ordered copy of its own: torch.from_numpy shares memory,
    # and the arrays of a JAX tree are read-only views.
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def params_from_jax(
    tree: Dict[str, Any], device: Optional[torch.device] = None
) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    return {
        k: params_from_jax(v, device) if isinstance(v, dict)
        else tensor_from_numpy(np.asarray(v), device)
        for k, v in tree.items()
    }


def bert_params_from_jax(
    tree: Dict[str, Any], device: Optional[torch.device] = None
) -> Dict[str, Any]:
    """The JAX ``BertClassifier`` tree (numpy leaves) -> the port's
    ``models/bert.py`` tree: the same names, nesting and layouts."""
    for k in ("word_emb", "pos_emb", "type_emb", "layers", "cls_out_w"):
        if k not in tree:
            raise KeyError(f"not a BertClassifier tree: no {k!r}")
    return params_from_jax(tree, device)
