"""BERT/RoBERTa/XLM-R-family encoder with a sequence-classification head.

The port of the JAX package's ``models/bert.py``: the cross-encoder that
scores (query, document) pairs jointly for ``/rerank`` and ``/score``
(``engine/cross_encoder.py``, the server's ``--scoring-model``). Layouts
are the JAX package's, so the two run on the same weights
(``models/convert.py::bert_params_from_jax``):

- params: a plain dict; per-layer weights stacked on a leading axis,
  dense weights ``[L, in, out]``, the two layer norms of a layer nested as
  ``{"w", "b"}``;
- a forward over ``[B, T]`` padded pairs with their valid ``lengths``:
  embeddings (word + position from ``position_offset`` + segment type),
  then per layer bidirectional attention masked to the valid keys, a
  residual layer norm, the exact-GELU MLP and a second residual layer
  norm; the RoBERTa head (dense + tanh on the first token, then the label
  projection).

Layer norms run in fp32 and cast back; the attention products keep an
fp32 result (``preferred_element_type`` in JAX). They are plain products
(``jnp.einsum`` in the JAX package, outside any Pallas kernel), so the
port writes them with ``torch.bmm``.

Checkpoints: ``bert_config_from_hf`` reads a local ``config.json`` (bert,
roberta or xlm-roberta; more than 2 labels refused) and
``load_hf_bert_params`` its safetensors through the port's own reader
(``models/safetensors.py``), both head layouts included.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..logging_utils import init_logger
from ..ops.int4_matmul import bmm_f32
from .llama import _DTYPES
from .safetensors import Checkpoint

logger = init_logger(__name__)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 250002
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5
    num_labels: int = 1
    # BERT distinguishes segment A (query) from segment B (document) by
    # learned type embeddings; RoBERTa/XLM-R have one type.
    type_vocab_size: int = 1
    # RoBERTa-family position ids start at pad_token_id + 1 (= 2).
    position_offset: int = 2
    pad_token_id: int = 1
    name: str = "bert"
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


BERT_PRESETS: Dict[str, BertConfig] = {
    # Tiny debug encoder for tests (random weights).
    "tiny-bert-debug": BertConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        max_position_embeddings=130,
        type_vocab_size=2,
        name="tiny-bert-debug",
    ),
    # bge-reranker-base shapes (XLM-RoBERTa base, 1-label head).
    "bge-reranker-base": BertConfig(name="bge-reranker-base"),
    # bge-reranker-large shapes (XLM-RoBERTa large).
    "bge-reranker-large": BertConfig(
        hidden_size=1024,
        intermediate_size=4096,
        num_layers=24,
        num_heads=16,
        name="bge-reranker-large",
    ),
}


class BertClassifier:
    """Stateless encoder and classification-head functions bound to a
    config."""

    def __init__(self, cfg: BertConfig):
        self.cfg = cfg

    def init_params(self, generator: torch.Generator,
                    device: torch.device) -> Params:
        """Random init with the JAX package's distributions (layer-norm
        weights 1, biases and type embeddings 0, the rest N(0, 1/fan_in)),
        drawn on ``device`` in the JAX package's leaf order; not its
        values, as the generators differ."""
        cfg = self.cfg
        dtype = cfg.torch_dtype
        D, Fi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

        def dense(shape, fan_in):
            return (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32)
                    / math.sqrt(fan_in)).to(dtype)

        def full(shape, value: float):
            return torch.full(shape, value, dtype=dtype, device=device)

        def ln():
            return {"w": full((L, D), 1.0), "b": full((L, D), 0.0)}

        return {
            "word_emb": dense((cfg.vocab_size, D), D),
            "pos_emb": dense((cfg.max_position_embeddings, D), D),
            "type_emb": full((cfg.type_vocab_size, D), 0.0),
            "emb_ln_w": full((D,), 1.0),
            "emb_ln_b": full((D,), 0.0),
            "layers": {
                "wq": dense((L, D, D), D),
                "bq": full((L, D), 0.0),
                "wk": dense((L, D, D), D),
                "bk": full((L, D), 0.0),
                "wv": dense((L, D, D), D),
                "bv": full((L, D), 0.0),
                "wo": dense((L, D, D), D),
                "bo": full((L, D), 0.0),
                "attn_ln": ln(),
                "w1": dense((L, D, Fi), D),
                "b1": full((L, Fi), 0.0),
                "w2": dense((L, Fi, D), Fi),
                "b2": full((L, D), 0.0),
                "mlp_ln": ln(),
            },
            "cls_dense_w": dense((D, D), D),
            "cls_dense_b": full((D,), 0.0),
            "cls_out_w": dense((D, cfg.num_labels), D),
            "cls_out_b": full((cfg.num_labels,), 0.0),
        }

    @torch.no_grad()
    def forward(
        self,
        params: Params,
        tokens: torch.Tensor,  # [B, T] int (padded with cfg.pad_token_id)
        lengths: torch.Tensor,  # [B] int valid lengths
        type_ids: Optional[torch.Tensor] = None,  # [B, T] segment ids
    ) -> torch.Tensor:
        """Relevance logits [B] float32 (the head's relevance column)."""
        cfg = self.cfg
        B, T = tokens.shape
        H, hd = cfg.num_heads, cfg.head_dim
        dev = tokens.device
        tokens = tokens.long()
        ar = torch.arange(T, device=dev)
        positions = torch.clamp(ar + cfg.position_offset,
                                max=cfg.max_position_embeddings - 1)
        valid = ar[None, :] < lengths.to(dev).long()[:, None]  # [B, T]
        if type_ids is None:
            type_ids = torch.zeros((B, T), dtype=torch.long, device=dev)
        type_ids = torch.clamp(type_ids.long(), max=cfg.type_vocab_size - 1)
        x = (params["word_emb"][tokens] + params["pos_emb"][positions][None]
             + params["type_emb"][type_ids])
        x = _layer_norm(x, params["emb_ln_w"], params["emb_ln_b"],
                        cfg.layer_norm_eps)
        mask = valid[:, None, None, :]  # [B, 1, 1, S]: padding only (bidir)
        layers = params["layers"]

        def heads(t: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B*H, T, hd]
            return t.reshape(B, T, H, hd).transpose(1, 2).reshape(B * H, T, hd)

        for li in range(cfg.num_layers):
            lp = {k: (v[li] if torch.is_tensor(v)
                      else {kk: vv[li] for kk, vv in v.items()})
                  for k, v in layers.items()}
            q = heads(x @ lp["wq"] + lp["bq"])
            k = heads(x @ lp["wk"] + lp["bk"])
            v = heads(x @ lp["wv"] + lp["bv"])
            scores = bmm_f32(q, k.transpose(1, 2)).view(B, H, T, T) \
                / math.sqrt(hd)
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
            probs = torch.softmax(scores, dim=-1)
            attn = bmm_f32(probs.to(v.dtype).view(B * H, T, T), v)
            attn = attn.view(B, H, T, hd).transpose(1, 2).reshape(
                B, T, cfg.hidden_size).to(x.dtype)
            a = attn @ lp["wo"] + lp["bo"]
            x = _layer_norm(x + a, lp["attn_ln"]["w"], lp["attn_ln"]["b"],
                            cfg.layer_norm_eps)
            f = F.gelu((x @ lp["w1"] + lp["b1"]).float(),
                       approximate="none").to(x.dtype)
            f = f @ lp["w2"] + lp["b2"]
            x = _layer_norm(x + f, lp["mlp_ln"]["w"], lp["mlp_ln"]["b"],
                            cfg.layer_norm_eps)
        # RoBERTa classification head: dense + tanh on the first token.
        h = torch.tanh(x[:, 0] @ params["cls_dense_w"] + params["cls_dense_b"])
        logits = h @ params["cls_out_w"] + params["cls_out_b"]
        # A 1-label head scores column 0; a 2-label head puts the positive
        # class at label 1. More labels are refused at config parse.
        col = 1 if cfg.num_labels == 2 else 0
        return logits[:, col].float()


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Layer norm in fp32, cast back to x's dtype (the JAX ``_layer_norm``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)) * w + b).to(x.dtype)


def bert_config_from_hf(config_path: str, name: str = "") -> BertConfig:
    """A :class:`BertConfig` from an HF ``config.json``, field for field as
    the JAX package builds it."""
    with open(config_path) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "")
    if mt not in ("bert", "roberta", "xlm-roberta"):
        raise ValueError(
            f"unsupported scoring model_type {mt!r} (bert/roberta/xlm-roberta)"
        )
    roberta = mt != "bert"
    n_labels = len(hf.get("id2label", {0: ""})) or 1
    if n_labels > 2:
        # A >2-class head has no single relevance column.
        raise ValueError(
            f"scoring model has {n_labels} labels; cross-encoder scoring "
            "supports 1-label (regression) or 2-label (positive=1) heads"
        )
    return BertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        max_position_embeddings=hf["max_position_embeddings"],
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        num_labels=n_labels,
        position_offset=(hf.get("pad_token_id", 1) or 0) + 1 if roberta else 0,
        pad_token_id=hf.get("pad_token_id", 1 if roberta else 0),
        type_vocab_size=hf.get("type_vocab_size", 1),
        name=name or mt,
    )


_HF_LAYER = {
    "wq": "attention.self.query.weight", "bq": "attention.self.query.bias",
    "wk": "attention.self.key.weight", "bk": "attention.self.key.bias",
    "wv": "attention.self.value.weight", "bv": "attention.self.value.bias",
    "wo": "attention.output.dense.weight",
    "bo": "attention.output.dense.bias",
    ("attn_ln", "w"): "attention.output.LayerNorm.weight",
    ("attn_ln", "b"): "attention.output.LayerNorm.bias",
    "w1": "intermediate.dense.weight", "b1": "intermediate.dense.bias",
    "w2": "output.dense.weight", "b2": "output.dense.bias",
    ("mlp_ln", "w"): "output.LayerNorm.weight",
    ("mlp_ln", "b"): "output.LayerNorm.bias",
}


def load_hf_bert_params(cfg: BertConfig, model_dir: str,
                        device: Optional[torch.device] = None) -> Params:
    """The JAX ``load_hf_bert_params`` tree of an HF
    ``...ForSequenceClassification`` checkpoint, read by the port's
    safetensors reader: the ``roberta.``/``bert.``/bare prefixes, and both
    heads (RoBERTa's ``classifier.dense`` + ``classifier.out_proj``, BERT's
    ``bert.pooler.dense`` + bare ``classifier``). Linear weights are stored
    ``[out, in]`` and become ``[in, out]``."""
    ck = Checkpoint(model_dir)
    prefix = next((p for p in ("roberta.", "bert.", "")
                   if f"{p}embeddings.word_embeddings.weight" in ck), "")
    device = torch.device(device or "cpu")
    dtype = cfg.torch_dtype

    def get(name: str) -> torch.Tensor:
        t = ck.tensor(name)
        t = t.T if t.dim() == 2 and not name.endswith("embeddings.weight") \
            else t
        return t.to(device=device, dtype=dtype, copy=True).contiguous()

    layers: Params = {"attn_ln": {}, "mlp_ln": {}}
    for ours, hf_name in _HF_LAYER.items():
        stacked = torch.stack([
            get(f"{prefix}encoder.layer.{i}.{hf_name}")
            for i in range(cfg.num_layers)])
        if isinstance(ours, tuple):
            layers[ours[0]][ours[1]] = stacked
        else:
            layers[ours] = stacked
    if "classifier.dense.weight" in ck:  # RoBERTa head
        head = {"cls_dense_w": get("classifier.dense.weight"),
                "cls_dense_b": get("classifier.dense.bias"),
                "cls_out_w": get("classifier.out_proj.weight"),
                "cls_out_b": get("classifier.out_proj.bias")}
    else:  # BERT head: the pooler's dense + tanh, then the classifier
        head = {"cls_dense_w": get(prefix + "pooler.dense.weight"),
                "cls_dense_b": get(prefix + "pooler.dense.bias"),
                "cls_out_w": get("classifier.weight"),
                "cls_out_b": get("classifier.bias")}
    e = prefix + "embeddings."
    params: Params = {
        "word_emb": get(e + "word_embeddings.weight"),
        "pos_emb": get(e + "position_embeddings.weight"),
        "type_emb": get(e + "token_type_embeddings.weight"),
        "emb_ln_w": get(e + "LayerNorm.weight"),
        "emb_ln_b": get(e + "LayerNorm.bias"),
        "layers": layers,
        **head,
    }
    logger.info("loaded cross-encoder tensors from %s", model_dir)
    return params


def get_bert_config(model: str) -> BertConfig:
    """A preset's config, or a local HF directory's."""
    if model in BERT_PRESETS:
        return BERT_PRESETS[model]
    cfg_path = os.path.join(model, "config.json")
    if os.path.isfile(cfg_path):
        return bert_config_from_hf(cfg_path, name=model)
    raise ValueError(
        f"unknown scoring model {model!r}: not a preset "
        f"({', '.join(sorted(BERT_PRESETS))}) and no local HF dir found"
    )
