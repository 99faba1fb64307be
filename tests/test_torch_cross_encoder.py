"""The cross-encoder of the PyTorch port (``models/bert.py``,
``engine/cross_encoder.py``) against the JAX package's.

On ``tiny-bert-debug`` weights drawn by the JAX ``init_params`` and
converted by ``bert_params_from_jax``, the port's ``BertClassifier``
scores the same padded pairs as the JAX one, segment ids and the
RoBERTa position offset included, within 1e-4 (fp32, as
``tests/test_cross_encoder.py`` holds the JAX one to its numpy oracle);
padding rows and columns leave a pair's score as it was. An HF
checkpoint of each head layout (RoBERTa's ``classifier.dense`` +
``out_proj``, BERT's pooler + ``classifier``) written by the
``safetensors`` package loads through the port's own reader as through
the JAX loader, bit for bit, and scores the same. ``encode_pair`` of the
byte tokenizer equals the JAX one, longest-first truncation included,
and ``CrossEncoder.score_pairs`` equals the JAX cross-encoder's whatever
the batch composition.
"""

import json

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.cross_encoder import (
    CrossEncoder as JaxCrossEncoder,
)
from production_stack_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from production_stack_tpu.models import bert as jbert
from production_stack_tpu_torch.engine.cross_encoder import CrossEncoder
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
from production_stack_tpu_torch.models import bert
from production_stack_tpu_torch.models.convert import bert_params_from_jax

NAME = "tiny-bert-debug"
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_scores_match_jax_and_ignore_padding():
    jmodel = jbert.BertClassifier(jbert.BERT_PRESETS[NAME])
    model = bert.BertClassifier(bert.BERT_PRESETS[NAME])
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    # The type embeddings are zeros at init: give segment 1 its own row.
    jparams["type_emb"] = jax.random.normal(jax.random.PRNGKey(1),
                                            jparams["type_emb"].shape) * 0.1
    params = bert_params_from_jax(_np(jparams))
    rng = np.random.default_rng(0)
    T = 32
    lengths = np.array([32, 17, 9, 1], np.int32)
    tokens = np.full((4, T), 1, np.int32)
    types = np.zeros((4, T), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(2, 500, n)
        types[i, n // 2:n] = 1
    want = np.asarray(jax.jit(jmodel.forward)(jparams, tokens, lengths, types))
    got = model.forward(params, *map(torch.from_numpy,
                                     (tokens, lengths, types)))
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # Row 2 alone in a 16-wide bucket, and among padding rows at 64.
    for B, Tb in ((1, 16), (8, 64)):
        tok = np.full((B, Tb), 1, np.int32)
        ty = np.zeros((B, Tb), np.int32)
        tok[0, :9], ty[0, :9] = tokens[2, :9], types[2, :9]
        lens = np.zeros(B, np.int32)
        lens[0] = 9
        alone = model.forward(params, *map(torch.from_numpy, (tok, lens, ty)))
        np.testing.assert_allclose(alone[0].item(), got[2].item(),
                                   rtol=1e-5, atol=1e-5)


def _checkpoint(tmp_path, head: str):
    """A tiny HF sequence-classification checkpoint: its config and its
    tensors, written by the ``safetensors`` package."""
    from safetensors.numpy import save_file

    roberta = head == "roberta"
    hf = {"model_type": "xlm-roberta" if roberta else "bert",
          "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "max_position_embeddings": 130, "layer_norm_eps": 1e-5,
          "pad_token_id": 1 if roberta else 0, "type_vocab_size": 2,
          "id2label": ({"0": "LABEL_0"} if roberta
                       else {"0": "neg", "1": "pos"})}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    rng = np.random.default_rng(2)
    D, Fi, pre = 64, 128, "roberta." if roberta else "bert."
    t = {pre + "embeddings.word_embeddings.weight": rng.normal(size=(512, D)),
         pre + "embeddings.position_embeddings.weight":
             rng.normal(size=(130, D)),
         pre + "embeddings.token_type_embeddings.weight":
             rng.normal(size=(2, D)),
         pre + "embeddings.LayerNorm.weight": 1 + rng.normal(size=D) * 0.1,
         pre + "embeddings.LayerNorm.bias": rng.normal(size=D) * 0.1}
    labels = 1 if roberta else 2
    if roberta:
        t.update({"classifier.dense.weight": rng.normal(size=(D, D)),
                  "classifier.dense.bias": rng.normal(size=D),
                  "classifier.out_proj.weight": rng.normal(size=(labels, D)),
                  "classifier.out_proj.bias": rng.normal(size=labels)})
    else:
        t.update({pre + "pooler.dense.weight": rng.normal(size=(D, D)),
                  pre + "pooler.dense.bias": rng.normal(size=D),
                  "classifier.weight": rng.normal(size=(labels, D)),
                  "classifier.bias": rng.normal(size=labels)})
    for i in range(2):
        e = f"{pre}encoder.layer.{i}."
        for nm, shape in (
            ("attention.self.query", (D, D)), ("attention.self.key", (D, D)),
            ("attention.self.value", (D, D)),
            ("attention.output.dense", (D, D)),
            ("intermediate.dense", (Fi, D)), ("output.dense", (D, Fi)),
        ):
            t[e + nm + ".weight"] = rng.normal(size=shape) / np.sqrt(shape[1])
            t[e + nm + ".bias"] = rng.normal(size=shape[0]) * 0.1
        for nm in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[e + nm + ".weight"] = 1 + rng.normal(size=D) * 0.1
            t[e + nm + ".bias"] = rng.normal(size=D) * 0.1
    save_file({k: np.asarray(v, np.float32) for k, v in t.items()},
              str(tmp_path / "model.safetensors"))
    return str(tmp_path)


@pytest.mark.parametrize("head", ["roberta", "bert"])
def test_hf_checkpoint_loads_as_the_jax_loader(tmp_path, head):
    path = _checkpoint(tmp_path, head)
    jcfg = jbert.bert_config_from_hf(f"{path}/config.json", name="t")
    cfg = bert.bert_config_from_hf(f"{path}/config.json", name="t")
    assert {k: getattr(cfg, k) for k in cfg.__dataclass_fields__} == {
        k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}
    assert cfg.num_labels == (1 if head == "roberta" else 2)
    want = _np(jbert.load_hf_bert_params(jcfg, path))
    got = bert.load_hf_bert_params(cfg, path)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.numpy(), got)))
    for keys, leaf in flat:
        node = got
        for k in keys:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(keys))
    tokens = np.full((2, 16), cfg.pad_token_id, np.int32)
    tokens[0, :5] = [0, 7, 9, 11, 2]
    tokens[1, :11] = np.arange(20, 31)
    lengths = np.array([5, 11], np.int32)
    jmodel, model = jbert.BertClassifier(jcfg), bert.BertClassifier(cfg)
    np.testing.assert_allclose(
        model.forward(got, *map(torch.from_numpy, (tokens, lengths))).numpy(),
        np.asarray(jmodel.forward(want, tokens, lengths)), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="labels"):
        (tmp_path / "config.json").write_text(json.dumps(
            {"model_type": "bert", "id2label": {"0": 0, "1": 1, "2": 2}}))
        bert.bert_config_from_hf(f"{path}/config.json")


def test_encode_pair_matches_jax():
    ours, ref = ByteTokenizer(), JaxBytes()
    cases = [("what is paged attention", "blocks of keys", None),
             ("q" * 40, "d" * 10, 32), ("q" * 5, "d" * 90, 32),
             ("héllo", "wörld", 8), ("", "", 4), ("ab", "cd", 5)]
    for a, b, max_len in cases:
        got = ours.encode_pair(a, b, max_len=max_len)
        assert got == ref.encode_pair(a, b, max_len=max_len), (a, b, max_len)
        assert 258 in got[0] and len(got[0]) == len(got[1])
        if max_len is not None:
            assert len(got[0]) <= max_len


def test_score_pairs_match_jax_in_any_batch():
    ref = JaxCrossEncoder(NAME, max_len=64, max_batch=4)
    ce = CrossEncoder(NAME, max_len=64, max_batch=4, device="cpu",
                      params=bert_params_from_jax(_np(ref.params)))
    assert ce.max_len == ref.max_len == 64
    pairs = [("what is jax", f"document number {i} " * (i + 1))
             for i in range(6)]
    want = ref.score_pairs(pairs)
    got = ce.score_pairs(pairs)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # Alone, reversed, and beside a long document: the same scores.
    for batch in ([pairs[2]], pairs[::-1], [pairs[3], ("x", "y" * 200)]):
        idx = [pairs.index(p) for p in batch if p in pairs]
        scores = ce.score_pairs(batch)
        np.testing.assert_allclose([scores[batch.index(pairs[i])]
                                    for i in idx],
                                   [got[i] for i in idx], rtol=TOL, atol=TOL)
    # A preset draws its weights from a generator seeded 0: two encoders
    # score alike.
    a = CrossEncoder(NAME, max_len=64, device="cpu").score_pairs(pairs[:2])
    b = CrossEncoder(NAME, max_len=64, device="cpu").score_pairs(pairs[:2])
    assert a == b and all(np.isfinite(a))
