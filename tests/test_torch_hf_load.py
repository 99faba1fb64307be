"""Serving a local HF checkpoint: the port's safetensors reader, its
``config_from_hf_json`` and ``load_hf_params`` against the JAX package's,
and an engine built from a checkpoint directory against the JAX engine
from the same directory.

Checkpoints are written here from a seed: the ``safetensors`` package's
writer (installed on this machine only: the port reads the format with
numpy alone) lays out F32, F16, BF16 and I8 tensors in one file or in
shards with a ``model.safetensors.index.json``. Trees are held leaf for
leaf and bit for bit: bf16 (F32 sources rounded once), int8 and int4
(quantized from the stored values with the numpy loader's division).
"""

import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.registry import get_model_config
from production_stack_tpu_torch.models.safetensors import INDEX_FILE, Checkpoint

BF16 = ml_dtypes.bfloat16


def _write(path, tensors, shards=1):
    """``tensors`` in ``shards`` files (round robin by name) with an index
    when there is more than one."""
    path.mkdir(parents=True, exist_ok=True)
    names = sorted(tensors)
    if shards == 1:
        save_file({k: tensors[k] for k in names},
                  str(path / "model.safetensors"))
        return
    weight_map = {}
    for s in range(shards):
        f = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: tensors[k] for k in names[s::shards]}
        save_file(part, str(path / f))
        weight_map.update({k: f for k in part})
    (path / INDEX_FILE).write_text(json.dumps({"weight_map": weight_map}))


@pytest.mark.parametrize("shards", [1, 3], ids=["one_file", "sharded"])
def test_reader_equals_safetensors_numpy(tmp_path, shards):
    rng = np.random.default_rng(0)
    tensors = {
        "a.f32": rng.standard_normal((3, 5)).astype(np.float32),
        "b.f16": rng.standard_normal((7,)).astype(np.float16),
        "c.bf16": rng.standard_normal((4, 2, 3)).astype(BF16),
        "d.i8": rng.integers(-128, 128, (5, 3)).astype(np.int8),
        "e.scalar": np.asarray(2.5, np.float32),
        "f.odd_bf16": rng.standard_normal((3,)).astype(BF16),
    }
    _write(tmp_path, tensors, shards)
    want = {}
    for f in sorted(tmp_path.glob("*.safetensors")):
        want.update(load_file(str(f)))
    ck = Checkpoint(str(tmp_path))
    assert sorted(ck) == sorted(want) == sorted(tensors)
    for k, w in want.items():
        got = ck.get(k)
        t = ck.tensor(k)
        assert got.shape == w.shape and t.shape == w.shape, k
        if w.dtype == BF16:
            assert got.dtype == np.uint16 and t.dtype == torch.bfloat16
            assert np.array_equal(got, w.view(np.uint16)), k
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert got.dtype == w.dtype and np.array_equal(got, w), k
            assert np.array_equal(t.numpy(), w), k


def _hf_config(model_type):
    cfg = {"model_type": model_type, "vocab_size": 512, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "rms_norm_eps": 1e-6, "max_position_embeddings": 2048,
           "rope_theta": 500000.0, "eos_token_id": [7, 9],
           "bos_token_id": 1, "tie_word_embeddings": False}
    extra = {
        "llama": {"rope_scaling": {
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192}},
        "mistral": {"sliding_window": 64, "eos_token_id": 2},
        "qwen2": {"sliding_window": 64},  # ignored, as by JAX
        "qwen3": {"head_dim": 32},
        "gemma": {"hidden_act": "gelu", "head_dim": 32,
                  "tie_word_embeddings": True},
        "gemma2": {"hidden_activation": "gelu_pytorch_tanh", "head_dim": 32,
                   "query_pre_attn_scalar": 32, "sliding_window": 32,
                   "attn_logit_softcapping": 50.0,
                   "final_logit_softcapping": 30.0,
                   "tie_word_embeddings": True},
    }[model_type]
    cfg.update(extra)
    return cfg


MODEL_TYPES = ("llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2")


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_config_from_hf_json_equals_jax(tmp_path, model_type):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_hf_config(model_type)))
    want = jllama.config_from_hf_json(str(path), name="m")
    got = tllama.config_from_hf_json(str(path), name="m")
    fields = {f for f in got.__dataclass_fields__}
    assert fields <= set(want.__dataclass_fields__)
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    # A directory resolves through its config.json.
    assert get_model_config(str(tmp_path)) == dataclasses.replace(
        got, name=str(tmp_path))


def _checkpoint(path, model_type, seed=0):
    """A tiny checkpoint of ``model_type`` in HF names and ``[out, in]``
    layout: matmul weights in F32 (rounded by the loader) and BF16, norms
    in F16, Qwen2's biases in F32."""
    hf = _hf_config(model_type)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))
    cfg = tllama.config_from_hf_json(str(path / "config.json"))
    rng = np.random.default_rng(seed)
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(out, inp, dtype):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(dtype)

    t = {"model.embed_tokens.weight": w(V, D, BF16),
         "model.norm.weight": (1 + 0.1 * rng.standard_normal(D)).astype(
             np.float16)}
    if not cfg.tie_word_embeddings:
        t["lm_head.weight"] = w(V, D, np.float32)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "self_attn.q_proj.weight"] = w(cfg.q_size, D, np.float32)
        t[p + "self_attn.k_proj.weight"] = w(cfg.kv_size, D, BF16)
        t[p + "self_attn.v_proj.weight"] = w(cfg.kv_size, D, BF16)
        t[p + "self_attn.o_proj.weight"] = w(D, cfg.q_size, np.float32)
        t[p + "mlp.gate_proj.weight"] = w(Fi, D, BF16)
        t[p + "mlp.up_proj.weight"] = w(Fi, D, np.float32)
        t[p + "mlp.down_proj.weight"] = w(D, Fi, BF16)
        norms = ["input_layernorm", "post_attention_layernorm"]
        if cfg.post_block_norms:
            norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
        for n in norms:
            t[p + n + ".weight"] = (1 + 0.1 * rng.standard_normal(D)).astype(
                np.float16)
        if cfg.qk_norm:
            for n in ("q_norm", "k_norm"):
                t[p + f"self_attn.{n}.weight"] = (
                    1 + 0.1 * rng.standard_normal(cfg.head_dim)).astype(BF16)
        if cfg.attention_bias:
            for n, size in (("q", cfg.q_size), ("k", cfg.kv_size),
                            ("v", cfg.kv_size)):
                t[p + f"self_attn.{n}_proj.bias"] = (
                    0.1 * rng.standard_normal(size)).astype(np.float32)
    _write(path, t, shards=2)
    return str(path)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("model_type,quantize", [
    ("llama", None), ("llama", "int8"), ("llama", "int4"),
    ("qwen2", "int8"), ("gemma2", None), ("qwen3", "int4")])
def test_load_hf_params_equals_jax(tmp_path, model_type, quantize):
    path = _checkpoint(tmp_path / "ckpt", model_type)
    jcfg = jllama.config_from_hf_json(f"{path}/config.json")
    tcfg = tllama.config_from_hf_json(f"{path}/config.json")
    want = params_from_jax(jax.tree.map(
        np.asarray, jllama.load_hf_params(jcfg, path, quantize=quantize or False)))
    got = tllama.load_hf_params(tcfg, path, quantize=quantize)
    assert tllama.quant_mode(got) == quantize
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w), k


def test_engine_from_a_checkpoint_dir_equals_the_jax_engine(tmp_path):
    """Both engines from the same directory (no tokenizer files: the byte
    tokenizer), greedy, the port in four-token bursts. A checkpoint
    serves in bf16 in both packages, whose CPU matmuls round differently:
    greedy rows are compared here, and seeded draws (whose Gumbel-max
    choice among the top 40 turns on far smaller differences) are held
    to JAX's in fp32 by ``test_torch_seeded_draw.py``."""
    path = _checkpoint(tmp_path / "ckpt", "llama", seed=3)
    common = dict(model=path, block_size=8, max_prefill_tokens=32,
                  max_model_len=128, num_kv_blocks=64, max_num_seqs=4)
    jeng = JaxLLMEngine(JaxEngineConfig(num_decode_steps=1, **common))
    eng = LLMEngine(EngineConfig(device="cpu", num_decode_steps=4, **common))
    assert eng.model_cfg == tllama.config_from_hf_json(f"{path}/config.json",
                                                       name=path)
    assert eng.tokenizer.decode(eng.tokenizer.encode("hi")) == "hi"
    rng = np.random.default_rng(5)
    prompts = [rng.integers(10, 500, n).tolist() for n in (40, 9)]
    sp = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    want = jeng.generate([list(p) for p in prompts], JaxSamplingParams(**sp))
    got = eng.generate([list(p) for p in prompts], SamplingParams(**sp))
    assert [g["token_ids"] for g in got] == [w["token_ids"] for w in want]
