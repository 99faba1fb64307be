"""The PyTorch port's Llama forward vs the JAX package's, on the same weights.

``params_from_jax`` converts the JAX ``Llama.init_params`` tree; both
forwards then run one prefill chunk that crosses pages (with a padding row
and padded tail columns whose writes are dropped) followed by three decode
steps on the same cache. Logits must agree under the numerics oracle's
rule (``tests/test_numerics_oracle.py``: atol = 2e-3 * max|logit|,
rtol = 2e-3, argmax equal) and the caches must hold the same rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu.models.registry import get_model_config as jax_config
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama, LlamaConfig

NB, BS = 16, 8


def _variant(**kw):
    cfg = dataclasses.replace(jax_config("tiny-llama-debug"), **kw)
    return cfg, LlamaConfig(**dataclasses.asdict(cfg))


CONFIGS = {
    "tiny-llama-debug": {},
    # GQA with the llama3 rope ramp active well below the sequence length,
    # and Qwen2-style QKV biases.
    "gqa-rope-scaled-bias": dict(
        num_kv_heads=2, rope_scaling_factor=8.0, rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0, rope_original_max_position=16,
        attention_bias=True,
    ),
    # Mistral-style sliding window, passed through to attention.
    "sliding-window": dict(sliding_window=8, sliding_window_pattern=1),
}


def _agree(got, want, label):
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=2e-3,
                               err_msg=label)
    assert np.array_equal(got.argmax(-1), want.argmax(-1)), label


def _jax_params(jmodel, cfg):
    params = jmodel.init_params(jax.random.PRNGKey(0))
    if cfg.attention_bias:  # zero at init: give the biases real values
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            shape = params["layers"][name].shape
            params["layers"][name] = jnp.asarray(
                rng.standard_normal(shape, dtype=np.float32) * 0.5)
    return params


def _steps(seed=0, vocab=512):
    """[(tokens, positions, write_idx, tables, kv_lens, last_idx)] for one
    20-token prefill (bucket 24: 4 padded tail columns) plus three decode
    steps of row 0; row 1 is a padding row throughout. The sequence's pages
    skip page 0 so a drop wrapped into the next layer would show there."""
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, NB))[:4].astype(np.int32)
    drop = NB * BS
    tables = np.zeros((2, 4), np.int32)
    tables[0] = pages

    def slot(p):
        return int(pages[p // BS]) * BS + p % BS

    n, Tb = 20, 24
    tokens = np.zeros((2, Tb), np.int32)
    tokens[0, :n] = rng.integers(1, vocab, n)
    positions = np.zeros((2, Tb), np.int32)
    positions[0, :n] = np.arange(n)
    positions[0, n:] = n - 1  # the runner's padding contract
    write_idx = np.full((2, Tb), drop, np.int32)
    write_idx[0, :n] = [slot(p) for p in range(n)]
    steps = [(tokens, positions, write_idx, tables,
              np.array([n, 0], np.int32), np.array([n - 1, 0], np.int32))]
    for i in range(3):
        p = n + i
        steps.append((
            np.array([[rng.integers(1, vocab)], [0]], np.int32),
            np.array([[p], [0]], np.int32),
            np.array([[slot(p)], [drop]], np.int32),
            tables, np.array([p + 1, 0], np.int32), np.zeros(2, np.int32),
        ))
    return steps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jcfg, tcfg = _variant(**CONFIGS[name], dtype="float32")
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = _jax_params(jmodel, jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))

    jforward = jax.jit(jmodel.forward, static_argnames=("attn_impl",))
    jcache = jmodel.make_kv_cache(NB, BS)
    tcache = tmodel.make_kv_cache(NB, BS, device=torch.device("cpu"))
    for i, step in enumerate(_steps(vocab=jcfg.vocab_size)):
        want, jcache = jforward(
            jparams, *(jnp.asarray(a) for a in step), jcache,
            attn_impl="gather")
        got, tcache = tmodel.forward(
            tparams, *(torch.from_numpy(a) for a in step), tcache,
            attn_impl="gather")
        _agree(got.numpy()[:1], np.asarray(want)[:1], f"{name} step {i}")

    jc, tc = np.asarray(jcache), tcache.numpy()
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
    written = np.abs(jc).sum(axis=(0, 2, 4)) > 0  # [nb, bs] slots in use
    assert written.sum() == 23  # 20 prefill rows + 3 decode rows
    # Dropped writes (padding row, padded tail) land nowhere: page 0 is in
    # no table, so it stays zero in every layer of both caches.
    assert not np.any(tc[:, 0]) and not np.any(jc[:, 0])
    np.testing.assert_array_equal(np.abs(tc).sum(axis=(0, 2, 4)) > 0, written)


def test_forward_bfloat16_near_jax():
    """bf16 weights and cache: the two packages sum in different orders
    and may round intermediate bf16 values at different points, so logits
    are held to 3e-2 * max|logit| and the same slots must
    be written. Logits keep their float32 accumulator in both, so the
    deviation is that of the layers alone."""
    jcfg, tcfg = _variant(dtype="bfloat16")
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jforward = jax.jit(jmodel.forward, static_argnames=("attn_impl",))
    jcache = jmodel.make_kv_cache(NB, BS)
    tcache = tmodel.make_kv_cache(NB, BS, device=torch.device("cpu"))
    for i, step in enumerate(_steps(vocab=jcfg.vocab_size)):
        want, jcache = jforward(
            jparams, *(jnp.asarray(a) for a in step), jcache,
            attn_impl="gather")
        got, tcache = tmodel.forward(
            tparams, *(torch.from_numpy(a) for a in step), tcache,
            attn_impl="gather")
        assert got.dtype == torch.float32
        want = np.asarray(want)[:1]
        np.testing.assert_allclose(got.numpy()[:1], want, rtol=0,
                                   atol=3e-2 * float(np.abs(want).max()),
                                   err_msg=f"bf16 step {i}")
    jc = np.asarray(jcache.astype(jnp.float32))
    tc = tcache.float().numpy()
    np.testing.assert_array_equal(np.abs(tc).sum(axis=(0, 2, 4)) > 0,
                                  np.abs(jc).sum(axis=(0, 2, 4)) > 0)


def test_params_from_jax_bfloat16():
    """bf16 leaves cross as raw bits; shapes, names and values survive."""
    jcfg, tcfg = _variant(dtype="bfloat16", num_layers=1)
    jparams = JaxLlama(jcfg).init_params(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    assert tree["embed"].dtype == ml_dtypes.bfloat16
    got = params_from_jax(tree)
    shapes = Llama(tcfg).param_shapes()
    for key in ("embed", "lm_head", "final_norm"):
        assert got[key].dtype == torch.bfloat16
        assert tuple(got[key].shape) == tuple(shapes[key])
        np.testing.assert_array_equal(
            got[key].float().numpy(), tree[key].astype(np.float32))
    assert set(got["layers"]) == set(shapes["layers"])
    for key, t in got["layers"].items():
        assert tuple(t.shape) == tuple(shapes["layers"][key])
        np.testing.assert_array_equal(
            t.float().numpy(), tree["layers"][key].astype(np.float32))


def test_unported_configs_raise():
    """No architecture knob is refused any more: mixture-of-experts
    (tests/test_torch_moe.py), the Qwen3 and Gemma knobs
    (tests/test_torch_gemma.py) construct; an activation the JAX package
    does not know still raises."""
    base = LlamaConfig(**dataclasses.asdict(jax_config("tiny-llama-debug")))
    for kw in (dict(num_experts=4), dict(qk_norm=True),
               dict(hidden_act="gelu_tanh"), dict(norm_unit_offset=True),
               dict(embed_scale=True), dict(post_block_norms=True)):
        Llama(dataclasses.replace(base, **kw))
    with pytest.raises(ValueError):
        Llama(dataclasses.replace(base, hidden_act="relu"))
