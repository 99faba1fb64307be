"""The port's mixture-of-experts (Mixtral) against the JAX package's.

The same weights (the JAX ``init_params`` of ``tiny-mixtral-debug``,
crossed with ``params_from_jax``) and the same inputs (numpy, seeded) go
through both packages; the JAX references are jitted. Tolerances:

- ``_moe_mlp``, under each name against the JAX form of that name and
  against an independent per-token numpy loop (``moe_oracle``, re-stated
  from ``tests/test_moe.py``): fp32 rtol = atol = 2e-5 (the JAX file's
  own bound); bf16 atol 1e-3 * max|want| (both sum bf16 products in fp32
  in different orders and round the SwiGLU product to bf16 once) and, to
  the fp32 oracle, 2e-2 * max|want|. The experts each token picks equal
  the JAX ``top_k``'s exactly.
- The int8 and int4 forwards on a JAX ``quantize_tree`` output, and the
  paged forward (a prefill chunk, then decode steps) against the JAX
  forward over the whole sequence: the numerics oracle's rule
  (``tests/test_numerics_oracle.py::_agree``: atol 2e-3 * max|logit|,
  rtol 2e-3, argmax equal). The port's names run one body, so ``ragged``
  and ``dense`` give equal logits, bit for bit.
- ``load_hf_params`` on a tiny Mixtral checkpoint written here: every
  leaf equal to the JAX loader's bit for bit, unquantized, int8 and int4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.registry import get_model_config as jax_config
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.convert import params_from_jax

NAME = "tiny-mixtral-debug"
NB, BS = 16, 8
T = 20  # a prefill of 20 tokens crosses pages at BS = 8


def _configs(**kw):
    jcfg = dataclasses.replace(jax_config(NAME), **kw)
    return jcfg, tllama.LlamaConfig(**dataclasses.asdict(jcfg))


def _jax_params(jcfg, seed=0):
    return jllama.Llama(jcfg).init_params(jax.random.PRNGKey(seed))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def moe_oracle(x, lp, num_experts, top_k):
    """Independent per-token reference: softmax router, top-k by sorted
    probability, weights renormalized over the chosen experts, per-expert
    SwiGLU applied in a plain Python loop."""
    x = np.asarray(x, np.float32)
    out = np.zeros_like(x)
    logits = x @ np.asarray(lp["w_router"], np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    for n in range(x.shape[0]):
        ids = np.argsort(-p[n])[:top_k]
        w = p[n][ids]
        w /= w.sum()
        for wi, e in zip(w, ids):
            g = x[n] @ np.asarray(lp["w_gate"], np.float32)[e]
            u = x[n] @ np.asarray(lp["w_up"], np.float32)[e]
            h = (g / (1.0 + np.exp(-g))) * u
            out[n] += wi * (h @ np.asarray(lp["w_down"], np.float32)[e])
    return out


def _agree(got, want, label):
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=2e-3,
                               err_msg=label)
    assert np.array_equal(got.argmax(-1), want.argmax(-1)), label


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax_and_the_oracle(dtype):
    jcfg, tcfg = _configs(dtype=dtype)
    lp = jax.tree.map(lambda a: a[0], _jax_params(jcfg)["layers"])
    tlp = _port(lp)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((13, jcfg.hidden_size)),
                    jnp.float32).astype(jcfg.jdtype)
    xt = _port({"x": x})["x"]

    # The experts each token picks: the JAX router's top_k, exactly.
    probs = jax.nn.softmax(jnp.einsum(
        "nd,de->ne", x.astype(jnp.float32), lp["w_router"].astype(jnp.float32)))
    jw, jids = jax.lax.top_k(probs, jcfg.num_experts_per_tok)
    tw, tids = tllama.moe_route(tcfg, tlp, xt)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(
        jw / jw.sum(-1, keepdims=True)), rtol=1e-6, atol=1e-7)

    oracle = moe_oracle(np.asarray(x.astype(jnp.float32)),
                        jax.tree.map(lambda a: np.asarray(a, np.float32), lp),
                        jcfg.num_experts, jcfg.num_experts_per_tok)
    for impl in ("ragged", "dense"):
        want = np.asarray(jax.jit(
            lambda p, v, impl=impl: jllama._moe_mlp(jcfg, p, v, impl))(lp, x))
        got = tllama._moe_mlp(tcfg, tlp, xt, impl)
        assert got.dtype == torch.float32 and got.shape == xt.shape
        got = got.numpy()
        scale = float(np.abs(want).max())
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)
            np.testing.assert_allclose(got, oracle, rtol=0,
                                       atol=2e-2 * scale)
    with pytest.raises(ValueError, match="moe_impl"):
        tllama._moe_mlp(tcfg, tlp, xt, "sparse")


def _steps(vocab, seed=3):
    """A 20-token prefill chunk (bucket 24: 4 padded tail columns, whose
    writes are dropped) into pages that skip page 0, then 3 decode
    steps; row 1 is a padding row throughout. Returns the steps' numpy
    inputs and the whole sequence's tokens."""
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, NB))[:4].astype(np.int32)
    drop = NB * BS
    tables = np.zeros((2, 4), np.int32)
    tables[0] = pages

    def slot(p):
        return int(pages[p // BS]) * BS + p % BS

    seq = rng.integers(1, vocab, T + 3).astype(np.int32)
    Tb = 24
    tokens = np.zeros((2, Tb), np.int32)
    tokens[0, :T] = seq[:T]
    positions = np.zeros((2, Tb), np.int32)
    positions[0, :T] = np.arange(T)
    positions[0, T:] = T - 1  # the runner's padding contract
    write_idx = np.full((2, Tb), drop, np.int32)
    write_idx[0, :T] = [slot(p) for p in range(T)]
    steps = [(tokens, positions, write_idx, tables,
              np.array([T, 0], np.int32), np.array([T - 1, 0], np.int32))]
    for i in range(3):
        p = T + i
        steps.append((np.array([[seq[p]], [0]], np.int32),
                      np.array([[p], [0]], np.int32),
                      np.array([[slot(p)], [drop]], np.int32), tables,
                      np.array([p + 1, 0], np.int32), np.zeros(2, np.int32)))
    return steps, seq


def _jax_full(jcfg, jparams, seq):
    """The JAX forward over the whole sequence at once: [len, V]."""
    model = jllama.Llama(jcfg)
    n = len(seq)
    pos = jnp.arange(n, dtype=jnp.int32)[None]
    fwd = jax.jit(model.forward,
                  static_argnames=("attn_impl", "all_logits", "moe_impl"))
    logits, _ = fwd(jparams, jnp.asarray(seq)[None], pos, pos,
                    jnp.arange(NB, dtype=jnp.int32)[None],
                    jnp.asarray([n], jnp.int32), jnp.asarray([n - 1], jnp.int32),
                    model.make_kv_cache(NB, BS), attn_impl="gather",
                    all_logits=True, moe_impl="ragged")
    return np.asarray(logits[0])


def _port_paged(tcfg, tparams, steps, impl):
    """The port's forward over ``steps`` on one cache: the prefill's last
    logits, then each decode step's, of row 0 [4, V]."""
    model = tllama.Llama(tcfg)
    cache = model.make_kv_cache(NB, BS, device=torch.device("cpu"))
    out = []
    for step in steps:
        logits, cache = model.forward(
            tparams, *(torch.from_numpy(a) for a in step), cache,
            attn_impl="gather", moe_impl=impl)
        out.append(logits[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_forward_matches_jax(mode):
    """The JAX ``test_quantized_moe_matches_dequantized_reference`` case:
    both packages serve one JAX ``quantize_tree`` output."""
    jcfg, tcfg = _configs()
    q = jllama.quantize_tree(_jax_params(jcfg, seed=9), mode=mode)
    tq = _port(q)
    assert tllama.quant_mode(tq) == mode
    assert tq["layers"]["w_gate"].dim() == 4
    assert "w_router" in tq["layers"] and tq["layers"]["w_router"].dtype \
        == torch.float32
    steps, seq = _steps(jcfg.vocab_size)
    want = _jax_full(jcfg, q, seq)[T - 1:]
    got = _port_paged(tcfg, tq, steps, "auto")
    _agree(got, want, f"mixtral {mode}")


def test_paged_forward_matches_the_jax_full_forward():
    jcfg, tcfg = _configs()
    jparams = _jax_params(jcfg, seed=3)
    tparams = _port(jparams)
    steps, seq = _steps(jcfg.vocab_size)
    want = _jax_full(jcfg, jparams, seq)[T - 1:]
    ragged = _port_paged(tcfg, tparams, steps, "ragged")
    dense = _port_paged(tcfg, tparams, steps, "dense")
    _agree(ragged, want, "ragged paged vs JAX full")
    _agree(dense, want, "dense paged vs JAX full")
    np.testing.assert_array_equal(ragged, dense)


HF_CONFIG = {"model_type": "mixtral", "vocab_size": 256, "hidden_size": 64,
             "intermediate_size": 128, "num_hidden_layers": 2,
             "num_attention_heads": 4, "num_key_value_heads": 2,
             "num_local_experts": 4, "num_experts_per_tok": 2,
             "rms_norm_eps": 1e-5, "rope_theta": 1e6,
             "max_position_embeddings": 512, "eos_token_id": 2,
             "bos_token_id": 1}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_load_hf_params_equals_jax(tmp_path):
    """A Mixtral checkpoint in HF names (``[out, in]``; experts' w1/w3/w2
    in BF16 and F32, the router in F32, norms in F16), loaded by both
    packages unquantized, int8 and int4."""
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIG))
    cfg = tllama.config_from_hf_json(str(tmp_path / "config.json"))
    jcfg = jllama.config_from_hf_json(str(tmp_path / "config.json"))
    assert cfg.num_experts == 4 and jcfg.num_experts == 4
    rng = np.random.default_rng(0)
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(out, inp, dtype=np.float32):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(dtype)

    def norm(n):
        return (1 + 0.1 * rng.standard_normal(n)).astype(np.float16)

    bf16 = ml_dtypes.bfloat16
    t = {"model.embed_tokens.weight": w(V, D, bf16),
         "model.norm.weight": norm(D), "lm_head.weight": w(V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "self_attn.q_proj.weight"] = w(cfg.q_size, D)
        t[p + "self_attn.k_proj.weight"] = w(cfg.kv_size, D, bf16)
        t[p + "self_attn.v_proj.weight"] = w(cfg.kv_size, D, bf16)
        t[p + "self_attn.o_proj.weight"] = w(D, cfg.q_size)
        t[p + "input_layernorm.weight"] = norm(D)
        t[p + "post_attention_layernorm.weight"] = norm(D)
        t[p + "block_sparse_moe.gate.weight"] = w(cfg.num_experts, D)
        for e in range(cfg.num_experts):
            q = p + f"block_sparse_moe.experts.{e}."
            t[q + "w1.weight"] = w(Fi, D, bf16)
            t[q + "w3.weight"] = w(Fi, D)
            t[q + "w2.weight"] = w(D, Fi, bf16)
    save_file(t, str(tmp_path / "model.safetensors"))

    for quantize in (None, "int8", "int4"):
        want = dict(_flat(_port(jllama.load_hf_params(
            jcfg, str(tmp_path), quantize=quantize or False))))
        got = tllama.load_hf_params(cfg, str(tmp_path), quantize=quantize)
        assert tllama.quant_mode(got) == quantize
        got = dict(_flat(got))
        assert sorted(got) == sorted(want), quantize
        assert got["layers.w_gate"].shape[:2] == (cfg.num_layers,
                                                  cfg.num_experts)
        for k, wv in want.items():
            g = got[k]
            assert g.dtype == wv.dtype and g.shape == wv.shape, (quantize, k)
            if g.dtype == torch.bfloat16:
                g, wv = g.view(torch.int16), wv.view(torch.int16)
            assert torch.equal(g, wv), (quantize, k)
