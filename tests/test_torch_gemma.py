"""The Gemma, Gemma-2 and Qwen3 families: the port's forward vs the JAX
package's, on the same weights.

``params_from_jax`` converts the JAX ``Llama.init_params`` tree, whose norm
weights (``(1 + w)`` norms, Gemma-2's post-block norms, Qwen3's q/k norms)
are first moved off 1 so that every norm weighs in; both forwards then
run the chunked prefill and three decode steps of
``tests/test_torch_model.py`` (a 20-token prompt: the tiny Gemma-2
window of 16 cuts keys on its local layers). Logits agree under the
numerics oracle's rule (``_agree``); in fp32 the caches hold the same rows
(``_same_cache``). One case runs Gemma-2's knobs at head_dim 256; one tiny
Gemma-2 engine answers a completion through the port's server with the
tokens the JAX forward decodes greedily.
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu.models.registry import get_model_config as jax_config
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama, LlamaConfig
from production_stack_tpu_torch.models.registry import get_model_config

from .test_torch_model import BS, NB, _agree, _steps


def _configs(name, **kw):
    jcfg = dataclasses.replace(jax_config(name), **kw)
    return jcfg, LlamaConfig(**dataclasses.asdict(jcfg))


def _jax_params(jmodel, seed=1):
    """``init_params`` with every norm weight moved off 1 by N(0, 0.1)."""
    params = jmodel.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    for tree in (params, params["layers"]):
        for name, w in tree.items():
            if "norm" in name:
                noise = rng.standard_normal(w.shape).astype(np.float32) * 0.1
                tree[name] = (w.astype(jnp.float32) + noise).astype(w.dtype)
    return params


def _run_both(jcfg, tcfg):
    """Logits of every step through both forwards (gather paths), and
    both caches as fp32 numpy arrays."""
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = _jax_params(jmodel)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(tparams["layers"]) == set(tmodel.param_shapes()["layers"])
    for name in ("q_norm", "k_norm", "post_attn_norm", "post_mlp_norm"):
        if name in jparams["layers"]:  # the families' new leaves, bit for bit
            got = tparams["layers"][name]
            assert got.dtype == tcfg.torch_dtype
            np.testing.assert_array_equal(
                got.float().numpy(),
                np.asarray(jparams["layers"][name].astype(jnp.float32)))
    jforward = jax.jit(jmodel.forward, static_argnames=("attn_impl",))
    jcache = jmodel.make_kv_cache(NB, BS)
    tcache = tmodel.make_kv_cache(NB, BS, device=torch.device("cpu"))
    logits = []
    for step in _steps(vocab=jcfg.vocab_size):
        want, jcache = jforward(
            jparams, *(jnp.asarray(a) for a in step), jcache,
            attn_impl="gather")
        got, tcache = tmodel.forward(
            tparams, *(torch.from_numpy(a) for a in step), tcache,
            attn_impl="gather")
        assert got.dtype == torch.float32
        logits.append((got.numpy()[:1], np.asarray(want)[:1]))
    return (logits, tcache.float().numpy(),
            np.asarray(jcache.astype(jnp.float32)))


def _same_cache(tc, jc):
    """fp32 caches: the K/V rows of later layers come out of a residual
    stream that the sqrt(D) embedding scale makes about 11x larger than
    Llama's, so they are held to 1e-5 of the cache's largest magnitude
    (a few fp32 roundings of the stream), not to a fixed 1e-5."""
    np.testing.assert_allclose(tc, jc, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jc).max()))


@pytest.mark.parametrize("name", ["tiny-gemma-debug", "tiny-gemma2-debug",
                                  "tiny-qwen3-debug"])
def test_family_forward_matches_jax(name):
    jcfg, tcfg = _configs(name, dtype="float32")
    logits, tc, jc = _run_both(jcfg, tcfg)
    for i, (got, want) in enumerate(logits):
        _agree(got, want, f"{name} step {i}")
    _same_cache(tc, jc)


def test_gemma2_bfloat16_near_jax():
    """bf16 weights and cache: the packages round intermediate bf16 values
    at different points, so logits are held to 3e-2 * max|logit| (as
    ``test_torch_model.test_forward_bfloat16_near_jax``) and the same
    slots must be written."""
    jcfg, tcfg = _configs("tiny-gemma2-debug", dtype="bfloat16")
    logits, tc, jc = _run_both(jcfg, tcfg)
    for i, (got, want) in enumerate(logits):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * float(np.abs(want).max()),
                                   err_msg=f"bf16 step {i}")
    np.testing.assert_array_equal(np.abs(tc).sum(axis=(0, 2, 4)) > 0,
                                  np.abs(jc).sum(axis=(0, 2, 4)) > 0)


def test_gemma2_head_dim_256_matches_jax():
    """Gemma-2's knobs at gemma2-9b's head_dim 256 and scale 1/16 (H 4 over
    KH 2, 2 layers, a window of 8 inside the 20-token prompt)."""
    jcfg, tcfg = _configs("tiny-gemma2-debug", num_heads=4, num_kv_heads=2,
                          head_dim=256, num_layers=2, sliding_window=8,
                          query_pre_attn_scalar=256.0, dtype="float32")
    assert tcfg.attn_scale == 1 / 16
    # gemma2-9b's page: 42 layers x K and V x 8 kv heads x 256 dims, 344,064
    # bytes a token in bf16 (half in e4m3).
    big = Llama(get_model_config("gemma2-9b"))
    for dtype, per_token in ((None, 344_064), (torch.float8_e4m3fn, 172_032)):
        page = big.make_kv_cache(1, BS, dtype=dtype,
                                 device=torch.device("meta"))
        assert page.numel() * page.element_size() == BS * per_token
    logits, tc, jc = _run_both(jcfg, tcfg)
    for i, (got, want) in enumerate(logits):
        _agree(got, want, f"hd 256 step {i}")
    _same_cache(tc, jc)


def test_gemma2_engine_serves_the_jax_greedy_tokens():
    """A tiny Gemma-2 engine on the CPU, serving the converted JAX weights
    through the port's server: a completion of 8 tokens is the engine's own
    greedy run, which is the JAX forward's argmax token by token."""
    jcfg, tcfg = _configs("tiny-gemma2-debug", dtype="float32")
    jmodel = JaxLlama(jcfg)
    jparams = _jax_params(jmodel)
    prompt = "Gemma-2 on the port."
    cfg = EngineConfig(model="tiny-gemma2-debug", device="cpu", block_size=8,
                       max_model_len=128, num_kv_blocks=32,
                       max_prefill_tokens=16)
    engine = AsyncLLMEngine(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    expected = engine.engine.generate([prompt], SamplingParams(
        max_tokens=8, temperature=0.0, ignore_eos=True))[0]

    # The JAX forward's greedy tokens: the prompt in one chunk, then one
    # token a step, on a cache of its own.
    ids = [b + 1 for b in prompt.encode()]
    n = len(ids)
    W = -(-(n + 8) // BS)
    tables = np.arange(W, dtype=np.int32)[None]
    jforward = jax.jit(jmodel.forward, static_argnames=("attn_impl",))
    jcache = jmodel.make_kv_cache(W + 1, BS)
    toks = ids
    pos = list(range(n))
    greedy = []
    for _ in range(8):
        L = len(pos)
        logits, jcache = jforward(
            jparams, jnp.asarray([toks], jnp.int32),
            jnp.asarray([pos], jnp.int32), jnp.asarray([pos], jnp.int32),
            jnp.asarray(tables),
            jnp.asarray([pos[-1] + 1], jnp.int32),
            jnp.asarray([L - 1], jnp.int32), jcache, attn_impl="gather")
        greedy.append(int(np.argmax(np.asarray(logits)[0])))
        toks, pos = [greedy[-1]], [pos[-1] + 1]
    assert expected["token_ids"] == greedy

    server, thread = serve_in_thread(engine)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1], timeout=60)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": 8, "temperature": 0.0,
             "ignore_eos": True}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    assert resp.status == 200
    assert out["choices"][0]["text"] == expected["text"]
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["usage"]["completion_tokens"] == 8
