"""The port's engine and server on ``tiny-mixtral-debug`` against the JAX
package's, and the mixture-of-experts step's fixed shapes.

- ``LLMEngine``, greedy, on the JAX runner's own weights (fp32, on the
  CPU): tokens equal to the JAX engine's for prompts of three lengths,
  under ``moe_impl`` ``auto`` and ``dense`` in both engines; the port
  steps in four-token decode bursts and its runner resolves ``auto`` to
  ``ragged`` as the JAX runner does on one device.
- ``/v1/embeddings`` of the port's server (``--moe-impl`` from its own
  parser) against the JAX ``Llama.encode`` on the same weights: the
  numerics oracle's numeric rule (atol 2e-3 * max|want|, rtol 2e-3).
- The forward with experts, under each name, unquantized, int8 and int4,
  runs on the ``meta`` device: no operation needs a value on the host
  (``.item()``, ``bincount``, a boolean mask, ``repeat_interleave``
  without ``output_size`` raise there), which is what a CUDA graph's
  capture needs; a form sized from the routing fails the same check.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu.models.registry import get_model_config as jax_config
from production_stack_tpu_torch.engine import server as port_server
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import serve_in_thread
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.registry import get_model_config

MODEL = "tiny-mixtral-debug"
COMMON = dict(model=MODEL, block_size=8, max_prefill_tokens=32,
              max_model_len=256, num_kv_blocks=128, max_num_seqs=8)


@pytest.mark.parametrize("impl", ["auto", "dense"])
def test_engine_greedy_tokens_match_jax(impl):
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather", moe_impl=impl,
                                        num_decode_steps=1, **COMMON))
    assert jeng.runner._moe_impl == ("ragged" if impl == "auto" else impl)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    eng = LLMEngine(EngineConfig(device="cpu", moe_impl=impl,
                                 num_decode_steps=4, **COMMON), params=params)
    assert eng.runner.moe_impl == jeng.runner._moe_impl
    assert eng.runner.params["layers"]["w_gate"].dim() == 4

    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (50, 13, 7)]
    kw = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    want = jeng.generate([list(p) for p in prompts], JaxSamplingParams(**kw))
    got = eng.generate([list(p) for p in prompts], SamplingParams(**kw))
    for w, g in zip(want, got):
        assert len(g["token_ids"]) == 12
        assert g["token_ids"] == w["token_ids"]


def test_embeddings_route_matches_jax_encode():
    argv = ["--model", MODEL, "--device", "cpu", "--moe-impl", "dense",
            "--block-size", "8", "--num-kv-blocks", "64",
            "--max-model-len", "64", "--max-num-seqs", "4",
            "--max-num-batched-tokens", "32"]
    cfg = port_server.engine_config_from_args(
        port_server.parse_engine_args(argv))
    assert cfg.moe_impl == "dense"
    jmodel = JaxLlama(jax_config(MODEL))
    jparams = jmodel.init_params(jax.random.PRNGKey(5))
    engine = AsyncLLMEngine(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    assert engine.engine.runner.moe_impl == "dense"
    server, thread = serve_in_thread(engine)
    ids = [list(range(40, 52)), list(range(300, 309))]
    try:
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.server_address[1], timeout=60)
        conn.request("POST", "/v1/embeddings",
                     json.dumps({"model": MODEL, "input": ids}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    assert resp.status == 200, body
    got = np.asarray([d["embedding"] for d in body["data"]], np.float32)
    encode = jax.jit(jmodel.encode, static_argnames=("moe_impl",))
    for row, toks in zip(got, ids):
        want = np.asarray(encode(jparams, jnp.asarray([toks], jnp.int32),
                                 jnp.asarray([len(toks)], jnp.int32),
                                 moe_impl="dense"))[0]
        np.testing.assert_allclose(row, want, rtol=2e-3,
                                   atol=2e-3 * float(np.abs(want).max()))


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else v.to("meta")
            for k, v in tree.items()}


@pytest.mark.parametrize("quantization", [None, "int8", "int4"])
def test_moe_forward_needs_no_value_on_the_host(quantization):
    cfg = get_model_config(MODEL)
    model = tllama.Llama(cfg)
    params = _meta(model.init_params(torch.Generator().manual_seed(0),
                                     torch.device("cpu"),
                                     quantization=quantization))
    meta = torch.device("meta")
    cache = model.make_kv_cache(16, 8, device=meta)
    for B, T in ((4, 1), (1, 24)):  # a decode step, a prefill chunk
        i32 = dict(dtype=torch.int32, device=meta)
        batch = [torch.empty((B, T), **i32) for _ in range(3)] + [
            torch.empty((B, 4), **i32), torch.empty(B, **i32),
            torch.empty(B, **i32)]
        for impl in tllama.MOE_IMPLS:
            logits, _ = model.forward(params, *batch, cache,
                                      attn_impl="gather", moe_impl=impl)
            assert logits.shape == (B, cfg.vocab_size)
            assert logits.device == meta
    # The control: group sizes read on the host (a bincount) fail here.
    with pytest.raises(NotImplementedError):
        torch.bincount(torch.empty(8, dtype=torch.long, device=meta),
                       minlength=cfg.num_experts)
