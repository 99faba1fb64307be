"""The embedding path (``Llama.encode``) of the PyTorch port against the
JAX package's.

The same weights (a JAX ``init_params`` tree, quantized by the JAX
``quantize_tree`` for int8 and int4, converted by ``params_from_jax``)
and the same prompts, made with numpy, go through both encodes: the four
tiny families (Llama; Gemma's embed scale and unit-offset norms;
Gemma-2's softcap, post-block norms and a window of 16 inside 32
positions; Qwen3's qk norm), and Llama with int8 and int4 weights (JAX's
int4 through its Pallas kernel in interpret mode, as its own tests run
it; the port's through the kernel's plain version).

Each case runs in fp32, the presets' dtype, and in bf16. In fp32 the
vectors agree under ``_agree``'s numeric rule (atol 2e-3 * max|want|,
rtol 2e-3). In bf16 they are held to the repo's bf16 rule, 3e-2 *
max|want| (``test_torch_model.test_forward_bfloat16_near_jax``): XLA's
CPU and PyTorch compute tanh, exp and rsqrt to different last fp32 bits,
so now and then one bf16 rounding flips and moves a vector past
``_agree``'s rule (up to 2.8 times it over six prompt seeds on
tiny-gemma2-debug). The JAX reference is compiled with
``xla_allow_excess_precision`` off, so that it rounds each bf16 value
where the program says as the port does, and at backend optimization
level 0, which compiles it in a tenth of the time.

A prompt padded into a longer bucket gives its exact-length vector, and
the attention's blocks of query rows (``ENCODE_SCORE_BYTES``) give the
one-block result.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu.models.llama import quantize_tree as jax_quantize
from production_stack_tpu.models.registry import (
    get_model_config as jax_model_config,
)
from production_stack_tpu_torch.models import llama as llama_mod
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama
from production_stack_tpu_torch.models.registry import get_model_config

CASES = [("tiny-llama-debug", None), ("tiny-gemma-debug", None),
         ("tiny-gemma2-debug", None), ("tiny-qwen3-debug", None),
         ("tiny-llama-debug", "int8"), ("tiny-llama-debug", "int4")]
T = 32
LENGTHS = (T, 19, 1)
# The tolerance of each dtype: _agree's numeric rule in fp32, the repo's
# bf16 rule in bf16 (see above).
RULES = {"float32": (2e-3, 2e-3), "bfloat16": (0.0, 3e-2)}


def reference(fn, *args):
    """``fn(*args)`` compiled with bf16 values rounded where written."""
    compiled = jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False,
        "xla_backend_optimization_level": 0})
    return np.asarray(compiled(*args))


def agree(got, want, label, dtype="float32"):
    rtol, atol = RULES[dtype]
    assert got.shape == want.shape, label
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * float(np.abs(want).max()),
        err_msg=label)


@pytest.mark.parametrize("name,quant", CASES,
                         ids=[f"{n}-{q or 'dense'}" for n, q in CASES])
def test_encode_matches_jax(name, quant):
    rng = np.random.default_rng(len(name))
    tokens = rng.integers(1, 512, (len(LENGTHS), T)).astype(np.int32)
    lengths = np.array(LENGTHS, np.int32)
    for dtype in RULES:
        jcfg = dataclasses.replace(jax_model_config(name), dtype=dtype)
        tcfg = dataclasses.replace(get_model_config(name), dtype=dtype)
        jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
        jparams = jmodel.init_params(jax.random.PRNGKey(0))
        if quant:
            jparams = jax_quantize(jax.tree.map(lambda a: a, jparams), quant)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
        label = f"{name} {quant or 'dense'} {dtype}"
        want = reference(jmodel.encode, jparams, tokens, lengths)
        got = tmodel.encode(tparams, torch.from_numpy(tokens),
                            torch.from_numpy(lengths))
        assert got.dtype == torch.float32
        got = got.numpy()
        agree(got, want, label, dtype)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)
        # Query rows in blocks of 8 (scores of 8 x 32 fp32 a head).
        heads = tcfg.num_heads * len(LENGTHS)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(llama_mod, "ENCODE_SCORE_BYTES", 8 * T * 4 * heads)
            blocked = tmodel.encode(tparams, torch.from_numpy(tokens),
                                    torch.from_numpy(lengths)).numpy()
        agree(blocked, got, f"{label} in query blocks of 8", dtype)
        # The 19-token row alone, at its exact length, its own bucket.
        exact = tmodel.encode(tparams, torch.from_numpy(tokens[1:2, :19]),
                              torch.tensor([19])).numpy()
        agree(exact[0], got[1], f"{label}: padded against exact length",
              dtype)
