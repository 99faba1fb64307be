"""The PyTorch port's weight-only quantization vs the JAX package's.

- The quantizers (int8 per channel on either axis, group-wise int4 and its
  dequantization) are bit-identical to the compiled JAX ones, and the
  port's quantized random init equals quantizing its bf16 init.
- ``int4_matmul_plain`` (the W4A16 kernel's plain version) agrees with the
  JAX Pallas ``int4_matmul``, run in interpret mode as its own tests run it
  (``tests/conftest.py`` sets ``PST_FORCE_PALLAS_INTERPRET``), and both
  with the float64 truth within 1e-5 of max|ref|.
- The int8 and int4 forwards on a converted JAX ``quantize_tree`` output
  agree with the JAX forward by the numerics oracle's rule, and an int4
  engine gives the JAX int4 engine's greedy tokens on its own weights.
- ``_proj`` adds a bias to the fp32 accumulator before its one rounding, as
  the JAX ``_proj`` does: bitwise equal at bf16.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama
from production_stack_tpu_torch.models.registry import get_model_config
from production_stack_tpu_torch.ops.int4_matmul import (
    dequant_int4,
    int4_matmul_plain,
)
from tests.test_int4_matmul import _truth
from tests.test_torch_model import (
    BS,
    CONFIGS,
    NB,
    _agree,
    _jax_params,
    _steps,
    _variant,
)

# The shapes of tests/test_quantization.py's int4 tests: one 128-row group,
# the group-16 fallback of a tiny contraction dim, and a stacked leaf.
SHAPES = [(256, 32), (3, 48, 16), (2, 256, 24)]


def _bits(a) -> bytes:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.uint16)
    return np.ascontiguousarray(a).tobytes()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_quantizers_bitwise_equal_jax():
    q8 = jax.jit(jllama.quantize_leaf, static_argnums=1)
    q4 = jax.jit(jllama.quantize_leaf_int4)
    deq = jax.jit(jllama.dequant_int4, static_argnums=2)
    rng = np.random.default_rng(0)
    for shape in SHAPES:
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        wt = torch.from_numpy(w)
        for axis in (-2, -1):
            qj, sj = q8(jnp.asarray(w), axis)
            qt, st = tllama.quantize_leaf(wt, axis)
            assert _bits(qj) == _bits(qt.numpy()), (shape, axis)
            assert _bits(sj) == _bits(st.numpy()), (shape, axis)
        qj, sj = q4(jnp.asarray(w))
        qt, st = tllama.quantize_leaf_int4(wt)
        assert qt.shape[-2] * 2 == shape[-2] and st.shape[-2] == shape[-2] // (
            16 if shape[-2] == 48 else 128)
        assert _bits(qj) == _bits(qt.numpy()), shape
        assert _bits(sj) == _bits(st.numpy()), shape
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            got = dequant_int4(qt, st, tdt)
            assert got.dtype == tdt
            assert _bits(deq(qj, sj, jdt)) == _bits(
                got.view(torch.int16).numpy() if tdt == torch.bfloat16
                else got.numpy()), (shape, tdt)

    # The quantized random init is quantize_tree of the plain init from the
    # same generator state, leaf for leaf.
    model = Llama(get_model_config("tiny-llama-debug"))
    for mode in ("int8", "int4"):
        want = tllama.quantize_tree(
            model.init_params(torch.Generator().manual_seed(3),
                              torch.device("cpu")), mode)
        tree = model.init_params(torch.Generator().manual_seed(3),
                                 torch.device("cpu"), quantization=mode)
        assert tllama.quant_mode(tree) == mode
        want, got = dict(_flat(want)), dict(_flat(tree))
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), (mode, k)


def test_int4_matmul_plain_matches_pallas_kernel():
    din, dout, N = 1024, 256, 5
    rng = np.random.default_rng(din + N)
    w = jnp.asarray(rng.normal(size=(din, dout)).astype(np.float32) * 0.02)
    packed, scales = jllama.quantize_leaf_int4(w)
    x = rng.normal(size=(N, din)).astype(np.float32)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), packed, scales))
    got = int4_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(np.array(packed)),
        torch.from_numpy(np.array(scales))).numpy()
    assert got.dtype == np.float32 and got.shape == (N, dout)
    truth = _truth(x, packed, scales)
    tol = 1e-5 * np.abs(truth).max()
    assert np.abs(want - truth).max() < tol
    assert np.abs(got - truth).max() < tol
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_forward_matches_jax(mode):
    """GQA + llama3 rope + biases in float32; one prefill chunk crossing
    pages (padding row, dropped tail writes) and three decode steps."""
    jcfg, tcfg = _variant(**CONFIGS["gqa-rope-scaled-bias"], dtype="float32")
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = _jax_params(jmodel, jcfg)
    # quantize_tree mutates its argument: give it a copy of the tree.
    jparams = jllama.quantize_tree(jax.tree.map(lambda a: a, jparams), mode)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(tree)

    # Every leaf crossed with its name, shape and dtype, its bits intact.
    want, got = dict(_flat(tree)), dict(_flat(tparams))
    assert want.keys() == got.keys()
    for k, a in want.items():
        t = got[k]
        assert tuple(t.shape) == a.shape, k
        assert str(t.dtype) == f"torch.{a.dtype}", k
        assert _bits(a) == _bits(t.numpy()), k
    suffix = "_q4s" if mode == "int4" else "_qs"
    assert got["layers.wq"].dtype == torch.int8 and f"layers.wq{suffix}" in got
    assert got["embed"].dtype == torch.int8 and "embed_qs" in got
    assert tllama.quant_mode(tparams) == mode

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
        _agree(got.numpy()[:1], np.asarray(want)[:1], f"{mode} step {i}")
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               rtol=1e-5, atol=1e-5)


def test_int4_engine_greedy_tokens_match_jax():
    """Both engines serve the JAX runner's own streamed int4 weights; the
    port steps in four-token decode bursts."""
    common = dict(model="tiny-llama-debug", quantization="int4", block_size=8,
                  max_prefill_tokens=32, max_model_len=256, num_kv_blocks=128,
                  max_num_seqs=8)
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        num_decode_steps=1, **common))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    assert tllama.quant_mode(params) == "int4"
    eng = LLMEngine(EngineConfig(device="cpu", num_decode_steps=4, **common),
                    params=params)
    assert eng.runner.params["layers"]["wq"].dtype == torch.int8
    assert eng.runner.param_bytes == sum(
        t.numel() * t.element_size() for _, t in _flat(params))

    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (50, 13, 7)]
    kw = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    want = jeng.generate([list(p) for p in prompts], JaxSamplingParams(**kw))
    got = eng.generate([list(p) for p in prompts], SamplingParams(**kw))
    for w, g in zip(want, got):
        assert g["token_ids"] == w["token_ids"]
        assert len(g["token_ids"]) == 12


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def test_proj_rounds_once_after_bias_like_jax():
    """Small integers times powers of two: every fp32 accumulator is exact
    in any summation order, so the only difference left is where the
    rounding to bf16 happens. Column 0 of row 0 accumulates 257 with bias
    1: bf16(257 + 1) = 258, but bf16(bf16(257) + 1) = 256."""
    rng = np.random.default_rng(5)
    K, N = 16, 64
    x = rng.integers(-4, 5, (3, K)) * 2.0 ** rng.integers(0, 3, (3, K))
    w = rng.integers(-8, 9, (K, N)) * 2.0 ** rng.integers(0, 5, (K, N))
    b = rng.integers(-3, 4, N).astype(np.float64)
    x[0], w[:, 0], b[0] = 0, 0, 1
    x[0, :2], w[:2, 0] = 1, (256, 1)
    x, w, b = _bf16(x), _bf16(w), _bf16(b)
    acc = x.astype(np.float64) @ w.astype(np.float64)
    once = _bf16(acc + b.astype(np.float64))
    twice = _bf16(_bf16(acc).astype(np.float64) + b.astype(np.float64))
    assert once[0, 0] == 258 and twice[0, 0] == 256
    assert (once != twice).sum() >= 1

    q8 = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s8 = (2.0 ** rng.integers(-8, -2, N)).astype(np.float32)
    cases = {"bf16": {"w": w}, "int8": {"w": q8, "w_qs": s8}}
    xt = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    bt = torch.from_numpy(b.view(np.uint16)).view(torch.bfloat16)
    for label, p in cases.items():
        want = jllama._proj(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in p.items()}, "w",
                            jnp.asarray(b))
        got = tllama._proj(xt, params_from_jax(p), "w", bt)
        assert got.dtype == torch.bfloat16, label
        assert _bits(want) == _bits(got.view(torch.int16).numpy()), label
        if label == "bf16":
            assert _bits(want) == _bits(once)
