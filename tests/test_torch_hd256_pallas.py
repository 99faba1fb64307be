"""The port's kernel plain versions at head_dim 256 (gemma-7b, gemma2-9b)
vs the JAX package's Pallas kernels at the same head_dim.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them (``tests/conftest.py`` sets
``PST_FORCE_PALLAS_INTERPRET``). Every case has a sliding window that
starts mid-page and Gemma-2's attention softcap of 50, at gemma2-9b's
scale of 1/16 and G = 2. fp32 cases are held to 2e-5 (the tolerance of
``tests/test_torch_attention_pallas.py``); the e4m3 case to that of
``tests/test_torch_fp8_pallas.py`` (the Pallas P·V rounds P to about
2^-8). Each interpreted call takes seconds, so this file holds four cases
and is its own file, so that ``--dist loadfile`` gives it a worker of its
own.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from production_stack_tpu.ops.paged_attention_pallas import (
    pallas_paged_attention,
    pallas_paged_attention_decode_write,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_attention_decode_plain,
    paged_attention_decode_write_plain,
    paged_attention_prefill_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)
HD, SCALE, SOFTCAP = 256, 1.0 / 16, 50.0
_pallas_jit = jax.jit(pallas_paged_attention,
                      static_argnames=("scale", "softcap"))
_fused_jit = jax.jit(pallas_paged_attention_decode_write,
                     static_argnames=("scale", "softcap"))


def _inputs(B, T, starts, kv_lens, H=4, KH=2, nb=8, bs=32, W=2, seed=0,
            dtype=np.float32):
    """q [B, T, H, 256] and a one-layer cache in ``dtype`` (ml_dtypes for
    bf16/e4m3); shuffled tables. Large pages keep the interpreted kernels'
    page-DMA loops short."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, HD), dtype=np.float32)
    kv = rng.standard_normal((1, nb, 2, bs, KH * HD), dtype=np.float32) * 2
    if dtype != np.float32:
        q, kv = q.astype(ml_dtypes.bfloat16), kv.astype(dtype)
    tables = rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32)
    starts = np.asarray(starts, np.int32)
    q_pos = starts[:, None] + np.arange(T, dtype=np.int32)[None]
    return q, kv, tables, np.asarray(kv_lens, np.int32), q_pos


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 and e4m3 as ml_dtypes) as a torch tensor of the
    same bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _pallas(q, kv, tables, lens, q_pos, window):
    return np.asarray(_pallas_jit(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(q_pos), window=window, scale=SCALE,
        softcap=SOFTCAP), np.float32)


def test_hd256_decode_plain_matches_pallas():
    # G = 2, lengths ending mid-page, a window of 20 starting mid-page in
    # row 2, an empty padding row (zeros in both).
    q, kv, tables, lens, _ = _inputs(B=3, T=1, starts=[0, 0, 0],
                                     kv_lens=[13, 0, 61])
    q_pos = (np.maximum(lens, 1) - 1)[:, None]
    want = _pallas(q, kv, tables, lens, q_pos, 20)[:, 0]
    got = paged_attention_decode_plain(
        _torch(q[:, 0]), _torch(kv), _torch(tables), _torch(lens), 0,
        scale=SCALE, window=20, softcap=SOFTCAP).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1].any()


def test_hd256_decode_write_plain_matches_pallas():
    """Each row writes its last position (row 1 drops its write): the cache
    must come out as the Pallas kernel's, and the outputs agree."""
    q, kv, tables, lens, _ = _inputs(B=3, T=1, starts=[0, 0, 0],
                                     kv_lens=[13, 5, 61], seed=1)
    rng = np.random.default_rng(2)
    lanes = kv.shape[-1]
    k_new = rng.standard_normal((3, lanes), dtype=np.float32)
    v_new = rng.standard_normal((3, lanes), dtype=np.float32)
    nb, bs = kv.shape[1], kv.shape[3]
    wf = np.asarray([int(tables[i, (n - 1) // bs]) * bs + (n - 1) % bs
                     for i, n in enumerate(lens)], np.int32)
    wf[1] = nb * bs
    want, want_kv = _fused_jit(
        jnp.asarray(q[:, 0]), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), 0, jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(wf), window=20, scale=SCALE, softcap=SOFTCAP)
    cache = _torch(kv)
    got = paged_attention_decode_write_plain(
        _torch(q[:, 0]), cache, _torch(tables), _torch(lens), 0,
        _torch(k_new), _torch(v_new), _torch(wf), scale=SCALE, window=20,
        softcap=SOFTCAP)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want_kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hd256_prefill_plain_matches_pallas():
    # T=16 continuing at start 13 (crosses pages of 16) and a fresh row; a
    # window of 10 starts mid-page.
    q, kv, tables, lens, q_pos = _inputs(B=2, T=16, starts=[13, 0],
                                         kv_lens=[29, 16], bs=16, seed=3)
    want = _pallas(q, kv, tables, lens, q_pos, 10)
    got = paged_attention_prefill_plain(
        _torch(q), _torch(kv), _torch(tables), _torch(lens),
        _torch(q_pos[:, 0]), 0, scale=SCALE, window=10,
        softcap=SOFTCAP).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_hd256_e4m3_prefill_plain_matches_pallas():
    """bf16 q over an e4m3 cache. Both sides read the same e4m3 K/V exactly
    and accumulate Q·Kᵀ in fp32; the Pallas P·V rounds P to about 2^-8 and
    either bf16 output rounds once more (2^-8 relative)."""
    q, kv, tables, lens, q_pos = _inputs(
        B=2, T=16, starts=[13, 0], kv_lens=[29, 16], bs=16, seed=4,
        dtype=ml_dtypes.float8_e4m3fn)
    want = _pallas(q, kv, tables, lens, q_pos, 10)
    got = paged_attention_prefill_plain(
        _torch(q), _torch(kv), _torch(tables), _torch(lens),
        _torch(q_pos[:, 0]), 0, scale=SCALE, window=10, softcap=SOFTCAP)
    assert got.dtype == torch.bfloat16
    v_max = float(np.abs(kv.astype(np.float32)[:, :, 1]).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                               atol=2.0 ** -8 * v_max)
