"""The port's kernel plain versions on an e4m3 cache vs the JAX package's
Pallas kernels in their e4m3 form.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them (``tests/conftest.py`` sets
``PST_FORCE_PALLAS_INTERPRET``), with bf16 q over an e4m3 cache. Each
interpreted call takes seconds, so this file holds one decode, one
decode-write and one prefill case, and is its own file so that
``--dist loadfile`` gives it a worker of its own.

Tolerance. Both sides read the same e4m3 K/V exactly and accumulate Q·Kᵀ
in fp32. The Pallas P·V (``_pv_dot``) rounds P to e4m3 plus a 16x-scaled
e4m3 residual, about 2^-8 of each probability, so its output may differ
from the port's unrounded fp32 P·V by up to 2^-8 · max|V|; either side's
bf16 output rounds once more, 2^-8 relative (rtol).
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
from production_stack_tpu_torch.ops.fp8 import raw

_pallas_jit = jax.jit(pallas_paged_attention, static_argnames=("scale",))
_fused_jit = jax.jit(pallas_paged_attention_decode_write,
                     static_argnames=("scale", "softcap"))
RTOL = 2.0 ** -8


def _inputs(B, T, starts, kv_lens, H=8, KH=2, hd=32, nb=8, bs=32, W=2,
            seed=0):
    """bf16 q [B, T, H, hd] and an e4m3 cache, as numpy arrays of
    ml_dtypes; shuffled tables. Large pages keep the interpreted kernels'
    page-DMA loops short."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(ml_dtypes.bfloat16)
    kv = (rng.standard_normal((1, nb, 2, bs, KH * hd)) * 2).astype(
        ml_dtypes.float8_e4m3fn)
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


def _close(got: torch.Tensor, want, kv):
    v_max = float(np.abs(kv.astype(np.float32)[:, :, 1]).max())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=RTOL, atol=2.0 ** -8 * v_max)


def test_e4m3_decode_plain_matches_pallas():
    # G=4, lengths ending mid-page (41 crosses a page), an empty padding
    # row (zeros in both).
    q, kv, tables, lens, q_pos = _inputs(B=3, T=1, starts=[12, 0, 40],
                                         kv_lens=[13, 0, 41])
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = _pallas_jit(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
                       jnp.asarray(lens), jnp.asarray(q_pos),
                       scale=scale)[:, 0]
    got = paged_attention_decode_plain(
        _torch(q[:, 0]), _torch(kv), _torch(tables), _torch(lens), 0,
        scale=scale)
    assert got.dtype == torch.bfloat16
    _close(got, want, kv)
    assert not got[1].any()


def test_e4m3_decode_write_plain_matches_pallas():
    """bf16 rows cast into the e4m3 cache as they are written: the whole
    cache must come out byte for byte as the Pallas kernel's, a K value
    past e4m3's range (-600: NaN) and a V value (500: NaN) included; row 1
    drops its write. A NaN row stays inside its kv head's outputs in the
    port (as in the gather path); the Pallas kernel applies its head mask
    by multiplication, so there it reaches every head of the sequence:
    the port's NaNs must be a subset of the kernel's, and every output the
    kernel keeps finite must agree."""
    q, kv, tables, lens, _ = _inputs(B=3, T=1, starts=[12, 0, 40],
                                     kv_lens=[13, 5, 41], seed=1)
    rng = np.random.default_rng(2)
    lanes = kv.shape[-1]
    k_new = rng.standard_normal((3, lanes)).astype(ml_dtypes.bfloat16)
    v_new = rng.standard_normal((3, lanes)).astype(ml_dtypes.bfloat16)
    k_new[0, 3] = -600.0
    v_new[2, 40] = 500.0
    nb, bs = kv.shape[1], kv.shape[3]
    wf = np.asarray([int(tables[i, (n - 1) // bs]) * bs + (n - 1) % bs
                     for i, n in enumerate(lens)], np.int32)
    wf[1] = nb * bs
    scale = 1.0 / np.sqrt(q.shape[-1])
    want, want_kv = _fused_jit(
        jnp.asarray(q[:, 0]), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), 0, jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(wf), scale=scale)
    cache = _torch(kv)
    got = paged_attention_decode_write_plain(
        _torch(q[:, 0]), cache, _torch(tables), _torch(lens), 0,
        _torch(k_new), _torch(v_new), _torch(wf), scale=scale)
    want_kv = np.asarray(want_kv)
    np.testing.assert_array_equal(raw(cache).numpy(), want_kv.view(np.uint8))
    assert np.isnan(want_kv.astype(np.float32)).sum() == 2
    got_nan = torch.isnan(got.float()).numpy()
    want_nan = np.isnan(np.asarray(want, np.float32))
    assert got_nan[0].any() and got_nan[2].any() and not got_nan[1].any()
    assert not (got_nan & ~want_nan).any()
    finite = ~want_nan
    v_max = float(np.nanmax(np.abs(kv.astype(np.float32)[:, :, 1])))
    np.testing.assert_allclose(got.float().numpy()[finite],
                               np.asarray(want, np.float32)[finite],
                               rtol=RTOL, atol=2.0 ** -8 * v_max)


def test_e4m3_prefill_plain_matches_pallas():
    # T=16 continuing at start 13 (crosses pages of 16) and a fresh row.
    q, kv, tables, lens, q_pos = _inputs(B=2, T=16, starts=[13, 0],
                                         kv_lens=[29, 16], bs=16, seed=3)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = _pallas_jit(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
                       jnp.asarray(lens), jnp.asarray(q_pos), scale=scale)
    got = paged_attention_prefill_plain(
        _torch(q), _torch(kv), _torch(tables), _torch(lens),
        _torch(q_pos[:, 0]), 0, scale=scale)
    _close(got, want, kv)
