"""The port's kernel plain versions vs the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them (``tests/conftest.py`` sets
``PST_FORCE_PALLAS_INTERPRET``). Each interpret call is slow, so this file
holds one decode case and one prefill case; it is its own file so that
``--dist loadfile`` gives it a worker of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from production_stack_tpu.ops.paged_attention_pallas import (
    pallas_paged_attention,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_attention_decode_plain,
    paged_attention_prefill_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(B, T, starts, kv_lens, H=8, KH=2, hd=32, nb=32, bs=8, W=6, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd), dtype=np.float32)
    kv = rng.standard_normal((1, nb, 2, bs, KH * hd), dtype=np.float32)
    tables = rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32)
    starts = np.asarray(starts, np.int32)
    kv_lens = np.asarray(kv_lens, np.int32)
    q_pos = starts[:, None] + np.arange(T, dtype=np.int32)[None]
    return q, kv, tables, kv_lens, q_pos


# Jitted: the interpreted kernel compiles once into one program instead of
# dispatching op by op, which keeps the suite's CPU time down.
_pallas_jit = jax.jit(pallas_paged_attention, static_argnames=("scale",))


def _pallas(q, kv, tables, kv_lens, q_pos, scale):
    return np.asarray(_pallas_jit(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_pos), scale=scale,
    ))


def test_decode_plain_matches_pallas_decode_kernel():
    # GQA (G=4), lengths ending mid-page (41 crosses a 32-token page), one
    # empty padding row. Large pages keep the interpreted kernels' page-DMA
    # loops short (they unroll 1024 / bs copies a chunk in decode, 512 / bs
    # in prefill).
    q, kv, tables, kv_lens, q_pos = _inputs(
        B=3, T=1, starts=[12, 0, 40], kv_lens=[13, 0, 41], nb=8, bs=32, W=2
    )
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = _pallas(q, kv, tables, kv_lens, q_pos, scale)[:, 0]
    got = paged_attention_decode_plain(
        torch.from_numpy(q[:, 0].copy()), torch.from_numpy(kv),
        torch.from_numpy(tables), torch.from_numpy(kv_lens), 0, scale=scale,
    ).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_prefill_plain_matches_pallas_prefill_kernel():
    # T=16 continuing at start 13: the chunk crosses pages (bs=16) and the
    # kernel's q tile clamps to 16.
    q, kv, tables, kv_lens, q_pos = _inputs(
        B=2, T=16, starts=[13, 0], kv_lens=[29, 16], nb=8, bs=16, W=2, seed=1
    )
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = _pallas(q, kv, tables, kv_lens, q_pos, scale)
    got = paged_attention_prefill_plain(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(tables),
        torch.from_numpy(kv_lens), torch.from_numpy(q_pos[:, 0].copy()), 0,
        scale=scale,
    ).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
