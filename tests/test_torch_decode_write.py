"""The port's fused decode-write plain version vs the JAX package's.

``paged_attention_decode_write_plain`` (the CUDA decode-write kernel's
plain version) writes this step's K/V rows into their page slots, dropping
a slot at or past ``nb*bs``, then decodes. Against the JAX Pallas
``pallas_paged_attention_decode_write`` in interpret mode (the setup of
``tests/test_paged_attention.py::test_decode_write_fused_matches_scatter_then_read``)
and against the JAX scatter followed by ``gather_paged_attention``: the
whole cache, every layer, must be bitwise equal afterwards, and the
attention output must agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from production_stack_tpu.ops.attention import gather_paged_attention
from production_stack_tpu.ops.paged_attention_pallas import (
    pallas_paged_attention_decode_write,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_attention_decode_write_plain,
)

# Jitted: the interpreted kernel compiles once into one program instead of
# dispatching op by op.
_fused_jit = jax.jit(pallas_paged_attention_decode_write,
                     static_argnames=("scale", "softcap"))


def _case(G, lens, W=6, L=2, nb=32, bs=8, KH=2, hd=16, seed=0):
    """fp32 cache, q, this step's rows and their write slots; row 1 drops
    its write (the runner's padding-row slot ``nb*bs``)."""
    rng = np.random.default_rng(seed)
    B, lanes = len(lens), KH * hd
    kv = rng.standard_normal((L, nb, 2, bs, lanes)).astype(np.float32)
    q = rng.standard_normal((B, KH * G, hd)).astype(np.float32)
    # Disjoint per-row pages (the allocator's ownership invariant).
    tables = (np.arange(B * W).reshape(B, W) % nb).astype(np.int32)
    k_new = rng.standard_normal((B, lanes)).astype(np.float32)
    v_new = rng.standard_normal((B, lanes)).astype(np.float32)
    wf = [int(tables[i, (n - 1) // bs]) * bs + (n - 1) % bs
          for i, n in enumerate(lens)]
    wf[1] = nb * bs
    return (q, kv, tables, np.asarray(lens, np.int32), k_new, v_new,
            np.asarray(wf, np.int32))


def _scatter(kv, layer, k_new, v_new, wf):
    """The JAX test's reference write: numpy rows into a copy of the cache."""
    nb, bs = kv.shape[1], kv.shape[3]
    out = kv.copy()
    for i, w in enumerate(wf):
        if w < nb * bs:
            out[layer, w // bs, 0, w % bs] = k_new[i]
            out[layer, w // bs, 1, w % bs] = v_new[i]
    return out


def _port(q, kv, tables, lens, layer, k_new, v_new, wf, **kw):
    cache = torch.from_numpy(kv.copy())
    out = paged_attention_decode_write_plain(
        torch.from_numpy(q), cache, torch.from_numpy(tables),
        torch.from_numpy(lens), layer, torch.from_numpy(k_new),
        torch.from_numpy(v_new), torch.from_numpy(wf), **kw)
    return out.numpy(), cache.numpy()


def test_decode_write_plain_matches_pallas_kernel():
    """GQA G=4, lengths 13 / 1 / 40, the write of row 1 dropped, writes
    into layer 1 (layer 0 must come out untouched)."""
    q, kv, tables, lens, k_new, v_new, wf = _case(G=4, lens=[13, 1, 40])
    layer = 1
    want_out, want_kv = _fused_jit(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), layer, jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(wf), scale=0.25)
    got_out, got_kv = _port(q, kv, tables, lens, layer, k_new, v_new, wf,
                            scale=0.25)
    np.testing.assert_array_equal(got_kv, np.asarray(want_kv))
    np.testing.assert_array_equal(got_kv[0], kv[0])
    assert not np.array_equal(got_kv[1], kv[1])  # the two kept rows landed
    np.testing.assert_allclose(got_out, np.asarray(want_out), rtol=0,
                               atol=1e-5)


def test_decode_write_plain_window_matches_scatter_then_gather():
    """GQA G=8 and a sliding window of 11: the 40-token row sees keys from
    position 29, mid-page; the dropped row 1 reads the cache unwritten."""
    q, kv, tables, lens, k_new, v_new, wf = _case(
        G=8, lens=[13, 30, 40], seed=1)
    layer, window = 0, 11
    ref_kv = _scatter(kv, layer, k_new, v_new, wf)
    want = gather_paged_attention(
        jnp.asarray(q)[:, None], jnp.asarray(ref_kv), jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(lens - 1)[:, None], layer,
        scale=0.25, window=window)[:, 0]
    got_out, got_kv = _port(q, kv, tables, lens, layer, k_new, v_new, wf,
                            scale=0.25, window=window)
    np.testing.assert_array_equal(got_kv, ref_kv)
    np.testing.assert_allclose(got_out, np.asarray(want), rtol=0, atol=1e-5)
