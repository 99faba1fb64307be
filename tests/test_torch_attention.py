"""The PyTorch port's paged attention vs the JAX package's gather oracle.

The same inputs, made from a seed with numpy, go through the JAX
``gather_paged_attention`` and through the port's ``gather_paged_attention``
and the plain versions of its two CUDA kernels
(``paged_attention_decode_plain`` / ``paged_attention_prefill_plain``).
Setups follow ``tests/test_paged_attention.py``; fp32, rtol = atol = 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops.attention import (
    gather_paged_attention as jax_gather,
)
from production_stack_tpu_torch.ops.attention import (
    gather_paged_attention,
    paged_attention,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_prefill,
    paged_attention_prefill_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _pack(k, v):
    # [KH, nb, bs, hd] pair -> stacked combined [L=1, nb, 2, bs, KH*hd]
    KH, nb, bs, hd = k.shape
    fold = lambda x: x.transpose(1, 2, 0, 3).reshape(nb, bs, KH * hd)
    return np.stack([fold(k), fold(v)], axis=1)[None]


def _setup(B, T, starts, H=8, KH=4, hd=32, nb=32, bs=8, W=4, seed=0,
           kv_lens=None):
    """Row b's T queries sit at starts[b] + t; kv_lens default to
    starts + T (the chunk's KV is already written)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd), dtype=np.float32)
    k = rng.standard_normal((KH, nb, bs, hd), dtype=np.float32)
    v = rng.standard_normal((KH, nb, bs, hd), dtype=np.float32)
    tables = rng.permutation(nb)[: B * W].reshape(B, W).astype(np.int32)
    starts = np.asarray(starts, np.int32)
    if kv_lens is None:
        kv_lens = starts + T
    kv_lens = np.asarray(kv_lens, np.int32)
    q_pos = starts[:, None] + np.arange(T, dtype=np.int32)[None]
    return q, _pack(k, v), tables, kv_lens, q_pos


# One compile per case instead of one dispatch per op: keeps the suite's
# CPU time down.
_jax_gather = jax.jit(jax_gather, static_argnames=("scale", "window", "softcap"))


def _jax(q, kv, tables, kv_lens, q_pos, **kw):
    return np.asarray(_jax_gather(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(kv_lens), jnp.asarray(q_pos), **kw,
    ))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = {
    # name: (_setup kwargs, attention kwargs)
    "decode": (dict(B=3, T=1, starts=[4, 31, 18]), {}),
    "fresh_prompt": (dict(B=2, T=16, starts=[0, 0], nb=64, W=8, seed=1), {}),
    "chunk_continuation": (
        dict(B=3, T=8, starts=[0, 13, 40], nb=64, W=8, seed=1), {}),
    "long_context": (
        dict(B=1, T=64, starts=[1472], nb=256, W=192, seed=1), {}),
    "multi_tile": (dict(B=1, T=256, starts=[64], nb=128, W=64, seed=1), {}),
    "odd_t": (dict(B=1, T=192, starts=[0], nb=128, W=32, seed=1), {}),
    "gqa": (dict(B=2, T=12, starts=[3, 20], H=8, KH=2, nb=32, W=6, seed=2), {}),
    # window 11 starts mid-page (bs=8) for every row
    "window_mid_page": (
        dict(B=2, T=10, starts=[17, 30], nb=32, W=6, seed=3), dict(window=11)),
    "decode_window_mid_page": (
        dict(B=3, T=1, starts=[4, 31, 26], seed=4), dict(window=5)),
    "softcap": (
        dict(B=2, T=9, starts=[0, 7], nb=32, W=4, seed=5), dict(softcap=3.0)),
}
# Few test items per file keep pytest-xdist's file scheduling (largest
# files first) of the rest of the suite as it was.
GROUPS = {
    "decode": ("decode", "decode_window_mid_page"),
    "prefill": ("fresh_prompt", "chunk_continuation", "gqa",
                "window_mid_page", "softcap"),
    "long": ("long_context", "multi_tile", "odd_t"),
}


def _check_case(case):
    setup, kw = CASES[case]
    q, kv, tables, kv_lens, q_pos = _setup(**setup)
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = _jax(q, kv, tables, kv_lens, q_pos, scale=scale, **kw)

    tq, tkv, ttab, tlens, tpos = _t(q, kv, tables, kv_lens, q_pos)
    got = gather_paged_attention(tq, tkv, ttab, tlens, tpos, scale=scale, **kw)
    np.testing.assert_allclose(got.numpy(), ref, **TOL, err_msg=case)
    # impl="auto" on a CPU tensor is the gather path
    auto = paged_attention(tq, tkv, ttab, tlens, tpos, scale=scale, **kw)
    np.testing.assert_array_equal(auto.numpy(), got.numpy(), err_msg=case)

    if q.shape[1] == 1:
        plain = paged_attention_decode_plain(
            tq[:, 0], tkv, ttab, tlens, 0, scale=scale, **kw)
        np.testing.assert_allclose(plain.numpy(), ref[:, 0], **TOL,
                                   err_msg=case)
        wrapped = paged_attention_decode(tq[:, 0], tkv, ttab, tlens, 0,
                                         scale=scale, **kw)
    else:
        starts = tpos[:, 0].contiguous()
        plain = paged_attention_prefill_plain(
            tq, tkv, ttab, tlens, starts, 0, scale=scale, **kw)
        np.testing.assert_allclose(plain.numpy(), ref, **TOL, err_msg=case)
        wrapped = paged_attention_prefill(tq, tkv, ttab, tlens, starts, 0,
                                          scale=scale, **kw)
    # On a CPU tensor the kernel wrapper is its plain version.
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy(), err_msg=case)


@pytest.mark.parametrize("group", list(GROUPS))
def test_port_attention_matches_jax_gather(group):
    assert sorted(c for g in GROUPS.values() for c in g) == sorted(CASES)
    for case in GROUPS[group]:
        _check_case(case)


def test_port_attention_empty_rows():
    """kv_len == 0 padding rows: the kernels' plain versions write zeros;
    live rows still match the JAX gather."""
    q, kv, tables, kv_lens, q_pos = _setup(B=3, T=1, starts=[4, 0, 18])
    kv_lens[1] = 0
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = _jax(q, kv, tables, kv_lens, q_pos, scale=scale)
    tq, tkv, ttab, tlens, _ = _t(q, kv, tables, kv_lens, q_pos)
    got = paged_attention_decode_plain(tq[:, 0], tkv, ttab, tlens, 0,
                                       scale=scale).numpy()
    assert np.all(np.isfinite(got))
    assert np.all(got[1] == 0.0)
    np.testing.assert_allclose(got[[0, 2]], ref[[0, 2], 0], **TOL)

    # Prefill batch with a padding row (the runner pads rows with kv_len 0).
    q, kv, tables, kv_lens, q_pos = _setup(B=2, T=8, starts=[5, 0], nb=32,
                                           W=4, kv_lens=[13, 0])
    ref = _jax(q, kv, tables, kv_lens, q_pos, scale=scale)
    tq, tkv, ttab, tlens, tpos = _t(q, kv, tables, kv_lens, q_pos)
    got = paged_attention_prefill_plain(tq, tkv, ttab, tlens,
                                        tpos[:, 0].contiguous(), 0,
                                        scale=scale).numpy()
    assert np.all(got[1] == 0.0)
    np.testing.assert_allclose(got[0], ref[0], **TOL)


def test_port_attention_reads_the_right_layer():
    """The full stacked cache with a layer index: layer 1 of a two-layer
    cache equals the one-layer computation on that layer alone."""
    q, kv, tables, kv_lens, q_pos = _setup(B=2, T=4, starts=[3, 9], seed=6)
    other = np.random.default_rng(7).standard_normal(kv.shape).astype(np.float32)
    two = np.concatenate([other, kv], axis=0)
    scale = 0.2
    ref = _jax(q, kv, tables, kv_lens, q_pos, scale=scale)
    tq, ttwo, ttab, tlens, tpos = _t(q, two, tables, kv_lens, q_pos)
    got = gather_paged_attention(tq, ttwo, ttab, tlens, tpos, 1, scale=scale)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    plain = paged_attention_prefill_plain(tq, ttwo, ttab, tlens,
                                          tpos[:, 0].contiguous(), 1,
                                          scale=scale)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA launch goes through, in order; every case here is
    refused before the device check, so it runs on CPU tensors."""
    from production_stack_tpu_torch.ops.paged_attention_cuda import _check

    q = torch.zeros(2, 32, 128, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 2, 8, 8 * 128, dtype=torch.bfloat16)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    cases = [
        (TypeError, (q, 3, kv.to(torch.float8_e5m2), tables, lens, 0)),
        (TypeError, (q.float(), 3, kv, tables, lens, 0)),
        (TypeError, (q.half(), 3, kv.to(torch.float8_e4m3fn), tables, lens, 0)),
        (ValueError, (q[None], 3, kv, tables, lens, 0)),
        # A head_dim no kernel takes (128 and 256 are the tensor cores').
        (ValueError, (torch.zeros(2, 16, 96, dtype=torch.bfloat16), 3,
                      kv[..., :192], tables, lens, 0)),
        (ValueError, (torch.zeros(2, 72, 128, dtype=torch.bfloat16), 3, kv,
                      tables, lens, 0)),  # H/KH = 9
        (ValueError, (q[:, :12], 3, kv, tables, lens, 0)),  # H/KH = 1.5
        (IndexError, (q, 3, kv, tables, lens, 1)),
        (TypeError, (q, 3, kv, tables.long(), lens, 0)),
        (ValueError, (q, 3, kv, tables[:1], lens, 0)),
        (ValueError, (q, 3, kv, tables, lens, 0)),  # CPU tensors
    ]
    for err, args in cases:
        with pytest.raises(err):
            _check("decode", *args)
