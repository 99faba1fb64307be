"""The port's sampling ops vs the JAX package's ``ops/sampling.py``.

Greedy, logit bias, allowed-token masks and both penalty forms must match
exactly. Seeded sampling is held here to reproducibility and top-k /
top-p / min-p to keeping only allowed ids; ``test_torch_seeded_draw.py``
holds the draw to ``jax.random`` bit for bit and the sampled tokens to the
JAX sampler's and the JAX engine's.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import torch

from production_stack_tpu.ops import sampling as jsamp
from production_stack_tpu_torch.ops import sampling as tsamp

B, V = 4, 300


def _logits(seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_greedy_matches_jax():
    lg = _logits()
    lg[1, 7] = lg[1, 9] = lg[1].max() + 1.0  # a tie: first index wins in both
    args = dict(temps=np.zeros(B, np.float32), top_ps=np.ones(B, np.float32),
                top_ks=np.zeros(B, np.int32), min_ps=np.zeros(B, np.float32),
                seeds=np.arange(B, dtype=np.uint32))
    want = np.asarray(jsamp.sample_tokens(
        jnp.asarray(lg), *(jnp.asarray(v) for v in args.values())))
    for greedy_only in (True, False):
        got = tsamp.sample_tokens(_t(lg), *(_t(v) for v in args.values()),
                                  greedy_only=greedy_only)
        np.testing.assert_array_equal(got.numpy(), want)


def test_logit_bias_and_allowed_mask_match_jax():
    lg = _logits(1)
    ids = np.array([[3, 3, V, 0], [V, V, V, V], [299, 5, 6, V], [1, 2, 3, 4]],
                   np.int32)
    vals = np.random.default_rng(2).standard_normal(ids.shape).astype(np.float32)
    want = np.asarray(jsamp.apply_logit_bias(
        jnp.asarray(lg), jnp.asarray(ids), jnp.asarray(vals)))
    got = tsamp.apply_logit_bias(_t(lg), _t(ids), _t(vals)).numpy()
    np.testing.assert_array_equal(got, want)

    lg = _logits(3)
    ids = np.array([[3, 9, V, V], [V, V, V, V], [0, 299, 5, 5], [1, V, 2, V]],
                   np.int32)
    free = np.array([False, True, False, False])
    want = np.asarray(jsamp.apply_allowed_mask(
        jnp.asarray(lg), jnp.asarray(ids), jnp.asarray(free)))
    got = tsamp.apply_allowed_mask(_t(lg), _t(ids), _t(free)).numpy()
    np.testing.assert_array_equal(got, want)


def _penalty_args(seed=4):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, V, size=(B, 8)).astype(np.int32)
    prompt[:, 6:] = V  # padding
    output = rng.integers(0, 40, size=(B, 6)).astype(np.int32)  # repeats
    output[0, 4:] = V
    presence = np.array([0.0, 0.5, 1.0, -0.3], np.float32)
    frequency = np.array([0.0, 0.2, 0.7, 0.1], np.float32)
    repetition = np.array([1.0, 1.3, 0.8, 2.0], np.float32)
    return prompt, output, presence, frequency, repetition


def test_both_penalty_forms_match_jax():
    lg = _logits(5)
    args = _penalty_args()
    want = np.asarray(jsamp.apply_penalties(
        jnp.asarray(lg), *(jnp.asarray(a) for a in args)))
    got = tsamp.apply_penalties(_t(lg), *(_t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)

    # The dense form a decode burst carries from step to step.
    lg = _logits(6)
    rng = np.random.default_rng(7)
    seen = rng.random((B, V)) < 0.1
    counts = rng.integers(0, 3, size=(B, V)).astype(np.float32)
    _, _, presence, frequency, repetition = _penalty_args()
    args = (seen, counts, presence, frequency, repetition)
    want = np.asarray(jsamp.apply_penalties_counts(
        jnp.asarray(lg), *(jnp.asarray(a) for a in args)))
    got = tsamp.apply_penalties_counts(_t(lg), *(_t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)


def _sample(lg, temps, top_ps, top_ks, min_ps, seeds):
    return tsamp.sample_tokens(
        _t(lg), _t(np.asarray(temps, np.float32)),
        _t(np.asarray(top_ps, np.float32)), _t(np.asarray(top_ks, np.int32)),
        _t(np.asarray(min_ps, np.float32)), _t(np.asarray(seeds, np.int64)),
    ).numpy()


def test_seeded_sampling_is_reproducible():
    lg = _logits(8)
    args = ([1.0] * B, [1.0] * B, [0] * B, [0.0] * B, [11, 12, 13, 14])
    a = _sample(lg, *args)
    b = _sample(lg, *args)
    np.testing.assert_array_equal(a, b)
    draws = {tuple(_sample(lg, [1.0] * B, [1.0] * B, [0] * B, [0.0] * B,
                           [s] * B)) for s in range(8)}
    assert len(draws) > 1, "different seeds should not all draw alike"


def test_truncation_keeps_only_allowed_ids():
    lg = _logits(9)
    lgt = _t(lg)
    probs = torch.softmax(lgt, dim=-1).numpy()
    order = np.argsort(-lg, axis=-1)
    for kind, seed in itertools.product(("top_k", "top_p", "min_p"), range(16)):
        if kind == "top_k":
            got = _sample(lg, [1.0] * B, [1.0] * B, [3] * B, [0.0] * B, [seed] * B)
            allowed = [set(order[i, :3]) for i in range(B)]
        elif kind == "top_p":
            got = _sample(lg, [1.0] * B, [0.5] * B, [0] * B, [0.0] * B, [seed] * B)
            allowed = []
            for i in range(B):
                p = probs[i, order[i]]
                before = np.cumsum(p) - p
                allowed.append(set(order[i, before < 0.5]))
        else:
            got = _sample(lg, [1.0] * B, [1.0] * B, [0] * B, [0.3] * B, [seed] * B)
            allowed = [set(np.nonzero(probs[i] >= 0.3 * probs[i].max())[0])
                       for i in range(B)]
        for i in range(B):
            assert got[i] in allowed[i], (kind, seed, i)


def test_packed_logprobs_match_log_softmax():
    lg = _logits(10)
    z = np.zeros(B, np.float32)
    packed = tsamp.sample_tokens_packed(
        _t(lg), _t(z), _t(np.ones(B, np.float32)), _t(np.zeros(B, np.int32)),
        _t(z), _t(np.zeros(B, np.int64)), with_logprobs=True,
    ).numpy()
    assert packed.shape == (B, tsamp.PACKED_WIDTH)
    tokens, chosen, top_lps, top_ids = tsamp.unpack_sampled(packed)
    want = np.asarray(jsamp.sample_tokens_packed(
        jnp.asarray(lg), jnp.asarray(z), jnp.ones(B), jnp.zeros(B, jnp.int32),
        jnp.asarray(z), jnp.zeros(B, jnp.uint32), with_logprobs=True,
    ))
    np.testing.assert_array_equal(tokens, want[:, 0].astype(np.int64))
    np.testing.assert_allclose(chosen, want[:, 1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(top_lps, want[:, 2:22], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(top_ids, want[:, 22:].astype(np.int64))
