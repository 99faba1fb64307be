"""Token sampling on the device: temperature / top-k / top-p / min-p plus
penalties, logit bias and allowed-token masks (PyTorch).

Greedy, masking and penalty math follow the JAX package's
``ops/sampling.py`` exactly, and so does the seeded draw: each row's
Gumbel noise is ``jax.random.gumbel(jax.random.PRNGKey(seed), (K,))``,
computed here from the device ``seeds`` tensor with integer tensor ops
(threefry2x32, :func:`threefry_bits`), so a seeded request gets the JAX
server's tokens and the sampler never reads a seed on the host.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_K_CAP = 256
LOGPROBS_K = 20
PACKED_WIDTH = 2 + 2 * LOGPROBS_K
_NEG = -0.7 * torch.finfo(torch.float32).max


_MASK32 = 0xFFFF_FFFF
# threefry2x32 as jax._src.prng.threefry2x32 runs it: 20 rounds in five
# groups of four, with these rotations, the key schedule (k0, k1, k0 ^ k1
# ^ 0x1BD11BDA) injected after each group with the group's index.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# jax.random.uniform's range [tiny, 1) in float32: maxval - minval is 1.0.
_TINY = float(np.finfo(np.float32).tiny)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK32


def threefry_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(jax.random.PRNGKey(seed), (n,), uint32)`` of each
    row's seed, as int64 [B, n] holding the 32-bit words: threefry2x32 on
    key (0, seed mod 2^32) and counters (0, i), i < n, the two output words
    XORed (JAX's partitionable layout, ``jax_threefry_partitionable``).
    int64 tensor ops masked to 32 bits, on ``seeds``' device."""
    k0 = torch.zeros_like(seeds, dtype=torch.int64)[:, None]
    k1 = (seeds.to(torch.int64) & _MASK32)[:, None]
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = k0 + torch.zeros(n, dtype=torch.int64, device=seeds.device)
    x1 = (torch.arange(n, dtype=torch.int64, device=seeds.device) + k1) \
        & _MASK32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _MASK32
    return x0 ^ x1


def gumbel_noise(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(jax.random.PRNGKey(seed), (n,), float32)`` of
    each row's seed, [B, n] float32: the words' top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [tiny, 1) as
    ``jax.random.uniform(..., minval=tiny, maxval=1.)`` does (times 1 - tiny,
    which is 1.0 in float32, plus tiny, then at least tiny), then
    ``-log(-log(u))``."""
    mant = (threefry_bits(seeds, n) >> 9) | 0x3F80_0000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * _SPAN + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    temps: torch.Tensor,  # [B]
    top_ps: torch.Tensor,  # [B]
    top_ks: torch.Tensor,  # [B] (<=0: disabled)
    min_ps: torch.Tensor,  # [B]
    seeds: torch.Tensor,  # [B] integer per-row seeds, on logits' device
    greedy_only: bool = False,
) -> torch.Tensor:
    """``greedy_only`` (every row greedy) skips the top-k/softmax/Gumbel
    machinery and returns the argmax."""
    if greedy_only:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B, V = logits.shape
    K = min(V, SAMPLE_K_CAP)
    greedy = temps <= 1e-5
    t = torch.clamp(temps, min=1e-5)[:, None]

    vals, idxs = torch.topk(logits, K, dim=-1)  # descending
    scaled = vals / t
    probs = torch.softmax(scaled, dim=-1)

    col = torch.arange(K, device=logits.device)[None, :]
    kk = torch.where(top_ks <= 0, K, torch.clamp(top_ks, max=K))[:, None]
    keep = col < kk
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_ps[:, None]  # keep the first token crossing top_p
    keep &= probs >= min_ps[:, None] * probs[:, :1]
    keep[:, 0] = True

    g = gumbel_noise(seeds, K)
    choice = torch.argmax(
        torch.where(keep, scaled + g, torch.full_like(scaled, _NEG)), dim=-1
    )
    sampled = torch.gather(idxs, 1, choice[:, None])[:, 0]
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled).to(
        torch.int32
    )


def sample_tokens_packed(
    logits: torch.Tensor,
    temps: torch.Tensor,
    top_ps: torch.Tensor,
    top_ks: torch.Tensor,
    min_ps: torch.Tensor,
    seeds,
    with_logprobs: bool = False,
    greedy_only: bool = False,
) -> torch.Tensor:
    """Sample into one packed float32 array: ``[token]`` per row, or with
    ``with_logprobs`` ``[token, chosen_logprob, top_lps(K), top_ids(K)]``
    (raw ``log_softmax`` of the logits). Token ids ride as float32, exact
    for any vocab below 2**24."""
    tokens = sample_tokens(
        logits, temps, top_ps, top_ks, min_ps, seeds, greedy_only=greedy_only
    )
    if not with_logprobs:
        return tokens[:, None].to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, 1, tokens[:, None].long())
    top_lps, top_ids = torch.topk(logp, LOGPROBS_K, dim=-1)
    return torch.cat(
        [tokens[:, None].to(torch.float32), chosen, top_lps,
         top_ids.to(torch.float32)],
        dim=1,
    )


def unpack_sampled(packed) -> tuple:
    """Host-side view of a packed row array (any leading dims):
    (tokens int, chosen_lp, top_lps [..., K], top_ids [..., K] int)."""
    tokens = packed[..., 0].astype(np.int64)
    chosen = packed[..., 1]
    top_lps = packed[..., 2 : 2 + LOGPROBS_K]
    top_ids = packed[..., 2 + LOGPROBS_K :].astype(np.int64)
    return tokens, chosen, top_lps, top_ids


def _in_vocab(ids: torch.Tensor, V: int) -> torch.Tensor:
    """``ids`` [B, N] as int64, with the pad id V and anything else outside
    [0, V) sent to an extra column V that the caller slices off: dropping
    them needs no host sync."""
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < V), ids, V)


def apply_logit_bias(
    logits: torch.Tensor,  # [B, V] float32
    bias_ids: torch.Tensor,  # [B, Nb] int32, pad = V (dropped)
    bias_vals: torch.Tensor,  # [B, Nb] float32
) -> torch.Tensor:
    """OpenAI ``logit_bias``: additive per-token offsets before sampling."""
    V = logits.shape[1]
    out = torch.nn.functional.pad(logits, (0, 1))
    out.scatter_add_(1, _in_vocab(bias_ids, V), bias_vals.to(out.dtype))
    return out[:, :V]


def apply_allowed_mask(
    logits: torch.Tensor,  # [B, V] float32
    allowed_ids: torch.Tensor,  # [B, Na] int32, pad = V (dropped)
    allow_free: torch.Tensor,  # [B] bool — True: row is unconstrained
) -> torch.Tensor:
    """Restrict each constrained row to its allowed token set (everything
    else to the large negative); unconstrained rows pass through."""
    B, V = logits.shape
    mask = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    mask.scatter_(1, _in_vocab(allowed_ids, V), True)
    mask = mask[:, :V] | allow_free[:, None]
    return torch.where(mask, logits, torch.full_like(logits, _NEG))


def apply_penalties_counts(
    logits: torch.Tensor,  # [B, V] float32
    prompt_seen: torch.Tensor,  # [B, V] bool
    out_counts: torch.Tensor,  # [B, V] float32
    presence: torch.Tensor,  # [B]
    frequency: torch.Tensor,  # [B]
    repetition: torch.Tensor,  # [B]
) -> torch.Tensor:
    """vLLM-convention penalties over dense per-vocab state (the form a
    decode burst carries from step to step)."""
    seen = prompt_seen | (out_counts > 0)
    rep = repetition[:, None]
    logits = torch.where(
        seen, torch.where(logits > 0, logits / rep, logits * rep), logits
    )
    logits = logits - frequency[:, None] * out_counts
    logits = logits - presence[:, None] * (out_counts > 0).to(torch.float32)
    return logits


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    prompt_tokens: torch.Tensor,  # [B, Pp] int32, pad = V (dropped)
    output_tokens: torch.Tensor,  # [B, Po] int32, pad = V (dropped)
    presence: torch.Tensor,
    frequency: torch.Tensor,
    repetition: torch.Tensor,
) -> torch.Tensor:
    """Token-id-array form: scatters into the dense state and delegates to
    :func:`apply_penalties_counts` so the two forms cannot drift."""
    B, V = logits.shape
    out_ids = _in_vocab(output_tokens, V)
    out_counts = torch.zeros((B, V + 1), dtype=torch.float32,
                             device=logits.device)
    out_counts.scatter_add_(1, out_ids, torch.ones_like(out_ids, dtype=torch.float32))
    prompt_seen = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    prompt_seen.scatter_(1, _in_vocab(prompt_tokens, V), True)
    return apply_penalties_counts(
        logits, prompt_seen[:, :V], out_counts[:, :V], presence, frequency,
        repetition,
    )
