"""Speculative decoding: n-gram prompt-lookup drafting.

The port's own copy of the JAX package's ``engine/spec.py`` (numpy only),
the analogue of vLLM's ``[ngram]`` speculative model (which the
reference stack passes through to its engines via ``extraArgs``,
``helm/values.yaml:81``): no draft model — draft tokens are proposed by
matching the sequence's own recent suffix against its history (prompt +
generated text). Multi-round-QA-style workloads re-quote their history
constantly, so lookup drafts hit often; the target model then scores all K
drafts in ONE forward pass (``all_logits``) instead of K sequential decode
steps.

Exactness: the engine drafts only for greedy (temperature=0) rows and
accepts a draft prefix exactly as long as it matches the model's own
argmax at every position — output token-for-token identical to
non-speculative decoding where both score a position alike. On the card
a verify pass scores its K+1 positions with the prefill kernel and a
plain step with the decode kernel, whose bf16 roundings differ, so a
greedy token can part where the top two logits nearly tie. The paged KV
design makes rollback free: rejected positions' cache writes sit past the
committed ``kv_len`` and are overwritten when those positions are decoded
for real.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def propose_ngram(
    token_ids,
    k: int,
    min_n: int = 1,
    max_n: int = 3,
    lookback: int = 0,
) -> Optional[List[int]]:
    """Draft up to ``k`` tokens by prompt lookup.

    Finds the longest n-gram (``max_n`` down to ``min_n``) such that the
    sequence's last n tokens also occur earlier in the sequence; drafts the
    tokens that followed the MOST RECENT earlier occurrence. None if no
    n-gram recurs (the caller falls back to plain decoding).

    ``token_ids`` may be a list or an int numpy array (the engine caches
    one per sequence — rebuilding 32k-token arrays every decode step was
    measurable host time). ``lookback`` > 0 caps the scan to the last that
    many tokens, bounding per-step host work at long context.
    """
    a = np.asarray(token_ids, np.int64)
    if lookback > 0 and a.shape[0] > lookback:
        a = a[-lookback:]
    L = a.shape[0]
    if L < min_n + 1 or k <= 0:
        return None
    for n in range(min(max_n, L - 1), min_n - 1, -1):
        suf = a[-n:]
        # Match windows a[s : s+n] for starts s in [0, L-n) — vectorized
        # per-offset equality. The suffix itself (start L-n) lies past the
        # range, so every candidate is a genuine earlier (possibly
        # overlapping) occurrence.
        ok = np.ones(L - n, bool)
        for t in range(n):
            ok &= a[t : L - n + t] == suf[t]
        starts = np.flatnonzero(ok)
        if starts.size:
            s = int(starts[-1])  # most recent occurrence
            cont = a[s + n : s + n + k]
            if cont.size:
                return cont.astype(np.int64).tolist()
    return None


def count_accepted(draft: List[int], argmax_ids: np.ndarray) -> int:
    """Accepted draft prefix length: position j's draft survives iff it
    equals the model's argmax at position j-1 AND every earlier draft
    survived. ``argmax_ids`` is the verify step's [K+1] argmax row."""
    a = 0
    for j, d in enumerate(draft):
        if int(argmax_ids[j]) != int(d):
            break
        a += 1
    return a
