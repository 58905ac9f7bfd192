"""Edit distance and WER with a substitution / deletion / insertion
breakdown.

Counterpart of openasr_tpu/utils/metrics.py, a copy so that the port's
scorer (`openasr_torch.bin.wer`) imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1, dtype=np.int32)
    cur = np.empty(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur[0] = i
        ri = ref[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (0 if ri == hyp[j - 1] else 1)
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev, cur = cur, prev
    return int(prev[m])


def batch_distance(refs: List[Sequence], hyps: List[Sequence]) -> int:
    """Summed edit distance over a batch."""
    return sum(edit_distance(r, h) for r, h in zip(refs, hyps))


def align_stats(ref: Sequence, hyp: Sequence) -> Dict[str, int]:
    """DP alignment with its substitution / deletion / insertion counts."""
    n, m = len(ref), len(hyp)
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dp[i - 1, j - 1] + (0 if ref[i - 1] == hyp[j - 1] else 1)
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, sub)
    # backtrack: matches, then substitutions, deletions, insertions
    i, j = n, m
    stats = {"sub": 0, "del": 0, "ins": 0, "cor": 0}
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] and ref[i - 1] == hyp[j - 1]:
            stats["cor"] += 1
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + 1:
            stats["sub"] += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            stats["del"] += 1
            i -= 1
        else:
            stats["ins"] += 1
            j -= 1
    stats["err"] = stats["sub"] + stats["del"] + stats["ins"]
    stats["ref_len"] = n
    return stats


def wer(refs: List[Sequence], hyps: List[Sequence]) -> Dict[str, float]:
    """Corpus-level WER (percent) with its sub / del / ins shares."""
    total = {"sub": 0, "del": 0, "ins": 0, "cor": 0, "err": 0, "ref_len": 0}
    for r, h in zip(refs, hyps):
        s = align_stats(r, h)
        for k in total:
            total[k] += s[k]
    denom = max(total["ref_len"], 1)
    return {
        "wer": 100.0 * total["err"] / denom,
        "sub": 100.0 * total["sub"] / denom,
        "del": 100.0 * total["del"] / denom,
        "ins": 100.0 * total["ins"] / denom,
        "n_ref": total["ref_len"],
    }
