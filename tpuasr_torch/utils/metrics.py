"""WER/TER by edit distance: the port's copy of ``tpuasr/utils/metrics.py``
(a test holds the two equal)."""

from __future__ import annotations

import numpy as np


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two token sequences (host-side)."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1)
    cur = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        cur[0] = i
        sub = prev[:-1] + (np.asarray(hyp) != ref[i - 1])
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev, cur = cur, prev
    return int(prev[n])


def wer(refs: list, hyps: list) -> float:
    """Corpus-level word/token error rate: total edits / total ref tokens."""
    edits = 0
    total = 0
    for r, h in zip(refs, hyps):
        edits += edit_distance(list(r), list(h))
        total += len(r)
    return edits / max(total, 1)
