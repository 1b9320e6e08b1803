"""Length bucketing, the port's copy of ``tpuasr/data/bucketing.py``: a
small fixed set of padded lengths, so an epoch runs few distinct shapes
and padding waste stays bounded."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Sample-length buckets. An utterance of n samples goes to the smallest
    boundary >= n; longer utterances are truncated by the loader."""

    boundaries: tuple   # ascending sample counts

    def bucket_of(self, n: int) -> int:
        """Index of the bucket for an n-sample utterance, or -1 if too long."""
        for i, b in enumerate(self.boundaries):
            if n <= b:
                return i
        return -1

    def padded_len(self, idx: int) -> int:
        return self.boundaries[idx]


def make_buckets(lengths, max_waste: float = 0.2, min_buckets: int = 2,
                 max_buckets: int = 8, quantum: int = 1) -> BucketSpec:
    """Bucket boundaries from a corpus length histogram: k equal-mass
    quantiles for the least k in [min_buckets, max_buckets] whose expected
    padding waste is at most ``max_waste``, always ending at the longest
    utterance; every boundary rounded up to a multiple of ``quantum``
    samples."""
    lengths = np.asarray(sorted(lengths))
    if len(lengths) == 0:
        raise ValueError("empty corpus")

    def q_up(x):
        return -(-int(x) // quantum) * quantum

    lo, hi = int(lengths[0]), q_up(lengths[-1])
    if lo == hi or max_buckets == 1:
        return BucketSpec((hi,))
    for k in range(min_buckets, max_buckets + 1):
        qs = [lengths[int(len(lengths) * (i + 1) / k) - 1] for i in range(k)]
        bounds = sorted(set(q_up(q) for q in qs) | {hi})
        waste = _expected_waste(lengths, bounds)
        if waste <= max_waste:
            return BucketSpec(tuple(bounds))
    return BucketSpec(tuple(bounds))


def _expected_waste(lengths, bounds) -> float:
    pad = 0
    tot = 0
    for n in lengths:
        for b in bounds:
            if n <= b:
                pad += b - n
                tot += b
                break
    return pad / max(tot, 1)
