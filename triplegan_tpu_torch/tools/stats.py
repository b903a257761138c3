"""The campaign's statistics, each the same function of its inputs as the
JAX package's tool that it copies:

* ``sign_test_p``: the two-sided exact sign test on paired wins (ties
  dropped), as ``tools/digits_experiment.py`` and ``tools/flagset_ab.py``
  compute it inline;
* ``paired_permutation_p``: ``tools/digits_experiment.py::paired_permutation_p``;
* ``two_sample_perm_p`` and ``equivalence_analysis``: those of
  ``tools/tf_parity_train.py`` (independent samples: runs of two
  implementations, whose random streams are unrelated).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def sign_test_p(a: Sequence[float], b: Sequence[float]) -> float:
    """Two-sided exact binomial sign test on the pairs (a_i, b_i): the
    pairs where one side is lower count as that side's wins, ties are
    dropped; 1.0 when every pair ties."""
    wins_b = sum(1 for x, y in zip(a, b) if y < x)
    wins_a = sum(1 for x, y in zip(a, b) if y > x)
    n_pairs = wins_a + wins_b
    if not n_pairs:
        return 1.0
    k = max(wins_a, wins_b)
    tail = sum(math.comb(n_pairs, i) for i in range(k, n_pairs + 1))
    return min(1.0, 2.0 * tail / 2.0**n_pairs)


def paired_permutation_p(a: Sequence[float], b: Sequence[float]) -> float:
    """Exact two-sided paired permutation test on the mean difference:
    the share of the 2^n sign assignments of the differences whose |sum|
    reaches the observed one (1.0 with no pairs or no difference)."""
    diffs = [x - y for x, y in zip(a, b)]
    n = len(diffs)
    if n == 0 or all(d == 0 for d in diffs):
        return 1.0
    observed = abs(sum(diffs))
    hits = 0
    for mask in range(1 << n):
        s = sum(d if (mask >> i) & 1 else -d for i, d in enumerate(diffs))
        if abs(s) >= observed - 1e-12:
            hits += 1
    return hits / float(1 << n)


def two_sample_perm_p(a: Sequence[float], b: Sequence[float], n_iter: int = 20000, seed: int = 0) -> float:
    """Two-sided permutation test on the difference of the means of two
    independent samples, ``n_iter`` shuffles of the pool from
    ``RandomState(seed)``; (hits + 1) / (n_iter + 1)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    obs = abs(a.mean() - b.mean())
    pool = np.concatenate([a, b])
    rng = np.random.RandomState(seed)
    hits = 0
    for _ in range(n_iter):
        rng.shuffle(pool)
        if abs(pool[: len(a)].mean() - pool[len(a):].mean()) >= obs - 1e-12:
            hits += 1
    return (hits + 1) / (n_iter + 1)


def equivalence_analysis(a: Sequence[float], b: Sequence[float], margin_pct: float = 2.0,
                         n_boot: int = 20000, seed: int = 0) -> dict:
    """The bootstrap 90% percentile CI of mean(a) − mean(b) (each sample
    resampled with replacement, ``RandomState(seed)``) and TOST at α = 0.05:
    equivalent within ``margin_pct`` iff the whole CI lies inside ±margin.
    The default ±2.0 points is the digits measurement's own resolution: its
    500-image test set alone gives ±1.1 points of noise a seed."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    rng = np.random.RandomState(seed)
    diffs = np.empty(n_boot)
    for i in range(n_boot):
        diffs[i] = (a[rng.randint(0, len(a), len(a))].mean()
                    - b[rng.randint(0, len(b), len(b))].mean())
    lo, hi = np.percentile(diffs, [5.0, 95.0])
    return {
        "mean_diff_pct": round(float(a.mean() - b.mean()), 3),
        "diff_ci90_pct": [round(float(lo), 3), round(float(hi), 3)],
        "equiv_margin_pct": margin_pct,
        "tost_equivalent": bool(lo > -margin_pct and hi < margin_pct),
    }
