"""Synthetic key streams (numpy only), the port's copy of the reference's.

* ``zipf_keys``     — the ZIPF dataset: parametrized Zipfian key streams.
* ``drifting_zipf`` — LFM-like stream: Zipfian with the identity of the
  heavy keys re-drawn over time (concept drift).

Both draw from ``numpy.random.default_rng(seed)`` exactly as
``repro.data.generators`` does, so the same seed yields the same keys in
both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = ["zipf_keys", "drifting_zipf"]


def _zipf_probs(num_keys: int, exponent: float) -> np.ndarray:
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    return p / p.sum()


def zipf_keys(
    n: int,
    num_keys: int = 100_000,
    exponent: float = 1.0,
    seed: int = 0,
    key_space: int = 2**30,
) -> np.ndarray:
    """Sample ``n`` keys from a Zipf(num_keys, exponent) distribution, key
    identities scattered over ``key_space`` by a random permutation."""
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(num_keys, exponent)
    ranks = rng.choice(num_keys, size=n, p=probs)
    ids = rng.choice(key_space, size=num_keys, replace=False)
    return ids[ranks].astype(np.int64)


def drifting_zipf(
    num_batches: int,
    batch_size: int,
    num_keys: int = 10_000,
    exponent: float = 1.0,
    drift_every: int = 5,
    drift_fraction: float = 0.3,
    seed: int = 0,
):
    """Yield ``num_batches`` key batches; every ``drift_every`` batches a
    ``drift_fraction`` of the ranks get brand-new key identities."""
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(num_keys, exponent)
    ids = rng.choice(2**30, size=num_keys, replace=False).astype(np.int64)
    for b in range(num_batches):
        if b > 0 and b % drift_every == 0:
            k = max(1, int(drift_fraction * num_keys))
            swap = rng.choice(num_keys, size=k, replace=False)
            ids[swap] = rng.choice(2**30, size=k, replace=False)
        ranks = rng.choice(num_keys, size=batch_size, p=probs)
        yield ids[ranks].copy()
