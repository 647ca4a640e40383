"""Synthetic key streams (numpy only), the port's copy of the reference's.

* ``zipf_keys``     — the ZIPF dataset: parametrized Zipfian key streams.
* ``drifting_zipf`` — LFM-like stream: Zipfian with the identity of the
  heavy keys re-drawn over time (concept drift).
* ``host_skew_keys`` — web-crawl-like: few giant hosts, heavy-tailed rest
  (the §6 fetch-list workload).
* ``hotspot_flip``  — nonstationary: the whole heavy set goes cold at one
  batch boundary and a disjoint set goes hot.
* ``sawtooth_skew`` — nonstationary: hard-Zipf and near-uniform batches
  alternate every ``period`` batches (the elastic triggers' stress load).
* ``lm_token_stream`` — Zipfian token batches for the LM training loop.

All draw from ``numpy.random.default_rng(seed)`` exactly as
``repro.data.generators`` does, so the same seed yields the same keys in
both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "zipf_keys",
    "drifting_zipf",
    "host_skew_keys",
    "hotspot_flip",
    "sawtooth_skew",
    "lm_token_stream",
]


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


def host_skew_keys(
    n: int,
    num_hosts: int = 64,
    giants: int = 4,
    giant_mass: float = 0.6,
    seed: int = 0,
) -> np.ndarray:
    """Web-crawl fetch-list keys: ``giants`` hosts own ``giant_mass`` of all
    pages; the rest follow Zipf(1.2) — the §6 distribution shape."""
    rng = np.random.default_rng(seed)
    tail = _zipf_probs(num_hosts - giants, 1.2) * (1.0 - giant_mass)
    head = np.full(giants, giant_mass / giants)
    probs = np.concatenate([head, tail])
    ids = rng.choice(2**30, size=num_hosts, replace=False)
    return ids[rng.choice(num_hosts, size=n, p=probs)].astype(np.int64)


def hotspot_flip(
    num_batches: int,
    batch_size: int,
    num_keys: int = 10_000,
    exponent: float = 1.5,
    flip_at: int | None = None,
    seed: int = 0,
):
    """Yield Zipf batches whose rank -> key-identity mapping is re-drawn
    once, at batch ``flip_at`` (default: the midpoint): every heavy key goes
    cold at one boundary while a disjoint set goes hot."""
    flip_at = num_batches // 2 if flip_at is None else flip_at
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(num_keys, exponent)
    ids = rng.choice(2**30, size=num_keys, replace=False).astype(np.int64)
    for b in range(num_batches):
        if b == flip_at:
            ids = rng.choice(2**30, size=num_keys, replace=False).astype(np.int64)
        ranks = rng.choice(num_keys, size=batch_size, p=probs)
        yield ids[ranks].copy()


def sawtooth_skew(
    num_batches: int,
    batch_size: int,
    num_keys: int = 10_000,
    exponent: float = 1.8,
    period: int = 2,
    seed: int = 0,
):
    """Yield ``period`` hard-Zipf batches, then ``period`` near-uniform ones,
    and so on; the key identities stay fixed (the load is what changes)."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(2**30, size=num_keys, replace=False).astype(np.int64)
    hot = _zipf_probs(num_keys, exponent)
    flat = np.full(num_keys, 1.0 / num_keys)
    for b in range(num_batches):
        probs = hot if (b // period) % 2 == 0 else flat
        ranks = rng.choice(num_keys, size=batch_size, p=probs)
        yield ids[ranks].copy()


def lm_token_stream(
    n_batches: int, batch: int, seq: int, vocab: int, seed: int = 0, exponent: float = 1.1
):
    """Zipfian int32 token-id batches ``[batch, seq]`` over the first
    ``min(vocab, 50_000)`` ids, for the LM training loop."""
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(min(vocab, 50_000), exponent)
    for _ in range(n_batches):
        toks = rng.choice(len(probs), size=(batch, seq), p=probs)
        yield toks.astype(np.int32)
