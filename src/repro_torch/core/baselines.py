"""Baseline partitioning strategies the paper compares against.

* ``Readj`` / ``Redist`` / ``Scan`` — Gedik, *Partitioning functions for
  stateful data parallelism in stream processing*, VLDBJ 2014.  Run with
  linear resource functions, balance constraint ``theta = 0.2`` and utility
  ``U = rho + gamma`` (the paper's stated configuration).
* ``Mixed`` — Fang et al., arXiv:1610.05121: explicit placement for tracked
  heavy keys + uniform hash for the tail, under a load bound ``theta_max``.

These are best-effort reconstructions from the cited papers' descriptions
(the DR paper itself partly reconstructs its Storm/S4 baselines the same
way).  All of them share KIP's table representation so balance, migration
and runtime measurements are apples-to-apples; none of them re-bins the
weighted-hash tail — that is KIP's distinguishing mechanism.

Host numpy, bit-identical to ``repro.core.baselines``: the numpy calls that
decide bits or ties are the reference's (``np.add.at``'s sequential sum,
``np.argsort``'s default kind, the first index of ``np.argmax`` /
``np.argmin``).  On the device a baseline's table is routed like KIP's,
by ``partition_apply`` (:func:`repro_torch.core.replay.replay_partition`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hashing import DEFAULT_NUM_HOSTS
from repro_torch.core.histogram import Histogram
from repro_torch.core.partitioner import Partitioner, _pad_heavy, uniform_partitioner

__all__ = ["readj_update", "redist_update", "scan_update", "mixed_update"]


def _tail_loads(prev: Partitioner, hist: Histogram, n: int) -> np.ndarray:
    hosts_per_part = np.bincount(prev.host_to_part, minlength=n).astype(np.float64)
    return hist.tail_mass / prev.num_hosts * hosts_per_part


def _build(prev: Partitioner, hist: Histogram, parts: np.ndarray, n: int) -> Partitioner:
    # the table keeps the wider of the histogram and ``prev`` (not rounded
    # to the kernels' tile: ``ops.apply_partitioner`` pads on the way in)
    cap = max(len(hist), prev.heavy_keys.shape[0])
    hk, hp, _ = _pad_heavy(hist.keys.astype(np.int32), parts.astype(np.int32), cap)
    return Partitioner(n, hk, hp, prev.host_to_part.copy(), prev.seed)


def readj_update(
    prev: Partitioner, hist: Histogram, num_partitions: int | None = None, theta: float = 0.2
) -> Partitioner:
    """READJ: keep previous placement; move heavy keys off partitions only
    while the balance constraint ``max <= (1 + theta) * ideal`` is violated.
    Each step moves the largest member of the most loaded partition that
    leaves the least loaded one below it, for at most ``4B + 4`` steps (the
    reference's docstring says the smallest; its code, kept here, moves the
    largest).
    """
    n = int(num_partitions or prev.num_partitions)
    b = len(hist)
    parts = prev.lookup_np(hist.keys.astype(np.int32)).astype(np.int64)
    freqs = hist.freqs
    load = _tail_loads(prev, hist, n)
    np.add.at(load, parts, freqs)
    ideal = 1.0 / n
    bound = (1.0 + theta) * ideal
    for _ in range(4 * b + 4):
        src = int(np.argmax(load))
        if load[src] <= bound:
            break
        members = np.where(parts == src)[0]
        if len(members) == 0:
            break
        # LPT-style readjust: relocate the largest improving item of the
        # overloaded partition (fast convergence, heavy migration — the
        # trade the paper measures against KIP's keep-in-place probes)
        dst = int(np.argmin(load))
        if dst == src:
            break
        order = members[np.argsort(-freqs[members])]
        move = next((m for m in order if load[dst] + freqs[m] < load[src]), None)
        if move is None:
            break
        parts[move] = dst
        load[src] -= freqs[move]
        load[dst] += freqs[move]
    return _build(prev, hist, parts, n)


def redist_update(
    prev: Partitioner, hist: Histogram, num_partitions: int | None = None, theta: float = 0.2
) -> Partitioner:
    """REDIST: rebuild from scratch by LPT greedy — best balance over the
    tracked keys, completely migration-oblivious (previous placement is
    ignored, so placements flap with histogram noise — the heavy-migration
    end of Gedik's spectrum)."""
    n = int(num_partitions or prev.num_partitions)
    load = _tail_loads(prev, hist, n)
    parts = np.zeros(len(hist), np.int64)
    for i in range(len(hist)):  # hist is frequency-descending (LPT order)
        p = int(np.argmin(load))
        parts[i] = p
        load[p] += hist.freqs[i]
    return _build(prev, hist, parts, n)


def scan_update(
    prev: Partitioner, hist: Histogram, num_partitions: int | None = None, theta: float = 0.2
) -> Partitioner:
    """SCAN: per-item utility minimization U = rho + gamma — stay at the
    current location unless that violates the balance constraint (gamma
    dominates ties), making it the most migration-frugal strategy.
    """
    n = int(num_partitions or prev.num_partitions)
    parts = prev.lookup_np(hist.keys.astype(np.int32)).astype(np.int64)
    freqs = hist.freqs
    load = _tail_loads(prev, hist, n)
    ideal = 1.0 / n
    out = np.zeros(len(hist), np.int64)
    for i in range(len(hist)):
        f = freqs[i]
        stay = int(parts[i])
        best = int(np.argmin(load))
        # U = rho + gamma: moving must beat staying by more than the slack
        # (gamma penalizes any migration) — maximally sticky placement
        if load[stay] <= load[best] + theta * ideal:
            p = stay
        else:
            p = best
        out[i] = p
        load[p] += f
    return _build(prev, hist, out, n)


def mixed_update(
    prev: Partitioner,
    hist: Histogram,
    num_partitions: int | None = None,
    theta_max: float = 0.1,
    a_max: int | None = None,
) -> Partitioner:
    """MIXED (Fang et al.): explicit top-``a_max`` keys + hash tail, rebuilt
    each epoch under load bound ``(1 + theta_max)/N``.  Unlike KIP it has no
    migration-aware probe order and never re-bins the hash tail.
    """
    n = int(num_partitions or prev.num_partitions)
    if a_max is not None:
        hist = hist.top(a_max)
    load = _tail_loads(prev, hist, n)
    bound = (1.0 + theta_max) / n
    parts = np.zeros(len(hist), np.int64)
    for i in range(len(hist)):
        f = hist.freqs[i]
        # hash location if admissible (cheap routing), else least loaded
        hp = int(prev.lookup_np(hist.keys[i : i + 1].astype(np.int32))[0])
        p = hp if load[hp] + f <= bound else int(np.argmin(load))
        parts[i] = p
        load[p] += f
    return _build(prev, hist, parts, n)


def make_baseline(name: str, num_partitions: int, num_hosts: int = DEFAULT_NUM_HOSTS, seed: int = 0):
    """(update_fn, initial_partitioner) pair for a named strategy."""
    updates = {
        "hash": lambda prev, hist, n=None, **kw: prev,
        "readj": readj_update,
        "redist": redist_update,
        "scan": scan_update,
        "mixed": mixed_update,
    }
    if name not in updates:
        raise KeyError(f"unknown baseline {name!r}; have {sorted(updates)}")
    return updates[name], uniform_partitioner(num_partitions, num_hosts, seed)
