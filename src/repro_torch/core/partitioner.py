"""Partitioning functions: UHP and the Key Isolator Partitioner (KIP).

A partitioner is three small tables (plus the split-replica column), kept
as numpy on the host for planning and handed to the device as int32
tensors (:meth:`Partitioner.tables`):

* ``heavy_keys``  int32[B]  sorted ascending, padded with ``KEY_SENTINEL``
* ``heavy_parts`` int32[B]  explicit partition of each heavy key
* ``host_to_part`` int32[H] weighted-hash routing: key -> host -> partition
* ``heavy_repl``  int32[B]  replica count per heavy key (1 = no split; pad
  rows carry 0 so the route clamps them to a no-op choice)

``kip_update`` implements Algorithm 1 (KIPUPDATE) from the paper and
``resize_partitioner`` re-plans across partition counts with it;
``split_replica_rows`` is the host twin of the route kernels' replica pick.
All of this is the host numpy of ``repro.core.partitioner``, bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compat import to_device
from repro_torch.core.hashing import (
    DEFAULT_NUM_HOSTS,
    GOLDEN,
    KEY_SENTINEL,
    fmix32,
    hash_to_host,
    seed_mix,
)
from repro_torch.core.histogram import Histogram

__all__ = [
    "HEAVY_TILE",
    "PartitionerTables",
    "Partitioner",
    "expected_loads",
    "heavy_capacity_for",
    "kip_update",
    "load_imbalance",
    "resize_partitioner",
    "split_replica_rows",
    "uniform_partitioner",
]

# heavy-table widths round up to this tile (the reference's route-kernel
# tile), so tables and snapshots have the reference's shapes
HEAVY_TILE = 128


class PartitionerTables(NamedTuple):
    """The device representation of a partitioner (int32 tensors)."""

    heavy_keys: torch.Tensor  # int32[B] sorted, padded with KEY_SENTINEL
    heavy_parts: torch.Tensor  # int32[B]
    host_to_part: torch.Tensor  # int32[H]
    heavy_repl: torch.Tensor  # int32[B] replicas per heavy key (pad rows: 0)


@dataclasses.dataclass(frozen=True)
class Partitioner:
    """Host-side partitioner object (numpy tables + metadata)."""

    num_partitions: int
    heavy_keys: np.ndarray  # int32[B] sorted ascending (sentinel padded)
    heavy_parts: np.ndarray  # int32[B]
    host_to_part: np.ndarray  # int32[H]
    seed: int = 0
    heavy_repl: np.ndarray | None = None  # int32[B] replicas (None = all 1)

    @property
    def num_hosts(self) -> int:
        return len(self.host_to_part)

    @property
    def num_heavy(self) -> int:
        return int((self.heavy_keys != KEY_SENTINEL).sum())

    def tables(self, device) -> PartitionerTables:
        """The device tables on ``device`` (no default: the caller names it),
        uploaded without waiting for the card's stream (``compat.to_device``)."""
        live = self.heavy_keys != KEY_SENTINEL
        if self.heavy_repl is None:
            repl = live.astype(np.int32)
        else:
            # live rows clamp to >= 1; pad rows stay 0, which the route
            # clamps to 1: a sentinel record hitting a pad row takes choice 0
            repl = np.where(live, np.maximum(self.heavy_repl, 1), 0).astype(np.int32)
        return PartitionerTables(*(
            to_device(np.ascontiguousarray(t, np.int32), device)
            for t in (self.heavy_keys, self.heavy_parts, self.host_to_part, repl)))

    # -- lookups ----------------------------------------------------------
    def lookup_np(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized host-side partition lookup (planning / benchmarks)."""
        keys = np.asarray(keys, np.int32)
        hosts = hash_to_host(keys, self.num_hosts, self.seed)
        part = self.host_to_part[hosts]
        if self.num_heavy:
            idx = np.searchsorted(self.heavy_keys, keys)
            idx = np.minimum(idx, len(self.heavy_keys) - 1)
            hit = self.heavy_keys[idx] == keys
            part = np.where(hit, self.heavy_parts[idx], part)
        return part.astype(np.int32)

    def heavy_map(self) -> dict[int, int]:
        m = self.heavy_keys != KEY_SENTINEL
        return dict(zip(self.heavy_keys[m].tolist(), self.heavy_parts[m].tolist()))

    # -- hot-key splitting ------------------------------------------------
    def split_map(self) -> dict[int, int]:
        """``{key: replicas}`` for every key currently split (repl > 1)."""
        if self.heavy_repl is None:
            return {}
        m = (self.heavy_keys != KEY_SENTINEL) & (self.heavy_repl > 1)
        return dict(zip(self.heavy_keys[m].tolist(), self.heavy_repl[m].tolist()))

    def with_splits(self, split_map: dict[int, int]) -> "Partitioner":
        """Re-stamp the replica column from ``split_map``; every other key
        drops back to one replica.

        A split key missing from the heavy table is inserted at its current
        :meth:`lookup_np` home (the table only grows — to the next
        kernel-tile multiple — when the insertions overflow the current
        width, so table shapes stay stable across re-stamps)."""
        live = self.heavy_keys != KEY_SENTINEL
        keys = self.heavy_keys[live].astype(np.int32)
        parts = self.heavy_parts[live].astype(np.int32)
        repl = np.ones(len(keys), np.int32)
        have = {int(k): i for i, k in enumerate(keys.tolist())}
        extra_keys, extra_parts, extra_repl = [], [], []
        for k, d in split_map.items():
            d = int(min(max(int(d), 1), self.num_partitions))
            if int(k) in have:
                repl[have[int(k)]] = d
            else:
                home = int(self.lookup_np(np.asarray([k], np.int32))[0])
                extra_keys.append(int(k))
                extra_parts.append(home)
                extra_repl.append(d)
        if extra_keys:
            keys = np.concatenate([keys, np.asarray(extra_keys, np.int32)])
            parts = np.concatenate([parts, np.asarray(extra_parts, np.int32)])
            repl = np.concatenate([repl, np.asarray(extra_repl, np.int32)])
        cap = self.heavy_keys.shape[0]
        if len(keys) > cap:
            cap = heavy_capacity_for(0.0, self.num_partitions, floor=len(keys))
        hk, hp, hr = _pad_heavy(keys, parts, cap, repl)
        return dataclasses.replace(
            self, heavy_keys=hk, heavy_parts=hp, heavy_repl=hr
        )


def _pad_heavy(keys: np.ndarray, parts: np.ndarray, capacity: int, repl=None):
    """Sort by key and sentinel-pad heavy tables to fixed width.

    ``repl`` (replicas per key) defaults to all-ones; its pad value is 0,
    which the route clamps to 1, so sentinel records take replica choice 0."""
    if repl is None:
        repl = np.ones(len(keys), np.int32)
    order = np.argsort(keys, kind="stable")
    keys, parts, repl = keys[order], parts[order], np.asarray(repl)[order]
    pad = capacity - len(keys)
    assert pad >= 0, f"heavy table overflow: {len(keys)} > {capacity}"
    keys = np.concatenate([keys, np.full(pad, KEY_SENTINEL, np.int32)])
    parts = np.concatenate([parts, np.zeros(pad, np.int32)])
    repl = np.concatenate([repl, np.zeros(pad, np.int32)])
    return keys.astype(np.int32), parts.astype(np.int32), repl.astype(np.int32)


def uniform_partitioner(
    num_partitions: int,
    num_hosts: int = DEFAULT_NUM_HOSTS,
    seed: int = 0,
    heavy_capacity: int = 0,
) -> Partitioner:
    """UHP — the Spark/Flink default: hash(key) mod N (host table = h mod N)."""
    host_to_part = (np.arange(num_hosts, dtype=np.int64) % num_partitions).astype(np.int32)
    hk, hp, _ = _pad_heavy(np.zeros(0, np.int32), np.zeros(0, np.int32), heavy_capacity)
    return Partitioner(num_partitions, hk, hp, host_to_part, seed)


def kip_update(
    prev: Partitioner,
    hist: Histogram,
    num_partitions: int | None = None,
    eps: float = 0.01,
    heavy_capacity: int | None = None,
    tight: bool = False,
) -> Partitioner:
    """Algorithm 1 — KIPUPDATE(KI, HASH, H, Hist, N, eps).

    ``prev`` is KI (the partitioner of the previous stage); its
    ``host_to_part`` also serves as the HASH host mapping when probing a
    heavy key's fallback location.  ``num_partitions`` may differ from
    ``prev.num_partitions`` (elastic resize uses this).
    """
    n = int(num_partitions or prev.num_partitions)
    h = prev.num_hosts
    seed = prev.seed
    b = len(hist)
    cap = heavy_capacity if heavy_capacity is not None else max(b, prev.heavy_keys.shape[0])

    keys = hist.keys.astype(np.int64)
    freqs = hist.freqs.astype(np.float64)

    # line 1: allowed load level
    top_freq = float(freqs[0]) if b else 0.0
    maxload = max(1.0 / n, top_freq) + eps
    # line 2: average load carried by one host (tail mass spread over hosts)
    hostload = max(0.0, 1.0 - float(freqs.sum())) / h

    load = np.zeros(n, np.float64)
    prev_heavy = prev.heavy_map()
    # previous assignment of each heavy key under KI
    prev_part = prev.lookup_np(keys.astype(np.int32))
    # the pure-hash (future non-heavy) location under the previous host map
    hash_host = hash_to_host(keys.astype(np.int32), h, seed)
    hash_part = prev.host_to_part[hash_host]
    if n < prev.num_partitions:  # elastic shrink: fold removed partitions
        prev_part = prev_part % n
        hash_part = hash_part % n
        prev_heavy = {k: p % n for k, p in prev_heavy.items()}

    heavy_parts = np.zeros(b, np.int32)
    for i in range(b):  # Hist is ordered by decreasing frequency
        f = freqs[i]
        p = int(prev_heavy.get(int(keys[i]), prev_part[i]))  # line 4: KI(k)
        if load[p] < maxload - f:  # line 5
            heavy_parts[i] = p
            load[p] += f
            continue
        p = int(hash_part[i])  # line 7: HASH(k)
        if load[p] < maxload - f:  # line 8
            heavy_parts[i] = p
            load[p] += f
            continue
        p = int(np.argmin(load))  # line 10: lowest-load partition
        heavy_parts[i] = p
        load[p] += f

    # lines 11-13: add host loads under the previous host->partition mapping
    host_to_part = prev.host_to_part.copy()
    if n < prev.num_partitions:
        host_to_part = host_to_part % n
    hosts_per_part = np.bincount(host_to_part, minlength=n).astype(np.float64)
    load = load + hostload * hosts_per_part

    # lines 14-15: greedy bin packing — move hosts off overloaded partitions
    if tight and hostload > 0:
        # Beyond-paper 'tight' mode: Algorithm 1 only rebins hosts when a
        # partition exceeds MAXLOAD, which for f1 >> 1/N leaves the tail
        # spread untouched.  Waterfill instead: equalize total loads at the
        # level L solving sum_p max(0, L - heavy_load[p]) = tail_mass, and
        # move the minimal number of hosts toward per-partition quotas.
        heavy_only = load - hostload * hosts_per_part
        tail_mass = hostload * h
        lo, hi = heavy_only.min(), heavy_only.max() + tail_mass + hostload
        for _ in range(60):  # bisection on the waterline
            mid = 0.5 * (lo + hi)
            if np.maximum(0.0, mid - heavy_only).sum() > tail_mass:
                hi = mid
            else:
                lo = mid
        quota = np.maximum(0.0, hi - heavy_only) / hostload
        quota = np.floor(quota).astype(int)
        # distribute leftover host slots to lowest-load partitions
        leftover = h - quota.sum()
        order = np.argsort(heavy_only + quota * hostload)
        for i in range(leftover):
            quota[order[i % n]] += 1
        hosts_of = [list(np.where(host_to_part == p)[0]) for p in range(n)]
        surplus = []
        for p in range(n):
            while len(hosts_of[p]) > quota[p]:
                surplus.append(hosts_of[p].pop())
        for p in range(n):
            while len(hosts_of[p]) < quota[p] and surplus:
                hh = surplus.pop()
                host_to_part[hh] = p
                hosts_of[p].append(hh)
        hosts_per_part = np.bincount(host_to_part, minlength=n).astype(np.float64)
        load = heavy_only + hostload * hosts_per_part
    elif hostload > 0:
        order_src = np.argsort(-load, kind="stable")
        # hosts grouped per partition for O(H) moves
        hosts_of = [np.where(host_to_part == p)[0].tolist() for p in range(n)]
        dst_iter = 0
        dsts = np.argsort(load, kind="stable").tolist()
        for p in order_src.tolist():
            while load[p] > maxload and hosts_of[p]:
                # first partition with room for one more host
                while dst_iter < len(dsts) and (
                    dsts[dst_iter] == p or load[dsts[dst_iter]] >= maxload - hostload
                ):
                    dst_iter += 1
                if dst_iter >= len(dsts):
                    break  # nowhere below the bound: leave residual imbalance
                q = dsts[dst_iter]
                hh = hosts_of[p].pop()
                host_to_part[hh] = q
                hosts_of[q].append(hh)
                load[p] -= hostload
                load[q] += hostload

    # a fresh plan carries no replica column: the DR master re-stamps its
    # split set via ``with_splits`` after installing the new partitioner
    hk, hp, _ = _pad_heavy(keys.astype(np.int32), heavy_parts, max(cap, b))
    return Partitioner(n, hk, hp, host_to_part.astype(np.int32), seed)


def resize_partitioner(
    prev: Partitioner,
    num_partitions: int,
    hist: Histogram | None = None,
    *,
    eps: float = 0.01,
    heavy_capacity: int | None = None,
    tight: bool = True,
) -> Partitioner:
    """Elastic grow/shrink: re-plan ``prev`` for a different partition count.

    This is :func:`kip_update` with ``num_partitions != prev.num_partitions``
    (a shrink folds removed partitions, ``p % n``; a grow relies on the host
    re-binning, waterfilled under ``tight``, to populate the new ones), plus
    a resize before any histogram exists: an empty histogram still re-bins
    hosts, so every partition receives hash traffic right after the resize.
    """
    n = int(num_partitions)
    if n < 1:
        raise ValueError(f"num_partitions must be >= 1, got {n}")
    if hist is None:
        hist = Histogram(np.zeros(0, np.int64), np.zeros(0), 0.0)
    return kip_update(prev, hist, num_partitions=n, eps=eps,
                      heavy_capacity=heavy_capacity, tight=tight)


def heavy_capacity_for(lam: float, num_partitions: int, *, floor: int = 0) -> int:
    """Heavy-table width for tracking ``lam`` keys per partition, rounded up
    to the route kernels' tile width (``HEAVY_TILE``).

    The one shared rounding rule for every sizing site (streaming driver,
    repartition policy).  ``floor`` lower-bounds the result before rounding
    (e.g. the current table width, to keep table shapes stable)."""
    want = max(int(np.ceil(lam * num_partitions)), int(floor), 1)
    return int(-(-want // HEAVY_TILE) * HEAVY_TILE)


def split_replica_rows(
    partitioner: Partitioner,
    keys: np.ndarray,
    num_workers: int = 1,
    valid: np.ndarray | None = None,
) -> np.ndarray:
    """Host twin of the route kernels' replica pick: the rows each partition
    receives from *split* keys this batch (``int64[num_partitions]``).

    Worker ``i`` owns the contiguous chunk ``keys[i*local:(i+1)*local]`` and
    a record's replica hash uses its *local* index in that chunk, as on the
    device: replica ``(fmix32(idx * golden ^ mixed) & 0x7FFFFFFF) % d`` past
    the key's home."""
    n = partitioner.num_partitions
    out = np.zeros(n, np.int64)
    smap = partitioner.split_map()
    if not smap:
        return out
    keys = np.asarray(keys, np.int32).reshape(num_workers, -1)
    if valid is not None:
        valid = np.asarray(valid, bool).reshape(keys.shape)
    seed = np.uint32(seed_mix(partitioner.seed))
    for k, d in smap.items():
        m = keys == np.int32(k)
        if valid is not None:
            m &= valid
        idx = (np.flatnonzero(m) % keys.shape[1]).astype(np.uint32)  # local indices
        if not len(idx):
            continue
        # the key's own mix is one constant: hash only the key's records
        mixed = fmix32(np.asarray([k], np.uint32) ^ seed)
        h = fmix32(idx * np.uint32(GOLDEN) ^ mixed)
        choice31 = (h & np.uint32(0x7FFFFFFF)).astype(np.int32)
        home = int(partitioner.lookup_np(np.asarray([k], np.int32))[0])
        out += np.bincount((home + choice31 % np.int32(d)) % n, minlength=n)
    return out


# ---------------------------------------------------------------------------
# Balance metrics (paper's evaluation currency)
# ---------------------------------------------------------------------------


def load_imbalance(partitioner: Partitioner, key_stream: np.ndarray) -> float:
    """max(load) / mean(load) over the actual key stream (paper Fig. 2/3)."""
    parts = partitioner.lookup_np(np.asarray(key_stream, np.int32))
    loads = np.bincount(parts, minlength=partitioner.num_partitions)
    return float(loads.max() / max(loads.mean(), 1e-12))


def expected_loads(partitioner: Partitioner, hist: Histogram) -> np.ndarray:
    """Planner's view of per-partition load given a histogram."""
    n = partitioner.num_partitions
    load = np.zeros(n)
    parts = partitioner.lookup_np(hist.keys.astype(np.int32))
    np.add.at(load, parts, hist.freqs)
    hosts_per_part = np.bincount(partitioner.host_to_part, minlength=n)
    load += hist.tail_mass / partitioner.num_hosts * hosts_per_part
    return load
