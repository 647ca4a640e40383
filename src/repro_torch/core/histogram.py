"""Key-frequency histograms (DRW sampling + DRM merging).

The DR master keeps the top ``B = lambda * N`` keys in a global histogram
``Hist`` whose entries carry *relative* frequencies.  Workers build small
exact summaries of each micro-batch during normal routing work
(:func:`local_topk_histogram`, on the device); the master merges them into
a drift-respecting :class:`CounterSketch` on the host.

Besides :class:`CounterSketch`, the host keeps the sketches the paper
compares it with: :class:`SpaceSaving` (Metwally et al.),
:class:`LossyCounting` (Manku & Motwani) and :class:`CountMinSketch`.
Every host class here is numpy (the two sequential sketches plain Python
dicts) and bit-identical to ``repro.core.histogram``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hashing import GOLDEN, fmix32

__all__ = [
    "Histogram",
    "CounterSketch",
    "SpaceSaving",
    "LossyCounting",
    "CountMinSketch",
    "local_topk_histogram",
]


@dataclasses.dataclass(frozen=True)
class Histogram:
    """Top-B histogram with *relative* frequencies, sorted descending.

    ``keys[i]`` has estimated frequency ``freqs[i]`` (fraction of all input).
    ``sum(freqs) <= 1``; the remainder is the untracked tail mass.
    """

    keys: np.ndarray  # int64[B]
    freqs: np.ndarray  # float64[B], descending
    total_weight: float  # absolute number of records observed

    def __post_init__(self):
        assert self.keys.shape == self.freqs.shape
        if len(self.freqs) > 1:
            assert np.all(np.diff(self.freqs) <= 1e-12), "freqs must be descending"

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def tail_mass(self) -> float:
        return max(0.0, 1.0 - float(self.freqs.sum()))

    def top(self, b: int) -> "Histogram":
        return Histogram(self.keys[:b], self.freqs[:b], self.total_weight)

    @staticmethod
    def from_counts(keys, counts, total: float | None = None) -> "Histogram":
        keys = np.asarray(keys, dtype=np.int64)
        counts = np.asarray(counts, dtype=np.float64)
        order = np.argsort(-counts, kind="stable")
        keys, counts = keys[order], counts[order]
        total = float(counts.sum()) if total is None else float(total)
        freqs = counts / max(total, 1e-30)
        return Histogram(keys, freqs, total)

    @staticmethod
    def exact(key_stream: np.ndarray) -> "Histogram":
        keys, counts = np.unique(np.asarray(key_stream), return_counts=True)
        return Histogram.from_counts(keys, counts)

    @staticmethod
    def merge(hists: Sequence["Histogram"], top_b: int | None = None) -> "Histogram":
        """DRM merge of per-worker local histograms (weight = records seen)."""
        if not hists:
            return Histogram(np.zeros(0, np.int64), np.zeros(0), 0.0)
        acc: dict[int, float] = {}
        total = 0.0
        for h in hists:
            total += h.total_weight
            w = h.total_weight
            for k, f in zip(h.keys.tolist(), h.freqs.tolist()):
                acc[k] = acc.get(k, 0.0) + f * w
        merged = Histogram.from_counts(
            np.fromiter(acc.keys(), np.int64, len(acc)),
            np.fromiter(acc.values(), np.float64, len(acc)),
            total=total,
        )
        return merged.top(top_b) if top_b is not None else merged

    def ewma(self, newer: "Histogram", alpha: float, top_b: int | None = None) -> "Histogram":
        """Drift-respecting blend: keep a record of past histograms.

        ``alpha`` is the weight of the *new* histogram; old mass decays by
        ``1 - alpha`` so heavy keys must persist to stay isolated.
        """
        acc: dict[int, float] = {}
        for k, f in zip(self.keys.tolist(), self.freqs.tolist()):
            acc[k] = acc.get(k, 0.0) + (1.0 - alpha) * f
        for k, f in zip(newer.keys.tolist(), newer.freqs.tolist()):
            acc[k] = acc.get(k, 0.0) + alpha * f
        keys = np.fromiter(acc.keys(), np.int64, len(acc))
        vals = np.fromiter(acc.values(), np.float64, len(acc))
        order = np.argsort(-vals, kind="stable")
        out = Histogram(keys[order], vals[order], newer.total_weight)
        return out.top(top_b) if top_b is not None else out


# ---------------------------------------------------------------------------
# Host-side sketches
# ---------------------------------------------------------------------------


class CounterSketch:
    """The DRW counter-based heuristic (paper §4 / extended paper).

    A fixed table of ``capacity`` (key, count) pairs.  Batches are counted
    exactly (vectorized ``np.unique``) and merged with the SpaceSaving merge
    rule: evicted keys donate their count to the minimum-count floor so the
    estimate stays an over-approximation.  A multiplicative ``decay`` applied
    per batch makes the summary drift-respecting: keys that stop being heavy
    fade out within a few micro-batches.
    """

    def __init__(self, capacity: int, decay: float = 1.0):
        assert capacity > 0 and 0.0 < decay <= 1.0
        self.capacity = capacity
        self.decay = decay
        self._keys = np.zeros(0, np.int64)
        self._counts = np.zeros(0, np.float64)
        self._floor = 0.0  # SpaceSaving-style minimum for unseen keys
        self.total = 0.0

    def update(self, key_batch: np.ndarray) -> None:
        keys, counts = np.unique(np.asarray(key_batch, np.int64), return_counts=True)
        self.update_counts(keys, counts.astype(np.float64))

    def update_counts(self, keys: np.ndarray, counts: np.ndarray,
                      total: float | None = None) -> None:
        """``total``: true number of records the counts were sampled from
        (a top-k summary undercounts the tail; without the true total the
        relative frequencies would be inflated by 1/coverage)."""
        if self.decay < 1.0:
            self._counts *= self.decay
            self._floor *= self.decay
            self.total *= self.decay
        self.total += float(counts.sum()) if total is None else float(total)
        # merge exact batch counts into the summary
        all_keys = np.concatenate([self._keys, np.asarray(keys, np.int64)])
        new_mask = np.concatenate(
            [np.zeros(len(self._keys), bool), np.ones(len(keys), bool)]
        )
        all_counts = np.concatenate([self._counts, np.asarray(counts, np.float64)])
        # keys new to the summary enter at floor + their batch count
        all_counts = all_counts + np.where(new_mask, self._floor, 0.0)
        uniq, inv = np.unique(all_keys, return_inverse=True)
        merged = np.zeros(len(uniq))
        np.add.at(merged, inv, all_counts)
        # a key present both in summary and batch was given the floor once: ok
        dup = np.zeros(len(uniq))
        np.add.at(dup, inv, new_mask & np.isin(all_keys, self._keys))
        merged -= dup * self._floor
        if len(uniq) > self.capacity:
            order = np.argsort(-merged, kind="stable")
            keep = order[: self.capacity]
            self._floor = float(merged[order[self.capacity]])
            self._keys, self._counts = uniq[keep], merged[keep]
        else:
            self._keys, self._counts = uniq, merged

    def histogram(self, top_b: int | None = None) -> Histogram:
        h = Histogram.from_counts(self._keys, self._counts, total=max(self.total, 1e-30))
        return h.top(top_b) if top_b is not None else h

    def rescale(self) -> int:
        """Re-warm the summary when its heavy-key budget changes meaning.

        The DRM reads the top ``B = lam * N`` entries; an elastic resize
        jumps ``N``, so a *grow* suddenly reads deeper into the table —
        into entries whose count is dominated by the SpaceSaving floor
        (the over-approximation every evicted key donates on entry) rather
        than by observed traffic.  Those stale-tail entries would surface
        as freshly isolated "heavy" keys purely because they entered the
        table recently.  Dropping every entry without at least a floor's
        worth of evidence beyond the inherited floor (``count < 2 * floor``)
        re-warms the summary: surviving entries are backed by real counts,
        and genuinely heavy keys sit far above the cut.  Returns the number
        of entries dropped.  A no-op while the table has never evicted
        (``floor == 0`` — every count is exact).
        """
        if self._floor <= 0.0 or len(self._keys) == 0:
            return 0
        keep = self._counts >= 2.0 * self._floor
        dropped = int((~keep).sum())
        if dropped:
            self._keys = self._keys[keep]
            self._counts = self._counts[keep]
        return dropped

    @property
    def memory_items(self) -> int:
        return len(self._keys)


class SpaceSaving:
    """Metwally et al. stream-summary (sequential reference implementation).

    A record at a full table evicts the first minimum in the dict's
    insertion order and enters at the end: the dict's order decides ties
    here and in :meth:`histogram`'s stable sort."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.counts: dict[int, float] = {}
        self.total = 0.0

    def update(self, key_batch) -> None:
        for k in np.asarray(key_batch).tolist():
            self.total += 1.0
            if k in self.counts:
                self.counts[k] += 1.0
            elif len(self.counts) < self.capacity:
                self.counts[k] = 1.0
            else:
                mk = min(self.counts, key=self.counts.get)
                mv = self.counts.pop(mk)
                self.counts[k] = mv + 1.0

    def histogram(self, top_b: int | None = None) -> Histogram:
        return _dict_histogram(self.counts, self.total, top_b)

    @property
    def memory_items(self) -> int:
        return len(self.counts)


class LossyCounting:
    """Manku & Motwani lossy counting with bucket width ceil(1/eps)."""

    def __init__(self, epsilon: float):
        self.epsilon = epsilon
        self.width = int(np.ceil(1.0 / epsilon))
        self.counts: dict[int, float] = {}
        self.deltas: dict[int, float] = {}
        self.total = 0.0
        self._bucket = 1

    def update(self, key_batch) -> None:
        for k in np.asarray(key_batch).tolist():
            self.total += 1.0
            if k in self.counts:
                self.counts[k] += 1.0
            else:
                self.counts[k] = 1.0
                self.deltas[k] = self._bucket - 1
            if int(self.total) % self.width == 0:
                self._prune()
                self._bucket += 1

    def _prune(self) -> None:
        dead = [k for k, c in self.counts.items() if c + self.deltas[k] <= self._bucket]
        for k in dead:
            del self.counts[k]
            del self.deltas[k]

    def histogram(self, top_b: int | None = None) -> Histogram:
        return _dict_histogram(self.counts, self.total, top_b)

    @property
    def memory_items(self) -> int:
        return len(self.counts)


def _dict_histogram(counts: dict, total: float, top_b: int | None) -> Histogram:
    """A sequential sketch's ``{key: count}`` as a histogram, ties in the
    dict's order (``Histogram.from_counts`` sorts stably)."""
    if not counts:
        return Histogram(np.zeros(0, np.int64), np.zeros(0), 0.0)
    h = Histogram.from_counts(
        np.fromiter(counts.keys(), np.int64, len(counts)),
        np.fromiter(counts.values(), np.float64, len(counts)),
        total=max(total, 1e-30),
    )
    return h.top(top_b) if top_b is not None else h


class CountMinSketch:
    """Count-min sketch + candidate set, vectorized over batches.

    The device path for the row updates is the ``sketch_update`` kernel
    (:func:`repro_torch.kernels.ops.count_sketch`); this host class mirrors
    it bit for bit (the same fmix32 row hashing) and adds the top-k
    candidate tracking the kernel leaves to the host.
    """

    def __init__(self, depth: int, width: int, candidates: int = 256):
        self.depth, self.width = depth, width
        self.table = np.zeros((depth, width), np.float64)
        self.total = 0.0
        self.k = candidates
        self._cand: dict[int, float] = {}

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        return np.stack([fmix32((keys ^ (d * GOLDEN)) & 0xFFFFFFFF) % self.width
                         for d in range(self.depth)])  # [depth, n]

    def update(self, key_batch: np.ndarray) -> None:
        keys, counts = np.unique(np.asarray(key_batch, np.int64), return_counts=True)
        self.total += float(counts.sum())
        cols = self._rows(keys)
        for d in range(self.depth):
            np.add.at(self.table[d], cols[d], counts)
        est = self.estimate(keys)
        for k, e in zip(keys.tolist(), est.tolist()):
            self._cand[k] = e
        if len(self._cand) > self.k:
            keep = sorted(self._cand.items(), key=lambda kv: -kv[1])[: self.k]
            self._cand = dict(keep)

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        cols = self._rows(keys)
        ests = np.stack([self.table[d, cols[d]] for d in range(self.depth)])
        return ests.min(axis=0)

    def histogram(self, top_b: int | None = None) -> Histogram:
        if not self._cand:
            return Histogram(np.zeros(0, np.int64), np.zeros(0), 0.0)
        keys = np.fromiter(self._cand.keys(), np.int64, len(self._cand))
        h = Histogram.from_counts(keys, self.estimate(keys), total=max(self.total, 1e-30))
        return h.top(top_b) if top_b is not None else h

    @property
    def memory_items(self) -> int:
        return self.depth * self.width + len(self._cand)


# ---------------------------------------------------------------------------
# Device-side exact top-k of one micro-batch per worker — the DRW hook.
# ---------------------------------------------------------------------------


def local_topk_histogram(keys: torch.Tensor, valid: torch.Tensor, k: int):
    """Exact top-k (key, count) of each worker's padded key batch.

    ``keys`` / ``valid`` are ``[W, n]`` (1-D: one worker).  Returns
    ``(topk_keys i32[W, k], topk_counts i32[W, k], total i32[W])``; unused
    slots carry key ``-1`` and count ``0``.  Equal counts keep the lowest
    segment index first, as ``lax.top_k`` does (``torch.topk`` does not
    promise an order among ties, so a stable descending sort takes its
    place).
    """
    one = keys.dim() == 1
    if one:
        keys, valid = keys.unsqueeze(0), valid.unsqueeze(0)
    w, n = keys.shape
    big = 2**62 if keys.dtype == torch.int64 else 2**31 - 1
    masked = torch.where(valid, keys, torch.full_like(keys, big))
    s, _ = torch.sort(masked, dim=1)
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    seg_id = torch.cumsum(start, dim=1) - 1
    counts = torch.zeros((w, n), dtype=torch.int32, device=keys.device)
    counts.scatter_add_(1, seg_id, (masked != big).to(torch.int32))
    seg_keys = torch.zeros_like(s).scatter_reduce_(
        1, seg_id, torch.where(start, s, torch.full_like(s, -big)), "amax")
    k = min(k, n)
    top_counts, idx = torch.sort(counts, dim=1, descending=True, stable=True)
    top_counts, idx = top_counts[:, :k], idx[:, :k]
    top_keys = torch.gather(seg_keys, 1, idx)
    top_keys = torch.where(top_counts > 0, top_keys, torch.full_like(top_keys, -1))
    total = valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    if one:
        return top_keys[0], top_counts[0], total[0]
    return top_keys, top_counts, total
