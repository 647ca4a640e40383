"""The paper's baselines (Readj, Redist, Scan, Mixed), the SpaceSaving and
LossyCounting sketches and ``host_skew_keys`` in the port, against the live
reference on the same numpy inputs.

All of these are host numpy (the two sketches plain Python dicts), so every
comparison is bit for bit, with no tolerance: each ``Partitioner`` field by
``np.array_equal`` with its dtype, each histogram's keys and freqs by their
bytes, ``total_weight`` by ``==``, each sketch's dicts with their order."""
import functools

import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.histogram import Histogram as JHistogram
from repro.core.histogram import LossyCounting as JLossyCounting
from repro.core.histogram import SpaceSaving as JSpaceSaving
from repro.core.partitioner import Partitioner as JPartitioner
from repro.core.partitioner import kip_update as j_kip_update
from repro.core.partitioner import uniform_partitioner as j_uniform
from repro.data.generators import drifting_zipf as j_drifting_zipf
from repro.data.generators import host_skew_keys as j_host_skew_keys
from repro.data.generators import zipf_keys as j_zipf_keys
from repro_torch.core import (LossyCounting, SpaceSaving, make_baseline, mixed_update,
                              readj_update, redist_update, scan_update)
from repro_torch.core.histogram import Histogram
from repro_torch.core.migration import plan_migration
from repro_torch.core.partitioner import (Partitioner, kip_update, load_imbalance,
                                          uniform_partitioner)
from repro_torch.data.generators import drifting_zipf, host_skew_keys, zipf_keys

NAMES = ["readj", "redist", "scan", "mixed"]
UPDATES = {"readj": (readj_update, jb.readj_update), "redist": (redist_update, jb.redist_update),
           "scan": (scan_update, jb.scan_update), "mixed": (mixed_update, jb.mixed_update)}
# each baseline's keyword values: the defaults, a tight and a loose bound,
# and Mixed's explicit-key budget below and above the histogram's length
KWARGS = ([(name, kw) for name in ("readj", "redist", "scan")
           for kw in ({}, {"theta": 0.0}, {"theta": 0.5})]
          + [("mixed", kw) for kw in ({}, {"theta_max": 0.0}, {"theta_max": 0.5},
                                      {"a_max": 8}, {"theta_max": 0.02, "a_max": 1000})])


def _same_bits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _same_partitioner(got: Partitioner, want: JPartitioner) -> None:
    assert (got.num_partitions, got.seed) == (want.num_partitions, want.seed)
    assert got.heavy_repl is None and want.heavy_repl is None
    for name in ("heavy_keys", "heavy_parts", "host_to_part"):
        _same_bits(getattr(got, name), getattr(want, name), name)
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def _same_histogram(got: Histogram, want: JHistogram) -> None:
    _same_bits(got.keys, want.keys, "keys")
    _same_bits(got.freqs, want.freqs, "freqs")
    assert got.total_weight == want.total_weight


def _j_partitioner(p: Partitioner) -> JPartitioner:
    """The reference's partitioner with the port's tables (copies)."""
    return JPartitioner(p.num_partitions, p.heavy_keys.copy(), p.heavy_parts.copy(),
                        p.host_to_part.copy(), p.seed)


def _j_histogram(h: Histogram) -> JHistogram:
    return JHistogram(h.keys.copy(), h.freqs.copy(), h.total_weight)


def _both(name, prev, hist, n, **kw):
    """One baseline update by each package on the same inputs, held equal."""
    mine, ref = UPDATES[name]
    want = ref(_j_partitioner(prev), _j_histogram(hist), n, **kw)
    got = mine(prev, hist, n, **kw)
    _same_partitioner(got, want)
    return got


@functools.lru_cache(maxsize=None)
def _zipf_hist() -> Histogram:
    keys = zipf_keys(200_000, num_keys=50_000, exponent=1.1, seed=11)
    hist = Histogram.exact(keys)
    _same_histogram(hist, JHistogram.exact(j_zipf_keys(200_000, num_keys=50_000,
                                                       exponent=1.1, seed=11)))
    return hist


# ---------------------------------------------------------------------------
# Each baseline, one update from UHP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", KWARGS, ids=lambda x: str(x))
@pytest.mark.parametrize("n", [4, 16, 35, 64])
def test_baseline_matches_reference(name, kw, n):
    hist = _zipf_hist().top(2 * n)
    _both(name, uniform_partitioner(n), hist, n, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_baseline_over_1536_keys_and_default_partition_count(name):
    """A table above the kernels' probe size (1,024 rows), and
    ``num_partitions`` left to ``prev``'s."""
    hist = _zipf_hist().top(1536)
    got = _both(name, uniform_partitioner(64, seed=3), hist, None)
    assert got.heavy_keys.shape == (1536,) and got.num_partitions == 64


@pytest.mark.parametrize("name", NAMES)
def test_baseline_to_another_partition_count(name):
    """``num_partitions`` other than ``prev``'s: the tail loads still count
    ``prev``'s host table."""
    _both(name, uniform_partitioner(16), _zipf_hist().top(48), 24)


# ---------------------------------------------------------------------------
# Chained updates: ``prev`` is the last update's own output, or a KIP table
# ---------------------------------------------------------------------------


def _drift_batches():
    batches = list(drifting_zipf(8, 20_000, num_keys=4_000, exponent=1.0, drift_every=2,
                                 drift_fraction=0.3, seed=9))
    for got, want in zip(batches, j_drifting_zipf(8, 20_000, num_keys=4_000, exponent=1.0,
                                                  drift_every=2, drift_fraction=0.3, seed=9)):
        _same_bits(got, want, "batch")
    return batches


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n", [16, 35])
def test_chained_updates_match_reference(name, n):
    """Eight drifting batches, each baseline updated every batch on its own
    last output (the reference chained on its own output too)."""
    mine, ref = UPDATES[name]
    got, want = uniform_partitioner(n), j_uniform(n)
    for batch in _drift_batches():
        hist, jhist = Histogram.exact(batch).top(2 * n), JHistogram.exact(batch).top(2 * n)
        _same_histogram(hist, jhist)
        got, want = mine(got, hist, n), ref(want, jhist, n)
        _same_partitioner(got, want)
    assert got.num_heavy > 0


@pytest.mark.parametrize("name", NAMES)
def test_chained_updates_from_a_kip_table(name):
    """The chain starts from a KIP partitioner (re-binned hosts, a heavy
    table padded to 128 rows: wider than the histograms that follow)."""
    n = 20
    batches = _drift_batches()
    first = Histogram.exact(batches[0]).top(4 * n)
    got = kip_update(uniform_partitioner(n, heavy_capacity=128), first, tight=True)
    want = j_kip_update(j_uniform(n, heavy_capacity=128), _j_histogram(first), tight=True)
    _same_partitioner(got, want)
    assert not np.array_equal(got.host_to_part, uniform_partitioner(n).host_to_part)
    mine, ref = UPDATES[name]
    for batch in batches[1:]:
        hist = Histogram.exact(batch).top(2 * n)
        got, want = mine(got, hist, n), ref(want, _j_histogram(hist), n)
        _same_partitioner(got, want)
        assert got.heavy_keys.shape == (128,)


# ---------------------------------------------------------------------------
# Edge cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("capacity", [0, 128])
def test_empty_histogram(name, capacity):
    """No tracked key: on UHP the table keeps ``prev``'s width, 0 rows
    without a heavy capacity."""
    empty = Histogram(np.zeros(0, np.int64), np.zeros(0), 0.0)
    got = _both(name, uniform_partitioner(8, heavy_capacity=capacity), empty, 8)
    assert got.heavy_keys.shape == (capacity,) and got.num_heavy == 0


@pytest.mark.parametrize("name,kw", KWARGS, ids=lambda x: str(x))
@pytest.mark.parametrize("size", [60, 600])
def test_tied_frequencies(name, kw, size):
    """Runs of equal frequencies: the dict order, the stable sort of the
    histogram and numpy's default argsort in Readj decide the ties.  Above
    256 members of one partition that argsort orders equal values otherwise
    than a stable sort does (numpy 2's vectorised sort)."""
    rng = np.random.default_rng(5)
    keys = rng.choice(2**30, size=size, replace=False)
    counts = np.repeat([40.0, 40.0, 25.0, 25.0, 25.0, 25.0, 10.0, 10.0, 10.0, 10.0, 10.0, 10.0],
                       size // 12)
    total = float(counts.sum()) * 1.5
    hist = Histogram.from_counts(keys, counts, total=total)
    _same_histogram(hist, JHistogram.from_counts(keys, counts, total=total))
    _both(name, uniform_partitioner(6), hist, 6, **kw)
    # every key on one partition first, so Readj's argsort orders the ties
    # among that partition's members
    prev = Partitioner(6, np.sort(keys).astype(np.int32), np.zeros(size, np.int32),
                       uniform_partitioner(6).host_to_part.copy(), 0)
    _both(name, prev, hist, 6, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_prev_table_wider_than_the_histogram(name):
    prev = uniform_partitioner(12, heavy_capacity=256)
    got = _both(name, prev, _zipf_hist().top(10), 12)
    assert got.heavy_keys.shape == (256,) and got.num_heavy == 10


def test_make_baseline_hash_and_unknown_names():
    update, prev = make_baseline("hash", 16, num_hosts=1024, seed=7)
    jupdate, jprev = jb.make_baseline("hash", 16, num_hosts=1024, seed=7)
    _same_partitioner(prev, jprev)
    hist = _zipf_hist().top(32)
    assert update(prev, hist, 16) is prev and update(prev, hist) is prev
    assert update(prev, hist, 16, theta=0.3) is prev
    for name in NAMES:
        update, prev = make_baseline(name, 10, num_hosts=2048, seed=2)
        jupdate, jprev = jb.make_baseline(name, 10, num_hosts=2048, seed=2)
        assert update is UPDATES[name][0]
        _same_partitioner(prev, jprev)
        _same_partitioner(update(prev, hist, 10), jupdate(jprev, _j_histogram(hist), 10))
    with pytest.raises(KeyError) as got:
        make_baseline("kip", 4)
    with pytest.raises(KeyError) as want:
        jb.make_baseline("kip", 4)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# SpaceSaving and LossyCounting
# ---------------------------------------------------------------------------


def _same_sketch(got, want) -> None:
    assert list(got.counts.items()) == list(want.counts.items())
    assert all(type(k) is int for k in got.counts)
    if hasattr(want, "deltas"):
        assert list(got.deltas.items()) == list(want.deltas.items())
        assert (got._bucket, got.width, got.epsilon) == (want._bucket, want.width, want.epsilon)
    assert got.total == want.total and got.memory_items == want.memory_items
    for top_b in (None, 1, 5):
        _same_histogram(got.histogram(top_b), want.histogram(top_b))


def _sketch_stream(seed: int) -> list[np.ndarray]:
    """Batches over few keys with many equal counts (ties), then a shift of
    the heavy set."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40, 700)
    b = zipf_keys(1_500, num_keys=300, exponent=1.2, seed=seed)
    c = np.repeat(np.arange(100, 130), 3)
    return [a, b[:800], c, b[800:]]


@pytest.mark.parametrize("capacity", [1, 7, 64])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_spacesaving_matches_reference(capacity, seed, as_tensor):
    got, want = SpaceSaving(capacity), JSpaceSaving(capacity)
    _same_sketch(got, want)
    for batch in _sketch_stream(seed):
        got.update(torch.as_tensor(batch) if as_tensor else batch)
        want.update(batch)
        _same_sketch(got, want)
    assert got.memory_items == min(capacity, len(np.unique(np.concatenate(_sketch_stream(seed)))))


@pytest.mark.parametrize("epsilon", [0.05, 0.01, 0.003])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_lossy_counting_matches_reference(epsilon, seed, as_tensor):
    got, want = LossyCounting(epsilon), JLossyCounting(epsilon)
    _same_sketch(got, want)
    for batch in _sketch_stream(seed):
        got.update(torch.as_tensor(batch) if as_tensor else batch)
        want.update(batch)
        _same_sketch(got, want)
    assert got._bucket > 1  # at least one bucket boundary pruned


def test_sketches_on_int32_keys_and_an_empty_batch():
    keys = zipf_keys(3_000, num_keys=500, exponent=1.0, seed=4).astype(np.int32)
    for mine, ref in ((SpaceSaving(20), JSpaceSaving(20)),
                      (LossyCounting(0.02), JLossyCounting(0.02))):
        mine.update(np.zeros(0, np.int64))
        ref.update(np.zeros(0, np.int64))
        _same_sketch(mine, ref)
        mine.update(keys)
        ref.update(keys)
        _same_sketch(mine, ref)


# ---------------------------------------------------------------------------
# host_skew_keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    dict(num_hosts=960, giants=16, giant_mass=0.5, seed=49),
    dict(num_hosts=192, giants=1, giant_mass=0.3, seed=3),
    dict(num_hosts=100, giants=4, giant_mass=0.0, seed=8),
    dict(num_hosts=5, giants=5, giant_mass=1.0, seed=1),
    dict(num_hosts=1024, giants=64, giant_mass=0.5, seed=42),
], ids=str)
def test_host_skew_keys_matches_reference(kw):
    got, want = host_skew_keys(20_000, **kw), j_host_skew_keys(20_000, **kw)
    _same_bits(got, want, "keys")
    assert got.dtype == np.int64
    assert len(np.unique(got)) <= kw.get("num_hosts", 64)


def test_host_skew_keys_without_giants_raises_as_the_reference():
    with pytest.raises(ZeroDivisionError):
        j_host_skew_keys(100, num_hosts=16, giants=0, giant_mass=0.0)
    with pytest.raises(ZeroDivisionError):
        host_skew_keys(100, num_hosts=16, giants=0, giant_mass=0.0)


# ---------------------------------------------------------------------------
# The reference's own properties, on the port's names
# (tests/test_baselines.py, tests/test_histogram.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_total_function(name):
    update, prev = make_baseline(name, 16)
    stream = zipf_keys(100_000, num_keys=10_000, exponent=1.1, seed=0)
    part = update(prev, Histogram.exact(stream).top(32), 16)
    parts = part.lookup_np(stream.astype(np.int32))
    assert parts.min() >= 0 and parts.max() < 16


@pytest.mark.parametrize("name", NAMES)
def test_improves_over_hash(name):
    n = 16
    update, prev = make_baseline(name, n)
    stream = zipf_keys(200_000, num_keys=50_000, exponent=1.2, seed=1)
    part = update(prev, Histogram.exact(stream).top(2 * n), n)
    assert load_imbalance(part, stream) <= load_imbalance(prev, stream) + 1e-9


def test_kip_beats_baselines_on_drift():
    """Fig. 3's headline: over a drifting stream KIP's mean imbalance is
    within 0.05 of Scan's and Readj's or better."""
    n = 20
    results = {}
    for name in ["scan", "readj", "kip"]:
        if name == "kip":
            update, part = (lambda prev, hist, n=n: kip_update(prev, hist, n)), uniform_partitioner(n)
        else:
            update, part = make_baseline(name, n)
        imb, mig = [], []
        for batch in drifting_zipf(12, 50_000, num_keys=5_000, exponent=1.0, seed=7):
            new = update(part, Histogram.exact(batch).top(2 * n), n)
            mig.append(plan_migration(part, new, np.unique(batch)).relative_migration)
            part = new
            imb.append(load_imbalance(part, batch))
        results[name] = (float(np.mean(imb[1:])), float(np.mean(mig[1:])))
    assert results["kip"][0] <= results["scan"][0] + 0.05
    assert results["kip"][0] <= results["readj"][0] + 0.05


def test_redist_migrates_more_than_scan():
    """Sticky Scan moves less state than rebuild-from-scratch Redist on a
    gradually drifting stream (Gedik's trade-off, paper Fig. 3)."""
    n = 16
    mig = {}
    for strat in ["redist", "scan"]:
        update, part = make_baseline(strat, n)
        total = []
        for batch in drifting_zipf(8, 50_000, num_keys=5_000, exponent=1.0,
                                   drift_every=3, drift_fraction=0.2, seed=5):
            new = update(part, Histogram.exact(batch).top(2 * n), n)
            total.append(plan_migration(part, new, np.unique(batch)).relative_migration)
            part = new
        mig[strat] = float(np.mean(total[1:]))
    assert mig["scan"] <= mig["redist"] + 1e-9, mig


def test_spacesaving_error_bound():
    """|est - true| <= total / capacity (the SpaceSaving guarantee)."""
    ss = SpaceSaving(capacity=50)
    stream = zipf_keys(20_000, num_keys=1_000, exponent=1.3, seed=2)
    ss.update(stream)
    h = ss.histogram()
    true = Histogram.exact(stream)
    td = dict(zip(true.keys.tolist(), (true.freqs * true.total_weight).tolist()))
    for k, f in zip(h.keys.tolist(), h.freqs.tolist()):
        assert abs(f * ss.total - td.get(k, 0)) <= len(stream) / 50 + 1e-6


def test_lossy_counting_bound():
    eps = 0.001
    lc = LossyCounting(epsilon=eps)
    stream = zipf_keys(50_000, num_keys=5_000, exponent=1.2, seed=3)
    lc.update(stream)
    true = Histogram.exact(stream)
    td = dict(zip(true.keys.tolist(), (true.freqs * true.total_weight).tolist()))
    h = lc.histogram()
    for k, f in zip(h.keys.tolist(), h.freqs.tolist()):
        c = f * lc.total
        assert c <= td.get(k, 0) + 1e-6  # lossy counting under-estimates
        assert c >= td.get(k, 0) - eps * len(stream) - 1e-6
