"""The port's host and device building blocks against the reference on the
CPU: hashing, the DRW top-k histogram, the keyed-state merge, KIP planning,
migration planning and the control plane (same ``Signals`` in, same
decisions out), plus the DR master's snapshots across the packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.control import Signals as JSignals
from repro.core import hashing as jhash
from repro.core.drm import DRConfig as JDRConfig, DRMaster as JDRMaster
from repro.core.histogram import Histogram as JHistogram, local_topk_histogram as j_topk
from repro.core.migration import (
    exchange_lane_cost as j_cost,
    migration_capacity as j_capacity,
    plan_migration as j_plan,
)
from repro.core.partitioner import (
    Partitioner as JPartitioner,
    kip_update as j_kip,
    uniform_partitioner as j_uniform,
)
from repro.core.state import merge_into as j_merge
from repro.data.generators import drifting_zipf as j_drifting, zipf_keys as j_zipf
from repro.exchange.backends import resolve_backend as j_backend
from repro_torch.control import Signals
from repro_torch.core import hashing
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.histogram import Histogram, local_topk_histogram
from repro_torch.core.migration import exchange_lane_cost, migration_capacity, plan_migration
from repro_torch.core.partitioner import Partitioner, kip_update, uniform_partitioner
from repro_torch.core.state import merge_into
from repro_torch.data.generators import drifting_zipf, zipf_keys
from repro_torch.exchange.backends import resolve_backend

SENT = 2**31 - 1


def _full_range_int32(n=200_000, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2, -1, -2, SENT, SENT - 1, -(2**31), -(2**31) + 1,
                      2**16 - 1, 2**16, 2**24, 0x7FFF_0000], np.int64)
    return np.concatenate([edges, rng.integers(-(2**31), 2**31, n)]).astype(np.int32)


def test_fmix32_full_int32_range():
    x = _full_range_int32()
    want = np.asarray(jhash.fmix32(jnp.asarray(x)))
    np.testing.assert_array_equal(jhash.fmix32(x, xp=np), want)
    np.testing.assert_array_equal(hashing.fmix32(x), want)
    got = hashing.fmix32(torch.as_tensor(x))
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("num_hosts", [4096, 1024, 1000])
@pytest.mark.parametrize("seed", [0, 3, 2**20 + 7])
def test_hash_to_host_and_hash_mod_full_int32_range(num_hosts, seed):
    x = _full_range_int32(50_000, seed=num_hosts)
    want = np.asarray(jhash.hash_to_host(jnp.asarray(x), num_hosts, seed))
    np.testing.assert_array_equal(hashing.hash_to_host(x, num_hosts, seed), want)
    np.testing.assert_array_equal(hashing.hash_to_host(torch.as_tensor(x), num_hosts, seed).numpy(), want)
    want = np.asarray(jhash.hash_mod(jnp.asarray(x), 37, seed))
    np.testing.assert_array_equal(hashing.hash_mod(torch.as_tensor(x), 37, seed).numpy(), want)
    np.testing.assert_array_equal(hashing.hash_mod(x, 37, seed), want)


def test_generators_match_reference():
    np.testing.assert_array_equal(zipf_keys(5000, num_keys=300, exponent=1.1, seed=4),
                                  j_zipf(5000, num_keys=300, exponent=1.1, seed=4))
    for a, b in zip(drifting_zipf(4, 1000, num_keys=500, drift_every=2, seed=9),
                    j_drifting(4, 1000, num_keys=500, drift_every=2, seed=9)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("keys,k", [
    ([3, 5, 5, 5, 1, 5], 3),            # the ROADMAP's tie case
    ([7, 7, 2, 2, 9, 9, 4, 4, 1], 3),    # four keys tied at 2
    ([10, 11, 12, 13, 14, 15, 16, 17], 4),  # all tied at 1
    ([5, 5, 6, 6, 6], 8),               # k beyond the distinct keys
])
def test_local_topk_histogram_ties_lowest_index_first(keys, k):
    keys = np.asarray(keys, np.int32)
    valid = np.ones(len(keys), bool)
    valid[-1] = len(keys) % 2 == 0   # an invalid record too
    want = j_topk(jnp.asarray(keys), jnp.asarray(valid), k)
    got = local_topk_histogram(torch.as_tensor(keys), torch.as_tensor(valid), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_local_topk_histogram_stacked_workers():
    rng = np.random.default_rng(1)
    keys = j_zipf(4 * 3000, num_keys=400, exponent=1.1, seed=2).astype(np.int32).reshape(4, -1)
    valid = rng.random(keys.shape) < 0.9
    got = local_topk_histogram(torch.as_tensor(keys), torch.as_tensor(valid), 64)
    for i in range(4):
        want = j_topk(jnp.asarray(keys[i]), jnp.asarray(valid[i]), 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


@pytest.mark.parametrize("cap", [64, 300])
def test_merge_into_duplicates_and_overflow(cap):
    """Duplicate keys across state and batch, invalid rows, sentinel state
    rows holding leftover values (what a migration leaves behind), and a
    table too small for the distinct keys (overflow)."""
    rng = np.random.default_rng(cap)
    w, m = 3, 400
    state_keys = np.full((w, cap), SENT, np.int32)
    state_vals = np.zeros((w, cap, 2), np.float32)
    for i in range(w):
        live = np.sort(rng.choice(500, cap // 2, replace=False)).astype(np.int32)
        state_keys[i, : len(live)] = live
        state_vals[i, : len(live)] = rng.integers(1, 9, (len(live), 2))
        state_vals[i, len(live):len(live) + 3] = 5.0   # leftover values under sentinels
    batch_keys = rng.integers(0, 600, (w, m)).astype(np.int32)
    batch_vals = rng.integers(1, 5, (w, m, 2)).astype(np.float32)
    batch_valid = rng.random((w, m)) < 0.8
    got = merge_into(*(torch.as_tensor(a) for a in
                       (state_keys, state_vals, batch_keys, batch_vals, batch_valid)))
    if cap == 64:
        assert int(got[2].max()) > 0
    for i in range(w):
        want = j_merge(jnp.asarray(state_keys[i]), jnp.asarray(state_vals[i]),
                       jnp.asarray(batch_keys[i]), jnp.asarray(batch_vals[i]),
                       jnp.asarray(batch_valid[i]))
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(x))


def _both_partitioners(num_parts, heavy_capacity=128, seed=0):
    j = j_uniform(num_parts, heavy_capacity=heavy_capacity, seed=seed)
    t = uniform_partitioner(num_parts, heavy_capacity=heavy_capacity, seed=seed)
    return j, t


def _same_tables(a: JPartitioner, b: Partitioner):
    """Same device tables (a missing replica column reads as all ones)."""
    assert a.num_partitions == b.num_partitions and a.seed == b.seed
    for x, y in zip(a.tables(), b.tables("cpu")):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def _same_partitioner(a: JPartitioner, b: Partitioner):
    assert a.num_partitions == b.num_partitions and a.seed == b.seed
    for name in ("heavy_keys", "heavy_parts", "host_to_part"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    if a.heavy_repl is None:
        assert b.heavy_repl is None
    else:
        np.testing.assert_array_equal(a.heavy_repl, b.heavy_repl)


@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("num_parts,exponent", [(8, 1.2), (16, 1.6), (5, 0.9)])
def test_kip_update_same_tables(tight, num_parts, exponent):
    stream = j_zipf(20_000, num_keys=3_000, exponent=exponent, seed=num_parts)
    jh = JHistogram.exact(stream).top(2 * num_parts)
    th = Histogram.exact(stream).top(2 * num_parts)
    np.testing.assert_array_equal(jh.keys, th.keys)
    jp, tp = _both_partitioners(num_parts)
    for _ in range(2):  # a second round starts from the first round's plan
        jp = j_kip(jp, jh, eps=0.01, heavy_capacity=128, tight=tight)
        tp = kip_update(tp, th, eps=0.01, heavy_capacity=128, tight=tight)
        _same_partitioner(jp, tp)
    keys = stream[:5000].astype(np.int32)
    np.testing.assert_array_equal(jp.lookup_np(keys), tp.lookup_np(keys))
    _same_partitioner(jp.with_splits({int(jh.keys[0]): 3, 12345: 2}),
                      tp.with_splits({int(th.keys[0]): 3, 12345: 2}))


@pytest.mark.parametrize("num_workers", [1, 2, 4])
def test_migration_planning_same(num_workers):
    stream = j_zipf(30_000, num_keys=4_000, exponent=1.3, seed=5)
    jp, tp = _both_partitioners(8)
    jn = j_kip(jp, JHistogram.exact(stream).top(16), heavy_capacity=128, tight=True)
    tn = kip_update(tp, Histogram.exact(stream).top(16), heavy_capacity=128, tight=True)
    live = np.unique(stream)
    weights = np.random.default_rng(0).random(len(live))
    for w8 in (None, weights):
        a, b = j_plan(jp, jn, live, w8), plan_migration(tp, tn, live, w8)
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
        assert j_capacity(a, num_workers=num_workers) == migration_capacity(b, num_workers=num_workers)
        for name in ("dense", "local"):
            assert j_cost(a, num_workers=num_workers, backend=j_backend(name)) == \
                exchange_lane_cost(b, num_workers=num_workers, backend=resolve_backend(name))
        assert j_cost(a, num_workers=num_workers) == exchange_lane_cost(b, num_workers=num_workers)


def _decision_rows(log):
    return [(d.tick, d.kind, d.taken, d.reason, d.imbalance, d.detail) for d in log.records]


@pytest.mark.parametrize("cfg_kw", [
    dict(imbalance_trigger=1.1, migration_cost_weight=0.2),
    dict(imbalance_trigger=1.3, migration_cost_weight=1.0, min_batches_between=2),
    dict(imbalance_trigger=1.05, migration_cost_weight=0.0, tight=False, lam=1.5),
])
def test_same_signals_same_decisions(cfg_kw):
    """The same DRW histograms and Signals stream drive both DR masters to
    the same decisions, reasons, partitioners and snapshots."""
    jd = JDRMaster(j_uniform(8, heavy_capacity=128), JDRConfig(**cfg_kw))
    td = DRMaster(uniform_partitioner(8, heavy_capacity=128), DRConfig(**cfg_kw))
    for b, batch in enumerate(j_drifting(6, 4096, num_keys=1500, exponent=1.3,
                                         drift_every=2, seed=3)):
        u, c = np.unique(batch, return_counts=True)
        top = np.argsort(-c, kind="stable")[:64]
        hk = np.full((2, 64), -1, np.int64)
        hc = np.zeros((2, 64), np.int64)
        hk[0, : len(top)], hc[0, : len(top)] = u[top], c[top]
        jd.observe(hk, hc, total_records=float(len(batch)))
        td.observe(hk, hc, total_records=float(len(batch)))
        loads = np.bincount(jd.partitioner.lookup_np(batch.astype(np.int32)), minlength=8)
        kw = dict(loads=loads.astype(np.float64), num_workers=2, records=float(len(batch)),
                  at_safe_point=b != 4)
        ja, ta = jd.evaluate(JSignals(**kw)), td.evaluate(Signals(**kw))
        assert (ja.kind, ja.taken, ja.reason) == (ta.kind, ta.taken, ta.reason)
        _same_partitioner(jd.partitioner, td.partitioner)
    assert _decision_rows(jd.decisions) == _decision_rows(td.decisions)
    assert jd.decisions.counts() == td.decisions.counts()
    js, ts = jd.snapshot(), td.snapshot()
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(np.asarray(js[k]), np.asarray(ts[k]), err_msg=k)


def test_drm_snapshots_cross_the_packages():
    """A port snapshot restores into the reference's DRMaster and back."""
    td = DRMaster(uniform_partitioner(8, heavy_capacity=128),
                  DRConfig(imbalance_trigger=1.1, migration_cost_weight=0.2))
    batch = j_zipf(5000, num_keys=800, exponent=1.4, seed=1)
    u, c = np.unique(batch, return_counts=True)
    td.observe(u[None, :64], c[None, :64], total_records=5000.0)
    loads = np.bincount(td.partitioner.lookup_np(batch.astype(np.int32)), minlength=8)
    assert td.evaluate(Signals(loads=loads.astype(np.float64), num_workers=2)).taken
    jd = JDRMaster.restore(td.snapshot(), JDRConfig(imbalance_trigger=1.1))
    _same_tables(jd.partitioner, td.partitioner)
    back = DRMaster.restore(jd.snapshot(), DRConfig(imbalance_trigger=1.1))
    assert _decision_rows(back.decisions) == _decision_rows(td.decisions)
    _same_tables(jd.partitioner, back.partitioner)
    np.testing.assert_array_equal(back.sketch._keys, td.sketch._keys)


@pytest.mark.parametrize("bad", [
    dict(pipeline_depth=3), dict(grow_trigger=1.0, shrink_trigger=1.1),
    dict(backend_ragged_below=0.9, backend_dense_above=0.5),
    dict(split_trigger=0.5, unsplit_trigger=0.8), dict(resize_cooldown=-1),
    dict(health_failure_threshold=0),
])
def test_drconfig_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        JDRConfig(**bad)
    with pytest.raises(ValueError):
        DRConfig(**bad)


@pytest.mark.parametrize("flag", [
    dict(elastic=True), dict(split_keys_enabled=True), dict(auto_backend=True),
    dict(health_enabled=True), dict(split_least_load=True), dict(snapshot_interval=2),
])
def test_unported_features_raise(flag):
    """Every ``DRConfig`` feature is ported now (the name dates from when
    some raised): a master built with each flag takes the reference's
    decisions over the same signals, and its snapshot is the reference's."""
    rng = np.random.default_rng(1)
    td = DRMaster(uniform_partitioner(4), DRConfig(**flag))
    jd = JDRMaster(j_uniform(4), JDRConfig(**flag))
    for step in range(4):
        loads = rng.integers(1, 50, 4).astype(np.float64)
        straggle = np.asarray([0.0, 0.2 * (step % 2), 0.0, 0.0])
        for drm, sig in ((td, Signals), (jd, JSignals)):
            drm.evaluate(sig(loads=loads, num_workers=2, lane_straggle_s=straggle[:2]))
    assert _decision_rows(td.decisions) == _decision_rows(jd.decisions)
    js, ts = jd.snapshot(), td.snapshot()
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(np.asarray(js[k]), np.asarray(ts[k]), err_msg=k)