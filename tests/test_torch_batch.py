"""Batch-mode DR: the port's ``BatchJob`` and ``CountMinSketch`` on the CPU
against the reference's, on the same seeded keys.  Every ``BatchResult``
field must be equal exactly: the partitioner's tables, the assignments,
both imbalances (the port counts loads as integers and takes the ratio with
the reference's float64 formula), ``replayed_records``."""
import numpy as np
import pytest
import torch

from repro.core.drm import DRConfig as JDRConfig
from repro.core.histogram import CountMinSketch as JCountMinSketch
from repro.core.replay import BatchJob as JBatchJob
from repro.data.generators import zipf_keys as j_zipf
from repro_torch.core import BatchJob, CountMinSketch
from repro_torch.core.drm import DRConfig
from repro_torch.kernels import ops

TABLES = ("heavy_keys", "heavy_parts", "host_to_part")


def _assert_same_result(got, want):
    assert (got.imbalance_before, got.imbalance_after, got.replayed_records,
            got.sample_fraction) == (want.imbalance_before, want.imbalance_after,
                                     want.replayed_records, want.sample_fraction)
    assert got.assignments.dtype == torch.int32
    np.testing.assert_array_equal(got.assignments.numpy(), want.assignments)
    gp, wp = got.partitioner, want.partitioner
    assert (gp.num_partitions, gp.seed, gp.heavy_repl) == (wp.num_partitions, wp.seed,
                                                           wp.heavy_repl)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(gp, name), getattr(wp, name), err_msg=name)


@pytest.mark.parametrize("exponent", [1.0, 1.4, 2.0])
def test_batch_job_matches_reference(exponent):
    """The paper's batch configuration (lam 4, eps 0.003, 35 partitions) at a
    test's size, three skews."""
    keys = j_zipf(60_000, num_keys=20_000, exponent=exponent, seed=int(exponent * 10))
    want = JBatchJob(35, dr=JDRConfig(mode="batch", lam=4.0, eps=0.003)).run(keys)
    got = BatchJob(35, dr=DRConfig(mode="batch", lam=4.0, eps=0.003), device="cpu").run(keys)
    _assert_same_result(got, want)
    assert got.imbalance_after <= got.imbalance_before
    # at exponent 2 one key carries most records: KIP cannot beat UHP's max
    assert got.replayed_records == (6000 if exponent < 2 else 0)


def test_batch_job_default_config_and_tensor_input():
    keys = j_zipf(50_000, num_keys=10_000, exponent=1.2, seed=3)
    want = JBatchJob(8, sample_fraction=0.2, seed=5).run(keys)
    for k in (keys, torch.as_tensor(keys)):
        _assert_same_result(BatchJob(8, sample_fraction=0.2, seed=5, device="cpu").run(k),
                            want)


def test_batch_job_uniform_is_a_noop_as_in_the_reference():
    """tests/test_streaming.py's uniform case: KIP does not pay for the
    replay, so the uniform partitioner stays and nothing is replayed."""
    keys = np.random.default_rng(4).integers(0, 10**6, 50_000)
    want = JBatchJob(num_partitions=8).run(keys)
    got = BatchJob(num_partitions=8, device="cpu").run(keys)
    _assert_same_result(got, want)
    assert got.replayed_records == 0 and got.partitioner.num_heavy == 0


def test_count_min_sketch_matches_reference():
    batches = [j_zipf(3000, num_keys=1500, exponent=1.1, seed=s) for s in range(3)]
    batches.append(np.asarray([-5, 2**31 - 1, 0, 7, 7], np.int64))
    got, want = CountMinSketch(4, 1000, candidates=64), JCountMinSketch(4, 1000, candidates=64)
    for b in batches:
        got.update(b)
        want.update(b)
        np.testing.assert_array_equal(got.table, want.table)
    probe = np.concatenate([batches[0][:100], [123456789, -5]])
    np.testing.assert_array_equal(got.estimate(probe), want.estimate(probe))
    gh, wh = got.histogram(10), want.histogram(10)
    np.testing.assert_array_equal(gh.keys, wh.keys)
    np.testing.assert_array_equal(gh.freqs, wh.freqs)
    assert (gh.total_weight, got.total, got.memory_items) == (wh.total_weight, want.total,
                                                              want.memory_items)


@pytest.mark.parametrize("depth,width", [(4, 512), (3, 1000), (8, 2048)])
def test_count_sketch_equals_host_count_min_sketch(depth, width):
    keys = j_zipf(5000, num_keys=2000, exponent=1.3, seed=depth)
    cms = CountMinSketch(depth, width)
    cms.update(keys)
    got = ops.count_sketch(torch.as_tensor(keys), depth=depth, width=width)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), cms.table)
