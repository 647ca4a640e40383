"""The CUDA route kernels against their plain PyTorch versions, on the card.

These need a CUDA device and the CUDA toolkit (the kernels are built from
``src/repro_torch/kernels/csrc`` at first use); without a device they skip.
Every output must be equal exactly.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.histogram import Histogram
from repro_torch.core.partitioner import kip_update, uniform_partitioner
from repro_torch.core.streaming import StreamingJob
from repro_torch.core.drm import DRConfig
from repro_torch.data.generators import drifting_zipf, zipf_keys
from repro_torch.kernels import ops
from repro_torch.kernels.lookup_dispatch import lookup_dispatch, lookup_dispatch_plain
from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

pytestmark = pytest.mark.gpu
SENT = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _case(w, n, parts, splits, empty, seed):
    stream = zipf_keys(w * n, num_keys=5000, exponent=1.2, seed=seed)
    if empty:
        p = uniform_partitioner(parts)
    else:
        hist = Histogram.exact(stream).top(64)
        p = kip_update(uniform_partitioner(parts, heavy_capacity=128), hist)
        if splits:
            p = p.with_splits({int(hist.keys[i]): d for i, d in enumerate(splits)})
    rng = np.random.default_rng(seed)
    valid = rng.random((w, n)) < 0.9
    keys = np.where(valid, stream.reshape(w, n), SENT).astype(np.int32)
    vals = rng.normal(size=(w, n, 2)).astype(np.float32)
    return p, keys, valid, vals


@pytest.mark.parametrize("w,n,lanes,cap,num_partitions,splits,empty", [
    (1, 1000, 1, 2048, 0, None, False),
    (3, 1000, 3, 200, 8, (4, 3), False),
    (4, 5000, 4, 700, 16, None, True),
    (8, 65536, 8, 4096, 32, (8,), False),
    (2, 2048, 1000, 8, 0, None, False),
])
def test_kernels_equal_plain_versions(cuda, w, n, lanes, cap, num_partitions, splits, empty):
    p, keys, valid, vals = _case(w, n, max(lanes, num_partitions), splits, empty, n)
    k, v, x = (torch.as_tensor(a, device=cuda) for a in (keys, valid, vals))
    t = p.tables(cuda)
    for pad_empty in (True, False):
        hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=num_partitions, pad_empty=pad_empty)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=lanes,
                  num_partitions=num_partitions)
        before = (lookup_dispatch.launches, route_bucketize.launches)
        got = lookup_dispatch(k, v, hk, hp, t.host_to_part, hr, **kw)
        want = lookup_dispatch_plain(k, v, hk, hp, t.host_to_part, hr, **kw)
        for g, x_ in zip(got, want):
            assert torch.equal(g, x_)
        got = route_bucketize(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap,
                              key_fill=SENT, **kw)
        want = route_bucketize_plain(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap,
                                     key_fill=SENT, **kw)
        torch.cuda.synchronize()
        for g, x_ in zip(got, want):
            assert torch.equal(g, x_)
        assert (lookup_dispatch.launches, route_bucketize.launches) == (before[0] + 1,
                                                                        before[1] + 1)


def test_streaming_job_card_equals_cpu(cuda):
    batches = list(drifting_zipf(4, 16384, num_keys=5000, exponent=1.3, drift_every=2, seed=2))
    jobs = {}
    for device in (cuda, "cpu"):
        jobs[str(device)] = StreamingJob(device=device, num_workers=4, num_partitions=16,
                                         state_capacity=8192,
                                         dr=DRConfig(imbalance_trigger=1.1,
                                                     migration_cost_weight=0.2))
        jobs[str(device)].run(batches)
    card, cpu = jobs["cuda"], jobs["cpu"]
    for a, b in zip(card.metrics, cpu.metrics):
        assert (a.imbalance, a.repartitioned, a.relative_migration, a.overflow, a.reason,
                a.shipped_rows) == (b.imbalance, b.repartitioned, b.relative_migration,
                                    b.overflow, b.reason, b.shipped_rows)
    assert torch.equal(card.state_keys.cpu(), cpu.state_keys)
    assert torch.equal(card.state_vals.cpu(), cpu.state_vals)
