"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and the CUDA toolkit (the kernels are built from
``src/repro_torch/kernels/csrc`` at first use); without a device they skip.
Every output of the routing and batch kernels must be equal exactly; the
flash-attention kernel sums in another order than its plain version, so it
is held within 2e-5 in float32 and 2e-2 in bf16 (the reference's own
tolerances, ``tests/test_flash_kernel.py``), and within 2e-2 wherever
``p_bf16`` rounds the softmax weights to bf16.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import dist_cases
import train_dist_cases
from repro_torch import compat
from repro_torch.core.baselines import make_baseline
from repro_torch.core.histogram import CountMinSketch, Histogram
from repro_torch.core.partitioner import kip_update, uniform_partitioner
from repro_torch.core.replay import BatchJob, replay_partition
from repro_torch.core.streaming import StreamingJob
from repro_torch.core.drm import DRConfig
from repro_torch.data.generators import drifting_zipf, zipf_keys
from repro_torch.kernels import build, ops
from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.lookup_dispatch import (RANK_KERNELS, lookup_dispatch,
                                                 lookup_dispatch_plain)
from repro_torch.kernels.partition_apply import partition_apply, partition_apply_plain
from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain
from repro_torch.kernels.sketch_update import THREADS, plan, sketch_update, sketch_update_plain

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


@pytest.mark.parametrize("w,n,b,num_hosts,sentinels", [
    (1, 100_000, 256, 4096, False),
    (35, 3000, 0, 4096, True),          # empty heavy table
    (4, 50_000, 256, 4096, True),       # sentinel keys hit pad rows: part 0
    (2, 20_000, 16384, 8192, False),    # tables past the default 48 KB
])
def test_partition_apply_equals_plain(cuda, w, n, b, num_hosts, sentinels):
    rng = np.random.default_rng(n + b)
    keys = zipf_keys(w * n, num_keys=50_000, exponent=1.1, seed=b).astype(np.int32)
    live = np.unique(keys)[: b // 2] if b else np.zeros(0, np.int32)
    hk = np.concatenate([live, np.full(b - len(live), SENT, np.int32)]).astype(np.int32)
    hp = np.concatenate([rng.integers(0, 35, len(live)), np.zeros(b - len(live))])
    if sentinels:
        keys[rng.random(len(keys)) < 0.1] = SENT
    args = [torch.as_tensor(a, dtype=torch.int32, device=cuda) for a in
            (keys.reshape(w, n), hk, hp, rng.integers(0, 35, num_hosts))]
    before = partition_apply.launches
    got = partition_apply(*args, seed=3, num_hosts=num_hosts)
    want = partition_apply_plain(*args, seed=3, num_hosts=num_hosts)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and partition_apply.launches == before + 1


@pytest.mark.parametrize("w,n,num_parts", [(1, 1_000_000, 35), (3, 5000, 1),
                                           (2, 70_000, 1024), (8, 2048, 7)])
def test_dispatch_count_equals_plain(cuda, w, n, num_parts):
    rng = np.random.default_rng(n)
    dest = rng.integers(-2, num_parts + 2, (w, n)).astype(np.int32)
    valid = rng.random((w, n)) < 0.8
    d, v = torch.as_tensor(dest, device=cuda), torch.as_tensor(valid, device=cuda)
    before = dispatch_count.launches
    got = dispatch_count(d, v, num_parts=num_parts)
    want = dispatch_count_plain(d, v, num_parts=num_parts)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert dispatch_count.launches == before + 1
    got1 = dispatch_count(d[0].contiguous(), v[0].contiguous(), num_parts=num_parts)
    assert all(torch.equal(g, x[0]) for g, x in zip(got1, want))


@pytest.mark.parametrize("w,depth,width", [(1, 4, 2048), (1, 8, 8192), (3, 1, 1000),
                                           (2, 8, 2048), (1, 4, 8192)])
def test_sketch_update_equals_plain(cuda, w, depth, width):
    rng = np.random.default_rng(width + depth)
    keys = zipf_keys(w * 200_000, num_keys=100_000, exponent=1.4, seed=depth)
    k = torch.as_tensor(keys.astype(np.int32).reshape(w, -1), device=cuda)
    v = torch.as_tensor(rng.random(k.shape) < 0.9, device=cuda)
    before = sketch_update.launches
    got = sketch_update(k, v, depth=depth, width=width)
    want = sketch_update_plain(k, v, depth=depth, width=width)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and sketch_update.launches == before + 1
    cms = CountMinSketch(depth, width)
    cms.update(keys[: k.shape[1]][v[0].cpu().numpy()])
    np.testing.assert_array_equal(got[0].cpu().numpy().astype(np.float64), cms.table)


SKETCH_STEP = THREADS * 4  # records a block of the sketch kernel takes a step


@pytest.mark.parametrize("w,n,depth,width,exponent,invalid,key_off,valid_off", [
    (1, 200_000, 4, 2048, None, 0.0, 0, 0),          # one key for every record
    (1, 300_000, 4, 2048, 2.0, 0.1, 0, 0),
    (1, 300_000, 4, 1000, 2.0, 0.1, 0, 0),
    (1, 100_001, 4, 2048, 1.2, 0.1, 1, 1),           # keys 4 bytes past 16, valid 1 byte past 4
    (3, 20_003, 3, 1000, 1.2, 0.1, 3, 2),            # keys 12 bytes past 16, valid 2 past 4
    (1, 1, 4, 2048, 1.2, 0.0, 0, 0),
    (1, 15, 4, 2048, 1.2, 0.0, 1, 0),
    (2, 17, 3, 3, 1.2, 0.0, 0, 0),                 # 9 cells: outputs not on 16 bytes
    (1, 3 * SKETCH_STEP + 1, 4, 2048, 1.2, 0.1, 0, 0),
    (35, 3000, 4, 2048, 1.2, 0.1, 0, 0),
    (2, 5000, 4, 2048, 1.2, 1.0, 0, 0),             # every record invalid
    (3, 0, 4, 2048, 1.2, 0.1, 0, 0),                # no records
    (1, 500_000, 8, 8192, 1.2, 0.1, 0, 0),          # rows split over 2 blocks
    (2, 50_000, 5, 20_000, 1.2, 0.1, 0, 0),         # split over 4, ragged row groups
    (1, 40_000, 1, 1, 1.2, 0.1, 0, 0),
    (1, 2**20 + 7, 2, 40_961, 1.1, 0.1, 0, 0),      # split, width not a power of two
], ids=["one-key", "exponent-2", "exponent-2-width-1000", "misaligned-views",
        "misaligned-W3", "n-1", "n-15", "n-17-width-3", "3-steps-plus-1", "35-rows",
        "all-invalid", "n-0", "split-depth-8", "split-depth-5", "width-1", "split-width-40961"])
def test_sketch_update_edge_cases(cuda, w, n, depth, width, exponent, invalid, key_off,
                                  valid_off):
    """sketch_update equals its plain version bit for bit on the edges of its
    loads (views off 16 and 4 bytes, ragged tails, n below a vector),
    skew, stacked rows, both paths (all rows in a block, rows split over a
    cluster) and both columns (mask, fastmod), with every tensor the
    wrapper allocates handed out dirty."""
    rng = np.random.default_rng(n + depth + width)
    if exponent is None:
        keys = np.full(w * n, 123_456_789, np.int64)
    else:
        keys = zipf_keys(max(w * n, 1), num_keys=100_000, exponent=exponent, seed=n)[: w * n]
    kb = torch.as_tensor(np.concatenate([np.zeros(key_off, np.int64), keys]).astype(np.int32),
                         device=cuda)
    vb = torch.as_tensor(np.concatenate([np.zeros(valid_off, bool),
                                         rng.random(w * n) >= invalid]), device=cuda)
    k, v = kb[key_off:].view(w, n), vb[valid_off:].view(w, n)
    assert k.data_ptr() % 16 == 4 * key_off and v.data_ptr() % 4 == valid_off
    if w == 1 and n > 1000:
        k, v = k[0], v[0]
    before = sketch_update.launches
    want = sketch_update_plain(k, v, depth=depth, width=width)
    with _dirty_outputs():
        got = sketch_update(k, v, depth=depth, width=width)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and sketch_update.launches == before + 1
    assert float(want.sum()) == depth * float(v.sum())
    p = plan(w, n, depth, width, resident_clusters=15)
    assert p.path == ("shared" if depth * width * 4 <= 200 * 1024 else "split")


def test_sketch_update_is_deterministic_under_concurrent_load(cuda):
    """The clusters' tickets and partials under load: the batch path's shape
    (depth 4, width 2048, 2,000,000 keys at exponent 1.2) and the split
    path (depth 8, width 8192) on four streams at once beside a copy that
    keeps the memory busy, eight rounds: every sketch equals, bit for bit,
    an idle card's."""
    keys = torch.as_tensor(zipf_keys(2_000_000, num_keys=1_000_000, exponent=1.2,
                                     seed=3).astype(np.int32), device=cuda)
    valid = torch.ones_like(keys, dtype=torch.bool)
    shapes = [(4, 2048), (8, 8192)]
    want = [sketch_update(keys, valid, depth=d, width=wd) for d, wd in shapes]
    torch.cuda.synchronize()
    for got, (d, wd) in zip(want, shapes):
        assert torch.equal(got, sketch_update_plain(keys, valid, depth=d, width=wd))
    src = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    dst = torch.empty_like(src)
    streams = [torch.cuda.Stream() for _ in range(5)]
    outs = []
    for _ in range(8):
        with torch.cuda.stream(streams[4]):
            for _ in range(4):
                dst.copy_(src)
        for st in streams[:4]:
            with torch.cuda.stream(st):
                outs.append([sketch_update(keys, valid, depth=d, width=wd) for d, wd in shapes])
    torch.cuda.synchronize()
    for out in outs:
        assert all(torch.equal(g, x) for g, x in zip(out, want))


def test_batch_job_card_equals_cpu(cuda):
    keys = zipf_keys(400_000, num_keys=50_000, exponent=1.2, seed=12)
    dr = DRConfig(mode="batch", lam=4.0, eps=0.003)
    before = partition_apply.launches
    card = BatchJob(35, dr=dr, device=cuda).run(keys)
    cpu = BatchJob(35, dr=dr, device="cpu").run(keys)
    assert partition_apply.launches == before + 2
    assert (card.imbalance_before, card.imbalance_after, card.replayed_records) == (
        cpu.imbalance_before, cpu.imbalance_after, cpu.replayed_records)
    assert card.assignments.device.type == "cuda"
    assert torch.equal(card.assignments.cpu(), cpu.assignments)
    np.testing.assert_array_equal(card.assignments.cpu().numpy(),
                                  card.partitioner.lookup_np(keys))


@pytest.mark.parametrize("name", ["hash", "readj", "redist", "scan", "mixed"])
@pytest.mark.parametrize("n,top", [(16, 32), (64, 1536), (8, 0)])
def test_baseline_tables_route_on_the_card(cuda, name, n, top):
    """Each baseline's table (empty, 2N rows, and 1,536 rows: the search
    branch above the probe's 1,024) routed by ``partition_apply`` through
    ``ops.apply_partitioner`` equals the host's ``lookup_np``."""
    keys = zipf_keys(300_000, num_keys=60_000, exponent=1.0, seed=n)
    hist = Histogram.exact(keys).top(top)
    update, prev = make_baseline(name, n)
    part = update(prev, hist, n)
    assert part.heavy_keys.shape == ((0,) if name == "hash" else (top,))
    before = partition_apply.launches
    got = replay_partition(part, torch.as_tensor(keys.astype(np.int32), device=cuda))
    assert partition_apply.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    want = part.lookup_np(keys)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(torch.bincount(got, minlength=n).cpu().numpy(),
                                  np.bincount(want, minlength=n))


# records per tile of each kernel's one-pass lane rank (csrc/lane_rank.cuh, kTileOf)
TILES = {"lookup_dispatch": 4096, "route_bucketize": 4096, "dispatch_count": 8192}
TILE = TILES["route_bucketize"]  # lookup_dispatch's too
DISPATCH_TILE = TILES["dispatch_count"]


def _check_tiles():
    lib = build.library()
    assert {k: lib.rk_tile_records(i) for k, i in RANK_KERNELS.items()} == TILES


@contextlib.contextmanager
def _dirty_outputs():
    """Inside, every tensor that ``torch.empty`` and ``torch.empty_like``
    make starts as 0x5A bytes, so an output cell a kernel forgets to write
    shows (the wrappers allocate their outputs and scratch with them)."""
    empty, empty_like = torch.empty, torch.empty_like

    def dirty(t):
        if t.numel():
            t.view(-1).view(torch.uint8).fill_(0x5A)
        return t

    torch.empty = lambda *a, **k: dirty(empty(*a, **k))
    torch.empty_like = lambda *a, **k: dirty(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def _route_inputs(w, n, parts, invalid, seed):
    """Zipf keys [w, n] with a seeded share `invalid` of sentinel records, a
    KIP partitioner over `parts` partitions with its hottest key split 4
    ways, and f32 values [w, n, 1]."""
    stream = zipf_keys(max(w * n, 1000), num_keys=5000, exponent=1.2, seed=seed)
    hist = Histogram.exact(stream).top(64)
    p = kip_update(uniform_partitioner(parts, heavy_capacity=128), hist)
    p = p.with_splits({int(hist.keys[0]): 4})
    rng = np.random.default_rng(seed)
    valid = rng.random((w, n)) >= invalid
    keys = np.where(valid, stream[: w * n].reshape(w, n), SENT).astype(np.int32)
    vals = rng.normal(size=(w, n, 1)).astype(np.float32)
    return p, keys, valid, vals


@pytest.mark.parametrize("w,n,lanes,cap,parts,invalid", [
    (2, 1000, 8, 600, 32, 0.1),              # below one tile
    (3, 3 * TILE + 1, 8, 4000, 32, 0.1),     # k tiles + 1 record
    (2, 15 * TILE, 8, 20000, 32, 0.1),       # many tiles per worker
    (35, 3000, 8, 500, 32, 0.1),             # 35 stacked rows
    (2, 50_000, 1024, 64, 2048, 0.1),        # 1024 lanes
    (3, 5000, 5, 2001, 16, 0.1),             # 30,015 cells, none full: ragged 16-byte tails
    (2, 3000, 8, 0, 32, 0.1),                # capacity 0
    (2, 5000, 8, 700, 32, 1.0),              # every record invalid
    (3, 0, 8, 100, 32, 0.1),                 # no records
], ids=["below-one-tile", "k-tiles-plus-1", "many-tiles", "35-rows", "1024-lanes",
        "ragged-capacity", "capacity-0", "all-invalid", "n-0"])
def test_route_kernels_edge_cases(cuda, w, n, lanes, cap, parts, invalid):
    """lookup_dispatch and route_bucketize equal their plain versions on the
    one-pass rank's edges and the fill's, with every output and scratch
    tensor handed out dirty."""
    _check_tiles()
    p, keys, valid, vals = _route_inputs(w, n, parts, invalid, seed=w * 7 + lanes)
    k, v, x = (torch.as_tensor(a, device=cuda) for a in (keys, valid, vals))
    t = p.tables(cuda)
    hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=parts, pad_empty=True)
    kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=lanes, num_partitions=parts)
    want = lookup_dispatch_plain(k, v, hk, hp, t.host_to_part, hr, **kw)
    with _dirty_outputs():
        got = lookup_dispatch(k, v, hk, hp, t.host_to_part, hr, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x_) for g, x_ in zip(got, want))
    want = route_bucketize_plain(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap,
                                 key_fill=SENT, **kw)
    with _dirty_outputs():
        got = route_bucketize(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap, key_fill=SENT,
                              **kw)
    torch.cuda.synchronize()
    for g, x_ in zip(got, want):
        assert torch.equal(g, x_)
    assert int(want[2].sum()) == int(valid.sum())


def _probe_case(kind, w, n, b, seed):
    """(keys [w * n], sorted heavy keys [b], heavy parts, replicas, host
    table, partitioner seed) for one edge of the heavy-key probe: `live`
    Zipf keys, b distinct heavy keys among the hot ones; `sentinels` one
    live key and b - 1 sentinel pad rows, a tenth of the keys the sentinel;
    `runs` runs of equal heavy keys whose later rows carry other parts, and
    pad rows whose parts differ after the first; `collide` heavy keys and
    missing keys whose hashes share probe slots (found by searching seeded
    keys), so walks pass other keys before a hit or an empty slot."""
    from repro_torch.core.hashing import fmix32, seed_mix

    rng = np.random.default_rng(seed)
    pseed = seed % 5
    stream = zipf_keys(max(w * n, 1), num_keys=5000, exponent=1.2, seed=seed)[: w * n]
    uniq, counts = np.unique(stream, return_counts=True)
    hot = uniq[np.argsort(-counts, kind="stable")][: max(b, 1)]  # the hottest keys first
    if kind == "live":  # half of the rows hot keys, half other keys
        first = hot[: (b + 1) // 2]
        pool = np.setdiff1d(rng.integers(0, 6000, 4 * b + 8), first)
        hk = np.sort(np.concatenate([first, rng.choice(pool, b - len(first), replace=False)]))
        keys = stream
    elif kind == "sentinels":
        hk = np.concatenate([hot[:1], np.full(b - 1, SENT)])
        keys = np.where(rng.random(w * n) < 0.1, SENT, stream)
    elif kind == "runs":
        live = hot[: b // 4]
        hk = np.concatenate([np.repeat(live, 2), live[: b // 8], np.full(b, SENT)])
        hk = np.sort(hk)[:b]
        hk[-8:] = SENT
        keys = np.where(rng.random(w * n) < 0.1, SENT, stream)
    else:  # collide
        slots = build.library().rk_probe_slots(b)
        cand = rng.integers(0, 2**31 - 1, 400_000, dtype=np.int64).astype(np.int32)
        home = fmix32(cand.astype(np.uint32) ^ np.uint32(seed_mix(pseed))) & (slots - 1)
        top = np.bincount(home, minlength=slots).argmax()
        same = cand[home == top][:12]          # 12 keys with one home slot
        nxt = cand[home == (top + 1) % slots][:4]
        table = np.unique(np.concatenate([same[:8], nxt[:3], hot[: b // 2]]))[:b]
        hk = np.concatenate([table, np.full(b - len(table), SENT)])
        keys = stream.copy()
        pick = rng.integers(0, w * n, w * n // 5)
        keys[pick] = np.concatenate([same, nxt])[rng.integers(0, 16, len(pick))]
    hk = np.asarray(hk, dtype=np.int32)
    assert np.all(np.diff(hk.astype(np.int64)) >= 0)
    hp = rng.integers(0, 32, b).astype(np.int32)
    hp[hk == SENT] = 0
    if kind == "runs":  # later rows of a run, and pad rows after the first, differ
        hp[1:][hk[1:] == hk[:-1]] = 31
    hr = rng.integers(0, 5, b).astype(np.int32)
    h2p = rng.integers(0, 32, 4096).astype(np.int32)
    return np.asarray(keys, dtype=np.int32), hk, hp, hr, h2p, pseed


@pytest.mark.parametrize("kind,w,n,b,offset", [
    ("live", 2, 5000, 0, 0),            # no heavy table
    ("live", 2, 5000, 1, 0),
    ("live", 3, 5003, 128, 0),          # n not a multiple of 4
    ("live", 2, 20_000, 1024, 0),       # the largest probed table
    ("live", 2, 20_000, 1025, 0),       # the smallest searched one
    ("sentinels", 2, 4001, 128, 0),     # 127 sentinel pad rows, keys equal to the sentinel
    ("runs", 2, 4000, 128, 0),          # first equal row wins
    ("collide", 2, 4000, 128, 0),       # shared probe slots
    ("live", 1, 3, 128, 0),             # n < 4
    ("live", 3, 1001, 128, 1),          # keys 4 bytes past a 16-byte boundary
    ("live", 1, 4097, 256, 3),          # 12 bytes past, one worker
], ids=["B0", "B1", "B128-ragged-n", "B1024-probe", "B1025-search", "127-sentinels",
        "equal-runs", "colliding-slots", "n-below-4", "misaligned-W3", "misaligned-W1"])
def test_heavy_probe_edge_cases(cuda, kind, w, n, b, offset):
    """partition_apply, lookup_dispatch and route_bucketize (which share the
    heavy-key probe) equal their plain versions on the probe's edges, with
    every tensor the wrappers allocate handed out dirty."""
    lib = build.library()
    assert lib.rk_probe_slots(1024) == 4096 and lib.rk_probe_slots(1025) == 0
    assert lib.rk_probe_slots(0) == 0 and lib.rk_probe_slots(1) == 4
    keys, hk, hp, hr, h2p, pseed = _probe_case(kind, w, n, b, seed=w * n + b + offset)
    buf = torch.as_tensor(np.concatenate([np.zeros(offset, np.int32), keys]), device=cuda)
    k = buf[offset:].view(w, n) if w > 1 else buf[offset:]
    assert k.is_contiguous() and (k.data_ptr() % 16 == 4 * offset)
    t_hk, t_hp, t_hr, t_h2p = (torch.as_tensor(a, device=cuda) for a in (hk, hp, hr, h2p))
    args = (k, t_hk, t_hp, t_h2p)
    want = partition_apply_plain(*args, seed=pseed, num_hosts=4096)
    with _dirty_outputs():
        got = partition_apply(*args, seed=pseed, num_hosts=4096)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    k2 = k.view(w, n)
    rng = np.random.default_rng(n)
    v = torch.as_tensor(rng.random((w, n)) < 0.9, device=cuda)
    x = torch.as_tensor(rng.normal(size=(w, n, 1)).astype(np.float32), device=cuda)
    kw = dict(seed=pseed, num_hosts=4096, num_lanes=8, num_partitions=32)
    want = lookup_dispatch_plain(k2, v, t_hk, t_hp, t_h2p, t_hr, **kw)
    with _dirty_outputs():
        got = lookup_dispatch(k2, v, t_hk, t_hp, t_h2p, t_hr, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x_) for g, x_ in zip(got, want))
    rb_kw = dict(kw, capacity=n // 4 + 1, key_fill=SENT)
    want = route_bucketize_plain(k2, v, x, t_hk, t_hp, t_h2p, t_hr, **rb_kw)
    with _dirty_outputs():
        got = route_bucketize(k2, v, x, t_hk, t_hp, t_h2p, t_hr, **rb_kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x_) for g, x_ in zip(got, want))


@pytest.mark.parametrize("w,n,num_parts,invalid", [
    (2, 1000, 35, 0.2),                     # below one tile
    (3, 3 * DISPATCH_TILE + 1, 35, 0.2),    # k tiles + 1 record
    (1, 50 * DISPATCH_TILE, 35, 0.2),       # many tiles
    (35, 3000, 35, 0.2),           # 35 stacked rows
    (2, 50_000, 1024, 0.2),        # 1024 destinations
    (2, 5000, 35, 1.0),            # every record invalid
    (3, 0, 35, 0.2),               # no records
], ids=["below-one-tile", "k-tiles-plus-1", "many-tiles", "35-rows", "1024-parts",
        "all-invalid", "n-0"])
def test_dispatch_count_edge_cases(cuda, w, n, num_parts, invalid):
    rng = np.random.default_rng(n + num_parts)
    dest = rng.integers(-2, num_parts + 2, (w, n)).astype(np.int32)
    valid = rng.random((w, n)) >= invalid
    d, v = torch.as_tensor(dest, device=cuda), torch.as_tensor(valid, device=cuda)
    _check_tiles()
    want = dispatch_count_plain(d, v, num_parts=num_parts)
    with _dirty_outputs():
        got = dispatch_count(d, v, num_parts=num_parts)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_rank_kernels_are_deterministic_under_concurrent_load(cuda):
    """The look-back's timing differs from launch to launch; the ranks must
    not.  route_bucketize (8 workers of 32 tiles) and dispatch_count (one
    worker of 245 tiles) on four streams at once beside a copy that keeps
    the memory busy, eight rounds: every output equals, bit for bit, the
    plain version's."""
    p, keys, valid, vals = _route_inputs(8, 32 * TILE, 32, 0.1, seed=5)
    k, v, x = (torch.as_tensor(a, device=cuda) for a in (keys, valid, vals))
    t = p.tables(cuda)
    hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=32, pad_empty=True)
    rb_args = (k, v, x, hk, hp, t.host_to_part, hr)
    rb_kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=8, num_partitions=32,
                 capacity=40_000, key_fill=SENT)
    rng = np.random.default_rng(6)
    d = torch.as_tensor(rng.integers(-1, 36, (1, 2_000_000)).astype(np.int32), device=cuda)
    dv = torch.as_tensor(rng.random((1, 2_000_000)) < 0.9, device=cuda)
    want = (route_bucketize_plain(*rb_args, **rb_kw), dispatch_count_plain(d, dv, num_parts=35))
    torch.cuda.synchronize()
    src = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    dst = torch.empty_like(src)
    streams = [torch.cuda.Stream() for _ in range(5)]
    outs = []
    for _ in range(8):
        with torch.cuda.stream(streams[4]):
            for _ in range(4):
                dst.copy_(src)
        for st in streams[:4]:
            with torch.cuda.stream(st):
                outs.append((route_bucketize(*rb_args, **rb_kw),
                             dispatch_count(d, dv, num_parts=35)))
    torch.cuda.synchronize()
    for got in outs:
        for g, w_ in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w_))


@pytest.mark.parametrize("p_bf16", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,p,sq,hd", [
    (1, 8, 1, 256), (1, 8, 100, 256), (1, 8, 300, 256), (1, 8, 2048, 256),  # gemma-2b
    (3, 2, 7, 16), (2, 2, 300, 64), (4, 1, 129, 128), (2, 2, 100, 192), (1, 4, 2048, 128),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
def test_flash_attention_equals_plain(cuda, dtype, g, p, sq, hd, causal, window, p_bf16):
    """float32 within 2e-5, bf16 within 2e-2; ``p_bf16`` rounds the weights
    to bf16 in both versions, so a last-bit difference in a score may flip
    a rounding and the bf16 tolerance holds for float32 inputs too."""
    gen = torch.Generator(device=cuda).manual_seed(sq * hd + g)
    q = torch.randn((g, p, sq, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((g, sq, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((g, sq, hd), generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, p_bf16=p_bf16)
    want = flash_attention_plain(q, k, v, causal=causal, window=window, p_bf16=p_bf16)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape and bool(torch.isfinite(got).all())
    tol = 2e-2 if dtype == torch.bfloat16 or p_bf16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("p_bf16", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_the_models_strided_views(cuda, dtype, p_bf16):
    """``models.attention.flash_attention`` hands the kernel q, k, v as the
    attention block makes them, non-contiguous ``[B, S, G, P, hd]`` /
    ``[B, S, G, hd]`` views of one projection, and gets the output written
    into ``[B, S, G * P * hd]``; held to the plain version."""
    from repro_torch.models.attention import flash_attention as model_flash

    b, s, g, p, hd = 2, 300, 2, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((b, s, (g * p + 2 * g) * hd), generator=gen, device=cuda).to(dtype)
    q = x[..., : g * p * hd].unflatten(-1, (g, p, hd))
    k = x[..., g * p * hd: (g * p + g) * hd].unflatten(-1, (g, hd))
    v = x[..., (g * p + g) * hd:].unflatten(-1, (g, hd))
    assert not q.is_contiguous() and not k.is_contiguous()
    before = flash_attention.launches
    got = model_flash(q, k, v, causal=True, window=96, p_bf16=p_bf16)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.shape == (b, s, g, p, hd)
    want = flash_attention_plain(q.permute(0, 2, 3, 1, 4).reshape(b * g, p, s, hd),
                                 k.permute(0, 2, 1, 3).reshape(b * g, s, hd),
                                 v.permute(0, 2, 1, 3).reshape(b * g, s, hd),
                                 causal=True, window=96, p_bf16=p_bf16)
    want = want.reshape(b, g, p, s, hd).permute(0, 3, 1, 2, 4)
    tol = 2e-2 if dtype == torch.bfloat16 or p_bf16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_q_offset_and_unequal_lengths(cuda, dtype):
    """q rows at positions 120-169 over 170 k rows: float32 runs the scalar
    kernel, bf16 the wgmma/TMA one; within 2e-5 and 2e-2."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 3, 50, 64), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, 170, 64), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, 170, 64), generator=gen, device=cuda).to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for causal, window in ((True, 0), (True, 40), (False, 0), (False, 40)):
        got = flash_attention(q, k, v, causal=causal, window=window, q_offset=120)
        want = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=120)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 64, 256), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 64, 256), dtype=torch.bfloat16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    qr, kr, vr = (torch.randn(t.shape, generator=gen, device=cuda).to(t.dtype) for t in (q, k, k))
    torch.testing.assert_close(flash_attention(qr, kr, vr, causal=True, p_bf16=True).float(),
                               flash_attention_plain(qr, kr, vr, causal=True,
                                                     p_bf16=True).float(), rtol=2e-2, atol=2e-2)
    for hd in (8, 24, 272):
        qh, kh = torch.zeros((1, 8, 64, hd), device=cuda), torch.zeros((1, 64, hd), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(qh, kh, kh, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), k, k, causal=True)


def test_serve_engine_card_equals_cpu(cuda):
    """Smoke gemma-2b and gemma3 in float32 (TF32 off): the card's engine
    gives the CPU's tokens, with one flash launch per layer per prefill."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("gemma-2b", "gemma3-27b"):
        cfg = reduce_for_smoke(get_config(arch))
        pol = Policy()
        params = model.init_params(cfg, 0, pol, device="cpu")
        card_params = {k: _to(v, cuda) for k, v in params.items()}
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, 20).astype(np.int32) for _ in range(3)]
        out = {}
        before = flash_attention.launches
        for dev, p in (("cpu", params), (cuda, card_params)):
            reqs = [Request(i, pr, 5) for i, pr in enumerate(prompts)]
            ServeEngine(cfg, p, pol, slots=2, max_len=32, device=dev).run(reqs)
            out[str(dev)] = [r.out_tokens for r in reqs]
        assert flash_attention.launches == before + 3 * cfg.num_layers
        assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemma_prefill_with_bf16_softmax_weights_card_equals_cpu(cuda, dtype, monkeypatch):
    """``Policy(attn_p_bf16=True)`` on the card: a gemma-2b prefill at full
    width, depth 2 (float32 runs the scalar kernel's mode, bf16 the
    tensor-core kernel's), held to the CPU's plain version within the bf16
    tolerance, 2e-2 relative to the logits' scale (bf16 rounds every
    activation relative to its size).  Attention is a small part of the
    logits, so each layer's attention output is held too: the card's to
    the plain version on the card's own inputs, and the first layer's to
    the CPU's, within 2e-2 relative to its scale."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention, model
    from repro_torch.models.modules import Policy

    seen = {"cpu": [], "cuda": []}
    model_flash = attention.flash_attention

    def recorded(q, k, v, **kw):
        out = model_flash(q, k, v, **kw)
        seen[q.device.type].append((q, k, v, kw, out))
        return out

    monkeypatch.setattr(attention, "flash_attention", recorded)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2)
    pol = Policy(param_dtype=dtype, compute_dtype=dtype, attn_p_bf16=True)
    params = model.init_params(cfg, 0, pol, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 200)))
    want, _ = model.prefill(params, {"tokens": toks}, cfg, pol, max_len=208)
    before = flash_attention.launches
    got, _ = model.prefill(_to(params, cuda), {"tokens": toks.to(cuda)}, cfg, pol, max_len=208)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    want = want[0, :, : cfg.vocab_size].float()
    got = got[0, :, : cfg.vocab_size].float().cpu()
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-2 * scale

    assert len(seen["cuda"]) == len(seen["cpu"]) == cfg.num_layers
    for layer, (q, k, v, kw, out) in enumerate(seen["cuda"]):
        assert kw["p_bf16"] and out.dtype == dtype
        plain = model_flash(q.cpu(), k.cpu(), v.cpu(), **kw).float()
        att_scale = max(1.0, float(plain.abs().max()))
        assert float((out.float().cpu() - plain).abs().max()) <= 2e-2 * att_scale, layer
    cpu_out, card_out = seen["cpu"][0][-1].float(), seen["cuda"][0][-1].float().cpu()
    att_scale = max(1.0, float(cpu_out.abs().max()))
    assert float((card_out - cpu_out).abs().max()) <= 2e-2 * att_scale


@pytest.mark.parametrize("p_bf16", [False, True])
def test_flash_attention_is_deterministic_under_concurrent_load(cuda, p_bf16):
    """The bf16 kernel's K/V ring (TMA loads on mbarriers) under load: the
    gemma-2b 2048-token shape launched on four streams at once beside a
    copy that keeps the memory busy, eight rounds; every output equals,
    bit for bit, the output of a launch on an idle card (the kernel sums in
    a fixed order, so a stage read before its load landed would show)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((1, 8, 2048, 256), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((1, 2048, 256), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((1, 2048, 256), generator=gen, device=cuda).to(torch.bfloat16)
    want = flash_attention(q, k, v, causal=True, p_bf16=p_bf16)
    torch.cuda.synchronize()
    src = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    dst = torch.empty_like(src)
    streams = [torch.cuda.Stream() for _ in range(5)]
    outs = []
    for _ in range(8):
        with torch.cuda.stream(streams[4]):
            for _ in range(4):
                dst.copy_(src)
        for st in streams[:4]:
            with torch.cuda.stream(st):
                outs.append(flash_attention(q, k, v, causal=True, p_bf16=p_bf16))
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, want)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# the overlapped streaming drivers on the card
# ---------------------------------------------------------------------------

_WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}


def _stream_job(device, depth=1, overlap=True, trigger=1.1):
    return StreamingJob(device=device, num_workers=4, num_partitions=16, state_capacity=8192,
                        dr=DRConfig(imbalance_trigger=trigger, migration_cost_weight=0.2,
                                    overlap_exchange=overlap, pipeline_depth=depth))


def _fields(m, skip):
    return {k: v for k, v in dataclasses.asdict(m).items() if k not in skip}


def test_overlapped_drivers_equal_serial_on_the_card(cuda):
    """Depth 1 (``process_batch``) and depth 2 (``run``) against the serial
    driver on the card, and each against the same driver on the CPU: equal
    trajectories (walls, ``state_rows`` and the driver's flags apart
    between drivers) and equal state."""
    batches = list(drifting_zipf(6, 16384, num_keys=5000, exponent=1.3, drift_every=2, seed=2))
    runs, jobs = {}, {}
    for name, depth, overlap in (("serial", 1, False), ("d1", 1, True), ("d2", 2, True)):
        for device in (cuda, "cpu"):
            job = _stream_job(device, depth, overlap)
            if name == "d1":
                ms = [job.process_batch(b) for b in batches]
            else:
                ms = job.run(batches)
            runs[name, str(device)], jobs[name, str(device)] = ms, job
    skip = _WALLS | {"state_rows", "overlapped", "pipelined"}
    for name in ("serial", "d1", "d2"):
        for a, b in zip(runs[name, "cuda"], runs[name, "cpu"]):
            assert _fields(a, _WALLS) == _fields(b, _WALLS)
        for a, b in zip(runs["serial", "cuda"], runs[name, "cuda"]):
            assert _fields(a, skip) == _fields(b, skip)
        for t in ("state_keys", "state_vals"):
            assert torch.equal(getattr(jobs[name, "cuda"], t).cpu(),
                               getattr(jobs["serial", "cpu"], t))
    assert sum(m.repartitioned for m in runs["d2", "cuda"]) >= 2
    assert any(m.pipelined for m in runs["d2", "cuda"])


def test_route_bucketize_into_a_recycled_dirty_set(cuda):
    """``out=`` a set full of junk (as a recycled set is): every output equal
    to the plain version's, written into the given tensors; a set the kernel
    cannot fill raises."""
    p, keys, valid, vals = _case(4, 20000, 16, (4,), False, 5)
    k, v, x = (torch.as_tensor(a, device=cuda) for a in (keys, valid, vals))
    t = p.tables(cuda)
    hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=16, pad_empty=True)
    for cap in (8000, 700):  # 700 overflows: dropped rows must land nowhere
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=4, capacity=cap,
                  key_fill=SENT, num_partitions=16)
        args = (k, v, x, hk, hp, t.host_to_part, hr)
        want = route_bucketize_plain(*args, **kw)
        out = tuple(torch.empty_like(b).view(-1).view(torch.uint8).fill_(0x5A)
                    .view(b.dtype).view(b.shape) for b in want[3:])
        got = route_bucketize(*args, **kw, out=out)
        torch.cuda.synchronize()
        assert all(g is o for g, o in zip(got[3:], out))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (cap == 700) == bool((want[2] > cap).any())
    bad = [out[0][:, :, :-1], out[1].to(torch.int64), out[2].cpu(),
           out[3].transpose(0, 1).contiguous().transpose(0, 1)]
    for i, b in enumerate(bad):
        wrong = list(out)
        wrong[i] = b
        with pytest.raises(ValueError, match="route kernel out"):
            route_bucketize(*args, **kw, out=tuple(wrong))


def test_depth2_steady_state_is_sync_free_on_the_card(cuda):
    """Over steady-state depth-2 batches (no action taken) the audit counts
    no blocking fetch or wait outside a safe point, and PyTorch's own sync
    check (``set_sync_debug_mode("error")``, which flags blocking copies,
    ``.item()`` and stream synchronizations but not event waits) flags no
    call: the driver's only waits are the start phase's copy events, inside
    its safe points."""
    batches = list(drifting_zipf(8, 65536, num_keys=20000, exponent=1.3, drift_every=100,
                                 seed=4))
    job = _stream_job(cuda, depth=2, trigger=1e9)
    job.run(batches[:2])  # fills the buffer pool and the staging sets
    compat.reset_host_sync_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms = job.run(batches[2:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert compat.host_sync_count() == 0
    assert all(m.action == "noop" for m in ms)
    assert all(m.pipelined for m in ms[1:])
    ref = _stream_job("cpu", overlap=False, trigger=1e9)
    ref.run(batches)
    assert torch.equal(job.state_keys.cpu(), ref.state_keys)
    assert torch.equal(job.state_vals.cpu(), ref.state_vals)


def test_staged_upload_survives_its_source_being_overwritten(cuda):
    """``_stage_next`` copies the batch into pinned staging before it
    returns: overwriting the numpy array right after still routes the
    original keys (an upload straight from the array would race the copy
    engine)."""
    batches = list(drifting_zipf(3, 65536, num_keys=20000, exponent=1.3, seed=6))
    job = _stream_job(cuda, depth=2, trigger=1e9)
    job.process_batch(batches[0])
    src = batches[1].copy()
    job._stage_next(src)
    src[:] = batches[2]
    m = job.process_batch(src)
    assert m.pipelined
    ref = _stream_job("cpu", overlap=False, trigger=1e9)
    ref.run(batches[:2])
    assert torch.equal(job.state_keys.cpu(), ref.state_keys)
    assert torch.equal(job.state_vals.cpu(), ref.state_vals)


# ---------------------------------------------------------------------------
# hot-key splitting and elastic resize on the card
# ---------------------------------------------------------------------------

def _flip_batch():
    """One batch of the full-size split stream (4 Mi records, 8 workers)."""
    from repro_torch.data.generators import hotspot_flip
    return next(hotspot_flip(1, 4_194_304, num_keys=1_000_000, exponent=1.3, seed=0))


@pytest.mark.parametrize("parts,fanouts", [(32, (8, 4, 3, 2)), (16, (2, 8)), (24, (3, 5)),
                                           (32, ())])
def test_route_kernels_at_the_split_and_resize_shapes(cuda, parts, fanouts):
    """route_bucketize and lookup_dispatch against their plain versions at
    the split and resize phases' shapes: 8 workers x 524,288 records, lanes
    of 1,048,576 rows, a live split table at fan-outs 2-8 and N = 16, 24, 32."""
    stream = _flip_batch()
    hist = Histogram.exact(stream).top(64)
    p = kip_update(uniform_partitioner(parts, heavy_capacity=128), hist)
    p = p.with_splits({int(hist.keys[i]): d for i, d in enumerate(fanouts)})
    assert p.split_map() == {int(hist.keys[i]): d for i, d in enumerate(fanouts)}
    k = torch.as_tensor(stream.astype(np.int32), device=cuda).reshape(8, -1)
    v = k != SENT
    x = torch.ones(k.shape + (1,), dtype=torch.float32, device=cuda)
    t = p.tables(cuda)
    hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=parts, pad_empty=True)
    kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=8, num_partitions=parts)
    got = route_bucketize(k, v, x, hk, hp, t.host_to_part, hr, capacity=1_048_576,
                          key_fill=SENT, **kw)
    want = route_bucketize_plain(k, v, x, hk, hp, t.host_to_part, hr, capacity=1_048_576,
                                 key_fill=SENT, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    del got, want
    got = lookup_dispatch(k, v, hk, hp, t.host_to_part, hr, **kw)
    want = lookup_dispatch_plain(k, v, hk, hp, t.host_to_part, hr, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_full_lane_unsplit_migrate_equals_cpu(cuda):
    """The unsplit's migration at a lane capacity of 262,144 rows: a key's
    partials on its 8 replica workers go home, routed by lookup_dispatch;
    every output equal to the CPU's, and the partials sum at home."""
    from repro_torch.core.shuffle import make_migrate_step
    from repro_torch.core.state import merge_into
    from repro_torch.exchange import ExchangeSpec

    w, cap = 8, 262_144
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 2**30, 8 * 200_000))[: 8 * 190_000].astype(np.int32)
    hot = int(keys[0])
    old = uniform_partitioner(32, heavy_capacity=128).with_splits({hot: 8})
    new = old.with_splits({})
    sk = np.full((w, cap), SENT, np.int32)
    sv = np.zeros((w, cap, 1), np.float32)
    rest = keys[1:]
    dest = old.lookup_np(rest) % w
    for i in range(w):  # each worker: its home keys, and one partial of the hot key
        mine = rest[dest == i]
        sk[i, : len(mine)] = mine
        sv[i, : len(mine), 0] = 1.0
        sk[i, len(mine)] = hot
        sv[i, len(mine), 0] = float(i + 1)
    outs = {}
    for label, dev in (("card", cuda), ("cpu", "cpu")):
        step = make_migrate_step(num_workers=w, state_capacity=cap, num_hosts=new.num_hosts,
                                 seed=new.seed,
                                 spec=ExchangeSpec(num_lanes=w, capacity=cap, axis="data"))
        before = lookup_dispatch.launches
        out = step(new.tables(dev), torch.as_tensor(sk, device=dev),
                   torch.as_tensor(sv, device=dev))
        if label == "card":
            assert lookup_dispatch.launches == before + 1
        kept = torch.where(out.kept_valid, out.kept_keys, SENT)
        merged = merge_into(kept, out.kept_vals, out.recv_keys, out.recv_vals, out.recv_valid)
        outs[label] = [t.cpu() for t in (*out, *merged)]
    for g, c in zip(outs["card"], outs["cpu"], strict=True):
        assert torch.equal(g, c)
    mk, mv = outs["cpu"][-3], outs["cpu"][-2]
    home = int(new.lookup_np(np.asarray([hot], np.int32))[0]) % w
    hit = mk == hot
    assert int(hit.sum()) == 1 and bool(hit[home].any())
    assert float(mv[hit].sum()) == sum(range(1, w + 1))
    assert int(outs["cpu"][8]) == 0 and int(outs["cpu"][-1].sum()) == 0  # no overflow


def _small_job(device, driver, parts, **kw):
    extra = {"serial": dict(overlap_exchange=False), "d1": {}, "d2": dict(pipeline_depth=2)}
    return StreamingJob(device=device, num_workers=8, num_partitions=parts, state_capacity=16_384,
                        dr=DRConfig(imbalance_trigger=1.2, **extra[driver], **kw))


@pytest.mark.parametrize("driver", ["serial", "d1", "d2"])
def test_split_and_resize_jobs_card_equal_cpu(cuda, driver):
    """A small split stream (Splits and an Unsplit) and a small elastic one
    (a grow, a shrink, a requested resize and a second grow) on the card and
    on the CPU, by each driver: equal trajectories and state."""
    from repro_torch.data.generators import hotspot_flip, sawtooth_skew

    flips = list(hotspot_flip(10, 16_384, num_keys=5000, exponent=1.3, flip_at=4, seed=0))
    saws = list(sawtooth_skew(9, 16_384, num_keys=5000, exponent=1.8, period=3, seed=0))
    split = dict(migration_cost_weight=0.2, split_keys_enabled=True, sketch_decay=0.5)
    elastic = dict(migration_cost_weight=0.1, elastic=True, min_partitions=8,
                   max_partitions=16, grow_trigger=4.0, shrink_trigger=2.5)
    for batches, parts, kw, want in ((flips, 32, split, {"split", "unsplit"}),
                                     (saws, 8, elastic, {"resize"})):
        jobs = {}
        for label, device in (("card", cuda), ("cpu", "cpu")):
            job = jobs[label] = _small_job(device, driver, parts, **kw)
            for seg in (batches[:6], batches[6:]):
                if driver == "d1":
                    for b in seg:
                        job.process_batch(b)
                else:
                    job.run(seg)
                if "elastic" in kw and not job._pending_resize:
                    job.resize(12)  # after batch 5: applied at batch 6's safe point
        card, cpu = jobs["card"], jobs["cpu"]
        for a, b in zip(card.metrics, cpu.metrics, strict=True):
            assert _fields(a, _WALLS) == _fields(b, _WALLS)
        assert torch.equal(card.state_keys.cpu(), cpu.state_keys)
        assert torch.equal(card.state_vals.cpu(), cpu.state_vals)
        kinds = {m.action for m in cpu.metrics}
        assert want <= kinds, kinds


@pytest.mark.parametrize("loads", ["ties", "hot replica", "random", "equal"])
@pytest.mark.parametrize("w,n,parts,fanouts", [(8, 65536, 32, (8, 4, 3)), (3, 5000, 8, (2, 8)),
                                               (1, 1000, 16, (16,))])
def test_route_kernels_with_loads_equal_plain(cuda, w, n, parts, fanouts, loads):
    """The two-choice least-load pick in both route kernels against their
    plain versions: a load vector with many ties, one hot replica at 1e9,
    random loads and equal loads (which must route as no vector does); the
    kernels read it themselves (one launch each, no other path)."""
    p, keys, valid, vals = _case(w, n, parts, fanouts, False, n)
    k, v, x = (torch.as_tensor(a, device=cuda) for a in (keys, valid, vals))
    t = p.tables(cuda)
    hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=parts, pad_empty=True)
    hot = int(p.lookup_np(np.asarray(list(p.split_map())[:1], np.int32))[0])
    vec = {"ties": np.repeat(np.arange(parts // 4, dtype=np.float32), 4),
           "hot replica": np.where(np.arange(parts) == hot, 1e9, 1.0),
           "random": np.random.default_rng(n).random(parts),
           "equal": np.full(parts, 3.0)}[loads]
    pl = torch.as_tensor(np.asarray(vec, np.float32), device=cuda)
    kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=w, num_partitions=parts,
              part_loads=pl)
    before = (lookup_dispatch.launches, route_bucketize.launches)
    with _dirty_outputs():
        got = lookup_dispatch(k, v, hk, hp, t.host_to_part, hr, **kw)
    want = lookup_dispatch_plain(k, v, hk, hp, t.host_to_part, hr, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x_) for g, x_ in zip(got, want))
    if loads == "equal":
        hashed = lookup_dispatch(k, v, hk, hp, t.host_to_part, hr,
                                 **{**kw, "part_loads": None})
        assert all(torch.equal(g, x_) for g, x_ in zip(got, hashed))
    with _dirty_outputs():
        got = route_bucketize(k, v, x, hk, hp, t.host_to_part, hr, capacity=2 * n // w + 8,
                              key_fill=SENT, **kw)
    want = route_bucketize_plain(k, v, x, hk, hp, t.host_to_part, hr,
                                 capacity=2 * n // w + 8, key_fill=SENT, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x_) for g, x_ in zip(got, want))
    assert lookup_dispatch.launches - before[0] >= 1
    assert route_bucketize.launches == before[1] + 1


@pytest.mark.parametrize("cap", [8, 300])
def test_ragged_backend_on_cuda_tensors(cuda, cap):
    """The ragged transport on the card: its rows, counts and shipped rows
    equal the CPU's, and its rows equal the dense transport's (capacity 8
    overflows every lane)."""
    from repro_torch.exchange import ExchangeSpec, Payload, make_exchange

    rng = np.random.default_rng(cap)
    lane = rng.integers(0, 4, (4, 700)).astype(np.int32)
    valid = rng.random((4, 700)) < 0.8
    vals = rng.normal(size=(4, 700, 2)).astype(np.float32)
    out = {}
    for label, dev, be in (("ragged card", cuda, "ragged"), ("ragged cpu", "cpu", "ragged"),
                           ("dense card", cuda, "dense")):
        ex = make_exchange(ExchangeSpec(num_lanes=4, capacity=cap, axis="data"), be)
        res = ex.finish(ex.start(torch.as_tensor(lane, device=dev),
                                 torch.as_tensor(valid, device=dev),
                                 [Payload(torch.as_tensor(vals, device=dev), -1.0)]))
        va, (v,) = res.unpack()
        out[label] = res, va.cpu(), v.cpu()
    card, cpu, dense = out["ragged card"], out["ragged cpu"], out["dense card"]
    assert torch.equal(card[1], cpu[1]) and torch.equal(card[2], cpu[2])
    assert torch.equal(card[1], dense[1]) and torch.equal(card[2], dense[2])
    for f in ("shipped_rows", "lane_counts", "recv_counts"):
        assert torch.equal(getattr(card[0], f).cpu(), getattr(cpu[0], f)), f
    assert torch.equal(card[0].send.overflow.cpu(), dense[0].send.overflow.cpu())


@pytest.mark.parametrize("driver", ["serial", "d1", "d2"])
def test_least_load_and_auto_backend_jobs_card_equal_cpu(cuda, driver):
    """A small split stream under the least-load pick with the BackendPolicy
    on (a switch to ragged mid-stream), and a ragged-pinned drifting stream,
    on the card and on the CPU by each driver: equal trajectories and
    state."""
    from repro_torch.data.generators import hotspot_flip

    flips = list(hotspot_flip(10, 16_384, num_keys=5000, exponent=1.3, flip_at=4, seed=0))
    drift = list(drifting_zipf(6, 16_384, num_keys=5000, exponent=1.3, drift_every=2, seed=1))
    pick = dict(migration_cost_weight=0.2, split_keys_enabled=True, sketch_decay=0.5,
                split_least_load=True, auto_backend=True, backend_patience=2,
                backend_cooldown=50)
    for batches, kw, job_kw, want in ((flips, pick, {}, {"split", "switch_backend"}),
                                      (drift, {}, {"exchange_backend": "ragged"},
                                       {"repartition"})):
        jobs = {}
        for label, device in (("card", cuda), ("cpu", "cpu")):
            job = jobs[label] = _small_job(device, driver, 32, **kw)
            if job_kw:
                job = jobs[label] = StreamingJob(
                    device=device, num_workers=8, num_partitions=32, state_capacity=16_384,
                    dr=job.drm.config, **job_kw)
            if driver == "d1":
                for b in batches:
                    job.process_batch(b)
            else:
                job.run(batches)
        card, cpu = jobs["card"], jobs["cpu"]
        for a, b in zip(card.metrics, cpu.metrics, strict=True):
            assert _fields(a, _WALLS) == _fields(b, _WALLS)
        assert torch.equal(card.state_keys.cpu(), cpu.state_keys)
        assert torch.equal(card.state_vals.cpu(), cpu.state_vals)
        assert want <= {m.action for m in cpu.metrics}, [m.action for m in cpu.metrics]


@pytest.mark.parametrize("n", [599_187, 2341, 4097])
@pytest.mark.parametrize("splits", [None, (4, 3)])
def test_route_kernels_at_seven_lanes(cuda, n, splits):
    """Seven workers, as after an eviction from eight: each worker's slice
    of a stacked ``[7, n]`` key tensor starts at an offset that is not a
    multiple of 16 bytes for odd ``n`` (599,187 is a 4 Mi-record batch over
    7 workers); both route kernels equal their plain versions over 32
    partitions, 7 lanes, and a capacity sized as the shuffle sizes it."""
    p, keys, valid, vals = _case(7, n, 32, splits, False, n % 1000)
    k, v, x = (torch.as_tensor(a, device=cuda) for a in (keys, valid, vals))
    assert k.is_contiguous() and k[1].data_ptr() % 16 != 0
    cap = int(np.ceil(2.0 * n / 8.0) * 8)
    t = p.tables(cuda)
    hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=32, pad_empty=True)
    kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=7, num_partitions=32)
    got = route_bucketize(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap, key_fill=SENT, **kw)
    want = route_bucketize_plain(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap,
                                 key_fill=SENT, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    lk, lp, _ = ops.pad_heavy_tables(t, num_partitions=0, pad_empty=False)
    home = dict(kw, num_partitions=0)
    got = lookup_dispatch(k, v, lk, lp, t.host_to_part, None, **home)
    want = lookup_dispatch_plain(k, v, lk, lp, t.host_to_part, None, **home)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


@pytest.mark.parametrize("driver", ["serial", "d1", "d2"])
def test_failure_domain_jobs_card_equal_cpu(cuda, driver):
    """A kill evicted onto 7 workers (then repartitions at 7 lanes), and
    Quarantine, Recover and Evict from lane health, on the card and on the
    CPU by each driver: equal trajectories, recoveries, lane ids and
    state."""
    from repro_torch.exchange import FaultPlan, FaultyBackend, LaneFault

    batches = list(drifting_zipf(12, 16_384, num_keys=5000, exponent=1.3, drift_every=3,
                                 seed=3))
    kill = FaultPlan(faults=(LaneFault(4, 5, "kill"),))
    health = FaultPlan(faults=(LaneFault(0, 2, "latency", delay_s=0.005, span=4),)
                       + tuple(LaneFault(t, 6, "transient") for t in range(6, 11)))
    cases = ((kill, dict(imbalance_trigger=1.2, migration_cost_weight=0.2,
                         snapshot_interval=3), ["evict"]),
             (health, dict(imbalance_trigger=1e9, health_enabled=True, health_straggler_ms=3.0,
                           health_recover_after=3, snapshot_interval=3),
              ["quarantine", "recover", "evict"]))
    for plan, kw, want in cases:
        jobs = {}
        for label, device in (("card", cuda), ("cpu", "cpu")):
            extra = {"serial": dict(overlap_exchange=False), "d1": {},
                     "d2": dict(pipeline_depth=2)}[driver]
            job = jobs[label] = StreamingJob(
                device=device, num_workers=8, num_partitions=32, state_capacity=16_384,
                dr=DRConfig(**kw, **extra), exchange_backend=FaultyBackend("dense", plan))
            if driver == "d1":
                for b in batches:
                    job.process_batch(b)
            else:
                job.run(batches)
        card, cpu = jobs["card"], jobs["cpu"]
        for a, b in zip(card.metrics, cpu.metrics, strict=True):
            assert _fields(a, _WALLS) == _fields(b, _WALLS)
        assert ([dataclasses.replace(r, wall_s=0.0) for r in card.recoveries]
                == [dataclasses.replace(r, wall_s=0.0) for r in cpu.recoveries])
        assert card._lane_ids == cpu._lane_ids
        assert torch.equal(card.state_keys.cpu(), cpu.state_keys)
        assert torch.equal(card.state_vals.cpu(), cpu.state_vals)
        changes = [m.action for m in cpu.metrics if m.action not in ("noop", "repartition")]
        assert changes + [r.kind for r in cpu.recoveries] == want, changes
        if plan is kill:  # the repartitions after the eviction route at 7 lanes
            assert any(m.repartitioned and m.lanes == 7 for m in cpu.metrics)


@pytest.mark.parametrize("backend", ["dense", "hierarchical"])
def test_topology_jobs_on_the_card(cuda, backend):
    """Eight workers on two hosts of four: the card equals the CPU in every
    metric but the walls (the shipped rows by class included) and in the
    state, by each driver; the hierarchical ships take two hops; and at
    depth 2 the steady-state batches stay free of host syncs (the class
    tables reach the card once, pinned, at the steps' first use)."""
    from repro_torch.exchange import ExchangeTopology

    batches = list(drifting_zipf(6, 16384, num_keys=5000, exponent=1.3, drift_every=2, seed=2))
    topo = ExchangeTopology(8, 4)
    for extra in (dict(overlap_exchange=False), {}, dict(pipeline_depth=2)):
        jobs = {label: StreamingJob(device=device, num_workers=8, num_partitions=32,
                                    state_capacity=16_384, topology=topo,
                                    exchange_backend=backend,
                                    dr=DRConfig(imbalance_trigger=1.2, migration_cost_weight=0.2,
                                                **extra))
                for label, device in (("card", cuda), ("cpu", "cpu"))}
        for job in jobs.values():
            job.run(batches)
        card, cpu = jobs["card"], jobs["cpu"]
        for a, b in zip(card.metrics, cpu.metrics, strict=True):
            assert _fields(a, _WALLS) == _fields(b, _WALLS)
            assert sum(a.shipped_rows_by_class) == a.shipped_rows
        assert torch.equal(card.state_keys.cpu(), cpu.state_keys)
        assert torch.equal(card.state_vals.cpu(), cpu.state_vals)
        if backend == "hierarchical":
            assert card.exchange_backend.flat_ships == 0 < card.exchange_backend.two_hop_ships
    job = StreamingJob(device=cuda, num_workers=8, num_partitions=32, state_capacity=16_384,
                       topology=topo, exchange_backend=backend,
                       dr=DRConfig(imbalance_trigger=1e9, pipeline_depth=2))
    job.run(batches[:2])
    compat.reset_host_sync_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms = job.run(batches[2:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert compat.host_sync_count() == 0
    assert all(m.pipelined for m in ms[1:])


@pytest.mark.parametrize("ep_shards,backend", [(0, None), (4, "dense"), (4, "ragged")])
def test_moe_serving_card_equals_cpu(cuda, ep_shards, backend):
    """Smoke Scout in float32 (TF32 off) over 4 stacked EP shards and on the
    oracle path: the card's engine gives the CPU's tokens and the same
    router counts a prefill; with shards every MoE layer launches
    dispatch_count (hop 1 and hop 2 for a prompt of a multiple of 4, one
    local bucketize otherwise and per decoded token)."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model, transformer
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("llama4-scout-17b-a16e"))
    pol = Policy(ep_shards=ep_shards, exchange_backend=backend)
    params = model.init_params(cfg, 0, pol, device="cpu")
    card_params = _to(params, cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (20, 13, 8)]
    out, counts = {}, {}
    backbone = transformer.backbone

    def capturing(*a, **k):
        res = backbone(*a, **k)
        counts.setdefault(str(a[1].device), []).append(res[2].cpu())
        return res

    transformer.backbone = capturing
    try:
        for dev, p in (("cpu", params), (cuda, card_params)):
            before = dispatch_count.launches
            reqs = [Request(i, pr, 5) for i, pr in enumerate(prompts)]
            ServeEngine(cfg, p, pol, slots=2, max_len=32, device=dev).run(reqs)
            out[str(dev)] = [r.out_tokens for r in reqs]
            launched = dispatch_count.launches - before
    finally:
        transformer.backbone = backbone
    assert out["cuda"] == out["cpu"]
    assert all(torch.equal(a, b) for a, b in zip(counts["cuda:0"], counts["cpu"], strict=True))
    moe_layers = sum(blk.ffn == "moe" for blk in transformer.layers(cfg))
    # prefills: 20 and 8 split over 4 shards (2 launches a layer), 13 does not
    want = moe_layers * (2 + 1 + 2 + 3 * 4) if ep_shards else 0
    assert launched == want, (launched, want)


def test_dense_prefill_and_decode_are_sync_free_on_the_card(cuda):
    """One prefill and one decode step of smoke gemma-2b in bf16 make no
    blocking call (``set_sync_debug_mode("error")``): the backbone fills a
    dense model's MoE outputs on the card and the rope frequencies are
    uploaded once, by the warm-up call."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.models.modules import Policy

    cfg = reduce_for_smoke(get_config("gemma-2b"))
    pol = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    params = model.init_params(cfg, 0, pol, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), dtype=torch.int32, device=cuda)

    def serve():
        logits, cache = model.prefill(params, {"tokens": tokens}, cfg, pol, 32)
        nxt = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        return logits, model.decode_step(params, cache, nxt, cfg, pol)[0]

    serve()  # loads the kernels and uploads the rope frequencies
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, step = serve()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert first.shape == step.shape == (2, 1, first.shape[-1])
    assert bool(torch.isfinite(first).all()) and bool(torch.isfinite(step).all())


# name -> (G, P, Sq, Sk, hd, causal, window, q_offset)
BWD_CASES = {
    "gemma": (1, 8, 256, 256, 256, True, 0, 0),
    "scout": (8, 5, 192, 192, 128, True, 0, 0),
    "ragged": (2, 3, 100, 100, 64, True, 0, 0),
    "window": (1, 4, 200, 200, 128, True, 48, 0),
    "offset": (2, 2, 37, 101, 32, True, 0, 64),
    "full": (3, 1, 70, 45, 16, False, 0, 0),
    # Scout's and gemma-2b's head layouts with ragged Sq and Sk, a window
    # and a q_offset (q positions 33-332 over 333 keys; 64-320 over 321)
    "scout_ragged": (2, 5, 300, 333, 128, True, 100, 33),
    "gemma_ragged": (1, 8, 257, 321, 256, True, 96, 64),
    # whisper-base's encoder (1,500 rows: a partial last tile) and its
    # cross-attention (448 q rows over 1,500 k rows), non-causal
    "whisper_encoder": (8, 1, 1500, 1500, 64, False, 0, 0),
    "whisper_cross": (8, 1, 448, 1500, 64, False, 0, 0),
}


def _excess(got, ref):
    """How much farther bf16 ``got`` lies from the float32 ``ref`` than half
    a bf16 ulp, over the largest |ref| (``chip_smoke._bwd_error``)."""
    g = got.float()
    _, e = torch.frexp(torch.maximum(g.abs(), ref.abs()))
    half_ulp = torch.ldexp(torch.ones_like(ref), e - 9)
    return float(((g - ref).abs() - half_ulp).max()) / float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_backward_kernel_equals_plain(cuda, case, dtype):
    """The backward kernels (``csrc/flash_attention_bwd.cu``) against their
    plain version on the same inputs and forward output: within 1e-4 x
    max(1, |ref|) in float32, and in bf16 no farther from the float32
    plain gradient than 1e-2 x max(1, |ref|) beyond the output's own
    rounding, and that excess within 1e-3 of the gradient's largest entry
    (phase 19 (d)'s measure); bf16 both with the forward's lse (the
    training path: no stats pass) and without it (the stats pass); two
    calls give the same bits, outputs handed out dirty."""
    from repro_torch.kernels import flash_attention as kflash

    g, p, sq, sk, hd, causal, window, q_offset = BWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    q, k, v = mk(1, sq, g, p, hd), mk(1, sk, g, hd), mk(1, sk, g, hd)
    dout = mk(1, sq, g * p * hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    bf = dtype == torch.bfloat16
    if bf:
        o, lse = kflash.flash_attention_seq_major(q, k, v, return_lse=True, **kw)
    else:
        o, lse = kflash.flash_attention_seq_major(q, k, v, **kw), None
    want = kflash.flash_attention_bwd_seq_major_plain(*(t.float() for t in (q, k, v, o, dout)),
                                                      **kw)
    for extra in ([{"lse": lse}, {}] if bf else [{}]):
        stats = kflash.flash_attention_bwd_seq_major.stats_launches
        with _dirty():
            got = kflash.flash_attention_bwd_seq_major(q, k, v, o, dout, **kw, **extra)
        again = kflash.flash_attention_bwd_seq_major(q, k, v, o, dout, **kw, **extra)
        torch.cuda.synchronize()
        assert kflash.flash_attention_bwd_seq_major.stats_launches - stats == (0 if extra else 2)
        for a, b, w in zip(got, again, want):
            assert a.dtype == dtype and torch.equal(a, b)
            err = ((a.float() - w).abs() / w.abs().clamp(min=1.0)).max()
            assert float(err) <= (1e-4 if dtype == torch.float32 else 1e-2), (case, float(err))
            if bf:
                assert _excess(a, w) <= 1e-3, (case, extra.keys(), _excess(a, w))


@pytest.mark.parametrize("case", ["gemma", "scout", "window", "offset", "gemma_ragged"])
def test_flash_forward_bits_equal_with_lse(cuda, case):
    """The bf16 forward gives the same output bits whether it also writes
    lse (training) or not (serving), and its lse lies within 1e-5 of
    ``torch.logsumexp`` of the plain masked scores."""
    from repro_torch.kernels import flash_attention as kflash

    g, p, sq, sk, hd, causal, window, q_offset = BWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(5)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = mk(2, sq, g, p, hd), mk(2, sk, g, hd), mk(2, sk, g, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    plain_out = kflash.flash_attention_seq_major(q, k, v, **kw)
    out, lse = kflash.flash_attention_seq_major(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    ref = kflash.flash_lse_plain(q.float().permute(0, 2, 3, 1, 4).reshape(-1, p, sq, hd),
                                 k.float().permute(0, 2, 1, 3).reshape(-1, sk, hd), **kw)
    assert float((lse - ref.reshape(lse.shape)).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="lse"):
        kflash.flash_attention_seq_major(q, k, v, return_lse=True, p_bf16=True, **kw)


def test_flash_backward_with_bf16_softmax_weights(cuda):
    """``p_bf16=True`` under autograd on the card: the forward rounds its
    weights and writes no lse, so the backward runs the stats pass (one
    call of it) and gives the exact float32 weights' gradient of the
    forward's own output, within phase 19 (d)'s 1e-3 excess."""
    from repro_torch.kernels import flash_attention as kflash

    gen = torch.Generator(device=cuda).manual_seed(7)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = (mk(2, 200, 2, 4, 128), mk(2, 200, 2, 128), mk(2, 200, 2, 128))
    for t in (q, k, v):
        t.requires_grad_()
    dout = mk(2, 200, 2 * 4 * 128)
    stats, launches = (kflash.flash_attention_bwd_seq_major.stats_launches,
                       kflash.flash_attention_bwd_seq_major.launches)
    out = kflash.flash_attention_seq_major_grad(q, k, v, causal=True, window=64, p_bf16=True)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert kflash.flash_attention_bwd_seq_major.launches - launches == 1
    assert kflash.flash_attention_bwd_seq_major.stats_launches - stats == 1
    want = kflash.flash_attention_bwd_seq_major_plain(
        *(t.detach().float() for t in (q, k, v, out, dout)), causal=True, window=64)
    for a, w in zip(got, want):
        assert _excess(a, w) <= 1e-3


@contextlib.contextmanager
def _dirty():
    """``torch.empty`` hands out 0x5A bytes inside (a cell the kernel
    forgets to write shows)."""
    empty = torch.empty

    def dirty(*a, **k):
        t = empty(*a, **k)
        if t.numel():
            t.view(-1).view(torch.uint8).fill_(0x5A)
        return t

    torch.empty = dirty
    try:
        yield
    finally:
        torch.empty = empty


@pytest.mark.parametrize("arch,ep_shards", [("gemma-2b", 0), ("llama4-scout-17b-a16e", 4)])
def test_smoke_train_steps_card_equal_cpu(cuda, arch, ep_shards):
    """Three float32 train steps of a smoke config on the card and on the
    CPU from the same parameters: equal expert counts and overflow, loss
    and grad_norm within 1e-4 relative, and the backward kernel launched
    once a layer a step."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import OptConfig, init_opt, tree_map
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config(arch))
    pol = Policy(ep_shards=ep_shards, exchange_backend="dense" if ep_shards else None)
    opt = OptConfig(lr=1e-3, warmup=1)
    cpu = model.init_params(cfg, 0, pol, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    states = {"cpu": (cpu, init_opt(cpu, opt)), "cuda": (card, init_opt(card, opt))}
    step = make_train_step(cfg, pol, opt)
    rng = np.random.default_rng(0)
    kflash.flash_attention_bwd_seq_major.launches = 0
    for _ in range(3):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 65)))
        out = {}
        for dev, (params, st) in states.items():
            t = toks.to(dev)
            batch = {"tokens": t[:, :-1], "labels": t[:, 1:],
                     "mask": torch.ones((2, 64), device=dev)}
            params, st, m = step(params, st, batch)
            states[dev] = (params, st)
            out[dev] = {k: v.cpu() for k, v in m.items()}
        assert float(out["cuda"]["overflow"]) == float(out["cpu"]["overflow"])
        if "expert_counts" in out["cpu"]:
            assert torch.equal(out["cuda"]["expert_counts"], out["cpu"]["expert_counts"])
        for key in ("loss", "grad_norm"):
            a, b = float(out["cuda"][key]), float(out["cpu"][key])
            assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
    assert kflash.flash_attention_bwd_seq_major.launches == 3 * cfg.num_layers


def test_xlstm_card_equals_cpu(cuda):
    """The smoke xlstm-125m at float32: a 24-token prefill and 4 decode
    steps (the recurrent states stored back into the cache) within 1e-4 x
    max(1, |cpu|) of the CPU's logits, then 3 train steps with loss and
    grad_norm within 1e-4 relative; a 300-token prompt raises ValueError."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import OptConfig, init_opt, tree_map
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("xlstm-125m"))
    pol = Policy()
    cpu = model.init_params(cfg, 0, pol, device="cpu")
    sides = {"cpu": cpu, "cuda": tree_map(lambda t: t.to(cuda), cpu)}
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)))
    logits, caches = {}, {}
    for dev, p in sides.items():
        logits[dev], caches[dev] = model.prefill(p, {"tokens": toks.to(dev)}, cfg, pol, 32)
    for i in range(5):
        a, b = logits["cuda"].cpu(), logits["cpu"]
        assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) <= 1e-4, i
        if i == 4:
            break
        nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)))
        for dev, p in sides.items():
            logits[dev], caches[dev] = model.decode_step(p, caches[dev], nxt.to(dev), cfg, pol)
    with pytest.raises(ValueError, match="chunk contract"):
        model.prefill(sides["cuda"], {"tokens": torch.zeros((1, 300), dtype=torch.int64,
                                                            device=cuda)}, cfg, pol, 304)
    opt = OptConfig(lr=1e-3, warmup=1)
    step = make_train_step(cfg, pol, opt)
    states = {dev: (p, init_opt(p, opt)) for dev, p in sides.items()}
    for _ in range(3):
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 65)))
        out = {}
        for dev, (p, st) in states.items():
            d = t.to(dev)
            p, st, m = step(p, st, {"tokens": d[:, :-1], "labels": d[:, 1:],
                                    "mask": torch.ones((2, 64), device=dev)})
            states[dev] = (p, st)
            out[dev] = {k: v.cpu() for k, v in m.items()}
        for key in ("loss", "grad_norm"):
            a, b = float(out["cuda"][key]), float(out["cpu"][key])
            assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)


def test_whisper_card_equals_cpu(cuda):
    """The smoke whisper-base at float32: a 12-token prefill over 32 frames
    and 4 decode steps within 1e-4 x max(1, |cpu|) of the CPU's logits (4
    flash launches a prefill: 2 encoder layers, the decoder's self and
    cross; none a decoded token), then 3 train steps with loss and
    grad_norm within 1e-4 relative (4 forward and 4 backward launches a
    step)."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import OptConfig, init_opt, tree_map
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("whisper-base"))
    per = cfg.enc_layers + 2 * cfg.num_layers
    pol = Policy()
    cpu = model.init_params(cfg, 0, pol, device="cpu")
    sides = {"cpu": cpu, "cuda": tree_map(lambda t: t.to(cuda), cpu)}
    rng = np.random.default_rng(0)
    frames = lambda: torch.as_tensor(rng.standard_normal((2, cfg.enc_len, cfg.d_model)),
                                     dtype=torch.float32)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12))),
             "enc_embeds": frames()}
    kflash.flash_attention.launches = 0
    logits, caches = {}, {}
    for dev, p in sides.items():
        logits[dev], caches[dev] = model.prefill(
            p, {k: v.to(dev) for k, v in batch.items()}, cfg, pol, 20)
    assert kflash.flash_attention.launches == per
    for i in range(5):
        a, b = logits["cuda"].cpu(), logits["cpu"]
        assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) <= 1e-4, i
        if i == 4:
            break
        nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)))
        for dev, p in sides.items():
            logits[dev], caches[dev] = model.decode_step(p, caches[dev], nxt.to(dev), cfg, pol)
    assert kflash.flash_attention.launches == per
    opt = OptConfig(lr=1e-3, warmup=1)
    step = make_train_step(cfg, pol, opt)
    states = {dev: (p, init_opt(p, opt)) for dev, p in sides.items()}
    kflash.flash_attention.launches = kflash.flash_attention_bwd_seq_major.launches = 0
    for _ in range(3):
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
        f = frames()
        out = {}
        for dev, (p, st) in states.items():
            d = t.to(dev)
            p, st, m = step(p, st, {"tokens": d[:, :-1], "labels": d[:, 1:],
                                    "mask": torch.ones((2, 32), device=dev),
                                    "enc_embeds": f.to(dev)})
            states[dev] = (p, st)
            out[dev] = {k: v.cpu() for k, v in m.items()}
        for key in ("loss", "grad_norm"):
            a, b = float(out["cuda"][key]), float(out["cpu"][key])
            assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
    assert kflash.flash_attention.launches == kflash.flash_attention_bwd_seq_major.launches
    assert kflash.flash_attention.launches == 3 * per


@pytest.mark.parametrize("arch,ep_shards,remat_policy", [
    ("gemma-2b", 0, "nothing"), ("llama4-scout-17b-a16e", 4, "nothing"),
    ("llama4-scout-17b-a16e", 4, "save_moe"), ("whisper-base", 0, "nothing"),
    ("jamba-1.5-large-398b", 4, "nothing")])
def test_remat_on_the_card_equals_the_step_without_it(cuda, arch, ep_shards, remat_policy):
    """Two bf16 train steps of a smoke config with and without remat from
    the same parameters: finite losses and gradient norms, metrics and
    parameters equal bit for bit; flash forward launched twice an attention
    layer a step under remat, its backward once; dispatch_count 2 a MoE
    layer a step, 4 under ``"nothing"``.  whisper's flash calls a forward
    are its encoder layers plus two a decoder layer (self and cross);
    jamba's period holds one attention layer among seven Mamba mixers."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import OptConfig, init_opt, leaves, tree_map
    from repro_torch.train.train_step import make_train_step

    cfg = reduce_for_smoke(get_config(arch))
    bf16 = torch.bfloat16
    base = dict(param_dtype=bf16, compute_dtype=bf16, ep_shards=ep_shards,
                exchange_backend="dense" if ep_shards else None)
    start = model.init_params(cfg, 0, Policy(**base), device=cuda)
    opt = OptConfig(lr=1e-3, warmup=1)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(2):
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 65)), device=cuda)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                        "mask": torch.ones((2, 64), device=cuda)})
        if cfg.encdec:
            batches[-1]["enc_embeds"] = torch.as_tensor(
                rng.standard_normal((2, cfg.enc_len, cfg.d_model)), dtype=torch.float32,
                device=cuda)
    runs = []
    for extra in ({}, dict(remat=True, remat_policy=remat_policy)):
        params = tree_map(lambda t: t.clone(), start)
        st = init_opt(params, opt)
        step = make_train_step(cfg, Policy(**base, **extra), opt)
        for fn in (kflash.flash_attention, kflash.flash_attention_bwd_seq_major, dispatch_count):
            fn.launches = 0
        metrics = []
        for batch in batches:
            params, st, m = step(params, st, batch)
            metrics.append({k: v.cpu() for k, v in m.items()})
        runs.append((metrics, leaves(params), kflash.flash_attention.launches,
                     kflash.flash_attention_bwd_seq_major.launches, dispatch_count.launches))
    (m0, p0, f0, b0, d0), (m1, p1, f1, b1, d1) = runs
    for a, b in zip(m0, m1):
        assert all(torch.isfinite(a[k]).all() for k in ("loss", "grad_norm"))
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    moe_layers = sum(blk.ffn == "moe" for blk in cfg.pattern) * cfg.num_periods
    attn_layers = sum(blk.mixer == "attn" for blk in cfg.pattern) * cfg.num_periods
    per = cfg.enc_layers + 2 * cfg.num_layers if cfg.encdec else attn_layers
    assert (f0, f1, b0, b1) == (2 * per, 4 * per, 2 * per, 2 * per)
    rerun = 2 if remat_policy == "nothing" else 1
    assert (d0, d1) == (2 * 2 * moe_layers, rerun * 2 * 2 * moe_layers)


@pytest.mark.parametrize("ep_shards", [0, 4])
def test_jamba_card_equals_cpu(cuda, ep_shards):
    """The smoke jamba-1.5-large (one period: seven Mamba mixers, one
    attention, four top-2 MoE FFNs) at float32: the Mamba mixer of layer 0
    alone, forward and backward on 2 x 512 tokens (two chunks), within
    1e-4 x max(1, |cpu|); a 12-token prefill and 4 decode steps within
    1e-4 x max(1, |cpu|) of the CPU's logits (one flash launch a prefill,
    none a token; at 4 shards 2 dispatch_count launches a MoE layer a
    prefill, 1 a token); a 300-token prompt raises ValueError.  Remat on
    the card: ``test_remat_on_the_card_equals_the_step_without_it``."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import model, ssm
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("jamba-1.5-large-398b"))
    pol = Policy(ep_shards=ep_shards, exchange_backend="dense" if ep_shards else None)
    cpu = model.init_params(cfg, 0, pol, device="cpu")
    sides = {"cpu": cpu, "cuda": tree_map(lambda t: t.to(cuda), cpu)}
    rng = np.random.default_rng(2)

    def rel(a, b):
        return float(((a.cpu() - b).abs() / b.abs().clamp(min=1.0)).max())

    x = torch.as_tensor(rng.standard_normal((2, 512, cfg.d_model)), dtype=torch.float32)
    cot = torch.as_tensor(rng.standard_normal((2, 512, cfg.d_model)), dtype=torch.float32)
    out = {}
    for dev, p in sides.items():
        mp = {k: v.detach().requires_grad_() for k, v in p["layers"][0]["mamba"].items()}
        xd = x.to(dev).requires_grad_()
        y, st = ssm.mamba_forward(mp, xd, pol, d_state=cfg.mamba_d_state)
        grads = torch.autograd.grad((y * cot.to(dev)).sum(), [xd, *mp.values()])
        out[dev] = [y, st["ssm"], st["conv"], *grads]
    for a, b in zip(out["cuda"], out["cpu"], strict=True):
        assert rel(a, b) <= 1e-4
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
    logits, caches = {}, {}
    kflash.flash_attention.launches = dispatch_count.launches = 0
    for dev, p in sides.items():
        logits[dev], caches[dev] = model.prefill(p, {"tokens": toks.to(dev)}, cfg, pol, 24)
    moe_layers = sum(blk.ffn == "moe" for blk in cfg.pattern)
    assert kflash.flash_attention.launches == 1
    assert dispatch_count.launches == (2 * moe_layers if ep_shards else 0)
    for i in range(5):
        assert rel(logits["cuda"], logits["cpu"]) <= 1e-4, i
        if i == 4:
            break
        nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)))
        for dev, p in sides.items():
            logits[dev], caches[dev] = model.decode_step(p, caches[dev], nxt.to(dev), cfg, pol)
    assert kflash.flash_attention.launches == 1
    assert dispatch_count.launches == ((2 + 4) * moe_layers if ep_shards else 0)
    with pytest.raises(ValueError, match="chunk contract"):
        model.prefill(sides["cuda"], {"tokens": torch.zeros((1, 300), dtype=torch.int64,
                                                            device=cuda)}, cfg, pol, 304)


def test_two_processes_on_the_card_equal_the_stacked_job(cuda, tmp_path):
    """Two ranks share the card under gloo (NCCL refuses two ranks on one
    card), one worker each, the kernels built once before the spawn: the
    serial and depth-2 drivers equal the stacked two-worker job on the card
    in every metric but the walls, in the gathered state and in each rank's
    decisions."""
    build.library()
    ranks = dist_cases.spawn(tmp_path, 2, {"sections": ("gpu job",), "device": "cuda"})
    batches = list(drifting_zipf(dist_cases.NUM_BATCHES, 16_384, **dist_cases.STREAM))
    skip = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
    for driver in ("serial", "depth 2"):
        stacked = StreamingJob(device="cuda", num_workers=2, **dist_cases.JOB,
                               dr=DRConfig(**dist_cases.CFG, **dist_cases.DRIVERS[driver]))
        dist_cases.feed(stacked, driver, batches)
        rec = ranks[0][f"gpu/{driver}"]
        assert [_fields(m, skip) for m in stacked.metrics] == [
            {k: v for k, v in m.items() if k not in skip} for m in rec["metrics"]]
        assert any(m.repartitioned for m in stacked.metrics)
        np.testing.assert_array_equal(rec["keys"], stacked.state_keys.cpu().numpy())
        np.testing.assert_array_equal(rec["vals"], stacked.state_vals.cpu().numpy())
        assert ranks[1][f"gpu/{driver}"]["decisions"] == rec["decisions"]


def test_pipeline_on_the_card_equals_the_plain_model(cuda, tmp_path):
    """Two gloo stages share the card: stablelm-1.6b's smoke config at 4
    layers, float32 under remat, TF32 off; the pipelined loss and every
    gradient against the plain model on the card, the flash kernels
    launched by every stage (2 forwards under remat and 1 backward a layer
    a tick)."""
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import trainable
    from repro_torch.launch.pipeline import stack_stage_params, stage_params

    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    ranks = train_dist_cases.wait(train_dist_cases.start(
        tmp_path, 2, {"case": "pipeline card", "device": "cuda"}), tmp_path, 2)
    cfg = train_dist_cases.pp_config()
    pol = Policy(remat=True)
    params = trainable(model.init_params(cfg, 0, pol, device=cuda))
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in train_dist_cases.pp_batch(cfg.vocab_size).items()}
    loss, _ = model.loss_fn(params, batch, cfg, pol)
    grads = dict(zip(map(id, leaves(params)), torch.autograd.grad(loss, leaves(params))))
    ticks = train_dist_cases.PP_MICRO + 1
    for r in ranks:
        assert abs(float(r["loss"]) - float(loss)) <= 2e-4 * abs(float(loss))
        mine = leaves(stage_params(stack_stage_params(cfg, params, 2), r["rank"]))
        for got, p in zip(r["grads"], mine):
            want = grads[id(p)].cpu()
            assert float((got - want).norm() / want.norm()) <= 1e-3
        assert r["launches"] == (2 * ticks * cfg.num_layers // 2, ticks * cfg.num_layers // 2)


def test_compressed_sync_on_the_card_equals_the_host(cuda, tmp_path):
    """Two gloo ranks on the card: each rank's mean and error equal bit for
    bit what the same int8 quantization and float32 sum give on the host
    (a sum of two is one add, in either order)."""
    from repro_torch.train.compression import _quantize

    build.library()
    ranks = train_dist_cases.wait(train_dist_cases.start(
        tmp_path, 2, {"case": "compression card", "device": "cuda"}), tmp_path, 2)
    inputs = [train_dist_cases.compression_inputs(r) for r in range(2)]
    for k in inputs[0][0]:
        deq, err = [], []
        for g, e in inputs:
            g32 = torch.from_numpy(g[k]) + torch.from_numpy(e[k])
            q, s = _quantize(g32)
            deq.append(q.to(torch.float32) * s)
            err.append(g32 - deq[-1])
        mean = (deq[0] + deq[1]) / 2
        for r in ranks:
            assert torch.equal(r["mean"][k], mean), k
            assert torch.equal(r["error"][k], err[r["rank"]]), k
