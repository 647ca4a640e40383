"""The port's route kernels, held against the reference on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those plain versions (and the padding wrappers in
``repro_torch.kernels.ops``) to ``repro.kernels.ref`` and to the Pallas
kernels run in interpret mode, on the shapes ``tests/test_kernels.py``
sweeps plus an empty heavy table, split replicas with d > 1, invalid
sentinel records and capacity overflow.  Integer outputs must be equal
exactly; the f32 payloads are copied, never summed, so they are equal too.
The count-min sketch sums 1.0s in float32, exact below 2**24, so it is
equal exactly as well.

The flash-attention plain version is held to the Pallas kernel in
interpret mode on every case of ``tests/test_flash_kernel.py``, and to the
jnp flash and a naive oracle on ragged lengths the Pallas kernel rejects,
at the reference's own tolerances: 2e-5 in float32, 2e-2 in bf16 (the
sums run in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Histogram, kip_update, uniform_partitioner
from repro.data.generators import zipf_keys
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_tpu
from repro.models.attention import flash_attention as jnp_flash
from repro_torch.core.partitioner import PartitionerTables
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.dispatch_count import dispatch_count
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lookup_dispatch import lookup_dispatch
from repro_torch.kernels.partition_apply import partition_apply
from repro_torch.kernels.route_bucketize import route_bucketize
from repro_torch.kernels.sketch_update import sketch_update

SENT = 2**31 - 1


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def _port_tables(t) -> PartitionerTables:
    return PartitionerTables(*(_t(np.asarray(x), torch.int32) for x in t))


def _kip(num_parts, seed=0, splits=None):
    stream = zipf_keys(8192, num_keys=2_000, exponent=1.2, seed=seed)
    hist = Histogram.exact(stream).top(64)
    p = kip_update(uniform_partitioner(num_parts, heavy_capacity=128), hist)
    if splits:
        p = p.with_splits({int(hist.keys[i]): d for i, d in enumerate(splits)})
    return p, stream


def _batch(stream, n, seed, dim=2, sentinel_invalid=True):
    rng = np.random.default_rng(seed)
    keys = stream[:n].astype(np.int32)
    valid = rng.random(n) < 0.85
    if sentinel_invalid:
        keys = np.where(valid, keys, SENT).astype(np.int32)
    vals = rng.normal(size=(n, dim)).astype(np.float32)
    return keys, valid, vals


def _eq(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


RB_NAMES = ("part", "slot", "counts", "buf_valid", "buf_keys", "buf_vals", "buf_part")


# ---------------------------------------------------------------------------
# plain versions against repro.kernels.ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("b", [128, 512])
@pytest.mark.parametrize("num_hosts", [1024, 4096])
def test_partition_apply_matches_reference(n, b, num_hosts):
    rng = np.random.default_rng(n + b)
    keys = rng.integers(0, 2**30, n).astype(np.int32)
    heavy = np.sort(rng.choice(2**30, b // 2, replace=False)).astype(np.int32)
    hk = np.concatenate([heavy, np.full(b - len(heavy), SENT, np.int32)])
    hp = np.concatenate([rng.integers(0, 16, len(heavy)), np.zeros(b - len(heavy))]).astype(np.int32)
    table = rng.integers(0, 16, num_hosts).astype(np.int32)
    keys[: b // 4] = heavy[: b // 4]
    keys[-3:] = SENT
    for seed in (0, 7):
        want = jref.partition_apply_ref(jnp.asarray(keys), jnp.asarray(hk), jnp.asarray(hp),
                                        jnp.asarray(table), seed=seed, num_hosts=num_hosts)
        got = tref.partition_apply_ref(_t(keys), _t(hk), _t(hp), _t(table),
                                       seed=seed, num_hosts=num_hosts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("num_parts", [4, 16, 256])
def test_dispatch_count_matches_reference(n, num_parts):
    rng = np.random.default_rng(n * num_parts)
    dest = rng.integers(0, num_parts, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    want = jref.dispatch_count_ref(jnp.asarray(dest), jnp.asarray(valid), num_parts=num_parts)
    got = tref.dispatch_count_ref(_t(dest), _t(valid), num_parts=num_parts)
    _eq(got, want, ("slot", "counts"))


@pytest.mark.parametrize("repl", [(2,), (4, 3), (8, 1, 5)])
def test_split_choice_matches_reference(repl):
    p, stream = _kip(16, splits=repl)
    keys, valid, _ = _batch(stream, 3000, 1)
    t = p.tables()
    want = jref.split_choice_ref(jnp.asarray(keys), t.heavy_keys, t.heavy_repl,
                                 seed=p.seed, num_partitions=16)
    got = tref.split_choice_ref(_t(keys), *(_t(np.asarray(x)) for x in
                                            (t.heavy_keys, t.heavy_repl)),
                                seed=p.seed, num_partitions=16)
    _eq(got, want, ("hit", "offset"))


@pytest.mark.parametrize("loads", ["equal", "ties", "random", "hot replica"])
def test_split_choice_two_choice_pick_matches_reference(loads):
    """The least-load pick: the same offsets as the reference's twin for a
    load vector with equal entries (the hash pick), many ties, random loads
    and one replica at 1e9."""
    p, stream = _kip(16, splits=(8, 3, 2))
    keys, _, _ = _batch(stream, 3000, 2)
    t = p.tables()
    home = jref.partition_apply_ref(jnp.asarray(keys), t.heavy_keys, t.heavy_parts,
                                    t.host_to_part, seed=p.seed)
    rng = np.random.default_rng(5)
    vec = {"equal": np.ones(16), "ties": np.repeat(np.arange(4.0), 4),
           "random": rng.random(16), "hot replica": np.where(np.arange(16) == 3, 1e9, 1.0)}
    vec = vec[loads].astype(np.float32)
    want = jref.split_choice_ref(jnp.asarray(keys), t.heavy_keys, t.heavy_repl, seed=p.seed,
                                 num_partitions=16, home=home, part_loads=jnp.asarray(vec))
    got = tref.split_choice_ref(_t(keys), *(_t(np.asarray(x)) for x in
                                            (t.heavy_keys, t.heavy_repl)),
                                seed=p.seed, num_partitions=16, home=_t(np.asarray(home)),
                                part_loads=_t(vec))
    _eq(got, want, ("hit", "offset"))


@pytest.mark.parametrize("num_lanes,num_partitions,splits", [
    (4, 0, None), (8, 0, None), (4, 16, (4, 2)), (8, 32, (8,)), (1, 8, (3,))])
def test_lookup_dispatch_matches_reference(num_lanes, num_partitions, splits):
    p, stream = _kip(max(num_partitions, num_lanes), splits=splits)
    keys, valid, _ = _batch(stream, 2500, num_lanes)
    t = p.tables()
    want = jref.lookup_dispatch_ref(
        jnp.asarray(keys), jnp.asarray(valid), t.heavy_keys, t.heavy_parts, t.host_to_part,
        seed=p.seed, num_hosts=p.num_hosts, num_lanes=num_lanes,
        heavy_repl=t.heavy_repl if num_partitions else None, num_partitions=num_partitions)
    pt = _port_tables(t)
    got = tref.lookup_dispatch_ref(
        _t(keys), _t(valid), pt.heavy_keys, pt.heavy_parts, pt.host_to_part,
        seed=p.seed, num_hosts=p.num_hosts, num_lanes=num_lanes,
        heavy_repl=pt.heavy_repl if num_partitions else None, num_partitions=num_partitions)
    _eq(got, want, ("part", "slot", "counts"))


@pytest.mark.parametrize("n,num_lanes,capacity", [(512, 4, 32), (1024, 8, 128), (2048, 16, 200)])
@pytest.mark.parametrize("num_partitions,splits", [(0, None), (16, (4, 2))])
def test_route_bucketize_matches_reference(n, num_lanes, capacity, num_partitions, splits):
    """All seven outputs, lanes past capacity included (the sweep's shapes)."""
    p, stream = _kip(max(num_lanes, num_partitions), splits=splits)
    keys, valid, vals = _batch(stream, n, n)
    t = p.tables()
    want = jref.route_bucketize_ref(
        jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(vals), t.heavy_keys,
        t.heavy_parts, t.host_to_part, seed=p.seed, num_hosts=p.num_hosts,
        num_lanes=num_lanes, capacity=capacity, key_fill=SENT,
        heavy_repl=t.heavy_repl if num_partitions else None, num_partitions=num_partitions)
    pt = _port_tables(t)
    got = tref.route_bucketize_ref(
        _t(keys), _t(valid), _t(vals), pt.heavy_keys, pt.heavy_parts, pt.host_to_part,
        seed=p.seed, num_hosts=p.num_hosts, num_lanes=num_lanes, capacity=capacity,
        key_fill=SENT, heavy_repl=pt.heavy_repl if num_partitions else None,
        num_partitions=num_partitions)
    _eq(got, want, RB_NAMES)


def test_stacked_workers_use_worker_local_index():
    """W stacked workers in one call == the reference run per worker shard
    (the split-replica hash folds in the worker-local index)."""
    w, n, lanes, cap = 4, 700, 4, 150
    p, stream = _kip(16, splits=(4, 3))
    keys, valid, vals = _batch(np.concatenate([stream] * 2), w * n, 3)
    t = p.tables()
    pt = _port_tables(t)
    got = tref.route_bucketize_ref(
        _t(keys).reshape(w, n), _t(valid).reshape(w, n), _t(vals).reshape(w, n, 2),
        pt.heavy_keys, pt.heavy_parts, pt.host_to_part, seed=p.seed,
        num_hosts=p.num_hosts, num_lanes=lanes, capacity=cap, key_fill=SENT,
        heavy_repl=pt.heavy_repl, num_partitions=16)
    for i in range(w):
        sl = slice(i * n, (i + 1) * n)
        want = jref.route_bucketize_ref(
            jnp.asarray(keys[sl]), jnp.asarray(valid[sl]), jnp.asarray(vals[sl]),
            t.heavy_keys, t.heavy_parts, t.host_to_part, seed=p.seed,
            num_hosts=p.num_hosts, num_lanes=lanes, capacity=cap, key_fill=SENT,
            heavy_repl=t.heavy_repl, num_partitions=16)
        _eq([g[i] for g in got], want, RB_NAMES)


# ---------------------------------------------------------------------------
# the padding wrappers against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["kip", "split", "empty", "overflow"])
def test_ops_route_bucketize_matches_pallas_interpret(case):
    """``repro_torch.kernels.ops.route_bucketize`` (plain version on the CPU)
    == ``repro.kernels.ops.route_bucketize(..., interpret=True)`` on all
    seven outputs, the parts of invalid sentinel records included (they hit
    a sentinel pad row: part 0)."""
    n, lanes, cap, num_partitions = 512, 4, 128, 0
    if case == "empty":
        p = uniform_partitioner(8)
        stream = zipf_keys(4096, num_keys=2_000, exponent=1.2, seed=5)
        num_partitions = 8
    else:
        p, stream = _kip(8, splits=(4, 2) if case in ("split", "overflow") else None)
        num_partitions = 8 if case in ("split", "overflow") else 0
    if case == "overflow":
        cap = 40
    keys, valid, vals = _batch(stream, n, 11)
    t = p.tables()
    want = jops.route_bucketize(
        jnp.asarray(keys), jnp.asarray(valid), t, jnp.asarray(vals), num_hosts=p.num_hosts,
        seed=p.seed, num_lanes=lanes, capacity=cap, key_fill=SENT,
        num_partitions=num_partitions, interpret=True)
    got = tops.route_bucketize(
        _t(keys), _t(valid), _port_tables(t), _t(vals), num_hosts=p.num_hosts,
        seed=p.seed, num_lanes=lanes, capacity=cap, key_fill=SENT,
        num_partitions=num_partitions)
    _eq(got, want, RB_NAMES)
    if case == "overflow":
        assert int((got[2] - cap).clamp(min=0).sum()) > 0


@pytest.mark.parametrize("case", ["kip", "split", "empty"])
def test_ops_route_slots_matches_pallas_interpret(case):
    """``ops.route_slots`` pads the heavy table to the tile but adds no tile
    to an empty one.  The reference's Pallas kernel cannot take an empty
    heavy table (its zero-width block fails), so that case is held to the
    reference's jnp twin, which its exchange plane runs off the TPU."""
    lanes = 8
    if case == "empty":
        p = uniform_partitioner(16)
        stream = zipf_keys(4096, num_keys=2_000, exponent=1.2, seed=6)
    else:
        p, stream = _kip(16, splits=(4,) if case == "split" else None)
    num_partitions = 16 if case == "split" else 0
    keys, valid, _ = _batch(stream, 768, 12)
    t = p.tables()
    if case == "empty":
        assert t.heavy_keys.shape[0] == 0
        want = jref.lookup_dispatch_ref(
            jnp.asarray(keys), jnp.asarray(valid), t.heavy_keys, t.heavy_parts,
            t.host_to_part, seed=p.seed, num_hosts=p.num_hosts, num_lanes=lanes)
    else:
        want = jops.route_slots(jnp.asarray(keys), jnp.asarray(valid), t,
                                num_hosts=p.num_hosts, seed=p.seed, num_lanes=lanes,
                                num_partitions=num_partitions)
    got = tops.route_slots(_t(keys), _t(valid), _port_tables(t), num_hosts=p.num_hosts,
                           seed=p.seed, num_lanes=lanes, num_partitions=num_partitions)
    _eq(got, want, ("part", "slot", "counts"))


def test_kernel_wrappers_on_cpu_equal_plain_versions():
    """The wrappers' CPU path is the plain version, output for output."""
    p, stream = _kip(8, splits=(2,))
    keys, valid, vals = _batch(stream, 1000, 2)
    k, v, x = _t(keys).reshape(2, -1), _t(valid).reshape(2, -1), _t(vals).reshape(2, -1, 2)
    hk, hp, hr = tops.pad_heavy_tables(_port_tables(p.tables()), num_partitions=8,
                                       pad_empty=True)
    h2p = _t(p.host_to_part, torch.int32)
    kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=4, num_partitions=8)
    _eq(lookup_dispatch(k, v, hk, hp, h2p, hr, **kw),
        tref.lookup_dispatch_ref(k, v, hk, hp, h2p, heavy_repl=hr, **kw),
        ("part", "slot", "counts"))
    _eq(route_bucketize(k, v, x, hk, hp, h2p, hr, capacity=100, key_fill=SENT, **kw),
        tref.route_bucketize_ref(k, v, x, hk, hp, h2p, heavy_repl=hr, capacity=100,
                                 key_fill=SENT, **kw),
        RB_NAMES)


# ---------------------------------------------------------------------------
# the batch path's kernels: partition_apply, dispatch_count, sketch_update
# ---------------------------------------------------------------------------


def _dests(n, num_parts, seed):
    """Destinations with out-of-range values (negative and >= num_parts)
    and a seeded fifth of invalid records."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, num_parts, n).astype(np.int32)
    out = rng.random(n) < 0.1
    dest[out] = rng.choice([-7, -1, num_parts, num_parts + 3], int(out.sum()))
    valid = rng.random(n) >= 0.2
    return dest, valid


@pytest.mark.parametrize("n,num_parts", [(512, 1), (512, 4), (2048, 16), (1536, 1024)])
def test_dispatch_count_out_of_range_and_invalid(n, num_parts):
    """Out-of-range valid records get slot 0 and no count, invalid ones -1,
    as the jnp twin and the Pallas kernel (interpret) give them."""
    dest, valid = _dests(n, num_parts, n + num_parts)
    want = jref.dispatch_count_ref(jnp.asarray(dest), jnp.asarray(valid), num_parts=num_parts)
    got = tref.dispatch_count_ref(_t(dest), _t(valid), num_parts=num_parts)
    _eq(got, want, ("slot", "counts"))
    pallas = jops.dispatch_slots(jnp.asarray(dest), jnp.asarray(valid), num_parts=num_parts)
    _eq(tops.dispatch_slots(_t(dest), _t(valid), num_parts=num_parts), pallas,
        ("slot", "counts"))
    oor = valid & ((dest < 0) | (dest >= num_parts))
    assert oor.any() and (~valid).any()
    assert (got[0].numpy()[oor] == 0).all() and (got[0].numpy()[~valid] == -1).all()


def test_dispatch_count_stacked_workers_are_independent():
    w, n, num_parts = 3, 700, 8
    dest, valid = _dests(w * n, num_parts, 5)
    slot, counts = tref.dispatch_count_ref(_t(dest).reshape(w, n), _t(valid).reshape(w, n),
                                           num_parts=num_parts)
    for i in range(w):
        sl = slice(i * n, (i + 1) * n)
        want = jref.dispatch_count_ref(jnp.asarray(dest[sl]), jnp.asarray(valid[sl]),
                                       num_parts=num_parts)
        _eq((slot[i], counts[i]), want, ("slot", "counts"))


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("depth,width", [(1, 2048), (2, 512), (4, 1000), (8, 1024)])
def test_sketch_update_matches_reference(n, depth, width):
    """The plain version == the jnp twin == the Pallas kernel (interpret),
    a width that is not a power of two and invalid records included."""
    rng = np.random.default_rng(n + depth + width)
    keys = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    keys[: n // 2] = rng.integers(0, 300, n // 2)  # repeated keys
    valid = rng.random(n) < 0.9
    want = jref.sketch_update_ref(jnp.asarray(keys), jnp.asarray(valid), depth=depth,
                                  width=width)
    got = tref.sketch_update_ref(_t(keys), _t(valid), depth=depth, width=width)
    assert got.dtype == torch.float32 and got.shape == (depth, width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = jops.count_sketch(jnp.asarray(keys), jnp.asarray(valid), depth=depth, width=width)
    np.testing.assert_array_equal(
        tops.count_sketch(_t(keys), _t(valid), depth=depth, width=width).numpy(),
        np.asarray(pallas))


def test_sketch_update_stacked_workers_and_default_valid():
    w, n = 3, 500
    keys = zipf_keys(w * n, num_keys=400, exponent=1.1, seed=9).astype(np.int32)
    got = tops.count_sketch(_t(keys).reshape(w, n), depth=3, width=777)
    assert got.shape == (w, 3, 777)
    for i in range(w):
        want = jref.sketch_update_ref(jnp.asarray(keys[i * n:(i + 1) * n]),
                                      jnp.ones(n, bool), depth=3, width=777)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[i].sum(dim=1).numpy(), np.full(3, n, np.float32))


@pytest.mark.parametrize("case", ["kip", "sentinel_keys", "stacked", "empty"])
def test_ops_apply_partitioner_matches_pallas_interpret(case):
    """``ops.apply_partitioner`` pads the heavy table to the tile with
    sentinel keys and part 0, as the reference does.  A key equal to the
    sentinel takes a pad row's part, 0.  The reference's Pallas wrapper
    cannot take an empty heavy table (the uniform partitioner), so that case
    is held to the jnp twin."""
    if case == "empty":
        p = uniform_partitioner(35)
        stream = zipf_keys(4096, num_keys=2_000, exponent=1.2, seed=7)
    else:
        p, stream = _kip(35)
    keys = stream[:2000].astype(np.int32)
    if case == "sentinel_keys":
        keys[np.random.default_rng(1).random(len(keys)) < 0.1] = SENT
    t = p.tables()
    if case == "empty":
        assert t.heavy_keys.shape[0] == 0
        want = jref.partition_apply_ref(jnp.asarray(keys), t.heavy_keys, t.heavy_parts,
                                        t.host_to_part, seed=p.seed, num_hosts=p.num_hosts)
    else:
        want = jops.apply_partitioner(jnp.asarray(keys), t, num_hosts=p.num_hosts, seed=p.seed)
    k = _t(keys).reshape(4, 500) if case == "stacked" else _t(keys)
    got = tops.apply_partitioner(k, _port_tables(t), num_hosts=p.num_hosts, seed=p.seed)
    assert got.shape == k.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), p.lookup_np(keys))


def test_batch_kernel_wrappers_on_cpu_equal_plain_versions_and_launch_nothing():
    p, stream = _kip(8)
    keys = _t(stream[:1200].astype(np.int32)).reshape(2, -1)
    valid = keys % 7 != 0
    hk, hp, _ = tops.pad_heavy_tables(_port_tables(p.tables()), num_partitions=0,
                                      pad_empty=False)
    h2p = _t(p.host_to_part, torch.int32)
    dest = (keys % 11 - 1).to(torch.int32)
    before = (partition_apply.launches, dispatch_count.launches, sketch_update.launches)
    assert torch.equal(partition_apply(keys, hk, hp, h2p, seed=p.seed, num_hosts=p.num_hosts),
                       tref.partition_apply_ref(keys, hk, hp, h2p, seed=p.seed,
                                                num_hosts=p.num_hosts))
    _eq(dispatch_count(dest, valid, num_parts=9),
        tref.dispatch_count_ref(dest, valid, num_parts=9), ("slot", "counts"))
    assert torch.equal(sketch_update(keys, valid, depth=3, width=1000),
                       tref.sketch_update_ref(keys, valid, depth=3, width=1000))
    assert (partition_apply.launches, dispatch_count.launches,
            sketch_update.launches) == before


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _naive_attention(q, k, v, causal, window):
    """Softmax attention written out: q [G, P, Sq, hd], k/v [G, Sk, hd]."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    sq, sk, hd = q.shape[2], k.shape[1], q.shape[3]
    s = np.einsum("gpqh,gkh->gpqk", q, k) * hd**-0.5
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    s = np.where(ok, s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("gpqk,gkh->gpqh", w / w.sum(-1, keepdims=True), v)


def _qkv(g, p, sq, sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, p, sq, hd)).astype(np.float32),
            rng.standard_normal((g, sk, hd)).astype(np.float32),
            rng.standard_normal((g, sk, hd)).astype(np.float32))


@pytest.mark.parametrize("sq,sk,bq,bk", [(256, 256, 128, 128), (512, 512, 256, 256)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
@pytest.mark.parametrize("g,p,hd", [(2, 2, 64), (1, 4, 128)])
def test_flash_plain_matches_pallas_interpret(sq, sk, bq, bk, causal, window, g, p, hd):
    """Every case of ``tests/test_flash_kernel.py``, with the plain version
    chunked as the Pallas kernel tiles."""
    q, k, v = _qkv(g, p, sq, sk, hd, sq + g + hd + int(causal))
    want = flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, bq=bq, bk=bk, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          q_chunk=bq, kv_chunk=bk)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_on_the_jnp_flash_case(dtype):
    """``tests/test_flash_kernel.py::test_kernel_matches_jnp_flash``'s inputs
    in both types: the plain version equals the Pallas kernel."""
    q, k, v = _qkv(2, 2, 256, 256, 64, 0)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = flash_attention_tpu(jq, jk, jv, causal=True, bq=128, bk=128, interpret=True)
    got = flash_attention(*(_t(np.asarray(x.astype(jnp.float32))).to(td) for x in (jq, jk, jv)),
                          causal=True, q_chunk=128, kv_chunk=128)
    assert got.dtype == td
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sq", [1, 7, 100, 300])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
def test_flash_plain_ragged_lengths(sq, causal, window):
    """Lengths the Pallas kernel rejects (``Sq % bq != 0``): held to the jnp
    flash at the same chunks and to the naive oracle."""
    g, p, hd = 2, 4, 16
    q, k, v = _qkv(g, p, sq, sq, hd, sq)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          q_chunk=64, kv_chunk=64)
    jq = jnp.asarray(q.transpose(2, 0, 1, 3)[None])           # [1, Sq, G, P, hd]
    want = jnp_flash(jq, jnp.asarray(k.transpose(1, 0, 2)[None]),
                     jnp.asarray(v.transpose(1, 0, 2)[None]), causal=causal, window=window,
                     q_chunk=64, kv_chunk=64)
    want = np.asarray(want)[0].transpose(1, 2, 0, 3)           # back to [G, P, Sq, hd]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _naive_attention(q, k, v, causal, window),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_plain_bf16_weights_match_jnp_flash(window):
    """``p_bf16`` (bf16 softmax weights for the PV product) exists only in
    the plain version; it follows the jnp flash's rounding."""
    sq, g, p, hd = 40, 1, 2, 32
    q, k, v = _qkv(g, p, sq, sq, hd, 3)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window, p_bf16=True,
                          q_chunk=16, kv_chunk=16)
    want = jnp_flash(jnp.asarray(q.transpose(2, 0, 1, 3)[None]),
                     jnp.asarray(k.transpose(1, 0, 2)[None]),
                     jnp.asarray(v.transpose(1, 0, 2)[None]), causal=True, window=window,
                     q_chunk=16, kv_chunk=16, p_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0].transpose(1, 2, 0, 3),
                               rtol=2e-2, atol=2e-2)


def test_flash_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    q, k, v = _qkv(3, 2, 70, 70, 48, 9)
    before = flash_attention.launches
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=20)
    want = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True, window=20)
    assert torch.equal(got, want) and flash_attention.launches == before
