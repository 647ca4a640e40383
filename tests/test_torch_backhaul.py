"""The exchange plane's request-response verbs in the port against the
reference, on the CPU: ``Exchange.backhaul`` on every backend (and through
``FaultyBackend``), ``take_from`` and ``ExchangeResult.stats``; and the
stacked two-hop permutation of the hierarchical transport.

The reference's counterparts are ``tests/test_backends.py``'s backhaul
tests: the round trip (ship, answer each received row, ship the answers
back over the same lanes, gather each record's answer), the ragged return
trip without the forward counts, and the expert-dispatch round trip of the
MoE layer (ship to a worker, bucket into local experts, answer, gather,
ship back, gather), here through the plane alone: the MoE layer waits for
its slice.  The reference runs in a subprocess on four host devices of an
``Auto``-axis mesh, its ragged transport on the masked fallback
(``REPRO_DISABLE_NATIVE_RAGGED=1``: XLA:CPU has no ragged all-to-all).
Every output is compared exactly: rows, answers, shipped and occupied
rows.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.exchange import ExchangeSpec as JSpec
from repro.exchange import LocalBackend as JLocal
from repro.exchange import Payload as JPayload
from repro.exchange import make_exchange as j_make_exchange
from repro.exchange import take_from as j_take_from
from repro_torch.exchange import (
    ExchangeSpec,
    ExchangeTopology,
    FaultPlan,
    FaultyBackend,
    HierarchicalBackend,
    LocalBackend,
    Payload,
    make_exchange,
    take_from,
)
from repro_torch.exchange.backends import _transposed, _two_hop_a2a

REPO = Path(__file__).resolve().parents[1]
W = 4


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# the round trips at W=4 against the reference
# ---------------------------------------------------------------------------

REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.exchange import (ExchangeSpec, ExchangeTopology, FaultPlan, FaultyBackend,
                                Payload, make_exchange, take_from)
    cases, capacity = json.loads(sys.argv[2])
    inputs = np.load(sys.argv[3])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    out = {}

    def backend_of(name, faulty):
        return FaultyBackend(name, FaultPlan()) if faulty else name

    def run(body, args, n_out):
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * len(args),
                              out_specs=(P("data"),) * n_out, check_vma=False))
        return [np.asarray(x) for x in f(*(jnp.asarray(a) for a in args))]

    for name, (kind, backend, topo, faulty, skew) in cases.items():
        spec = ExchangeSpec(4, capacity, axis="data",
                            topology=None if topo is None else ExchangeTopology(*topo))
        ex = make_exchange(spec, backend_of(backend, faulty))
        lane, valid, vals, eloc = (inputs[f"{skew}/{k}"] for k in ("lane", "valid", "vals", "eloc"))
        if kind == "roundtrip":
            def body(lane, valid, vals):
                res = ex(lane, valid, [Payload(vals, -1.0)])
                resp = jnp.where(res.valid, res.payloads[0] * 2.0 + 1.0, 0.0)
                ret, back_shipped, back_occupied = ex.backhaul(resp, forward=res)
                by = res.shipped_rows_by_class
                by = jnp.full(3, -9, jnp.int32) if by is None else by
                lc = res.lane_counts if res.lane_counts is not None else jnp.full(4, -9, jnp.int32)
                return (take_from(ret, res.send)[None], ret[None], res.shipped_rows[None],
                        back_shipped[None], back_occupied[None], by[None], lc[None],
                        res.send.lane_overflow[None], res.valid[None])
            got = run(body, (lane, valid, vals), 9)
            keys = ("out", "ret", "shipped", "back_shipped", "back_occupied", "by_class",
                    "lane_counts", "lane_overflow", "valid")
        elif kind == "no_forward":
            def body(lane, valid, vals):
                res = ex(lane, valid, [Payload(vals, 0.0)])
                ret, shipped, occupied = ex.backhaul(res.payloads[0])
                return take_from(ret, res.send)[None], shipped[None], occupied[None]
            got = run(body, (lane, valid, vals), 3)
            keys = ("out", "back_shipped", "back_occupied")
        else:  # the expert-dispatch round trip: 2 local experts a worker
            def body(lane, valid, vals, eloc):
                x = jnp.stack([vals, vals * 4.0 - 1.0], axis=-1)
                res1 = ex(lane, valid, [Payload(x, 0), Payload(eloc, 0)])
                rvalid, (rx, re) = res1.unpack()
                local = make_exchange(ExchangeSpec(2, 2 * capacity))
                res2 = local.bucketize(re, rvalid, [Payload(rx, 0)])
                eout = res2.payloads[0] * jnp.asarray([2.0, -0.5])[:, None, None] + 1.0
                back = take_from(eout, res2.send).reshape(4, capacity, 2)
                ret, back_shipped, back_occupied = ex.backhaul(back, forward=res1)
                val = take_from(ret, res1.send)
                return (val[None], (res1.shipped_rows + back_shipped)[None],
                        back_occupied[None], (res1.send.overflow + res2.send.overflow)[None])
            got = run(body, (lane, valid, vals, eloc), 4)
            keys = ("out", "shipped", "back_occupied", "overflow")
        for k, v in zip(keys, got):
            out[f"{name}/{k}"] = v
    np.savez(sys.argv[1], **out)
""")

CAPACITY = 32
BACKENDS = {
    "dense": ("dense", None),
    "ragged": ("ragged", None),
    "ragged/2x2": ("ragged", (4, 2)),
    "hierarchical/2x2": ("hierarchical", (4, 2)),
    "hierarchical/flat": ("hierarchical", None),
    "dense/2x2": ("dense", (4, 2)),
}
# name -> (kind, backend, topology, behind a never-firing FaultyBackend, skew)
CASES = {f"roundtrip/{b}/{skew}{'/faulty' if faulty else ''}": ("roundtrip", be, topo, faulty, skew)
         for b, (be, topo) in BACKENDS.items() for skew in ("uniform", "hot")
         for faulty in (False, True)}
CASES |= {f"no_forward/{b}": ("no_forward", be, topo, False, "uniform")
          for b, (be, topo) in BACKENDS.items()}
CASES |= {f"experts/{b}/{skew}": ("experts", be, topo, False, skew)
          for b, (be, topo) in BACKENDS.items() for skew in ("uniform", "hot")}


def _inputs():
    """Per skew, W=4 workers of 48 records: uniform lanes, or every record
    on lane 0 (which overflows at capacity 32)."""
    rng = np.random.default_rng(9)
    arrays = {}
    for skew in ("uniform", "hot"):
        n = W * 48
        arrays[f"{skew}/lane"] = (np.zeros(n, np.int32) if skew == "hot"
                                  else rng.integers(0, W, n).astype(np.int32))
        arrays[f"{skew}/valid"] = rng.random(n) < 0.85
        arrays[f"{skew}/vals"] = rng.normal(size=n).astype(np.float32)
        arrays[f"{skew}/eloc"] = rng.integers(0, 2, n).astype(np.int32)
    return arrays


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    d = tmp_path_factory.mktemp("backhaul_w4")
    arrays = _inputs()
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_W4, str(d / "out.npz"), json.dumps([CASES, CAPACITY]),
         str(d / "in.npz")], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return arrays, np.load(d / "out.npz")


def _exchange(backend, topo, faulty=False):
    spec = ExchangeSpec(W, CAPACITY, axis="data",
                        topology=None if topo is None else ExchangeTopology(*topo))
    return make_exchange(spec, FaultyBackend(backend, FaultPlan()) if faulty else backend)


def _stacked(arrays, skew):
    return tuple(_t(arrays[f"{skew}/{k}"]).view(W, -1)
                 for k in ("lane", "valid", "vals", "eloc"))


def _roundtrip(ex, lane, valid, vals):
    res = ex(lane, valid, [Payload(vals, -1.0)])
    resp = torch.where(res.valid, res.payloads[0] * 2.0 + 1.0, 0.0)
    ret, back_shipped, back_occupied = ex.backhaul(resp, forward=res)
    return res, ret, take_from(ret, res.send), back_shipped, back_occupied


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("roundtrip/")])
def test_backhaul_round_trip_matches_reference(reference_w4, name):
    """The returned buffers, each record's answer, the forward and return
    traffic and the return occupancy equal the reference's, per worker, for
    every backend (behind a never-firing ``FaultyBackend`` too).  Answers
    are ``2x + 1`` for records that took a slot and 0 for the rest; the
    occupancy is the backend-independent count of live rows."""
    arrays, ref = reference_w4
    _, backend, topo, faulty, skew = CASES[name]
    ex = _exchange(backend, topo, faulty)
    lane, valid, vals, _ = _stacked(arrays, skew)
    res, ret, out, back_shipped, back_occupied = _roundtrip(ex, lane, valid, vals)
    np.testing.assert_array_equal(out.numpy(), ref[f"{name}/out"])
    np.testing.assert_array_equal(ret.numpy(), ref[f"{name}/ret"])
    np.testing.assert_array_equal(res.shipped_rows.numpy(), ref[f"{name}/shipped"])
    np.testing.assert_array_equal(back_shipped.numpy(), ref[f"{name}/back_shipped"])
    np.testing.assert_array_equal(back_occupied.numpy(), ref[f"{name}/back_occupied"])
    by = (np.full((W, 3), -9) if res.shipped_rows_by_class is None
          else res.shipped_rows_by_class.numpy())
    np.testing.assert_array_equal(by, ref[f"{name}/by_class"])
    assert torch.equal(out, torch.where(res.send.ok, vals * 2.0 + 1.0, 0.0))
    # the return occupancy: the rows each worker received, whatever the backend
    assert torch.equal(back_occupied, res.valid.sum(dim=(1, 2)))
    if skew == "hot":
        assert int(res.send.overflow.sum()) > 0
    if backend == "ragged":
        # counted rows both ways, and the count phase once (4 lanes of a
        # 4-byte count against 4-byte rows: 4 rows)
        assert torch.equal(res.shipped_rows, res.lane_counts.sum(dim=1) + W)
        assert torch.equal(back_shipped, res.recv_counts.sum(dim=1).to(torch.int64))


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("no_forward/")])
def test_backhaul_without_forward_counts_matches_reference(reference_w4, name):
    """Without the forward result a backhaul ships the pad back, whatever
    the backend; every record gets its own value back."""
    arrays, ref = reference_w4
    _, backend, topo, _, skew = CASES[name]
    ex = _exchange(backend, topo)
    lane, valid, vals, _ = _stacked(arrays, skew)
    res = ex(lane, valid, [Payload(vals, 0.0)])
    ret, shipped, occupied = ex.backhaul(res.payloads[0])
    out = take_from(ret, res.send)
    np.testing.assert_array_equal(out.numpy(), ref[f"{name}/out"])
    np.testing.assert_array_equal(shipped.numpy(), ref[f"{name}/back_shipped"])
    np.testing.assert_array_equal(occupied.numpy(), ref[f"{name}/back_occupied"])
    assert torch.equal(out, torch.where(res.send.ok, vals, 0.0))
    assert (shipped == W * CAPACITY).all()


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("experts/")])
def test_expert_dispatch_round_trip_matches_reference(reference_w4, name):
    """The MoE layer's exchange pattern through the plane alone: ship each
    record (two payloads) to its worker, bucket it into one of two local
    experts, answer, gather, ship the answers back and gather them per
    record.  Answers, traffic and overflow equal the reference's, and the
    answers of every backend equal the dense backend's.  The answers scale
    by powers of two before one addition, so a fused multiply-add rounds
    them as the separate operations do."""
    arrays, ref = reference_w4
    _, backend, topo, _, skew = CASES[name]

    def run(backend, topo):
        ex = _exchange(backend, topo)
        lane, valid, vals, eloc = _stacked(arrays, skew)
        x = torch.stack([vals, vals * 4.0 - 1.0], dim=-1)
        res1 = ex(lane, valid, [Payload(x, 0), Payload(eloc, 0)])
        rvalid, (rx, re) = res1.unpack()
        local = make_exchange(ExchangeSpec(2, 2 * CAPACITY))
        res2 = local.bucketize(re, rvalid, [Payload(rx, 0)])
        eout = res2.payloads[0] * torch.tensor([2.0, -0.5])[None, :, None, None] + 1.0
        back = take_from(eout, res2.send).reshape(W, W, CAPACITY, 2)
        ret, back_shipped, back_occupied = ex.backhaul(back, forward=res1)
        return (take_from(ret, res1.send), res1.shipped_rows + back_shipped, back_occupied,
                res1.send.overflow + res2.send.overflow)

    val, shipped, occupied, overflow = run(backend, topo)
    np.testing.assert_array_equal(val.numpy(), ref[f"{name}/out"])
    np.testing.assert_array_equal(shipped.numpy(), ref[f"{name}/shipped"])
    np.testing.assert_array_equal(occupied.numpy(), ref[f"{name}/back_occupied"])
    np.testing.assert_array_equal(overflow.numpy(), ref[f"{name}/overflow"])
    assert torch.equal(val, run("dense", None)[0])


def test_ragged_round_trip_ships_fewer_rows_than_dense(reference_w4):
    """Under skew the ragged round trip ships the measured rows both ways,
    below the dense pad twice; hierarchical ships the pad plus its
    inter-host rows."""
    arrays, _ = reference_w4
    lane, valid, vals, _ = _stacked(arrays, "uniform")
    total = {}
    for name, (backend, topo) in BACKENDS.items():
        res, _, _, back, _ = _roundtrip(_exchange(backend, topo), lane, valid, vals)
        total[name] = res.shipped_rows + back
    assert (total["dense"] == 2 * W * CAPACITY).all()
    assert (total["ragged"] < total["dense"]).all()
    assert (total["hierarchical/2x2"] > total["dense"]).all()
    assert torch.equal(total["hierarchical/flat"], total["dense"])


# ---------------------------------------------------------------------------
# the stacked two-hop permutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hosts,per_host", [(2, 4), (4, 2), (2, 2), (3, 5), (2, 3)])
@pytest.mark.parametrize("tail,dtype", [((), torch.float32), ((3,), torch.int32),
                                        ((2, 5), torch.bfloat16), ((), torch.bool)])
def test_two_hop_equals_the_flat_transpose_and_is_an_involution(hosts, per_host, tail, dtype):
    w = hosts * per_host
    gen = torch.Generator().manual_seed(hosts * 10 + per_host)
    x = torch.randint(-1000, 1000, (w, w, 7) + tail, generator=gen).to(dtype)
    y = _two_hop_a2a(x, hosts, per_host)
    assert y.dtype == dtype and y.is_contiguous()
    assert torch.equal(y, _transposed(x))
    assert torch.equal(_two_hop_a2a(y, hosts, per_host), x)
    assert y.data_ptr() != x.data_ptr()


def test_hierarchical_ships_count_by_kind():
    """The backend counts each ship once: two-hop at 8 lanes on two hosts
    (the mask and the payloads of a ship together), flat at 7."""
    be = HierarchicalBackend()
    for lanes in (8, 8, 7):
        ex = make_exchange(ExchangeSpec(lanes, 4, axis="data",
                                        topology=ExchangeTopology(8, 4)), be)
        lane = torch.randint(0, lanes, (lanes, 10), generator=torch.Generator().manual_seed(0))
        res = ex(lane.int(), torch.ones((lanes, 10), dtype=torch.bool),
                 [Payload(torch.ones(lanes, 10), 0), Payload(lane, 0)])
        ex.backhaul(res.payloads[0], forward=res)
    assert (be.two_hop_ships, be.flat_ships) == (4, 2)


# ---------------------------------------------------------------------------
# take_from, the local backhaul and stats, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tail", [(), (3,)])
def test_take_from_matches_reference(seed, tail):
    """Records that took a slot read their cell; records without one (full
    lane, invalid, lane out of range) read 0, as in the reference."""
    rng = np.random.default_rng(seed)
    lanes, cap, n = 5, 6, 40
    lane = rng.integers(-1, lanes + 2, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    spec, jspec = ExchangeSpec(lanes, cap), JSpec(lanes, cap)
    jres = j_make_exchange(jspec).bucketize(jnp.asarray(lane), jnp.asarray(valid),
                                            [JPayload(jnp.zeros(n), 0)])
    res = make_exchange(spec).bucketize(_t(lane)[None], _t(valid)[None],
                                        [Payload(torch.zeros((1, n)), 0)])
    buffers = rng.normal(size=(lanes, cap) + tail).astype(np.float32)
    want = np.asarray(j_take_from(jnp.asarray(buffers), jres.send))
    got = take_from(_t(buffers)[None], res.send)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((~res.send.ok[0] & _t(valid)).sum()) > 0


def test_local_backhaul_matches_reference():
    """A local exchange's backhaul leaves the buffers where they are and
    ships nothing; the local backend refuses a worker axis."""
    buffers = np.arange(24, dtype=np.float32).reshape(4, 6)
    jrows, jshipped, jocc = JLocal().backhaul(JSpec(4, 6), jnp.asarray(buffers))
    for be in (LocalBackend(), FaultyBackend("local", FaultPlan())):
        rows, shipped, occ = make_exchange(ExchangeSpec(4, 6), be).backhaul(_t(buffers)[None])
        np.testing.assert_array_equal(rows[0].numpy(), np.asarray(jrows))
        assert shipped.tolist() == [int(jshipped)] and occ.tolist() == [int(jocc)] == [0]
    with pytest.raises(ValueError):
        LocalBackend().backhaul(ExchangeSpec(4, 6, axis="data"), _t(buffers)[None])
    with pytest.raises(AssertionError):
        JLocal().backhaul(JSpec(4, 6, axis="data"), jnp.asarray(buffers))


@pytest.mark.parametrize("axis,backend", [(None, None), ("data", "dense"), ("data", "ragged"),
                                          ("data", "hierarchical")])
def test_stats_match_reference_on_one_worker(axis, backend):
    """On one worker the port's record is the reference's, field for field:
    a local exchange (4 lanes, nothing ships) and a one-lane collective
    with a topology, with walls, a backend name and replica rows."""
    from repro.exchange import ExchangeTopology as JTopology

    rng = np.random.default_rng(3)
    lanes = 4 if axis is None else 1
    n = 30
    lane = rng.integers(0, lanes, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    vals = rng.normal(size=n).astype(np.float32)
    topo = None if axis is None else (1, 1)
    jspec = JSpec(lanes, 8, axis=axis, topology=None if topo is None else JTopology(*topo))
    spec = ExchangeSpec(lanes, 8, axis=axis,
                        topology=None if topo is None else ExchangeTopology(*topo))
    if axis is None:
        jres = j_make_exchange(jspec)(jnp.asarray(lane), jnp.asarray(valid),
                                      [JPayload(jnp.asarray(vals), -1.0)])
    else:
        jres = _w1_reference(jspec, backend, lane, valid, vals)
    res = make_exchange(spec, backend)(_t(lane)[None], _t(valid)[None],
                                       [Payload(_t(vals)[None], -1.0)])
    kw = dict(wall_s=0.5, count_wall_s=0.25, ship_wall_s=0.125, hidden_wall_s=0.0625,
              backend="dense", replica_rows=np.arange(3))
    for s in (None, spec):
        a = res.stats(s, **kw)
        b = jres.stats(None if s is None else jspec, **kw)
        for field in ("rows", "wall_s", "padded_rows", "occupied_rows", "count_wall_s",
                      "ship_wall_s", "hidden_wall_s", "backend"):
            assert getattr(a, field) == getattr(b, field), field
        for field in ("lane_overflow", "replica_rows", "rows_by_class"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=field)


def _w1_reference(jspec, backend, lane, valid, vals):
    """The reference's one-lane collective on a one-device mesh, as an
    ``ExchangeResult`` of concrete arrays holding every field its
    ``stats`` reads."""
    from repro.exchange import ExchangeResult as JResult
    from repro.exchange import SendInfo as JSendInfo

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ex = j_make_exchange(jspec, backend)
    none = jnp.full((1,), -9, jnp.int32)

    def body(lane, valid, vals):
        res = ex(lane, valid, [JPayload(vals, -1.0)])
        by = none if res.shipped_rows_by_class is None else res.shipped_rows_by_class
        lc = none if res.lane_counts is None else res.lane_counts
        return (res.valid[None], res.shipped_rows[None], lc[None], by[None],
                res.send.lane_overflow[None])

    valid_buf, shipped, lc, by, lane_ov = (np.asarray(x)[0] for x in jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("data"),) * 3, out_specs=(P("data"),) * 5,
        check_vma=False))(jnp.asarray(lane), jnp.asarray(valid), jnp.asarray(vals)))
    return JResult(valid_buf, (), JSendInfo(None, None, None, None, lane_ov),
                   shipped_rows=shipped, lane_counts=None if lc[0] < 0 else lc,
                   shipped_rows_by_class=None if by[0] < 0 else by)


@pytest.mark.parametrize("name", ["roundtrip/ragged/2x2/uniform", "roundtrip/hierarchical/2x2/hot",
                                  "roundtrip/dense/2x2/uniform", "roundtrip/dense/uniform"])
def test_stats_at_w4_divide_the_worker_sums(reference_w4, name):
    """At W=4 the stacked record sums each count over the workers and
    floor-divides by W, as the reference's psum-then-divide: here against
    the reference's per-worker counts of the same exchange."""
    arrays, ref = reference_w4
    _, backend, topo, _, skew = CASES[name]
    ex = _exchange(backend, topo)
    lane, valid, vals, _ = _stacked(arrays, skew)
    res = ex(lane, valid, [Payload(vals, -1.0)])
    st = res.stats(ex.spec, backend=backend)
    assert st.rows == int(ref[f"{name}/shipped"].sum()) // W
    assert st.padded_rows == W * CAPACITY
    counts = ref[f"{name}/lane_counts"]
    occupied = counts if counts.min() >= 0 else ref[f"{name}/valid"].sum(axis=2)
    assert st.occupied_rows == int(occupied.sum()) // W
    np.testing.assert_array_equal(st.lane_overflow, ref[f"{name}/lane_overflow"].sum(axis=0))
    by = ref[f"{name}/by_class"]
    if by.min() < 0:
        assert st.rows_by_class is None
    else:
        np.testing.assert_array_equal(st.rows_by_class, by.sum(axis=0) // W)
        assert st.rows_by_class.dtype == np.int64
    # the control phase's record is final before the ship
    started = ex.start(lane, valid, [Payload(vals, -1.0)]).buffers
    assert started.stats(ex.spec).rows == st.rows
