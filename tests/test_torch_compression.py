"""The int8 gradient sync with error feedback held against the reference on
the CPU.

``_quantize`` bit for bit (int8 values and scale) over seeded inputs,
all-zero and exactly ``+-max`` ones among them; ``init_error_feedback``;
the reference's five-step error-feedback identity, step by step against
the reference's one-device mesh.  Then four gloo processes against the
reference's four-device ``Auto``-axis mesh, fed distinct buffers a device
through ``jax.make_array_from_single_device_arrays`` under ``P()``: each
rank's int8 values and scale exact, its mean within one float32 ulp of the
leaf's largest mean (the order of a float32 sum), its error within one ulp
of its largest ``grad + error`` (XLA fuses ``g32 - q * scale`` into one
multiply-subtract; the port rounds the product first, as numpy does): 2.4e-7
at a unit normal's scale.  And three ranks, where a sum in float64 rounded once is not any
order of float32 adds: every mean must be one of those orders'.
"""
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

import train_dist_cases as tc
from repro.train import compression as jc
from repro_torch.train import compression as tcomp

REPO = Path(__file__).resolve().parents[1]


def _ulp(x) -> float:
    """One float32 ulp of the largest ``|x|``: 2.4e-7 at a unit normal's
    largest draws (about 3), the order of the reference's fused
    ``g32 - q * scale`` against the port's rounded product, and of a
    float32 sum's order over the ranks."""
    return float(np.spacing(np.float32(np.abs(np.asarray(x, np.float32)).max())))

LEAVES = ("w", "m", "z", "edge", "b16")

REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    import train_dist_cases as tc
    from repro.train.compression import _quantize, compressed_grad_sync
    devices = jax.devices()[:4]
    mesh = jax.sharding.Mesh(np.asarray(devices), ("data",))
    inputs = [tc.compression_inputs(r) for r in range(4)]
    sharding = NamedSharding(mesh, P())

    def distinct(arrays, dtype):
        bufs = [jax.device_put(jnp.asarray(a, dtype), d) for a, d in zip(arrays, devices)]
        return jax.make_array_from_single_device_arrays(arrays[0].shape, sharding, bufs)

    dt = {k: (jnp.bfloat16 if k == "b16" else jnp.float32) for k in inputs[0][0]}
    grads = {k: distinct([i[0][k] for i in inputs], dt[k]) for k in dt}
    error = {k: distinct([i[1][k] for i in inputs], jnp.float32) for k in dt}
    mean, err = compressed_grad_sync(mesh, ("data",))(grads, error)
    out = {}
    for k in dt:
        for name, tree in (("mean", mean), ("error", err)):
            shards = sorted(tree[k].addressable_shards, key=lambda s: devices.index(s.device))
            out[f"{name}/{k}"] = np.stack([np.asarray(s.data) for s in shards])
        for r, (g, e) in enumerate(inputs):
            q, s = _quantize(jnp.asarray(g[k], dt[k]).astype(jnp.float32) + jnp.asarray(e[k]))
            out[f"q/{k}/{r}"] = np.asarray(q)
            out[f"scale/{k}/{r}"] = np.asarray(s)
    np.savez(sys.argv[1], **out)
""")


@pytest.mark.parametrize("case", ["normal", "tiny", "huge", "zeros", "max", "ties", "bf16 sums"])
def test_quantize_matches_reference_bit_for_bit(case):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4096).astype(np.float32)
    if case == "tiny":
        x *= 1e-30
    elif case == "huge":
        x *= 1e30
    elif case == "zeros":
        x[:] = 0.0
    elif case == "max":
        x[5], x[9] = 3.0, -3.0
        x = np.clip(x, -3.0, 3.0)
    elif case == "ties":
        # max 127 * 0.5: scale 0.5, so x / scale lands on every half step
        x = np.arange(-254, 255, dtype=np.float32) * np.float32(0.25)
    elif case == "bf16 sums":
        x = tc._bf16_values(x) + np.float32(0.01) * rng.standard_normal(4096).astype(np.float32)
    jq, js = jc._quantize(jnp.asarray(x))
    tq, ts = tcomp._quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    if case == "max":
        assert set(np.unique(tq.numpy())[[0, -1]]) == {-127, 127}
    if case == "zeros":
        assert not tq.any()


def test_init_error_feedback():
    grads = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(5)]}
    err = tcomp.init_error_feedback(grads)
    want = jc.init_error_feedback({"a": jnp.ones((3, 4), jnp.bfloat16), "b": [jnp.ones(5)]})
    assert err["a"].dtype == torch.float32 and err["b"][0].dtype == torch.float32
    assert tuple(err["a"].shape) == want["a"].shape and not err["a"].any()
    assert tuple(err["b"][0].shape) == want["b"][0].shape and not err["b"][0].any()


def test_error_feedback_identity_as_the_reference():
    """The reference's test, in both packages: over 5 steps, the sum of the
    synced gradients plus the final error is the sum of the true ones.  The
    first step's mean and error against the reference's one-device mesh
    (later steps feed each package its own error back, so a step's ulp
    carries on)."""
    jsync = jc.compressed_grad_sync(jax.make_mesh((1,), ("data",)), ("data",))
    tsync = tcomp.compressed_grad_sync()
    rng = np.random.default_rng(0)
    g_true = [rng.standard_normal(64).astype(np.float32) for _ in range(5)]
    jerr, terr = {"w": jnp.zeros(64)}, {"w": torch.zeros(64)}
    jacc, tacc = jnp.zeros(64), torch.zeros(64)
    for i, g in enumerate(g_true):
        jout, jerr = jsync({"w": jnp.asarray(g)}, jerr)
        tout, terr = tsync({"w": torch.from_numpy(g)}, terr)
        if i == 0:
            tol = _ulp(g)
            np.testing.assert_allclose(tout["w"].numpy(), np.asarray(jout["w"]), rtol=0, atol=tol)
            np.testing.assert_allclose(terr["w"].numpy(), np.asarray(jerr["w"]), rtol=0, atol=tol)
        jacc, tacc = jacc + jout["w"], tacc + tout["w"]
    total = sum(g_true)
    np.testing.assert_allclose((tacc + terr["w"]).numpy(), total, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jacc + jerr["w"]), total, rtol=1e-5, atol=1e-5)


def test_error_is_updated_in_place_and_mismatches_raise(monkeypatch):
    monkeypatch.setattr(tcomp, "BUCKET_ELEMS", 8)   # three buckets
    sync = tcomp.compressed_grad_sync()
    grads = {"a": torch.randn(5), "b": torch.randn(20), "c": torch.randn(3)}
    err = tcomp.init_error_feedback(grads)
    keep = err["b"]
    mean, err2 = sync(grads, err)
    assert err2 is err and err2["b"] is keep and keep.any()
    for k in grads:   # one replica: the mean is the dequantized gradient
        q, s = tcomp._quantize(grads[k])
        assert torch.equal(mean[k], q.to(torch.float32) * s / 1)
        assert torch.equal(err[k], grads[k] - q.to(torch.float32) * s)
    with pytest.raises(ValueError):
        sync(grads, {"a": torch.zeros(5)})
    with pytest.raises(ValueError):
        sync({"a": torch.randn(5)}, {"a": torch.zeros(4)})


@pytest.mark.parametrize("sizes,cap,want", [
    ([3, 4, 5], 8, [[0, 1], [2]]), ([10, 1, 1], 8, [[0], [1, 2]]), ([1] * 4, 2, [[0, 1], [2, 3]]),
    ([], 8, [])])
def test_buckets(sizes, cap, want):
    assert tcomp._buckets(sizes, cap) == want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four gloo ranks and the reference's four devices, side by side; then
    three gloo ranks."""
    d = tmp_path_factory.mktemp("compression")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_W4, str(d / "ref.npz"),
                            str(REPO / "tests")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        four = tc.start(d / "w4", 4, {"case": "compression"})
        three = tc.start(d / "w3", 3, {"case": "float32 sum"})
        ranks4 = tc.wait(four, d / "w4", 4)
        ranks3 = tc.wait(three, d / "w3", 3)
        _, err = ref.communicate(timeout=tc.SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    return ranks4, ranks3, dict(np.load(d / "ref.npz"))


@pytest.mark.parametrize("leaf", LEAVES)
def test_four_ranks_quantize_exactly_as_the_reference(runs, leaf):
    ranks, _, ref = runs
    for r in ranks:
        q, s = r["quantized"][leaf]
        np.testing.assert_array_equal(q.numpy(), ref[f"q/{leaf}/{r['rank']}"])
        assert s.numpy().tobytes() == ref[f"scale/{leaf}/{r['rank']}"].tobytes()


@pytest.mark.parametrize("leaf", LEAVES)
def test_four_ranks_mean_and_error_match_reference(runs, leaf):
    ranks, _, ref = runs
    for r in ranks:
        mean, err = r["mean"][leaf], r["error"][leaf]
        assert mean.dtype == torch.float32 and err.dtype == torch.float32
        g, e = tc.compression_inputs(r["rank"])
        tol_e = _ulp(g[leaf] + e[leaf]) if g[leaf].any() else 0.0
        tol_m = _ulp(ref[f"mean/{leaf}"][0]) if g[leaf].any() else 0.0
        np.testing.assert_allclose(mean.numpy(), ref[f"mean/{leaf}"][r["rank"]], rtol=0,
                                   atol=tol_m)
        np.testing.assert_allclose(err.numpy(), ref[f"error/{leaf}"][r["rank"]], rtol=0,
                                   atol=tol_e)
        assert torch.equal(mean, ranks[0]["mean"][leaf])   # every rank the same bits
    if leaf == "z":
        assert not ranks[0]["mean"][leaf].any()


def test_four_ranks_hand_the_group_float32(runs):
    """One float32 all-reduce of every leaf: 4 bytes an element."""
    ranks, _, _ = runs
    n = sum(v.size for v in tc.compression_inputs(0)[0].values())
    assert all(r["bytes"] == 4 * n for r in ranks)


def test_three_ranks_sum_in_float32(runs):
    """Each element of the mean is ``fl32(fl32(a + b) + c) / 3`` for some
    order of the three ranks' dequantized values; the inputs hold elements
    where the float64 sum rounded once is none of those, so a sum in
    float64 fails here."""
    _, ranks, _ = runs
    deq = []
    for r in range(3):
        q, s = tcomp._quantize(torch.from_numpy(tc.sum_inputs(r)))
        deq.append((q.to(torch.float32) * s).numpy())
    a, b, c = deq
    orders = np.stack([(a + b) + c, (a + c) + b, (b + c) + a]) / np.float32(3)
    f64 = ((a.astype(np.float64) + b + c).astype(np.float32)) / np.float32(3)
    discriminating = ~(orders == f64).any(axis=0)
    assert discriminating.sum() >= 20
    for r in ranks:
        got = r["mean"].numpy()
        assert (orders == got).any(axis=0).all()
        assert torch.equal(r["mean"], ranks[0]["mean"])
