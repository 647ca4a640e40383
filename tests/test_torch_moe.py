"""The port's MoE layer (``repro_torch.moe.layer``) against the reference
on the CPU, from numpy inputs made from seeds.

``moe_ref`` runs in this process.  ``moe_apply`` over the dense and the
ragged transport and ``moe_apply_replicated`` run at 4 stacked EP shards
(``Policy(ep_shards=4)``) against the reference on a ``(1, 4)``
``("data", "model")`` mesh of ``Auto`` axes in one W=4 subprocess
(``REPRO_DISABLE_NATIVE_RAGGED=1``: XLA:CPU has no ragged all-to-all), at
capacity 1.25 (with drops) and 8.0 (none), top-1 and top-2, under the
identity placement and a permuted one.

Equal exactly: the router's ids, ``counts``, ``overflow``,
``shipped_rows``, ``occupied_rows`` and ``exchange_stats()``.  ``y`` and
``aux_loss`` within 1e-5 (float32; XLA's dots against torch's).  Every
input's router logits keep their top ``k + 1`` apart by more than
``MARGIN``, asserted on the inputs, so that a near-tie, which the two
packages could break apart, fails loudly instead of passing by luck.
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

from repro.configs.base import MoESpec as JSpec
from repro.models.modules import Policy as JPolicy
from repro.moe import layer as jlayer
from repro_torch.configs.base import MoESpec
from repro_torch.models.modules import Policy
from repro_torch.moe import layer
from repro_torch.moe.kip_placement import apply_placement_to_weights

REPO = Path(__file__).resolve().parents[1]
N = 4            # EP shards
D, F, E = 16, 32, 8
MARGIN = 1e-4    # smallest gap between the top k + 1 router logits
TOL = 1e-5       # y and aux_loss, float32
PERM = np.asarray([5, 1, 7, 3, 0, 6, 2, 4], np.int32)  # logical expert -> slot


def _spec(cls, k, cf):
    return cls(num_experts=E, top_k=k, d_ff_expert=F, shared_expert=True, capacity_factor=cf)


def _params(seed):
    """Layer parameters from a numpy seed; the router leans toward expert
    0 along ``HOT`` so that a capacity of 1.25 drops pairs."""
    rng = np.random.default_rng(seed)
    p = {
        "router": rng.normal(0, D**-0.5, (D, E)).astype(np.float32),
        "wi": rng.normal(0, D**-0.5, (E, D, 2, F)).astype(np.float32),
        "wo": rng.normal(0, F**-0.5, (E, F, D)).astype(np.float32),
        "shared": {"wi": rng.normal(0, D**-0.5, (D, 2, F)).astype(np.float32),
                   "wo": rng.normal(0, F**-0.5, (F, D)).astype(np.float32)},
    }
    p["router"][:, 0] += 0.6 * _hot()
    return p


def _hot():
    return np.random.default_rng(99).normal(0, 1, D).astype(np.float32) / np.sqrt(D)


def _x(b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, D)) + 1.5 * _hot()).astype(np.float32)


# name -> (batch, sequence, seed): 64 tokens a shard for moe_apply, 48
# tokens (6 a row, no multiple of 4) for the replicated path
INPUTS = {"prefill": (2, 128, 1), "ragged_seq": (8, 6, 2), "decode": (4, 1, 3)}
CASES = {
    f"{path}/{be}/k{k}/cf{cf}/{place}": (path, be, k, cf, place, x)
    for path, be, x in (("apply", "dense", "prefill"), ("apply", "ragged", "prefill"),
                        ("replicated", None, "ragged_seq"), ("replicated", None, "decode"))
    for k in (1, 2) for cf in (1.25, 8.0) for place in ("identity", "permuted")
}


def _inv(place):
    return np.arange(E, dtype=np.int32) if place == "identity" else PERM


def _arrays():
    out = {f"x/{name}": _x(*shape) for name, shape in INPUTS.items()}
    for k, v in _params(0).items():
        if isinstance(v, dict):
            out.update({f"p/{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[f"p/{k}"] = v
    return out


def _nested(arrays, wrap):
    p = {}
    for key, v in arrays.items():
        if not key.startswith("p/"):
            continue
        parts = key.split("/")[1:]
        node = p
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = wrap(v)
    return p


def _assert_margin(router, x, k):
    logits = np.sort(x.reshape(-1, D).astype(np.float64) @ router.astype(np.float64),
                     axis=-1)[:, ::-1]
    gaps = logits[:, :k] - logits[:, 1:k + 1]
    assert gaps.min() > MARGIN, f"a near-tie in the router logits: {gaps.min():.3g}"


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import MoESpec
    from repro.models.modules import Policy
    from repro.moe.layer import _route, moe_apply, moe_apply_replicated
    cases, E, F = json.loads(sys.argv[2])
    arrays = dict(np.load(sys.argv[3]))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    p = {"router": arrays["p/router"], "wi": arrays["p/wi"], "wo": arrays["p/wo"],
         "shared": {"wi": arrays["p/shared/wi"], "wo": arrays["p/shared/wo"]}}
    p = jax.tree.map(jnp.asarray, p)
    perm = np.asarray([5, 1, 7, 3, 0, 6, 2, 4], np.int32)
    out = {}
    for name, (path, be, k, cf, place, xname) in cases.items():
        spec = MoESpec(num_experts=E, top_k=k, d_ff_expert=F, shared_expert=True,
                       capacity_factor=cf)
        pol = Policy(mesh=mesh, tp=4, exchange_backend=be)
        inv = jnp.asarray(np.arange(E, dtype=np.int32) if place == "identity" else perm)
        x = jnp.asarray(arrays[f"x/{xname}"])
        fn = moe_apply if path == "apply" else moe_apply_replicated
        got = jax.jit(lambda pp, xx: fn(pp, xx, spec, "swiglu", pol, inv))(p, x)
        ids = jax.jit(lambda r, t: _route(r, t, spec)[1])(p["router"], x.reshape(-1, x.shape[-1]))
        res = {"y": got.y, "counts": got.counts, "overflow": got.overflow,
               "aux": got.aux_loss, "ids": ids}
        if got.shipped_rows is not None:
            res["shipped"] = got.shipped_rows
            res["occupied"] = got.occupied_rows
        st = got.exchange_stats(padded_rows=123, backend=be)
        res["stats"] = np.asarray([st.rows, st.padded_rows,
                                   -1 if st.occupied_rows is None else st.occupied_rows])
        for key, v in res.items():
            out[f"{name}/{key}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_w4")
    np.savez(tmp / "in.npz", **_arrays())
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_W4, str(tmp / "ref.npz"),
         json.dumps([CASES, E, F]), str(tmp / "in.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_shards_match_reference(reference_w4, case):
    path, be, k, cf, place, xname = CASES[case]
    arrays = _arrays()
    x = arrays[f"x/{xname}"]
    _assert_margin(arrays["p/router"], x, k)
    p = _nested(arrays, torch.as_tensor)
    spec = _spec(MoESpec, k, cf)
    pol = Policy(tp=4, ep_shards=N, exchange_backend=be)
    fn = layer.moe_apply if path == "apply" else layer.moe_apply_replicated
    got = fn(p, torch.as_tensor(x), spec, "swiglu", pol, torch.as_tensor(_inv(place)))
    ref = {key.split("/")[-1]: v for key, v in reference_w4.items()
           if key.rsplit("/", 1)[0] == case}
    ids = layer._route(p["router"], torch.as_tensor(x).reshape(-1, D), spec)[1]
    np.testing.assert_array_equal(ids.numpy(), ref["ids"])
    np.testing.assert_array_equal(got.counts.numpy(), ref["counts"])
    assert float(got.overflow) == float(ref["overflow"])
    if path == "apply":
        assert int(got.shipped_rows) == int(ref["shipped"])
        assert int(got.occupied_rows) == int(ref["occupied"])
    else:
        assert got.shipped_rows is None and "shipped" not in ref
    st = got.exchange_stats(padded_rows=123, backend=be)
    occ = -1 if st.occupied_rows is None else st.occupied_rows
    assert [st.rows, st.padded_rows, occ] == ref["stats"].tolist()
    assert (st.backend, st.wall_s) == (be, 0.0)
    np.testing.assert_allclose(got.y.numpy(), ref["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(ref["aux"]), rtol=TOL, atol=TOL)


def test_cases_cover_drops_and_none(reference_w4):
    """Capacity 1.25 drops pairs on both paths; 8.0 drops none, and there
    the port's dispatch equals its own oracle, also with the weights laid
    out by the permuted placement (slot ``PERM[e]`` holds expert ``e``)."""
    for case, (path, be, k, cf, place, xname) in CASES.items():
        over = float(reference_w4[f"{case}/overflow"])
        if cf == 8.0:
            assert over == 0.0, case
        elif xname != "decode":
            assert over > 0.0, case
    arrays = _arrays()
    p = _nested(arrays, torch.as_tensor)
    x = torch.as_tensor(arrays["x/prefill"])
    placed = apply_placement_to_weights(p, np.argsort(PERM))
    for k in (1, 2):
        spec = _spec(MoESpec, k, 8.0)
        want = layer.moe_ref(p, x, spec, "swiglu", Policy())
        for be in ("dense", "ragged"):
            got = layer.moe_apply(placed, x, spec, "swiglu",
                                  Policy(ep_shards=N, exchange_backend=be), torch.as_tensor(PERM))
            np.testing.assert_allclose(got.y.numpy(), want.y.numpy(), rtol=TOL, atol=TOL)
            assert torch.equal(got.counts, want.counts)


def test_dense_and_ragged_give_equal_outputs():
    """The transports differ only in their traffic: ``y``, the counts and
    the drops equal bit for bit, ragged ships fewer rows, and both report
    the same occupancy."""
    arrays = _arrays()
    p = _nested(arrays, torch.as_tensor)
    x = torch.as_tensor(arrays["x/prefill"])
    spec = _spec(MoESpec, 1, 1.25)
    outs = {be: layer.moe_apply(p, x, spec, "swiglu", Policy(ep_shards=N, exchange_backend=be))
            for be in ("dense", "ragged")}
    d, r = outs["dense"], outs["ragged"]
    assert torch.equal(d.y, r.y) and torch.equal(d.counts, r.counts)
    assert float(d.overflow) == float(r.overflow) > 0
    assert int(r.shipped_rows) < int(d.shipped_rows)
    assert int(r.occupied_rows) == int(d.occupied_rows)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shared", [True, False])
def test_moe_ref_matches_reference(k, shared):
    arrays = _arrays()
    x = arrays["x/prefill"][:, :24]
    _assert_margin(arrays["p/router"], x, k)
    jp = _nested(arrays, jnp.asarray)
    tp = _nested(arrays, torch.as_tensor)
    if not shared:
        jp.pop("shared")
        tp.pop("shared")
    jspec = JSpec(num_experts=E, top_k=k, d_ff_expert=F, shared_expert=shared)
    spec = MoESpec(num_experts=E, top_k=k, d_ff_expert=F, shared_expert=shared)
    want = jax.jit(lambda pp, xx: jlayer.moe_ref(pp, xx, jspec, "swiglu", JPolicy()))(
        jp, jnp.asarray(x))
    got = layer.moe_ref(tp, torch.as_tensor(x), spec, "swiglu", Policy())
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert float(got.overflow) == float(want.overflow) == 0.0
    assert got.shipped_rows is None and got.occupied_rows is None
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), rtol=TOL, atol=TOL)
    assert got.exchange_stats() == got.exchange_stats(padded_rows=0)
    assert got.exchange_stats().rows == 0


def test_route_and_init_match_the_reference_layout():
    """``_route`` equals the reference's on the same inputs (weights,
    ids, probabilities); the port's ``init_moe`` draws the reference's
    shapes and dtypes (the router float32 in a bf16 policy)."""
    arrays = _arrays()
    x = arrays["x/decode"].reshape(-1, D)
    for k in (1, 2):
        jw, jids, jprobs = jlayer._route(jnp.asarray(arrays["p/router"]), jnp.asarray(x),
                                         _spec(JSpec, k, 1.25))
        w, ids, probs = layer._route(torch.as_tensor(arrays["p/router"]), torch.as_tensor(x),
                                     _spec(MoESpec, k, 1.25))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)
    jp = jlayer.init_moe(jax.random.PRNGKey(0), D, _spec(JSpec, 1, 1.25), "swiglu",
                         jnp.bfloat16)
    tp = layer.init_moe(torch.Generator().manual_seed(0), D, _spec(MoESpec, 1, 1.25),
                        "swiglu", torch.bfloat16)
    flat = lambda t: {k: v for k, v in t.items() if not isinstance(v, dict)}
    for key, v in flat(jp).items():
        assert tuple(tp[key].shape) == v.shape, key
        assert str(tp[key].dtype).split(".")[-1] == str(v.dtype), key
    assert tp["router"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in tp["shared"].items()} == {
        k: v.shape for k, v in jp["shared"].items()}


def test_expert_parallel_paths_need_shards():
    arrays = _arrays()
    p = _nested(arrays, torch.as_tensor)
    x = torch.as_tensor(arrays["x/decode"])
    spec = _spec(MoESpec, 1, 1.25)
    with pytest.raises(ValueError, match="ep_shards"):
        layer.moe_apply(p, x, spec, "swiglu", Policy())
    with pytest.raises(ValueError, match="multiple"):
        layer.moe_apply_replicated(p, x, spec, "swiglu", Policy(ep_shards=3))
    with pytest.raises(ValueError, match="does not split"):
        layer.moe_apply(p, torch.as_tensor(arrays["x/ragged_seq"]), spec, "swiglu",
                        Policy(ep_shards=N))
