"""Training under ``Policy.mesh`` on the CPU: gradients through both MoE
paths over a process mesh, the mesh-wide AdamW step and the KIP safe
point's expert moves across ranks, held against the reference's
``jax.grad`` and jitted ``make_train_step`` under ``shard_map``.

A module fixture spawns four gloo ranks once (``tests/mesh_train_cases.py``,
a ``file://`` store under the test's temporary directory) and, beside
them, two reference subprocesses (the layer's gradients, the train steps)
with four host devices on ``Auto``-axis meshes.  Each rank lays the ``(1, 4)`` and the ``(2, 2)`` ``("data",
"model")`` mesh over the group and runs:

* the MoE layer's gradients (``sum(y * C) + 0.5 * aux_loss``) on every
  case of ``tests/mesh_cases.py``: ``moe_apply`` on the dense, native
  ragged and masked ragged transports and ``moe_apply_replicated``, k 1
  and 2, capacity 1.25 and 8.0, identity and permuted placement, shared
  expert on and off.  XLA:CPU cannot differentiate the reference's ragged
  backend (its ``ragged-all-to-all`` is unimplemented there: pinned
  below), so the port's ragged gradients are held against the
  reference's dense ones, which carry the same values;
* two steps of ``make_train_step`` on the Scout smoke model under
  ``make_policy(cfg, mesh, "train", float32 options)`` with remat
  ``"nothing"`` and ``"save_moe"``, both held to the reference's step at
  its default policy (``"nothing"``: remat moves no value there, and one
  compile a mesh keeps the file inside its time);
* the safe point: the controller's decision compared across ranks, a
  fixed permutation that crosses ranks applied to the weights and both
  moments, and a controller fed rank-dependent counts (it must raise).

Tolerances: the layer's gradients within 1e-5 x max(1, |ref|) (float32,
XLA's sums against torch's); counts and drops equal.  The train step's
loss, ``grad_norm``, ``lr`` and overflow within rtol 1e-4, atol 1e-6 (as
``tests/test_torch_train.py``), the moments within 1e-6 x max(1, |ref|),
and the parameters within rtol 1e-4, atol 1e-6 where the first step's
gradient is not near zero (``|m| > 1e-3 * max |m|`` of the reference's
first moment: AdamW's first update is about ``sign(g) * lr`` and
magnifies noise in a near-zero gradient into a whole step).  Equal bit
for bit: every rank's dense leaves and ``expert_counts`` after every step;
the weights after the move against the reference's ``jnp.take`` of the
gathered weights, cut by rank, and the moments against the port's stacked
``apply_placement_in_place``.  The file takes about 60-90 s.
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

import mesh_cases as mc
import mesh_train_cases as mt
from repro.configs.base import reduce_for_smoke
from repro.configs.registry import get_config
from repro.models import model as jmodel
from repro.models.modules import Policy as JPolicy
from repro_torch.carry import opt_from_jax, params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models.modules import Policy
from repro_torch.moe.kip_placement import apply_placement_in_place

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
MOMENT_TOL = 1e-6

REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[3])
    import mesh_cases as mc
    import mesh_train_cases as mt
    from repro.configs.base import MoESpec, reduce_for_smoke
    from repro.configs.registry import get_config
    from repro.launch.sharding import ShardingOptions, make_policy
    from repro.models.modules import Policy
    from repro.moe.layer import moe_apply, moe_apply_replicated
    from repro.train.optimizer import OptConfig, init_opt
    from repro.train.train_step import make_train_step
    params_dir, part = sys.argv[2], sys.argv[4]
    arrays = mc.moe_arrays()
    meshes = {n: jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(d), ("data", "model"))
              for n, d in mc.MESHES.items()}
    out, errors = {}, {}

    def layer_loss(fn, spec, pol, inv, cot):
        def loss(p, x):
            got = fn(p, x, spec, "swiglu", pol, inv)
            return jnp.sum(got.y * cot) + mt.AUX_W * got.aux_loss, got
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))

    done = {}
    for name, (m, path, be, k, cf, place, shared, xname) in (
            mc.MOE_CASES.items() if part == "layer" else ()):
        # XLA:CPU cannot differentiate the ragged backend: its dense
        # gradient carries the same values (the ragged cases repeat the
        # dense ones' settings, so each is computed once)
        same = (m, path, k, cf, place, shared, xname)
        if same not in done:
            spec = MoESpec(num_experts=mc.E, top_k=k, d_ff_expert=mc.F, shared_expert=shared,
                           capacity_factor=cf)
            pol = Policy(mesh=meshes[m], tp=mc.MESHES[m][1],
                         exchange_backend="dense" if be == "ragged" else be)
            fn = moe_apply if path == "apply" else moe_apply_replicated
            (loss, got), (gp, gx) = layer_loss(fn, spec, pol, jnp.asarray(mc.inv_place(place)),
                                               jnp.asarray(mt.cotangent(xname)))(
                mc.moe_params(arrays, jnp.asarray, shared), jnp.asarray(arrays["x/" + xname]))
            res = {"loss": loss, "counts": got.counts, "overflow": got.overflow, "grad/x": gx}
            res.update({"grad/" + key: v for key, v in mc.flat(gp).items()})
            done[same] = {key: np.asarray(v) for key, v in res.items()}
        for key, v in done[same].items():
            out[name + "/" + key] = v

    # the pin: jax.grad through the native ragged backend on XLA:CPU
    spec = MoESpec(num_experts=mc.E, top_k=2, d_ff_expert=mc.F, shared_expert=True,
                   capacity_factor=8.0)
    for m, mesh in (meshes.items() if part == "layer" else ()):
        pol = Policy(mesh=mesh, tp=mc.MESHES[m][1], exchange_backend="ragged")
        try:
            layer_loss(moe_apply, spec, pol, jnp.arange(mc.E, dtype=jnp.int32),
                       jnp.asarray(mt.cotangent("prefill")))(
                mc.moe_params(arrays, jnp.asarray, True), jnp.asarray(arrays["x/prefill"]))
            errors[m] = None
        except Exception as e:
            errors[m] = type(e).__name__ + ": " + str(e)

    cfg = reduce_for_smoke(get_config(mc.SCOUT))
    batch = {k: jnp.asarray(v) for k, v in mt.train_batch().items()}
    ocfg = OptConfig(**mt.OPT)
    for m, mesh in (meshes.items() if part == "train" else ()):
        start = jax.tree.map(jnp.asarray, mc.unflat(dict(np.load(f"{params_dir}/{m}.npz"))))
        # remat moves no value in the reference: its default policy stands
        # for both of the port's
        opts = ShardingOptions(compute_dtype=jnp.float32, param_dtype=jnp.float32)
        step = jax.jit(make_train_step(cfg, make_policy(cfg, mesh, "train", opts), ocfg))
        params, opt = start, init_opt(start, ocfg)
        for i in range(mt.STEPS):
            params, opt, met = step(params, opt, batch)
            pre = f"{m}/train/{i}/"
            for key, v in met.items():
                out[pre + "metrics/" + key] = np.asarray(v)
            for tag, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
                for key, v in mc.flat(tree).items():
                    out[pre + tag + "/" + key] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    with open(sys.argv[1] + ".json", "w") as f:
        json.dump({"errors": errors}, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, from one spawn and two
    reference subprocesses (the layer's gradients, the train steps)
    running side by side on the same reference parameters."""
    d = tmp_path_factory.mktemp("mesh_train")
    cfg = reduce_for_smoke(get_config(mc.SCOUT))
    plan = {"params": {}}
    for name, (_, ntp) in mc.MESHES.items():
        jp = jmodel.init_params(cfg, jax.random.PRNGKey(5), JPolicy(tp=ntp))
        np.savez(d / f"{name}.npz", **mc.flat(jp))
        plan["params"][name] = str(d / f"{name}.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("REPRO_DISABLE_NATIVE_RAGGED", None)
    refs = {part: subprocess.Popen(
        [sys.executable, "-c", REFERENCE_W4, str(d / f"ref_{part}.npz"), str(d),
         str(REPO / "tests"), part],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("layer", "train")}
    try:
        ranks = mt.spawn(d, plan)
        errs = {part: ref.communicate(timeout=mt.SPAWN_TIMEOUT_S)[1]
                for part, ref in refs.items()}
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for part, ref in refs.items():
        assert ref.returncode == 0, errs[part][-4000:]
    extra = json.loads((d / "ref_layer.npz.json").read_text())
    ref = {**dict(np.load(d / "ref_layer.npz")), **dict(np.load(d / "ref_train.npz"))}
    return ranks, ref, extra


def _close(got, want, tol=GRAD_TOL, err_msg=""):
    """``|got - want| <= tol * max(1, |want|)`` elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    excess = np.abs(got - want) - tol * np.maximum(1.0, np.abs(want))
    assert excess.max(initial=-1.0) <= 0, (
        f"{err_msg}: max |diff| {np.abs(got - want).max():.3g} beyond {tol:g} x max(1, |ref|)")


def _slots(rec_coords, mesh, e):
    """The slot range a rank's cut holds under ``mesh``."""
    ntp = mc.MESHES[mesh][1]
    j = rec_coords["model"]
    return slice(j * (e // ntp), (j + 1) * (e // ntp))


def _is_slots(key: str) -> bool:
    return key.split("/")[-1] in ("wi", "wo") and "/moe/" in f"/{key}" and "shared" not in key


# ---------------------------------------------------------------------------
# the MoE layer's gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(mc.MOE_CASES))
def test_moe_layer_grads_over_the_mesh_match_reference(runs, case):
    ranks, ref, _ = runs
    mesh, path, be, k, cf, place, shared, xname = mc.MOE_CASES[case]
    want = {key[len(case) + 1:]: v for key, v in ref.items() if key.startswith(case + "/")}
    tags = [""] + (["/masked"] if be == "ragged" else [])
    for tag in tags:
        for r in ranks:
            got = r[mesh][case + tag]
            np.testing.assert_array_equal(got["counts"], want["counts"])
            assert got["overflow"] == float(want["overflow"])
            _close(got["loss"], want["loss"], err_msg="loss")
            assert sorted(got["grads"]) == sorted(k_[5:] for k_ in want if k_.startswith("grad/"))
            for leaf, g in got["grads"].items():
                w = want["grad/" + leaf]
                if leaf in ("wi", "wo"):
                    w = w[_slots(r[mesh]["coords"], mesh, mc.E)]
                _close(g, w, err_msg=f"rank {r['rank']} {leaf}")
                # the leaves every rank holds whole come out equal on every rank
                if leaf not in ("wi", "wo"):
                    np.testing.assert_array_equal(g, ranks[0][mesh][case + tag]["grads"][leaf])
        if be == "ragged":
            # the native uneven ship and the masked dense one: the same
            # gradients bit for bit
            for r in ranks:
                native, masked = r[mesh][case], r[mesh][case + "/masked"]
                for leaf, g in native["grads"].items():
                    np.testing.assert_array_equal(g, masked["grads"][leaf], err_msg=leaf)
    if cf == 1.25 and path == "apply":
        assert float(want["overflow"]) > 0, "capacity 1.25 dropped nothing"


@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_reference_cannot_differentiate_ragged_on_xla_cpu(runs, mesh):
    """The reference's jax.grad through its native ragged backend fails on
    XLA:CPU (ROADMAP.md, queue 3): the port's ragged gradients are held
    against the reference's dense ones instead."""
    _, _, extra = runs
    msg = extra["errors"][mesh]
    assert msg is not None, "the reference differentiated the ragged backend"
    assert "ragged-all-to-all" in msg and "UNIMPLEMENTED" in msg, msg


# ---------------------------------------------------------------------------
# the Scout smoke train step under make_policy
# ---------------------------------------------------------------------------


def _ref_trees(ref, pre, cfg):
    """The reference's params, m and v after a step, in the port's layout."""
    trees = {}
    for tag in ("params", "m", "v"):
        flat = {key[len(pre) + len(tag) + 1:]: v for key, v in ref.items()
                if key.startswith(pre + tag + "/")}
        trees[tag] = mc.unflat(flat)
    pol = Policy(param_dtype=torch.float32)
    params = params_from_jax(trees["params"], cfg, pol, device="cpu")
    opt = opt_from_jax((np.int32(0), trees["m"], trees["v"]), cfg, pol, device="cpu")
    return {"params": mc.flat(params), "m": mc.flat(opt.m), "v": mc.flat(opt.v)}


@pytest.mark.parametrize("remat", mt.REMATS)
@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_scout_train_step_over_the_mesh_matches_reference(runs, mesh, remat):
    ranks, ref, _ = runs
    cfg = tbase.reduce_for_smoke(treg.get_config(mc.SCOUT))
    first = _ref_trees(ref, f"{mesh}/train/0/", cfg)
    masks = {k: np.abs(v.numpy()) > 1e-3 * np.abs(v.numpy()).max() for k, v in first["m"].items()}
    for i in range(mt.STEPS):
        pre = f"{mesh}/train/{i}/"
        want = _ref_trees(ref, pre, cfg) if i else first
        for r in ranks:
            got = r[mesh][f"train/{remat}/{i}"]
            for key in ("loss", "grad_norm", "lr", "overflow"):
                np.testing.assert_allclose(float(got[key]), float(ref[pre + "metrics/" + key]),
                                           rtol=RTOL, atol=ATOL, err_msg=key)
            np.testing.assert_array_equal(got["expert_counts"], ref[pre + "metrics/expert_counts"])
            assert sorted(got["params"]) == sorted(want["params"])
            for tag in ("params", "m", "v"):
                for key, g in got[tag].items():
                    w = want[tag][key].numpy()
                    if _is_slots(key):
                        w = w[_slots(r[mesh]["coords"], mesh, mt.SCOUT_E)]
                    if tag == "params":
                        m = masks[key]
                        if _is_slots(key):
                            m = m[_slots(r[mesh]["coords"], mesh, mt.SCOUT_E)]
                        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL,
                                                   err_msg=f"step {i} {key}")
                    else:
                        _close(g, w, MOMENT_TOL, err_msg=f"step {i} {tag} {key}")
            # every rank's dense leaves, counts, loss and norm equal bit for bit
            r0 = ranks[0][mesh][f"train/{remat}/{i}"]
            assert got["dense"] == r0["dense"]
            for key in ("expert_counts", "loss", "grad_norm", "lr"):
                np.testing.assert_array_equal(got[key], r0[key])
            # "nothing" recomputes each MoE layer inside the backward
            per = cfg.num_layers
            assert got["calls"] == ["moe_apply"] * per * (2 if remat == "nothing" else 1), (
                got["calls"])


# ---------------------------------------------------------------------------
# the safe point across ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_safe_point_moves_experts_across_ranks(runs, mesh):
    """``apply_placement_in_place`` under the mesh: every rank's weights
    equal the reference's ``jnp.take`` of the gathered weights, cut by rank,
    bit for bit; the moments equal the port's stacked move, cut by rank;
    the controllers agree; the gather equals the ranks' cuts."""
    ranks, _, _ = runs
    perm = np.asarray(mt.MOVE)
    e = mt.SCOUT_E
    for r in ranks:
        sp = r[mesh]["safe_point"]
        assert sp["leaf"] is True
        assert sp["decision"] == ranks[0][mesh]["safe_point"]["decision"]
        sl = _slots(r[mesh]["coords"], mesh, e)
        for tag in ("params", "m", "v"):
            whole = sp["before"][tag]
            assert whole and all(_is_slots(k) for k in whole)
            for key, before in whole.items():
                np.testing.assert_array_equal(before, ranks[0][mesh]["safe_point"]["before"][tag][key])
                np.testing.assert_array_equal(before[sl], sp["cut_before"][tag][key])
                if tag == "params":
                    want = np.asarray(jnp.take(jnp.asarray(before), jnp.asarray(perm), axis=0))
                else:
                    t = {key.split("/")[-1]: torch.as_tensor(before).clone()}
                    other = "wo" if key.endswith("wi") else "wi"
                    t[other] = torch.zeros((e, 1))
                    apply_placement_in_place([t], perm)
                    want = t[key.split("/")[-1]].numpy()
                np.testing.assert_array_equal(sp["after"][tag][key], want[sl],
                                              err_msg=f"{tag} {key}")
            # the leaves the move does not touch stay as they were
            for key, v in sp["after"][tag].items():
                if not _is_slots(key):
                    np.testing.assert_array_equal(v, sp["cut_before"][tag][key])
        crossing = sum(perm[p] // (e // mc.MESHES[mesh][1]) != p // (e // mc.MESHES[mesh][1])
                       for p in range(e))
        assert crossing > 0


@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_placement_disagreement_raises_on_every_rank(runs, mesh):
    ranks, _, _ = runs
    for r in ranks:
        msg = r[mesh]["disagreement"]
        assert msg is not None and "placed the experts differently" in msg, msg
