"""The cases ``tests/test_torch_mesh_train.py`` runs in each of its spawned
ranks, and the inputs both packages share.

The test spawns four ranks once (:func:`spawn`); each joins a gloo group
through a ``file://`` store, lays the ``(1, 4)`` and ``(2, 2)`` ``("data",
"model")`` meshes over it and runs, under ``Policy.mesh``:

* the MoE layer's gradients: ``moe_apply`` (dense, ragged with the native
  uneven ship and masked) and ``moe_apply_replicated`` on the cases of
  ``tests/mesh_cases.py`` (k 1 and 2, capacity 1.25 and 8.0, identity and
  permuted placement, with and without the shared expert), the loss
  ``sum(y * C) + AUX_W * aux_loss`` for a seeded cotangent ``C``;
* two steps of ``make_train_step`` on the Scout smoke model under
  ``make_policy(cfg, mesh, "train", float32 options)``, remat ``"nothing"``
  and ``"save_moe"``, from the reference's parameters cut by
  ``carry.rank_params`` and zero moments cut by ``carry.rank_opt``;
* the safe point across ranks: a ``PlacementController`` on the step's
  mesh-summed counts (its decision compared across the group), then a
  fixed permutation that crosses ranks applied to the weights and both
  moments, the whole trees gathered before and after; and a controller fed
  counts that differ by rank, which must raise on every rank.

Each rank saves what it saw to ``rank<r>.pt`` beside the store.  At module
level this file imports numpy only, so a spawned rank never loads jax and
the reference's subprocess never loads torch.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

import mesh_cases as mc

W = mc.W
MESHES = mc.MESHES
AUX_W = 0.5
REMATS = ("nothing", "save_moe")
STEPS = 2
OPT = dict(lr=1e-3, warmup=2)
TRAIN_BATCH = (2, 8)       # 8 tokens split over both meshes' model axes
SCOUT_E = 4                # the smoke config's experts
MOVE = [2, 0, 3, 1]        # new slot -> old slot: every slot crosses at (1, 4), half at (2, 2)
SPAWN_TIMEOUT_S = 300


def cotangent(xname: str) -> np.ndarray:
    b, s, _ = mc.INPUTS[xname]
    return np.random.default_rng(40 + s).normal(0, 1, (b, s, mc.D)).astype(np.float32)


def train_batch() -> dict:
    b, s = TRAIN_BATCH
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    labels = rng.integers(0, 512, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[1, :3] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask}


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# in each rank
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy().copy()


def _grad_case(pm, arrays, case, out) -> None:
    import torch

    from repro_torch.carry import rank_params
    from repro_torch.configs.base import MoESpec
    from repro_torch.models.modules import Policy
    from repro_torch.moe import layer

    _, path, be, k, cf, place, shared, xname = mc.MOE_CASES[case]
    spec = MoESpec(num_experts=mc.E, top_k=k, d_ff_expert=mc.F, shared_expert=shared,
                   capacity_factor=cf)
    fn = layer.moe_apply if path == "apply" else layer.moe_apply_replicated
    cot = torch.as_tensor(cotangent(xname))
    inv = torch.as_tensor(mc.inv_place(place))
    ships = {"": None} if be != "ragged" else {"": "", "/masked": "1"}
    for tag, flag in ships.items():
        cut = rank_params({"moe": mc.moe_params(arrays, torch.as_tensor, shared)}, pm)["moe"]
        leaves = mc.flat(cut)
        x = torch.as_tensor(arrays[f"x/{xname}"]).clone()
        for t in (*leaves.values(), x):
            t.requires_grad_(True)
        if flag is not None:
            os.environ["REPRO_DISABLE_NATIVE_RAGGED"] = flag
        try:
            pol = Policy(mesh=pm, tp=pm.shape["model"], exchange_backend=be)
            got = fn(cut, x, spec, "swiglu", pol, inv)
            loss = (got.y * cot).sum() + AUX_W * got.aux_loss
            names = sorted(leaves)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names] + [x])
        finally:
            os.environ.pop("REPRO_DISABLE_NATIVE_RAGGED", None)
        rec = {"loss": float(loss.detach()), "grads": {n: _np(gr) for n, gr in zip(names + ["x"], grads)},
               "counts": _np(got.counts), "overflow": float(got.overflow)}
        if got.shipped_rows is not None:
            rec["shipped"], rec["occupied"] = int(got.shipped_rows), int(got.occupied_rows)
        out[case + tag] = rec


def _moe_calls():
    """Count the MoE layer's calls (the remat recompute runs it again)."""
    from repro_torch.models import transformer

    calls, saved = [], {}
    for name in ("moe_apply", "moe_apply_replicated"):
        fn = saved[name] = getattr(transformer, name)
        setattr(transformer, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                      _fn(*a, **k))[1])
    return calls, lambda: [setattr(transformer, n, f) for n, f in saved.items()]


def _dense_digests(params) -> dict:
    from repro_torch.train.optimizer import expert_flags, leaves

    flat = mc.flat(params)
    flags = dict(zip(flat, expert_flags(params)))
    assert len(flat) == len(leaves(params))
    return {k: digest(v) for k, v in flat.items() if not flags[k]}


def _train_case(pm, mesh_name, remat, plan, out):
    import torch

    from repro_torch.carry import params_from_jax, rank_opt, rank_params
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.sharding import ShardingOptions, make_policy
    from repro_torch.train.optimizer import OptConfig, init_opt
    from repro_torch.train.train_step import make_train_step

    cfg = reduce_for_smoke(get_config(mc.SCOUT))
    opts = ShardingOptions(compute_dtype=torch.float32, param_dtype=torch.float32,
                           remat_policy=remat)
    pol = make_policy(cfg, pm, "train", opts)
    tree = mc.unflat(dict(np.load(plan["params"][mesh_name])))
    whole = params_from_jax(tree, cfg, pol, device="cpu")
    ocfg = OptConfig(**OPT)
    params, opt = rank_params(whole, pm), rank_opt(init_opt(whole, ocfg), pm)
    del whole
    step = make_train_step(cfg, pol, ocfg)
    batch = {k: torch.as_tensor(v) for k, v in train_batch().items()}
    calls, undo = _moe_calls()
    try:
        for i in range(STEPS):
            del calls[:]
            params, opt, m = step(params, opt, batch)
            out[f"train/{remat}/{i}"] = {
                **{k: _np(v) for k, v in m.items()},
                "params": {k: _np(v) for k, v in mc.flat(params).items()},
                "m": {k: _np(v) for k, v in mc.flat(opt.m).items()},
                "v": {k: _np(v) for k, v in mc.flat(opt.v).items()},
                "dense": _dense_digests(params), "calls": list(calls)}
    finally:
        undo()
    return params, opt, m["expert_counts"]


def _safe_point(pm, params, opt, counts, out) -> None:
    from repro_torch.carry import gather_rank_params
    from repro_torch.moe.kip_placement import PlacementController, apply_placement_in_place
    from repro_torch.train.train_step import moe_state

    ntp = pm.shape["model"]
    ctl = PlacementController(SCOUT_E, ntp)
    ctl.observe(counts.numpy())
    changed, _, perm = ctl.maybe_update()
    ctl.check_agreement(pm.group)
    trees = {"params": params, "m": opt.m, "v": opt.v}
    before = {k: mc.flat(gather_rank_params(t, pm)) for k, t in trees.items()}
    cut_before = {k: {n: _np(v) for n, v in mc.flat(t).items()} for k, t in trees.items()}
    apply_placement_in_place(moe_state(params, opt), MOVE, pm)
    out["safe_point"] = {
        "decision": {"changed": bool(changed), "perm": np.asarray(perm).tolist()},
        "before": {k: {n: _np(v) for n, v in t.items() if n.endswith(("moe/wi", "moe/wo"))}
                   for k, t in before.items()},
        "cut_before": cut_before,
        "after": {k: {n: _np(v) for n, v in mc.flat(t).items()} for k, t in trees.items()},
        "leaf": bool(params["layers"][0]["moe"]["wi"].requires_grad)}
    # a controller whose counts differ by rank decides otherwise: every rank raises
    odd = PlacementController(SCOUT_E, ntp)
    skew = np.ones(SCOUT_E)
    skew[pm.group.rank % SCOUT_E] = 100.0
    odd.observe(skew)
    odd.maybe_update()
    try:
        odd.check_agreement(pm.group)
        out["disagreement"] = None
    except RuntimeError as e:
        out["disagreement"] = str(e)


def run(rank: int, world: int, store: str, plan: dict) -> None:
    """One rank: join the gloo group through ``store``, lay each mesh over
    it, run its cases and save the results beside the store.  Any failure
    raises, and the spawning parent re-raises it."""
    import torch

    from repro_torch.exchange.dist import WorkerGroup
    from repro_torch.launch.mesh import MeshShape, ProcessMesh

    torch.set_num_threads(1)
    g = WorkerGroup.init(backend="gloo", rank=rank, world_size=world,
                         init_method=f"file://{store}", device="cpu")
    arrays = mc.moe_arrays()
    out: dict = {"rank": rank}
    for name, dims in MESHES.items():
        pm = ProcessMesh(MeshShape(dims, ("data", "model")), g)
        rec: dict = {"coords": dict(pm.coords)}
        for case, c in mc.MOE_CASES.items():
            if c[0] == name:
                _grad_case(pm, arrays, case, rec)
        for remat in REMATS:
            params, opt, counts = _train_case(pm, name, remat, plan, rec)
        _safe_point(pm, params, opt, counts, rec)
        out[name] = rec
    g.close()
    torch.save(out, Path(store).parent / f"rank{rank}.pt")


def spawn(d: Path, plan: dict) -> list:
    """The ``W`` ranks of :func:`run` through ``dist_cases.spawn``: their
    saved results, in rank order."""
    import dist_cases

    return dist_cases.spawn(d, W, plan, SPAWN_TIMEOUT_S, target=run)
