"""The cases ``tests/test_torch_policy_mesh.py`` runs in each of its spawned
ranks, and the inputs both packages share.

The test spawns four ranks once (:func:`spawn`); each joins a gloo group
through a ``file://`` store, lays both meshes over it (``(1, 4)`` and
``(2, 2)`` over ``("data", "model")``), runs :func:`run`'s cases under
``Policy.mesh`` and saves what it saw to ``rank<r>.pt`` beside the store.
The reference's subprocess builds its inputs from the same functions.  At
module level this file imports numpy only, so a spawned rank never loads
jax and the reference's subprocess never loads torch.
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path

import numpy as np

W = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
D, F, E = 16, 32, 8
MARGIN = 1e-4    # smallest gap between the top k + 1 router logits
PERM = [5, 1, 7, 3, 0, 6, 2, 4]  # logical expert -> slot
# name -> (batch, sequence, seed): 32 tokens a rank for moe_apply at both
# meshes, 48 tokens (6 a row, no multiple of 4) and 4 for the replicated path
INPUTS = {"prefill": (2, 64, 1), "ragged_seq": (8, 6, 2), "decode": (4, 1, 3)}


def _moe_cases() -> dict:
    """name -> (mesh, path, backend, k, capacity factor, placement, shared
    expert, input).  Every backend x k x capacity of ``moe_apply`` and every
    k x capacity of the replicated path at each mesh; the placement and
    the shared expert alternate, so each value meets each other one."""
    out = {}
    for mesh in MESHES:
        combos = [("apply", be, k, cf, "prefill") for be in ("dense", "ragged")
                  for k in (1, 2) for cf in (1.25, 8.0)]
        combos += [("replicated", None, k, cf, x) for k in (1, 2) for cf in (1.25, 8.0)
                   for x in ("ragged_seq", "decode") if (k == 1) == (x == "decode")]
        for n, (path, be, k, cf, x) in enumerate(combos):
            place = ("identity", "permuted")[n % 2]
            shared = (n // 2) % 2 == 0
            out[f"{mesh}/{path}/{be}/k{k}/cf{cf}/{place}/{'shared' if shared else 'plain'}"] = (
                mesh, path, be, k, cf, place, shared, x)
    return out


MOE_CASES = _moe_cases()
# the reference's data-axis contract: batches the (2, 2) mesh's data axes
# do not divide, at a sequence its model axis does
CONTRACT_BATCHES = (1, 3)
CONTRACT_SEQ = 4

# the Scout smoke model under make_policy: prompts [B, S] (8 splits over
# both model axes, 6 only over (2, 2)'s), then teacher-forced decode steps
SCOUT = "llama4-scout-17b-a16e"
PROMPTS = {"s8": (2, 8), "s6": (2, 6)}
STEPS = 3
MAX_LEN = 24
# ServeEngine at (1, 4): prompts of 8 and 16 tokens take moe_apply, 13 and
# 6 the replicated path
ENGINE_PROMPTS = (8, 13, 16, 6)
ENGINE_NEW = 4
ENGINE_SLOTS = 2
ENGINE_MAX_LEN = 32
SPAWN_TIMEOUT_S = 300


def _hot():
    return np.random.default_rng(99).normal(0, 1, D).astype(np.float32) / np.sqrt(D)


def moe_arrays() -> dict:
    """The layer's inputs and parameters, flat: ``x/<input>`` and
    ``p/<leaf>``.  The router leans toward expert 0 along the inputs'
    common direction, so that a capacity of 1.25 drops pairs."""
    out = {}
    for name, (b, s, seed) in INPUTS.items():
        rng = np.random.default_rng(seed)
        out[f"x/{name}"] = (rng.normal(0, 1, (b, s, D)) + 1.5 * _hot()).astype(np.float32)
    rng = np.random.default_rng(0)
    out["p/router"] = rng.normal(0, D**-0.5, (D, E)).astype(np.float32)
    out["p/router"][:, 0] += 0.6 * _hot()
    out["p/wi"] = rng.normal(0, D**-0.5, (E, D, 2, F)).astype(np.float32)
    out["p/wo"] = rng.normal(0, F**-0.5, (E, F, D)).astype(np.float32)
    out["p/shared/wi"] = rng.normal(0, D**-0.5, (D, 2, F)).astype(np.float32)
    out["p/shared/wo"] = rng.normal(0, F**-0.5, (F, D)).astype(np.float32)
    return out


def contract_x(b: int) -> np.ndarray:
    return np.random.default_rng(b).normal(0, 1, (b, CONTRACT_SEQ, D)).astype(np.float32)


def moe_params(arrays: dict, wrap, shared: bool) -> dict:
    p = {k: wrap(arrays[f"p/{k}"]) for k in ("router", "wi", "wo")}
    if shared:
        p["shared"] = {k: wrap(arrays[f"p/shared/{k}"]) for k in ("wi", "wo")}
    return p


def inv_place(place: str) -> np.ndarray:
    return np.arange(E, dtype=np.int32) if place == "identity" else np.asarray(PERM, np.int32)


def prompt_tokens(name: str):
    """``(prompt int32[B, S], steps int32[STEPS, B, 1])`` of a prompt."""
    b, s = PROMPTS[name]
    rng = np.random.default_rng(s)
    return (rng.integers(0, 512, (b, s)).astype(np.int32),
            rng.integers(0, 512, (STEPS, b, 1)).astype(np.int32))


def engine_prompts() -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, n).astype(np.int32) for n in ENGINE_PROMPTS]


def flat(tree, prefix="") -> dict:
    """A tree of dicts and lists as ``{"a/0/b": leaf}``; numpy leaves for
    arrays, torch tensors kept."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, node in items for k, v in flat(node, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree if hasattr(tree, "numpy") else np.asarray(tree)}


def unflat(arrays: dict) -> dict:
    out: dict = {}
    for key, v in arrays.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# in each rank
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy().copy()


def _moe_case(pm, arrays, case, out, traffic) -> None:
    import torch

    from repro_torch.carry import rank_params
    from repro_torch.configs.base import MoESpec
    from repro_torch.models.modules import Policy
    from repro_torch.moe import layer

    _, path, be, k, cf, place, shared, xname = MOE_CASES[case]
    spec = MoESpec(num_experts=E, top_k=k, d_ff_expert=F, shared_expert=shared,
                   capacity_factor=cf)
    whole = moe_params(arrays, torch.as_tensor, shared)
    cut = rank_params({"moe": whole}, pm)["moe"]
    x = torch.as_tensor(arrays[f"x/{xname}"])
    inv = torch.as_tensor(inv_place(place))
    fn = layer.moe_apply if path == "apply" else layer.moe_apply_replicated
    ships = {"": None} if be != "ragged" else {"": "", "/masked": "1"}
    for tag, flag in ships.items():
        if flag is not None:
            os.environ["REPRO_DISABLE_NATIVE_RAGGED"] = flag
        try:
            before = dict(pm.group.traffic)
            pol = Policy(mesh=pm, tp=pm.shape["model"], exchange_backend=be)
            got = fn(cut, x, spec, "swiglu", pol, inv)
            traffic[case + tag] = {key: v - before[key] for key, v in pm.group.traffic.items()}
        finally:
            os.environ.pop("REPRO_DISABLE_NATIVE_RAGGED", None)
        st = got.exchange_stats(padded_rows=123, backend=be)
        rec = {"y": _np(got.y), "counts": _np(got.counts), "overflow": float(got.overflow),
               "aux": float(got.aux_loss),
               "stats": [st.rows, st.padded_rows,
                         -1 if st.occupied_rows is None else st.occupied_rows]}
        if got.shipped_rows is not None:
            rec["shipped"], rec["occupied"] = int(got.shipped_rows), int(got.occupied_rows)
        out[case + tag] = rec
    if case.endswith("/plain") and pm.shape["model"] > 1:
        # a tree of every expert is not a rank's cut
        try:
            fn(whole, x, spec, "swiglu", Policy(mesh=pm, tp=pm.shape["model"]), inv)
        except ValueError as e:
            out[case + "/whole"] = str(e)


def _margins():
    """Wrap the router so that every call records its smallest gap between
    the top k + 1 logits; returns the list and an undo."""
    import torch

    from repro_torch.moe import layer

    seen, route = [], layer._route

    def recording(router_w, t, spec):
        logits = (t.to(torch.float32) @ router_w.to(torch.float32)).double()
        top = torch.topk(logits, spec.top_k + 1, dim=-1).values
        seen.append(float((top[:, :-1] - top[:, 1:]).min()))
        return route(router_w, t, spec)

    layer._route = recording
    return seen, lambda: setattr(layer, "_route", route)


def _paths():
    """Record the MoE path each backbone call takes."""
    from repro_torch.models import transformer

    calls, saved = [], {}
    for name in ("moe_apply", "moe_apply_replicated", "moe_ref"):
        fn = saved[name] = getattr(transformer, name)
        setattr(transformer, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                      _fn(*a, **k))[1])
    return calls, lambda: [setattr(transformer, n, f) for n, f in saved.items()]


def _cache_rec(cache) -> dict:
    layer0 = cache["layers"][0]
    return {"k": _np(layer0["k"]), "v": _np(layer0["v"]), "slot_pos": _np(layer0["pos"]),
            "pos": _np(cache["pos"])}


def _model_cases(pm, mesh_name, params_path, out) -> None:
    import torch

    from repro_torch.carry import params_from_jax, rank_params
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.sharding import ShardingOptions, make_policy
    from repro_torch.models import model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduce_for_smoke(get_config(SCOUT))
    opts = ShardingOptions(compute_dtype=torch.float32, param_dtype=torch.float32)
    pol = make_policy(cfg, pm, "prefill", opts)
    tree = unflat(dict(np.load(params_path)))
    params = rank_params(params_from_jax(tree, cfg, pol, device="cpu"), pm)
    out["n_experts"] = int(params["layers"][0]["moe"]["wi"].shape[0])
    seen, undo_margins = _margins()
    calls, undo_paths = _paths()
    try:
        for name in PROMPTS:
            prompt, steps = prompt_tokens(name)
            del calls[:]
            logits, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt)}, cfg, pol,
                                          MAX_LEN)
            rec = {"logits": [_np(logits)], "prefill_cache": _cache_rec(cache)}
            for tok in steps:
                logits, cache = model.decode_step(params, cache, torch.as_tensor(tok), cfg, pol)
                rec["logits"].append(_np(logits))
            rec["cache"] = _cache_rec(cache)
            rec["paths"] = list(calls)
            out[f"model/{name}"] = rec
        if mesh_name == "1x4":
            reqs = [Request(rid=i, prompt=p, max_new_tokens=ENGINE_NEW)
                    for i, p in enumerate(engine_prompts())]
            eng = ServeEngine(cfg, params, pol, slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                              device="cpu")
            del calls[:]
            eng.run(reqs, max_ticks=100)
            out["engine"] = {"tokens": [list(r.out_tokens) for r in reqs],
                             "done": [r.done for r in reqs], "steps": eng.steps,
                             "tokens_out": eng.tokens_out, "paths": sorted(set(calls))}
    finally:
        undo_margins()
        undo_paths()
    out["margin"] = min(seen)
    out["rank_init"] = _rank_init(pm, cfg, pol)
    out["fields"] = _fields(pol)
    out["fields_pure_dp"] = _fields(make_policy(cfg, pm, "prefill",
                                                ShardingOptions(pure_dp=True)))


def _rank_init(pm, cfg, pol) -> bool:
    """``init_rank_params`` under a permuted placement against the same
    slots of the whole model's ``init_params`` permuted by it: bit for
    bit, and every other leaf equal."""
    import torch

    from repro_torch.carry import init_rank_params, rank_params
    from repro_torch.models import model
    from repro_torch.moe.kip_placement import apply_placement_to_weights

    place = np.asarray([2, 0, 3, 1])
    mine = init_rank_params(cfg, 7, pol, place=place, device="cpu")
    whole = model.init_params(cfg, 7, pol, device="cpu")
    whole["layers"] = [dict(lay, moe=apply_placement_to_weights(lay["moe"], place))
                       for lay in whole["layers"]]
    want = flat(rank_params(whole, pm))
    got = flat(mine)
    return sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in got)


def _fields(pol) -> dict:
    from repro_torch.models.modules import no_shard

    return {"param_dtype": str(pol.param_dtype).split(".")[-1],
            "compute_dtype": str(pol.compute_dtype).split(".")[-1], "tp": pol.tp,
            "dp_axes": list(pol.dp_axes), "tp_axis": pol.tp_axis, "remat": pol.remat,
            "attn_q_chunk": pol.attn_q_chunk, "attn_kv_chunk": pol.attn_kv_chunk,
            "attn_p_bf16": pol.attn_p_bf16, "recurrent_bf16": pol.recurrent_bf16,
            "remat_policy": pol.remat_policy, "moe_capacity_factor": pol.moe_capacity_factor,
            "slstm_unroll": pol.slstm_unroll, "mesh": dict(pol.mesh.shape),
            "identity_shard": pol.shard is no_shard}


def _contract(pm, arrays, out) -> None:
    import torch

    from repro_torch.configs.base import MoESpec
    from repro_torch.models.modules import Policy
    from repro_torch.moe import layer

    spec = MoESpec(num_experts=E, top_k=1, d_ff_expert=F, shared_expert=True)
    p = moe_params(arrays, torch.as_tensor, True)
    pol = Policy(mesh=pm, tp=pm.shape["model"])
    for b in CONTRACT_BATCHES:
        try:
            layer.moe_apply(p, torch.as_tensor(contract_x(b)), spec, "swiglu", pol)
            out[f"contract/{b}"] = None
        except ValueError as e:
            out[f"contract/{b}"] = str(e)


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
    arrays = moe_arrays()
    out: dict = {"rank": rank}
    for name, dims in MESHES.items():
        pm = ProcessMesh(MeshShape(dims, ("data", "model")), g)
        rec: dict = {"coords": dict(pm.coords),
                     "subgroups": {"data": list(pm.subgroup("data").ranks),
                                   "model": list(pm.subgroup("model").ranks),
                                   "all": list(pm.subgroup(("model", "data")).ranks)},
                     "index": [pm.index("data"), pm.index("model"),
                               pm.index(("data", "model"))]}
        traffic: dict = {}
        for case, c in MOE_CASES.items():
            if c[0] == name:
                _moe_case(pm, arrays, case, rec, traffic)
        rec["traffic"] = traffic
        _model_cases(pm, name, plan["params"][name], rec)
        if name == "2x2":
            _contract(pm, arrays, rec)
        out[name] = rec
    g.close()
    torch.save(out, Path(store).parent / f"rank{rank}.pt")


def spawn(d: Path, plan: dict) -> list:
    """The ``W`` ranks of :func:`run` through ``dist_cases.spawn``: their
    saved results, in rank order."""
    import dist_cases

    return dist_cases.spawn(d, W, plan, SPAWN_TIMEOUT_S, target=run)


@contextlib.contextmanager
def one_rank_mesh(d: Path):
    """A ``(1, 1)`` ``("data", "model")`` ProcessMesh over a one-rank gloo
    group joined in this process through a ``file://`` store in ``d``; the
    group is closed on the way out."""
    from repro_torch.exchange.dist import WorkerGroup
    from repro_torch.launch.mesh import MeshShape, ProcessMesh

    g = WorkerGroup.init(backend="gloo", rank=0, world_size=1,
                         init_method=f"file://{d / 'one_rank_store'}", device="cpu")
    try:
        yield ProcessMesh(MeshShape((1, 1), ("data", "model")), g)
    finally:
        g.close()
