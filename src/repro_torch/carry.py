"""Carry a reference job's state or model across.

``job_from_reference_snapshot`` builds a port ``StreamingJob`` from the
numpy dict ``repro.core.streaming.StreamingJob.snapshot()`` returns;
``params_from_jax`` turns the reference's LM parameter tree (as numpy
arrays) into the port's per-layer parameters, and ``opt_from_jax`` its
``OptState`` (step and the two Adam moment trees) into the port's, so
both packages start a training step from the same state.

Under a process mesh (``Policy.mesh``) a rank holds every dense leaf whole
and only its own expert slots: :func:`rank_params` cuts a whole tree (the
port's, or the reference's through ``params_from_jax``) to them,
:func:`rank_opt` cuts an ``OptState``'s moments the same way, and
:func:`init_rank_params` draws them alone, equal bit for bit to the same
slots of the whole model's ``init_params`` from the same seed.
:func:`gather_rank_params` is the way back: every rank's slots gathered
over the model axis into the whole tree.

The snapshot's keys are the reference's own (state tables, partitioner
tables with ``heavy_repl``, split fields, sketch, tick counters, the lane
topology's ``topology_*`` keys, the lane health record and quarantine
ledger, decision log), and the port's ``snapshot()`` writes the same keys,
so a snapshot round-trips between the packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.drm import DRConfig
from repro_torch.core.streaming import StreamingJob
from repro_torch.models.modules import Policy
from repro_torch.train.optimizer import OptState

__all__ = ["gather_rank_params", "init_rank_params", "job_from_reference_snapshot",
           "opt_from_jax", "params_from_jax", "rank_opt", "rank_params", "rank_slots"]


def job_from_reference_snapshot(snap: dict, *, config: DRConfig | None = None,
                                device=None, **job_kwargs) -> StreamingJob:
    """A port job resuming ``snap`` on ``device`` (``None``: the CUDA device).

    The worker count, state capacity, payload width, partition count and
    partitioner seed come from the snapshot (its lane topology and transport
    too, through ``restore``); ``config`` is the DR
    configuration the reference job ran with, and ``job_kwargs`` the other
    ``StreamingJob`` arguments it was built with (``capacity_factor``,
    ``hist_k``, ...)."""
    state_keys = np.asarray(snap["state_keys"])
    state_vals = np.asarray(snap["state_vals"])
    job = StreamingJob(
        num_partitions=int(snap["drm_num_partitions"]),
        num_workers=state_keys.shape[0],
        device=device,
        state_capacity=state_keys.shape[1],
        payload_dim=state_vals.shape[2],
        dr=config,
        seed=int(snap["drm_seed"]),
        exchange_backend=str(snap.get("drm_exchange_backend", "dense")),
        **job_kwargs,
    )
    job.restore(snap)
    return job


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # arrays fetched from jax are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":  # numpy has no bf16: go through the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree: dict, cfg: ArchConfig, pol: Policy, *, device=None) -> dict:
    """The port's parameters from the reference's ``transformer.init_params``
    tree (numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``), cast to
    ``pol.param_dtype`` on ``device`` (``None``: the CUDA device).

    The reference stacks each pattern position's blocks ``[periods, ...]``
    under ``blocks.b{j}``; the port keeps one dict per layer, layer
    ``period * len(pattern) + j``.  ``embed.tok``, ``lm_head``,
    ``final_norm`` and ``tail{j}`` map one to one.  A MoE block's ``moe``
    dict carries over the same way: its ``router [d, E]`` stays float32
    (the reference keeps it so in every policy), its stacked experts ``wi
    [E, d, gate, f]`` and ``wo [E, f, d]`` and its ``shared`` FFN are cast
    like the rest; dense and MoE blocks may interleave (Maverick).  The
    xLSTM blocks' ``mlstm`` and ``slstm`` dicts and the Mamba blocks'
    ``mamba`` dicts carry over as any other (Mamba's ``a_log``, ``dt_bias``
    and ``d_skip`` in ``pol.param_dtype``, as the reference inits them).

    An enc-dec tree (``repro.models.encdec.init_params``: ``embed``,
    ``dec_pos``, stacked ``enc [enc_layers, ...]`` and ``dec [num_layers,
    ...]``, ``enc_ln``, ``final_norm``) becomes the port's, with ``enc``
    and ``dec`` as per-layer lists."""
    dev = resolve_device(device)
    return _layers_from_jax(tree, cfg, lambda a, name: _tensor(
        a, torch.float32 if name == "router" else pol.param_dtype, dev))


def opt_from_jax(opt_state, cfg: ArchConfig, pol: Policy, *, device=None) -> OptState:
    """The port's ``OptState`` from the reference's ``repro.train.
    optimizer.OptState`` (numpy arrays, e.g. ``jax.tree.map(np.asarray,
    opt)``): ``step`` as an int32 scalar, and ``m`` and ``v`` laid out per
    layer as :func:`params_from_jax` lays out the parameters, each moment
    in its own dtype (float32, or bf16 for ``moment_dtype=bfloat16``), on
    ``device`` (``None``: the CUDA device)."""
    dev = resolve_device(device)
    keep = lambda a, name: _tensor(a, _dtype_of(a), dev)
    step = torch.as_tensor(np.asarray(opt_state[0]).astype(np.int32), device=dev)
    return OptState(step, _layers_from_jax(opt_state[1], cfg, keep),
                    _layers_from_jax(opt_state[2], cfg, keep))


def _dtype_of(a) -> torch.dtype:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), a.dtype)).dtype


def _layers_from_jax(tree: dict, cfg: ArchConfig, convert) -> dict:
    """The reference's ``[periods, ...]``-stacked tree as the port's
    per-layer tree, each array through ``convert(array, key)``."""
    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return convert(node, name)

    def layer(node, i):
        return {k: layer(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]

    if cfg.encdec:
        enc, dec = conv(tree["enc"]), conv(tree["dec"])
        return {"embed": conv(tree["embed"]), "dec_pos": conv(tree["dec_pos"]),
                "enc": [layer(enc, i) for i in range(cfg.enc_layers)],
                "dec": [layer(dec, i) for i in range(cfg.num_layers)],
                "enc_ln": conv(tree["enc_ln"]), "final_norm": conv(tree["final_norm"])}
    out = {"embed": conv(tree["embed"]), "final_norm": conv(tree["final_norm"])}
    if not cfg.tie_embeddings:
        out["lm_head"] = conv(tree["lm_head"])
    stacked = conv(tree["blocks"])
    out["layers"] = [layer(stacked[f"b{j}"], per)
                     for per in range(cfg.num_periods) for j in range(len(cfg.pattern))]
    for j in range(len(cfg.tail)):
        out[f"tail{j}"] = conv(tree[f"tail{j}"])
    return out


def rank_slots(mesh, num_experts: int, place=None, *, tp_axis: str = "model") -> list[int]:
    """The logical experts this rank's slots hold, in slot order: slots
    ``[j * e_loc, (j + 1) * e_loc)`` on model coordinate ``j`` of ``mesh``
    (a :class:`~repro_torch.launch.mesh.ProcessMesh`), ``e_loc =
    num_experts / mesh.shape[tp_axis]``, under the placement ``place``
    (slot ``p`` holds logical expert ``place[p]``; ``None``: the
    identity)."""
    ntp = mesh.shape[tp_axis]
    if num_experts % ntp:
        raise ValueError(f"experts {num_experts} not a multiple of the {ntp} ranks of "
                         f"{tp_axis!r}")
    e_loc, j = num_experts // ntp, mesh.index(tp_axis)
    place = np.arange(num_experts) if place is None else np.asarray(place)
    return [int(x) for x in place[j * e_loc: (j + 1) * e_loc]]


def rank_params(params, mesh, *, tp_axis: str = "model"):
    """This rank's cut of a whole parameter tree under ``mesh`` (a
    :class:`~repro_torch.launch.mesh.ProcessMesh`): every MoE layer's
    ``wi`` and ``wo`` keep slots ``[j * e_loc, (j + 1) * e_loc)`` on model
    coordinate ``j`` (the ``"model"`` entry of the rules' decode specs,
    ``launch/sharding.py``), copied so that the whole tree can be freed;
    every other leaf is the same tensor.  A reference tree goes through
    :func:`params_from_jax` first."""
    def cut(node):
        if isinstance(node, list):
            return [cut(v) for v in node]
        if not isinstance(node, dict):
            return node
        if {"router", "wi", "wo"} <= set(node):
            e = node["wi"].shape[0]
            sl = rank_slots(mesh, e, tp_axis=tp_axis)
            return {k: v[sl[0]: sl[-1] + 1].clone() if k in ("wi", "wo") else cut(v)
                    for k, v in node.items()}
        return {k: cut(v) for k, v in node.items()}

    return cut(params)


def rank_opt(opt_state: OptState, mesh, *, tp_axis: str = "model") -> OptState:
    """This rank's cut of a whole ``OptState`` (the port's, or the
    reference's through :func:`opt_from_jax`): both moment trees cut as
    :func:`rank_params` cuts the parameters, the step as it is."""
    return OptState(opt_state.step, rank_params(opt_state.m, mesh, tp_axis=tp_axis),
                    rank_params(opt_state.v, mesh, tp_axis=tp_axis))


@torch.no_grad()
def gather_rank_params(tree, mesh, *, tp_axis: str = "model"):
    """The whole tree from every rank's cut (a parameter or a moment tree,
    as :func:`rank_params` cuts it): each MoE layer's ``wi`` and ``wo``
    gathered over the model axis's ranks in slot order, every other leaf
    the same tensor.  Every rank calls it together and gets the whole
    tree."""
    group = mesh.subgroup(tp_axis)

    def whole(t):
        rows, = group.gather_rows(t[None])
        return rows.reshape((-1,) + tuple(t.shape[1:]))

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        if {"router", "wi", "wo"} <= set(node):
            return {k: whole(v) if k in ("wi", "wo") else walk(v) for k, v in node.items()}
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def init_rank_params(cfg: ArchConfig, seed: int, pol: Policy, *, place=None,
                     device=None) -> dict:
    """This rank's parameters under ``pol.mesh``, drawn as
    ``model.init_params(cfg, seed, pol)`` draws the whole model, keeping
    only the experts of :func:`rank_slots` (``place``: the placement the
    slots follow, ``None`` the identity) in every MoE layer: no other
    expert is ever held beside them.  They equal, bit for bit, the same
    slots of the whole model's draw permuted by ``place``
    (``moe.kip_placement.apply_placement_to_weights``)."""
    from repro_torch.models import model

    if pol.mesh is None:
        raise ValueError("init_rank_params needs Policy.mesh: without one a rank holds "
                         "every expert (model.init_params)")
    slots = rank_slots(pol.mesh, cfg.moe.num_experts, place,
                       tp_axis=pol.tp_axis) if cfg.moe is not None else None
    return model.init_params(cfg, seed, pol, device=device, experts=slots)
