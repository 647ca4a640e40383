"""Carry a reference job's state or model across.

``job_from_reference_snapshot`` builds a port ``StreamingJob`` from the
numpy dict ``repro.core.streaming.StreamingJob.snapshot()`` returns;
``params_from_jax`` turns the reference's LM parameter tree (as numpy
arrays) into the port's per-layer parameters, and ``opt_from_jax`` its
``OptState`` (step and the two Adam moment trees) into the port's, so
both packages start a training step from the same state.

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

__all__ = ["job_from_reference_snapshot", "opt_from_jax", "params_from_jax"]


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
