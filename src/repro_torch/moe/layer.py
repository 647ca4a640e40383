"""Expert-parallel MoE layer with DR-style dispatch, over EP shards stacked
on one device or over a process mesh's model axis (a port of
``repro.moe.layer``).

The token -> expert exchange *is* the paper's keyed shuffle: keys are
expert ids, partitions are EP shards, and the routing table is the KIP
placement (``inv_place``: logical expert -> physical slot).  The reference
runs the layer under ``shard_map`` over ``(data, model)``.  The port runs
it two ways.  Stacked (``Policy.ep_shards = N``): the ``N`` model shards
live on the leading axis of ``[N, ...]`` tensors on one device, as
``StreamingJob`` stacks its workers, with one data shard.  Over a mesh
(``Policy.mesh``, a :class:`~repro_torch.launch.mesh.ProcessMesh`): each
rank runs the reference's ``shard_map`` body on its own block, its
tensors ``[1, ...]``, and the records cross processes over the mesh's
model-axis subgroup.  Either way the exchange is the port's plane
(``repro_torch.exchange``): hop 1 ships over the policy's transport
(dense or ragged), hop 2 buckets into local experts with the
``dispatch_count`` kernel on the card, and the combine rides the same
lanes back (``backhaul`` + ``take_from``).

Three evaluation paths, as in the reference:

* ``moe_ref`` — the dense oracle (every expert on every token, exact
  combine): the plain version of the whole layer.
* ``moe_apply`` — the distributed dispatch: shard ``m`` holds the
  sequence slice ``[m * S / N, (m + 1) * S / N)`` of every batch row (of
  its data coordinate's batch block, over a mesh) and the experts of
  physical slots ``[m * E / N, (m + 1) * E / N)``.
* ``moe_apply_replicated`` — decode: the tokens go to every shard, each
  computes its own experts (over a mesh, its data coordinate's ``F /
  dpn`` slice of them), and the shards' partial outputs are summed.

Stacked, the router runs once over all tokens in ``[B, S]`` order on every
path, so the three paths route a token alike on one device.  Within one
record's shard the ``psum`` of the reference is a sum over the stacked
axis; the shared expert, F-sliced over the model axis in the reference's
decode path, is one FFN here (the sum of its slices).

Over a mesh, every rank holds ``x`` whole and gets ``y`` whole back:
``moe_apply`` gathers the ranks' blocks over the whole mesh, and
``moe_apply_replicated`` sums their partial outputs in one float32
all-reduce (cast back to the compute dtype).  A rank's ``wi`` and ``wo``
hold its own slots (``carry.rank_params``).  The statistics are the reference's: ``counts``, ``overflow``
and ``aux_loss`` summed (``aux_loss`` averaged) over all ranks in
float32, ``shipped_rows`` and ``occupied_rows`` in int64.  ``moe_apply``
needs the data axes to divide ``B`` and the model axis to divide ``S``
(``ValueError``): the reference's ``shard_map`` raises there too, so its
``ServeEngine``, which prefills ``[1, S]``, cannot serve a MoE model on a
mesh whose data axes hold more than one device (ROADMAP.md, queue 3).

Both mesh paths train.  Every rank differentiates the same replicated
loss, and each input takes the sum the reference's ``shard_map`` in_specs
give its cotangent (:meth:`~repro_torch.exchange.dist.WorkerGroup.
sum_grads`, inside the backward, each gradient in its own dtype): the
router and the shared expert (``P()``; F-sliced over the model axis on
the replicated path) over every rank, ``wi`` and ``wo`` over the data
axes (``P(tp)``; the replicated path's F-slices), and ``x`` over every
rank (``moe_apply``: each rank's block lands in its own block of the
whole ``x``; the replicated path: a sum of partials).  The hops, the
gather of ``y`` and the sum of the partial outputs carry gradients
through the group's collectives (their backward is their transpose:
the reverse all-to-all, this rank's own block, the identity).
``moe_apply``'s ``aux_loss`` is the mean of the ranks' (each rank's term
gets ``1 / W`` of its gradient); the replicated path's is each rank's
own, the same on every rank, and counts once in the summed gradients.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import MoESpec
from repro_torch.exchange import ExchangeSpec, ExchangeStats, Payload, make_exchange, take_from
from repro_torch.models.modules import Policy, act_fn, apply_ffn, init_ffn, normal

__all__ = ["MoEOut", "init_moe", "moe_apply", "moe_apply_replicated", "moe_ref"]


class MoEOut(NamedTuple):
    y: torch.Tensor          # [B, S, d]
    counts: torch.Tensor     # f32[E] global tokens routed per logical expert
    overflow: torch.Tensor   # f32[] dropped (token, expert) pairs
    aux_loss: torch.Tensor   # f32[] load-balancing auxiliary loss
    # rows the exchange transport measured moving across both dispatch
    # directions (forward ship + combine backhaul), summed over shards;
    # None on paths with no cross-shard exchange (oracle, replicated decode)
    shipped_rows: torch.Tensor = None   # int64[]
    # rows live in the exchanged lanes, both directions (the
    # backend-independent occupancy)
    occupied_rows: torch.Tensor = None  # int64[]

    def exchange_stats(self, *, padded_rows: int = 0, wall_s: float = 0.0,
                       backend: str | None = None) -> ExchangeStats:
        """This step's dispatch traffic as one :class:`ExchangeStats`, the
        record ``Telemetry.record_exchange`` takes; ``padded_rows`` is what
        the dispatch specs provisioned (both directions).  Paths with no
        cross-shard exchange report zero rows."""
        rows = 0 if self.shipped_rows is None else int(self.shipped_rows)
        occ = None if self.occupied_rows is None else int(self.occupied_rows)
        return ExchangeStats(rows=rows, wall_s=wall_s, padded_rows=padded_rows,
                             occupied_rows=occ, backend=backend)


def init_moe(gen: torch.Generator, d: int, spec: MoESpec, ffn_kind: str, dtype,
             experts=None) -> dict:
    """Router (float32), stacked expert FFNs ``wi [E, d, gate, f]``, ``wo
    [E, f, d]`` and the shared expert, drawn from ``gen`` in that order,
    one expert at a time (every ``wi``, then every ``wo``).

    ``experts`` (logical expert ids in slot order; ``None``: all, in
    order) keeps only those experts' draws, stacked in that order: the
    others are drawn and dropped, so the kept slots equal the same experts
    of the whole draw bit for bit while no more than one other expert is
    ever held (a rank's cut, ``carry.init_rank_params``)."""
    e, f = spec.num_experts, spec.d_ff_expert
    gate = 2 if ffn_kind in ("swiglu", "geglu") else 1
    keep = list(range(e)) if experts is None else [int(x) for x in experts]
    if sorted(set(keep)) != sorted(keep) or not all(0 <= x < e for x in keep):
        raise ValueError(f"experts {keep} are not distinct ids below {e}")
    slot = {x: i for i, x in enumerate(keep)}

    def stacked(shape, scale):
        if gen.device.type == "meta":  # shapes only (model.abstract_params)
            return torch.empty((len(keep),) + shape, dtype=dtype, device="meta")
        out = torch.empty((len(keep),) + shape, dtype=dtype, device=gen.device)
        for x in range(e):
            w = normal(gen, shape, scale, dtype)
            if x in slot:
                out[slot[x]] = w
        return out

    p = {
        "router": normal(gen, (d, e), d**-0.5, torch.float32),
        "wi": stacked((d, gate, f), d**-0.5),
        "wo": stacked((f, d), f**-0.5),
    }
    if spec.shared_expert:
        p["shared"] = init_ffn(gen, d, f, ffn_kind, dtype)
    return p


def _route(router_w: torch.Tensor, t: torch.Tensor, spec: MoESpec):
    """``[T, d] -> (weights f32[T, k], logical ids int32[T, k], probs
    f32[T, E])``; top-1 gates by the sigmoid (llama4), top-k > 1 by a
    softmax over the chosen logits."""
    logits = t.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.topk(logits, spec.top_k, dim=-1)
    w = torch.sigmoid(vals) if spec.top_k == 1 else torch.softmax(vals, dim=-1)
    return w, ids.to(torch.int32), probs


def _aux_loss(probs: torch.Tensor, ids: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balance loss ``E * sum_e f_e * P_e`` over the
    token axis (the last but one; leading axes are kept)."""
    f = torch.nn.functional.one_hot(ids[..., 0].long(), e).to(torch.float32).mean(dim=-2)
    pm = probs.mean(dim=-2)
    return e * (f * pm).sum(dim=-1)


def _expert_ffn(wi: torch.Tensor, wo: torch.Tensor, x: torch.Tensor, ffn_kind: str):
    """``x [E, C, d]`` (or ``[1, C, d]``, the same rows for every expert)
    through each expert's gated FFN (``wi [E, d, g, f]``, ``wo [E, f,
    d]``)."""
    e, d, g, f = wi.shape
    h = torch.matmul(x, wi.reshape(e, d, g * f)).unflatten(-1, (g, f))
    a = act_fn(ffn_kind)
    h = a(h[..., 0, :]) * h[..., 1, :] if g == 2 else a(h[..., 0, :])
    return torch.matmul(h, wo)


def _capacity(cf: float, rows: int, lanes: int) -> int:
    """The reference's lane capacity: ``cf * rows / lanes`` rounded up to
    a multiple of 8, at least 8."""
    return max(8, int(np.ceil(cf * rows / lanes / 8.0) * 8))


def _shards(pol: Policy, spec: MoESpec) -> tuple[int, int]:
    n = pol.ep_shards
    if n < 1:
        raise ValueError("the expert-parallel paths need Policy.ep_shards >= 1")
    if spec.num_experts % n:
        raise ValueError(f"experts {spec.num_experts} not a multiple of the "
                         f"{n} EP shards")
    return n, spec.num_experts // n


def _identity_place(spec: MoESpec, device) -> torch.Tensor:
    return torch.arange(spec.num_experts, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# reference (dense) path
# ---------------------------------------------------------------------------


def moe_ref(p: dict, x: torch.Tensor, spec: MoESpec, ffn_kind: str, pol: Policy,
            inv_place: torch.Tensor | None = None) -> MoEOut:
    """Every expert over every token, then each token's top-k combined
    (the placement does not change the function)."""
    b, s, d = x.shape
    cd = pol.compute_dtype
    t = x.reshape(-1, d)
    w, ids, probs = _route(p["router"], t, spec)
    all_out = _expert_ffn(p["wi"].to(cd), p["wo"].to(cd), t.to(cd)[None], ffn_kind)
    tok = torch.arange(t.shape[0], device=x.device)[:, None]
    sel = all_out[ids.long(), tok]  # [T, k, d]
    y = (sel * w[..., None].to(cd)).sum(dim=1)
    if "shared" in p:
        y = y + apply_ffn(p["shared"], x, ffn_kind, pol).reshape(-1, d)
    counts = torch.bincount(ids.reshape(-1).long(), minlength=spec.num_experts)
    return MoEOut(y.reshape(b, s, d), counts.to(torch.float32),
                  torch.zeros((), dtype=torch.float32, device=x.device),
                  _aux_loss(probs, ids, spec.num_experts))


# ---------------------------------------------------------------------------
# expert-parallel dispatch (the paper's shuffle, keys = experts)
# ---------------------------------------------------------------------------


def moe_apply(p: dict, x: torch.Tensor, spec: MoESpec, ffn_kind: str, pol: Policy,
              inv_place: torch.Tensor | None = None) -> MoEOut:
    """``x [B, S, d]`` with ``S`` a multiple of ``N = pol.ep_shards``: each
    shard routes its sequence slice, ships every record to the shard that
    owns its expert (hop 1), buckets the received records into its local
    experts (hop 2), and the results ride the same lanes back.  Under
    ``pol.mesh`` each rank does so for its own block
    (:func:`_moe_apply_mesh`)."""
    if pol.mesh is not None:
        return _moe_apply_mesh(p, x, spec, ffn_kind, pol, inv_place)
    n, e_loc = _shards(pol, spec)
    b, s, d = x.shape
    if s % n:
        raise ValueError(f"moe_apply: sequence {s} does not split over {n} EP shards")
    e, k = spec.num_experts, spec.top_k
    cf = pol.moe_capacity_factor or spec.capacity_factor
    cd = pol.compute_dtype
    if inv_place is None:
        inv_place = _identity_place(spec, x.device)
    s_l = s // n
    tn = b * s_l

    def shard_major(a: torch.Tensor) -> torch.Tensor:
        """``[B * S, ...]`` in token order -> ``[N, B * S / N, ...]``: shard
        m holds rows ``(b, m * s_l + j)`` in ``(b, j)`` order."""
        rest = tuple(a.shape[1:])
        return a.reshape((b, n, s_l) + rest).transpose(0, 1).reshape((n, tn) + rest)

    w, ids, probs = _route(p["router"], x.reshape(-1, d), spec)
    w, ids, probs = shard_major(w), shard_major(ids), shard_major(probs)
    xs = shard_major(x.reshape(-1, d).to(cd))
    rec_e = ids.reshape(n, tn * k)
    rec_w = w.reshape(n, tn * k)
    phys = inv_place.to(device=x.device, dtype=torch.int32)[rec_e.long()]
    dev = phys // e_loc
    eloc = phys % e_loc
    rec_x = xs.repeat_interleave(k, dim=1)

    # hop 1: ship records to the owning EP shard over the policy's
    # transport; the combine backhauls over the same backend
    c1 = _capacity(cf, tn * k, n)
    ship = make_exchange(ExchangeSpec(num_lanes=n, capacity=c1, axis="model"),
                         pol.exchange_backend)
    res1 = ship(dev, torch.ones_like(dev, dtype=torch.bool),
                [Payload(rec_x, 0), Payload(eloc, 0)])
    rvalid, (rxf, ref_) = res1.unpack()

    # hop 2: bucket received records into local per-expert buffers (an
    # axis-free spec: the local backend, nothing ships)
    c2 = _capacity(cf, tn * k, e_loc)
    local = make_exchange(ExchangeSpec(num_lanes=e_loc, capacity=c2))
    res2 = local.bucketize(ref_, rvalid, [Payload(rxf, 0)])
    overflow = res1.send.overflow + res2.send.overflow

    eout = _expert_ffn(p["wi"].to(cd), p["wo"].to(cd),
                       res2.payloads[0].reshape(e, c2, d), ffn_kind)

    # return trip: each received record's result, back over the same lanes
    back = take_from(eout.reshape(n, e_loc, c2, d), res2.send).reshape(n, n, c1, d)
    ret, back_shipped, back_occupied = ship.backhaul(back, forward=res1)
    val = take_from(ret, res1.send)
    y = (val * rec_w[..., None].to(cd)).reshape(n, tn, k, d).sum(dim=2)
    y = y.reshape(n, b, s_l, d).transpose(0, 1).reshape(b, s, d)
    if "shared" in p:
        y = y + apply_ffn(p["shared"], x, ffn_kind, pol)

    counts = torch.bincount(rec_e.reshape(-1).long(), minlength=e).to(torch.float32)
    aux = _aux_loss(probs, ids, e).mean()
    shipped = (res1.shipped_rows + back_shipped).sum()
    fwd_occupied = tn * k - res1.send.overflow.to(torch.int64)
    occupied = (fwd_occupied + back_occupied).sum()
    return MoEOut(y, counts, overflow.sum().to(torch.float32), aux, shipped, occupied)


def moe_apply_replicated(p: dict, x: torch.Tensor, spec: MoESpec, ffn_kind: str,
                         pol: Policy, inv_place: torch.Tensor | None = None) -> MoEOut:
    """Decode-path EP (no weight movement): every shard sees every token,
    buckets the (token, expert) pairs of its own experts locally, runs
    them, and the shards' partial outputs are summed (the reference's
    ``psum``).  With one data shard each expert's F-slice is all of F.
    Under ``pol.mesh`` each rank computes its own partial output
    (:func:`_moe_replicated_mesh`)."""
    if pol.mesh is not None:
        return _moe_replicated_mesh(p, x, spec, ffn_kind, pol, inv_place)
    n, e_loc = _shards(pol, spec)
    b, s, d = x.shape
    e, k = spec.num_experts, spec.top_k
    cf = pol.moe_capacity_factor or spec.capacity_factor
    cd = pol.compute_dtype
    if inv_place is None:
        inv_place = _identity_place(spec, x.device)
    t = x.reshape(-1, d)
    tn = t.shape[0]
    w, ids, probs = _route(p["router"], t, spec)
    rec_e = ids.reshape(-1)
    phys = inv_place.to(device=x.device, dtype=torch.int32)[rec_e.long()]
    shard = torch.arange(n, dtype=torch.int32, device=x.device)[:, None]
    mine = (phys // e_loc)[None] == shard                       # [N, T*k]
    eloc = torch.where(mine, (phys % e_loc)[None], 0)

    # local exchange: only each shard's own (token, expert) pairs get slots
    c2 = _capacity(cf, tn * k, e_loc)
    local = make_exchange(ExchangeSpec(num_lanes=e_loc, capacity=c2))
    rec_x = t.to(cd).repeat_interleave(k, dim=0)
    res = local.bucketize(eloc, mine, [Payload(rec_x.expand(n, tn * k, d), 0)])
    overflow = res.send.overflow.to(torch.float32)
    eout = _expert_ffn(p["wi"].to(cd), p["wo"].to(cd),
                       res.payloads[0].reshape(e, c2, d), ffn_kind)
    val = take_from(eout.reshape(n, e_loc, c2, d), res.send)   # [N, T*k, d]
    y = (val * w.reshape(1, tn * k, 1).to(cd)).reshape(n, tn, k, d).sum(dim=2)
    y = y.sum(dim=0)
    if "shared" in p:
        y = y + apply_ffn(p["shared"], x, ffn_kind, pol).reshape(tn, d)
    counts = torch.bincount(rec_e.long(), minlength=e).to(torch.float32)
    # the reference's pmean over the shards times the model-axis size
    return MoEOut(y.reshape(b, s, d), counts, overflow.mean() * n,
                  _aux_loss(probs, ids, e))


# ---------------------------------------------------------------------------
# over a process mesh: the reference's shard_map bodies, one rank each
# ---------------------------------------------------------------------------


class _MeshAxes(NamedTuple):
    mesh: object        # the ProcessMesh
    dp: tuple           # the data axes, mesh order
    tp: str             # the model axis
    dpn: int            # ranks over the data axes
    ntp: int            # ranks over the model axis
    e_loc: int          # experts a model shard
    i: int              # this rank's index over the data axes
    j: int              # ... and over the model axis


def _mesh_axes(pol: Policy, spec: MoESpec) -> _MeshAxes:
    """The mesh's axes as the layer reads them; raises for a mesh the layer
    cannot run over."""
    pm, dp, tp = pol.mesh, tuple(pol.dp_axes), pol.tp_axis
    if tp in dp or set(pm.axis_names) != set(dp) | {tp}:
        raise ValueError(f"the MoE layers run over data axes {dp} and a model axis {tp!r} "
                         f"that together are the mesh's axes {pm.axis_names}")
    ntp = pm.shape[tp]
    if spec.num_experts % ntp:
        raise ValueError(f"experts {spec.num_experts} not a multiple of the model axis's "
                         f"{ntp} ranks")
    dpn = math.prod(pm.shape[a] for a in dp)
    return _MeshAxes(pm, dp, tp, dpn, ntp, spec.num_experts // ntp, pm.index(dp), pm.index(tp))


def _rank_slots(p: dict, ax: _MeshAxes) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``wi`` and ``wo``: its model shard's ``e_loc`` experts,
    as ``carry.rank_params`` and ``carry.init_rank_params`` cut them."""
    wi, wo = p["wi"], p["wo"]
    if wi.shape[0] != ax.e_loc or wo.shape[0] != ax.e_loc:
        raise ValueError(f"a rank holds its model shard's {ax.e_loc} experts "
                         f"(carry.rank_params), got wi {tuple(wi.shape)}")
    return wi, wo


def _summed_inputs(p: dict, x: torch.Tensor, ax: _MeshAxes) -> tuple[dict, torch.Tensor]:
    """``p`` and ``x`` as they are, their gradients summed in the backward
    as the reference's in_specs sum their cotangents: the router, the
    shared expert and ``x`` over every rank, ``wi`` and ``wo`` over the data
    axes.  Every rank makes the same calls, so their backward collectives
    run in one order."""
    g = ax.mesh.group
    shared = p.get("shared")
    names = sorted(shared) if shared is not None else []
    router, x, *sh = g.sum_grads(p["router"], x, *(shared[k] for k in names))
    wi, wo = _rank_slots(p, ax)
    if ax.dpn > 1:
        wi, wo = ax.mesh.subgroup(ax.dp).sum_grads(wi, wo)
    out = {**p, "router": router, "wi": wi, "wo": wo}
    if shared is not None:
        out["shared"] = {**shared, **dict(zip(names, sh))}
    return out, x


def _moe_apply_mesh(p: dict, x: torch.Tensor, spec: MoESpec, ffn_kind: str, pol: Policy,
                    inv_place: torch.Tensor | None) -> MoEOut:
    """``moe_apply`` on rank ``(i, j)``: batch block ``i`` over the data
    axes, sequence block ``j`` over the model axis, as ``P(dp, tp, None)``
    gives ``shard_map``'s body; hop 1 and the backhaul over the model
    subgroup, ``y`` gathered over the whole mesh."""
    ax = _mesh_axes(pol, spec)
    b, s, d = x.shape
    if b % ax.dpn:
        raise ValueError(
            f"moe_apply: the data axes {ax.dp} ({ax.dpn} ranks) do not divide the batch {b}; "
            f"the reference's shard_map splits the batch evenly over them (P(dp, tp, None)), "
            f"so a prefill of [1, S] with S a multiple of the model axis cannot run on a mesh "
            f"whose data axes hold more than one device")
    if s % ax.ntp:
        raise ValueError(f"moe_apply: the model axis's {ax.ntp} ranks do not divide the "
                         f"sequence {s} (the reference's shard_map splits it evenly)")
    e, k = spec.num_experts, spec.top_k
    cf = pol.moe_capacity_factor or spec.capacity_factor
    cd = pol.compute_dtype
    if inv_place is None:
        inv_place = _identity_place(spec, x.device)
    b_l, s_l = b // ax.dpn, s // ax.ntp
    p, x = _summed_inputs(p, x, ax)
    x_loc = x[ax.i * b_l: (ax.i + 1) * b_l, ax.j * s_l: (ax.j + 1) * s_l]
    t = x_loc.reshape(-1, d)
    tn = t.shape[0]
    w, ids, probs = _route(p["router"], t, spec)
    rec_e = ids.reshape(1, tn * k)
    rec_w = w.reshape(1, tn * k)
    phys = inv_place.to(device=x.device, dtype=torch.int32)[rec_e.long()]
    dev = phys // ax.e_loc
    eloc = phys % ax.e_loc
    rec_x = t.to(cd).repeat_interleave(k, dim=0)[None]

    # hop 1 over the model subgroup, on the policy's transport
    c1 = _capacity(cf, tn * k, ax.ntp)
    ship = make_exchange(ExchangeSpec(num_lanes=ax.ntp, capacity=c1, axis=ax.tp,
                                      group=ax.mesh.subgroup(ax.tp)), pol.exchange_backend)
    res1 = ship(dev, torch.ones_like(dev, dtype=torch.bool),
                [Payload(rec_x, 0), Payload(eloc, 0)])
    rvalid, (rxf, ref_) = res1.unpack()

    # hop 2: the received records into this rank's experts, locally
    c2 = _capacity(cf, tn * k, ax.e_loc)
    local = make_exchange(ExchangeSpec(num_lanes=ax.e_loc, capacity=c2))
    res2 = local.bucketize(ref_, rvalid, [Payload(rxf, 0)])
    overflow = (res1.send.overflow + res2.send.overflow).sum().to(torch.float32)
    wi, wo = _rank_slots(p, ax)
    eout = _expert_ffn(wi.to(cd), wo.to(cd), res2.payloads[0].reshape(ax.e_loc, c2, d),
                       ffn_kind)

    back = take_from(eout.reshape(1, ax.e_loc, c2, d), res2.send).reshape(1, ax.ntp, c1, d)
    ret, back_shipped, back_occupied = ship.backhaul(back, forward=res1)
    val = take_from(ret, res1.send)
    y = (val * rec_w[..., None].to(cd)).reshape(tn, k, d).sum(dim=1)
    if "shared" in p:
        y = y + apply_ffn(p["shared"], x_loc, ffn_kind, pol).reshape(-1, d)

    # y back to [B, S, d] on every rank: the blocks in rank order, then
    # laid out by their (data..., model) coordinates
    g = ax.mesh.group
    rows, = g.gather_rows(y.reshape(1, b_l, s_l, d))
    names = ax.mesh.axis_names
    order = [names.index(a) for a in ax.dp + (ax.tp,)]
    nd = len(names)
    y = rows.reshape(tuple(ax.mesh.dims) + (b_l, s_l, d)).permute(
        order + [nd, nd + 1, nd + 2]).reshape(ax.dpn, ax.ntp, b_l, s_l, d)
    y = y.permute(0, 2, 1, 3, 4).reshape(b, s, d)

    counts = torch.bincount(rec_e.reshape(-1).long(), minlength=e).to(torch.float32)
    counts, overflow, aux = g.sum(counts, overflow, _aux_loss(probs, ids, e),
                                  dtype=torch.float32)
    fwd_occupied = tn * k - res1.send.overflow.to(torch.int64)
    shipped, occupied = g.sum((res1.shipped_rows + back_shipped).sum(),
                              (fwd_occupied + back_occupied).sum())
    return MoEOut(y, counts, overflow, aux / g.world_size, shipped, occupied)


def _moe_replicated_mesh(p: dict, x: torch.Tensor, spec: MoESpec, ffn_kind: str,
                         pol: Policy, inv_place: torch.Tensor | None) -> MoEOut:
    """``moe_apply_replicated`` on rank ``(i, j)``: every token, the
    (token, expert) pairs of model shard ``j``'s experts through F-slice
    ``i`` of them (the data axes split F), the shared expert's F-slice ``j``
    over ``dpn``, and one float32 all-reduce of the partial outputs over
    all ranks."""
    ax = _mesh_axes(pol, spec)
    b, s, d = x.shape
    e, k = spec.num_experts, spec.top_k
    cf = pol.moe_capacity_factor or spec.capacity_factor
    cd = pol.compute_dtype
    if inv_place is None:
        inv_place = _identity_place(spec, x.device)
    p, x = _summed_inputs(p, x, ax)
    t = x.reshape(-1, d)
    tn = t.shape[0]
    w, ids, probs = _route(p["router"], t, spec)
    rec_e = ids.reshape(-1)
    phys = inv_place.to(device=x.device, dtype=torch.int32)[rec_e.long()]
    mine = ((phys // ax.e_loc) == ax.j)[None]
    eloc = torch.where(mine, (phys % ax.e_loc)[None], 0)

    c2 = _capacity(cf, tn * k, ax.e_loc)
    local = make_exchange(ExchangeSpec(num_lanes=ax.e_loc, capacity=c2))
    res = local.bucketize(eloc, mine, [Payload(t.to(cd).repeat_interleave(k, dim=0)[None], 0)])
    wi, wo = _rank_slots(p, ax)
    f = wi.shape[-1]
    if f % ax.dpn:
        raise ValueError(f"moe_apply_replicated: the data axes' {ax.dpn} ranks do not divide "
                         f"the experts' hidden size {f}")
    fl = f // ax.dpn
    wi, wo = wi[..., ax.i * fl: (ax.i + 1) * fl], wo[:, ax.i * fl: (ax.i + 1) * fl]
    eout = _expert_ffn(wi.to(cd), wo.to(cd), res.payloads[0].reshape(ax.e_loc, c2, d),
                       ffn_kind)
    val = take_from(eout.reshape(1, ax.e_loc, c2, d), res.send)[0]
    y = (val * w.reshape(tn * k, 1).to(cd)).reshape(tn, k, d).sum(dim=1)
    if "shared" in p:
        sh = p["shared"]
        fs = sh["wi"].shape[-1]
        if fs % ax.ntp:
            raise ValueError(f"moe_apply_replicated: the model axis's {ax.ntp} ranks do not "
                             f"divide the shared expert's hidden size {fs}")
        sl = slice(ax.j * (fs // ax.ntp), (ax.j + 1) * (fs // ax.ntp))
        part = {"wi": sh["wi"][..., sl], "wo": sh["wo"][sl]}
        y = y + apply_ffn(part, t, ffn_kind, pol) / ax.dpn
    g = ax.mesh.group
    y, overflow = g.sum(y, res.send.overflow.to(torch.float32).sum(), dtype=torch.float32)
    counts = torch.bincount(rec_e.long(), minlength=e).to(torch.float32)
    # every rank's aux is the same value; each takes 1 / W of its gradient,
    # so the router's summed gradient counts it once (the reference divides
    # a P() output's cotangent by the mesh's size)
    aux = _aux_loss(probs, ids, e)
    aux = aux.detach() + (aux - aux.detach()) / g.world_size
    # the reference's pmean over every rank times the model axis's size
    return MoEOut(y.reshape(b, s, d), counts, overflow / g.world_size * ax.ntp, aux)
