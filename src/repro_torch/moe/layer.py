"""Expert-parallel MoE layer with DR-style dispatch, over EP shards stacked
on one device (a port of ``repro.moe.layer``).

The token -> expert exchange *is* the paper's keyed shuffle: keys are
expert ids, partitions are EP shards, and the routing table is the KIP
placement (``inv_place``: logical expert -> physical slot).  The reference
runs the layer under ``shard_map`` over ``(data, model)``; the port keeps
its ``N = Policy.ep_shards`` model shards stacked on the leading axis of
``[N, ...]`` tensors, as ``StreamingJob`` stacks its workers, with one
data shard.  The exchange is the port's plane (``repro_torch.exchange``):
hop 1 ships over the policy's transport (dense or ragged), hop 2 buckets
into local experts with the ``dispatch_count`` kernel on the card, and the
combine rides the same lanes back (``backhaul`` + ``take_from``).

Three evaluation paths, as in the reference:

* ``moe_ref`` — the dense oracle (every expert on every token, exact
  combine): the plain version of the whole layer.
* ``moe_apply`` — the distributed dispatch: shard ``m`` holds the
  sequence slice ``[m * S / N, (m + 1) * S / N)`` of every batch row and
  the experts of physical slots ``[m * E / N, (m + 1) * E / N)``.
* ``moe_apply_replicated`` — decode: the tokens go to every shard, each
  computes its own experts, and the shards' partial outputs are summed.

The router runs once over all tokens in ``[B, S]`` order on every path,
so the three paths route a token alike on one device.  Within one
record's shard the ``psum`` of the reference is a sum over the stacked
axis; the shared expert, F-sliced over the model axis in the reference's
decode path, is one FFN here (the sum of its slices).
"""
from __future__ import annotations

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


def init_moe(gen: torch.Generator, d: int, spec: MoESpec, ffn_kind: str, dtype) -> dict:
    """Router (float32), stacked expert FFNs ``wi [E, d, gate, f]``, ``wo
    [E, f, d]`` and the shared expert, drawn from ``gen``."""
    e, f = spec.num_experts, spec.d_ff_expert
    gate = 2 if ffn_kind in ("swiglu", "geglu") else 1
    p = {
        "router": normal(gen, (d, e), d**-0.5, torch.float32),
        "wi": normal(gen, (e, d, gate, f), d**-0.5, dtype),
        "wo": normal(gen, (e, f, d), f**-0.5, dtype),
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
    experts (hop 2), and the results ride the same lanes back."""
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
    ``psum``).  With one data shard each expert's F-slice is all of F."""
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
