"""Plain PyTorch versions of the CUDA kernels (no custom kernel, any device).

These are the oracles the CUDA kernels are held to, and what the kernel
wrappers run when handed CPU tensors.  Each mirrors its counterpart in
``repro.kernels.ref`` bit for bit.

``flash_attention_ref`` is the plain version of the flash-attention kernel:
the reference's jnp chunked flash (``repro.models.attention.
flash_attention``) in the Pallas kernel's ``[G, P, Sq, hd]`` layout.

Records are stacked per worker: ``keys`` is ``int32[W, n]`` (a 1-D ``[n]``
input is one worker and returns 1-D outputs).  The split-replica hash folds
in the record's *worker-local* index, as the reference's shard-local
``arange`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import GOLDEN, fmix32, mul32, seed_mix

__all__ = [
    "block_visible",
    "dispatch_count_ref",
    "flash_attention_ref",
    "lookup_dispatch_ref",
    "partition_apply_ref",
    "route_bucketize_ref",
    "scatter_rows",
    "sketch_update_ref",
    "split_choice_ref",
]


def _stacked(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (x, False) if x.dim() >= 2 else (x.unsqueeze(0), True)


def scatter_rows(cell: torch.Tensor, num_cells: int, data: torch.Tensor, fill,
                 shape: tuple, out: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter ``data[W, n, ...]`` to flat cell ids ``cell[W, n]`` of a buffer
    ``shape + data.shape[2:]`` prefilled with ``fill``.  Rows whose cell is
    ``num_cells`` drop out without a data-dependent mask (which would wait
    for the card): in a fresh buffer they land in one trailing spare cell
    that is cut off.

    ``out`` is a recycled buffer of exactly ``shape + data.shape[2:]``
    (contiguous), refilled and written in place; it has no spare cell, so
    the dropped rows write cell 0 instead, each carrying the value cell 0
    ends with (its own record's, else ``fill``): every write to it agrees,
    and the values equal the fresh path's."""
    trailing = tuple(data.shape[2:])
    rows = data.reshape((-1,) + trailing)
    cell = cell.reshape(-1)
    if out is None:
        buf = torch.full((num_cells + 1,) + trailing, fill, dtype=data.dtype,
                         device=data.device)
        buf[cell] = rows
        return buf[:num_cells].view(tuple(shape) + trailing)
    if (tuple(out.shape) != tuple(shape) + trailing or out.dtype != data.dtype
            or out.device != data.device or not out.is_contiguous()):
        raise ValueError(f"scatter_rows: out must be contiguous {data.dtype}"
                         f"{list(shape) + list(trailing)} on {data.device}, got "
                         f"{out.dtype}{list(out.shape)} on {out.device}")
    flat = out.view((num_cells,) + trailing)
    flat.fill_(fill)
    if cell.numel() == 0 or num_cells == 0:
        return out
    kept = cell < num_cells
    first = (cell == 0) & kept
    own = rows.index_select(0, first.to(torch.int32).argmax().view(1))[0]
    at0 = torch.where(first.any(), own, torch.full_like(own, fill))
    drop = ~kept if not trailing else (~kept).view((-1,) + (1,) * len(trailing))
    flat[torch.where(kept, cell, 0)] = torch.where(drop, at0, rows)
    return out


def _heavy_index(keys: torch.Tensor, heavy_keys: torch.Tensor):
    """(index of the first heavy row >= key, clipped; whether it equals key)."""
    b = heavy_keys.shape[0]
    idx = torch.searchsorted(heavy_keys, keys.contiguous()).clamp_(max=b - 1)
    return idx, heavy_keys[idx] == keys


def partition_apply_ref(keys, heavy_keys, heavy_parts, host_to_part, *,
                        seed=0, num_hosts=4096):
    """key -> partition: heavy-table hit, else the hashed host's partition."""
    keys, one = _stacked(keys.to(torch.int32))
    mixed = fmix32(keys.to(torch.int64) ^ seed_mix(seed))
    part = host_to_part[mixed & (num_hosts - 1)]
    if heavy_keys.shape[0] > 0:
        idx, hit = _heavy_index(keys, heavy_keys)
        part = torch.where(hit, heavy_parts[idx], part)
    part = part.to(torch.int32)
    return part[0] if one else part


def split_choice_ref(keys, heavy_keys, heavy_repl, *, seed=0, num_partitions=0,
                     home=None, part_loads=None):
    """Replica pick for split heavy keys: ``(hit, offset)`` with the offset
    ``(h & 0x7FFFFFFF) % max(repl, 1)``, ``h = fmix32(idx * golden ^ mixed)``.

    With ``home`` (each record's home partition) and ``part_loads`` (a
    float32 ``[num_partitions]`` load vector) the pick is the two-choice
    least-load tie-break: a second hash ``h2 = fmix32(h + 0x85EBCA6B)``
    proposes ``offset2 = (h2 & 0x7FFFFFFF) % d``, and a record takes it
    only when ``loads[(home + offset2) % N] < loads[(home + offset) % N]``
    (ties keep the first hash, so equal loads route as the hash pick)."""
    keys, one = _stacked(keys.to(torch.int32))
    mixed = fmix32(keys.to(torch.int64) ^ seed_mix(seed))
    idx = torch.arange(keys.shape[1], device=keys.device, dtype=torch.int64)
    h = fmix32(mul32(idx, GOLDEN)[None, :] ^ mixed)
    bidx, hit = _heavy_index(keys, heavy_keys)
    d = heavy_repl[bidx].to(torch.int64).clamp(min=1)
    offset = (h & 0x7FFFFFFF) % d
    if part_loads is not None and home is not None and num_partitions > 0:
        h2 = fmix32((h + 0x85EBCA6B) & 0xFFFFFFFF)  # the sum wraps mod 2**32
        offset2 = (h2 & 0x7FFFFFFF) % d
        loads = part_loads.to(torch.float32)
        base = _stacked(home)[0].to(torch.int64)
        p1 = (base + offset) % num_partitions
        p2 = (base + offset2) % num_partitions
        offset = torch.where(loads[p2] < loads[p1], offset2, offset)
    offset = offset.to(torch.int32)
    return (hit[0], offset[0]) if one else (hit, offset)


def dispatch_count_ref(dest, valid, *, num_parts):
    """Stable rank of each valid record within its destination and the
    per-destination counts, via a stable sort.

    As in the reference, an invalid record gets slot -1 and a valid record
    whose destination lies outside ``[0, num_parts)`` gets slot 0 and is
    not counted (the exchange counts it as overflow)."""
    dest, one = _stacked(dest.to(torch.int32))
    valid = valid.reshape(dest.shape)
    w, n = dest.shape
    counted = valid & (dest >= 0) & (dest < num_parts)
    key = torch.where(counted, dest.to(torch.int64), num_parts)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    counts = torch.zeros((w, num_parts + 1), dtype=torch.int64, device=dest.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(n, device=dest.device, dtype=torch.int64).expand(w, n)
    rank_sorted = pos - torch.gather(start, 1, sorted_key)
    slot = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    slot = torch.where(counted, slot, torch.where(valid, 0, -1)).to(torch.int32)
    counts = counts[:, :num_parts].to(torch.int32)
    return (slot[0], counts[0]) if one else (slot, counts)


def sketch_update_ref(keys, valid, *, depth=4, width=2048):
    """Count-min sketch ``float32[depth, width]`` (``[W, depth, width]`` for
    stacked keys): row ``d`` adds ``valid`` at column
    ``fmix32(key ^ (d * golden mod 2**32)) % width``, summed in float32
    as the reference does (exact while a cell stays below 2**24)."""
    keys, one = _stacked(keys.to(torch.int32))
    valid = valid.reshape(keys.shape)
    w = keys.shape[0]
    k = keys.to(torch.int64) & 0xFFFFFFFF
    add = valid.to(torch.float32)
    out = torch.zeros((w, depth, width), dtype=torch.float32, device=keys.device)
    for d in range(depth):
        col = fmix32(k ^ ((d * GOLDEN) & 0xFFFFFFFF)) % width
        out[:, d].scatter_add_(1, col, add)
    return out[0] if one else out


def lookup_dispatch_ref(keys, valid, heavy_keys, heavy_parts, host_to_part, *,
                        seed=0, num_hosts=4096, num_lanes,
                        heavy_repl=None, num_partitions=0, part_loads=None):
    """Partition lookup + lane slot in one call: ``(part, slot, counts)``."""
    part = partition_apply_ref(keys, heavy_keys, heavy_parts, host_to_part,
                               seed=seed, num_hosts=num_hosts)
    if heavy_repl is not None and num_partitions > 0 and heavy_keys.shape[0] > 0:
        hit, offset = split_choice_ref(
            keys, heavy_keys, heavy_repl, seed=seed,
            num_partitions=num_partitions, home=part, part_loads=part_loads)
        part = torch.where(hit, (part + offset) % num_partitions, part).to(torch.int32)
    slot, counts = dispatch_count_ref(part % num_lanes, valid, num_parts=num_lanes)
    return part, slot, counts


def route_bucketize_ref(keys, valid, vals, heavy_keys, heavy_parts, host_to_part, *,
                        seed=0, num_hosts=4096, num_lanes, capacity, key_fill,
                        heavy_repl=None, num_partitions=0, part_loads=None, out=None):
    """Route + slot + scatter into ``[W, L, capacity]`` send buffers.

    Returns ``(part, slot, counts, buf_valid, buf_keys, buf_vals, buf_part)``;
    records whose slot is at or past ``capacity`` drop out, and cells no
    record fills hold ``key_fill`` / 0 / 0 / False.  ``out`` is a recycled
    ``(buf_valid, buf_keys, buf_vals, buf_part)`` set written in place (see
    :func:`scatter_rows`); the values equal a fresh set's."""
    part, slot, counts = lookup_dispatch_ref(
        keys, valid, heavy_keys, heavy_parts, host_to_part,
        seed=seed, num_hosts=num_hosts, num_lanes=num_lanes,
        heavy_repl=heavy_repl, num_partitions=num_partitions,
        part_loads=part_loads)
    k, one = _stacked(keys.to(torch.int32))
    p, _ = _stacked(part)
    s, _ = _stacked(slot)
    v = valid.reshape(k.shape)
    x = vals.reshape(k.shape + vals.shape[-1:])
    w = k.shape[0]
    shape = (w, num_lanes, capacity)
    cells = w * num_lanes * capacity
    ok = v & (s >= 0) & (s < capacity)
    lane = (p % num_lanes).to(torch.int64)
    worker = torch.arange(w, device=k.device, dtype=torch.int64)[:, None]
    cell = torch.where(ok, (worker * num_lanes + lane) * capacity + s, cells)
    if out is None:
        out = (None,) * 4
    elif one:
        out = tuple(b.unsqueeze(0) for b in out)
    buf_valid = scatter_rows(cell, cells, ok, False, shape, out=out[0])
    buf_keys = scatter_rows(cell, cells, k, int(key_fill), shape, out=out[1])
    buf_vals = scatter_rows(cell, cells, x, 0.0, shape, out=out[2])
    buf_part = scatter_rows(cell, cells, torch.where(v, p, 0), 0, shape, out=out[3])
    if one:
        buf_valid, buf_keys, buf_vals, buf_part = (
            buf_valid[0], buf_keys[0], buf_vals[0], buf_part[0])
    return part, slot, counts, buf_valid, buf_keys, buf_vals, buf_part


NEG_INF = -1e30


def block_visible(causal: bool, window: int, q0: int, q1: int, k0: int, k1: int) -> bool:
    """May any (q, k) pair of the block q in [q0, q1), k in [k0, k1) attend?"""
    if causal and k0 > q1 - 1:
        return False
    if window > 0 and k1 - 1 < q0 - window + 1:
        return False
    return True


def flash_attention_ref(q, k, v, *, causal, window=0, q_offset=0, q_chunk=256,
                        kv_chunk=512, block_skip=True, p_bf16=False):
    """Attention of ``q [G, P, Sq, hd]`` over ``k, v [G, Sk, hd]``, in
    float32 with an online softmax over ``kv_chunk`` blocks, ``q_chunk``
    rows at a time; the result in q's type.

    q row i sits at position ``q_offset + i``, k row j at j; the mask keeps
    ``kpos <= qpos`` when causal and ``kpos > qpos - window`` when
    ``window > 0``, masked scores are -1e30, and ``block_skip`` skips blocks
    the mask hides entirely.  ``p_bf16`` rounds the softmax weights to bf16
    for the PV product (summed in float32), as the jnp flash does.  A
    float64 input is computed in float64 (``torch.autograd.gradcheck``)."""
    g, p, sq, hd = q.shape
    sk = k.shape[1]
    scale = hd**-0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32  # float64 for gradcheck
    qc, kc = max(1, min(q_chunk, sq)), max(1, min(kv_chunk, sk))
    outs = []
    for q0 in range(0, sq, qc):
        q1 = min(q0 + qc, sq)
        qb = q[:, :, q0:q1].to(ct) * scale
        acc = torch.zeros((g, p, q1 - q0, hd), dtype=ct, device=q.device)
        m = torch.full((g, p, q1 - q0), NEG_INF, dtype=ct, device=q.device)
        l = torch.zeros_like(m)
        qpos = q_offset + q0 + torch.arange(q1 - q0, device=q.device)[:, None]
        for k0 in range(0, sk, kc):
            k1 = min(k0 + kc, sk)
            if block_skip and not block_visible(causal, window, q0 + q_offset,
                                                q1 + q_offset, k0, k1):
                continue
            kb = k[:, k0:k1].to(ct)
            vb = v[:, k0:k1].to(ct)
            s = torch.einsum("gpqh,gkh->gpqk", qb, kb)
            kpos = k0 + torch.arange(k1 - k0, device=q.device)[None, :]
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                ok &= kpos <= qpos
            if window > 0:
                ok &= kpos > qpos - window
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            if p_bf16:
                pw = torch.exp((s - m_new[..., None]).to(torch.bfloat16))
                l = l * corr + pw.sum(dim=-1, dtype=torch.float32)
                pv = torch.einsum("gpqk,gkh->gpqh", pw.to(torch.float32),
                                  vb.to(torch.bfloat16).to(torch.float32))
            else:
                pw = torch.exp(s - m_new[..., None])
                l = l * corr + pw.sum(dim=-1)
                pv = torch.einsum("gpqk,gkh->gpqh", pw, vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    if not outs:
        return torch.empty_like(q)
    return torch.cat(outs, dim=2).to(q.dtype)
