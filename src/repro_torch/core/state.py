"""Per-worker keyed operator state (the stateful-reduce substrate).

State is a fixed-capacity sorted table per worker, stacked over W workers::

    keys   int32[W, S]     sorted ascending, KEY_SENTINEL padded
    values f32[W, S, D]    one state row per key

``merge_into`` folds a batch of (key, value) rows into the tables with a
*stable* sort + segment sum, the semantics of ``repro.core.state``
(``jnp.argsort`` is stable, so the port sorts with ``stable=True``).
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import KEY_SENTINEL

__all__ = ["empty_state", "merge_into", "state_size"]

_SENT = int(KEY_SENTINEL)


def empty_state(capacity: int, dim: int, *, num_workers: int = 1,
                dtype=torch.float32, device="cpu"):
    """Empty stacked tables ``(keys int32[W, S], vals [W, S, D])``."""
    return (
        torch.full((num_workers, capacity), _SENT, dtype=torch.int32, device=device),
        torch.zeros((num_workers, capacity, dim), dtype=dtype, device=device),
    )


def merge_into(state_keys, state_vals, batch_keys, batch_vals, batch_valid):
    """Fold batch rows into the sorted state tables, per worker.

    Shapes: state ``[W, S]`` / ``[W, S, D]``, batch ``[W, M]`` /
    ``[W, M, D]`` / ``[W, M]``.  Returns ``(keys, vals, overflowed)`` where
    ``overflowed[W]`` counts distinct keys that did not fit in the table.
    Invalid batch rows are masked to the sentinel with zero values; state
    rows are taken as they are (sentinel rows' values join the sentinel
    segment, exactly as in the reference).
    """
    w, cap = state_keys.shape
    bk = torch.where(batch_valid, batch_keys.to(torch.int32),
                     torch.full_like(batch_keys, _SENT, dtype=torch.int32))
    bv = torch.where(batch_valid[..., None], batch_vals, torch.zeros_like(batch_vals))
    all_keys = torch.cat([state_keys, bk], dim=1)
    all_vals = torch.cat([state_vals, bv], dim=1)
    sk, order = torch.sort(all_keys, dim=1, stable=True)
    dim = all_vals.shape[2]
    sv = torch.gather(all_vals, 1, order[..., None].expand(-1, -1, dim))
    start = torch.ones_like(sk, dtype=torch.bool)
    start[:, 1:] = sk[:, 1:] != sk[:, :-1]
    seg = torch.cumsum(start, dim=1) - 1
    m = sk.shape[1]
    seg_keys = torch.full((w, m), _SENT, dtype=torch.int32, device=sk.device)
    seg_keys.scatter_reduce_(1, seg, sk, "amin")
    seg_vals = torch.zeros((w, m, dim), dtype=sv.dtype, device=sv.device)
    seg_vals.scatter_add_(1, seg[..., None].expand(-1, -1, dim), sv)
    num_valid = (seg_keys != _SENT).sum(dim=1)
    overflow = (num_valid - cap).clamp(min=0)
    return seg_keys[:, :cap].contiguous(), seg_vals[:, :cap].contiguous(), overflow


def state_size(state_keys) -> torch.Tensor:
    """Live rows per worker."""
    return (state_keys != _SENT).sum(dim=-1)
