"""Mamba-1 selective SSM block (Jamba's mixer), chunked (a port of
``repro.models.ssm``).

The selective scan runs chunk by chunk: within a chunk of ``c`` tokens
an associative scan over ``(exp(dt * A), dt * x * B)`` pairs gives every
step's state from the chunk's start as a ``[B, c, d_inner, d_state]``
float32 tensor; across chunks the state ``h [B, d_inner, d_state]`` is
carried by a Python loop, as the reference's ``lax.scan`` carries it.  A
sequence of ``s`` tokens is cut into chunks of ``min(chunk, s)``, which
must divide ``s``: the reference asserts it, and this port raises
``ValueError`` (it neither pads nor cuts the prompt).  Decode is the same
forward at one token with the state.

The intra-chunk scan follows ``jax.lax.associative_scan``'s odd/even
recursion (combine adjacent pairs, scan the half, fill in the even
positions, interleave), so its products are taken in the reference's
order: the cumulative decay comes out equal, the accumulated inputs within
float32 rounding (XLA may fuse ``a2 * b1 + b2``).  ``dt * x`` is rounded to
the compute dtype before it is cast to float32, as in the reference.

Plain PyTorch ops throughout: the reference reaches no Pallas kernel here.
Random init draws from an explicit ``torch.Generator``, as the rest of the
port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import Policy, normal

__all__ = [
    "init_mamba",
    "init_mamba_state",
    "mamba_decode",
    "mamba_forward",
]

F32 = torch.float32


def init_mamba(gen: torch.Generator, d: int, *, expand: int, d_state: int, d_conv: int,
               dtype=F32) -> dict:
    di = expand * d
    dt_rank = -(-d // 16)
    dev = gen.device
    # S4D-real initialisation of A, stored as log(A) in the parameter dtype
    a = torch.arange(1, d_state + 1, dtype=F32, device=dev)[None].repeat(di, 1)
    return {
        "in_proj": normal(gen, (d, 2, di), d**-0.5, dtype),          # x, z
        "conv_w": normal(gen, (d_conv, di), d_conv**-0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": normal(gen, (di, dt_rank + 2 * d_state), di**-0.5, dtype),
        "dt_proj": normal(gen, (dt_rank, di), dt_rank**-0.5, dtype),
        "dt_bias": torch.full((di,), math.log(math.expm1(0.01)), dtype=dtype,
                              device=dev),                           # softplus^-1(0.01)
        "a_log": torch.log(a).to(dtype),
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal(gen, (di, d), di**-0.5, dtype),
    }


def _ssm_inputs(p: dict, x: torch.Tensor, pol: Policy, d_state: int):
    """The input projection: ``(x_m, z)``, each ``[B, S, d_inner]`` in the
    compute dtype."""
    del d_state  # the reference's signature
    w = p["in_proj"].to(pol.compute_dtype)
    xz = torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    return xz[:, :, 0], xz[:, :, 1]


def _conv_causal(xm: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None):
    """Depthwise causal conv, then SiLU; ``state [B, k-1, di]`` carries the
    previous rows.  Returns ``(out, new_state)``, the new state the last
    ``k-1`` rows of ``[state, xm]`` (prompts shorter than ``k-1`` included).
    The taps are summed as Python's ``sum`` sums them (``0 + tap0 + ...``),
    so a bf16 sum rounds as the reference's does."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xm.shape[0], k - 1, xm.shape[2]), dtype=xm.dtype, device=xm.device)
    else:
        pad = state.to(xm.dtype)
    xp = torch.cat([pad, xm], dim=1)
    out = sum(xp[:, i:i + xm.shape[1]] * w[i][None, None] for i in range(k))
    return F.silu(out + b[None, None]), xp[:, -(k - 1):]


def _dt_b_c(p: dict, xc: torch.Tensor, d_state: int, cd):
    """The selective parameters: ``dt [B, S, di]`` (softplus of the low-rank
    projection plus ``dt_bias``), ``B`` and ``C`` ``[B, S, d_state]``, all in
    ``cd``."""
    dbc = torch.matmul(xc, p["x_proj"].to(cd))
    dt_rank = p["dt_proj"].shape[0]
    dt = F.softplus(torch.matmul(dbc[..., :dt_rank], p["dt_proj"].to(cd))
                   + p["dt_bias"].to(cd)[None, None])
    return dt, dbc[..., dt_rank:dt_rank + d_state], dbc[..., dt_rank + d_state:]


def _combine(a1, b1, a2, b2):
    """The scan's operator: ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[even0, odd0, even1, odd1, ...]`` along dim 1; ``even`` has as
    many rows as ``odd`` or one more."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` along dim 1, by
    ``jax.lax.associative_scan``'s recursion."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _chunk(h: torch.Tensor, xc, dt, bmat, cmat, a: torch.Tensor):
    """One chunk of ``c`` tokens from the carried state ``h [B, di, ds]``:
    ``(h_new, y [B, c, di])``, both float32."""
    da = torch.exp(dt.to(F32)[..., None] * a[None, None])             # [B, c, di, ds]
    dbx = (dt * xc).to(F32)[..., None] * bmat.to(F32)[:, :, None, :]
    aprod, bxcum = _scan(da, dbx)
    hs = aprod * h[:, None] + bxcum
    y = torch.matmul(hs, cmat.to(F32)[..., None])[..., 0]
    return hs[:, -1], y


def mamba_forward(p: dict, x: torch.Tensor, pol: Policy, *, d_state: int, chunk: int = 256,
                  state: dict | None = None):
    """Train / prefill forward over ``x [B, S, d]``.  Returns ``(out [B, S,
    d], state)`` with the new decode state ``{"conv": [B, k-1, di]`` in the
    compute dtype, ``"ssm": [B, di, d_state]`` float32``}`` (a new dict;
    ``state`` is not changed).  Raises ``ValueError`` when ``min(chunk, S)``
    does not divide ``S``, where the reference asserts."""
    b, s, _ = x.shape
    cd = pol.compute_dtype
    c = min(chunk, s)
    if s % c:
        raise ValueError(
            f"mamba_forward: {s} tokens do not split into chunks of {c}; the reference's "
            f"chunk contract (repro.models.ssm.mamba_forward asserts s % min(chunk, s) == 0) "
            f"takes a sequence of at most {chunk} tokens or a multiple of {chunk}")
    xm, z = _ssm_inputs(p, x, pol, d_state)
    xc, conv_state = _conv_causal(xm, p["conv_w"].to(cd), p["conv_b"].to(cd),
                                  None if state is None else state["conv"])
    xc = pol.shard(xc, "ssm_inner")
    dt, bmat, cmat = _dt_b_c(p, xc, d_state, cd)
    a = -torch.exp(p["a_log"].to(F32))                                 # [di, ds]
    if state is None:
        h = torch.zeros((b, xc.shape[-1], d_state), dtype=F32, device=x.device)
    else:
        h = state["ssm"].to(F32)
    ys = []
    for j in range(0, s, c):
        sl = slice(j, j + c)
        h, y = _chunk(h, xc[:, sl], dt[:, sl], bmat[:, sl], cmat[:, sl], a)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(cd)
    y = y + xc * p["d_skip"].to(cd)[None, None]
    y = y * F.silu(z)
    out = torch.matmul(y, p["out_proj"].to(cd))
    return out, {"conv": conv_state.to(cd), "ssm": h}


def mamba_decode(p: dict, x: torch.Tensor, pol: Policy, *, d_state: int, state: dict):
    """Single-token step: ``x [B, 1, d]``."""
    return mamba_forward(p, x, pol, d_state=d_state, chunk=1, state=state)


def init_mamba_state(b: int, d: int, *, expand: int, d_state: int, d_conv: int, dtype=F32,
                     device=None) -> dict:
    di = expand * d
    return {
        "conv": torch.zeros((b, d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((b, di, d_state), dtype=F32, device=device),
    }
