"""xLSTM mixers: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, a sequential scan) -- arXiv:2405.04517 (a port of
``repro.models.xlstm``).

mLSTM runs chunkwise: within a chunk the gate-weighted q/k/v products are
dense ``[chunk, chunk]`` matrices; across chunks the matrix memory ``c``,
the normaliser ``n`` and the stabiliser ``m`` are carried.  A sequence of
``s`` tokens is cut into chunks of ``min(chunk, s)``, which must divide
``s``: the reference asserts it, and this port raises ``ValueError`` (it
neither pads nor cuts the prompt, which would give another result).

sLSTM has no parallel form: each time step is 15 small kernels over the
``[heads, batch, head_dim]`` state (the per-head recurrent product one
``baddbmm``; the gates' exponentials one ``exp`` of the two stacked); the
bias is added to the input projection once, before the loop (float32
sums in another order than the reference's ``wx + r h + b``).
``Policy.slstm_unroll`` only regroups the reference's scan; this loop
gives the same bits for any value.

The state's stabilisers start at ``-1e30`` (a float32 constant, as in the
reference), never ``-inf``.  Heads are padded to ``pol.tp`` with dead heads
whose down-projection rows are zero (the mLSTM's output gate is zero there
too), so they add exactly zero to the output.

Plain PyTorch ops throughout: the reference runs ``lax.scan`` here and
reaches no Pallas kernel.  Random init draws from an explicit
``torch.Generator``, as the rest of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import Policy, normal

__all__ = [
    "init_mlstm",
    "init_mlstm_state",
    "init_slstm",
    "init_slstm_state",
    "mlstm_forward",
    "slstm_forward",
]

NEG = -1e30  # the stabilisers' start and the masked scores (float32, not -inf)
F32 = torch.float32


def _dead_heads_zero(down: torch.Tensor, heads: int) -> torch.Tensor:
    """``down [heads_p, hd, d]`` with the padded heads' rows zeroed."""
    if down.shape[0] > heads:
        mask = (torch.arange(down.shape[0], device=down.device) < heads)[:, None, None]
        down = down * mask
    return down


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, d: int, heads: int, heads_p: int, *, proj: int = 2,
               dtype=F32) -> dict:
    di = proj * d
    hd = di // heads
    dev = gen.device
    p = {
        "up": normal(gen, (d, 2, di), d**-0.5, dtype),           # x_m, z
        "conv_w": normal(gen, (4, di), 0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "wq": normal(gen, (di, heads_p, hd), di**-0.5, dtype),
        "wk": normal(gen, (di, heads_p, hd), di**-0.5, dtype),
        "wv": normal(gen, (di, heads_p, hd), di**-0.5, dtype),
        "w_if": normal(gen, (di, 2, heads_p), di**-0.5, dtype),  # i, f pre-activations
        "b_if": torch.stack([torch.zeros(heads_p, device=dev),
                             torch.full((heads_p,), 3.0, device=dev)]).to(dtype),
        "down": normal(gen, (heads_p, hd, d), di**-0.5, dtype),
    }
    p["down"] = _dead_heads_zero(p["down"], heads)
    return p


def _mlstm_qkvif(p: dict, x: torch.Tensor, cd, conv_state=None):
    """The mLSTM's projections: q, k, v ``[B, S, Hp, hd]`` in ``cd``, the
    float32 input and log-forget gates ``[B, S, Hp]``, the output gate's
    pre-activation ``z [B, S, di]`` and the conv state's last 3 rows."""
    b, s, d = x.shape
    up = p["up"].to(cd)
    xz = torch.matmul(x, up.reshape(d, -1)).unflatten(-1, up.shape[1:])
    xm, z = xz[:, :, 0], xz[:, :, 1]
    # causal depthwise conv feeding q/k (as in the paper's block)
    conv_w = p["conv_w"].to(cd)
    k4 = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((b, k4 - 1, xm.shape[-1]), dtype=xm.dtype, device=x.device)
    else:
        pad = conv_state.to(xm.dtype)
    xp = torch.cat([pad, xm], dim=1)
    xc = sum(xp[:, i:i + s] * conv_w[i][None, None] for i in range(k4))
    xc = F.silu(xc + p["conv_b"].to(cd)[None, None])
    new_conv_state = xp[:, -(k4 - 1):]

    def heads(t, w):
        w = w.to(cd)
        return torch.matmul(t, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])

    q, k, v = heads(xc, p["wq"]), heads(xc, p["wk"]), heads(xm, p["wv"])
    ifg = heads(xm, p["w_if"]) + p["b_if"].to(cd)[None, None]
    logi = ifg[:, :, 0].to(F32)                   # [B, S, H]
    logf = F.logsigmoid(ifg[:, :, 1].to(F32))     # [B, S, H]
    return q, k, v, logi, logf, z, new_conv_state


def _bf16_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` of the operands rounded to bf16, multiplied and
    summed in float32 (the reference's bf16 dot with a float32 result)."""
    return torch.einsum(eq, a.to(torch.bfloat16).to(F32), b.to(torch.bfloat16).to(F32))


def _mlstm_chunk(cm, nm, mm, qb, kb, vb, lib, lfb, scale: float, recurrent_bf16: bool):
    """One chunk of ``c`` tokens: ``(c_new, n_new, m_end)`` and its output
    ``h [B, c, H, hd]`` (float32)."""
    c = qb.shape[1]
    qf, kf, vf = qb.to(F32), kb.to(F32), vb.to(F32)
    f_cum = torch.cumsum(lfb, dim=1)                     # F_t (within the chunk)
    f_tot = f_cum[:, -1]                                 # [B, H]
    # stabilisers
    a = lib - f_cum                                      # i_s - F_s
    m_intra = f_cum + torch.cummax(a, dim=1).values      # [B, c, H]
    m_inter = mm[:, None] + f_cum                        # the old state's path
    m_t = torch.maximum(m_intra, m_inter)
    # intra-chunk: D[t, s] = exp(F_t - F_s + i_s - m_t), s <= t
    dmat = f_cum[:, :, None] - f_cum[:, None, :] + lib[:, None, :] - m_t[:, :, None]
    tri = torch.ones((c, c), dtype=torch.bool, device=qb.device).tril()
    dmat = torch.where(tri[None, :, :, None], dmat, NEG)
    w = torch.exp(dmat)                                  # [B, t, s, H]
    sqk = torch.einsum("bthk,bshk->btsh", qf, kf) * scale
    pw = w * sqk
    if recurrent_bf16:
        y_intra = _bf16_product("btsh,bshv->bthv", pw, vb)
        n_intra = _bf16_product("btsh,bshk->bthk", w, kb)
    else:
        y_intra = torch.einsum("btsh,bshv->bthv", pw, vf)
        n_intra = torch.einsum("btsh,bshk->bthk", w, kf)
    # inter-chunk: the old memory's contribution
    g = torch.exp(m_inter - m_t)[..., None]              # [B, c, H, 1]
    qs = qf * scale
    y_inter = torch.einsum("bthk,bhkv->bthv", qs, cm) * g
    n_inter = torch.einsum("bthk,bhk->bth", qs, nm)[..., None] * g
    num = y_intra + y_inter
    den = torch.abs(torch.einsum("bthk,bthk->bth", qs, n_intra)[..., None] + n_inter)
    h = num / torch.maximum(den, torch.exp(-m_t)[..., None])
    # the carry at the chunk's end
    m_end = torch.maximum(mm + f_tot, f_tot + torch.amax(a, dim=1))
    decay_old = torch.exp(mm + f_tot - m_end)            # [B, H]
    wk_end = torch.exp(f_tot[:, None] - f_cum + lib - m_end[:, None])  # [B, c, H]
    c_new = cm * decay_old[..., None, None] + torch.einsum(
        "bshk,bshv->bhkv", wk_end[..., None] * kf, vf)
    n_new = nm * decay_old[..., None] + torch.einsum("bsh,bshk->bhk", wk_end, kf)
    return c_new, n_new, m_end, h


def mlstm_forward(p: dict, x: torch.Tensor, pol: Policy, *, chunk: int = 256,
                  state: dict | None = None):
    """Chunk-parallel mLSTM over ``x [B, S, d]``.  Returns ``(out [B, S, d],
    state)`` with the new state ``{"c": [B, H, hd, hd], "n": [B, H, hd],
    "m": [B, H], "conv": [B, 3, di]}`` (a new dict; ``state`` is not
    changed).  Raises ``ValueError`` when ``min(chunk, S)`` does not divide
    ``S``, where the reference asserts."""
    b, s, _ = x.shape
    cd = pol.compute_dtype
    c = min(chunk, s)
    if s % c:
        raise ValueError(
            f"mlstm_forward: {s} tokens do not split into chunks of {c}; the reference's "
            f"chunk contract (repro.models.xlstm.mlstm_forward asserts s % min(chunk, s) "
            f"== 0) takes a sequence of at most {chunk} tokens or a multiple of {chunk}")
    q, k, v, logi, logf, z, conv_state = _mlstm_qkvif(
        p, x, cd, None if state is None else state["conv"])
    hp, hd = q.shape[2], q.shape[3]
    scale = hd**-0.5
    if state is None:
        cm = torch.zeros((b, hp, hd, hd), dtype=F32, device=x.device)
        nm = torch.zeros((b, hp, hd), dtype=F32, device=x.device)
        mm = torch.full((b, hp), NEG, dtype=F32, device=x.device)
    else:
        cm, nm, mm = state["c"], state["n"], state["m"]
    hs = []
    for j in range(0, s, c):
        sl = slice(j, j + c)
        cm, nm, mm, h = _mlstm_chunk(cm, nm, mm, q[:, sl], k[:, sl], v[:, sl], logi[:, sl],
                                     logf[:, sl], scale, pol.recurrent_bf16)
        hs.append(h)
    h = torch.cat(hs, dim=1).to(cd)
    # the z gate covers the real heads only; padded (dead) heads gate to zero
    real = z.shape[-1] // hd
    zr = F.silu(z).reshape(b, s, real, hd)
    if hp > real:
        zr = F.pad(zr, (0, 0, 0, hp - real))
    h = h * zr
    down = p["down"].to(cd)
    out = torch.matmul(h.reshape(b, s, hp * hd), down.reshape(hp * hd, -1))
    return out, {"c": cm, "n": nm, "m": mm, "conv": conv_state}


def init_mlstm_state(b: int, heads_p: int, hd: int, di: int, conv: int = 4, dtype=F32,
                     device=None) -> dict:
    return {
        "c": torch.zeros((b, heads_p, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((b, heads_p, hd), dtype=F32, device=device),
        "m": torch.full((b, heads_p), NEG, dtype=F32, device=device),
        "conv": torch.zeros((b, conv - 1, di), dtype=dtype, device=device),
    }


def init_slstm_state(b: int, heads_p: int, hd: int, device=None) -> dict:
    z = torch.zeros((b, heads_p, hd), dtype=F32, device=device)  # never written in place
    return {"c": z, "n": z, "h": z, "m": z - 1e30}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, d: int, heads: int, heads_p: int, dtype=F32) -> dict:
    hd = d // heads
    b = torch.zeros((4, heads_p, hd), dtype=F32, device=gen.device)
    b[2] = 3.0  # forget-gate bias
    p = {
        "w": normal(gen, (d, 4, heads_p, hd), d**-0.5, dtype),     # z i f o
        "r": normal(gen, (4, heads_p, hd, hd), hd**-0.5, dtype),   # recurrent, block-diagonal
        "b": b.to(dtype),
        "down": normal(gen, (heads_p, hd, d), d**-0.5, dtype),
    }
    p["down"] = _dead_heads_zero(p["down"], heads)
    return p


def slstm_forward(p: dict, x: torch.Tensor, pol: Policy, *, state: dict | None = None,
                  unroll: int | None = None):
    """Sequential sLSTM over ``x [B, S, d]``.  Returns ``(out [B, S, d],
    state)`` with the new float32 state ``{"c", "n", "h", "m"}``, each
    ``[B, H, hd]`` (a new dict).  ``unroll`` (default ``pol.slstm_unroll``)
    regroups the reference's scan without changing its bits; this loop
    takes one step at a time whatever it is.

    The loop never reads a value back to the host: each step is queued."""
    del unroll  # the grouping does not change a bit (module docstring)
    b, s, d = x.shape
    cd = pol.compute_dtype
    w = p["w"].to(cd)
    _, _, hp, hd = w.shape
    wx = torch.matmul(x, w.reshape(d, -1)).to(F32).reshape(b, s, 4, hp, hd)
    # time-major, head-major, the bias added once: step t reads [H, B, 4 * hd]
    bias = p["b"].to(F32)[None, None]
    steps = (wx + bias).permute(1, 3, 0, 2, 4).reshape(s, hp, b, 4 * hd).unbind(0)
    r = p["r"].to(F32).permute(1, 2, 0, 3).reshape(hp, hd, 4 * hd)  # [H, k, (g, j)]
    if state is None:
        zeros = torch.zeros((hp, b, hd), dtype=F32, device=x.device)
        c, n, h, m = zeros, zeros, zeros, zeros - 1e30
    else:
        c, n, h, m = (state[k].to(F32).transpose(0, 1) for k in ("c", "n", "h", "m"))
    one = torch.ones((), dtype=F32, device=x.device)
    hs = []
    for wx_t in steps:  # unbind, not indexing: the backward stacks once
        pre = torch.baddbmm(wx_t, h, r).view(hp, b, 4, hd)
        z_pre, logi, f_pre, o_pre = pre.unbind(2)
        zt = torch.tanh(z_pre)
        logf = F.logsigmoid(f_pre)
        o = torch.sigmoid(o_pre)
        fm = logf + m
        m = torch.maximum(fm, logi)
        i_s, f_s = torch.exp(torch.stack([logi, fm]) - m).unbind(0)
        c = torch.addcmul(f_s * c, i_s, zt)
        n = torch.addcmul(i_s, f_s, n)
        h = o * c / torch.maximum(n, one)
        hs.append(h)
    hseq = torch.stack(hs).permute(2, 0, 1, 3).to(cd)              # [B, S, H, hd]
    down = p["down"].to(cd)
    out = torch.matmul(hseq.reshape(b, s, hp * hd), down.reshape(hp * hd, -1))
    new = {k: v.transpose(0, 1).contiguous() for k, v in zip("cnhm", (c, n, h, m))}
    return out, new
