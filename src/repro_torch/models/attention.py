"""Attention: GQA with the TP head layout, RoPE, flash attention over the
hand-written kernel, decode attention and KV caches (a port of
``repro.models.attention`` for one device).

The head layout is the reference's (``head_layout``): q heads padded to
``hq_p`` with dead heads, kv heads replicated at activation level to
``hkv_p``, each physical kv slot grouped with its ``qps`` q heads.  With
``tp = 1`` nothing is padded and the kv gather is skipped.

``flash_attention`` keeps the reference's layout (q ``[B, Sq, Hkv_p, qps,
hd]``) and hands it to the kernel as strided views, with no copy: on the
card the CUDA kernel (``repro_torch.kernels.flash_attention``), on the CPU
its plain version.  Decode attention is plain PyTorch: it was never a
Pallas kernel.

M-RoPE (``rope_kind="mrope"``, qwen2-vl) splits the rotary frequencies
into (t, h, w) sections, each rotated by its own position stream of
``pos [3, B, S]``; it is plain PyTorch, as the reference's is plain jnp.

Caches are updated in place: ``decode_step`` writes the new token's k/v
into the cache it is given, where the reference returns new arrays.  The
cache's ``offset`` (the next write position) is a host ``int``.

Cross-attention (the enc-dec decoder's, ``models/encdec.py``) is
``attention_block`` with ``xkv=`` (k and v projected from the encoder's
output, no RoPE) or with ``static_cache=True`` (fixed k/v precomputed from
it, read and never written).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.modules import Policy, apply_norm, init_norm, normal

__all__ = [
    "HeadLayout",
    "apply_rope",
    "attention_block",
    "decode_attention",
    "flash_attention",
    "head_layout",
    "init_attention",
    "init_kv_cache",
]


# ---------------------------------------------------------------------------
# head layout (pure numpy, as the reference's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    hq: int          # real q heads
    hkv: int         # real kv heads
    hq_p: int        # physical q heads (multiple of tp)
    hkv_p: int       # physical kv heads (multiple of tp, or real if >= tp)
    q_map: tuple     # [hq_p] -> real q index or -1 (dead)
    kv_map: tuple    # [hkv_p] -> real kv index
    qps: int         # q heads per physical kv slot


def head_layout(hq: int, hkv: int, tp: int) -> HeadLayout:
    if hkv >= tp:
        assert hkv % tp == 0, f"kv heads {hkv} not a multiple of tp {tp}"
        hkv_p = hkv
    else:
        assert tp % hkv == 0, f"tp {tp} not a multiple of kv heads {hkv}"
        hkv_p = tp
    r = hkv_p // hkv                       # physical slots per real kv head
    qpr = hq // hkv                        # real q heads per real kv head
    qps = int(np.ceil(qpr / r))            # q heads per physical slot
    hq_p = hkv_p * qps
    q_map = [-1] * hq_p
    kv_map = [0] * hkv_p
    for j in range(hkv):
        for c in range(r):
            s = j * r + c                  # physical kv slot
            kv_map[s] = j
            for t in range(qps):
                rq = c * qps + t           # index within this kv head's q set
                if rq < qpr:
                    q_map[s * qps + t] = j * qpr + rq
    return HeadLayout(hq, hkv, hq_p, hkv_p, tuple(q_map), tuple(kv_map), qps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def _rope_freqs(hd_rot: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd_rot, 2, dtype=np.float64) / hd_rot))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(hd_rot: int, theta: float, device: torch.device) -> torch.Tensor:
    """``_rope_freqs`` as float32 on ``device``, uploaded once: a pageable
    upload in every call would wait for the whole stream."""
    return torch.as_tensor(_rope_freqs(hd_rot, theta).astype(np.float32), device=device)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, *, theta: float, pct: float = 1.0,
               mrope_sections: tuple | None = None) -> torch.Tensor:
    """x ``[B, S, H, hd]``; pos int ``[B, S]``, or ``[3, B, S]`` for M-RoPE
    (``mrope_sections``: the (t, h, w) section sizes, summing to
    ``hd_rot / 2``; frequency section ``i`` is rotated by ``pos[i]``).
    Angles are float32; the rotation runs in x's dtype, as the
    reference's."""
    hd = x.shape[-1]
    hd_rot = int(hd * pct) // 2 * 2
    freqs = _rope_freqs_on(hd_rot, float(theta), x.device)
    if mrope_sections is None:
        angles = pos.to(torch.float32)[..., None] * freqs    # [B, S, hd_rot/2]
    else:
        bounds = np.cumsum((0,) + tuple(mrope_sections)).tolist()
        angles = torch.cat([pos[i].to(torch.float32)[..., None] * freqs[lo:hi]
                            for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))], dim=-1)
    dt = x.dtype
    sin = torch.sin(angles).to(dt)[:, :, None, :]
    cos = torch.cos(angles).to(dt)[:, :, None, :]
    x1, x2 = x[..., : hd_rot // 2], x[..., hd_rot // 2: hd_rot]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot, x[..., hd_rot:]], dim=-1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d: int, lay: HeadLayout, hd: int, *, qk_norm: bool,
                   norm_kind: str, dtype) -> dict:
    wq = normal(gen, (d, lay.hq_p, hd), d**-0.5, dtype)
    dead = torch.as_tensor(np.array(lay.q_map) < 0, device=wq.device)
    wq = torch.where(dead[None, :, None], torch.zeros((), dtype=dtype, device=wq.device), wq)
    p = {
        "wq": wq,
        "wk": normal(gen, (d, lay.hkv, hd), d**-0.5, dtype),
        "wv": normal(gen, (d, lay.hkv, hd), d**-0.5, dtype),
        "wo": normal(gen, (lay.hq_p, hd, d), (lay.hq_p * hd) ** -0.5, dtype),
    }
    if qk_norm:
        p["q_norm"] = init_norm(norm_kind, hd, dtype, wq.device)
        p["k_norm"] = init_norm(norm_kind, hd, dtype, wq.device)
    return p


# ---------------------------------------------------------------------------
# flash attention (the kernel) and decode attention (plain)
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,   # [B, Sq, Hkv_p, qps, hd]
    k: torch.Tensor,   # [B, Sk, Hkv_p, hd]
    v: torch.Tensor,   # [B, Sk, Hkv_p, hd]
    *,
    causal: bool,
    window: int = 0,          # 0 = unbounded
    q_offset: int = 0,        # absolute position of q[0]
    q_chunk: int = 2048,
    kv_chunk: int = 2048,
    block_skip: bool = True,
    p_bf16: bool = False,
) -> torch.Tensor:
    """The reference's signature and layout over the flash kernel, which
    reads these views as they are and writes a contiguous ``[B, Sq, Hkv_p
    * qps * hd]`` buffer (returned as its ``[B, Sq, Hkv_p, qps, hd]`` view);
    the chunk sizes and ``block_skip`` reach only the plain version (CPU).
    Under autograd (an input that requires grad) it goes through
    ``flash_attention_seq_major_grad``, whose backward is the backward
    kernel on the card."""
    b, sq, g, qps, hd = q.shape
    fn = kflash.flash_attention_seq_major
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        fn = kflash.flash_attention_seq_major_grad  # training: the backward kernel
    out = fn(q, k, v, causal=causal, window=window, q_offset=q_offset, p_bf16=p_bf16,
             q_chunk=q_chunk, kv_chunk=kv_chunk, block_skip=block_skip)
    return out.view(b, sq, g, qps, hd)


def decode_attention(
    q: torch.Tensor,        # [B, 1, Hkv_p, qps, hd]
    k_cache: torch.Tensor,  # [B, L, Hkv_p, hd]
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,   # int32 [B, L] position held in each slot (-1 empty)
    pos: torch.Tensor,      # int [B] current decode position
    *,
    window: int = 0,
) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    qf = q.to(torch.float32) * scale
    s = torch.einsum("bqgph,bkgh->bqgpk", qf, k_cache.to(torch.float32))
    ok = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window > 0:
        ok &= kv_pos > (pos[:, None] - window)
    s = torch.where(ok[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqgpk,bkgh->bqgph", p, v_cache.to(torch.float32))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the attention block (prefill / decode)
# ---------------------------------------------------------------------------


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, hd = w.shape
    return torch.matmul(x, w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def physical_kv(k: torch.Tensor, v: torch.Tensor,
                lay: HeadLayout) -> tuple[torch.Tensor, torch.Tensor]:
    """k and v ``[B, S, hkv, hd]`` replicated to the physical kv slots
    ``[B, S, hkv_p, hd]`` (the parameters stay real)."""
    if lay.kv_map != tuple(range(lay.hkv)):
        kv_map = torch.as_tensor(lay.kv_map, device=k.device)
        k, v = k[:, :, kv_map], v[:, :, kv_map]
    return k, v


def attention_block(
    p: dict,
    x: torch.Tensor,          # [B, S, d]
    lay: HeadLayout,
    pol: Policy,
    *,
    pos: torch.Tensor,        # [B, S] (or [3, B, S] for mrope)
    causal: bool = True,
    window: int = 0,
    theta: float = 10_000.0,
    rope_pct: float = 1.0,
    rope_kind: str = "rope",
    mrope_sections: tuple | None = None,
    norm_kind: str = "rmsnorm",
    cache: dict | None = None,   # {"k", "v", "pos", "offset"}
    xkv: torch.Tensor | None = None,  # cross-attention source [B, Sk, d] (enc-dec)
    static_cache: bool = False,  # cache holds fixed k/v (cross-attention): never written
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention for prefill (``S > 1``: flash, then the cache is
    filled) and decode (``S == 1``: the cache is appended to, then read).

    Cross-attention, as the reference's (``repro.models.attention``
    :256-336): ``xkv`` projects k and v from the encoder's output (no RoPE
    on either side); ``static_cache`` reads the fixed k/v of ``cache`` and
    returns it unchanged: flash, non-causal, for ``S > 1``, and decode
    attention at position ``2**30`` (every cached row visible) for ``S ==
    1``.

    ``rope_kind="mrope"`` rotates q and k by ``mrope_sections`` with ``pos
    [3, B, S]``; decode reads its scalar position from ``pos[0]``."""
    b, s = x.shape[:2]
    hd = p["wq"].shape[-1]
    cd = pol.compute_dtype
    rope = rope_kind in ("rope", "mrope") and xkv is None
    rot = dict(theta=theta, pct=rope_pct,
               mrope_sections=mrope_sections if rope_kind == "mrope" else None)

    q = _project(x, p["wq"].to(cd))
    if "q_norm" in p:
        q = apply_norm(p["q_norm"], q, norm_kind)
    if rope and not static_cache:
        q = apply_rope(q, pos, **rot)
    q = pol.shard(q, "act_q")
    pos1 = pos if pos.ndim <= 2 else pos[0]  # [B, S] scalar positions
    qg = q.reshape(b, s, lay.hkv_p, lay.qps, hd)

    if static_cache:
        if s > 1:
            out = flash_attention(qg, cache["k"], cache["v"], causal=False,
                                  q_chunk=pol.attn_q_chunk, kv_chunk=pol.attn_kv_chunk,
                                  block_skip=pol.attn_block_skip, p_bf16=pol.attn_p_bf16)
        else:
            every = torch.full((b,), 2**30, dtype=torch.int32, device=x.device)
            out = decode_attention(qg, cache["k"], cache["v"], cache["pos"], every)
        return _out_proj(out, p, lay, pol), cache

    src = x if xkv is None else xkv
    k = _project(src, p["wk"].to(cd))
    v = _project(src, p["wv"].to(cd))
    if "q_norm" in p:
        k = apply_norm(p["k_norm"], k, norm_kind)
    if rope:
        k = apply_rope(k, pos, **rot)

    k, v = physical_kv(k, v, lay)
    k = pol.shard(k, "act_kv")
    v = pol.shard(v, "act_kv")

    new_cache = None
    if cache is None or s > 1:
        out = flash_attention(qg, k, v, causal=causal, window=window,
                              q_chunk=pol.attn_q_chunk, kv_chunk=pol.attn_kv_chunk,
                              block_skip=pol.attn_block_skip, p_bf16=pol.attn_p_bf16)
        if cache is not None:
            new_cache = _cache_store_prefill(cache, k, v, window)
    else:
        new_cache = _cache_append(cache, k, v, window)
        out = decode_attention(qg, new_cache["k"], new_cache["v"], new_cache["pos"],
                               pos1[:, 0], window=window)

    return _out_proj(out, p, lay, pol), new_cache


def _out_proj(out: torch.Tensor, p: dict, lay: HeadLayout, pol: Policy) -> torch.Tensor:
    """The heads' outputs ``[B, S, Hkv_p, qps, hd]`` through ``wo``."""
    hq_hd = lay.hq_p * p["wq"].shape[-1]
    out = pol.shard(out.reshape(*out.shape[:2], hq_hd), "act_q")
    return torch.matmul(out, p["wo"].to(pol.compute_dtype).reshape(hq_hd, -1))


# ---------------------------------------------------------------------------
# KV caches: full-length and ring-buffer (sliding window)
# ---------------------------------------------------------------------------


def init_kv_cache(b: int, max_len: int, lay: HeadLayout, hd: int, *, window: int = 0,
                  dtype=torch.bfloat16, device=None) -> dict:
    length = min(window, max_len) if window > 0 else max_len
    return {
        "k": torch.zeros((b, length, lay.hkv_p, hd), dtype=dtype, device=device),
        "v": torch.zeros((b, length, lay.hkv_p, hd), dtype=dtype, device=device),
        "pos": torch.full((b, length), -1, dtype=torch.int32, device=device),
        "offset": 0,
    }


def _cache_store_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor, window: int) -> dict:
    """Write a prompt's k/v ``[B, S, H, hd]`` into a fresh cache (in place)."""
    b, s = k.shape[:2]
    length = cache["k"].shape[1]
    if window > 0 and s > length:
        # only the trailing window survives in a ring cache, at slot pos % length
        posv = torch.arange(s - length, s, dtype=torch.int32, device=k.device)
        order = torch.argsort(posv % length, stable=True)
        cache["k"].copy_(k[:, -length:][:, order])
        cache["v"].copy_(v[:, -length:][:, order])
        cache["pos"].copy_(posv[order][None].expand(b, length))
    else:
        cache["k"].zero_()[:, :s] = k
        cache["v"].zero_()[:, :s] = v
        cache["pos"].fill_(-1)[:, :s] = torch.arange(s, dtype=torch.int32, device=k.device)
    cache["offset"] = s
    return cache


def _cache_append(cache: dict, k: torch.Tensor, v: torch.Tensor, window: int) -> dict:
    """Insert one decoded token (k/v ``[B, 1, H, hd]``) at ``offset`` (in place)."""
    off = cache["offset"]
    length = cache["k"].shape[1]
    slot = off % length if window > 0 else min(off, length - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][:, slot] = off
    cache["offset"] = off + 1
    return cache
