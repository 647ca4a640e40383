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
Pallas kernel.  M-RoPE raises ``NotImplementedError`` (ROADMAP.md, queue 1
item 10).

Caches are updated in place: ``decode_step`` writes the new token's k/v
into the cache it is given, where the reference returns new arrays.  The
cache's ``offset`` (the next write position) is a host ``int``.
"""
from __future__ import annotations

import dataclasses

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


def apply_rope(x: torch.Tensor, pos: torch.Tensor, *, theta: float, pct: float = 1.0,
               mrope_sections: tuple | None = None) -> torch.Tensor:
    """x ``[B, S, H, hd]``; pos int ``[B, S]``.  Angles are float32; the
    rotation runs in x's dtype, as the reference's."""
    if mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md, queue 1 item 10)")
    hd = x.shape[-1]
    hd_rot = int(hd * pct) // 2 * 2
    freqs = torch.as_tensor(_rope_freqs(hd_rot, theta).astype(np.float32), device=x.device)
    angles = pos.to(torch.float32)[..., None] * freqs        # [B, S, hd_rot/2]
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
    the chunk sizes and ``block_skip`` reach only the plain version (CPU)."""
    b, sq, g, qps, hd = q.shape
    out = kflash.flash_attention_seq_major(q, k, v, causal=causal, window=window,
                                           q_offset=q_offset, p_bf16=p_bf16, q_chunk=q_chunk,
                                           kv_chunk=kv_chunk, block_skip=block_skip)
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


def attention_block(
    p: dict,
    x: torch.Tensor,          # [B, S, d]
    lay: HeadLayout,
    pol: Policy,
    *,
    pos: torch.Tensor,        # [B, S]
    causal: bool = True,
    window: int = 0,
    theta: float = 10_000.0,
    rope_pct: float = 1.0,
    rope_kind: str = "rope",
    norm_kind: str = "rmsnorm",
    cache: dict | None = None,   # {"k", "v", "pos", "offset"}
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention for prefill (``S > 1``: flash, then the cache is
    filled) and decode (``S == 1``: the cache is appended to, then read).
    Cross-attention (``xkv`` / ``static_cache``) is enc-dec and is not
    ported (ROADMAP.md, queue 1 item 10)."""
    b, s, d = x.shape
    hd = p["wq"].shape[-1]
    cd = pol.compute_dtype
    if rope_kind == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md, queue 1 item 10)")

    q = _project(x, p["wq"].to(cd))
    if "q_norm" in p:
        q = apply_norm(p["q_norm"], q, norm_kind)
    if rope_kind == "rope":
        q = apply_rope(q, pos, theta=theta, pct=rope_pct)
    q = pol.shard(q, "act_q")
    qg = q.reshape(b, s, lay.hkv_p, lay.qps, hd)

    k = _project(x, p["wk"].to(cd))
    v = _project(x, p["wv"].to(cd))
    if "q_norm" in p:
        k = apply_norm(p["k_norm"], k, norm_kind)
    if rope_kind == "rope":
        k = apply_rope(k, pos, theta=theta, pct=rope_pct)

    # replicate kv to the physical layout (params stay real)
    if lay.kv_map != tuple(range(lay.hkv)):
        kv_map = torch.as_tensor(lay.kv_map, device=k.device)
        k, v = k[:, :, kv_map], v[:, :, kv_map]
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
                               pos[:, 0], window=window)

    out = pol.shard(out.reshape(b, s, lay.hq_p * hd), "act_q")
    y = torch.matmul(out, p["wo"].to(cd).reshape(lay.hq_p * hd, d))
    return y, new_cache


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
