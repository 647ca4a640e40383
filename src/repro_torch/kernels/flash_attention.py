"""Flash attention forward (``flash_attention``) for q ``[G, P, Sq, hd]``
over k, v ``[G, Sk, hd]``: the CUDA kernel's wrapper, beside its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_tpu`` and, on the models' prefill path, the jnp chunked
flash it stands in for (``repro.models.attention.flash_attention``).  The
kernel (``csrc/flash_attention.cu``) keeps the online-softmax state of a
64-row q tile in registers while it walks the 64-row kv tiles, skips the
tiles the causal or window mask hides, masks ragged edges itself (any Sq,
Sk) and takes float32 or bf16 inputs with ``hd`` a multiple of 16 up to
256.  It is bounded by operations on an H100.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); on a CUDA tensor it
launches the kernel or raises.  ``flash_attention.launches`` counts the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["MAX_HEAD_DIM", "flash_attention", "flash_attention_plain"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal, window=0, q_offset=0, p_bf16=False,
                          q_chunk=256, kv_chunk=512, block_skip=True):
    """The plain PyTorch version of :func:`flash_attention` (any device)."""
    return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               q_chunk=q_chunk, kv_chunk=kv_chunk, block_skip=block_skip,
                               p_bf16=p_bf16)


def _check(q, k, v, window):
    build.require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention input: need q [G, P, Sq, hd] and k, v "
                         f"[G, Sk, hd], got {list(q.shape)}, {list(k.shape)}, {list(v.shape)}")
    g, p, sq, hd = q.shape
    if k.shape[0] != g or k.shape[2] != hd:
        raise ValueError(f"flash_attention input: k {list(k.shape)} does not match q "
                         f"{list(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention input: q, k, v must all be float32 or all bf16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention input: head_dim {hd} is not a multiple of 16 "
                         f"in [16, {MAX_HEAD_DIM}]")
    if g > 65535 or p > 65535 or max(q.numel(), k.numel()) >= 2**31 or window < 0:
        raise ValueError("flash_attention input: too large for one launch, or window < 0")


def flash_attention(q, k, v, *, causal, window=0, q_offset=0, p_bf16=False,
                    q_chunk=256, kv_chunk=512, block_skip=True):
    """Attention of ``q [G, P, Sq, hd]`` over ``k, v [G, Sk, hd]`` in
    float32, returned in q's type: q row i at position ``q_offset + i``,
    k row j at j; causal keeps ``kpos <= qpos``, ``window > 0`` keeps
    ``kpos > qpos - window``.

    ``q_chunk``, ``kv_chunk`` and ``block_skip`` shape only the plain
    version's loop (its summation order); the kernel tiles 64 x 64 and
    always skips hidden tiles, which is exact.  ``p_bf16`` (bf16 softmax
    weights for the PV product) exists only in the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, p_bf16=p_bf16, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk, block_skip=block_skip)
    if p_bf16:
        raise NotImplementedError(
            "Policy.attn_p_bf16=True has no CUDA kernel yet (ROADMAP.md, queue 1 item 10)")
    _check(q, k, v, window)
    g, p, sq, hd = q.shape
    out = torch.empty_like(q)
    code = build.library().fa_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g, p, sq, k.shape[1], hd,
        _DTYPES[q.dtype], int(bool(causal)), int(window), int(q_offset), hd**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
