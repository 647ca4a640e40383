"""Flash attention forward: the CUDA kernel's wrappers, beside their plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_tpu`` and, on the models' prefill path, the jnp chunked
flash it stands in for (``repro.models.attention.flash_attention``).  Two
entries share one kernel launch:

* :func:`flash_attention` takes the Pallas layout, q ``[G, P, Sq, hd]``
  over k, v ``[G, Sk, hd]``, so it stays comparable with
  ``flash_attention_tpu``;
* :func:`flash_attention_seq_major` takes the models' layout, q
  ``[B, Sq, G, P, hd]`` over k, v ``[B, Sk, G, hd]``, as strided views, and
  writes the output straight into ``[B, Sq, G * P * hd]``: no copy before
  or after the kernel.

The kernel (``csrc/flash_attention.cu``) is chosen by the inputs' type,
explicitly: bf16 goes to the tensor-core kernel (wgmma with TMA loads),
float32 to the scalar float32 kernel; ``p_bf16`` (``Policy.attn_p_bf16``)
is a mode of both.  A call the chosen kernel cannot take raises.  Both
take any Sq and Sk, causal and/or window masks, ``q_offset``, and ``hd`` a
multiple of 16 up to 256.  :func:`pallas_views` and :func:`seq_major_views`
give the kernel's strided views of either layout, and :func:`plan` computes
what the wrapper hands the kernel from their shapes and strides alone,
touching no data.

On a CPU tensor a wrapper runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); on a CUDA tensor it
launches the kernel or raises.  ``flash_attention.launches`` counts the
launches of both entries.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["MAX_HEAD_DIM", "FlashLaunch", "flash_attention", "flash_attention_plain",
           "flash_attention_seq_major", "pallas_views", "plan", "seq_major_views"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {torch.float32: "scalar_f32", torch.bfloat16: "wgmma_bf16"}


def flash_attention_plain(q, k, v, *, causal, window=0, q_offset=0, p_bf16=False,
                          q_chunk=256, kv_chunk=512, block_skip=True):
    """The plain PyTorch version of :func:`flash_attention` (any device)."""
    return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               q_chunk=q_chunk, kv_chunk=kv_chunk, block_skip=block_skip,
                               p_bf16=p_bf16)


@dataclasses.dataclass(frozen=True)
class FlashLaunch:
    """The arguments of one kernel launch, from shapes and strides alone."""
    kernel: str          # "wgmma_bf16" (tensor cores) or "scalar_f32"
    dtype: int           # the C entry's code: 0 float32, 1 bf16
    p_bf16: int
    dims: tuple          # (B, G, P, Sq, Sk, hd)
    q_strides: tuple     # elements: (batch, group, head, row)
    k_strides: tuple     # elements: (batch, group, row)
    v_strides: tuple
    o_strides: tuple     # as q's

    @functools.cached_property
    def c_strides(self) -> list:
        """The four stride arrays as the C entry takes them."""
        return [(ctypes.c_int64 * len(st))(*st)
                for st in (self.q_strides, self.k_strides, self.v_strides, self.o_strides)]


def _strides(shape, stride, what, hd, tma):
    """Element strides without the last dimension, which must be dense.  A
    dimension of size 1 gets stride ``hd`` (any stride is right for it; TMA
    wants a positive multiple of 16 bytes)."""
    if shape[-1] > 1 and stride[-1] != 1:
        raise ValueError(f"flash_attention input: {what}'s last dimension must be contiguous "
                         f"(stride {stride[-1]})")
    out = []
    for n, st in zip(shape[:-1], stride[:-1]):
        if n == 1:
            st = hd
        elif tma and (st <= 0 or st % 8):
            raise ValueError(f"flash_attention input: bf16 {what} strides {list(stride)} are "
                             "not positive multiples of 8 elements (16 bytes), which the TMA "
                             "loads need")
        out.append(int(st))
    return tuple(out)


def plan(q, k, v, out, *, window=0, p_bf16=False) -> FlashLaunch:
    """Check q, out ``[B, G, P, Sq, hd]`` and k, v ``[B, G, Sk, hd]``
    (strided views, the last dimension dense) and return the launch's
    arguments; raises ``ValueError`` on what the kernels do not take."""
    return _plan(*((t.dtype, tuple(t.shape), t.stride()) for t in (q, k, v, out)),
                 int(window), bool(p_bf16))


@functools.lru_cache(maxsize=512)
def _plan(q, k, v, out, window, p_bf16) -> FlashLaunch:
    """:func:`plan` on (dtype, shape, strides) triples: the same shapes
    recur on every layer of a model, so their checks run once."""
    (qdt, qsh, qst), (kdt, ksh, kst), (vdt, vsh, vst), (odt, osh, ost) = q, k, v, out
    if len(qsh) != 5 or len(ksh) != 4 or vsh != ksh or osh != qsh:
        raise ValueError(f"flash_attention input: need q, out [B, G, P, Sq, hd] and k, v "
                         f"[B, G, Sk, hd], got {list(qsh)}, {list(ksh)}, {list(vsh)}, "
                         f"{list(osh)}")
    if qdt not in _DTYPES or any(dt != qdt for dt in (kdt, vdt, odt)):
        raise ValueError(f"flash_attention input: q, k, v must all be float32 or all bf16, "
                         f"got {qdt}, {kdt}, {vdt}")
    b, g, p, sq, hd = qsh
    tma = qdt == torch.bfloat16
    strides = [_strides(sh, st, name, hd, tma)
               for sh, st, name in ((qsh, qst, "q"), (ksh, kst, "k"), (vsh, vst, "v"))]
    strides.append(_strides(osh, ost, "out", hd, False))
    if tuple(ksh[:2]) != (b, g) or ksh[3] != hd:
        raise ValueError(f"flash_attention input: k {list(ksh)} does not match q {list(qsh)}")
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention input: head_dim {hd} is not a multiple of 16 "
                         f"in [16, {MAX_HEAD_DIM}]")
    if (b * g > 65535 or p > 65535 or max(sq, ksh[2]) >= 2**31 - 128
            or b * g * p * (sq // 128 + 1) >= 2**31 or window < 0):
        raise ValueError("flash_attention input: too large for one launch, or window < 0")
    if any(st % 2 for st in strides[3]):
        raise ValueError("flash_attention input: out strides must be even (pairs are stored)")
    return FlashLaunch(_KERNELS[qdt], _DTYPES[qdt], int(p_bf16), (b, g, p, sq, ksh[2], hd),
                       *strides)


def _launch(q, k, v, out, *, causal, window, q_offset, p_bf16):
    """Launch the kernel on the views q, out ``[B, G, P, Sq, hd]`` and k, v
    ``[B, G, Sk, hd]`` (all on one CUDA device)."""
    dev = q.device
    for t in (q, k, v, out):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_attention input: tensor on {t.device}; the kernel path "
                             "takes CUDA tensors on one device only")
    lp = plan(q, k, v, out, window=window, p_bf16=p_bf16)
    lib = build.library()
    code = lib.fa_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lp.dims, lp.dtype, lp.p_bf16,
        int(bool(causal)), int(window), int(q_offset), lp.dims[5] ** -0.5, *lp.c_strides,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, f"flash_attention ({lp.kernel})")
    flash_attention.launches += 1


def pallas_views(q, k, v, out):
    """The kernel's views of the Pallas layout: q, out ``[G, P, Sq, hd]``
    and k, v ``[G, Sk, hd]`` as ``[1, G, P, Sq, hd]`` and ``[1, G, Sk, hd]``."""
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention input: need q [G, P, Sq, hd] and k, v "
                         f"[G, Sk, hd], got {list(q.shape)}, {list(k.shape)}, {list(v.shape)}")
    return q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0), out.unsqueeze(0)


def seq_major_views(q, k, v, out):
    """The kernel's views of the models' layout: q ``[B, Sq, G, P, hd]``,
    k, v ``[B, Sk, G, hd]`` and out ``[B, Sq, G * P * hd]`` as
    ``[B, G, P, Sq, hd]`` and ``[B, G, Sk, hd]``, without a copy."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention input: need q [B, Sq, G, P, hd] and k, v "
                         f"[B, Sk, G, hd], got {list(q.shape)}, {list(k.shape)}, "
                         f"{list(v.shape)}")
    return (q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            out.view(q.shape).permute(0, 2, 3, 1, 4))


def flash_attention(q, k, v, *, causal, window=0, q_offset=0, p_bf16=False,
                    q_chunk=256, kv_chunk=512, block_skip=True):
    """Attention of ``q [G, P, Sq, hd]`` over ``k, v [G, Sk, hd]`` in
    float32, returned in q's type: q row i at position ``q_offset + i``,
    k row j at j; causal keeps ``kpos <= qpos``, ``window > 0`` keeps
    ``kpos > qpos - window``; ``p_bf16`` rounds the softmax weights to bf16
    for the PV product, as the jnp flash does.

    ``q_chunk``, ``kv_chunk`` and ``block_skip`` shape only the plain
    version's loop (its summation order); the kernels tile 64 or 128 q rows
    by 64 kv rows and always skip hidden tiles, which is exact."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, p_bf16=p_bf16, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk, block_skip=block_skip)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(*pallas_views(q, k, v, out), causal=causal, window=window, q_offset=q_offset,
            p_bf16=p_bf16)
    return out


flash_attention.launches = 0


def flash_attention_seq_major(q, k, v, *, causal, window=0, q_offset=0, p_bf16=False,
                              q_chunk=256, kv_chunk=512, block_skip=True):
    """:func:`flash_attention` in the models' layout: q ``[B, Sq, G, P, hd]``
    over k, v ``[B, Sk, G, hd]`` (strided views with a dense last
    dimension), returned as ``[B, Sq, G * P * hd]``.  On the card the kernel
    reads the views and writes that output directly."""
    b, sq, g, p, hd = q.shape
    if q.device.type == "cpu":
        out = flash_attention_plain(q.permute(0, 2, 3, 1, 4).reshape(b * g, p, sq, hd),
                                    k.permute(0, 2, 1, 3).reshape(b * g, -1, hd),
                                    v.permute(0, 2, 1, 3).reshape(b * g, -1, hd),
                                    causal=causal, window=window, q_offset=q_offset,
                                    p_bf16=p_bf16, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                    block_skip=block_skip)
        return out.reshape(b, g, p, sq, hd).permute(0, 3, 1, 2, 4).reshape(b, sq, g * p * hd)
    out = q.new_empty((b, sq, g * p * hd))
    _launch(*seq_major_views(q, k, v, out), causal=causal, window=window, q_offset=q_offset,
            p_bf16=p_bf16)
    return out
