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

The backward (``csrc/flash_attention_bwd.cu``) replaces no Pallas kernel:
the reference trains through its jnp flash, which XLA differentiates.  In
bf16 it runs on the tensor cores: the row sums D, then dk and dv (with a
reduce of partials when the P heads are split over blocks), then dq,
taking each row's log-sum-exp from the forward
(``flash_attention_seq_major(..., return_lse=True)``, which the bf16
kernel writes in its epilogue); without it (``p_bf16``, or a caller with
no lse) a stats pass computes it first.  float32 runs the scalar kernels
with their stats pass.  :func:`flash_attention_bwd_seq_major` takes the
models' layout; :func:`flash_attention_bwd_plain` is the plain version (in
the Pallas layout, and :func:`flash_attention_bwd_seq_major_plain` in the
models'), :func:`flash_lse_plain` the plain lse;
:func:`flash_attention_seq_major_plain` is the forward's plain version in
the models' layout.
:func:`flash_attention_seq_major_grad` is the forward as a
``torch.autograd.Function`` whose backward is that kernel on the card and
the plain version on the CPU; ``flash_attention_bwd_seq_major.launches``
counts the backward calls (one a call, for its kernels) and
``.stats_launches`` those of them that ran the stats pass.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

__all__ = ["BWD_HEAD_DIMS", "MAX_HEAD_DIM", "FlashBwdLaunch", "FlashLaunch", "bwd_splits",
           "flash_attention", "flash_attention_bwd_plain", "flash_attention_bwd_seq_major",
           "flash_attention_bwd_seq_major_plain", "flash_attention_plain",
           "flash_attention_seq_major", "flash_attention_seq_major_grad",
           "flash_attention_seq_major_plain", "flash_lse_plain",
           "lse_rows", "pallas_views", "plan", "plan_bwd", "seq_major_views"]

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


def lse_rows(sq: int) -> int:
    """Elements between two (b, g, head) rows of the backward's row
    statistics (lse, D): Sq rounded up to 64, so that the kernels load a
    64-row tile's 256 bytes whole and aligned."""
    return max(64, -(-sq // 64) * 64)


def _lse_buffer(b, g, p, sq, dev):
    """A float32 ``[B, G, P, Sq]`` view of rows of :func:`lse_rows`."""
    return torch.empty((b, g, p, lse_rows(sq)), dtype=torch.float32, device=dev)[..., :sq]


def _launch(q, k, v, out, *, causal, window, q_offset, p_bf16, lse=None):
    """Launch the kernel on the views q, out ``[B, G, P, Sq, hd]`` and k, v
    ``[B, G, Sk, hd]`` (all on one CUDA device); ``lse`` (bf16 without
    ``p_bf16`` only) is a :func:`_lse_buffer` the kernel fills."""
    dev = q.device
    for t in (q, k, v, out):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_attention input: tensor on {t.device}; the kernel path "
                             "takes CUDA tensors on one device only")
    lp = plan(q, k, v, out, window=window, p_bf16=p_bf16)
    if lse is not None and (lp.dtype != 1 or lp.p_bf16):
        raise ValueError("flash_attention: only the bf16 kernel without p_bf16 writes lse (with "
                         "p_bf16 its row sums add rounded weights)")
    lib = build.library()
    code = lib.fa_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), 0 if lse is None else lse.stride(2),
        *lp.dims, lp.dtype, lp.p_bf16, int(bool(causal)), int(window), int(q_offset),
        lp.dims[5] ** -0.5, *lp.c_strides, torch.cuda.current_stream(dev).cuda_stream)
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
                              q_chunk=256, kv_chunk=512, block_skip=True, return_lse=False):
    """:func:`flash_attention` in the models' layout: q ``[B, Sq, G, P, hd]``
    over k, v ``[B, Sk, G, hd]`` (strided views with a dense last
    dimension), returned as ``[B, Sq, G * P * hd]``.  On the card the kernel
    reads the views and writes that output directly.

    ``return_lse`` returns ``(out, lse)`` as well: lse float32 ``[B, G, P,
    Sq]``, each row's log-sum-exp of its scaled, masked scores (+1e30 for a
    row that sees no key), rows :func:`lse_rows` apart, the backward's
    input.  On the card the bf16 kernel writes it in its epilogue (only
    without ``p_bf16``: that mode's row sums add rounded weights); on the
    CPU :func:`flash_lse_plain` computes it."""
    b, sq, g, p, hd = q.shape
    if q.device.type == "cpu":
        out = flash_attention_seq_major_plain(q, k, v, causal=causal, window=window,
                                              q_offset=q_offset, p_bf16=p_bf16,
                                              q_chunk=q_chunk, kv_chunk=kv_chunk,
                                              block_skip=block_skip)
        if not return_lse:
            return out
        lse = flash_lse_plain(q.permute(0, 2, 3, 1, 4).reshape(b * g, p, sq, hd),
                              k.permute(0, 2, 1, 3).reshape(b * g, -1, hd), causal=causal,
                              window=window, q_offset=q_offset)
        buf = _lse_buffer(b, g, p, sq, q.device)
        buf.copy_(lse.reshape(b, g, p, sq))
        return out, buf
    out = q.new_empty((b, sq, g * p * hd))
    lse = _lse_buffer(b, g, p, sq, q.device) if return_lse else None
    _launch(*seq_major_views(q, k, v, out), causal=causal, window=window, q_offset=q_offset,
            p_bf16=p_bf16, lse=lse)
    return (out, lse) if return_lse else out


def flash_attention_seq_major_plain(q, k, v, *, causal, window=0, q_offset=0, p_bf16=False,
                                    q_chunk=256, kv_chunk=512, block_skip=True):
    """:func:`flash_attention_plain` (any device) in the models' layout of
    :func:`flash_attention_seq_major`: ``[B, Sq, G * P * hd]`` out."""
    b, sq, g, p, hd = q.shape
    out = flash_attention_plain(q.permute(0, 2, 3, 1, 4).reshape(b * g, p, sq, hd),
                                k.permute(0, 2, 1, 3).reshape(b * g, -1, hd),
                                v.permute(0, 2, 1, 3).reshape(b * g, -1, hd),
                                causal=causal, window=window, q_offset=q_offset, p_bf16=p_bf16,
                                q_chunk=q_chunk, kv_chunk=kv_chunk, block_skip=block_skip)
    return out.reshape(b, g, p, sq, hd).permute(0, 3, 1, 2, 4).reshape(b, sq, g * p * hd)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

BWD_HEAD_DIMS = (16, 32, 64, 128, 256)  # the backward kernel's templates
_BWD_Q_CHUNK = 512  # q rows a step of the plain backward: bounds its [.., q, Sk] temporaries


def flash_attention_bwd_plain(q, k, v, o, dout, *, causal, window=0, q_offset=0):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` at ``q [G,
    P, Sq, hd]``, ``k, v [G, Sk, hd]``, given its output ``o`` and the
    output's gradient ``dout``: the formulas of the kernel in float32,
    ``_BWD_Q_CHUNK`` q rows at a time, returned in the inputs' types.  The
    softmax weights are the exact float32 ones (``p_bf16`` rounds only the
    forward).  A float64 input is computed in float64 (gradcheck)."""
    g, p, sq, hd = q.shape
    sk = k.shape[1]
    scale = hd**-0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf, vf = k.to(ct), v.to(ct)
    dk = torch.zeros((g, sk, hd), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    kpos = torch.arange(sk, device=q.device)[None, :]
    for q0 in range(0, sq, _BWD_Q_CHUNK):
        q1 = min(q0 + _BWD_Q_CHUNK, sq)
        qb = q[:, :, q0:q1].to(ct) * scale
        s = torch.einsum("gpqh,gkh->gpqk", qb, kf)
        qpos = q_offset + q0 + torch.arange(q1 - q0, device=q.device)[:, None]
        ok = torch.ones((q1 - q0, sk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, NEG_INF)
        pw = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        pw = torch.where(ok, pw, 0.0)
        dob = dout[:, :, q0:q1].to(ct)
        dsum = (dob * o[:, :, q0:q1].to(ct)).sum(dim=-1, keepdim=True)
        ds = pw * (torch.einsum("gpqh,gkh->gpqk", dob, vf) - dsum)
        dv += torch.einsum("gpqk,gpqh->gkh", pw, dob)
        dk += torch.einsum("gpqk,gpqh->gkh", ds, qb)
        dqs.append(torch.einsum("gpqk,gkh->gpqh", ds, kf) * scale)
    dq = torch.cat(dqs, dim=2) if dqs else torch.zeros(q.shape, dtype=ct, device=q.device)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_lse_plain(q, k, *, causal, window=0, q_offset=0):
    """Each row's log-sum-exp of the scaled, masked scores of ``q [G, P, Sq,
    hd]`` over ``k [G, Sk, hd]``, float32 ``[G, P, Sq]`` (float64 for a
    float64 input): the statistic the bf16 forward kernel hands its
    backward.  A row that sees no key gets +1e30 (its softmax weights are
    0 in the backward).  ``_BWD_Q_CHUNK`` q rows at a time."""
    g, p, sq, hd = q.shape
    sk = k.shape[1]
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf = k.to(ct)
    kpos = torch.arange(sk, device=q.device)[None, :]
    rows = []
    for q0 in range(0, sq, _BWD_Q_CHUNK):
        q1 = min(q0 + _BWD_Q_CHUNK, sq)
        s = torch.einsum("gpqh,gkh->gpqk", q[:, :, q0:q1].to(ct) * hd**-0.5, kf)
        qpos = q_offset + q0 + torch.arange(q1 - q0, device=q.device)[:, None]
        ok = torch.ones((q1 - q0, sk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        lse = torch.logsumexp(torch.where(ok, s, NEG_INF), dim=-1)
        rows.append(torch.where(ok.any(dim=-1), lse, -NEG_INF))
    return torch.cat(rows, dim=2) if rows else torch.zeros((g, p, 0), dtype=ct, device=q.device)


def bwd_splits(b, g, p, sk, sms) -> int:
    """Blocks over the group's P heads in the bf16 dk/dv kernel: doubled
    (up to 4, at most P) while the (b, g, 64 kv rows) blocks do not fill
    the card's ``sms`` SMs once (one block an SM).  gemma-2b's layer (B 4,
    G 1, 1,024 keys: 64 blocks) gets 4, Scout's (B 2, G 8: 256) 1.  Each
    split writes float32 partials that a reduce sums in split order, so the
    result depends on the split count, never on the run."""
    blocks = b * g * -(-sk // 64)
    n = 1
    while 2 * n <= min(p, 4) and blocks * n < sms:
        n *= 2
    return n


@dataclasses.dataclass(frozen=True)
class FlashBwdLaunch:
    """The arguments of one backward launch sequence, from shapes and
    strides alone."""
    dtype: int           # 0 float32, 1 bf16
    dims: tuple          # (B, G, P, Sq, Sk, hd)
    strides: tuple       # q, k, v, o, dout, dq, dk, dv element strides

    @functools.cached_property
    def c_strides(self) -> list:
        return [(ctypes.c_int64 * len(st))(*st) for st in self.strides]


def plan_bwd(q, k, v, o, dout, dq, dk, dv) -> FlashBwdLaunch:
    """Check q, o, dout, dq ``[B, G, P, Sq, hd]`` and k, v, dk, dv ``[B, G,
    Sk, hd]`` (strided views, the last dimension dense, one type) and
    return the launch's arguments; raises
    ``ValueError`` on what the kernels do not take.  bf16 inputs are read
    by TMA (and o by 16-byte loads), so their strides must be positive
    multiples of 8 elements; the outputs are stored in pairs, so theirs
    must be even."""
    return _plan_bwd(tuple((t.dtype, tuple(t.shape), t.stride())
                           for t in (q, k, v, o, dout, dq, dk, dv)))


@functools.lru_cache(maxsize=512)
def _plan_bwd(specs) -> FlashBwdLaunch:
    names = ("q", "k", "v", "o", "dout", "dq", "dk", "dv")
    (qdt, qsh, _), (_, ksh, _) = specs[0], specs[1]
    if len(qsh) != 5 or len(ksh) != 4:
        raise ValueError(f"flash_attention_bwd input: need q [B, G, P, Sq, hd] and k "
                         f"[B, G, Sk, hd], got {list(qsh)}, {list(ksh)}")
    for name, (dt, sh, _) in zip(names, specs):
        want = qsh if name in ("q", "o", "dout", "dq") else ksh
        if sh != want:
            raise ValueError(f"flash_attention_bwd input: {name} {list(sh)} does not match "
                             f"{list(want)}")
        if dt != qdt or dt not in _DTYPES:
            raise ValueError(f"flash_attention_bwd input: every tensor must be float32 or "
                             f"every one bf16, got {name} {dt} beside q {qdt}")
    b, g, p, sq, hd = qsh
    if tuple(ksh[:2]) != (b, g) or ksh[3] != hd:
        raise ValueError(f"flash_attention_bwd input: k {list(ksh)} does not match "
                         f"q {list(qsh)}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd input: head_dim {hd} is not one of "
                         f"{BWD_HEAD_DIMS}")
    if b * g > 65535 or p > 65535 or max(sq, ksh[2]) >= 2**31 - 128:
        raise ValueError("flash_attention_bwd input: too large for one launch")
    tma = qdt == torch.bfloat16
    strides = tuple(_strides(sh, st, name, hd, tma and name in ("q", "k", "v", "o", "dout"))
                    for name, (_, sh, st) in zip(names, specs))
    if tma and any(st % 2 for st in sum(strides[5:], ())):
        raise ValueError("flash_attention_bwd input: bf16 dq, dk, dv strides must be even "
                         "(pairs are stored)")
    return FlashBwdLaunch(_DTYPES[qdt], (b, g, p, sq, ksh[2], hd), strides)


@functools.lru_cache(maxsize=16)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_lse(lse, shape):
    """Raise unless ``lse`` is laid out as the forward writes it (and the
    kernels read it): float32 ``[B, G, P, Sq]``, rows of :func:`lse_rows`
    or more (a multiple of 4) elements apart over dense ``(B, G, P)``,
    16-byte aligned."""
    b, g, p, sq = shape
    st = lse.stride()
    if (tuple(lse.shape) != shape or lse.dtype != torch.float32 or (sq > 1 and st[3] != 1)
            or st[2] < lse_rows(sq) or st[2] % 4 or st[1] != p * st[2] or st[0] != g * st[1]
            or lse.data_ptr() % 16):
        raise ValueError(f"flash_attention_bwd input: lse must be the forward's float32 "
                         f"{list(shape)} (rows lse_rows(Sq) apart), got {lse.dtype} "
                         f"{list(lse.shape)} with strides {list(st)}")


def _launch_bwd(q, k, v, o, dout, dq, dk, dv, *, causal, window, q_offset, lse=None):
    """Launch the backward on views q, o, dout, dq ``[B, G, P, Sq, hd]``
    and k, v, dk, dv ``[B, G, Sk, hd]`` (all on one CUDA device); ``lse``
    (bf16 only) is the forward's, else the stats pass computes it."""
    dev = q.device
    for t in (q, k, v, o, dout, dq, dk, dv):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_attention_bwd input: tensor on {t.device}; the kernel "
                             "path takes CUDA tensors on one device only")
    if window < 0:
        raise ValueError("flash_attention_bwd input: window < 0")
    lp = plan_bwd(q, k, v, o, dout, dq, dk, dv)  # raises on what the kernels do not take
    lib = build.library()
    b, g, p, sq, sk, hd = lp.dims
    nsplit = bwd_splits(b, g, p, sk, _sm_count(dev)) if lp.dtype == 1 else 1
    if lp.dtype == 1 and any(t.data_ptr() % 16 for t in (q, k, v, o, dout)):
        raise ValueError("flash_attention_bwd input: bf16 q, k, v, o and dout must start on "
                         "16-byte boundaries (TMA and 16-byte loads read them)")
    if lse is not None:
        if lp.dtype != 1:
            raise ValueError("flash_attention_bwd input: lse is taken by the bf16 kernels only "
                             "(float32 runs its stats pass)")
        _check_lse(lse, (b, g, p, sq))
    stats = lse is None
    if stats:
        lse = _lse_buffer(b, g, p, sq, dev)
    dsum = _lse_buffer(b, g, p, sq, dev)
    part = (torch.empty((2, nsplit, b, g, sk, hd), dtype=torch.float32, device=dev)
            if nsplit > 1 else None)
    code = lib.fa_flash_backward(
        *(t.data_ptr() for t in (q, k, v, o, dout, dq, dk, dv, lse, dsum)),
        None if part is None else part.data_ptr(), *lp.dims, lp.dtype, int(bool(causal)),
        int(window), int(q_offset), hd**-0.5, lse.stride(2), int(not stats), nsplit,
        *lp.c_strides, torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "flash_attention_bwd")
    flash_attention_bwd_seq_major.launches += 1
    flash_attention_bwd_seq_major.stats_launches += int(stats)


def _tma_ready(t) -> bool:
    """May TMA read the bf16 view ``t`` as it is: dense last dimension,
    other strides positive multiples of 8 elements, a 16-byte aligned
    start?"""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and
            all(n == 1 or (st > 0 and st % 8 == 0) for n, st in zip(t.shape[:-1], t.stride()[:-1])))


def flash_attention_bwd_seq_major(q, k, v, o, dout, *, causal, window=0, q_offset=0, lse=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_seq_major`, in the inputs'
    type: q ``[B, Sq, G, P, hd]``, k, v ``[B, Sk, G, hd]``, its output o and
    the output's gradient dout ``[B, Sq, G * P * hd]``; returns dq ``[B, Sq,
    G, P, hd]`` and dk, dv ``[B, Sk, G, hd]``.  On the card the kernels
    read the views and write those layouts directly; on the CPU the plain
    version runs.  ``lse``: the forward's row statistics
    (``flash_attention_seq_major(..., return_lse=True)``), which spare the
    bf16 kernels their stats pass; the plain version recomputes them."""
    o, dout = o.reshape(q.shape), dout.reshape(q.shape)
    if q.device.type == "cpu":
        return flash_attention_bwd_seq_major_plain(q, k, v, o, dout, causal=causal,
                                                   window=window, q_offset=q_offset)
    if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16 and not _tma_ready(dout)):
        dout = dout.contiguous()  # autograd may hand in any layout
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    qv = lambda t: t.permute(0, 2, 3, 1, 4)
    kv = lambda t: t.permute(0, 2, 1, 3)
    _launch_bwd(qv(q), kv(k), kv(v), qv(o), qv(dout), qv(dq), kv(dk), kv(dv), causal=causal,
                window=window, q_offset=q_offset, lse=lse)
    return dq, dk, dv


flash_attention_bwd_seq_major.launches = 0
flash_attention_bwd_seq_major.stats_launches = 0


def flash_attention_bwd_seq_major_plain(q, k, v, o, dout, *, causal, window=0, q_offset=0):
    """:func:`flash_attention_bwd_plain` (any device) in the models' layout
    of :func:`flash_attention_bwd_seq_major`."""
    b, sq, g, p, hd = q.shape
    sk = k.shape[1]
    to_pallas = lambda t: t.reshape(q.shape).permute(0, 2, 3, 1, 4).reshape(b * g, p, sq, hd)
    kv = lambda t: t.permute(0, 2, 1, 3).reshape(b * g, sk, hd)
    dq, dk, dv = flash_attention_bwd_plain(to_pallas(q), kv(k), kv(v), to_pallas(o),
                                           to_pallas(dout), causal=causal, window=window,
                                           q_offset=q_offset)
    back = lambda t: t.reshape(b, g, sk, hd).permute(0, 2, 1, 3)
    return dq.reshape(b, g, p, sq, hd).permute(0, 3, 1, 2, 4), back(dk), back(dv)


class _FlashSeqMajor(torch.autograd.Function):
    """:func:`flash_attention_seq_major` with its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        lse = None
        if q.device.type == "cuda" and q.dtype == torch.bfloat16 and not kw["p_bf16"]:
            out, lse = flash_attention_seq_major(q, k, v, return_lse=True, **kw)
        else:
            out = flash_attention_seq_major(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (kw["causal"], kw["window"], kw["q_offset"])
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        extra = {} if lse is None else {"lse": lse}  # the forward's row statistics
        dq, dk, dv = flash_attention_bwd_seq_major(q, k, v, out, dout, causal=causal,
                                                   window=window, q_offset=q_offset, **extra)
        return dq, dk, dv, None


def flash_attention_seq_major_grad(q, k, v, *, causal, window=0, q_offset=0, p_bf16=False,
                                   q_chunk=256, kv_chunk=512, block_skip=True):
    """:func:`flash_attention_seq_major` under autograd: the same forward,
    and a backward that is the CUDA kernel on the card and the plain
    version on the CPU, never autograd through the plain forward."""
    return _FlashSeqMajor.apply(q, k, v, dict(
        causal=causal, window=window, q_offset=q_offset, p_bf16=p_bf16, q_chunk=q_chunk,
        kv_chunk=kv_chunk, block_skip=block_skip))
