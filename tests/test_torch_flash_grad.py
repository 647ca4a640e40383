"""The flash-attention backward's plain version and its autograd wiring,
held against ``jax.grad`` of the reference's jnp flash on the CPU.

The kernel itself (``csrc/flash_attention_bwd.cu``) runs only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 19 (d)); here its
plain version ``flash_attention_bwd_plain`` and the
``torch.autograd.Function`` the models train through are checked, from
numpy inputs made from seeds.  Tolerances: float32 grads within rtol
1e-4, atol 1e-5 (XLA's and torch's sums in another order).  With
``p_bf16`` the reference differentiates through its bf16 rounding of the
softmax weights, while the port's backward takes the exact float32
weights and only the forward's output (in ``D = rowsum(dO * o)``) carries
the rounding: dv, which sees no ``D``, equals the exact reference's
within the float32 tolerance, and dq and dk lie within 3e-2 x max(1,
|ref|) of the reference's own p_bf16 grads (both round 8-bit weights,
in different places, over up to 50 keys; measured at most 2.3e-2).
``gradcheck`` runs in float64 at a tiny size.  The row statistic the bf16
forward kernel hands its backward (lse, ``flash_lse_plain``) is held to
``jax.nn.logsumexp`` of the reference's masked scores within 1e-6, and the
backward's launch plan (``plan_bwd``: TMA's stride rules for bf16, the
head splits) is checked from shapes and strides alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro.models import modules as jmod
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import attention as tatt
from repro_torch.models import modules as tmod

RTOL, ATOL = 1e-4, 1e-5
BF16_REL = 3e-2

# name -> (B, Sq, Sk, G, P, hd, causal, window, q_offset)
CASES = {
    "causal": (2, 40, 40, 2, 3, 16, True, 0, 0),
    "window": (1, 50, 50, 1, 4, 32, True, 12, 0),
    "noncausal_gqa": (2, 24, 33, 3, 2, 16, False, 0, 0),
    "offset": (1, 20, 36, 2, 2, 16, True, 0, 16),
    "one_head": (3, 17, 17, 1, 1, 64, True, 5, 0),
}


def _inputs(case, seed=0):
    b, sq, sk, g, p, hd = CASES[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, sq, g, p, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, sk, g, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, g, hd)).astype(np.float32)
    dout = rng.normal(0, 1, (b, sq, g, p, hd)).astype(np.float32)
    return q, k, v, dout


def _reference_grads(case, p_bf16, chunk=16):
    causal, window, q_offset = CASES[case][6:]
    q, k, v, dout = _inputs(case)

    def f(q, k, v):
        out = jatt.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   q_chunk=chunk, kv_chunk=chunk, p_bf16=p_bf16)
        return jnp.sum(out * dout)

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _close(got, want, p_bf16):
    got = got.detach().double().numpy()
    if p_bf16:
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= BF16_REL, err.max()
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p_bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_autograd_matches_jax_grad(case, p_bf16):
    """The models' flash (``attention.flash_attention`` under autograd, the
    plain backward on the CPU) against ``jax.grad`` of the jnp flash."""
    causal, window, q_offset = CASES[case][6:]
    q, k, v, dout = _inputs(case)
    tq, tk, tv = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=q_offset,
                               q_chunk=16, kv_chunk=16, p_bf16=p_bf16)
    got = torch.autograd.grad((out * torch.as_tensor(dout)).sum(), (tq, tk, tv))
    for g, w in zip(got, _reference_grads(case, p_bf16)):
        _close(g, w, p_bf16)
    if p_bf16:  # dv sees the exact float32 weights
        _close(got[2], _reference_grads(case, False)[2], False)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_in_the_pallas_layout(case):
    """``flash_attention_bwd_plain`` in the Pallas layout, given the
    forward's output, against ``jax.grad`` of the jnp flash."""
    b, sq, sk, g, p, hd, causal, window, q_offset = CASES[case]
    q, k, v, dout = (torch.as_tensor(x) for x in _inputs(case))
    to_pallas = lambda t: t.permute(0, 2, 3, 1, 4).reshape(b * g, p, sq, hd)
    kv = lambda t: t.permute(0, 2, 1, 3).reshape(b * g, sk, hd)
    o = kflash.flash_attention(to_pallas(q), kv(k), kv(v), causal=causal, window=window,
                               q_offset=q_offset)
    dq, dk, dv = kflash.flash_attention_bwd_plain(to_pallas(q), kv(k), kv(v), o,
                                                  to_pallas(dout), causal=causal,
                                                  window=window, q_offset=q_offset)
    want = _reference_grads(case, False)
    np.testing.assert_allclose(dq.reshape(b, g, p, sq, hd).permute(0, 3, 1, 2, 4).numpy(),
                               want[0], rtol=RTOL, atol=ATOL)
    for got, w in ((dk, want[1]), (dv, want[2])):
        np.testing.assert_allclose(got.reshape(b, g, sk, hd).permute(0, 2, 1, 3).numpy(), w,
                                   rtol=RTOL, atol=ATOL)


def test_plain_backward_across_q_chunks():
    """A sequence longer than the plain backward's q chunk (``_BWD_Q_CHUNK``
    rows, as every 1,024-token training layer is): the chunks' dk and dv
    sums and their masks at the seams against ``jax.grad``."""
    sq = kflash._BWD_Q_CHUNK + 88
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (1, sq, 1, 2, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, sq, 1, 16)).astype(np.float32) for _ in range(2))
    dout = rng.normal(0, 1, q.shape).astype(np.float32)
    kw = dict(causal=True, window=100, q_offset=0)

    def f(q, k, v):
        out = jatt.flash_attention(q, k, v, q_chunk=128, kv_chunk=128, **kw)
        return jnp.sum(out * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    o = kflash.flash_attention_seq_major(tq, tk, tv, **kw)
    got = kflash.flash_attention_bwd_seq_major(tq, tk, tv, o,
                                               torch.as_tensor(dout).reshape(1, sq, -1), **kw)
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["causal", "window", "noncausal_gqa", "offset"])
def test_gradcheck_float64(case):
    """``torch.autograd.gradcheck`` of the autograd Function in float64 at
    a small size (the plain forward and backward compute float64 inputs in
    float64)."""
    causal, window, q_offset = CASES[case][6:]
    g, p = min(CASES[case][3], 2), min(CASES[case][4], 2)
    rng = np.random.default_rng(5)
    sq, sk = 6, 6 + min(q_offset, 3)
    mk = lambda *shape: torch.as_tensor(rng.normal(0, 1, shape)).requires_grad_()
    q, k, v = mk(1, sq, g, p, 4), mk(1, sk, g, 4), mk(1, sk, g, 4)

    def f(q, k, v):
        return kflash.flash_attention_seq_major_grad(q, k, v, causal=causal, window=min(window, 4),
                                                     q_offset=min(q_offset, 3), q_chunk=4,
                                                     kv_chunk=4)

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-7, rtol=1e-5)


def test_backward_runs_the_backward_function(monkeypatch):
    """Under autograd the models' flash takes the backward wrapper once per
    call, and never differentiates through the plain forward."""
    calls = []
    real = kflash.flash_attention_bwd_seq_major

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(kflash, "flash_attention_bwd_seq_major", spy)
    q, k, v, dout = (torch.as_tensor(x) for x in _inputs("causal"))
    q.requires_grad_()
    out = tatt.flash_attention(q, k, v, causal=True)
    fns = [out.grad_fn] + [f for f, _ in out.grad_fn.next_functions]
    assert any("FlashSeqMajor" in type(f).__name__ for f in fns if f is not None), fns
    (out * dout).sum().backward()
    assert calls == [{"causal": True, "window": 0, "q_offset": 0}]
    with torch.no_grad():
        assert tatt.flash_attention(q, k, v, causal=True).grad_fn is None


def _attention_params(rng, d, lay, hd):
    return {"wq": rng.normal(0, d**-0.5, (d, lay.hq_p, hd)).astype(np.float32),
            "wk": rng.normal(0, d**-0.5, (d, lay.hkv, hd)).astype(np.float32),
            "wv": rng.normal(0, d**-0.5, (d, lay.hkv, hd)).astype(np.float32),
            "wo": rng.normal(0, (lay.hq_p * hd) ** -0.5, (lay.hq_p, hd, d)).astype(np.float32),
            "q_norm": {"w": rng.normal(0, 0.1, (hd,)).astype(np.float32)},
            "k_norm": {"w": rng.normal(0, 0.1, (hd,)).astype(np.float32)}}


@pytest.mark.parametrize("hq,hkv,tp,window", [(4, 2, 1, 0), (4, 1, 2, 0), (6, 2, 4, 8)])
def test_attention_block_grads_match_reference(hq, hkv, tp, window):
    """The training path of ``attention_block`` (no cache), with the kv
    heads gathered to the physical layout when ``tp`` replicates them: the
    gradient of the gather is a scatter-add over the physical kv heads."""
    rng = np.random.default_rng(7)
    b, s, d, hd = 2, 24, 32, 16
    lay = jatt.head_layout(hq, hkv, tp)
    assert tatt.head_layout(hq, hkv, tp) == tatt.HeadLayout(*jax.tree.leaves(
        [lay.hq, lay.hkv, lay.hq_p, lay.hkv_p]), lay.q_map, lay.kv_map, lay.qps)
    p = _attention_params(rng, d, lay, hd)
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    cot = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jpol = jmod.Policy(attn_q_chunk=8, attn_kv_chunk=8)
    tpol = tmod.Policy(attn_q_chunk=8, attn_kv_chunk=8)

    def jf(p, x):
        y, _ = jatt.attention_block(p, x, lay, jpol, pos=jnp.asarray(pos), window=window)
        return jnp.sum(y * cot)

    jg = jax.grad(jf, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp_ = jax.tree.map(lambda a: torch.as_tensor(a).requires_grad_(), p)
    tx = torch.as_tensor(x).requires_grad_()
    y, _ = tatt.attention_block(tp_, tx, tatt.head_layout(hq, hkv, tp), tpol,
                                pos=torch.as_tensor(pos.copy()), window=window)
    leaves = jax.tree.leaves(tp_) + [tx]
    got = torch.autograd.grad((y * torch.as_tensor(cot)).sum(), leaves)
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


LSE_CASES = {  # name -> (B, Sq, Sk, G, P, hd, causal, window, q_offset)
    "causal": (2, 70, 70, 2, 3, 32, True, 0, 0),
    "window": (1, 90, 90, 1, 4, 16, True, 20, 0),
    "noncausal": (2, 33, 51, 3, 2, 16, False, 0, 0),
    "offset": (1, 20, 36, 2, 2, 64, True, 0, 16),
    "no_key": (1, 12, 8, 1, 2, 16, True, 3, 6),  # rows at positions >= 10 see no key
}


def _reference_lse(q, k, causal, window, q_offset):
    """``jax.nn.logsumexp`` of the reference's masked scores (as
    ``repro.models.attention.flash_attention`` masks them: scaled q . k,
    hidden pairs at NEG_INF), ``[B, Sq, G, P]``."""
    hd = q.shape[-1]
    s = jnp.einsum("bqgph,bkgh->bqgpk", jnp.asarray(q) * hd**-0.5, jnp.asarray(k))
    qpos = q_offset + jnp.arange(q.shape[1])[:, None]
    kpos = jnp.arange(k.shape[1])[None, :]
    ok = jnp.ones((q.shape[1], k.shape[1]), bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    s = jnp.where(ok[None, :, None, None, :], s, jatt.NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)), np.asarray(ok.any(axis=-1))


@pytest.mark.parametrize("case", list(LSE_CASES))
def test_plain_lse_matches_jax_logsumexp(case):
    """The forward's lse on the CPU (``flash_attention_seq_major(...,
    return_lse=True)``, i.e. ``flash_lse_plain``) against
    ``jax.nn.logsumexp`` of the reference's jnp masked scores, within 1e-6;
    a row that sees no key holds +1e30 (the backward gives it P = 0)."""
    b, sq, sk, g, p, hd, causal, window, q_offset = LSE_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.normal(0, 1, (b, sq, g, p, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, sk, g, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, g, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, lse = kflash.flash_attention_seq_major(torch.as_tensor(q), torch.as_tensor(k),
                                              torch.as_tensor(v), return_lse=True, **kw)
    assert lse.shape == (b, g, p, sq) and lse.dtype == torch.float32
    assert lse.stride(2) == kflash.lse_rows(sq) and lse.stride(2) % 64 == 0
    want, seen = _reference_lse(q, k, causal, window, q_offset)
    got = lse.permute(0, 3, 1, 2).numpy()
    np.testing.assert_allclose(got[:, seen], want[:, seen], rtol=0, atol=1e-6)
    assert (got[:, ~seen] == 1e30).all()
    if case == "no_key":
        assert (~seen).any()


def _views(b, sq, sk, g, p, hd, dtype, pad=0):
    """The models' layout as the backward's kernels see it: q, o, dout, dq
    ``[B, G, P, Sq, hd]`` and k, v, dk, dv ``[B, G, Sk, hd]`` as strided
    views (``pad`` extra elements at the end of every row)."""
    def qv():
        return torch.zeros((b, sq, g, p, hd + pad), dtype=dtype)[..., :hd].permute(0, 2, 3, 1, 4)

    def kv():
        return torch.zeros((b, sk, g, hd + pad), dtype=dtype)[..., :hd].permute(0, 2, 1, 3)

    return qv(), kv(), kv(), qv(), qv(), qv(), kv(), kv()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1024, 1024, 1, 8, 256), (2, 1024, 1024, 8, 5, 128),
                                   (1, 37, 101, 2, 2, 32), (3, 70, 45, 3, 1, 16)])
def test_plan_bwd_takes_the_models_views(shape, dtype):
    """``plan_bwd`` on the views ``flash_attention_bwd_seq_major`` hands the
    kernels (the models' seq-major tensors, permuted): the dims, the
    element strides; and the head splits of the bf16 dk/dv kernel at the
    training layers' shapes on 132 SMs."""
    b, sq, sk, g, p, hd = shape
    lp = kflash.plan_bwd(*_views(b, sq, sk, g, p, hd, dtype))
    assert lp.dims == (b, g, p, sq, sk, hd)
    assert lp.dtype == (1 if dtype == torch.bfloat16 else 0)
    one = lambda dims, st: tuple(hd if n == 1 else s for n, s in zip(dims, st))  # size-1 dims
    assert lp.strides[0] == one((b, g, p, sq), (sq * g * p * hd, p * hd, hd, g * p * hd))
    assert lp.strides[1] == one((b, g, sk), (sk * g * hd, hd, g * hd))
    if shape[:2] == (4, 1024):  # gemma-2b's layer: 64 blocks
        assert kflash.bwd_splits(b, g, p, sk, 132) == 4
    if shape[:2] == (2, 1024):  # Scout's: 256 blocks fill 132 SMs
        assert kflash.bwd_splits(b, g, p, sk, 132) == 1


def test_bwd_splits():
    """Doubled while the blocks do not fill the card, up to 4 and to P."""
    assert kflash.bwd_splits(4, 1, 8, 1024, 132) == 4
    assert kflash.bwd_splits(2, 8, 5, 1024, 132) == 1
    assert kflash.bwd_splits(1, 1, 8, 256, 132) == 4
    assert kflash.bwd_splits(1, 1, 3, 256, 132) == 2
    assert kflash.bwd_splits(1, 1, 1, 64, 132) == 1
    assert kflash.bwd_splits(4, 1, 8, 1024, 64) == 1


@pytest.mark.parametrize("what", ["q", "k", "o", "dout"])
def test_plan_bwd_refuses_strides_tma_cannot_read(what):
    """bf16 inputs are read by TMA (o by 16-byte loads): a row stride that
    is not a multiple of 8 elements raises in bf16 and is taken in
    float32, which the scalar kernels read element by element."""
    names = ("q", "k", "v", "o", "dout", "dq", "dk", "dv")
    for dtype in (torch.float32, torch.bfloat16):
        views = list(_views(1, 40, 40, 2, 3, 32, dtype))
        odd = _views(1, 40, 40, 2, 3, 32, dtype, pad=4)  # rows of 36 elements
        i = names.index(what)
        views[i] = odd[i]
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="multiples of 8"):
                kflash.plan_bwd(*views)
        else:
            lp = kflash.plan_bwd(*views)
            assert lp.strides[i][-1] == 36 * (2 * 3 if i != 1 else 2)


def test_plan_bwd_refuses_odd_output_strides_in_bf16():
    """bf16 dq, dk, dv are stored in pairs of elements, so their strides
    must be even."""
    views = list(_views(1, 40, 40, 1, 1, 16, torch.bfloat16))
    views[6] = torch.zeros((1, 40, 1, 17), dtype=torch.bfloat16)[..., :16].permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="even"):
        kflash.plan_bwd(*views)
    views[6] = views[7]
    assert kflash.plan_bwd(*views).dims == (1, 1, 1, 40, 40, 16)


def test_parse_ptxas_keys_each_template_instance():
    """ptxas's report, keyed by the kernel's identifier and its mangled
    template arguments; the anonymous namespace's name carries digits of
    its own before the identifier's length."""
    from repro_torch.kernels import build

    ns = "_ZN36_INTERNAL_f51_22_flash_attention_bwd_cu_3c1a0fb6"
    text = "\n".join([
        f"ptxas info    : Compiling entry function '{ns}25flash_bwd_dq_wgmma_kernelILi4EEEvNS_8S"
        "hapeE' for 'sm_90a'",
        "ptxas info    : Used 230 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas info    : Compiling entry function '{ns}22flash_bwd_stats_kernelI13__nv_bfloat1"
        "6Li16EEEvNS_8ShapeE' for 'sm_90a'",
        "    8 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads",
        "ptxas info    : Used 64 registers",
        f"ptxas info    : Compiling entry function '{ns}21flash_bwd_dsum_kernelENS_8ShapeE' for "
        "'sm_90a'",
        "ptxas info    : Used 32 registers"])
    assert build.parse_ptxas(text) == {
        "flash_bwd_dq_wgmma_kernelILi4EE": {"registers": 230, "spill_stores": 0,
                                            "spill_loads": 0},
        "flash_bwd_stats_kernelI13__nv_bfloat16Li16EE": {"registers": 64, "spill_stores": 20,
                                                         "spill_loads": 20},
        "flash_bwd_dsum_kernel": {"registers": 32}, "warnings": []}


def test_an_edit_to_the_shared_header_rebuilds_both_flash_sources(tmp_path, monkeypatch):
    """Both flash sources include ``csrc/hopper_common.cuh``, and the
    library is named by a hash of every source and header: an edit to the
    header names a new library, which ``build.library`` compiles from every
    source (no nvcc runs here)."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in sorted(build._CSRC.glob("*.cu*")):
        (csrc / src.name).write_bytes(src.read_bytes())
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert '#include "hopper_common.cuh"' in (csrc / name).read_text()
    monkeypatch.setattr(build, "_CSRC", csrc)
    before = build.library_path()
    assert set(p.name for p in build.sources()) >= {"flash_attention.cu",
                                                    "flash_attention_bwd.cu"}
    header = csrc / "hopper_common.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    assert build.library_path() != before
