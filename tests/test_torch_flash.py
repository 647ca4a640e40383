"""The flash-attention wrapper's launch plan and its ``p_bf16`` mode, on the
CPU.

The CUDA kernel runs only on the card; here the pure helper that chooses
what a launch gets (kernel variant, dtype code, ``p_bf16`` flag, strides of
the strided views) is held to strides computed by hand for both layouts the
wrappers take, and the plain version's ``p_bf16`` mode is held to the jnp
flash (``repro.models.attention.flash_attention``) at gemma-2b's head shape
(G = 1, P = 8, hd = 256) within 2e-2, the tolerance of the existing
``p_bf16`` parity test: p is rounded to bf16, so a last-bit difference in a
score can flip its rounding in either package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jnp_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn

DTYPES = {"float32": (torch.float32, jnp.float32, 0, "scalar_f32"),
          "bf16": (torch.bfloat16, jnp.bfloat16, 1, "wgmma_bf16")}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the launch plan (no data touched)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_bf16", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_for_the_pallas_layout(dtype, p_bf16):
    td, _, code, kernel = DTYPES[dtype]
    g, p, sq, sk, hd = 3, 2, 70, 90, 48
    q, out = torch.empty((g, p, sq, hd), dtype=td), torch.empty((g, p, sq, hd), dtype=td)
    k, v = torch.empty((g, sk, hd), dtype=td), torch.empty((g, sk, hd), dtype=td)
    lp = fa.plan(*fa.pallas_views(q, k, v, out), window=5, p_bf16=p_bf16)
    assert (lp.kernel, lp.dtype, lp.p_bf16) == (kernel, code, int(p_bf16))
    assert lp.dims == (1, g, p, sq, sk, hd)
    # (batch, group, head, row); the batch of 1 gets stride hd
    assert lp.q_strides == lp.o_strides == (hd, p * sq * hd, sq * hd, hd)
    assert lp.k_strides == lp.v_strides == (hd, sk * hd, hd)
    assert [list(a) for a in lp.c_strides] == [list(lp.q_strides), list(lp.k_strides),
                                                list(lp.v_strides), list(lp.o_strides)]


@pytest.mark.parametrize("p_bf16", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_for_the_models_layout(dtype, p_bf16):
    """q, k, v as the attention block makes them (projections of one
    activation, split by head), the output ``[B, Sq, G * P * hd]``."""
    td, _, code, kernel = DTYPES[dtype]
    b, s, g, p, hd = 2, 33, 2, 4, 64
    x = torch.empty((b, s, (g * p + 2 * g) * hd), dtype=td)
    q = x[..., : g * p * hd].unflatten(-1, (g, p, hd))
    k = x[..., g * p * hd: (g * p + g) * hd].unflatten(-1, (g, hd))
    v = x[..., (g * p + g) * hd:].unflatten(-1, (g, hd))
    out = torch.empty((b, s, g * p * hd), dtype=td)
    lp = fa.plan(*fa.seq_major_views(q, k, v, out), p_bf16=p_bf16)
    assert (lp.kernel, lp.dtype, lp.p_bf16) == (kernel, code, int(p_bf16))
    assert lp.dims == (b, g, p, s, s, hd)
    row = (g * p + 2 * g) * hd
    assert lp.q_strides == (s * row, p * hd, hd, row)
    assert lp.k_strides == lp.v_strides == (s * row, hd, row)
    assert lp.o_strides == (s * g * p * hd, p * hd, hd, g * p * hd)


def test_plan_refuses_what_the_kernels_do_not_take():
    q = torch.empty((1, 2, 16, 64), dtype=torch.bfloat16)
    k = torch.empty((1, 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.plan(*fa.pallas_views(q.transpose(2, 3), k, k, q.transpose(2, 3)))
    # a bf16 row stride of 68 elements (136 bytes) is no multiple of 16 bytes
    wide = torch.empty((1, 2, 16, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        fa.plan(*fa.pallas_views(wide, k, k, q))
    # float32 takes it: its kernel reads with plain loads
    wide32 = torch.empty((1, 2, 16, 68))[..., :64]
    lp = fa.plan(*fa.pallas_views(wide32, k.float(), k.float(), q.float()))
    assert lp.kernel == "scalar_f32" and lp.q_strides[3] == 68
    with pytest.raises(ValueError, match="float32 or all bf16"):
        fa.plan(*fa.pallas_views(q, k.float(), k, q))
    with pytest.raises(ValueError, match="head_dim"):
        fa.plan(*fa.pallas_views(q[..., :40], k[..., :40], k[..., :40], q[..., :40]))
    with pytest.raises(ValueError, match="need q"):
        fa.seq_major_views(q, k, k, q)


# ---------------------------------------------------------------------------
# p_bf16 at gemma-2b's head shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_bf16_weights_at_gemma_heads(dtype, window):
    """G = 1 kv head, P = 8 q heads, hd = 256, causal (and windowed):
    the plain version's ``p_bf16`` mode against the jnp flash's."""
    td, jd, _, _ = DTYPES[dtype]
    g, p, sq, hd = 1, 8, 48, 256
    q, k, v = (_rand(shape, seed) for seed, shape in
               enumerate(((g, p, sq, hd), (g, sq, hd), (g, sq, hd))))
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = jnp_flash(jq.transpose(2, 0, 1, 3)[None], jk.transpose(1, 0, 2)[None],
                     jv.transpose(1, 0, 2)[None], causal=True, window=window,
                     q_chunk=16, kv_chunk=16, p_bf16=True)
    want = np.asarray(want.astype(jnp.float32))[0].transpose(1, 2, 0, 3)
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(td)
                  for x in (jq, jk, jv))
    got = fa.flash_attention(tq, tk, tv, causal=True, window=window, p_bf16=True,
                             q_chunk=16, kv_chunk=16)
    assert got.dtype == td and got.shape == (g, p, sq, hd)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("p_bf16", [False, True])
def test_models_layout_entry_on_the_cpu_matches_jnp_flash(p_bf16):
    """``flash_attention_seq_major`` (the models' entry) on strided views,
    and ``models.attention.flash_attention`` over it, against the jnp flash
    in the same ``[B, Sq, G, P, hd]`` layout."""
    b, s, g, p, hd = 2, 40, 2, 2, 32
    x = _rand((b, s, (g * p + 2 * g) * hd), 7)
    jx = jnp.asarray(x)
    q = jx[..., : g * p * hd].reshape(b, s, g, p, hd)
    k = jx[..., g * p * hd: (g * p + g) * hd].reshape(b, s, g, hd)
    v = jx[..., (g * p + g) * hd:].reshape(b, s, g, hd)
    want = np.asarray(jnp_flash(q, k, v, causal=True, window=9, q_chunk=16, kv_chunk=16,
                                p_bf16=p_bf16))
    tx = torch.as_tensor(x)
    tq = tx[..., : g * p * hd].unflatten(-1, (g, p, hd))
    tk = tx[..., g * p * hd: (g * p + g) * hd].unflatten(-1, (g, hd))
    tv = tx[..., (g * p + g) * hd:].unflatten(-1, (g, hd))
    got = fa.flash_attention_seq_major(tq, tk, tv, causal=True, window=9, q_chunk=16,
                                       kv_chunk=16, p_bf16=p_bf16)
    assert got.shape == (b, s, g * p * hd) and got.is_contiguous()
    tol = 2e-2 if p_bf16 else 2e-5
    np.testing.assert_allclose(got.numpy(), want.reshape(b, s, -1), rtol=tol, atol=tol)
    five = tattn.flash_attention(tq, tk, tv, causal=True, window=9, q_chunk=16, kv_chunk=16,
                                 p_bf16=p_bf16)
    assert five.shape == (b, s, g, p, hd)
    assert torch.equal(five.reshape(b, s, -1), got)
