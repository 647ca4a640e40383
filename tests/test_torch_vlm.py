"""The port's M-RoPE and vision tokens (``apply_rope``'s ``mrope_sections``,
``attention_block``'s ``rope_kind="mrope"``, ``_mrope_sections``,
``_positions``, ``_embed_inputs``) and qwen2-vl-7b's smoke config held
against the unpatched reference on the CPU.

Inputs come from seeded numpy generators; the reference's weights and
optimizer state are carried over with ``params_from_jax`` and
``opt_from_jax``, so both packages compute the same function.
Tolerances, as ``tests/test_torch_models.py`` states them: positions and
section sizes equal exactly; float32 element-wise pieces (RoPE, the
embedding splice) within 1e-5; float32 model numerics within rtol 1e-4 and
atol 1e-6 (sums run in another order, XLA's dots against torch's), logits
within 1e-4.

The reference's text stub feeds one position to all three streams, so its
M-RoPE equals plain RoPE bit for bit: a model-level test cannot see a
section that is rotated by the wrong stream.  ``apply_rope`` and
``attention_block`` are therefore also held with distinct t / h / w
streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import attention as jatt
from repro.models import model as jmodel
from repro.models import modules as jmod
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.carry import opt_from_jax, params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tatt
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as tengine
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step, trainable

ARCH = "qwen2-vl-7b"
JPOL = jmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
TPOL = tmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
ROPE_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
LOGIT_TOL = 1e-4
MARGIN = 1e-2   # greedy tokens compared where the reference's top-two margin exceeds it


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _cfgs(full=False):
    j, t = jreg.get_config(ARCH), treg.get_config(ARCH)
    return (j, t) if full else (jbase.reduce_for_smoke(j), tbase.reduce_for_smoke(t))


def _carried(seed=0):
    jcfg, tcfg = _cfgs()
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed), JPOL)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, TPOL, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch_np(cfg, seed, b=2, s=24, patches=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    if patches:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _port_tree(jtree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, TPOL, device="cpu")


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _close(got, want, rtol=RTOL, atol=ATOL):
    g, w = topt.leaves(got), topt.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _distinct_streams(rng, b, s):
    """``[3, B, S]`` positions whose t, h and w streams all differ."""
    pos = rng.integers(0, 3000, (3, b, s)).astype(np.int32)
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any() and (pos[0] != pos[2]).any()
    return pos


def _sections(hd, pct):
    half = int(hd * pct) // 2
    t = half // 4
    return (t, (half - t) // 2, half - t - (half - t) // 2)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_mrope_with_distinct_streams_matches(hd, pct):
    """Each frequency section rotated by its own stream, float32 angles;
    the result is not plain RoPE by any one stream (the test has teeth)."""
    rng = np.random.default_rng(hd + int(100 * pct))
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = _distinct_streams(rng, 2, 9)
    secs = _sections(hd, pct)
    assert sum(secs) == int(hd * pct) // 2
    kw = dict(theta=1e6, pct=pct, mrope_sections=secs)
    want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), **kw)
    got = tatt.apply_rope(_t(x), _t(pos), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=ROPE_TOL, atol=ROPE_TOL)
    for i in range(3):
        plain = tatt.apply_rope(_t(x), _t(pos[i]), theta=1e6, pct=pct)
        assert float((plain - got).abs().max()) > 1e-2, i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_with_one_stream_is_plain_rope_bit_for_bit(dtype):
    """The text stub (t = h = w) rotates exactly as plain RoPE, in both
    packages; bf16 keeps x's dtype."""
    rng = np.random.default_rng(7)
    td, jd = (torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16" else (torch.float32,
                                                                        jnp.float32)
    x = _t(rng.standard_normal((2, 11, 4, 16)).astype(np.float32)).to(td)
    pos = rng.integers(0, 500, (2, 11)).astype(np.int32)
    three = np.broadcast_to(pos[None], (3, 2, 11))
    got = tatt.apply_rope(x, _t(three), theta=1e6, mrope_sections=(2, 3, 3))
    assert got.dtype == td
    assert torch.equal(got, tatt.apply_rope(x, _t(pos), theta=1e6))
    jx = jnp.asarray(_np(x), jd)
    want = jatt.apply_rope(jx, jnp.asarray(three), theta=1e6, mrope_sections=(2, 3, 3))
    tol = 1e-2 if dtype == "bfloat16" else ROPE_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("full,want", [(True, (16, 24, 24)), (False, (2, 3, 3))])
def test_mrope_sections_equal_the_reference(full, want):
    jcfg, tcfg = _cfgs(full)
    assert ttr._mrope_sections(tcfg) == jtr._mrope_sections(jcfg) == want
    assert sum(want) == tcfg.head_dim // 2


@pytest.mark.parametrize("offset", ["int", "tensor"])
def test_positions_are_three_equal_streams(offset):
    """``[3, B, S]`` int32, equal exactly to the reference's, with an int
    offset (prefill, loss) and a ``[B]`` offset (decode's cache["pos"])."""
    jcfg, tcfg = _cfgs()
    b, s = 3, 5
    off = np.array([0, 4, 9], np.int32)
    jo, to = (7, 7) if offset == "int" else (jnp.asarray(off), _t(off))
    want = np.asarray(jtr._positions(jcfg, b, s, jo))
    got = ttr._positions(tcfg, b, s, to)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (3, b, s)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = dataclasses.replace(tcfg, rope_kind="rope")
    assert tuple(ttr._positions(plain, b, s, to).shape) == (b, s)


@pytest.mark.parametrize("patches", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_match(patches, dtype):
    """The patches, cast to the compute dtype, replace the first
    ``vision_tokens`` rows; without them the tokens' embeddings alone."""
    jcfg, tcfg, jparams, tparams = _carried(1)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                        torch.float32)
    nb = _batch_np(jcfg, 2, s=12, patches=patches)
    want = jtr._embed_inputs(jparams, jax.tree.map(jnp.asarray, nb), jcfg,
                             dataclasses.replace(JPOL, compute_dtype=jd))
    got = ttr._embed_inputs(tparams, {k: _t(v) for k, v in nb.items()}, tcfg,
                            dataclasses.replace(TPOL, compute_dtype=td))
    assert got.dtype == td and tuple(got.shape) == want.shape == (2, 12, jcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=ROPE_TOL,
                               atol=ROPE_TOL)
    v = jcfg.vision_tokens
    if patches:
        np.testing.assert_array_equal(
            _np(got[:, :v]), _np(_t(nb["vision_embeds"]).to(td)))
    tokens_only = ttr._embed_inputs(tparams, {"tokens": _t(nb["tokens"])}, tcfg,
                                    dataclasses.replace(TPOL, compute_dtype=td))
    assert torch.equal(got[:, v:], tokens_only[:, v:])


def _mrope_block_case(tp):
    rng = np.random.default_rng(40 + tp)
    d, hd, hq, hkv = 32, 16, 4, 2
    jlay, tlay = jatt.head_layout(hq, hkv, tp), tatt.head_layout(hq, hkv, tp)
    jp = jatt.init_attention(jax.random.PRNGKey(tp), d, jlay, hd, qk_norm=False,
                             norm_kind="rmsnorm", dtype=jnp.float32)
    return rng, d, hd, jlay, tlay, jp, jax.tree.map(lambda a: _t(np.asarray(a)), jp)


@pytest.mark.parametrize("tp", [1, 4])
def test_attention_block_mrope_with_distinct_streams_matches(tp):
    """``rope_kind="mrope"`` through the block with distinct streams: a
    13-token prefill into a cache, then 3 decode steps, each reading its
    scalar position from ``pos[0]``; outputs and caches equal the
    reference's."""
    rng, d, hd, jlay, tlay, jp, tp_ = _mrope_block_case(tp)
    b, s, max_len = 2, 13, 20
    secs = _sections(hd, 1.0)
    kw = dict(causal=True, rope_kind="mrope", mrope_sections=secs, theta=1e6)
    jc = jatt.init_kv_cache(b, max_len, jlay, hd, dtype=jnp.float32)
    tc = tatt.init_kv_cache(b, max_len, tlay, hd, dtype=torch.float32, device="cpu")
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = _distinct_streams(rng, b, s)
    pos[0] = np.arange(s, dtype=np.int32)  # the t stream: the tokens' own positions
    jy, jc = jatt.attention_block(jp, jnp.asarray(x), jlay, JPOL, pos=jnp.asarray(pos),
                                  cache=jc, **kw)
    ty, tc = tatt.attention_block(tp_, _t(x), tlay, TPOL, pos=_t(pos), cache=tc, **kw)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=RTOL, atol=1e-5)
    for i in range(3):
        x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
        p1 = rng.integers(0, 3000, (3, b, 1)).astype(np.int32)
        p1[0] = s + i
        jy, jc = jatt.attention_block(jp, jnp.asarray(x1), jlay, JPOL, pos=jnp.asarray(p1),
                                      cache=jc, **kw)
        ty, tc = tatt.attention_block(tp_, _t(x1), tlay, TPOL, pos=_t(p1), cache=tc, **kw)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), rtol=RTOL, atol=1e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert tc["offset"] == int(jc["offset"]) == s + i + 1


# ---------------------------------------------------------------------------
# the model at its smoke config
# ---------------------------------------------------------------------------


def test_params_carry_the_reference_tree():
    """qwen2-vl's tree (an untied ``lm_head``, no new leaf) carries one to
    one; the port's own init draws the same shapes and count."""
    jcfg, tcfg, jparams, tparams = _carried()
    assert sorted(tparams) == ["embed", "final_norm", "layers", "lm_head"]
    assert sorted(jparams) == ["blocks", "embed", "final_norm", "lm_head"]
    np.testing.assert_array_equal(_np(tparams["lm_head"]), np.asarray(jparams["lm_head"]))
    np.testing.assert_array_equal(_np(tparams["layers"][0]["attn"]["wk"]),
                                  np.asarray(jparams["blocks"]["b0"]["attn"]["wk"][0]))
    own = tmodel.init_params(tcfg, 0, TPOL, device="cpu")
    shapes = lambda tree: [tuple(t.shape) for t in _sorted_leaves(tree)]
    assert shapes(own) == shapes(tparams)
    n = sum(np.asarray(a).size for a in jax.tree.leaves(jparams))
    assert sum(t.numel() for t in topt.leaves(own)) == n


@pytest.mark.parametrize("patches", [True, False])
def test_loss_fn_value_and_every_grad_match(patches):
    jcfg, tcfg, jparams, tparams = _carried(2)
    tparams = trainable(tparams)
    nb = _batch_np(jcfg, 3, patches=patches)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, nb), jcfg, JPOL),
        has_aux=True)(jparams)
    tl, tm = tmodel.loss_fn(tparams, {k: _t(v) for k, v in nb.items()}, tcfg, TPOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
    assert float(tm["overflow"]) == float(jm["overflow"]) == 0.0
    tg = torch.autograd.grad(tl, topt.leaves(tparams))
    want = topt.leaves(_port_tree(jg, tcfg))
    assert len(tg) == len(want)
    for g, w in zip(tg, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)


def _same_cache(tc, jc, cfg):
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for i in range(cfg.num_layers):
        t, j = tc["layers"][i], jax.tree.map(lambda a: a[i], jc["blocks"]["b0"])
        np.testing.assert_allclose(_np(t["k"]), np.asarray(j["k"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(t["v"]), np.asarray(j["v"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        assert t["offset"] == int(j["offset"])


@pytest.mark.parametrize("patches", [True, False])
def test_prefill_and_decode_match(patches):
    """Prefill logits and caches with and without patches, then 4 decode
    steps (M-RoPE's decode positions from ``cache["pos"]``)."""
    jcfg, tcfg, jparams, tparams = _carried(3)
    nb = _batch_np(jcfg, 4, s=11, patches=patches)
    batch = {k: v for k, v in nb.items() if k in ("tokens", "vision_embeds")}
    max_len = 20
    jlog, jc = jax.jit(lambda p, b: jmodel.prefill(p, b, jcfg, JPOL, max_len))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tlog, tc = tmodel.prefill(tparams, {k: _t(v) for k, v in batch.items()}, tcfg, TPOL,
                              max_len)
    assert tlog.shape == jlog.shape == (2, 1, tmod.pad_vocab(jcfg.vocab_size))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _same_cache(tc, jc, jcfg)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, jcfg, JPOL))
    rng = np.random.default_rng(5)
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jc = step(jparams, jc, jnp.asarray(nxt))
        tlog, tc = tmodel.decode_step(tparams, tc, _t(nxt), tcfg, TPOL)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        _same_cache(tc, jc, jcfg)


def test_patches_change_the_logits():
    """The splice reaches the output: other patches, other logits."""
    _, tcfg, _, tparams = _carried(4)
    nb = _batch_np(tcfg, 6, s=10)
    a, _ = tmodel.prefill(tparams, {k: _t(nb[k]) for k in ("tokens", "vision_embeds")},
                          tcfg, TPOL, 12)
    b, _ = tmodel.prefill(tparams, {"tokens": _t(nb["tokens"]),
                                    "vision_embeds": _t(nb["vision_embeds"]) + 1.0},
                          tcfg, TPOL, 12)
    assert float((a - b).abs().max()) > 1e-3


def test_one_train_step_matches_from_opt_from_jax():
    """One ``make_train_step`` step with patches from the reference's exact
    state: metrics, parameters where the gradient is not near zero, both
    moments."""
    jcfg, tcfg, jparams, tparams = _carried(5)
    ocfg = dict(lr=1e-3, warmup=2)
    jo = jopt.init_opt(jparams, jopt.OptConfig(**ocfg))
    tstate = opt_from_jax(jax.tree.map(np.asarray, jo), tcfg, TPOL, device="cpu")
    nb = _batch_np(jcfg, 6)
    jb = jax.tree.map(jnp.asarray, nb)
    _, jg = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jb, jcfg, JPOL), has_aux=True)(jparams)
    masks = []
    for g in topt.leaves(_port_tree(jg, tcfg)):
        a = np.abs(_np(g))
        masks.append(a > 1e-3 * a.max())
    jparams, jo, jm = jax.jit(jmake_train_step(jcfg, JPOL, jopt.OptConfig(**ocfg)))(
        jparams, jo, jb)
    tparams, tstate, tm = make_train_step(tcfg, TPOL, topt.OptConfig(**ocfg))(
        tparams, tstate, {k: _t(v) for k, v in nb.items()})
    for key in ("loss", "grad_norm", "lr", "overflow"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL, atol=ATOL)
    got, want = topt.leaves(tparams), topt.leaves(_port_tree(jparams, tcfg))
    for a, b, m in zip(got, want, masks):
        np.testing.assert_allclose(_np(a)[m], _np(b)[m], rtol=RTOL, atol=ATOL)
    _close(tstate.m, _port_tree(jo.m, tcfg))
    _close(tstate.v, _port_tree(jo.v, tcfg))


def test_remat_matches_the_reference_remat():
    """``Policy(remat=True)`` with patches: the reference's
    ``jax.checkpoint`` loss and grads against the port's."""
    jcfg, tcfg, jparams, tparams = _carried(8)
    nb = _batch_np(jcfg, 9)
    jpol = dataclasses.replace(JPOL, remat=True)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, nb), jcfg, jpol)[0])(jparams)
    params = trainable(tparams)
    tl, _ = tmodel.loss_fn(params, {k: _t(v) for k, v in nb.items()}, tcfg,
                           dataclasses.replace(TPOL, remat=True))
    tg = torch.autograd.grad(tl, topt.leaves(params))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
    for g, w in zip(tg, topt.leaves(_port_tree(jg, tcfg))):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)


def test_vision_embeds_helper():
    """Seeded ``[B, vision_tokens, d]`` patches in the compute dtype on the
    named device; the same draws under float32 and bf16."""
    _, tcfg = _cfgs()
    draw = lambda pol: tmodel.vision_embeds(tcfg, 3, pol, torch.Generator().manual_seed(4),
                                            device="cpu")
    a, b = draw(TPOL), draw(tmod.Policy(compute_dtype=torch.bfloat16))
    assert a.shape == (3, tcfg.vision_tokens, tcfg.d_model) and a.dtype == torch.float32
    assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)
    assert torch.equal(a, draw(TPOL))
    gemma = tbase.reduce_for_smoke(treg.get_config("gemma-2b"))
    with pytest.raises(ValueError, match="no vision tokens"):
        tmodel.vision_embeds(gemma, 1, TPOL, torch.Generator(), device="cpu")


# ---------------------------------------------------------------------------
# the contracts, pinned in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["loss_fn", "prefill"])
def test_short_prompt_with_patches_raises_in_both_packages(entry):
    """A prompt shorter than its patches: the reference's concatenation
    has ``vision_tokens`` rows against S positions and fails (``TypeError``
    from a broadcast); the port raises ``ValueError`` and says why
    (ROADMAP.md, queue 3).  At S = ``vision_tokens`` both run."""
    jcfg, tcfg, jparams, tparams = _carried(6)
    nb = _batch_np(jcfg, 7, s=jcfg.vision_tokens // 2)
    jb, tb = jax.tree.map(jnp.asarray, nb), {k: _t(v) for k, v in nb.items()}
    jrun = {"loss_fn": lambda b: jmodel.loss_fn(jparams, b, jcfg, JPOL),
            "prefill": lambda b: jmodel.prefill(jparams, b, jcfg, JPOL, 16)}[entry]
    trun = {"loss_fn": lambda b: tmodel.loss_fn(tparams, b, tcfg, TPOL),
            "prefill": lambda b: tmodel.prefill(tparams, b, tcfg, TPOL, 16)}[entry]
    with pytest.raises(TypeError):
        jrun(jb)
    with pytest.raises(ValueError, match="cannot take 8 patch embeddings"):
        trun(tb)
    nb = _batch_np(jcfg, 7, s=jcfg.vision_tokens)
    jout, tout = jrun(jax.tree.map(jnp.asarray, nb)), trun({k: _t(v) for k, v in nb.items()})
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout[0]), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("layers,finite", [(8, True), (28, False)])
def test_zero_patches_overflow_the_gradient_at_depth_in_both_packages(layers, finite):
    """Zero patches (the launchers' stub) keep their rows exactly zero
    through every layer (q = k = v = 0 there, and the FFN of a zero row is
    zero), and each RMSNorm's backward multiplies a zero row's gradient by
    ``eps**-0.5 = 1000``: at 28 layers the gradient overflows float32 and
    the gradient norm is NaN in both packages (ROADMAP.md, queue 3); at 8
    it is finite and equal, and seeded patches are finite at 28."""
    from repro.train.optimizer import global_norm as jglobal_norm

    jcfg, tcfg = (dataclasses.replace(c, num_layers=layers) for c in _cfgs())
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(11), JPOL)
    tparams = trainable(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, TPOL,
                                        device="cpu"))
    nb = _batch_np(jcfg, 12, s=16)
    norms = {}
    for kind in ("zero", "seeded"):
        if kind == "zero":
            nb["vision_embeds"] = np.zeros_like(nb["vision_embeds"])
        else:
            nb = _batch_np(jcfg, 12, s=16)
        jl, jg = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, nb), jcfg, JPOL)[0])(jparams)
        tl, _ = tmodel.loss_fn(tparams, {k: _t(v) for k, v in nb.items()}, tcfg, TPOL)
        tn = topt.global_norm(torch.autograd.grad(tl, topt.leaves(tparams)))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
        norms[kind] = (float(jglobal_norm(jg)), float(tn))
    assert all(np.isfinite(norms["seeded"]))
    if finite:
        np.testing.assert_allclose(norms["zero"][1], norms["zero"][0], rtol=RTOL)
    else:
        assert all(np.isnan(norms["zero"])), norms


def test_serve_engine_serves_text_only_as_the_reference():
    """``ServeEngine`` passes no patches (the reference's engine passes
    only the prompt's tokens): the same ticks and tokens as the
    reference's, greedy tokens equal wherever its top-two margin exceeds
    ``MARGIN``."""
    jcfg, tcfg, jparams, tparams = _carried(9)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, jcfg.vocab_size, 12).astype(np.int32) for _ in range(4)]
    jreqs = [jengine.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    treqs = [tengine.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    jeng = jengine.ServeEngine(jcfg, jparams, JPOL, slots=2, max_len=32)
    teng = tengine.ServeEngine(tcfg, tparams, TPOL, slots=2, max_len=32, device="cpu")
    jeng.run(jreqs, max_ticks=100)
    teng.run(treqs, max_ticks=100)
    assert (teng.steps, teng.tokens_out) == (jeng.steps, jeng.tokens_out)
    for p, jr, tr in zip(prompts, jreqs, treqs):
        assert tr.done and len(tr.out_tokens) == len(jr.out_tokens) == 5
        if tr.out_tokens == jr.out_tokens:
            continue
        first = next(i for i, (a, b) in enumerate(zip(tr.out_tokens, jr.out_tokens)) if a != b)
        logits, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(p[None])}, jcfg, JPOL, 32)
        for tok in jr.out_tokens[:first]:
            logits, cache = jmodel.decode_step(jparams, cache, jnp.asarray([[tok]], jnp.int32),
                                               jcfg, JPOL)
        top = np.sort(np.asarray(logits[0, -1, :jcfg.vocab_size], np.float64))[-2:]
        assert top[1] - top[0] <= MARGIN, (jr.rid, first)


def test_launcher_trains_qwen2_vl(capsys):
    """``launch/train.py --arch qwen2-vl-7b --smoke --device cpu --steps
    2``: zero patch embeddings, as the reference's launcher gives them."""
    from repro_torch.launch import train as ttrain

    ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=qwen2-vl-7b-smoke" in out and "done: 2 steps" in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launcher_refuses_a_sequence_shorter_than_the_patches():
    """The smoke config's 8 vision tokens against ``--seq 4``."""
    from repro_torch.launch import train as ttrain

    with pytest.raises(ValueError, match="patch embeddings"):
        ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1", "--batch",
                     "1", "--seq", "4"])
