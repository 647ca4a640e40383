"""The port's encoder-decoder family (``repro_torch.models.encdec``, the
cross-attention of ``attention_block``) and whisper-base's smoke config
held against the unpatched reference on the CPU.

Inputs come from seeded numpy generators; the reference's weights and
optimizer state are carried over with ``params_from_jax`` and
``opt_from_jax``, so both packages compute the same function.
Tolerances: the sinusoid table, cache positions and offsets equal
exactly; float32 model numerics within rtol 1e-4 and atol 1e-6
(``tests/test_torch_train.py``'s: sums run in another order, XLA's dots
against torch's), logits within 1e-4 as ``tests/test_torch_models.py``
holds the other families; remat on against off bit for bit in the port;
teacher-forced decode against prefill within 2e-5 (the reference's probe
read 2.0e-6 at this config).
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
from repro.models import encdec as jenc
from repro.models import model as jmodel
from repro.models import modules as jmod
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.carry import opt_from_jax, params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tatt
from repro_torch.models import encdec as tenc
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmod
from repro_torch.serve import engine as tengine
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_eval_step, make_train_step, trainable

ARCH = "whisper-base"
JPOL = jmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
TPOL = tmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
RTOL, ATOL = 1e-4, 1e-6
LOGIT_TOL = 1e-4
TEACHER_TOL = 2e-5


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _cfgs():
    return (jbase.reduce_for_smoke(jreg.get_config(ARCH)),
            tbase.reduce_for_smoke(treg.get_config(ARCH)))


def _carried(seed=0):
    jcfg, tcfg = _cfgs()
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed), JPOL)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, TPOL, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch_np(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32),
            "enc_embeds": rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)}


def _port_tree(jtree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, TPOL, device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL):
    g, w = topt.leaves(got), topt.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(32, 64), (1500, 512), (7, 10), (1, 2)])
def test_sinusoid_equal_bit_for_bit(n, d):
    got, want = tenc._sinusoid(n, d), jenc._sinusoid(n, d)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tenc.MAX_DEC_POS == jenc.MAX_DEC_POS


def _xattn_case(tp, hq=4, hkv=2):
    rng = np.random.default_rng(30 + tp)
    d, hd = 32, 16
    jlay, tlay = jatt.head_layout(hq, hkv, tp), tatt.head_layout(hq, hkv, tp)
    jp = jatt.init_attention(jax.random.PRNGKey(tp), d, jlay, hd, qk_norm=False,
                             norm_kind="layernorm", dtype=jnp.float32)
    return rng, d, hd, jlay, tlay, jp, jax.tree.map(lambda a: _t(np.asarray(a)), jp)


@pytest.mark.parametrize("tp", [1, 4])
@pytest.mark.parametrize("sq,sk", [(9, 21), (21, 9), (1, 13)])
def test_attention_block_xkv_matches(tp, sq, sk):
    """k and v projected from another sequence (``xkv``), non-causal, no
    RoPE on either side though the block is asked for it; ``tp = 4``
    replicates the 2 kv heads to 4 slots."""
    rng, d, _, jlay, tlay, jp, tp_ = _xattn_case(tp)
    b = 2
    x = rng.standard_normal((b, sq, d)).astype(np.float32)
    src = rng.standard_normal((b, sk, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + 5, (b, sq))
    kw = dict(causal=False, rope_kind="rope", norm_kind="layernorm")
    jy, jc = jatt.attention_block(jp, jnp.asarray(x), jlay, JPOL, pos=jnp.asarray(pos),
                                  xkv=jnp.asarray(src), **kw)
    ty, tc = tatt.attention_block(tp_, _t(x), tlay, TPOL, pos=_t(pos), xkv=_t(src), **kw)
    assert jc is None and tc is None
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tp", [1, 4])
@pytest.mark.parametrize("sq", [1, 2, 17])
def test_attention_block_static_cache_matches(tp, sq):
    """Fixed k/v (``static_cache``): flash, non-causal, for ``S > 1`` and
    decode attention over every valid row for ``S == 1``; the cache comes
    back unchanged (the same dict in the port), one slot empty (pos -1)."""
    rng, d, hd, jlay, tlay, jp, tp_ = _xattn_case(tp)
    b, sk = 2, 19
    k = rng.standard_normal((b, sk, jlay.hkv_p, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, jlay.hkv_p, hd)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    if sq == 1:
        kpos[:, -1] = -1
    x = rng.standard_normal((b, sq, d)).astype(np.float32)
    pos = np.full((b, sq), 3, np.int32)
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(kpos),
              "offset": jnp.asarray(sk, jnp.int32)}
    tcache = {"k": _t(k), "v": _t(v), "pos": _t(kpos), "offset": sk}
    kw = dict(causal=False, rope_kind="none", norm_kind="layernorm", static_cache=True)
    jy, jc = jatt.attention_block(jp, jnp.asarray(x), jlay, JPOL, pos=jnp.asarray(pos),
                                  cache=jcache, **kw)
    ty, tc = tatt.attention_block(tp_, _t(x), tlay, TPOL, pos=_t(pos), cache=tcache, **kw)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=RTOL, atol=ATOL)
    assert tc is tcache and tc["offset"] == sk
    np.testing.assert_array_equal(tc["k"].numpy(), k)
    np.testing.assert_array_equal(tc["pos"].numpy(), kpos)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_params_carry_the_reference_tree():
    """The reference's stacked ``enc``/``dec`` become per-layer lists; the
    port's own init draws the same shapes; every array carried exactly."""
    jcfg, tcfg, jparams, tparams = _carried()
    assert sorted(tparams) == sorted(jparams)
    assert len(tparams["enc"]) == jcfg.enc_layers and len(tparams["dec"]) == jcfg.num_layers
    np.testing.assert_array_equal(_np(tparams["enc"][1]["attn"]["wq"]),
                                  np.asarray(jparams["enc"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(_np(tparams["dec"][0]["xattn"]["wv"]),
                                  np.asarray(jparams["dec"]["xattn"]["wv"][0]))
    np.testing.assert_array_equal(_np(tparams["dec_pos"]), np.asarray(jparams["dec_pos"]))
    own = tmodel.init_params(tcfg, 0, TPOL, device="cpu")
    shapes = lambda tree: [tuple(t.shape) for t in _sorted_leaves(tree)]
    assert shapes(own) == shapes(tparams)
    assert sum(t.numel() for t in topt.leaves(own)) == sum(
        np.asarray(a).size for a in jax.tree.leaves(jparams))


def test_encode_matches():
    jcfg, tcfg, jparams, tparams = _carried(1)
    nb = _batch_np(jcfg, 2)
    want = jenc.encode(jparams, jnp.asarray(nb["enc_embeds"]), jcfg, JPOL)
    got = tenc.encode(tparams, _t(nb["enc_embeds"]), tcfg, TPOL)
    assert got.shape == want.shape == (2, jcfg.enc_len, jcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL * 10)


def test_loss_fn_value_and_every_grad_match():
    """The loss and the gradient of every parameter, the encoder's too
    (they reach it through the cross-attention's k and v)."""
    jcfg, tcfg, jparams, tparams = _carried(2)
    tparams = trainable(tparams)
    nb = _batch_np(jcfg, 3)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, nb), jcfg, JPOL),
        has_aux=True)(jparams)
    tl, tm = tmodel.loss_fn(tparams, {k: _t(v) for k, v in nb.items()}, tcfg, TPOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
    assert float(tm["overflow"]) == float(jm["overflow"]) == 0.0
    flat = topt.leaves(tparams)
    tg = torch.autograd.grad(tl, flat)
    want = topt.leaves(_port_tree(jg, tcfg))
    assert len(tg) == len(want)
    for g, w in zip(tg, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)
    enc_grads = topt.leaves(tparams["enc"])
    assert all(float(g.abs().max()) > 0 for g, p in zip(tg, flat)
               if any(p is e for e in enc_grads))


def _same_cache(tc, jc, cfg):
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for i in range(cfg.num_layers):
        for key, jblk in (("blocks", jc["blocks"]), ("xcaches", jc["xcaches"])):
            t, j = tc[key][i], jax.tree.map(lambda a: a[i], jblk)
            np.testing.assert_allclose(_np(t["k"]), np.asarray(j["k"]), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(_np(t["v"]), np.asarray(j["v"]), rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
            assert t["offset"] == int(j["offset"])


def test_prefill_and_decode_match():
    """Prefill logits and caches (self and cross), then 4 decode steps."""
    jcfg, tcfg, jparams, tparams = _carried(3)
    nb = _batch_np(jcfg, 4, s=9)
    batch = {"tokens": nb["tokens"], "enc_embeds": nb["enc_embeds"]}
    max_len = 20
    jlog, jc = jax.jit(lambda p, b: jmodel.prefill(p, b, jcfg, JPOL, max_len))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tlog, tc = tmodel.prefill(tparams, {k: _t(v) for k, v in batch.items()}, tcfg, TPOL,
                              max_len)
    assert tlog.shape == jlog.shape == (2, 1, tmod.pad_vocab(jcfg.vocab_size))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _same_cache(tc, jc, jcfg)
    xk = [c["k"] for c in tc["xcaches"]]
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, jcfg, JPOL))
    rng = np.random.default_rng(5)
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jc = step(jparams, jc, jnp.asarray(nxt))
        tlog, tc = tmodel.decode_step(tparams, tc, _t(nxt), tcfg, TPOL)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        _same_cache(tc, jc, jcfg)
    assert all(c["k"] is k for c, k in zip(tc["xcaches"], xk))  # read, never rebuilt


@pytest.mark.parametrize("prefix,total", [(8, 9), (4, 12), (1, 6)])
def test_teacher_forced_decode_matches_prefill_in_the_port(prefix, total):
    """``prefix`` tokens prefilled, the rest decoded teacher-forced: the
    last logits equal the whole prefill's (a 1-token prefill runs the
    decode path of the self-attention)."""
    _, tcfg, _, tparams = _carried(4)
    rng = np.random.default_rng(prefix)
    toks = _t(rng.integers(0, tcfg.vocab_size, (1, total)))
    enc = _t(rng.standard_normal((1, tcfg.enc_len, tcfg.d_model)).astype(np.float32))
    full, _ = tmodel.prefill(tparams, {"tokens": toks, "enc_embeds": enc}, tcfg, TPOL, total)
    logits, cache = tmodel.prefill(tparams, {"tokens": toks[:, :prefix], "enc_embeds": enc},
                                   tcfg, TPOL, total)
    for t in range(prefix, total):
        logits, cache = tmodel.decode_step(tparams, cache, toks[:, t:t + 1], tcfg, TPOL)
    np.testing.assert_allclose(_np(logits), _np(full), rtol=TEACHER_TOL, atol=TEACHER_TOL)
    assert cache["blocks"][0]["offset"] == total


def test_one_train_step_matches_from_opt_from_jax():
    """One ``make_train_step`` step from the reference's exact state:
    metrics, parameters where the gradient is not near zero (AdamW's first
    update is about ``sign(g) * lr``), both moments."""
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
    assert int(tstate.step) == int(jo.step) == 1


def test_eval_step_matches():
    jcfg, tcfg, jparams, tparams = _carried(6)
    nb = _batch_np(jcfg, 7)
    out = make_eval_step(tcfg, TPOL)(tparams, {k: _t(v) for k, v in nb.items()})
    jl, _ = jmodel.loss_fn(jparams, jax.tree.map(jnp.asarray, nb), jcfg, JPOL)
    assert not out["loss"].requires_grad
    np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=RTOL, atol=ATOL)


def _grads(tcfg, pol, tparams, batch):
    params = trainable(topt.tree_map(lambda t: t.detach().clone(), tparams))
    loss, _ = tmodel.loss_fn(params, batch, tcfg, pol)
    return loss, torch.autograd.grad(loss, topt.leaves(params))


def test_remat_is_bit_equal_and_recomputes(monkeypatch):
    """``Policy(remat=True)``: each encoder and decoder layer is one
    checkpointed segment; loss and every gradient equal the run without
    remat bit for bit, and the backward runs every layer's attention again
    (2 x (enc + 2 x dec) flash calls a step instead of enc + 2 x dec)."""
    jcfg, tcfg, _, tparams = _carried(7)
    batch = {k: _t(v) for k, v in _batch_np(jcfg, 8).items()}
    calls = {"n": 0}
    orig = tatt.flash_attention

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tatt, "flash_attention", counted)
    runs = {}
    for remat in (False, True):
        calls["n"] = 0
        pol = dataclasses.replace(TPOL, remat=remat)
        runs[remat] = (*_grads(tcfg, pol, tparams, batch), calls["n"])
    (l0, g0, n0), (l1, g1, n1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    per = tcfg.enc_layers + 2 * tcfg.num_layers
    assert (n0, n1) == (per, 2 * per)


def test_remat_matches_the_reference_remat():
    """The reference's ``jax.checkpoint`` loss against the port's remat
    loss and grads, within the float32 tolerance."""
    jcfg, tcfg, jparams, tparams = _carried(8)
    nb = _batch_np(jcfg, 9)
    jpol = dataclasses.replace(JPOL, remat=True)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, nb), jcfg, jpol)[0])(jparams)
    tl, tg = _grads(tcfg, dataclasses.replace(TPOL, remat=True), tparams,
                    {k: _t(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
    for g, w in zip(tg, topt.leaves(_port_tree(jg, tcfg))):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# what the reference's API does not do, pinned in both packages
# ---------------------------------------------------------------------------


def test_init_cache_raises_in_both_packages():
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError, match="produced by prefill"):
        jmodel.init_cache(jcfg, 1, 8, JPOL)
    with pytest.raises(ValueError, match="produced by prefill"):
        tmodel.init_cache(tcfg, 1, 8, TPOL, device="cpu")
    with pytest.raises(ValueError, match="produced by prefill"):
        tmodel.init_cache(tcfg, 1, 8, TPOL)  # raises before it looks for a card


def test_serve_engine_cannot_serve_encdec_in_both_packages():
    """``ServeEngine.admit`` passes only the prompt's tokens to
    ``model.prefill`` (the reference's ``src/repro/serve/engine.py``
    :55-59), so an enc-dec model has no ``enc_embeds``: ``KeyError`` in
    both packages (ROADMAP.md, queue 3)."""
    jcfg, tcfg, jparams, tparams = _carried(9)
    prompt = np.arange(4, dtype=np.int32)
    jeng = jengine.ServeEngine(jcfg, jparams, JPOL, slots=1, max_len=16)
    with pytest.raises(KeyError, match="enc_embeds"):
        jeng.admit(jengine.Request(rid=0, prompt=prompt, max_new_tokens=2))
    teng = tengine.ServeEngine(tcfg, tparams, TPOL, slots=1, max_len=16, device="cpu")
    with pytest.raises(KeyError, match="enc_embeds"):
        teng.admit(tengine.Request(rid=0, prompt=prompt, max_new_tokens=2))


def test_launcher_trains_whisper(capsys):
    """``launch/train.py --arch whisper-base --smoke --device cpu --steps
    2``: zero frame embeddings, as the reference's launcher gives them."""
    from repro_torch.launch import train as ttrain

    ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=whisper-base-smoke" in out and "done: 2 steps" in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
