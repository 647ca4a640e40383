"""The port's training path (``repro_torch.train``, ``chunked_softmax_xent``,
``loss_fn``, ``launch/train.py``, the placement safe point) held against
the reference on the CPU.

Inputs come from numpy seeds; the reference's parameters and optimizer
state are carried over with ``repro_torch.carry.params_from_jax`` and
``opt_from_jax``, so both packages start from the same state.
Tolerances: token streams, checkpoints and the sliced update equal
exactly; the optimizer given the same grads within 1e-6 (XLA's and
torch's float32 ``pow`` and ``sqrt``); losses and grads within rtol 1e-4,
atol 1e-6 (float32 sums in another order).  A whole step's parameters are
compared only where ``|g| > 1e-3 * max |g|``: AdamW's first update is
about ``sign(g) * lr``, so it magnifies ulp-level noise in a near-zero
gradient into a full step.
"""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.data import generators as jgen
from repro.models import model as jmodel
from repro.models import modules as jmod
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.carry import opt_from_jax, params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.data import generators as tgen
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmod
from repro_torch.moe.kip_placement import ExpertPlacement, apply_placement_in_place
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_eval_step, make_train_step, moe_state, trainable

JPOL = jmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
TPOL = tmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
RTOL, ATOL = 1e-4, 1e-6
ARCHS = ["gemma-2b", "llama4-scout-17b-a16e", "xlstm-125m", "whisper-base"]
# every registry arch: attn / local_attn / mamba / mlstm / slstm mixers,
# dense, MoE or no FFNs, and the enc-dec family
LOSS_ARCHS = ["gemma-2b", "stablelm-1.6b", "deepseek-coder-33b", "gemma3-27b",
              "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "xlstm-125m",
              "whisper-base", "qwen2-vl-7b", "jamba-1.5-large-398b"]


def _cfgs(arch):
    return (jbase.reduce_for_smoke(jreg.get_config(arch)),
            tbase.reduce_for_smoke(treg.get_config(arch)))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _batch_np(vocab, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def _arch_batch_np(cfg, seed, b=2, s=32):
    """``_batch_np`` plus an enc-dec model's frame embeddings ``enc_embeds
    [B, enc_len, d]`` or a vision model's patch embeddings ``vision_embeds
    [B, vision_tokens, d]``."""
    nb = _batch_np(cfg.vocab_size, seed, b, s)
    rng = np.random.default_rng(seed + 1000)
    if cfg.encdec:
        nb["enc_embeds"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        nb["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return nb


def _port_tree(jtree, tcfg):
    """A reference params-shaped tree (grads, params) in the port's layout."""
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, TPOL, device="cpu")


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = topt.leaves(got), topt.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(3, 2, 17, 512, 0, 1.1), (2, 4, 9, 256_000, 5, 1.3),
                                  (1, 1, 64, 40, 7, 1.1)])
def test_lm_token_stream_bit_equal(args):
    n, b, s, v, seed, e = args
    got = list(tgen.lm_token_stream(n, b, s, v, seed=seed, exponent=e))
    want = list(jgen.lm_token_stream(n, b, s, v, seed=seed, exponent=e))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class TestAdamW:
    """The reference's ``TestOptimizer`` cases on the port."""

    def test_descends_quadratic(self):
        params = {"w": torch.tensor([3.0, -2.0])}
        cfg = topt.OptConfig(lr=0.1, weight_decay=0.0, warmup=1)
        st = topt.init_opt(params, cfg)
        for _ in range(200):
            g = {"w": 2 * params["w"]}
            params, st, m = topt.apply_updates(params, g, st, cfg)
        assert float(params["w"].abs().max()) < 1e-2
        assert int(st.step) == 200

    def test_clipping(self):
        params = {"w": torch.zeros(4)}
        cfg = topt.OptConfig(clip_norm=1.0, warmup=1)
        st = topt.init_opt(params, cfg)
        _, _, m = topt.apply_updates(params, {"w": torch.full((4,), 100.0)}, st, cfg)
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    def test_bf16_moments(self):
        params = {"w": torch.zeros(4)}
        st = topt.init_opt(params, topt.OptConfig(moment_dtype=torch.bfloat16))
        assert st.m["w"].dtype == torch.bfloat16 and st.v["w"].dtype == torch.bfloat16


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
              "b": {"c": rng.normal(0, 1, (3,)).astype(np.float32),
                    "d": rng.normal(0, 1, (2, 3, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(0, s, p.shape).astype(np.float32), params)
             for s in (0.3, 3.0, 0.01)]  # the second clips
    return params, grads


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("warmup", [1, 5])
def test_apply_updates_matches_reference(moments, warmup):
    """Three steps given the same grads: parameters, moments, step,
    grad_norm and lr within 1e-6."""
    params, grads = _opt_case(0)
    jcfg = jopt.OptConfig(lr=1e-2, warmup=warmup, moment_dtype=getattr(jnp, moments))
    tcfg = topt.OptConfig(lr=1e-2, warmup=warmup, moment_dtype=getattr(torch, moments))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt(jp, jcfg)
    tp = jax.tree.map(lambda a: torch.as_tensor(a.copy()), params)
    ts = topt.init_opt(tp, tcfg)
    for g in grads:
        jp, js, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = topt.apply_updates(tp, jax.tree.map(torch.as_tensor, g), ts, tcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        assert int(ts.step) == int(js.step)
        for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for a, b in zip(topt.leaves(tree_t), jax.tree.leaves(tree_j)):
                assert a.dtype == getattr(torch, str(b.dtype))
                np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), rtol=1e-6,
                                           atol=1e-6)


def test_sliced_update_equals_whole(monkeypatch):
    """The update in slices of 7 elements gives the bits of one slice."""
    params, grads = _opt_case(1)
    cfg = topt.OptConfig(lr=1e-2, warmup=2, moment_dtype=torch.bfloat16)
    runs = []
    for size in (1 << 24, 7):
        monkeypatch.setattr(topt, "SLICE", size)
        tp = jax.tree.map(lambda a: torch.as_tensor(a.copy()), params)
        ts = topt.init_opt(tp, cfg)
        for g in grads:
            tp, ts, _ = topt.apply_updates(tp, jax.tree.map(torch.as_tensor, g), ts, cfg)
        runs.append(topt.leaves((tp, ts.m, ts.v)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_update_keeps_the_leaves():
    """In place: the same tensors come back, still leaves that require
    grad."""
    p = {"w": torch.ones(3, requires_grad=True)}
    st = topt.init_opt(p, topt.OptConfig())
    ids = (id(p["w"]), id(st.m["w"]), id(st.v["w"]))
    p2, st2, _ = topt.apply_updates(p, {"w": torch.ones(3)}, st, topt.OptConfig())
    assert (id(p2["w"]), id(st2.m["w"]), id(st2.v["w"])) == ids
    assert p2["w"].requires_grad and p2["w"].is_leaf
    assert not torch.equal(p2["w"].detach(), torch.ones(3))


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("chunk", [8, 512])
@pytest.mark.parametrize("vocab", [300, 512])  # 300: padded to 512 columns
def test_chunked_softmax_xent_matches_reference(softcap, chunk, vocab):
    rng = np.random.default_rng(3)
    b, s, d, vp = 2, 32, 16, jmod.pad_vocab(vocab)
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    w = rng.normal(0, 0.5, (vp, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)

    def jloss(x, w):
        return jmod.chunked_softmax_xent(x, w, labels, mask, JPOL, vocab, chunk=chunk,
                                         softcap=softcap)

    jl, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.as_tensor(x).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    tl = tmod.chunked_softmax_xent(tx, tw, torch.as_tensor(labels), torch.as_tensor(mask),
                                   TPOL, vocab, chunk=chunk, softcap=softcap)
    tdx, tdw = torch.autograd.grad(tl, (tx, tw))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=RTOL, atol=ATOL)
    if vp > vocab:
        assert float(tdw[vocab:].abs().max()) == 0.0  # padded columns get no gradient


# ---------------------------------------------------------------------------
# loss_fn and the train step
# ---------------------------------------------------------------------------


def _carried(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed), JPOL)
    tparams = trainable(_port_tree(jparams, tcfg))
    return jcfg, tcfg, jparams, tparams


def test_loss_archs_are_every_supported_arch():
    """The port runs every registry arch, so ``LOSS_ARCHS`` is the whole
    registry."""
    assert sorted(treg.ARCH_IDS) == sorted(LOSS_ARCHS)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_values_and_grads_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _carried(arch)
    nb = _arch_batch_np(jcfg, 11)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, nb), jcfg, JPOL),
        has_aux=True)(jparams)
    tb = {k: torch.as_tensor(v) for k, v in nb.items()}
    tl, tm = tmodel.loss_fn(tparams, tb, tcfg, TPOL)
    flat = topt.leaves(tparams)
    tg = topt.tree_map(lambda g: g, dict(zip(range(len(flat)),
                                             torch.autograd.grad(tl, flat))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
    assert float(tm["overflow"]) == float(jm["overflow"]) == 0.0
    if jcfg.moe is not None:
        np.testing.assert_array_equal(tm["expert_counts"].numpy(),
                                      np.asarray(jm["expert_counts"]))
    else:
        assert "expert_counts" not in tm and "expert_counts" not in jm
    want = topt.leaves(_port_tree(jg, tcfg))
    got = [tg[i] for i in range(len(flat))]
    _assert_trees_close(got, want)


def _grad_mask(jgrads, tcfg):
    """Per port leaf: where ``|g| > 1e-3 * max |g|`` over that leaf."""
    out = []
    for g in topt.leaves(_port_tree(jgrads, tcfg)):
        a = np.abs(_np(g))
        out.append(a > 1e-3 * a.max())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Two steps of ``make_train_step`` from the same params and state:
    loss, overflow, counts, grad_norm and lr, then the parameters where
    the first step's gradient is not near zero, and the moments."""
    jcfg, tcfg, jparams, tparams = _carried(arch, seed=1)
    ocfg = dict(lr=1e-3, warmup=2)
    jo = jopt.init_opt(jparams, jopt.OptConfig(**ocfg))
    tstate = opt_from_jax(jax.tree.map(np.asarray, jo), tcfg, TPOL, device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, JPOL, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(tcfg, TPOL, topt.OptConfig(**ocfg))
    nb = _arch_batch_np(jcfg, 12)
    _, jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, nb), jcfg, JPOL),
        has_aux=True)(jparams)
    masks = _grad_mask(jg, tcfg)
    tb = {k: torch.as_tensor(v) for k, v in nb.items()}
    jb = jax.tree.map(jnp.asarray, nb)
    for i in range(2):
        jparams, jo, jm = jstep(jparams, jo, jb)
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        for key in ("loss", "grad_norm", "lr", "overflow"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL, atol=ATOL)
        if jcfg.moe is not None:
            np.testing.assert_array_equal(tm["expert_counts"].numpy(),
                                          np.asarray(jm["expert_counts"]))
        if i == 0:
            got, want = topt.leaves(tparams), topt.leaves(_port_tree(jparams, tcfg))
            for a, b, m in zip(got, want, masks):
                np.testing.assert_allclose(_np(a)[m], _np(b)[m], rtol=RTOL, atol=ATOL)
            _assert_trees_close(tstate.m, _port_tree(jo.m, tcfg), atol=1e-6)
    assert int(tstate.step) == int(jo.step) == 2


def test_eval_step_and_facade():
    """The eval step through the facade, for a decoder-only model and for
    the enc-dec one (whisper-base), against the reference's loss."""
    for arch in ("gemma-2b", "whisper-base"):
        jcfg, tcfg, jparams, tparams = _carried(arch)
        nb = _arch_batch_np(jcfg, 13)
        tb = {k: torch.as_tensor(v) for k, v in nb.items()}
        out = make_eval_step(tcfg, TPOL)(tparams, tb)
        jl, _ = jmodel.loss_fn(jparams, jax.tree.map(jnp.asarray, nb), jcfg, JPOL)
        assert not out["loss"].requires_grad
        np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=RTOL, atol=ATOL)


def test_loss_decreases_on_one_batch():
    """The reference's ``test_train_loss_decreases`` on the port."""
    _, tcfg = _cfgs("gemma-2b")
    params = tmodel.init_params(tcfg, 0, TPOL, device="cpu")
    opt_cfg = topt.OptConfig(lr=1e-2, warmup=5)
    opt = topt.init_opt(params, opt_cfg)
    step = make_train_step(tcfg, TPOL, opt_cfg)
    tb = {k: torch.as_tensor(v) for k, v in _batch_np(tcfg.vocab_size, 0).items()}
    losses = []
    for _ in range(15):
        params, opt, m = step(params, opt, tb)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_moe_train_emits_expert_counts():
    _, tcfg = _cfgs("llama4-scout-17b-a16e")
    params = tmodel.init_params(tcfg, 0, TPOL, device="cpu")
    opt = topt.init_opt(params, topt.OptConfig())
    step = make_train_step(tcfg, TPOL, topt.OptConfig())
    tb = {k: torch.as_tensor(v) for k, v in _batch_np(tcfg.vocab_size, 1).items()}
    _, _, m = step(params, opt, tb)
    counts = m["expert_counts"].numpy()
    assert counts.shape == (tcfg.moe.num_experts,)
    assert counts.sum() == 2 * 32 * tcfg.moe.top_k * tcfg.num_layers


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class TestCheckpoint:
    """The reference's ``TestCheckpoint`` cases on the port, with tensors."""

    def test_roundtrip(self, tmp_path):
        tree = {"a": {"b": torch.arange(6).reshape(2, 3)}, "c": [torch.ones(2), torch.zeros(1)]}
        tckpt.save(str(tmp_path), 5, tree)
        step, back = tckpt.restore(str(tmp_path), tree)
        assert step == 5
        assert torch.equal(back["a"]["b"], tree["a"]["b"])
        assert torch.equal(back["c"][0], tree["c"][0])

    def test_keep_last_k(self, tmp_path):
        tree = {"x": torch.zeros(1)}
        for s in range(6):
            tckpt.save(str(tmp_path), s, tree, keep=2)
        steps = sorted(os.listdir(tmp_path))
        assert len(steps) == 2 and steps[-1].endswith("05")
        assert tckpt.latest_step(str(tmp_path)) == 5

    def test_corruption_falls_back(self, tmp_path):
        tree = {"x": torch.arange(4)}
        tckpt.save(str(tmp_path), 1, {"x": torch.arange(4)})
        tckpt.save(str(tmp_path), 2, {"x": torch.arange(4) * 2})
        path = os.path.join(str(tmp_path), "step_000000002", "arrays.npz")
        with open(path, "r+b") as f:
            f.seek(100)
            f.write(b"\xde\xad\xbe\xef")
        step, back = tckpt.restore(str(tmp_path), tree)
        assert step == 1
        assert torch.equal(back["x"], torch.arange(4))

    def test_crash_mid_write_is_invisible(self, tmp_path):
        tree = {"x": torch.arange(4)}
        tckpt.save(str(tmp_path), 1, tree)
        os.makedirs(os.path.join(str(tmp_path), ".tmp_9"))
        step, _ = tckpt.restore(str(tmp_path), tree)
        assert step == 1

    @pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
    def test_full_train_state_roundtrip(self, tmp_path, moments):
        _, tcfg = _cfgs("llama4-scout-17b-a16e")
        pol = dataclasses.replace(TPOL, param_dtype=torch.bfloat16)
        params = tmodel.init_params(tcfg, 0, pol, device="cpu")
        opt = topt.init_opt(params, topt.OptConfig(moment_dtype=moments))
        opt.m["embed"]["tok"].normal_()
        tree = {"params": params, "opt": opt}
        tckpt.save(str(tmp_path), 7, tree)
        step, back = tckpt.restore(str(tmp_path), tree)
        assert step == 7 and isinstance(back["opt"], topt.OptState)
        for a, b in zip(topt.leaves(tree), topt.leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _cross_tree(rng):
    return {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
            "n": {"step": np.asarray(3, np.int32), "ids": np.arange(5, dtype=np.int32)},
            "l": [rng.normal(0, 1, (2,)).astype(np.float32)]}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _cross_tree(np.random.default_rng(0))
    tree["h"] = np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))
    jckpt.save(str(tmp_path), 4, tree)
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.int32 if a.dtype == np.int32
                                              else torch.float32), tree)
    like["h"] = torch.zeros(3, dtype=torch.bfloat16)
    step, back = tckpt.restore(str(tmp_path), like)
    assert step == 4
    for key in ("w", "l"):
        np.testing.assert_array_equal(_np(topt.leaves(back[key])[0]),
                                      topt.leaves(tree[key])[0])
    np.testing.assert_array_equal(back["n"]["ids"].numpy(), tree["n"]["ids"])
    assert int(back["n"]["step"]) == 3
    assert back["h"].dtype == torch.bfloat16 and back["h"].tolist() == [1.5, -2.25, 3.0]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _cross_tree(np.random.default_rng(1))
    ttree = jax.tree.map(lambda a: torch.as_tensor(a.copy()), tree)
    ttree["h"] = torch.tensor([0.5, 8.0], dtype=torch.bfloat16)
    tckpt.save(str(tmp_path), 6, ttree)
    jlike = dict(tree, h=np.zeros(2))
    step, back = jckpt.restore(str(tmp_path), jlike)
    assert step == 6
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves({k: back[k] for k in tree})):
        np.testing.assert_array_equal(a, b)
    # the reference reads the port's bf16 leaf as it reads its own: 2-byte records
    jtree = {"h": np.asarray(jnp.asarray([0.5, 8.0], jnp.bfloat16))}
    jckpt.save(str(tmp_path / "ref"), 1, jtree)
    _, own = jckpt.restore(str(tmp_path / "ref"), jtree)
    assert back["h"].dtype == own["h"].dtype and back["h"].tobytes() == own["h"].tobytes()


# ---------------------------------------------------------------------------
# opt_from_jax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_opt_from_jax_carries_step_and_moments(moments):
    jcfg, tcfg = _cfgs("llama4-scout-17b-a16e")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(2), JPOL)
    ocfg = jopt.OptConfig(moment_dtype=getattr(jnp, moments))
    jo = jopt.init_opt(jparams, ocfg)
    step = jax.jit(jmake_train_step(jcfg, JPOL, ocfg))
    jparams, jo, _ = step(jparams, jo, jax.tree.map(jnp.asarray,
                                                     _batch_np(jcfg.vocab_size, 3)))
    got = opt_from_jax(jax.tree.map(np.asarray, jo), tcfg, TPOL, device="cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    for tree_t, tree_j in ((got.m, jo.m), (got.v, jo.v)):
        flat_j = jax.tree.leaves(jax.tree.map(np.asarray, tree_j))
        assert len(topt.leaves(tree_t)) == len(topt.leaves(_port_tree(tree_j, tcfg)))
        for a in topt.leaves(tree_t):
            assert a.dtype == getattr(torch, moments) and a.is_contiguous()
        wi = tree_t["layers"][0]["moe"]["wi"]
        np.testing.assert_array_equal(_np(wi), np.asarray(tree_j["blocks"]["b0"]["moe"]["wi"][0],
                                                          np.float32))
        assert sum(a.size for a in flat_j) == sum(a.numel() for a in topt.leaves(tree_t))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_and_resumes(tmp_path, capsys):
    args = ["--arch", "llama4-scout-17b-a16e", "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    tlaunch.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "step    3 loss=" in out
    assert tckpt.latest_step(str(tmp_path)) == 4
    tlaunch.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 2 steps" in out
    assert "step    4 loss=" in out and "step    5 loss=" in out
    assert tckpt.latest_step(str(tmp_path)) == 6


def test_launcher_moves_experts_with_their_moments(tmp_path, capsys, monkeypatch):
    """At 4 EP shards (the launcher's policy given ``ep_shards=4``), a
    forced re-placement at step 0 permutes the experts and both moments:
    each expert's state lands at its new slot."""
    seen = {}
    real = apply_placement_in_place

    def spy(trees, perm):
        seen["before"] = [{k: t[k].detach().clone() for k in ("wi", "wo")} for t in trees]
        seen["perm"] = np.asarray(perm)
        real(trees, perm)
        seen["after"] = [{k: t[k].detach().clone() for k in ("wi", "wo")} for t in trees]

    class Forced(tlaunch.PlacementController):
        def maybe_update(self):
            perm = np.asarray([2, 3, 0, 1], np.int32)
            if self.history:
                return False, self.placement, np.arange(self.e, dtype=np.int32)
            place = self.placement.place[perm]
            inv = np.zeros_like(place)
            inv[place] = np.arange(self.e, dtype=np.int32)
            self.placement = ExpertPlacement(place, inv, self.n)
            self.history.append({"forced": True})
            return True, self.placement, perm

    monkeypatch.setattr(tlaunch, "apply_placement_in_place", spy)
    monkeypatch.setattr(tlaunch, "PlacementController", Forced)
    monkeypatch.setattr(tlaunch, "Policy", functools.partial(tmod.Policy, ep_shards=4))
    tlaunch.main(["--arch", "llama4-scout-17b-a16e", "--smoke", "--batch", "2", "--seq", "16",
                  "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "step 0: KIP moved 4 experts" in out
    assert len(seen["before"]) == 3  # the parameters and both moments of the one MoE layer
    for b, a in zip(seen["before"], seen["after"]):
        for k in ("wi", "wo"):
            assert torch.equal(a[k], b[k][torch.as_tensor(seen["perm"]).long()])


# ---------------------------------------------------------------------------
# the safe point repairs the reference's moments
# ---------------------------------------------------------------------------


PERM = np.asarray([3, 0, 1, 2], np.int32)  # new slot p takes old slot PERM[p]


def test_safe_point_permutes_moments_like_a_repaired_reference():
    """A reference step whose weights *and* moments the test permutes by
    hand equals the port's step after its safe point."""
    jcfg, tcfg, jparams, tparams = _carried("llama4-scout-17b-a16e", seed=3)
    ocfg = dict(lr=1e-3, warmup=1)
    jo = jopt.init_opt(jparams, jopt.OptConfig(**ocfg))
    jstep = jax.jit(jmake_train_step(jcfg, JPOL, jopt.OptConfig(**ocfg)))
    jb = jax.tree.map(jnp.asarray, _batch_np(jcfg.vocab_size, 4))
    jparams, jo, _ = jstep(jparams, jo, jb)           # moments are now non-zero
    tparams = trainable(_port_tree(jparams, tcfg))
    tstate = opt_from_jax(jax.tree.map(np.asarray, jo), tcfg, TPOL, device="cpu")

    take = lambda a: jnp.take(a, jnp.asarray(PERM), axis=1)
    moe = lambda tree: tree["blocks"]["b0"]["moe"]
    for tree in (jparams, jo.m, jo.v):
        moe(tree)["wi"], moe(tree)["wo"] = take(moe(tree)["wi"]), take(moe(tree)["wo"])
    apply_placement_in_place(moe_state(tparams, tstate), PERM)
    for t, j in ((tparams, jparams), (tstate.m, jo.m), (tstate.v, jo.v)):
        _assert_trees_close(t, _port_tree(j, tcfg), rtol=0, atol=0)

    jb2 = jax.tree.map(jnp.asarray, _batch_np(jcfg.vocab_size, 5))
    jparams, jo, jm = jstep(jparams, jo, jb2)
    tstep = make_train_step(tcfg, TPOL, topt.OptConfig(**ocfg))
    tparams, tstate, tm = tstep(tparams, tstate,
                                {k: torch.as_tensor(np.array(v)) for k, v in jb2.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    _assert_trees_close(tstate.m, _port_tree(jo.m, tcfg))
    _assert_trees_close(tstate.v, _port_tree(jo.v, tcfg))


def test_unrepaired_reference_launcher_leaves_moments(tmp_path, monkeypatch):
    """The reference's launcher as shipped: a forced re-placement at step 0
    permutes ``wi`` and ``wo`` but leaves both moments at the old slots
    (its ``permute`` lambda is never called), so each moved expert is next
    updated with another expert's moments."""
    import repro.launch.train as jlaunch

    class Forced:
        def __init__(self, e, n):
            self.e = e
            self.placement = type("P", (), {"inv_place": np.argsort(PERM).astype(np.int32)})()
            self.loads_ewma = np.ones(e)

        def observe(self, counts):
            pass

        def maybe_update(self):
            return True, None, PERM

        def shard_loads(self, loads):
            return np.ones(1)

    saved = {}
    monkeypatch.setattr(jlaunch, "PlacementController", Forced)
    monkeypatch.setattr(jlaunch.checkpoint, "save",
                        lambda d, step, tree, keep=3: saved.update(tree=tree))
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "llama4-scout-17b-a16e", "--smoke",
                                      "--steps", "1", "--batch", "2", "--seq", "16",
                                      "--ckpt-dir", str(tmp_path)])
    jlaunch.main()
    moved = saved["tree"]
    monkeypatch.setattr(jlaunch, "PlacementController",
                        type("Off", (Forced,), {"maybe_update": lambda self: (False, None, PERM)}))
    jlaunch.main()
    still = saved["tree"]
    for key in ("wi", "wo"):
        p_m = moved["params"]["blocks"]["b0"]["moe"][key]
        p_s = still["params"]["blocks"]["b0"]["moe"][key]
        np.testing.assert_array_equal(p_m, np.take(p_s, PERM, axis=1))   # weights moved
        for mom in (1, 2):                                               # OptState m, v
            m_m = moved["opt"][mom]["blocks"]["b0"]["moe"][key]
            m_s = still["opt"][mom]["blocks"]["b0"]["moe"][key]
            np.testing.assert_array_equal(m_m, m_s)                      # moments did not
            assert not np.array_equal(m_m, np.take(m_s, PERM, axis=1))
