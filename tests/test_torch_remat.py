"""Activation checkpointing (``Policy(remat=True, remat_policy=...)``) held
against the port's own step without it and against the reference's remat
``loss_fn`` on the CPU.

Each case runs a smoke config from parameters carried from the reference
(``params_from_jax``): gemma-2b, xlstm-125m and Llama 4 Scout on the dense
oracle, and Scout at 4 stacked EP shards (``moe_apply`` in every MoE layer)
against the reference on a ``(1, 4)`` ``("data", "model")`` mesh of
``Auto`` axes in one W=4 subprocess, under ``"nothing"`` and
``"save_moe"``.  The recomputation reruns the same operations on the same
inputs, so the loss, the metrics, every gradient and a whole train step's
parameters and moments equal the port's step without remat bit for bit.
Against the reference: the training tolerance of ``tests/test_torch_train.py``
(rtol 1e-4, atol 1e-6), the atol times the grad's largest entry (at least
1) as ``tests/test_torch_moe_train.py`` holds the sharded model.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import model as jmodel
from repro.models import modules as jmod
from repro_torch.carry import params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as ttr
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step, trainable

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6
SCOUT = "llama4-scout-17b-a16e"
POLICIES = ("nothing", "save_moe")
CASES = [("gemma-2b", 0), ("xlstm-125m", 0), (SCOUT, 0), (SCOUT, 4)]
SEED = 4


def _cfgs(arch):
    return (jbase.reduce_for_smoke(jreg.get_config(arch)),
            tbase.reduce_for_smoke(treg.get_config(arch)))


def _policies(shards, **kw):
    """The reference's and the port's policy (the reference's ``mesh`` is
    set in its W=4 subprocess; ``tp=4`` there pads nothing in these
    configs' layouts)."""
    common = dict(attn_q_chunk=16, attn_kv_chunk=16, tp=4 if shards else 1)
    extra = dict(ep_shards=shards, exchange_backend="dense") if shards else {}
    return jmod.Policy(**common, **kw), tmod.Policy(**common, **extra, **kw)


def _batch(vocab):
    toks = np.random.default_rng(8).integers(0, vocab, (2, 33)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": np.ones((2, 32), np.float32)}


def _carried(arch, shards):
    jcfg, tcfg = _cfgs(arch)
    jpol, tpol = _policies(shards)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(SEED), jpol)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, tree


def _port(tcfg, tree, tpol, batch):
    """The port's ``(loss, metrics, grads)`` from fresh leaves of ``tree``."""
    params = trainable(params_from_jax(tree, tcfg, tpol, device="cpu"))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = tmodel.loss_fn(params, tb, tcfg, tpol)
    grads = torch.autograd.grad(loss, topt.leaves(params))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, node in tree.items()
                for k, v in _flat(node, f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import reduce_for_smoke
    from repro.configs.registry import get_config
    from repro.models import model
    from repro.models.modules import Policy

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, node in tree.items()
                    for k, v in flat(node, f"{prefix}{key}/").items()}
        return {prefix[:-1]: np.asarray(tree)}

    def unflat(d):
        out = {}
        for key, v in d.items():
            node = out
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(v)
        return out

    a = dict(np.load(sys.argv[2]))
    cfg = reduce_for_smoke(get_config(sys.argv[3]))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    params = unflat({k[2:]: v for k, v in a.items() if k.startswith("p/")})
    batch = {k: jnp.asarray(a["b/" + k]) for k in ("tokens", "labels", "mask")}
    out = {}
    for rp in sys.argv[4:]:
        pol = Policy(mesh=mesh, tp=4, attn_q_chunk=16, attn_kv_chunk=16,
                     exchange_backend="dense", remat=True, remat_policy=rp)
        f = lambda p: model.loss_fn(p, batch, cfg, pol)
        (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        out[rp + "/loss"] = np.asarray(loss)
        out[rp + "/counts"] = np.asarray(m["expert_counts"])
        out[rp + "/overflow"] = np.asarray(m["overflow"])
        out.update({rp + "/g/" + k: v for k, v in flat(g).items()})
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    """The reference's remat loss, counts, overflow and grads of smoke Scout
    on a ``(1, 4)`` ``Auto`` mesh under both policies."""
    jcfg, _, tree = _carried(SCOUT, 4)
    tmp = tmp_path_factory.mktemp("remat_w4")
    arrays = {f"p/{k}": v for k, v in _flat(tree).items()}
    arrays.update({f"b/{k}": v for k, v in _batch(jcfg.vocab_size).items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_W4, str(tmp / "ref.npz"), str(tmp / "in.npz"), SCOUT,
         *POLICIES], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _reference(arch, shards, rp, jcfg, tree, batch, reference_w4):
    """``(loss, counts or None, overflow, grads tree)`` of the reference's
    remat ``loss_fn``."""
    if shards:
        ref = reference_w4
        grads = _unflat({k[len(rp) + 3:]: v for k, v in ref.items()
                         if k.startswith(rp + "/g/")})
        return ref[rp + "/loss"], ref[rp + "/counts"], ref[rp + "/overflow"], grads
    jpol, _ = _policies(0, remat=True, remat_policy=rp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    f = lambda p: jmodel.loss_fn(p, jb, jcfg, jpol)
    (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    counts = np.asarray(m["expert_counts"]) if "expert_counts" in m else None
    return np.asarray(loss), counts, np.asarray(m["overflow"]), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("remat_policy", POLICIES)
@pytest.mark.parametrize("arch,shards", CASES)
def test_remat_equals_the_step_without_it_and_the_reference(request, arch, shards,
                                                            remat_policy):
    jcfg, tcfg, tree = _carried(arch, shards)
    batch = _batch(jcfg.vocab_size)
    _, plain_pol = _policies(shards)
    _, remat_pol = _policies(shards, remat=True, remat_policy=remat_policy)
    loss0, m0, g0 = _port(tcfg, tree, plain_pol, batch)
    loss, m, grads = _port(tcfg, tree, remat_pol, batch)
    assert torch.equal(loss, loss0)
    assert sorted(m) == sorted(m0) and all(torch.equal(m[k], m0[k]) for k in m)
    assert len(grads) == len(g0) and all(torch.equal(a, b) for a, b in zip(grads, g0))

    reference_w4 = request.getfixturevalue("reference_w4") if shards else None
    jl, jcounts, jover, jg = _reference(arch, shards, remat_policy, jcfg, tree, batch,
                                        reference_w4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=ATOL)
    assert float(m["overflow"]) == float(jover)
    if jcounts is not None:
        np.testing.assert_array_equal(m["expert_counts"].numpy(), jcounts)
    else:
        assert "expert_counts" not in m
    want = topt.leaves(params_from_jax(jg, tcfg, remat_pol, device="cpu"))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = w.numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("remat_policy", POLICIES)
@pytest.mark.parametrize("arch,shards", [("xlstm-125m", 0), (SCOUT, 4)])
def test_remat_train_step_equals_the_step_without_it(arch, shards, remat_policy):
    """Two ``make_train_step`` steps: metrics, parameters and both moments
    equal bit for bit."""
    jcfg, tcfg, tree = _carried(arch, shards)
    batch = {k: torch.as_tensor(v) for k, v in _batch(jcfg.vocab_size).items()}
    opt = topt.OptConfig(lr=1e-3, warmup=1)
    runs = []
    for kw in ({}, dict(remat=True, remat_policy=remat_policy)):
        _, pol = _policies(shards, **kw)
        params = params_from_jax(tree, tcfg, pol, device="cpu")
        state = topt.init_opt(params, opt)
        step = make_train_step(tcfg, pol, opt)
        metrics = []
        for _ in range(2):
            params, state, m = step(params, state, batch)
            metrics.append(m)
        runs.append((params, state, metrics))
    (p0, s0, m0), (p1, s1, m1) = runs
    for a, b in zip(m0, m1):
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    for tree0, tree1 in ((p0, p1), (s0.m, s1.m), (s0.v, s1.v)):
        assert all(torch.equal(a, b) for a, b in zip(topt.leaves(tree0), topt.leaves(tree1)))


@pytest.mark.parametrize("remat_policy,reruns", [("nothing", 2), ("save_moe", 1)])
def test_save_moe_never_reruns_the_dispatch(monkeypatch, remat_policy, reruns):
    """Under ``"nothing"`` the backward recomputes each MoE layer
    (``moe_apply``, and its two ``dispatch_count`` calls, twice a layer a
    step); under ``"save_moe"`` it keeps their activations (once).
    Attention is recomputed under both; a forward without grad is never
    checkpointed."""
    jcfg, tcfg, tree = _carried(SCOUT, 4)
    _, pol = _policies(4, remat=True, remat_policy=remat_policy)
    calls = {"moe_apply": 0, "attention_block": 0, "dispatch_count": 0}
    for mod, name in ((ttr, "moe_apply"), (ttr, "attention_block"), (ops, "dispatch_count")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    _port(tcfg, tree, pol, _batch(jcfg.vocab_size))
    layers = len(ttr.layers(tcfg))
    moe_layers = sum(blk.ffn == "moe" for blk in ttr.layers(tcfg))
    # both hops of each moe_apply rank through dispatch_count
    assert calls == {"moe_apply": reruns * moe_layers, "attention_block": 2 * layers,
                     "dispatch_count": 2 * reruns * moe_layers}
    with torch.no_grad():
        params = params_from_jax(tree, tcfg, pol, device="cpu")
        calls.update(moe_apply=0, attention_block=0, dispatch_count=0)
        tb = {k: torch.as_tensor(v) for k, v in _batch(jcfg.vocab_size).items()}
        tmodel.loss_fn(params, tb, tcfg, pol)
    assert calls == {"moe_apply": moe_layers, "attention_block": layers,
                     "dispatch_count": 2 * moe_layers}


def test_policy_fields(tmp_path):
    """``remat`` and both policies construct; another policy raises
    ``ValueError``; ``mesh`` takes a ProcessMesh, remat included, and
    raises ``ValueError`` for anything else or beside ``ep_shards``."""
    for rp in POLICIES:
        pol = tmod.Policy(remat=True, remat_policy=rp)
        assert (pol.remat, pol.remat_policy) == (True, rp)
    pol = tmod.Policy(recurrent_bf16=True, slstm_unroll=4)
    assert (pol.recurrent_bf16, pol.slstm_unroll) == (True, 4)
    for bad in ("full", "save_attn", ""):
        with pytest.raises(ValueError, match="remat_policy"):
            tmod.Policy(remat=True, remat_policy=bad)
    with pytest.raises(ValueError, match="ProcessMesh"):
        tmod.Policy(mesh=object())
    import mesh_cases
    from repro_torch.launch.mesh import MeshShape

    with pytest.raises(ValueError, match="bare MeshShape"):
        tmod.Policy(mesh=MeshShape((2, 2), ("data", "model")))
    with mesh_cases.one_rank_mesh(tmp_path) as pm:
        pol = tmod.Policy(mesh=pm, remat=True, remat_policy="save_moe")
        assert (pol.mesh, pol.remat_policy) == (pm, "save_moe")
        with pytest.raises(ValueError, match="ep_shards"):
            tmod.Policy(mesh=pm, ep_shards=2)
