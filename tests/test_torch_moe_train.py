"""The MoE layer under autograd (``repro_torch.moe.layer``) against
``jax.grad`` of the reference's layer, on the CPU.

The loss is ``sum(y * C) + 0.5 * aux_loss`` for a fixed cotangent ``C``;
its gradient reaches the router (through the combine weights and
``_aux_loss``), the experts' ``wi`` and ``wo``, the shared expert and
``x`` (through hop 1, hop 2, ``backhaul`` and ``take_from``).  The
port's ``moe_apply`` over the dense and the ragged transport and
``moe_apply_replicated`` run at 4 stacked EP shards against the reference
on a ``(1, 4)`` ``("data", "model")`` mesh of ``Auto`` axes in one W=4
subprocess (``REPRO_DISABLE_NATIVE_RAGGED=1``: XLA:CPU has no ragged
all-to-all), at capacity 1.25 (pairs dropped: they get zero gradient in
both) and 8.0, top-1 and top-2, under the identity and a permuted
placement.  Loss and grads within rtol 1e-4 and an atol of 1e-6 times
the largest entry of the grad compared (at least 1e-6): float32 sums of
terms up to that size, in XLA's order against torch's, leave that much
where they cancel.  Every input's router logits keep their top
``k + 1`` apart by more than ``MARGIN``, asserted, so a near-tie fails
loudly instead of routing apart.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoESpec
from repro_torch.exchange import backends as tbackends
from repro_torch.models import model as tmodel
from repro_torch.models.modules import Policy
from repro_torch.moe import layer
from repro_torch.moe.kip_placement import apply_placement_to_weights
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

REPO = Path(__file__).resolve().parents[1]
N = 4            # EP shards
D, F, E = 16, 32, 8
MARGIN = 1e-4
RTOL, ATOL = 1e-4, 1e-6
AUX_W = 0.5
PERM = np.asarray([5, 1, 7, 3, 0, 6, 2, 4], np.int32)  # logical expert -> slot
GRADS = ("router", "wi", "wo", "shared/wi", "shared/wo", "x")

# name -> (batch, sequence, seed): 64 tokens a shard for moe_apply, 48
# tokens (6 a row) and a decode step for the replicated path
INPUTS = {"prefill": (2, 128, 1), "ragged_seq": (8, 6, 2), "decode": (4, 1, 3)}
CASES = {
    f"apply/{be}/k{k}/cf{cf}/{place}": ("apply", be, k, cf, place, "prefill")
    for be in ("dense", "ragged") for k in (1, 2) for cf in (1.25, 8.0)
    for place in ("identity", "permuted")
}
CASES.update({
    f"replicated/k{k}/{x}": ("replicated", None, k, 1.25, "permuted", x)
    for k in (1, 2) for x in ("ragged_seq", "decode")
})


def _hot():
    return np.random.default_rng(99).normal(0, 1, D).astype(np.float32) / np.sqrt(D)


def _arrays():
    """Layer parameters (the router leaning toward expert 0, so 1.25 drops
    pairs), the inputs and a cotangent each, from numpy seeds."""
    rng = np.random.default_rng(0)
    out = {
        "p/router": rng.normal(0, D**-0.5, (D, E)).astype(np.float32),
        "p/wi": rng.normal(0, D**-0.5, (E, D, 2, F)).astype(np.float32),
        "p/wo": rng.normal(0, F**-0.5, (E, F, D)).astype(np.float32),
        "p/shared/wi": rng.normal(0, D**-0.5, (D, 2, F)).astype(np.float32),
        "p/shared/wo": rng.normal(0, F**-0.5, (F, D)).astype(np.float32),
    }
    out["p/router"][:, 0] += 0.6 * _hot()
    for name, (b, s, seed) in INPUTS.items():
        r = np.random.default_rng(seed)
        out[f"x/{name}"] = (r.normal(0, 1, (b, s, D)) + 1.5 * _hot()).astype(np.float32)
        out[f"c/{name}"] = r.normal(0, 1, (b, s, D)).astype(np.float32)
    return out


def _params(arrays, wrap):
    return {"router": wrap(arrays["p/router"]), "wi": wrap(arrays["p/wi"]),
            "wo": wrap(arrays["p/wo"]),
            "shared": {"wi": wrap(arrays["p/shared/wi"]), "wo": wrap(arrays["p/shared/wo"])}}


def _spec(k, cf):
    return MoESpec(num_experts=E, top_k=k, d_ff_expert=F, shared_expert=True, capacity_factor=cf)


def _inv(place):
    return np.arange(E, dtype=np.int32) if place == "identity" else PERM


def _assert_margin(router, x, k):
    logits = np.sort(x.reshape(-1, D).astype(np.float64) @ router.astype(np.float64),
                     axis=-1)[:, ::-1]
    gaps = logits[:, :k] - logits[:, 1:k + 1]
    assert gaps.min() > MARGIN, f"a near-tie in the router logits: {gaps.min():.3g}"


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import MoESpec
    from repro.models.modules import Policy
    from repro.moe.layer import moe_apply, moe_apply_replicated
    cases, E, F, aux_w = json.loads(sys.argv[2])
    a = dict(np.load(sys.argv[3]))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    p = {"router": a["p/router"], "wi": a["p/wi"], "wo": a["p/wo"],
         "shared": {"wi": a["p/shared/wi"], "wo": a["p/shared/wo"]}}
    p = jax.tree.map(jnp.asarray, p)
    perm = np.asarray([5, 1, 7, 3, 0, 6, 2, 4], np.int32)
    out = {}
    for name, (path, be, k, cf, place, xname) in cases.items():
        spec = MoESpec(num_experts=E, top_k=k, d_ff_expert=F, shared_expert=True,
                       capacity_factor=cf)
        pol = Policy(mesh=mesh, tp=4, exchange_backend=be)
        inv = jnp.asarray(np.arange(E, dtype=np.int32) if place == "identity" else perm)
        x, c = jnp.asarray(a[f"x/{xname}"]), jnp.asarray(a[f"c/{xname}"])
        fn = moe_apply if path == "apply" else moe_apply_replicated

        def loss(pp, xx):
            o = fn(pp, xx, spec, "swiglu", pol, inv)
            return jnp.sum(o.y * c) + aux_w * o.aux_loss, (o.counts, o.overflow)

        try:
            (l, (counts, over)), (gp, gx) = jax.jit(
                jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
        except Exception as e:  # recorded, not raised: the port test reports it
            out[f"{name}/error"] = np.asarray(repr(e)[:2000])
            continue
        res = {"loss": l, "counts": counts, "overflow": over, "router": gp["router"],
               "wi": gp["wi"], "wo": gp["wo"], "shared/wi": gp["shared"]["wi"],
               "shared/wo": gp["shared"]["wo"], "x": gx}
        for key, v in res.items():
            out[f"{name}/{key}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_grad_w4")
    np.savez(tmp / "in.npz", **_arrays())
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_W4, str(tmp / "ref.npz"),
         json.dumps([CASES, E, F, AUX_W]), str(tmp / "in.npz")],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _port_grads(path, be, k, cf, place, xname):
    arrays = _arrays()
    p = _params(arrays, lambda a: torch.as_tensor(a.copy()).requires_grad_())
    x = torch.as_tensor(arrays[f"x/{xname}"]).requires_grad_()
    fn = layer.moe_apply if path == "apply" else layer.moe_apply_replicated
    pol = Policy(tp=4, ep_shards=N, exchange_backend=be)
    out = fn(p, x, _spec(k, cf), "swiglu", pol, torch.as_tensor(_inv(place)))
    loss = (out.y * torch.as_tensor(arrays[f"c/{xname}"])).sum() + AUX_W * out.aux_loss
    flat = [p["router"], p["wi"], p["wo"], p["shared"]["wi"], p["shared"]["wo"], x]
    return loss, out, dict(zip(GRADS, torch.autograd.grad(loss, flat)))


@pytest.mark.parametrize("case", list(CASES))
def test_layer_grads_match_reference(reference_w4, case):
    path, be, k, cf, place, xname = CASES[case]
    arrays = _arrays()
    _assert_margin(arrays["p/router"], arrays[f"x/{xname}"], k)
    ref = {key[len(case) + 1:]: v for key, v in reference_w4.items()
           if key.startswith(case + "/")}
    assert "error" not in ref, str(ref.get("error"))
    loss, out, grads = _port_grads(path, be, k, cf, place, xname)
    np.testing.assert_array_equal(out.counts.numpy(), ref["counts"])
    assert float(out.overflow) == float(ref["overflow"])
    np.testing.assert_allclose(float(loss.detach()), float(ref["loss"]), rtol=RTOL, atol=ATOL)
    for name in GRADS:
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(grads[name].numpy(), ref[name], rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)


def test_cases_cover_drops_and_none(reference_w4):
    """Capacity 1.25 drops pairs on the prefill path; 8.0 drops none."""
    for case, (path, be, k, cf, place, xname) in CASES.items():
        over = float(reference_w4[f"{case}/overflow"])
        if cf == 8.0:
            assert over == 0.0, case
        elif path == "apply":
            assert over > 0.0, case


@pytest.mark.parametrize("be", ["dense", "ragged"])
@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_grads_equal_the_oracle_without_drops(be, k):
    """At capacity 8.0 (nothing dropped) the dispatch's grads of
    ``sum(y * C)`` equal the dense oracle's, also with the weights laid out
    by a permuted placement (the grads of the placed weights are the
    oracle's, placed).  The aux loss stays out: the dispatch averages it
    over the shards' sequence slices, the oracle takes it over all tokens,
    as in the reference."""
    arrays = _arrays()
    x = arrays["x/prefill"]
    c = torch.as_tensor(arrays["c/prefill"])
    spec = _spec(k, 8.0)
    grads = []
    for fn, perm in ((layer.moe_ref, None), (layer.moe_apply, PERM)):
        p = _params(arrays, lambda a: torch.as_tensor(a.copy()))
        if perm is not None:
            p = apply_placement_to_weights(p, np.argsort(perm))
        for t in (p["router"], p["wi"], p["wo"], p["shared"]["wi"], p["shared"]["wo"]):
            t.requires_grad_()
        tx = torch.as_tensor(x).requires_grad_()
        pol = Policy(ep_shards=N if perm is not None else 0, exchange_backend=be)
        out = fn(p, tx, spec, "swiglu", pol, None if perm is None else torch.as_tensor(perm))
        g = torch.autograd.grad((out.y * c).sum(), [p["router"], p["wi"], p["wo"], tx])
        if perm is not None:  # slot PERM[e] holds expert e
            g = [g[0], g[1][torch.as_tensor(PERM).long()], g[2][torch.as_tensor(PERM).long()],
                 g[3]]
        grads.append(g)
        for t in (out.counts, out.overflow):
            assert not t.requires_grad
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("be", ["dense", "ragged"])
def test_training_never_takes_the_recycled_buffers(be, monkeypatch):
    """A train step of smoke Scout at 4 EP shards buckets every exchange
    into fresh buffers (``scatter_rows`` without ``out=``): the recycled
    path refills a buffer in place, which autograd cannot follow."""
    calls = []
    real = tbackends.scatter_rows

    def spy(*a, out=None, **kw):
        calls.append(out is None)
        return real(*a, out=out, **kw)

    monkeypatch.setattr(tbackends, "scatter_rows", spy)
    cfg = tbase.reduce_for_smoke(treg.get_config("llama4-scout-17b-a16e"))
    pol = Policy(attn_q_chunk=16, attn_kv_chunk=16, ep_shards=N, exchange_backend=be)
    params = tmodel.init_params(cfg, 0, pol, device="cpu")
    opt = topt.init_opt(params, topt.OptConfig())
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": torch.ones(2, 32)}
    _, _, m = make_train_step(cfg, pol, topt.OptConfig())(params, opt, batch)
    assert calls and all(calls), calls
    assert float(m["expert_counts"].sum()) == 2 * 32 * cfg.moe.top_k * cfg.num_layers
    assert not m["expert_counts"].requires_grad and not m["overflow"].requires_grad


def test_dropped_pairs_get_zero_gradient():
    """A token whose every (token, expert) pair overflowed contributes to
    ``y`` only through the shared expert, so its routed gradient is zero:
    the dropped rows land in the spare cell that is cut off."""
    arrays = _arrays()
    p = _params(arrays, lambda a: torch.as_tensor(a.copy()))
    p["shared"] = {"wi": torch.zeros(D, 2, F), "wo": torch.zeros(F, D)}
    x = torch.as_tensor(arrays["x/prefill"]).requires_grad_()
    spec = _spec(1, 0.25)  # a lane of 8 records: most pairs drop
    out = layer.moe_apply(p, x, spec, "swiglu", Policy(ep_shards=N), None)
    assert float(out.overflow) > 0
    (gx,) = torch.autograd.grad((out.y * torch.as_tensor(arrays["c/prefill"])).sum(), [x])
    dead = (out.y.detach().abs().sum(-1) == 0)
    assert bool(dead.any()) and bool((~dead).any())
    assert float(gx[dead].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# loss_fn of whole smoke MoE models at 4 shards
# ---------------------------------------------------------------------------

MODEL_ARCHS = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b")
MODEL_CASES = [(arch, be) for arch in MODEL_ARCHS for be in ("dense", "ragged")]

REFERENCE_LOSS_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
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

    cases = json.loads(sys.argv[2])
    a = dict(np.load(sys.argv[3]))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    out = {}
    for arch, be in cases:
        cfg = reduce_for_smoke(get_config(arch))
        pol = Policy(mesh=mesh, tp=4, attn_q_chunk=16, attn_kv_chunk=16, exchange_backend=be)
        params = unflat({k[len(arch) + 3:]: v for k, v in a.items()
                         if k.startswith(arch + "/p/")})
        batch = {k: jnp.asarray(a[f"{arch}/b/{k}"]) for k in ("tokens", "labels", "mask")}
        f = lambda p: model.loss_fn(p, batch, cfg, pol)
        (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        pre = f"{arch}/{be}/"
        out[pre + "loss"] = np.asarray(loss)
        out[pre + "counts"] = np.asarray(m["expert_counts"])
        out[pre + "overflow"] = np.asarray(m["overflow"])
        out.update({pre + "g/" + k: v for k, v in flat(g).items()})
    np.savez(sys.argv[1], **out)
""")


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


@pytest.fixture(scope="module")
def reference_loss_w4(tmp_path_factory):
    """The reference's loss, counts, overflow and grads of smoke Scout and
    Maverick on a ``(1, 4)`` ``Auto`` mesh (``tp=4``), from parameters made
    in this process."""
    import jax

    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.models import model as jmodel
    from repro.models.modules import Policy as JPolicy

    tmp = tmp_path_factory.mktemp("moe_loss_w4")
    arrays = {}
    for arch in MODEL_ARCHS:
        cfg = jbase.reduce_for_smoke(jreg.get_config(arch))
        jp = jmodel.init_params(cfg, jax.random.PRNGKey(4), JPolicy(tp=4))
        arrays.update({f"{arch}/p/{k}": v for k, v in _flat(jp).items()})
        rng = np.random.default_rng(8)
        toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
        arrays.update({f"{arch}/b/tokens": toks[:, :-1], f"{arch}/b/labels": toks[:, 1:],
                       f"{arch}/b/mask": np.ones((2, 32), np.float32)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_LOSS_W4, str(tmp / "ref.npz"),
         json.dumps(MODEL_CASES), str(tmp / "in.npz")],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return arrays, dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("arch,be", MODEL_CASES)
def test_loss_fn_at_four_shards_matches_reference(reference_loss_w4, arch, be, monkeypatch):
    """``model.loss_fn`` of a whole smoke MoE model at 4 stacked EP shards
    (``moe_apply`` in every MoE layer, dense and ragged) against the
    reference's at 4 devices: loss, counts and overflow, and every
    parameter's grad (tolerance as above); each router call keeps its top
    two logits more than ``MARGIN`` apart."""
    from repro_torch.carry import params_from_jax
    from repro_torch.models import transformer as ttr

    arrays, ref = reference_loss_w4
    cfg = tbase.reduce_for_smoke(treg.get_config(arch))
    pol = Policy(tp=4, ep_shards=N, attn_q_chunk=16, attn_kv_chunk=16, exchange_backend=be)
    tree = _unflat({k[len(arch) + 3:]: v for k, v in arrays.items()
                    if k.startswith(arch + "/p/")})
    params = params_from_jax(tree, cfg, pol, device="cpu")
    for t in topt.leaves(params):
        t.requires_grad_()
    gaps, paths = [], []
    route = layer._route

    def recording(router_w, t, spec):
        logits = (t.detach().to(torch.float32) @ router_w.detach().to(torch.float32)).double()
        top = torch.topk(logits, spec.top_k + 1, dim=-1).values
        gaps.append(float((top[:, :-1] - top[:, 1:]).min()))
        return route(router_w, t, spec)

    monkeypatch.setattr(layer, "_route", recording)
    for name in ("moe_apply", "moe_apply_replicated", "moe_ref"):
        fn = getattr(ttr, name)
        monkeypatch.setattr(ttr, name, lambda *a, _fn=fn, _n=name, **k: (paths.append(_n),
                                                                          _fn(*a, **k))[1])
    batch = {k: torch.as_tensor(arrays[f"{arch}/b/{k}"]) for k in ("tokens", "labels", "mask")}
    loss, m = tmodel.loss_fn(params, batch, cfg, pol)
    grads = torch.autograd.grad(loss, topt.leaves(params))
    pre = f"{arch}/{be}/"
    moe_layers = sum(blk.ffn == "moe" for blk in ttr.layers(cfg))
    assert paths == ["moe_apply"] * moe_layers
    assert gaps and min(gaps) > MARGIN, f"a router near-tie: {min(gaps):.3g}"
    np.testing.assert_array_equal(m["expert_counts"].numpy(), ref[pre + "counts"])
    assert float(m["overflow"]) == float(ref[pre + "overflow"])
    np.testing.assert_allclose(float(loss.detach()), float(ref[pre + "loss"]), rtol=RTOL,
                               atol=ATOL)
    want = _unflat({k[len(pre) + 2:]: v for k, v in ref.items() if k.startswith(pre + "g/")})
    want = topt.leaves(params_from_jax(want, cfg, Policy(tp=4), device="cpu"))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = w.numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL * scale)
