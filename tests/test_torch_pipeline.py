"""The GPipe pipeline held against the reference on the CPU.

``stack_stage_params``' stages and its ``ValueError``s (a pattern of more
than one block, a tail, periods the stages do not divide).  Then the
reference's own case, stablelm-1.6b's smoke config at 4 layers, 4 x 32
tokens in 2 microbatches: the port's pipelined loss and every gradient at
2 and 4 gloo stages, with and without remat, against the reference's
``make_pp_loss`` on an ``Auto``-axis mesh (``jax.sharding.Mesh``, the
parameters carried by ``params_from_jax``) and against the port's plain
``loss_fn``: the loss within rtol 2e-4 (the reference's own test's
limit), each leaf's gradient within 1e-3 by relative norm.

The reference's own ``tests/test_pipeline.py`` builds its mesh with
``jax.make_mesh``, whose axes are ``Explicit`` on jax 0.9.0: its loss runs
under ``set_mesh``, and its ``jax.grad``, taken outside it, raises.  The
reference subprocess runs that too, and a test pins the error.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import train_dist_cases as tc
from repro_torch.carry import _layers_from_jax, params_from_jax
from repro_torch.configs.registry import get_config
from repro_torch.launch.pipeline import make_pp_loss, stack_stage_params, stage_params
from repro_torch.models import model
from repro_torch.models.modules import Policy
from repro_torch.train.optimizer import leaves

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2e-4
GRAD_REL = 1e-3
STAGES = (2, 4)

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[2])
    import train_dist_cases as tc
    from repro.compat import set_mesh
    from repro.configs.base import reduce_for_smoke
    from repro.configs.registry import get_config
    from repro.launch.pipeline import make_pp_loss, stack_stage_params
    from repro.models import model
    from repro.models.modules import Policy
    out_dir = sys.argv[1]

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}{k}/")
        else:
            yield prefix.rstrip("/"), np.asarray(tree)

    cfg = dataclasses.replace(reduce_for_smoke(get_config("stablelm-1.6b")),
                              num_layers=tc.PP_LAYERS)
    pol = Policy(attn_q_chunk=tc.PP_CHUNK, attn_kv_chunk=tc.PP_CHUNK)
    params = model.init_params(cfg, jax.random.PRNGKey(0), pol)
    np.savez(os.path.join(out_dir, "params.tmp.npz"), **dict(flat(params)))
    os.replace(os.path.join(out_dir, "params.tmp.npz"), os.path.join(out_dir, "params.npz"))
    batch = {k: jnp.asarray(v) for k, v in tc.pp_batch(cfg.vocab_size).items()}
    out = {}
    for remat in (False, True):
        p = dataclasses.replace(pol, remat=remat)
        loss, g = jax.jit(jax.value_and_grad(
            lambda q, b: model.loss_fn(q, b, cfg, p)[0]))(params, batch)
        out[f"plain/{remat}/loss"] = np.asarray(loss)
        for k, v in flat(g):
            out[f"plain/{remat}/grad/{k}"] = v
        for n in (2, 4):
            mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("pod",))
            pp = make_pp_loss(cfg, p, mesh, microbatches=tc.PP_MICRO)
            loss, g = jax.jit(jax.value_and_grad(lambda q, b: pp(q, b)))(
                stack_stage_params(cfg, params, n), batch)
            out[f"pp/{n}/{remat}/loss"] = np.asarray(loss)
            g = {**g, "blocks": jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]),
                                             g["blocks"])}
            for k, v in flat(g):
                out[f"pp/{n}/{remat}/grad/{k}"] = v
    # the reference's own test's mesh: Explicit axes, the grad outside set_mesh
    mesh = jax.make_mesh((2,), ("pod",))
    stacked = stack_stage_params(cfg, params, 2)
    with set_mesh(mesh):
        pp = make_pp_loss(cfg, pol, mesh, microbatches=tc.PP_MICRO)
        out["explicit/loss"] = np.asarray(jax.jit(pp)(stacked, batch))
    try:
        jax.grad(lambda q: pp(q, batch))(stacked)
        out["explicit/grad error"] = np.asarray("")
    except Exception as e:
        out["explicit/grad error"] = np.asarray(f"{type(e).__name__}: {e}")
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, and, once it has written the parameters,
    the port's 2 and 4 gloo stages beside it."""
    d = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d), str(REPO / "tests")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctxs = {}
    try:
        deadline = time.monotonic() + tc.SPAWN_TIMEOUT_S
        while not (d / "params.npz").exists():
            if ref.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the reference wrote no parameters: "
                                   + ref.communicate()[1][-4000:])
            time.sleep(0.2)
        plan = {"case": "pipeline", "params": str(d / "params.npz")}
        for n in STAGES:
            ctxs[n] = tc.start(d / f"w{n}", n, {**plan, "plain": n == 2})
        ranks = {n: tc.wait(ctx, d / f"w{n}", n) for n, ctx in ctxs.items()}
        _, err = ref.communicate(timeout=tc.SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    assert ref.returncode == 0, err[-4000:]
    return ranks, dict(np.load(d / "ref.npz")), tc.nest(dict(np.load(d / "params.npz")))


def _rank_view(tree: dict, n: int, rank: int) -> list:
    """What rank ``rank`` of ``n`` holds of a full reference-layout tree
    (numpy, periods unstacked), in the order of ``leaves``."""
    cfg = tc.pp_config()
    port = _layers_from_jax(tree, cfg, lambda a, name: a)
    return leaves(stage_params(stack_stage_params(cfg, port, n), rank))


def _ref_tree(ref: dict, prefix: str, like: dict) -> dict:
    """The reference's arrays under ``prefix`` as a tree in the key order of
    ``like`` (the parameters' tree; jax hands gradients back sorted)."""
    def paths(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from paths(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}"

    return tc.nest({k: ref[prefix + k] for k in paths(like)})


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_stack_stage_params_splits_the_layers():
    cfg = tc.pp_config()
    params = model.init_params(cfg, 0, Policy(), device="cpu")
    for n in (1, 2, 4):
        stacked = stack_stage_params(cfg, params, n)
        assert [len(s) for s in stacked["layers"]] == [cfg.num_layers // n] * n
        flat = [layer for s in stacked["layers"] for layer in s]
        assert all(a is b for a, b in zip(flat, params["layers"]))
        assert stacked["embed"] is params["embed"] and stacked["lm_head"] is params["lm_head"]
        for r in range(n):
            mine = stage_params(stacked, r)
            assert mine["layers"] == stacked["layers"][r]
    with pytest.raises(ValueError, match="do not split"):
        stack_stage_params(cfg, params, 3)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "gemma3-27b", "gemma-2b"])
def test_stack_stage_params_refuses_what_the_reference_asserts(arch):
    """jamba's pattern of 8 blocks and gemma3's tail raise, as the
    reference's asserts; gemma-2b's 18 periods do not split into 4."""
    cfg = get_config(arch)
    params = {"layers": [None] * (cfg.num_layers - len(cfg.tail))}
    with pytest.raises(ValueError):
        stack_stage_params(cfg, params, 4)


def test_microbatches_must_divide_the_batch():
    cfg = tc.pp_config()

    class One:
        rank, world_size = 0, 1

    loss_fn = make_pp_loss(cfg, Policy(), One(), microbatches=3)
    batch = {k: torch.from_numpy(v) for k, v in tc.pp_batch(cfg.vocab_size).items()}
    with pytest.raises(ValueError, match="microbatches"):
        loss_fn(model.init_params(cfg, 0, Policy(), device="cpu"), batch)


@pytest.mark.parametrize("remat", [False, True], ids=["no remat", "remat"])
@pytest.mark.parametrize("n", STAGES)
def test_pp_loss_matches_reference_and_plain(runs, n, remat):
    ranks, ref, _ = runs
    losses = [float(r[f"pp/{remat}"]["loss"]) for r in ranks[n]]
    assert len(set(losses)) == 1                       # every rank the same loss
    np.testing.assert_allclose(losses[0], float(ref[f"pp/{n}/{remat}/loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[0], float(ranks[2][0][f"plain/{remat}"]["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(ref[f"pp/{n}/{remat}/loss"]),
                               float(ref[f"plain/{remat}/loss"]), rtol=LOSS_RTOL)


@pytest.mark.parametrize("remat", [False, True], ids=["no remat", "remat"])
@pytest.mark.parametrize("n", STAGES)
def test_pp_grads_match_reference_and_plain(runs, n, remat):
    """Each rank's gradient of each leaf it holds, the replicated ones
    summed over the ranks, within 1e-3 by relative norm of the
    reference's pipelined gradient and of the port's plain one."""
    ranks, ref, tree = runs
    plain = ranks[2][0][f"plain/{remat}"]["grads"]
    cfg = tc.pp_config()
    params = params_from_jax(tree, cfg, Policy(), device="cpu")   # the ranks' layout
    index = {id(p): i for i, p in enumerate(leaves(params))}
    want_ref = _ref_tree(ref, f"pp/{n}/{remat}/grad/", tree)
    worst = 0.0
    for r in ranks[n]:
        rank = r["rank"]
        got = r[f"pp/{remat}"]["grads"]
        mine = leaves(stage_params(stack_stage_params(cfg, params, n), rank))
        want = _rank_view(want_ref, n, rank)
        assert len(got) == len(want) == len(mine)
        for i, (g, w, p) in enumerate(zip(got, want, mine)):
            assert tuple(g.shape) == w.shape
            rels = (_rel(g, w), _rel(g, plain[index[id(p)]]))
            assert max(rels) <= GRAD_REL, (rank, i, tuple(g.shape), rels)
            worst = max(worst, *rels)
    assert worst <= GRAD_REL, worst


@pytest.mark.parametrize("n", STAGES)
def test_replicated_grads_are_summed_on_every_rank(runs, n):
    """The embedding, the LM head and the final norm: every rank holds the
    same gradient (their sum over the stages)."""
    ranks, _, _ = runs
    rep = ranks[n][0]["pp/False"]["grads"]
    # leaves order: embed, final_norm (b, w), lm_head, then the layers
    for r in ranks[n][1:]:
        for a, b in zip(rep[:4], r["pp/False"]["grads"][:4]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", STAGES)
def test_pp_hands_one_activation_a_tick(runs, n):
    """M + S - 1 forward hand-offs of a microbatch's activation, and M + S
    - 2 backward ones (the last tick's output is never read): float32
    ``[B / M, S, d]``, on every rank but the last (which sends nowhere)."""
    ranks, _, _ = runs
    cfg = tc.pp_config()
    one = tc.PP_BATCH // tc.PP_MICRO * tc.PP_SEQ * cfg.d_model * 4
    ticks = tc.PP_MICRO + n - 1
    for r in ranks[n]:
        want = 0 if r["rank"] == n - 1 else ticks * one
        # backward: to rank - 1, from every rank but the first
        want += 0 if r["rank"] == 0 else (ticks - 1) * one
        assert r["pp/False"]["shift_bytes"] == want
        assert torch.equal(r["no grad"], ranks[n][0]["no grad"])


def test_reference_fails_on_an_explicit_mesh(runs):
    """The reference's own test's mesh: the loss under ``set_mesh`` runs
    (and equals the Auto mesh's), the grad outside it raises."""
    _, ref, _ = runs
    np.testing.assert_allclose(float(ref["explicit/loss"]), float(ref["pp/2/False/loss"]),
                               rtol=1e-6)
    err = str(ref["explicit/grad error"])
    assert "Length of device assignment 1 is not equal to the size of the mesh 2" in err, err


def test_a_hand_off_one_rank_skips_fails_by_the_timeout(tmp_path):
    """No rank drops a collective silently: where one rank skips a hand-off
    the others wait on it, and the spawn's timeout kills the ranks and
    raises (as phase 26's ranks on the card do)."""
    ctx = tc.start(tmp_path, 2, {"case": "mismatched hand-off"})
    with pytest.raises(TimeoutError):
        tc.wait(ctx, tmp_path, 2, timeout_s=8)
    assert not any(p.is_alive() for p in ctx.processes)
