"""``Policy.mesh`` on the CPU: ``make_policy`` and both MoE paths over a
process mesh's model axis, held against the reference's ``shard_map`` run.

A module fixture spawns four gloo ranks once (``tests/mesh_cases.py``, a
``file://`` store under the test's temporary directory) and, beside them,
one reference subprocess with four host devices on ``Auto``-axis meshes
(``REPRO_DISABLE_NATIVE_RAGGED=1``: XLA:CPU has no ragged all-to-all).
Each rank lays the ``(1, 4)`` and the ``(2, 2)`` ``("data", "model")``
mesh over the group (``launch.mesh.ProcessMesh``) and runs:

* ``moe_apply`` (dense, ragged with the native uneven ship and masked) and
  ``moe_apply_replicated``, top-1 and top-2, capacity 1.25 (drops) and
  8.0, identity and permuted placement, with and without the shared
  expert, on its own expert slots (``carry.rank_params``);
* the Scout smoke model's ``prefill`` and three teacher-forced
  ``decode_step`` calls under ``make_policy``, and at ``(1, 4)`` one
  ``ServeEngine`` pass;
* the data-axis contract at ``(2, 2)`` and ``init_rank_params``.

Equal exactly: counts, overflow, shipped and occupied rows, the exchange
stats, greedy tokens, the MoE path each call takes.  ``y`` and
``aux_loss`` within 1e-5 (float32; XLA's dots against torch's), logits
and caches within 1e-4 (as ``tests/test_torch_moe_serve.py``).  Every
rank's ``y`` and logits equal every other rank's bit for bit.  Every
router input keeps its top ``k + 1`` logits apart by more than
``MARGIN``, so that a near-tie fails loudly.  ``make_policy``'s fields are
held to the reference's for every registry architecture, in this process,
on ``AbstractMesh``.  The whole file takes about 60-80 s.
"""
import json
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

import mesh_cases as mc
from repro.configs.base import reduce_for_smoke
from repro.configs.registry import ARCH_IDS, get_config
from repro.launch import sharding as jsh
from repro.models import model as jmodel
from repro.models.modules import Policy as JPolicy
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoESpec
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.modules import Policy
from repro_torch.moe import layer

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5        # y and aux_loss, float32
MODEL_TOL = 1e-4  # logits and caches, float32

REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[3])
    import mesh_cases as mc
    from repro.configs.base import MoESpec, reduce_for_smoke
    from repro.configs.registry import get_config
    from repro.launch.sharding import ShardingOptions, make_policy
    from repro.models import model
    from repro.models.modules import Policy
    from repro.moe.layer import moe_apply, moe_apply_replicated
    from repro.serve.engine import Request, ServeEngine
    params_dir = sys.argv[2]
    arrays = mc.moe_arrays()
    meshes = {n: jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(d), ("data", "model"))
              for n, d in mc.MESHES.items()}
    out = {}
    for name, (m, path, be, k, cf, place, shared, xname) in mc.MOE_CASES.items():
        spec = MoESpec(num_experts=mc.E, top_k=k, d_ff_expert=mc.F, shared_expert=shared,
                       capacity_factor=cf)
        pol = Policy(mesh=meshes[m], tp=mc.MESHES[m][1], exchange_backend=be)
        p = mc.moe_params(arrays, jnp.asarray, shared)
        fn = moe_apply if path == "apply" else moe_apply_replicated
        inv = jnp.asarray(mc.inv_place(place))
        got = jax.jit(lambda pp, xx: fn(pp, xx, spec, "swiglu", pol, inv))(
            p, jnp.asarray(arrays["x/" + xname]))
        st = got.exchange_stats(padded_rows=123, backend=be)
        res = {"y": got.y, "counts": got.counts, "overflow": got.overflow, "aux": got.aux_loss,
               "stats": np.asarray([st.rows, st.padded_rows,
                                    -1 if st.occupied_rows is None else st.occupied_rows])}
        if got.shipped_rows is not None:
            res["shipped"], res["occupied"] = got.shipped_rows, got.occupied_rows
        for key, v in res.items():
            out[name + "/" + key] = np.asarray(v)
    spec = MoESpec(num_experts=mc.E, top_k=1, d_ff_expert=mc.F, shared_expert=True)
    pol = Policy(mesh=meshes["2x2"], tp=2)
    errors = {}
    for b in mc.CONTRACT_BATCHES:
        try:
            moe_apply(mc.moe_params(arrays, jnp.asarray, True), jnp.asarray(mc.contract_x(b)),
                      spec, "swiglu", pol, jnp.arange(mc.E, dtype=jnp.int32))
            errors[b] = None
        except ValueError as e:
            errors[b] = str(e)
    cfg = reduce_for_smoke(get_config(mc.SCOUT))
    opts = ShardingOptions(compute_dtype=jnp.float32, param_dtype=jnp.float32)
    specs = {}
    for m, mesh in meshes.items():
        pol = make_policy(cfg, mesh, "prefill", opts)
        dpol = make_policy(cfg, mesh, "decode", opts)
        params = jax.tree.map(jnp.asarray, mc.unflat(dict(np.load(f"{params_dir}/{m}.npz"))))
        prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cfg, pol, mc.MAX_LEN))
        step = jax.jit(lambda p, c, t: model.decode_step(p, c, t, cfg, dpol))
        for name in mc.PROMPTS:
            prompt, steps = mc.prompt_tokens(name)
            logits, cache = prefill(params, jnp.asarray(prompt))
            pre = f"{m}/model/{name}/"
            def keep(tag, c):
                blk = jax.tree.map(lambda a: a[0], c["blocks"]["b0"])
                out[pre + tag + "/k"], out[pre + tag + "/v"] = np.asarray(blk["k"]), np.asarray(blk["v"])
                out[pre + tag + "/slot_pos"] = np.asarray(blk["pos"])
                out[pre + tag + "/pos"] = np.asarray(c["pos"])
            keep("prefill_cache", cache)
            out[pre + "logits/0"] = np.asarray(logits)
            for i, tok in enumerate(steps):
                logits, cache = step(params, cache, jnp.asarray(tok))
                out[pre + f"logits/{i + 1}"] = np.asarray(logits)
            keep("cache", cache)
        if m == "1x4":
            # the engine under the decode policy: the prefill policy's act_btd
            # constraint refuses a prompt the model axis does not divide
            reqs = [Request(rid=i, prompt=p, max_new_tokens=mc.ENGINE_NEW)
                    for i, p in enumerate(mc.engine_prompts())]
            eng = ServeEngine(cfg, params, dpol, slots=mc.ENGINE_SLOTS, max_len=mc.ENGINE_MAX_LEN)
            eng.run(reqs, max_ticks=100)
            out["engine/tokens"] = np.asarray([r.out_tokens for r in reqs])
            out["engine/counts"] = np.asarray([eng.steps, eng.tokens_out])
        else:
            for name, shape in (("act_btd", (2, 8, 64)), ("act_q", (2, 8, 4, 16)),
                                ("act_kv", (2, 8, 4, 16)), ("ffn_hidden4", (2, 8, 2, 64)),
                                ("ssm_inner", (2, 8, 64)), ("logits", (2, 8, 512))):
                sh = jax.jit(lambda x: pol.shard(x, name)).lower(
                    jnp.zeros(shape)).compile().output_shardings
                specs[name] = [list(a) if isinstance(a, tuple) else a for a in sh.spec]
    np.savez(sys.argv[1], **out)
    with open(sys.argv[1] + ".json", "w") as f:
        json.dump({"errors": errors, "specs": specs}, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, from one spawn and one
    subprocess running side by side on the same reference parameters."""
    d = tmp_path_factory.mktemp("policy_mesh")
    cfg = reduce_for_smoke(get_config(mc.SCOUT))
    plan = {"params": {}}
    for name, (_, ntp) in mc.MESHES.items():
        jp = jmodel.init_params(cfg, jax.random.PRNGKey(3), JPolicy(tp=ntp))
        np.savez(d / f"{name}.npz", **mc.flat(jp))
        plan["params"][name] = str(d / f"{name}.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_W4, str(d / "ref.npz"), str(d),
                            str(REPO / "tests")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = mc.spawn(d, plan)
        _, err = ref.communicate(timeout=mc.SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    extra = json.loads((d / "ref.npz.json").read_text())
    return ranks, dict(np.load(d / "ref.npz")), extra


def _assert_margin(router, x, k):
    logits = np.sort(x.reshape(-1, mc.D).astype(np.float64) @ router.astype(np.float64),
                     axis=-1)[:, ::-1]
    gaps = logits[:, :k] - logits[:, 1:k + 1]
    assert gaps.min() > mc.MARGIN, f"a near-tie in the router logits: {gaps.min():.3g}"


# ---------------------------------------------------------------------------
# the mesh and make_policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_process_mesh_lays_ranks_in_order(runs, mesh):
    """Rank r sits at unravel_index(r, dims); each axis's subgroup holds the
    ranks that share its other coordinates, numbered along the axis."""
    ranks, _, _ = runs
    dims = mc.MESHES[mesh]
    for r, rec in enumerate(ranks):
        i, j = np.unravel_index(r, dims)
        got = rec[mesh]
        assert got["coords"] == {"data": i, "model": j}
        assert got["subgroups"]["model"] == [i * dims[1] + c for c in range(dims[1])]
        assert got["subgroups"]["data"] == [c * dims[1] + j for c in range(dims[0])]
        assert got["subgroups"]["all"] == list(range(mc.W))
        assert got["index"] == [i, j, r]


def _ref_fields(pol) -> dict:
    return {"param_dtype": jnp.dtype(pol.param_dtype).name,
            "compute_dtype": jnp.dtype(pol.compute_dtype).name, "tp": pol.tp,
            "dp_axes": list(pol.dp_axes), "tp_axis": pol.tp_axis, "remat": pol.remat,
            "attn_q_chunk": pol.attn_q_chunk, "attn_kv_chunk": pol.attn_kv_chunk,
            "attn_p_bf16": pol.attn_p_bf16, "recurrent_bf16": pol.recurrent_bf16,
            "remat_policy": pol.remat_policy, "moe_capacity_factor": pol.moe_capacity_factor,
            "slstm_unroll": pol.slstm_unroll}


def _port_fields(fields: dict) -> dict:
    out = dict(fields)
    out["param_dtype"] = str(out["param_dtype"]).split(".")[-1]
    out["compute_dtype"] = str(out["compute_dtype"]).split(".")[-1]
    out["dp_axes"] = list(out["dp_axes"])
    return out


def _options(mod, cfg, dtype):
    """The default options, pure_dp, and every knob off its default."""
    base = mod.default_options(cfg)
    import dataclasses
    return [base, dataclasses.replace(base, pure_dp=True),
            dataclasses.replace(base, compute_dtype=dtype, remat=False, attn_q_chunk=256,
                                attn_kv_chunk=512, attn_p_bf16=True, recurrent_bf16=True,
                                remat_policy="save_moe", moe_cf=2.5, slstm_unroll=4, sp=False)]


MESH_SHAPES = [((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
               ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_policy_fields_match_reference(arch):
    """Every field the reference's make_policy sets, for each option set at
    the test meshes and both production meshes (shape only), and
    ``Policy()`` for ``mesh=None``."""
    cfg, tcfg = get_config(arch), treg.get_config(arch)
    for jopts, topts in zip(_options(jsh, cfg, jnp.float32),
                            _options(tsh, tcfg, torch.float32)):
        for dims, names in MESH_SHAPES:
            want = _ref_fields(jsh.make_policy(cfg, jax.sharding.AbstractMesh(dims, names),
                                               "prefill", jopts))
            got = _port_fields(tsh.policy_fields(MeshShape(dims, names), topts))
            assert got == want, (dims, topts)
        assert tsh.make_policy(tcfg, None, "prefill", topts) == Policy()
        assert jsh.make_policy(cfg, None, "prefill", jopts) == JPolicy()


@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_make_policy_on_a_process_mesh(runs, mesh):
    """make_policy on the ranks' ProcessMesh: the reference's fields on a
    mesh of its shape, the identity shard, the mesh itself."""
    ranks, _, _ = runs
    dims = mc.MESHES[mesh]
    cfg = reduce_for_smoke(get_config(mc.SCOUT))
    amesh = jax.sharding.AbstractMesh(dims, ("data", "model"))
    want = _ref_fields(jsh.make_policy(cfg, amesh, "prefill", jsh.ShardingOptions(
        compute_dtype=jnp.float32, param_dtype=jnp.float32)))
    want_dp = _ref_fields(jsh.make_policy(cfg, amesh, "prefill",
                                          jsh.ShardingOptions(pure_dp=True)))
    for rec in ranks:
        got = dict(rec[mesh]["fields"])
        assert got.pop("mesh") == {"data": dims[0], "model": dims[1]}
        assert got.pop("identity_shard") is True
        assert got == want
        got = dict(rec[mesh]["fields_pure_dp"])
        got.pop("mesh"), got.pop("identity_shard")
        assert got == want_dp


def test_activation_specs_match_the_references_constraints(runs):
    """The table the reference's shard callback constrains by, read off its
    compiled outputs at (2, 2), equals activation_specs' (size-1 axes and
    trailing Nones are what XLA drops)."""
    _, _, extra = runs
    opts = tsh.ShardingOptions()
    specs = tsh.activation_specs(MeshShape((2, 2), ("data", "model")), "prefill", opts)
    assert sorted(specs) == sorted(extra["specs"])
    for name, spec in specs.items():
        got = [list(a) if isinstance(a, tuple) else a for a in spec.spec]
        while got and got[-1] is None:
            got.pop()
        assert got == extra["specs"][name], name
    assert tsh.activation_specs(MeshShape((2, 2), ("data", "model")), "decode", opts) == {}
    pure = tsh.activation_specs(MeshShape((2, 2), ("data", "model")), "train",
                                tsh.ShardingOptions(pure_dp=True))
    assert {k: v.spec for k, v in pure.items()} == {
        "act_btd": (("data", "model"), None, None), "logits": (("data", "model"), None, None)}


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(mc.MOE_CASES))
def test_moe_paths_over_the_mesh_match_reference(runs, case):
    ranks, ref, _ = runs
    mesh, path, be, k, cf, place, shared, xname = mc.MOE_CASES[case]
    arrays = mc.moe_arrays()
    _assert_margin(arrays["p/router"], arrays[f"x/{xname}"], k)
    want = {key[len(case) + 1:]: v for key, v in ref.items() if key.startswith(case + "/")}
    tags = [""] + (["/masked"] if be == "ragged" else [])
    for tag in tags:
        for rec in (r[mesh] for r in ranks):
            got = rec[case + tag]
            np.testing.assert_array_equal(got["counts"], want["counts"])
            assert got["overflow"] == float(want["overflow"])
            assert got["stats"] == want["stats"].tolist()
            if path == "apply":
                assert (got["shipped"], got["occupied"]) == (int(want["shipped"]),
                                                            int(want["occupied"]))
            else:
                assert "shipped" not in got and "shipped" not in want
            np.testing.assert_allclose(got["y"], want["y"], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got["aux"], float(want["aux"]), rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(got["y"], ranks[0][mesh][case + tag]["y"])
            if not shared:
                assert "carry.rank_params" in rec[case + "/whole"]
    if cf == 1.25 and path == "apply":
        assert float(want["overflow"]) > 0, "capacity 1.25 dropped nothing"


@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_native_ragged_hands_the_group_fewer_bytes(runs, mesh):
    """The native ragged ship moves counted rows through the uneven
    all-to-all; the masked one ships the dense buffers; dense the pad."""
    ranks, _, _ = runs
    for rec in (r[mesh] for r in ranks):
        for case, c in mc.MOE_CASES.items():
            if c[0] != mesh or c[2] != "ragged":
                continue
            native, masked = rec["traffic"][case], rec["traffic"][case + "/masked"]
            assert native["all_to_all_uneven"] > 0 == masked["all_to_all_uneven"]
            assert (native["all_to_all"] + native["all_to_all_uneven"]
                    < masked["all_to_all"])
            assert native["all_gather"] == masked["all_gather"] > 0


def test_data_axis_contract_in_both_packages(runs):
    """At (2, 2) the data axes do not divide a batch of 1 or 3: the
    reference's shard_map raises ValueError, and so does the port, naming
    the contract (ROADMAP.md, queue 3)."""
    ranks, _, extra = runs
    for b in mc.CONTRACT_BATCHES:
        assert "divisible" in extra["errors"][str(b)], extra["errors"]
        for rec in ranks:
            msg = rec["2x2"][f"contract/{b}"]
            assert msg is not None and "do not divide the batch" in msg, msg
            assert "shard_map" in msg


# ---------------------------------------------------------------------------
# the Scout smoke model under make_policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt", list(mc.PROMPTS))
@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_scout_prefill_and_decode_match_reference(runs, mesh, prompt):
    ranks, ref, _ = runs
    pre = f"{mesh}/model/{prompt}/"
    b, s = mc.PROMPTS[prompt]
    ntp = mc.MESHES[mesh][1]
    first = "moe_apply" if s % ntp == 0 else "moe_apply_replicated"
    for rec in (r[mesh] for r in ranks):
        got = rec[f"model/{prompt}"]
        assert len(got["logits"]) == mc.STEPS + 1
        for i, lg in enumerate(got["logits"]):
            np.testing.assert_allclose(lg, ref[pre + f"logits/{i}"], rtol=MODEL_TOL,
                                       atol=MODEL_TOL, err_msg=f"call {i}")
            np.testing.assert_array_equal(lg, ranks[0][mesh][f"model/{prompt}"]["logits"][i])
        for tag in ("prefill_cache", "cache"):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[tag][key], ref[pre + f"{tag}/{key}"],
                                           rtol=MODEL_TOL, atol=MODEL_TOL)
            np.testing.assert_array_equal(got[tag]["slot_pos"], ref[pre + f"{tag}/slot_pos"])
            np.testing.assert_array_equal(got[tag]["pos"], ref[pre + f"{tag}/pos"])
        assert got["paths"] == [first] + ["moe_apply_replicated"] * mc.STEPS
        assert rec["margin"] > mc.MARGIN, f"a router near-tie: {rec['margin']:.3g}"
        # each rank holds its own experts only
        assert rec["n_experts"] == 4 // ntp


@pytest.mark.parametrize("mesh", list(mc.MESHES))
def test_init_rank_params_equals_the_whole_models_slots(runs, mesh):
    ranks, _, _ = runs
    assert all(r[mesh]["rank_init"] for r in ranks)


def test_serve_engine_at_1x4_matches_reference(runs):
    """One ServeEngine pass on every rank: greedy tokens equal to the
    reference engine's, every rank's equal, both MoE paths taken."""
    ranks, ref, _ = runs
    want = ref["engine/tokens"].tolist()
    for rec in (r["1x4"]["engine"] for r in ranks):
        assert rec["tokens"] == want
        assert all(rec["done"])
        assert [rec["steps"], rec["tokens_out"]] == ref["engine/counts"].tolist()
        assert rec["paths"] == ["moe_apply", "moe_apply_replicated"]


# ---------------------------------------------------------------------------
# no group needed
# ---------------------------------------------------------------------------


def test_init_moe_keeps_the_slots_of_the_whole_draw():
    """``experts=`` keeps those experts of the whole draw, in slot order,
    bit for bit, and the draws after the experts stay where they were."""
    spec = MoESpec(num_experts=8, top_k=1, d_ff_expert=12, shared_expert=True)
    whole = layer.init_moe(torch.Generator().manual_seed(4), 6, spec, "swiglu", torch.bfloat16)
    keep = [5, 2, 7]
    part = layer.init_moe(torch.Generator().manual_seed(4), 6, spec, "swiglu", torch.bfloat16,
                          experts=keep)
    for name in ("wi", "wo"):
        assert torch.equal(part[name], whole[name][keep])
    assert torch.equal(part["router"], whole["router"])
    assert all(torch.equal(part["shared"][k], whole["shared"][k]) for k in ("wi", "wo"))
    with pytest.raises(ValueError, match="distinct"):
        layer.init_moe(torch.Generator(), 6, spec, "swiglu", torch.float32, experts=[1, 1])


def test_mesh_needs_a_process_mesh():
    with pytest.raises(ValueError, match="bare MeshShape"):
        Policy(mesh=MeshShape((1, 4), ("data", "model")))
    with pytest.raises(ValueError, match="ProcessMesh"):
        tsh.make_policy(treg.get_config(mc.SCOUT), MeshShape((2, 2), ("data", "model")),
                        "prefill", tsh.ShardingOptions())
