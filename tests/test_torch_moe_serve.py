"""The MoE slice end to end on the CPU: ``reduce_for_smoke`` of Llama 4
Scout (a MoE FFN in every layer) and of Maverick (dense and MoE layers
interleaved) through the port's ``prefill`` / ``decode_step`` and
``ServeEngine``, held against the reference with its parameters carried
over by ``params_from_jax``.

Without EP shards both packages run the dense oracle ``moe_ref`` (the
reference's ``mesh=None``), in this process.  At 4 stacked shards the port
(``Policy(tp=4, ep_shards=4)``) runs against the reference on a ``(1, 4)``
``("data", "model")`` mesh of ``Auto`` axes in a W=4 subprocess: a prompt
of 12 tokens takes ``moe_apply``, one of 10 and every decode step
``moe_apply_replicated``.  Logits within 1e-4 (float32; XLA's dots against
torch's); the summed ``moe_counts`` and the dropped pairs equal exactly.
Every router call of the port keeps its top two logits apart by more than
``MARGIN`` (asserted), so that a near-tie, which the two packages could
break apart, fails loudly instead of passing by luck.
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

from repro.configs.base import reduce_for_smoke
from repro.configs.registry import get_config
from repro.models import model as jmodel
from repro.models import transformer as jtr
from repro.models.modules import Policy as JPolicy
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.carry import params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr
from repro_torch.models.modules import Policy
from repro_torch.moe import layer as tlayer
from repro_torch.serve.engine import Request, ServeEngine

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"]
MARGIN = 1e-4
TOL = 1e-4
B, MAX_LEN, STEPS = 2, 24, 3
PROMPTS = (12, 10)  # 12 splits over 4 shards (moe_apply), 10 does not


def _cfgs(arch):
    return (reduce_for_smoke(get_config(arch)),
            tbase.reduce_for_smoke(treg.get_config(arch)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, node in tree.items() for k, v in _flat(node, f"{prefix}{key}/").items()}
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


def _tokens(arch, s):
    rng = np.random.default_rng(len(arch) + s)
    return (rng.integers(0, 512, (B, s)).astype(np.int32),
            rng.integers(0, 512, (STEPS, B, 1)).astype(np.int32))


@pytest.fixture
def margins(monkeypatch):
    """The smallest top-1/top-2 router-logit gap of every port router
    call made while the test runs."""
    seen = []
    route = tlayer._route

    def recording(router_w, t, spec):
        logits = (t.to(torch.float32) @ router_w.to(torch.float32)).double()
        top = torch.topk(logits, 2, dim=-1).values
        seen.append(float((top[:, 0] - top[:, 1]).min()))
        return route(router_w, t, spec)

    monkeypatch.setattr(tlayer, "_route", recording)
    return seen


def _port_run(tcfg, tparams, pol, prompt, steps, monkeypatch):
    """Prefill and teacher-forced decode through the port's model facade,
    with ``backbone``'s MoE outputs captured at each call."""
    stats = []
    backbone = ttr.backbone

    def capturing(*a, **k):
        out = backbone(*a, **k)
        stats.append((out[2].numpy().copy(), float(out[3]), float(out[4])))
        return out

    monkeypatch.setattr(ttr, "backbone", capturing)
    logits, cache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)}, tcfg, pol,
                                   MAX_LEN)
    out = [logits.numpy()]
    for tok in steps:
        logits, cache = tmodel.decode_step(tparams, cache, torch.as_tensor(tok), tcfg, pol)
        out.append(logits.numpy())
    return out, stats


def _ref_run(cfg, jparams, pol, prompt, steps):
    """The reference's logits per call, and its backbone's ``(counts,
    overflow, aux)`` on the same inputs (``prefill`` drops them)."""
    def stats_of(params, x, pos, cache):
        _, _, counts, over, aux = jtr.backbone(params, x, cfg, pol, pos=pos, cache=cache)
        return counts, over, aux

    b, s = prompt.shape
    stats_fn = jax.jit(stats_of)
    x = jtr._embed_inputs(jparams, {"tokens": jnp.asarray(prompt)}, cfg, pol)
    stats = [stats_fn(jparams, x, jtr._positions(cfg, b, s, 0),
                      jtr.init_cache(cfg, b, MAX_LEN, pol))]
    logits, cache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cfg, pol, MAX_LEN))(
        jparams, jnp.asarray(prompt))
    out = [logits]
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, cfg, pol))
    for tok in steps:
        x = jtr.embed(jparams["embed"], jnp.asarray(tok), scale=cfg.embed_scale, d=cfg.d_model,
                      pol=pol)
        stats.append(stats_fn(jparams, x, jtr._positions(cfg, b, 1, cache["pos"]), cache))
        logits, cache = step(jparams, cache, jnp.asarray(tok))
        out.append(logits)
    return ([np.asarray(o) for o in out],
            [(np.asarray(c), float(o), float(a)) for c, o, a in stats])


def _same(port, ref, margins):
    (plog, pstats), (rlog, rstats) = port, ref
    assert len(plog) == len(rlog) == len(pstats) == len(rstats) == STEPS + 1
    for i, (a, b) in enumerate(zip(plog, rlog)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=f"call {i}")
    for i, ((pc, po, pa), (rc, ro, ra)) in enumerate(zip(pstats, rstats)):
        np.testing.assert_array_equal(pc, rc, err_msg=f"moe_counts, call {i}")
        assert po == ro, (i, po, ro)
        np.testing.assert_allclose(pa, ra, rtol=TOL, atol=TOL)
    assert margins and min(margins) > MARGIN, f"a router near-tie: {min(margins):.3g}"


@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ref_path_matches_reference(arch, s, margins, monkeypatch):
    cfg, tcfg = _cfgs(arch)
    jpol = JPolicy(attn_q_chunk=16, attn_kv_chunk=16)
    tpol = Policy(attn_q_chunk=16, attn_kv_chunk=16)
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(1), jpol)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, tpol, device="cpu")
    assert tparams["layers"][-1]["moe"]["router"].dtype == torch.float32
    prompt, steps = _tokens(arch, s)
    ref = _ref_run(cfg, jparams, jpol, prompt, steps)
    port = _port_run(tcfg, tparams, tpol, prompt, steps, monkeypatch)
    _same(port, ref, margins)
    moe_layers = sum(blk.ffn == "moe" for blk in ttr.layers(tcfg))
    assert float(port[1][0][0].sum()) == B * s * moe_layers * cfg.moe.top_k


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[4])
    from test_torch_moe_serve import _ref_run, _tokens, _unflat, PROMPTS
    from repro.configs.base import reduce_for_smoke
    from repro.configs.registry import get_config
    from repro.models.modules import Policy
    archs = json.loads(sys.argv[2])
    params = dict(np.load(sys.argv[3]))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    pol = Policy(mesh=mesh, tp=4, attn_q_chunk=16, attn_kv_chunk=16)
    out = {}
    for arch in archs:
        cfg = reduce_for_smoke(get_config(arch))
        jp = jax.tree.map(jnp.asarray, _unflat({k[len(arch) + 1:]: v for k, v in params.items()
                                               if k.startswith(arch + "/")}))
        for s in PROMPTS:
            prompt, steps = _tokens(arch, s)
            logits, stats = _ref_run(cfg, jp, pol, prompt, steps)
            for i, (lg, (c, o, a)) in enumerate(zip(logits, stats)):
                pre = f"{arch}/{s}/{i}/"
                out[pre + "logits"], out[pre + "counts"] = lg, c
                out[pre + "stats"] = np.asarray([o, a])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_serve_w4")
    jpol = JPolicy(tp=4, attn_q_chunk=16, attn_kv_chunk=16)
    params = {}
    for arch in ARCHS:
        jp = jmodel.init_params(_cfgs(arch)[0], jax.random.PRNGKey(2), jpol)
        params.update({f"{arch}/{k}": v for k, v in _flat(jp).items()})
    np.savez(tmp / "params.npz", **params)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_W4, str(tmp / "ref.npz"), json.dumps(ARCHS),
         str(tmp / "params.npz"), str(REPO / "tests")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return params, dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_four_stacked_shards_match_reference(reference_w4, arch, s, margins, monkeypatch):
    params, ref = reference_w4
    _, tcfg = _cfgs(arch)
    tpol = Policy(tp=4, ep_shards=4, attn_q_chunk=16, attn_kv_chunk=16)
    tree = _unflat({k[len(arch) + 1:]: v for k, v in params.items() if k.startswith(arch + "/")})
    tparams = params_from_jax(tree, tcfg, tpol, device="cpu")
    prompt, steps = _tokens(arch, s)
    calls = []
    for name in ("moe_apply", "moe_apply_replicated", "moe_ref"):
        fn = getattr(ttr, name)
        monkeypatch.setattr(ttr, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                          _fn(*a, **k))[1])
    port = _port_run(tcfg, tparams, tpol, prompt, steps, monkeypatch)
    pre = [f"{arch}/{s}/{i}/" for i in range(STEPS + 1)]
    refs = ([ref[p + "logits"] for p in pre],
            [(ref[p + "counts"], float(ref[p + "stats"][0]), float(ref[p + "stats"][1]))
             for p in pre])
    _same(port, refs, margins)
    moe_layers = sum(blk.ffn == "moe" for blk in ttr.layers(tcfg))
    first = "moe_apply" if s % 4 == 0 else "moe_apply_replicated"
    assert calls == [first] * moe_layers + ["moe_apply_replicated"] * moe_layers * STEPS


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-27b"])
def test_dense_backbone_returns_the_references_moe_outputs(arch):
    """A dense model's backbone returns the reference's hidden states and
    its MoE outputs: no counts, and zero drops and aux loss, as float32
    scalars on the hidden states' device."""
    cfg, tcfg = _cfgs(arch)
    jpol = JPolicy(attn_q_chunk=16, attn_kv_chunk=16)
    tpol = Policy(attn_q_chunk=16, attn_kv_chunk=16)
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(3), jpol)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, tpol, device="cpu")
    prompt, _ = _tokens(arch, PROMPTS[0])
    b, s = prompt.shape
    x = jtr._embed_inputs(jparams, {"tokens": jnp.asarray(prompt)}, cfg, jpol)
    want = jtr.backbone(jparams, x, cfg, jpol, pos=jtr._positions(cfg, b, s, 0))
    got = ttr.backbone(tparams, torch.as_tensor(np.array(x)), tcfg, tpol,
                       pos=ttr._positions(tcfg, b, s, 0))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    assert got[2] is None and want[2] is None
    for g, w in zip(got[3:], want[3:], strict=True):
        assert g.shape == () and g.dtype == torch.float32 and g.device == got[0].device
        assert float(g) == float(w) == 0.0


def test_tp_alone_keeps_the_oracle_path(monkeypatch):
    """``tp > 1`` pads the heads but does not switch the MoE path: without
    ``ep_shards`` every MoE layer runs ``moe_ref``."""
    _, tcfg = _cfgs(ARCHS[0])
    pol = Policy(tp=4)
    tparams = tmodel.init_params(tcfg, 0, pol, device="cpu")
    calls = []
    for name in ("moe_apply", "moe_apply_replicated", "moe_ref"):
        fn = getattr(ttr, name)
        monkeypatch.setattr(ttr, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                          _fn(*a, **k))[1])
    tmodel.prefill(tparams, {"tokens": torch.zeros((1, 8), dtype=torch.int64)}, tcfg, pol, 16)
    assert calls == ["moe_ref"]


def test_serve_engine_matches_reference_on_scout():
    """One ``ServeEngine`` pass of the Scout smoke config on the CPU beside
    the reference's engine: the same ticks and token counts, greedy
    tokens equal wherever the reference's top-two margin exceeds 1e-2 (as
    ``tests/test_torch_serve.py`` holds the dense engines); and the same
    pass over 4 stacked EP shards completes with tokens in the vocabulary."""
    cfg, tcfg = _cfgs(ARCHS[0])
    jpol = JPolicy(attn_q_chunk=64, attn_kv_chunk=64)
    tpol = Policy(attn_q_chunk=64, attn_kv_chunk=64)
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(0), jpol)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, tpol, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 13, 16, 6)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    jeng = JEngine(cfg, jparams, jpol, slots=2, max_len=64)
    teng = ServeEngine(tcfg, tparams, tpol, slots=2, max_len=64, device="cpu")
    jeng.run(jreqs, max_ticks=100)
    teng.run(treqs, max_ticks=100)
    assert (teng.steps, teng.tokens_out) == (jeng.steps, jeng.tokens_out)
    for p, jr, tr in zip(prompts, jreqs, treqs):
        assert tr.done and len(tr.out_tokens) == len(jr.out_tokens) == 5
        if tr.out_tokens != jr.out_tokens:
            first = next(i for i, (a, b) in enumerate(zip(tr.out_tokens, jr.out_tokens))
                         if a != b)
            logits, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(p[None])}, cfg,
                                           jpol, max_len=64)
            for tok in jr.out_tokens[:first]:
                logits, cache = jmodel.decode_step(jparams, cache, jnp.asarray([[tok]]), cfg,
                                                   jpol)
            top = np.sort(np.asarray(logits[0, -1, :cfg.vocab_size], np.float64))[-2:]
            assert top[1] - top[0] <= 1e-2, (jr.rid, first)
    sharded = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    eng = ServeEngine(tcfg, tparams, Policy(ep_shards=4, attn_q_chunk=64, attn_kv_chunk=64),
                      slots=2, max_len=64, device="cpu")
    eng.run(sharded, max_ticks=100)
    assert eng.tokens_out == teng.tokens_out and all(r.done for r in sharded)
    assert all(0 <= t < cfg.vocab_size for r in sharded for t in r.out_tokens)


def test_launch_serve_serves_scout(capsys):
    """The launcher serves the Scout smoke model on the CPU on the oracle
    path and prints the reference launcher's lines (the wall-clock total
    aside)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    args = ["--arch", ARCHS[0], "--requests", "6", "--max-new", "3", "--slots", "2",
            "--replicas", "2"]
    tserve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == 4 and got[-1].startswith("DR checkpoint: ")
    assert sum(int(line.split(", ")[1].split()[0]) for line in got[:2]) == 6 * 2
    old = sys.argv
    sys.argv = ["serve"] + args
    try:
        jserve.main()
    finally:
        sys.argv = old
    want = capsys.readouterr().out.splitlines()
    assert got[:2] == want[:2] and got[3] == want[3]
    assert got[2].split(" total ")[0] == want[2].split(" total ")[0]
