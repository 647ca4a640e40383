"""The port's Mamba mixer (``repro_torch.models.ssm``) and the hybrid
family (jamba-1.5-large's smoke config: one 8-layer period of Mamba and
attention mixers, dense and top-2 MoE FFNs without a shared expert) held
against the reference on the CPU.

Inputs come from seeded numpy generators; the reference's weights are
carried over (numpy for a mixer, ``params_from_jax`` for the model), so
both packages compute the same function.  Tolerances:
* the projections and ``_dt_b_c``'s ``B`` and ``C`` bit for bit in bf16;
  the causal conv within 2 bf16 ulps of each entry and ``dt`` within 1
  (the port's ``F.silu`` and ``F.softplus`` round once, XLA rounds each
  step of ``x * 1 / (1 + exp(-x))`` and of ``logaddexp(x, 0)`` to bf16;
  measured: 2 and 1 ulps); all within 1e-6 of each tensor's scale in
  float32, where XLA's dots sum in another order and it may contract
  the conv's products and sums into FMAs;
* a float32 mixer's output within 1e-5 and its state within 1e-6, each
  times the tensor's largest entry (at least 1): the scan mirrors
  ``jax.lax.associative_scan``'s recursion, but XLA may fuse its
  ``a2 * b1 + b2`` and sums the ``C`` contraction in another order
  (measured: 2.9e-6 of 4.1 at 512 tokens);
* a bf16 mixer within 2^-6 of that scale (two bf16 ulps at the largest
  entry): the float32 scan differs by an ulp, and an output that sits on
  a bf16 rounding boundary lands on the other neighbour before the
  output projection sums it (measured: 3.1e-2 of 4.1);
* gradients within rtol 1e-4 and 1e-5 of each gradient's scale;
* the model's logits within 1e-4, as ``tests/test_torch_models.py`` holds
  the other families; remat equal bit for bit to the step without it.

At 4 stacked EP shards the port (``Policy(tp=4, ep_shards=4)``) runs
against the reference on a ``(1, 4)`` ``("data", "model")`` mesh of
``Auto`` axes in one W=4 subprocess, as ``tests/test_torch_moe_serve.py``
holds Scout.
"""
import functools
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
from repro.models import ssm as js
from repro_torch.carry import params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmod
from repro_torch.models import ssm as ts
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import trainable

REPO = Path(__file__).resolve().parents[1]
ARCH = "jamba-1.5-large-398b"
D, EXPAND, D_STATE, D_CONV = 32, 2, 16, 4
RTOL, OUT_ATOL, STATE_ATOL, BF16_ATOL, GRAD_ATOL = 1e-5, 1e-5, 1e-6, 2.0**-6, 1e-5
MODEL_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROMPT, STEPS, MAX_LEN = 12, 3, 24   # 12 splits over 4 shards: moe_apply


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, rtol=RTOL, atol=OUT_ATOL):
    """Within ``rtol`` and ``atol`` times the largest ``|want|`` (at least 1)."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol * scale)


def _same_rounded(got, want, dtype, ulps=0):
    """Within ``ulps`` bf16 ulps of each entry (0: bit for bit) in bf16,
    within 1e-6 of the scale in float32."""
    if dtype != "bfloat16":
        _close(got, want, rtol=1e-6, atol=1e-6)
    elif not ulps:
        assert torch.equal(got, _t(want))
    else:
        w = _t(want).float()
        ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(2.0**-126))) - 7)
        assert bool(((got.float() - w).abs() <= ulps * ulp).all())


def _mixer(dtype="float32", seed=0):
    """The reference's mixer parameters, its policy, and the port's copies."""
    jd, td = DTYPES[dtype]
    jp = js.init_mamba(jax.random.PRNGKey(seed), D, expand=EXPAND, d_state=D_STATE,
                       d_conv=D_CONV, dtype=jd)
    return (jp, jmod.Policy(param_dtype=jd, compute_dtype=jd),
            {k: _t(v) for k, v in jp.items()}, tmod.Policy(param_dtype=td, compute_dtype=td))


def _x(seed, b, s, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_init_mamba_shapes_dtypes_and_constants(dtype):
    """The port's own init draws the reference's shapes and dtypes; the
    constant leaves ``dt_bias``, ``d_skip`` and ``conv_b`` equal the
    reference's bit for bit, and so does ``init_mamba_state``; ``a_log``
    within a float32 ulp (XLA's ``log(7)`` is one ulp above the correctly
    rounded value torch gives)."""
    jp, _, carried, _ = _mixer(dtype)
    jd, td = DTYPES[dtype]
    own = ts.init_mamba(torch.Generator().manual_seed(0), D, expand=EXPAND, d_state=D_STATE,
                        d_conv=D_CONV, dtype=td)
    assert sorted(own) == sorted(jp)
    for k in jp:
        assert (tuple(own[k].shape), own[k].dtype) == (tuple(carried[k].shape),
                                                      carried[k].dtype), k
    assert own["x_proj"].shape == (EXPAND * D, -(-D // 16) + 2 * D_STATE)
    for k in ("dt_bias", "d_skip", "conv_b"):
        assert torch.equal(own[k], carried[k]), k
    torch.testing.assert_close(own["a_log"], carried["a_log"], rtol=2.0**-23, atol=0.0)
    jst = js.init_mamba_state(3, D, expand=EXPAND, d_state=D_STATE, d_conv=D_CONV, dtype=jd)
    tst = ts.init_mamba_state(3, D, expand=EXPAND, d_state=D_STATE, d_conv=D_CONV, dtype=td)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        assert torch.equal(tst[k], _t(jst[k])), k


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 7])
def test_input_projection_and_conv_match_the_reference(s, with_state, dtype):
    """``_ssm_inputs``, then ``_conv_causal`` on the reference's ``x_m``,
    from no state and from a carried one; at 1 and 2 tokens the prompt is
    shorter than the conv's ``k - 1 = 3`` rows, and the new state keeps old
    rows (the state, a copy of rows, bit for bit)."""
    jp, jpol, tp, tpol = _mixer(dtype, seed=s)
    jx, tx = _x(s, 2, s, dtype)
    jxm, jz = js._ssm_inputs(jp, jx, jpol, D_STATE)
    txm, tz = ts._ssm_inputs(tp, tx, tpol, D_STATE)
    _same_rounded(txm, jxm, dtype)
    _same_rounded(tz, jz, dtype)
    txm = _t(jxm)
    jd, _ = DTYPES[dtype]
    state = (np.random.default_rng(s + 1).standard_normal((2, D_CONV - 1, EXPAND * D))
             .astype(np.float32) if with_state else None)
    jout, jnew = js._conv_causal(jxm, jp["conv_w"], jp["conv_b"],
                                 None if state is None else jnp.asarray(state).astype(jd))
    tout, tnew = ts._conv_causal(txm, tp["conv_w"], tp["conv_b"],
                                 None if state is None else _t(jnp.asarray(state).astype(jd)))
    _same_rounded(tout, jout, dtype, ulps=2)
    assert torch.equal(tnew, _t(jnew))
    assert tnew.shape == (2, D_CONV - 1, EXPAND * D)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dt_b_c_equals_the_reference(dtype):
    jp, jpol, tp, tpol = _mixer(dtype, seed=3)
    jx, tx = _x(3, 2, 9, dtype)
    jxm, _ = js._ssm_inputs(jp, jx, jpol, D_STATE)
    jxc, _ = js._conv_causal(jxm, jp["conv_w"], jp["conv_b"], None)
    want = js._dt_b_c(jp, jxc, D_STATE, jpol.compute_dtype)
    got = ts._dt_b_c(tp, _t(jxc), D_STATE, tpol.compute_dtype)
    for g, w, ulps in zip(got, want, (1, 0, 0), strict=True):
        _same_rounded(g, w, dtype, ulps)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,chunk", [(1, 256), (5, 256), (16, 4), (256, 256), (512, 256)])
def test_mamba_forward_matches_reference(s, chunk, dtype):
    """One chunk of 1, 5 and 256 tokens, four chunks of 4 and two of 256
    (the state carried across chunks): the output and the new state."""
    jp, jpol, tp, tpol = _mixer(dtype, seed=s)
    jx, tx = _x(s + 100, 2, s, dtype)
    jy, jst = jax.jit(functools.partial(js.mamba_forward, pol=jpol, d_state=D_STATE,
                                        chunk=chunk))(jp, jx)
    ty, tst = ts.mamba_forward(tp, tx, tpol, d_state=D_STATE, chunk=chunk)
    assert ty.dtype == tpol.compute_dtype and ty.shape == (2, s, D)
    assert tst["conv"].dtype == tpol.compute_dtype and tst["ssm"].dtype == torch.float32
    assert torch.equal(tst["conv"], _t(jst["conv"]))
    bf16 = dtype == "bfloat16"
    _close(ty, jy, atol=BF16_ATOL if bf16 else OUT_ATOL)
    _close(tst["ssm"], jst["ssm"], atol=BF16_ATOL if bf16 else STATE_ATOL)


def test_carried_state_prefill_then_decode():
    """A 16-token prefill (chunks of 4), then 4 ``mamba_decode`` steps and
    an 8-token forward from the returned states, against the reference's
    same calls and against one 28-token prefill (chunk 28 in the port:
    another summation order, so within the float32 tolerance)."""
    jp, jpol, tp, tpol = _mixer(seed=9)
    jx, tx = _x(9, 2, 28)
    fwd = jax.jit(functools.partial(js.mamba_forward, pol=jpol, d_state=D_STATE),
                  static_argnames="chunk")
    dec = jax.jit(functools.partial(js.mamba_decode, pol=jpol, d_state=D_STATE))
    jy, jst = fwd(jp, jx[:, :16], chunk=4)
    ty, tst = ts.mamba_forward(tp, tx[:, :16], tpol, d_state=D_STATE, chunk=4)
    outs = [ty]
    for t in range(16, 20):
        jy, jst = dec(jp, jx[:, t:t + 1], state=jst)
        ty, new = ts.mamba_decode(tp, tx[:, t:t + 1], tpol, d_state=D_STATE, state=tst)
        assert new is not tst and new["ssm"] is not tst["ssm"]  # a new state; the old kept
        tst = new
        _close(ty, jy)
        _close(tst["ssm"], jst["ssm"], atol=STATE_ATOL)
        outs.append(ty)
    jy, jst = fwd(jp, jx[:, 20:], chunk=8, state=jst)
    ty, tst = ts.mamba_forward(tp, tx[:, 20:], tpol, d_state=D_STATE, chunk=8, state=tst)
    _close(ty, jy)
    _close(tst["ssm"], jst["ssm"], atol=STATE_ATOL)
    assert torch.equal(tst["conv"], _t(jst["conv"]))
    outs.append(ty)
    whole, wst = ts.mamba_forward(tp, tx, tpol, d_state=D_STATE, chunk=28)
    _close(torch.cat(outs, dim=1), whole)
    _close(tst["ssm"], wst["ssm"], atol=STATE_ATOL)
    assert torch.equal(tst["conv"], wst["conv"])


@pytest.mark.parametrize("s,chunk,with_state", [(5, 256, False), (16, 4, True)])
def test_mamba_gradients_match_jax_grad(s, chunk, with_state):
    """Every parameter's gradient, the input's and the carried state's, of
    ``sum(out * cot) + sum(ssm * cot_s)``, against ``jax.grad``."""
    jp, jpol, tp, tpol = _mixer(seed=20 + s)
    jx, tx = _x(20 + s, 2, s)
    rng = np.random.default_rng(30 + s)
    cot = rng.standard_normal((2, s, D)).astype(np.float32)
    cot_s = rng.standard_normal((2, EXPAND * D, D_STATE)).astype(np.float32)
    st = ({"conv": rng.standard_normal((2, D_CONV - 1, EXPAND * D)).astype(np.float32),
           "ssm": rng.standard_normal((2, EXPAND * D, D_STATE)).astype(np.float32)}
          if with_state else None)

    def jloss(p, x, state):
        y, new = js.mamba_forward(p, x, jpol, d_state=D_STATE, chunk=chunk, state=state)
        return jnp.sum(y * cot) + jnp.sum(new["ssm"] * cot_s)

    jstate = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    jg, jgx, jgs = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jp, jx, jstate)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    tstate = None if st is None else {k: torch.as_tensor(v).requires_grad_()
                                      for k, v in st.items()}
    y, new = ts.mamba_forward(leaves, x, tpol, d_state=D_STATE, chunk=chunk, state=tstate)
    loss = (y * torch.as_tensor(cot)).sum() + (new["ssm"] * torch.as_tensor(cot_s)).sum()
    wrt = [*leaves.values(), x, *([] if tstate is None else tstate.values())]
    grads = torch.autograd.grad(loss, wrt)
    want = [jg[k] for k in leaves] + [jgx] + ([] if jgs is None else [jgs[k] for k in tstate])
    for g, w in zip(grads, want, strict=True):
        _close(g, w, rtol=1e-4, atol=GRAD_ATOL)


def test_chunk_contract():
    """Above 256 tokens a sequence must be a multiple of 256: the reference
    asserts at 300, the port raises ``ValueError`` naming the contract (256
    and 512 run in both: ``test_mamba_forward_matches_reference``)."""
    jp, jpol, tp, tpol = _mixer()
    jx, tx = _x(300, 1, 300)
    with pytest.raises(AssertionError):
        js.mamba_forward(jp, jx, jpol, d_state=D_STATE, chunk=256)
    with pytest.raises(ValueError, match="chunks of 256"):
        ts.mamba_forward(tp, tx, tpol, d_state=D_STATE, chunk=256)


# ---------------------------------------------------------------------------
# the model: jamba-1.5-large's smoke config
# ---------------------------------------------------------------------------

JPOL = jmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
TPOL = tmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)

# The reference at 4 shards, in a W=4 subprocess: the 12-token prefill and
# 3 decode steps, and loss_fn's loss, expert counts and drops on one batch
# (its gradient's compile alone takes about 45 s on this CPU; the port's
# sharded gradients are held bit for bit to its unsharded ones below, and
# those to jax.grad in tests/test_torch_train.py).
REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import reduce_for_smoke
    from repro.configs.registry import get_config
    from repro.models import model
    from repro.models.modules import Policy

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
    pol = Policy(mesh=mesh, tp=4, attn_q_chunk=16, attn_kv_chunk=16, exchange_backend="dense")
    params = unflat({k[2:]: v for k, v in a.items() if k.startswith("p/")})
    max_len = int(a["max_len"])
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cfg, pol, max_len))
    step = jax.jit(lambda p, c, t: model.decode_step(p, c, t, cfg, pol))
    logits, cache = prefill(params, jnp.asarray(a["prompt"]))
    out = {"logits/0": np.asarray(logits)}
    for i, tok in enumerate(a["steps"]):
        logits, cache = step(params, cache, jnp.asarray(tok))
        out[f"logits/{i + 1}"] = np.asarray(logits)
    batch = {k: jnp.asarray(a["b/" + k]) for k in ("tokens", "labels", "mask")}
    loss, m = jax.jit(lambda p: model.loss_fn(p, batch, cfg, pol))(params)
    out["loss"], out["counts"] = np.asarray(loss), np.asarray(m["expert_counts"])
    out["overflow"] = np.asarray(m["overflow"])
    np.savez(sys.argv[1], **out)
""")


def _cfgs():
    return (jbase.reduce_for_smoke(jreg.get_config(ARCH)),
            tbase.reduce_for_smoke(treg.get_config(ARCH)))


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (2, PROMPT)).astype(np.int32),
            rng.integers(0, 512, (STEPS, 2, 1)).astype(np.int32))


def _batch(seed):
    toks = np.random.default_rng(seed).integers(0, 512, (2, 33)).astype(np.int32)
    mask = (np.random.default_rng(seed + 1).random((2, 32)) < 0.9).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, node in tree.items()
                for k, v in _flat(node, f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's smoke Jamba parameters (float32), their tree as
    numpy, and the W=4 reference subprocess on them, started here so that
    it runs while the tests in this process do."""
    jcfg, tcfg = _cfgs()
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0), JPOL)
    tree = jax.tree.map(np.asarray, jparams)
    tmp = tmp_path_factory.mktemp("ssm_w4")
    prompt, steps = _tokens(2)
    np.savez(tmp / "in.npz", prompt=prompt, steps=steps, max_len=MAX_LEN,
             **{f"p/{k}": v for k, v in _flat(tree).items()},
             **{f"b/{k}": v for k, v in _batch(5).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_W4, str(tmp / "ref.npz"), str(tmp / "in.npz"), ARCH],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield jcfg, tcfg, jparams, tree, (proc, tmp / "ref.npz")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_w4(carried):
    """The W=4 reference's logits, loss, expert counts and drops."""
    proc, out = carried[4]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(out))


def _port_logits(tcfg, tparams, pol, prompt, steps):
    logits, cache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)}, tcfg, pol,
                                   MAX_LEN)
    out = [logits]
    for tok in steps:
        logits, cache = tmodel.decode_step(tparams, cache, torch.as_tensor(tok), tcfg, pol)
        out.append(logits)
    return out, cache


def _port_loss_grads(tcfg, tree, pol, batch):
    params = trainable(params_from_jax(tree, tcfg, pol, device="cpu"))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = tmodel.loss_fn(params, tb, tcfg, pol)
    grads = torch.autograd.grad(loss, topt.leaves(params))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _shards_pol(**kw):
    return tmod.Policy(tp=4, ep_shards=4, exchange_backend="dense", attn_q_chunk=16,
                       attn_kv_chunk=16, **kw)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_init_and_carry_keep_the_references_shapes_and_dtypes(carried, dtype):
    """Each layer's mixer: ``mamba`` at pattern positions 0-2 and 4-7,
    ``attn`` at 3; MoE FFNs (no shared expert) at the odd positions; the
    port's own init and the carried tree agree leaf by leaf in shape and
    dtype, the Mamba constants (``a_log``, ``dt_bias``, ``d_skip``) in the
    reference's dtype under each policy."""
    jcfg, tcfg, jparams, _, _ = carried
    jd, td = DTYPES[dtype]
    if dtype != "float32":
        jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0), jmod.Policy(param_dtype=jd))
    tpol = tmod.Policy(param_dtype=td)
    port = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, tpol, device="cpu")
    own = tmodel.init_params(tcfg, 0, tpol, device="cpu")
    leaves = lambda tree: [(tuple(t.shape), t.dtype) for t in _leaves(tree)]
    assert leaves(own) == leaves(port)
    mixers = ["attn" if "attn" in layer else "mamba" for layer in port["layers"]]
    assert mixers == ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
    for j, layer in enumerate(port["layers"]):
        ref = jparams["blocks"][f"b{j}"]
        assert ("moe" in layer) == (j % 2 == 1) and "shared" not in layer.get("moe", {})
        if "mamba" in layer:
            for k in ("a_log", "dt_bias", "d_skip"):
                assert layer["mamba"][k].dtype == td and ref["mamba"][k].dtype == jd, k
                assert torch.equal(layer["mamba"][k], _t(ref["mamba"][k][0])), k


def test_model_prefill_and_decode_match_without_shards(carried):
    """Prefill of 12 tokens, then 3 decode steps on the dense oracle:
    logits, and every Mamba layer's state stored back into the cache."""
    jcfg, tcfg, jparams, tree, _ = carried
    tparams = params_from_jax(tree, tcfg, TPOL, device="cpu")
    prompt, steps = _tokens(1)
    logits, tc = _port_logits(tcfg, tparams, TPOL, prompt, steps)
    jl, jc = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, jcfg, JPOL, MAX_LEN))(
        jparams, jnp.asarray(prompt))
    want = [jl]
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, jcfg, JPOL))
    for tok in steps:
        jl, jc = step(jparams, jc, jnp.asarray(tok))
        want.append(jl)
    for i, (g, w) in enumerate(zip(logits, want, strict=True)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=f"call {i}")
    fresh = ttr.init_cache(tcfg, 2, MAX_LEN, TPOL, device="cpu")
    for i, layer in enumerate(tc["layers"]):
        ref = jax.tree.map(lambda a: a[0], jc["blocks"][f"b{i}"])
        assert sorted(layer) == sorted(ref) == sorted(fresh["layers"][i])
        if i != 3:
            assert layer["ssm"].dtype == torch.float32 and layer["conv"].dtype == torch.float32
            for k in ref:
                _close(layer[k], ref[k], rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_teacher_forced_decode_equals_prefill(carried):
    """Prefill 15 tokens and decode the 16th gives the 16-token prefill's
    logits (the reference's ``test_decode_matches_forward``)."""
    _, tcfg, _, tree, _ = carried
    tparams = params_from_jax(tree, tcfg, TPOL, device="cpu")
    t = torch.as_tensor(np.random.default_rng(8).integers(0, 512, (1, 16)))
    full, _ = tmodel.prefill(tparams, {"tokens": t}, tcfg, TPOL, 32)
    _, cache = tmodel.prefill(tparams, {"tokens": t[:, :15]}, tcfg, TPOL, 32)
    step, _ = tmodel.decode_step(tparams, cache, t[:, 15:], tcfg, TPOL)
    np.testing.assert_allclose(_np(step), _np(full), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_model_refuses_a_prompt_off_the_chunk_contract(carried):
    jcfg, tcfg, jparams, tree, _ = carried
    tparams = params_from_jax(tree, tcfg, TPOL, device="cpu")
    toks = np.zeros((1, 300), np.int32)
    with pytest.raises(AssertionError):
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, JPOL, 304)
    with pytest.raises(ValueError, match="chunk contract"):
        tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks)}, tcfg, TPOL, 304)


@pytest.fixture(scope="module")
def without_remat(carried):
    """The loss, metrics and gradients without remat, by shard count (each
    computed once for both policies' cases)."""
    _, tcfg, _, tree, _ = carried
    return functools.cache(lambda shards: _port_loss_grads(
        tcfg, tree, _shards_pol() if shards else TPOL, _batch(6)))


@pytest.mark.parametrize("remat_policy", ["nothing", "save_moe"])
@pytest.mark.parametrize("shards", [0, 4])
def test_remat_equals_the_step_without_it(carried, without_remat, shards, remat_policy):
    """Under ``Policy(remat=True)`` the loss, the metrics and every gradient
    equal the pass without remat bit for bit (the Mamba blocks recomputed
    in the backward, the MoE FFNs kept under ``"save_moe"``)."""
    _, tcfg, _, tree, _ = carried
    remat = (_shards_pol(remat=True, remat_policy=remat_policy) if shards else
             tmod.Policy(remat=True, remat_policy=remat_policy, attn_q_chunk=16,
                         attn_kv_chunk=16))
    loss0, m0, g0 = without_remat(shards)
    loss, m, grads = _port_loss_grads(tcfg, tree, remat, _batch(6))
    assert torch.equal(loss, loss0)
    assert sorted(m) == sorted(m0) and all(torch.equal(m[k], m0[k]) for k in m)
    assert len(grads) == len(g0) and all(torch.equal(a, b) for a, b in zip(grads, g0))


def test_serve_engine_serves_jamba(carried):
    """``ServeEngine`` with one slot over two requests: every request served,
    its greedy tokens those of ``model.prefill`` and ``decode_step`` (held
    to the reference above) on its prompt alone, bit for bit; the Mamba
    states ride in each slot's cache."""
    _, tcfg, _, tree, _ = carried
    tparams = params_from_jax(tree, tcfg, TPOL, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (8, 13)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    eng = ServeEngine(tcfg, tparams, TPOL, slots=1, max_len=32, device="cpu")
    eng.run(reqs, max_ticks=50)
    assert eng.tokens_out == 2 * 3 and all(r.done for r in reqs)
    for p, r in zip(prompts, reqs):
        logits, cache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(p[None])}, tcfg,
                                       TPOL, 32)
        want = []
        for _ in range(4):
            want.append(int(torch.argmax(logits[0, -1, :tcfg.vocab_size])))
            logits, cache = tmodel.decode_step(tparams, cache, torch.tensor([[want[-1]]]),
                                               tcfg, TPOL)
        assert r.out_tokens == want, (r.rid, r.out_tokens, want)


def test_launchers_train_and_serve_jamba(capsys):
    """``launch/train.py`` and ``launch/serve.py`` run ``--arch
    jamba-1.5-large-398b --smoke`` on the CPU."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    ttrain.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
                 "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "done: 2 steps" in out and "step    1 loss=" in out
    tserve.main(["--arch", ARCH, "--smoke", "--requests", "4", "--max-new", "2",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "routed=4" in out and out.count("replica ") == 4


# the W=4 reference's results, read last: its subprocess ran beside the tests above


def test_model_prefill_and_decode_match_at_four_shards(carried, reference_w4, monkeypatch):
    """At 4 stacked EP shards the 12-token prefill takes ``moe_apply`` (top
    2 of 4 experts, no shared expert) in each MoE layer and each decode
    step ``moe_apply_replicated``; logits within 1e-4 of the reference's
    on its W=4 mesh."""
    _, tcfg, _, tree, _ = carried
    pol = _shards_pol()
    tparams = params_from_jax(tree, tcfg, pol, device="cpu")
    calls = []
    for name in ("moe_apply", "moe_apply_replicated", "moe_ref"):
        fn = getattr(ttr, name)
        monkeypatch.setattr(ttr, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                          _fn(*a, **k))[1])
    prompt, steps = _tokens(2)
    logits, _ = _port_logits(tcfg, tparams, pol, prompt, steps)
    for i, g in enumerate(logits):
        np.testing.assert_allclose(_np(g), reference_w4[f"logits/{i}"], rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"call {i}")
    assert calls == ["moe_apply"] * 4 + ["moe_apply_replicated"] * 4 * STEPS


def test_loss_matches_at_four_shards(carried, reference_w4):
    """``loss_fn`` at 4 shards (``moe_apply`` in the four MoE layers): the
    loss within rtol 1e-4 of the reference's on its W=4 mesh (the aux loss
    the mean of the shards' losses, as there), the expert counts (two a
    token at top 2) and the drops equal."""
    _, tcfg, _, tree, _ = carried
    loss, m, _ = _port_loss_grads(tcfg, tree, _shards_pol(), _batch(5))
    np.testing.assert_allclose(float(loss), float(reference_w4["loss"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(m["expert_counts"].numpy(), reference_w4["counts"])
    assert float(m["expert_counts"].sum()) == 2 * 32 * 2 * 4
    assert float(m["overflow"]) == float(reference_w4["overflow"])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_a_depth_cut_without_moe_layers_matches_the_reference():
    """Jamba cut to two (Mamba, dense) layers (``pattern[:1]``, as the
    training cut at full width): a MoE config whose periodic blocks hold no
    MoE FFN.  The reference's backbone returns empty expert counts there;
    the port's too (it raised before), with the loss within the tolerance
    of ``tests/test_torch_train.py`` and the prefill logits within 1e-4
    (the Mamba layers' gradients are held in ``test_torch_train.py``'s
    jamba case)."""
    import dataclasses

    jfull, tfull = jreg.get_config(ARCH), treg.get_config(ARCH)
    jcfg = dataclasses.replace(jbase.reduce_for_smoke(jfull), num_layers=2,
                               pattern=jfull.pattern[:1])
    tcfg = dataclasses.replace(tbase.reduce_for_smoke(tfull), num_layers=2,
                               pattern=tfull.pattern[:1])
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(3), JPOL)
    tree = jax.tree.map(np.asarray, jparams)
    batch = _batch(7)
    jl, jm = jax.jit(lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg,
                                              JPOL))(jparams)
    tparams = params_from_jax(tree, tcfg, TPOL, device="cpu")
    loss, m = tmodel.loss_fn(tparams, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg,
                             TPOL)
    assert np.asarray(jm["expert_counts"]).shape == (0,) == tuple(m["expert_counts"].shape)
    assert float(m["overflow"]) == float(jm["overflow"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-6)
    prompt, _ = _tokens(4)
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcfg, JPOL, MAX_LEN)
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)}, tcfg, TPOL, MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=MODEL_TOL, atol=MODEL_TOL)
