"""The port's xLSTM mixers (``repro_torch.models.xlstm``) and the xlstm-125m
model held against the reference on the CPU.

Inputs come from seeded numpy generators; the reference's weights are
carried over (``params_from_jax`` for the model, numpy for a mixer), so
both packages compute the same function.  Tolerances, each at float32
with rtol 1e-5 and an atol scaled by the tensor's largest entry (at least
1), since float32 sums run in another order (XLA's dots and its float32
cumsum against torch's) and move an entry near zero by an ulp of its
row's large terms (outputs reach 12 here): every state leaf within 1e-6
of that scale; a mixer's output within 1e-5 of it, as the output divides
by the normaliser ``max(|q . n|, exp(-m))``, which a small ``|q . n|``
amplifies (measured: 1.5e-6 from a carried state); with
``recurrent_bf16`` the output within 1e-4 of it, as an operand a float32
ulp apart in the two packages can round to the other bf16 neighbour,
which moves its product term by 2^-8 of itself (measured: 2.8e-6).
The model's logits within 1e-4, as ``tests/test_torch_models.py`` holds
the other families; the sLSTM's unroll and the dead heads exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import model as jmodel
from repro.models import modules as jmod
from repro.models import xlstm as jx
from repro_torch.carry import params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as tx

RTOL, STATE_ATOL, OUT_ATOL, BF16_ATOL = 1e-5, 1e-6, 1e-5, 1e-4
D, HEADS = 32, 4
ARCH = "xlstm-125m"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tp(jp):
    return {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


def _heads_p(tp):
    return -(-HEADS // tp) * tp


def _close(got, want, rtol=RTOL, atol=OUT_ATOL):
    """Within ``rtol`` and ``atol`` times the largest ``|want|`` (at least 1)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol * scale)


def _same_state(ts, js):
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].dtype == torch.float32 or k == "conv", k
        _close(ts[k], js[k], atol=STATE_ATOL)


def _inputs(seed, b, s):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 3])
@pytest.mark.parametrize("recurrent_bf16", [False, True])
@pytest.mark.parametrize("chunk,s", [(8, 32), (256, 32), (16, 16)])
def test_mlstm_matches_reference(chunk, s, recurrent_bf16, tp):
    """Chunk 8 over 32 tokens (4 chunks carrying c, n, m), ``s <= chunk``
    (one chunk of ``s``), then 8 more tokens from the returned state."""
    jp = jx.init_mlstm(jax.random.PRNGKey(tp), D, HEADS, _heads_p(tp))
    tp_ = _tp(jp)
    jpol, tpol = jmod.Policy(recurrent_bf16=recurrent_bf16), tmod.Policy(
        recurrent_bf16=recurrent_bf16)
    atol = BF16_ATOL if recurrent_bf16 else OUT_ATOL
    x = _inputs(chunk + s, 2, s)
    jy, js = jx.mlstm_forward(jp, jnp.asarray(x), jpol, chunk=chunk)
    ty, ts = tx.mlstm_forward(tp_, torch.as_tensor(x), tpol, chunk=chunk)
    _close(ty, jy, atol=atol)
    _same_state(ts, js)
    x2 = _inputs(chunk + s + 1, 2, 8)
    jy, js = jx.mlstm_forward(jp, jnp.asarray(x2), jpol, chunk=chunk, state=js)
    ty, ts2 = tx.mlstm_forward(tp_, torch.as_tensor(x2), tpol, chunk=chunk, state=ts)
    _close(ty, jy, atol=atol)
    _same_state(ts2, js)
    assert ts2 is not ts and ts2["c"] is not ts["c"]  # a new state; the old one kept


@pytest.mark.parametrize("tp", [1, 3])
@pytest.mark.parametrize("unroll", [1, 4, 7])
def test_slstm_matches_reference(unroll, tp):
    """``slstm_unroll`` 1, 4 and 7 (7 does not divide 20: the reference
    falls back to 5), from no state and then from the returned one."""
    jp = jx.init_slstm(jax.random.PRNGKey(10 + tp), D, HEADS, _heads_p(tp))
    tp_ = _tp(jp)
    jpol, tpol = jmod.Policy(slstm_unroll=unroll), tmod.Policy(slstm_unroll=unroll)
    x = _inputs(unroll, 2, 20)
    jy, js = jx.slstm_forward(jp, jnp.asarray(x), jpol)
    ty, ts = tx.slstm_forward(tp_, torch.as_tensor(x), tpol)
    _close(ty, jy)
    _same_state(ts, js)
    x2 = _inputs(unroll + 100, 2, 6)
    jy, js = jx.slstm_forward(jp, jnp.asarray(x2), jpol, state=js)
    ty, ts = tx.slstm_forward(tp_, torch.as_tensor(x2), tpol, state=ts)
    _close(ty, jy)
    _same_state(ts, js)


def test_slstm_unroll_changes_no_bit():
    """The reference's unroll only regroups its scan; the port's loop gives
    the same bits for every value, the explicit argument included."""
    tp_ = _tp(jx.init_slstm(jax.random.PRNGKey(3), D, HEADS, HEADS))
    x = torch.as_tensor(_inputs(5, 3, 14))
    runs = [tx.slstm_forward(tp_, x, tmod.Policy(slstm_unroll=u)) for u in (1, 4, 7, 14, 99)]
    runs.append(tx.slstm_forward(tp_, x, tmod.Policy(), unroll=4))
    for y, st in runs[1:]:
        assert torch.equal(y, runs[0][0])
        assert all(torch.equal(st[k], runs[0][1][k]) for k in st)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_dead_heads_give_exactly_zero(mixer):
    """At ``tp=3`` the 4 heads pad to 6: the two dead heads' rows of
    ``down`` are zero in both inits, and with the real heads' rows zeroed
    too the output is exactly zero."""
    init = {"mlstm": (jx.init_mlstm, tx.init_mlstm), "slstm": (jx.init_slstm, tx.init_slstm)}
    fwd = {"mlstm": tx.mlstm_forward, "slstm": tx.slstm_forward}[mixer]
    jinit, tinit = init[mixer]
    jp = _tp(jinit(jax.random.PRNGKey(4), D, HEADS, 6))
    own = tinit(torch.Generator().manual_seed(4), D, HEADS, 6)
    for p in (jp, own):
        assert p["down"].shape[0] == 6
        assert not p["down"][HEADS:].any() and p["down"][:HEADS].all()
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in jp.items()}
    jp["down"][:HEADS] = 0.0
    y, _ = fwd(jp, torch.as_tensor(_inputs(6, 2, 16)), tmod.Policy())
    assert torch.equal(y, torch.zeros_like(y))


def test_chunk_contract():
    """Above 256 tokens a prompt must be a multiple of 256: the reference
    asserts at 300, the port raises ``ValueError`` naming the contract;
    256 and 512 run in both."""
    jp = jx.init_mlstm(jax.random.PRNGKey(5), D, HEADS, HEADS)
    tp_ = _tp(jp)
    for s in (256, 512):
        x = _inputs(s, 1, s)
        jy, _ = jx.mlstm_forward(jp, jnp.asarray(x), jmod.Policy(), chunk=min(256, s))
        ty, _ = tx.mlstm_forward(tp_, torch.as_tensor(x), tmod.Policy(), chunk=min(256, s))
        _close(ty, jy)
    x = _inputs(300, 1, 300)
    with pytest.raises(AssertionError):
        jx.mlstm_forward(jp, jnp.asarray(x), jmod.Policy(), chunk=256)
    with pytest.raises(ValueError, match="chunks of 256"):
        tx.mlstm_forward(tp_, torch.as_tensor(x), tmod.Policy(), chunk=256)


# ---------------------------------------------------------------------------
# the model: xlstm-125m's smoke config
# ---------------------------------------------------------------------------


def _carry(tp=1, seed=0):
    cfg = jbase.reduce_for_smoke(jreg.get_config(ARCH))
    tcfg = tbase.reduce_for_smoke(treg.get_config(ARCH))
    jpol, tpol = jmod.Policy(tp=tp), tmod.Policy(tp=tp)
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(seed), jpol)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, tpol, device="cpu")
    return cfg, tcfg, jpol, tpol, jparams, tparams


@pytest.mark.parametrize("tp", [1, 8])
def test_model_prefill_and_decode_match(tp):
    """Prefill of 24 tokens, then 3 decode steps: logits and every layer's
    recurrent state (stored back into the cache, so decode continues from
    the prefill's state); at ``tp=8`` the 4 heads pad to 8 dead-headed
    ones (the reference's attention layout, which its init builds for
    every family, takes no ``tp`` that 2 kv heads do not divide)."""
    cfg, tcfg, jpol, tpol, jparams, tparams = _carry(tp)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jlog, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cfg, jpol, 32)
    tlog, tc = tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks)}, tcfg, tpol, 32)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    fresh = ttr.init_cache(tcfg, 2, 32, tpol, device="cpu")
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt), cfg, jpol)
        tlog, tc = tmodel.decode_step(tparams, tc, torch.as_tensor(nxt), tcfg, tpol)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    for i, layer in enumerate(tc["layers"]):
        ref = jax.tree.map(lambda a: a[i // 2], jc["blocks"][f"b{i % 2}"])
        assert sorted(layer) == sorted(ref) == sorted(fresh["layers"][i])
        for k in ref:
            np.testing.assert_allclose(_np(layer[k]), np.asarray(ref[k], np.float32),
                                       rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_teacher_forced_decode_equals_prefill():
    """The reference's ``test_decode_matches_forward`` on the port: prefill
    15 tokens and decode the 16th gives the 16-token prefill's logits, and
    both equal the reference's within 1e-4."""
    cfg, tcfg, jpol, tpol, jparams, tparams = _carry(seed=2)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    t = torch.as_tensor(toks)
    full, _ = tmodel.prefill(tparams, {"tokens": t}, tcfg, tpol, 32)
    _, cache = tmodel.prefill(tparams, {"tokens": t[:, :15]}, tcfg, tpol, 32)
    step, _ = tmodel.decode_step(tparams, cache, t[:, 15:], tcfg, tpol)
    np.testing.assert_allclose(_np(step), _np(full), rtol=1e-4, atol=1e-4)
    jfull, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cfg, jpol, 32)
    np.testing.assert_allclose(_np(full), np.asarray(jfull), rtol=1e-4, atol=1e-4)


def test_model_refuses_a_prompt_off_the_chunk_contract():
    cfg, tcfg, jpol, tpol, jparams, tparams = _carry()
    toks = np.zeros((1, 300), np.int32)
    with pytest.raises(AssertionError):
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cfg, jpol, 304)
    with pytest.raises(ValueError, match="chunk contract"):
        tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks)}, tcfg, tpol, 304)


def test_port_init_matches_the_reference_shapes():
    """The port's own init (another generator) draws the carried tree's
    shapes and dtypes, with and without dead heads."""
    for tp in (1, 8):
        _, tcfg, _, tpol, _, carried = _carry(tp)
        own = tmodel.init_params(tcfg, 0, tpol, device="cpu")
        leaves = lambda tree: [(tuple(t.shape), t.dtype) for t in _leaves(tree)]
        assert leaves(own) == leaves(carried)


def test_launchers_train_and_serve_xlstm(capsys):
    """``launch/train.py`` and ``launch/serve.py`` run ``--arch
    xlstm-125m`` (the smoke config) on the CPU."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    ttrain.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2", "--seq", "32",
                 "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=xlstm-125m-smoke" in out and "done: 3 steps" in out and "step    2 loss=" in out
    tserve.main(["--arch", ARCH, "--requests", "6", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "routed=6" in out and out.count("replica ") == 4


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
