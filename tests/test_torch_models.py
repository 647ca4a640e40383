"""The port's LM stack (configs, modules, attention, transformer, model)
held against the reference on the CPU.

Inputs come from numpy seeds; reference parameters are carried over with
``repro_torch.carry.params_from_jax``, so both packages compute the same
function.  Tolerances: data (configs, head layouts, cache positions and
offsets) equal exactly; float32 model numerics within 1e-4 (sums run in
another order: XLA's dots against torch's), element-wise pieces within
1e-5; the flash wrapper at the reference's own 2e-5 (float32) and 2e-2
(bf16).
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
from repro_torch.carry import params_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel
from repro_torch.models import attention as tatt
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmod

ARCHS = ["gemma-2b", "stablelm-1.6b", "deepseek-coder-33b", "gemma3-27b", "xlstm-125m"]
JPOL = jmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)
TPOL = tmod.Policy(attn_q_chunk=16, attn_kv_chunk=16)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _carry(cfg, seed=0):
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(seed), JPOL)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, params_from_jax(tree, _port_cfg(cfg), TPOL, device="cpu")


def _port_cfg(cfg):
    """The port's config equal to the reference's ``cfg`` (smoke or not)."""
    pc = treg.get_config(cfg.name.removesuffix("-smoke"))
    return tbase.reduce_for_smoke(pc) if cfg.name.endswith("-smoke") else pc


# ---------------------------------------------------------------------------
# configs: pure data, copied
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    js, ts = jbase.reduce_for_smoke(j), tbase.reduce_for_smoke(t)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    for a, b in ((j, t), (js, ts)):
        assert a.param_count() == b.param_count()
        assert a.param_count(active_only=True) == b.param_count(active_only=True)
        assert a.num_periods == b.num_periods
    assert jbase.cells_for(j) == tbase.cells_for(t)


def test_registry_and_shapes_equal_the_reference():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.all_cells() == jreg.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


@pytest.mark.parametrize("hq,hkv,tp", [(8, 1, 1), (4, 2, 1), (4, 1, 2), (28, 4, 16),
                                       (56, 8, 16), (40, 8, 16), (32, 32, 4)])
def test_head_layout_equals_the_reference(hq, hkv, tp):
    assert dataclasses.asdict(tatt.head_layout(hq, hkv, tp)) == dataclasses.asdict(
        jatt.head_layout(hq, hkv, tp))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    p = {"w": rng.standard_normal(24).astype(np.float32)}
    if kind == "layernorm":
        p["b"] = rng.standard_normal(24).astype(np.float32)
    want = jmod.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    got = tmod.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    init = tmod.init_norm(kind, 24, torch.float32, "cpu")
    assert {k: _np(v).tolist() for k, v in init.items()} == {
        k: np.asarray(v).tolist() for k, v in jmod.init_norm(kind, 24, jnp.float32).items()}


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn_matches(kind):
    rng = np.random.default_rng(1)
    gate = 1 if kind == "gelu" else 2
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    p = {"wi": rng.standard_normal((32, gate, 48)).astype(np.float32) * 0.2,
         "wo": rng.standard_normal((48, 32)).astype(np.float32) * 0.2}
    want = jmod.apply_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind,
                          jmod.Policy())
    got = tmod.apply_ffn({k: _t(v) for k, v in p.items()}, _t(x), kind, tmod.Policy())
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [True, False])
def test_embed_and_unembed_match(dtype, scale):
    rng = np.random.default_rng(2)
    vocab, d = 300, 48
    tok = rng.standard_normal((tmod.pad_vocab(vocab), d)).astype(np.float32)
    tokens = rng.integers(0, vocab, (2, 7))
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                        torch.float32)
    jx = jmod.embed({"tok": jnp.asarray(tok)}, jnp.asarray(tokens), scale=scale, d=d,
                    pol=jmod.Policy(compute_dtype=jd))
    tx = tmod.embed({"tok": _t(tok)}, _t(tokens), scale=scale, d=d,
                    pol=tmod.Policy(compute_dtype=td))
    assert tx.dtype == td
    np.testing.assert_array_equal(_np(tx), np.asarray(jx.astype(jnp.float32)))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = jmod.unembed_logits(jnp.asarray(x), jnp.asarray(tok), jmod.Policy())
    got = tmod.unembed_logits(_t(x), _t(tok), tmod.Policy())
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tmod.pad_vocab(vocab) == jmod.pad_vocab(vocab) == 512


@pytest.mark.parametrize("pct,theta", [(1.0, 10_000.0), (0.25, 10_000.0), (1.0, 1e6)])
def test_rope_matches(pct, theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 9)).astype(np.int32)
    want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta, pct=pct)
    got = tatt.apply_rope(_t(x), _t(pos), theta=theta, pct=pct)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    # M-RoPE: distinct (t, h, w) streams over sections of the hd_rot / 2 frequencies
    half = int(32 * pct) // 2
    secs = (half // 4, (half - half // 4) // 2, half - half // 4 - (half - half // 4) // 2)
    pos3 = rng.integers(0, 3000, (3, 2, 9)).astype(np.int32)
    want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos3), theta=theta, pct=pct,
                           mrope_sections=secs)
    got = tatt.apply_rope(_t(x), _t(pos3), theta=theta, pct=pct, mrope_sections=secs)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_policy_rejects_unported_fields(tmp_path):
    """The mesh field takes a ProcessMesh and nothing else (its parity is
    ``tests/test_torch_policy_mesh.py``'s); the MoE fields construct (their
    parity is ``tests/test_torch_moe*.py``'s; remat's is
    ``tests/test_torch_remat.py``'s)."""
    import mesh_cases
    from repro_torch.launch.mesh import MeshShape

    for bad in (object(), MeshShape((1, 4), ("data", "model"))):
        with pytest.raises(ValueError, match="ProcessMesh"):
            tmod.Policy(mesh=bad)
    with mesh_cases.one_rank_mesh(tmp_path) as pm:
        pol = tmod.Policy(mesh=pm, dp_axes=("data",), tp_axis="model")
        assert (pol.mesh, pol.dp_axes, pol.tp_axis) == (pm, ("data",), "model")
        with pytest.raises(ValueError, match="ep_shards"):
            tmod.Policy(mesh=pm, ep_shards=1)
    pol = tmod.Policy(moe_capacity_factor=1.5, exchange_backend="ragged", ep_shards=4)
    assert (pol.moe_capacity_factor, pol.exchange_backend, pol.ep_shards) == (1.5, "ragged", 4)
    with pytest.raises(ValueError, match="ep_shards"):
        tmod.Policy(ep_shards=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_model_flash_attention_matches(dtype, causal, window):
    """The port's ``models.attention.flash_attention`` (over the kernel
    wrapper) against the reference's jnp flash at B = 2, same chunks."""
    rng = np.random.default_rng(4)
    b, sq, g, qps, hd = 2, 37, 2, 3, 16
    q = rng.standard_normal((b, sq, g, qps, hd)).astype(np.float32)
    k = rng.standard_normal((b, sq, g, hd)).astype(np.float32)
    v = rng.standard_normal((b, sq, g, hd)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                        torch.float32)
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = jatt.flash_attention(jq, jk, jv, causal=causal, window=window, q_chunk=16,
                                kv_chunk=16)
    before = flash_kernel.launches
    got = tatt.flash_attention(*(_t(np.asarray(x.astype(jnp.float32))).to(td)
                                 for x in (jq, jk, jv)),
                               causal=causal, window=window, q_chunk=16, kv_chunk=16)
    assert got.dtype == td and got.shape == q.shape and flash_kernel.launches == before
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _attn_case(window, qk_norm, norm_kind, tp, hq=4, hkv=1):
    rng = np.random.default_rng(5)
    d, hd = 32, 16
    jlay, tlay = jatt.head_layout(hq, hkv, tp), tatt.head_layout(hq, hkv, tp)
    jp = jatt.init_attention(jax.random.PRNGKey(1), d, jlay, hd, qk_norm=qk_norm,
                             norm_kind=norm_kind, dtype=jnp.float32)
    if qk_norm:  # non-trivial norm weights
        jp["q_norm"]["w"] = jnp.asarray(rng.standard_normal(hd).astype(np.float32) * 0.3)
        jp["k_norm"]["w"] = jnp.asarray(rng.standard_normal(hd).astype(np.float32) * 0.3)
    tp_ = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return rng, d, jlay, tlay, jp, tp_


@pytest.mark.parametrize("window,qk_norm,norm_kind,tp", [
    (0, False, "rmsnorm", 1),      # gemma-2b-like: MQA
    (0, True, "rmsnorm", 2),       # kv heads replicated to the tp layout
    (6, True, "rmsnorm", 1),       # ring cache: prompt longer than the window
    (0, False, "layernorm", 1),
])
def test_attention_block_prefill_and_decode_with_caches(window, qk_norm, norm_kind, tp):
    rng, d, jlay, tlay, jp, tp_ = _attn_case(window, qk_norm, norm_kind, tp)
    b, s, max_len, steps = 2, 11, 20, 9
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(causal=True, window=window, theta=10_000.0, norm_kind=norm_kind)
    jc = jatt.init_kv_cache(b, max_len, jlay, 16, window=window, dtype=jnp.float32)
    tc = tatt.init_kv_cache(b, max_len, tlay, 16, window=window, dtype=torch.float32)
    jy, jc = jatt.attention_block(jp, jnp.asarray(x), jlay, JPOL, pos=jnp.asarray(pos),
                                  cache=jc, **kw)
    ty, tc = tatt.attention_block(tp_, _t(x), tlay, TPOL, pos=_t(pos), cache=tc, **kw)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-4, atol=1e-4)

    def same_cache():
        np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert tc["offset"] == int(jc["offset"])

    same_cache()
    for t in range(steps):  # decode, wrapping the ring cache when windowed
        xt = rng.standard_normal((b, 1, d)).astype(np.float32)
        pt = np.full((b, 1), s + t, np.int32)
        jy, jc = jatt.attention_block(jp, jnp.asarray(xt), jlay, JPOL, pos=jnp.asarray(pt),
                                      cache=jc, **kw)
        ty, tc = tatt.attention_block(tp_, _t(xt), tlay, TPOL, pos=_t(pt), cache=tc, **kw)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-4, atol=1e-4)
        same_cache()


def test_attention_block_without_cache_matches():
    rng, d, jlay, tlay, jp, tp_ = _attn_case(0, False, "rmsnorm", 1, hq=4, hkv=2)
    x = rng.standard_normal((2, 19, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19))
    jy, jc = jatt.attention_block(jp, jnp.asarray(x), jlay, JPOL, pos=jnp.asarray(pos),
                                  rope_pct=0.25)
    ty, tc = tatt.attention_block(tp_, _t(x), tlay, TPOL, pos=_t(pos), rope_pct=0.25)
    assert jc is None and tc is None
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the whole model: prefill and teacher-forced decode
# ---------------------------------------------------------------------------


def _ref_layers(cache, cfg):
    """The reference's stacked caches, one per layer in execution order."""
    out = []
    for per in range(cfg.num_periods):
        for j in range(len(cfg.pattern)):
            out.append(jax.tree.map(lambda a: a[per], cache["blocks"][f"b{j}"]))
    return out + [cache[f"tail{j}"] for j in range(len(cfg.tail))]


def _same_caches(tc, jc, cfg):
    """Attention caches: k and v within 1e-4, slot positions and offsets
    equal; a recurrent state (mLSTM, sLSTM): every leaf within 1e-4."""
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    port = tc["layers"] + [tc[f"tail{j}"] for j in range(len(cfg.tail))]
    ref = _ref_layers(jc, cfg)
    assert len(port) == len(ref) == cfg.num_layers
    for t, j in zip(port, ref):
        assert sorted(t) == sorted(j)
        if "k" not in j:
            for key in j:
                np.testing.assert_allclose(_np(t[key]), np.asarray(j[key], np.float32),
                                           rtol=1e-4, atol=1e-4)
            continue
        np.testing.assert_allclose(_np(t["k"]), np.asarray(j["k"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(t["v"]), np.asarray(j["v"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        assert t["offset"] == int(j["offset"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch):
    """``reduce_for_smoke`` of each dense arch: prefill logits and caches,
    then six teacher-forced decode steps (gemma3's local layers wrap their
    16-slot ring caches)."""
    cfg = jbase.reduce_for_smoke(jreg.get_config(arch))
    tcfg = _port_cfg(cfg)
    jparams, tparams = _carry(cfg)
    rng = np.random.default_rng(6)
    b, s, max_len = 2, 21, 40
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jlog, jc = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cfg, JPOL, max_len))(
        jparams, jnp.asarray(tokens))
    tlog, tc = tmodel.prefill(tparams, {"tokens": _t(tokens)}, tcfg, TPOL, max_len)
    assert tlog.shape == jlog.shape == (b, 1, tmod.pad_vocab(cfg.vocab_size))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    _same_caches(tc, jc, cfg)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, cfg, JPOL))
    for _ in range(6):
        nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlog, jc = step(jparams, jc, jnp.asarray(nxt))
        tlog, tc = tmodel.decode_step(tparams, tc, _t(nxt), tcfg, TPOL)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4, atol=1e-4)
        _same_caches(tc, jc, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carried_parameters_unstack_every_period(dtype):
    """gemma3's pattern at two periods plus its tail: layer
    ``period * 6 + j`` is ``blocks.b{j}[period]``, in either type."""
    cfg = dataclasses.replace(jbase.reduce_for_smoke(jreg.get_config("gemma3-27b")),
                              num_layers=14)
    tcfg = dataclasses.replace(_port_cfg(cfg), num_layers=14)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                        torch.float32)
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(3), jmod.Policy(param_dtype=jd))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              tmod.Policy(param_dtype=td), device="cpu")
    assert sum(np.asarray(a).size for a in jax.tree.leaves(jparams)) == sum(
        t.numel() for t in _leaves(tparams))
    assert all(t.dtype == td for t in _leaves(tparams))
    assert len(tparams["layers"]) == 12
    np.testing.assert_array_equal(
        _np(tparams["layers"][7]["attn"]["wq"]),                    # period 1, position 1
        np.asarray(jparams["blocks"]["b1"]["attn"]["wq"][1], np.float32))
    np.testing.assert_array_equal(_np(tparams["tail1"]["ffn"]["wo"]),
                                  np.asarray(jparams["tail1"]["ffn"]["wo"], np.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_port_init_params_shapes_match_the_reference():
    cfg = jbase.reduce_for_smoke(jreg.get_config("deepseek-coder-33b"))
    tparams = tmodel.init_params(_port_cfg(cfg), 0, TPOL, device="cpu")
    _, carried = _carry(cfg)
    shapes = lambda tree: [tuple(t.shape) for t in _leaves(tree)]
    assert shapes(tparams) == shapes(carried)
    again = tmodel.init_params(_port_cfg(cfg), 0, TPOL, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tparams), _leaves(again)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_init_params_shapes_match_the_reference(dtype):
    """whisper-base's smoke config: the port's own init draws the
    reference's tree (``enc`` / ``dec`` as per-layer lists) in the
    policy's type, the same on every call."""
    cfg = jbase.reduce_for_smoke(jreg.get_config("whisper-base"))
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                        torch.float32)
    tparams = tmodel.init_params(_port_cfg(cfg), 0, tmod.Policy(param_dtype=td), device="cpu")
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(0), jmod.Policy(param_dtype=jd))
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), _port_cfg(cfg),
                              tmod.Policy(param_dtype=td), device="cpu")
    shapes = lambda tree: [(tuple(t.shape), t.dtype) for t in _leaves(tree)]
    assert shapes(tparams) == shapes(carried)
    assert len(tparams["enc"]) == cfg.enc_layers and len(tparams["dec"]) == cfg.num_layers
    again = tmodel.init_params(_port_cfg(cfg), 0, tmod.Policy(param_dtype=td), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tparams), _leaves(again)))


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"])
def test_moe_families_are_supported(arch):
    """The port's own init of both MoE configs draws the reference's
    parameter shapes (the router float32)."""
    cfg = jbase.reduce_for_smoke(jreg.get_config(arch))
    tparams = tmodel.init_params(_port_cfg(cfg), 0, TPOL, device="cpu")
    _, carried = _carry(cfg)
    shapes = lambda tree: [tuple(t.shape) for t in _leaves(tree)]
    assert shapes(tparams) == shapes(carried)
    moe = [layer["moe"] for layer in tparams["layers"] if "moe" in layer]
    assert moe and all(m["router"].dtype == torch.float32 for m in moe)


def test_training_is_not_ported(tmp_path):
    """Training under the mesh, which this test once pinned as refused, is
    ported: on a one-rank ``(1, 1)`` mesh, ``loss_fn``'s loss and its
    gradient of every leaf under ``Policy(mesh=...)`` equal the stacked
    ``Policy(ep_shards=1)`` path's (float32, within 1e-6 x max(1, |g|):
    the mesh path routes its own block, the stacked one the whole batch,
    in another summation order).  The four-rank meshes are
    ``tests/test_torch_mesh_train.py``'s."""
    import mesh_cases

    cfg = tbase.reduce_for_smoke(treg.get_config("llama4-scout-17b-a16e"))
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 8)))
    batch = {"tokens": toks, "labels": toks.roll(1, dims=1), "mask": torch.ones((2, 8))}
    with mesh_cases.one_rank_mesh(tmp_path) as pm:
        got = {}
        for name, pol in (("mesh", tmod.Policy(mesh=pm, **f32)),
                          ("stacked", tmod.Policy(ep_shards=1, **f32))):
            params = tmodel.init_params(cfg, 0, pol, device="cpu")
            flat = _leaves(params)
            for t in flat:
                t.requires_grad_(True)
            loss, metrics = tmodel.loss_fn(params, batch, cfg, pol)
            got[name] = (loss, metrics["expert_counts"],
                         torch.autograd.grad(loss, flat, allow_unused=True))
    (lm, cm, gm), (ls, cs, gs) = got["mesh"], got["stacked"]
    assert torch.equal(cm, cs)
    np.testing.assert_allclose(float(lm), float(ls), rtol=1e-6)
    assert len(gm) == len(gs) and all(g is not None for g in gm)
    for a, b in zip(gm, gs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_init_params_targets_the_card_by_default():
    cfg = tbase.reduce_for_smoke(treg.get_config("gemma-2b"))
    if torch.cuda.is_available():
        assert tmodel.init_params(cfg, 0, TPOL)["embed"]["tok"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.init_params(cfg, 0, TPOL)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.init_cache(cfg, 1, 8, TPOL)
