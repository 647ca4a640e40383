"""The sharding rules and the mesh helpers held against the reference on the
CPU, shapes only.

For every registry architecture at its full size, the port's
``param_shardings`` over ``model.abstract_params`` (meta tensors) against
the reference's over ``jax.eval_shape`` parameters, on ``AbstractMesh``
(16, 16) and (2, 16, 16) (the production meshes) and (2, 2): fsdp on and
off, decode on and off, and ``pure_dp``.  The port's tree holds one entry
a layer where the reference stacks a period axis, so a stacked leaf's
spec is the reference's without its leading entry (``None``, the period
axis); the reference's specs are carried into the port's layout by
``carry._layers_from_jax``.  On (2, 2) ``pure_dp`` splits the reference's
period axis where four divides the period count: the port has no period
axis, and those leaves are checked to be exactly these.  Then
``batch_shardings`` on each cell's batch and ``cache_shardings`` on each
decode cell's caches, ``default_options`` and the mesh helpers.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.launch import sharding as js
from repro.models import model as jmodel
from repro.models.modules import Policy as JPolicy
from repro_torch.carry import _layers_from_jax
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES, cells_for
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as ts
from repro_torch.models import model as tmodel
from repro_torch.models.modules import Policy

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
OPTIONS = {"default": {}, "fsdp": dict(fsdp=True), "decode": dict(decode=True),
           "fsdp+decode": dict(fsdp=True, decode=True), "pure_dp": dict(pure_dp=True),
           "pure_dp+decode": dict(pure_dp=True, decode=True)}
ARCHS = list(treg.ARCH_IDS)
PERIOD = "period"   # marks a reference spec that splits the stacked period axis


class _Stacked:
    """A reference spec on a stacked leaf: a layer's spec is the rest."""

    def __init__(self, spec):
        self.spec = spec

    def __getitem__(self, i):
        if not self.spec:
            return ()
        return self.spec[1:] if self.spec[0] is None else (PERIOD,) + self.spec


class _StackedShape(_Stacked):
    """A stacked leaf's shape: a layer's shape is the rest."""

    def __getitem__(self, i):
        return self.spec[1:]


def _spec(x):
    return x.spec if isinstance(x, _Stacked) else x


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _jspecs(tree):
    """The reference's NamedSharding tree as tuples wrapped for the carry."""
    return jax.tree.map(lambda s: _Stacked(tuple(s.spec)), tree,
                        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))


def _port(tree) -> dict:
    return {k: v.spec for k, v in _flat(tree)}


def _tp(mesh_name) -> int:
    dims, names = MESHES[mesh_name]
    return dict(zip(names, dims))["model"]


@functools.lru_cache(maxsize=None)
def _abstract(arch, tp):
    jp = jmodel.abstract_params(jreg.get_config(arch), JPolicy(tp=tp, param_dtype=jnp.bfloat16))
    tp_ = tmodel.abstract_params(treg.get_config(arch), Policy(tp=tp, param_dtype=torch.bfloat16))
    return jp, tp_


def _meshes(name):
    dims, names = MESHES[name]
    return AbstractMesh(dims, names), tmesh.MeshShape(dims, names)


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, mesh_name, opt):
    kw = dict(OPTIONS[opt])
    decode = kw.pop("decode", False)
    am, mesh = _meshes(mesh_name)
    jp, tp_ = _abstract(arch, _tp(mesh_name))
    want = _layers_from_jax(_jspecs(js.param_shardings(jp, am, js.ShardingOptions(**kw),
                                                        decode=decode)),
                            jreg.get_config(arch), lambda s, name: s)
    want = {k: _spec(v) for k, v in _flat(want)}
    got = _port(ts.param_shardings(tp_, mesh, ts.ShardingOptions(**kw), decode=decode))
    assert sorted(want) == sorted(got)
    period = {k for k, v in want.items() if v and v[0] == PERIOD}
    assert {k: v for k, v in got.items() if k not in period} == \
        {k: v for k, v in want.items() if k not in period}
    if period:
        # only pure_dp on the small mesh splits the reference's period axis;
        # the port has none and splits its own first dimension that divides
        assert opt.startswith("pure_dp") and mesh_name == "2x2"
        shapes = {k: tuple(v.shape) for k, v in _flat(tp_)}
        for k in period:
            first = next(i for i, n in enumerate(shapes[k]) if n % 4 == 0) \
                if any(n % 4 == 0 for n in shapes[k]) else None
            assert got[k] == (() if first is None else tuple(
                ("data", "model") if i == first else None for i in range(len(shapes[k]))))


def test_stablelm_wq_spec_at_the_production_mesh():
    """The example the reference's rules give at (16, 16)."""
    _, mesh = _meshes("16x16")
    _, tp_ = _abstract("stablelm-1.6b", 16)
    got = ts.param_shardings(tp_, mesh, ts.default_options(treg.get_config("stablelm-1.6b")))
    assert got["layers"][0]["attn"]["wq"].spec == (None, "model", None)
    assert len(_port(got)) == 1 + 1 + 2 + 24 * 10   # embed, lm_head, norm, 24 layers


def _train_cells():
    return [(a, c) for a in ARCHS for c in cells_for(treg.get_config(a))
            if SHAPES[c].kind != "decode"]


def _decode_cells():
    return [(a, c) for a in ARCHS for c in cells_for(treg.get_config(a))
            if SHAPES[c].kind == "decode"]


@pytest.mark.parametrize("pure", [False, True], ids=["dp", "whole mesh"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,cell", _train_cells())
def test_batch_shardings_match_reference(arch, cell, mesh_name, pure):
    am, mesh = _meshes(mesh_name)
    tp = _tp(mesh_name)
    shape = SHAPES[cell]
    jshape = jreg.SHAPES[cell]
    jb = jmodel.input_specs(jreg.get_config(arch), jshape, JPolicy(tp=tp))
    tb = tmodel.input_specs(treg.get_config(arch), shape, Policy(tp=tp))
    assert {k: tuple(v.shape) for k, v in jb.items()} == {k: tuple(v.shape) for k, v in tb.items()}
    axes = tuple(am.axis_names) if pure else None
    want = {k: tuple(v.spec) for k, v in js.batch_shardings(jb, am, axes).items()}
    got = {k: v.spec for k, v in ts.batch_shardings(tb, mesh, axes).items()}
    assert got == want


def _cache_from_jax(tree, cfg):
    """The reference's decode cache (``blocks`` stacked a period, or an
    enc-dec's stacked ``blocks`` and ``xcaches``) in the port's layout."""
    def layer(node, i):
        return {k: layer(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]

    if cfg.encdec:
        return {"pos": tree["pos"],
                "blocks": [layer(tree["blocks"], i) for i in range(cfg.num_layers)],
                "xcaches": [layer(tree["xcaches"], i) for i in range(cfg.num_layers)]}
    out = {"pos": tree["pos"],
           "layers": [layer(tree["blocks"][f"b{j}"], per)
                      for per in range(cfg.num_periods) for j in range(len(cfg.pattern))]}
    for j in range(len(cfg.tail)):
        out[f"tail{j}"] = tree[f"tail{j}"]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,cell", _decode_cells())
def test_cache_shardings_match_reference(arch, cell, mesh_name):
    am, mesh = _meshes(mesh_name)
    tp = _tp(mesh_name)
    jcfg, cfg = jreg.get_config(arch), treg.get_config(arch)
    jcache, _ = jmodel.decode_input_specs(jcfg, jreg.SHAPES[cell], JPolicy(tp=tp))
    tcache, tok = tmodel.decode_input_specs(cfg, SHAPES[cell], Policy(tp=tp))
    batch = SHAPES[cell].global_batch
    assert tuple(tok.shape) == (batch, 1)
    jshapes = _cache_from_jax(jax.tree.map(lambda a: _StackedShape(tuple(a.shape)), jcache), jcfg)
    assert {k: _spec(v) for k, v in _flat(jshapes)} == \
        {k: tuple(getattr(v, "shape", ())) for k, v in _flat(tcache)}
    want = _cache_from_jax(_jspecs(js.cache_shardings(jcache, am, batch)), jcfg)
    want = {k: _spec(v) for k, v in _flat(want)}
    assert not any(v and v[0] == PERIOD for v in want.values())
    assert _port(ts.cache_shardings(tcache, mesh, batch)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_default_options_match_reference(arch):
    want = js.default_options(jreg.get_config(arch))
    got = ts.default_options(treg.get_config(arch))
    assert got.fsdp == want.fsdp
    assert str(got.moment_dtype).split(".")[-1] == jnp.dtype(want.moment_dtype).name
    assert str(got.param_dtype).split(".")[-1] == jnp.dtype(want.param_dtype).name
    assert str(got.compute_dtype).split(".")[-1] == jnp.dtype(want.compute_dtype).name
    for f in ("sp", "remat", "attn_q_chunk", "attn_kv_chunk", "pure_dp", "attn_p_bf16",
              "recurrent_bf16", "remat_policy", "moe_cf", "slstm_unroll"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_helpers_match_reference(multi_pod):
    dims, names = MESHES["2x16x16" if multi_pod else "16x16"]
    am = AbstractMesh(dims, names)
    got = tmesh.make_production_mesh(multi_pod=multi_pod)
    assert got.dims == dims and got.axis_names == names
    assert got.shape == dict(am.shape)
    assert got.size == int(np.prod(dims))
    assert tmesh.dp_axes_of(got) == jmesh.dp_axes_of(am)
    assert tmesh.tp_size(got) == jmesh.tp_size(am)
    assert tmesh.dp_size(got) == jmesh.dp_size(am)


def test_mesh_shape_refuses_bad_axes():
    with pytest.raises(ValueError):
        tmesh.MeshShape((2, 2), ("data",))
    with pytest.raises(ValueError):
        tmesh.MeshShape((2, 2), ("data", "data"))
    with pytest.raises(ValueError):
        tmesh.MeshShape((0, 2), ("data", "model"))


def test_named_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.MeshShape((2, 2, 4), ("pod", "data", "model"))
    assert ts.NamedSpec(mesh, (None, "model", None)).placements() == \
        [Replicate(), Replicate(), Shard(1)]
    assert ts.NamedSpec(mesh, (("pod", "data"), None)).placements() == \
        [Shard(0), Shard(0), Replicate()]
    assert ts.NamedSpec(mesh, ()).placements() == [Replicate()] * 3


def test_abstract_params_allocate_nothing():
    """Llama 4 Maverick's 400.7 B parameters as meta tensors, as many as the
    reference's ``abstract_params`` holds, each leaf of its dtype."""
    arch = "llama4-maverick-400b-a17b"
    params = tmodel.abstract_params(treg.get_config(arch), Policy(param_dtype=torch.bfloat16))
    want = jmodel.abstract_params(jreg.get_config(arch), JPolicy(param_dtype=jnp.bfloat16))
    flat = [v for _, v in _flat(params)]
    assert all(t.device.type == "meta" for t in flat)
    assert sum(t.numel() for t in flat) == sum(int(np.prod(a.shape))
                                               for a in jax.tree.leaves(want))
    assert sum(t.numel() for t in flat) == 400_713_815_040
    assert {str(t.dtype) for t in flat} == {"torch.bfloat16", "torch.float32"}
