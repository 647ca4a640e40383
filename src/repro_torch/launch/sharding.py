"""Sharding rules: map parameter, batch and cache trees to named specs (a
port of ``repro.launch.sharding``'s rules).

Strategy (the reference's): data parallelism over ("pod", "data"), tensor
parallelism over "model" (heads, d_ff, vocab, experts), FSDP over "data"
for the weight matrices of the large archs, experts over "model".  Rules
are (path regex, rank -> spec) pairs matched against a leaf's path in
the tree; the first match wins.

A spec is what a jax ``PartitionSpec`` holds: a tuple with one entry a
dimension, each an axis name, a tuple of names, or ``None``.
:class:`NamedSpec` pairs it with its mesh (a :class:`~repro_torch.launch.
mesh.MeshShape`, or anything with ``.shape`` and ``.axis_names``) and gives
the DTensor placements for a ``DeviceMesh`` of that mesh
(:meth:`NamedSpec.placements`).

The port's trees hold one entry a layer (``layers/<i>/attn/wq``) where the
reference stacks a period axis in front (``blocks/b<j>/attn/wq``).  The
rules are applied to the port's own leaves, so a stacked leaf's spec here
is the reference's without the leading ``None`` that ``_pad`` puts on the
period axis.  Build full-size trees for the rules with
``model.abstract_params`` (meta tensors, no storage).

:func:`make_policy` is the reference's: the ``Policy`` that runs a model
under a :class:`~repro_torch.launch.mesh.ProcessMesh`, every field as the
reference sets it.  Its ``shard`` callback returns ``x`` unchanged: every
rank holds the activations whole, and the reference's constraint changes
their layout, not their values.  The table it constrains by (logical
activation name -> spec) stays here as :func:`activation_specs`, for the
tensor-parallel layout that would redistribute by it.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models.modules import Policy, no_shard

__all__ = ["NamedSpec", "ShardingOptions", "activation_specs", "batch_shardings",
           "cache_shardings", "default_options", "make_policy", "param_shardings",
           "policy_fields"]

TP = "model"


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    fsdp: bool = False          # shard big weight matrices over "data" too
    sp: bool = True             # sequence-sharded residual stream (train/prefill)
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    moment_dtype: torch.dtype = torch.float32
    remat: bool = True
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 2048
    pure_dp: bool = False       # no TP: FSDP/ZeRO-3 over the whole mesh
    attn_p_bf16: bool = False   # bf16 softmax-weights @ V
    recurrent_bf16: bool = False  # bf16 gate/qkv precompute in ssm/xlstm
    remat_policy: str = "nothing"  # "nothing" | "save_moe"
    moe_cf: float = 0.0         # capacity-factor override (0 = config value)
    slstm_unroll: int = 1       # sLSTM steps per scan tick


def default_options(cfg: ArchConfig) -> ShardingOptions:
    """FSDP above 20 B parameters; bf16 Adam moments above 100 B."""
    big = cfg.param_count() > 20e9
    huge = cfg.param_count() > 100e9
    return ShardingOptions(fsdp=big, moment_dtype=torch.bfloat16 if huge else torch.float32)


def _data_axes(mesh, opts: ShardingOptions) -> tuple[str, ...]:
    """The batch axes: the whole mesh under ``pure_dp``, else the data
    axes."""
    return tuple(mesh.axis_names) if opts.pure_dp else dp_axes_of(mesh)


def policy_fields(mesh, opts: ShardingOptions) -> dict:
    """The fields :func:`make_policy` sets beside ``mesh`` and ``shard``,
    read from ``mesh``'s shape alone (any object with ``.shape`` and
    ``.axis_names``): ``tp`` the model axis's size (1 under ``pure_dp``),
    ``dp_axes`` the data axes (the whole mesh under ``pure_dp``), and the
    options' dtypes, chunks and knobs."""
    return dict(
        param_dtype=opts.param_dtype,
        compute_dtype=opts.compute_dtype,
        tp=1 if opts.pure_dp else mesh.shape[TP],
        dp_axes=_data_axes(mesh, opts),
        tp_axis=TP,
        remat=opts.remat,
        attn_q_chunk=opts.attn_q_chunk,
        attn_kv_chunk=opts.attn_kv_chunk,
        attn_p_bf16=opts.attn_p_bf16,
        recurrent_bf16=opts.recurrent_bf16,
        remat_policy=opts.remat_policy,
        moe_capacity_factor=opts.moe_cf,
        slstm_unroll=opts.slstm_unroll,
    )


def make_policy(cfg: ArchConfig, mesh, shape_kind: str, opts: ShardingOptions) -> Policy:
    """The reference's ``make_policy``: ``Policy()`` for ``mesh=None``, else
    a policy that executes under ``mesh`` (a :class:`~repro_torch.launch.
    mesh.ProcessMesh`; anything else raises ``ValueError`` in ``Policy``)
    with :func:`policy_fields`.  Its ``shard`` is the identity: the
    reference's constraints (:func:`activation_specs`) move no value."""
    if mesh is None:
        return Policy()
    return Policy(shard=no_shard, mesh=mesh, **policy_fields(mesh, opts))


def activation_specs(mesh, shape_kind: str, opts: ShardingOptions) -> dict:
    """The specs the reference's ``make_policy`` constrains each logical
    activation name to (``act_btd``, ``act_q``, ``act_kv``,
    ``ffn_hidden4``, ``ssm_inner``, ``logits``), as :class:`NamedSpec`
    on ``mesh``; under ``pure_dp`` only ``act_btd`` and ``logits``, batch
    over the whole mesh.  Empty where it constrains nothing: decode, or
    ``sp`` off.  A tensor of another rank than its spec's is left as it
    is there."""
    if shape_kind not in ("train", "prefill") or not opts.sp:
        return {}
    dp = _data_axes(mesh, opts)
    dp_spec = dp if len(dp) > 1 else dp[0]
    if opts.pure_dp:
        return {name: NamedSpec(mesh, (dp_spec, None, None)) for name in ("act_btd", "logits")}
    specs = {
        "act_btd": (dp_spec, TP, None),
        "act_q": (dp_spec, None, TP, None),
        "act_kv": (dp_spec, None, TP, None),
        "ffn_hidden4": (dp_spec, None, None, TP),
        "ssm_inner": (dp_spec, None, TP),
        "logits": (dp_spec, None, TP),
    }
    return {name: NamedSpec(mesh, spec) for name, spec in specs.items()}


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec on a mesh: ``spec[d]`` names the mesh axis (or axes, a tuple,
    major first) dimension ``d`` is split over, or is ``None``."""

    mesh: object
    spec: tuple

    def placements(self) -> list:
        """The DTensor placements on a ``DeviceMesh`` of :attr:`mesh` (one a
        mesh axis, in axis order): ``Shard(d)`` where dimension ``d`` is
        split over the axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, ax in enumerate(self.spec)
                    if ax == axis or (isinstance(ax, tuple) and axis in ax)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out


# ---------------------------------------------------------------------------
# tree walking
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    """A tensor's shape; a host scalar (a cache's ``offset``) is rank 0."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix.rstrip("/"), tree


def _rebuild(tree, specs: dict, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, specs, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_rebuild(v, specs, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    if tree is None:
        return None
    return specs[prefix.rstrip("/")]


def _by_path(tree, assign):
    specs = {k: assign(k, v) for k, v in _tree_paths(tree)}
    return _rebuild(tree, specs)


def _axes_size(mesh, ax) -> int:
    return math.prod(mesh.shape[a] for a in (ax if isinstance(ax, tuple) else (ax,)))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------


def _pad(rank: int, spec: tuple) -> tuple:
    """Left-pad a spec with None for a stacked period axis (if present)."""
    if rank == len(spec):
        return spec
    if rank != len(spec) + 1:
        raise ValueError(f"rank {rank} vs spec {spec}")
    return (None,) + spec


def _param_rules(fsdp: bool, decode: bool = False):
    """(path regex, rank -> spec).  First match wins.

    Decode mode: no FSDP (weight gathers a token are absurd); MoE expert
    FFNs are F-sharded over the data axes instead (expert-TP, zero weight
    movement)."""
    fs = "data" if (fsdp and not decode) else None
    if decode:
        moe_rules = [
            (r"moe/router$", lambda r: _pad(r, (None, None))),
            (r"moe/wi$", lambda r: _pad(r, (TP, None, None, "data"))),
            (r"moe/wo$", lambda r: _pad(r, (TP, "data", None))),
            (r"moe/shared/wi$", lambda r: _pad(r, (None, None, TP))),
            (r"moe/shared/wo$", lambda r: _pad(r, (TP, None))),
        ]
    else:
        moe_rules = [
            (r"moe/router$", lambda r: _pad(r, (None, None))),
            (r"moe/wi$", lambda r: _pad(r, (TP, fs, None, None))),
            (r"moe/wo$", lambda r: _pad(r, (TP, None, fs))),
            (r"moe/shared/wi$", lambda r: _pad(r, (fs, None, TP))),
            (r"moe/shared/wo$", lambda r: _pad(r, (TP, fs))),
        ]
    return moe_rules + [
        # embeddings / unembedding: vocab over model (+ d over data FSDP)
        (r"embed/tok$", lambda r: (TP, fs)),
        (r"lm_head$", lambda r: (TP, fs)),
        (r"dec_pos$", lambda r: (None, TP)),
        # attention
        (r"attn/wq$", lambda r: _pad(r, (fs, TP, None))),
        (r"attn/wk$", lambda r: _pad(r, (fs, None, None))),
        (r"attn/wv$", lambda r: _pad(r, (fs, None, None))),
        (r"attn/wo$", lambda r: _pad(r, (TP, None, fs))),
        # dense ffn
        (r"ffn/wi$", lambda r: _pad(r, (fs, None, TP))),
        (r"ffn/wo$", lambda r: _pad(r, (TP, fs))),
        # mamba
        (r"mamba/in_proj$", lambda r: _pad(r, (fs, None, TP))),
        (r"mamba/conv_w$", lambda r: _pad(r, (None, TP))),
        (r"mamba/conv_b$", lambda r: _pad(r, (TP,))),
        (r"mamba/x_proj$", lambda r: _pad(r, (TP, None))),
        (r"mamba/dt_proj$", lambda r: _pad(r, (None, TP))),
        (r"mamba/dt_bias$", lambda r: _pad(r, (TP,))),
        (r"mamba/a_log$", lambda r: _pad(r, (TP, None))),
        (r"mamba/d_skip$", lambda r: _pad(r, (TP,))),
        (r"mamba/out_proj$", lambda r: _pad(r, (TP, fs))),
        # xlstm
        (r"mlstm/up$", lambda r: _pad(r, (fs, None, TP))),
        (r"mlstm/conv_[wb]$", lambda r: _pad(r, (None, TP) if r >= 2 else (TP,))),
        (r"mlstm/w[qkv]$", lambda r: _pad(r, (None, TP, None))),
        (r"mlstm/w_if$", lambda r: _pad(r, (None, None, TP))),
        (r"mlstm/b_if$", lambda r: _pad(r, (None, TP))),
        (r"mlstm/down$", lambda r: _pad(r, (TP, None, fs))),
        (r"slstm/w$", lambda r: _pad(r, (None, None, TP, None))),
        (r"slstm/r$", lambda r: _pad(r, (None, TP, None, None))),
        (r"slstm/b$", lambda r: _pad(r, (None, TP, None))),
        (r"slstm/down$", lambda r: _pad(r, (TP, None, fs))),
        # norms + everything small: replicated
        (r"", lambda r: ()),
    ]


def param_shardings(params, mesh, opts: ShardingOptions, decode: bool = False):
    """A :class:`NamedSpec` tree matching ``params`` (tensors, or meta
    tensors from ``model.abstract_params``).  A dimension the mesh axes do
    not divide evenly is replicated."""
    if opts.pure_dp:
        return _pure_dp_shardings(params, mesh)
    rules = _param_rules(opts.fsdp, decode)

    def assign(path, leaf):
        shape = _shape(leaf)
        for pat, fn in rules:
            if re.search(pat, path):
                spec = tuple(fn(len(shape))) + (None,) * len(shape)
                fixed = tuple(None if ax is None or dim % _axes_size(mesh, ax) else ax
                              for dim, ax in zip(shape, spec))
                return NamedSpec(mesh, fixed)
        raise AssertionError(f"no rule for {path}")

    return _by_path(params, assign)


def _pure_dp_shardings(params, mesh):
    """ZeRO-3/FSDP: every tensor split over the *whole* mesh along its
    first evenly-divisible dimension; small tensors replicate."""
    axes = tuple(mesh.axis_names)
    n = math.prod(mesh.shape[a] for a in axes)

    def assign(_, leaf):
        shape = _shape(leaf)
        for i, dim in enumerate(shape):
            if dim % n == 0:
                spec = [None] * len(shape)
                spec[i] = axes
                return NamedSpec(mesh, tuple(spec))
        return NamedSpec(mesh, ())

    return _by_path(params, assign)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------


def batch_shardings(batch, mesh, axes: tuple | None = None):
    """The batch dimension over the longest suffix of the data axes (or
    ``axes``) whose product divides it; the rest replicated."""
    dp = axes or dp_axes_of(mesh)

    def assign(_, leaf):
        shape = _shape(leaf)
        if not shape:
            return NamedSpec(mesh, ())
        use = list(dp)
        while use and shape[0] % math.prod(mesh.shape[a] for a in use):
            use.pop(0)
        if not use:
            return NamedSpec(mesh, ())
        spec = tuple(use) if len(use) > 1 else use[0]
        return NamedSpec(mesh, (spec,) + (None,) * (len(shape) - 1))

    return _by_path(batch, assign)


STACKED = re.compile(r"(layers|blocks|xcaches)/\d+/")


def cache_shardings(cache, mesh, batch: int):
    """KV / SSM caches: the batch over the data axes when they divide it;
    heads (or the Mamba inner dimension) over "model"; for a batch the
    data axes do not divide (batch 1, long context), the KV sequence over
    them.

    The reference's rules read a periodic layer's cache with its stacked
    period axis in front, and some decide on that rank (an sLSTM's
    ``[B, H]`` state is rank 3 there); so a port leaf under ``layers/<i>``
    (an enc-dec's ``blocks/<i>``, ``xcaches/<i>``) is read with a period
    axis put back in front, and its spec is the rest."""
    dp = dp_axes_of(mesh)
    dp_spec = dp if len(dp) > 1 else dp[0]
    dpn = math.prod(mesh.shape[a] for a in dp)
    tp = mesh.shape[TP]
    batch_ok = batch % dpn == 0

    def assign(path, leaf):
        stacked = bool(STACKED.match(path))
        # the period axis put back has size 0: never the batch, never split
        shape = ((0,) if stacked else ()) + _shape(leaf)
        rank = len(shape)
        spec = [None] * rank
        # the batch dimension: the first equal to `batch`, after an optional stack axis
        for i, dim in enumerate(shape):
            if dim == batch and batch_ok and i <= 1:
                spec[i] = dp_spec
                break
        if re.search(r"/(k|v)$", path) and rank >= 4:
            # [..., B, L, H, hd]
            h_axis, l_axis = rank - 2, rank - 3
            if shape[h_axis] % tp == 0:
                spec[h_axis] = TP
            if not batch_ok and shape[l_axis] % dpn == 0:
                spec[l_axis] = dp_spec
        elif re.search(r"(ssm|conv)$", path) and rank >= 3:
            # mamba states [..., B, *, di]: the inner dimension over model
            if shape[-1] % tp == 0:
                spec[-1] = TP
        elif re.search(r"/(c|n|m|h)$", path) and rank >= 3:
            # xlstm states [..., B, H, ...]: heads over model
            h_axis = 2 if shape[0] != batch else 1
            if h_axis < rank and shape[h_axis] % tp == 0:
                spec[h_axis] = TP
        return NamedSpec(mesh, tuple(spec[1:] if stacked else spec))

    return _by_path(cache, assign)
