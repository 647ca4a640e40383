"""The cases the gradient-sync and pipeline tests run in each spawned rank.

``tests/test_torch_compression.py`` and ``tests/test_torch_pipeline.py``
spawn :func:`run` once a rank (gloo on the CPU, a ``file://`` store in the
test's temporary directory); it runs the case its plan names and saves
what it saw to ``rank<r>.pt`` beside the store.  The inputs are made here
from numpy seeds, so that a reference subprocess (which imports this
module too) feeds the reference the same ones.  This module imports
numpy, torch and the port only, so a spawned rank never loads jax.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

SPAWN_TIMEOUT_S = 300
# the pipeline's smoke model: stablelm-1.6b's smoke config at 4 layers, as
# the reference's tests/test_pipeline.py cuts it
PP_LAYERS = 4
PP_BATCH, PP_SEQ, PP_MICRO = 4, 32, 2
PP_CHUNK = 32


def compression_inputs(rank: int, n: int = 64) -> tuple[dict, dict]:
    """``(grads, error)`` of rank ``rank`` as numpy: a float32 vector, a
    matrix, an all-zero leaf (its error zero too), a leaf at exactly
    ``+max`` and ``-max``, and a bf16-representable one (fed as bf16)."""
    rng = np.random.default_rng(100 + rank)
    edge = rng.standard_normal(16).astype(np.float32)
    edge[3], edge[11] = 2.5, -2.5
    grads = {"w": rng.standard_normal(n).astype(np.float32),
             "m": (3 * rng.standard_normal((8, 16))).astype(np.float32),
             "z": np.zeros(32, np.float32),
             "edge": edge,
             "b16": _bf16_values(rng.standard_normal((4, 8)))}
    error = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in grads.items()}
    error["z"][:] = 0.0
    error["edge"][:] = 0.0
    return grads, error


def _bf16_values(x) -> np.ndarray:
    """float32 values that bf16 holds exactly (the high 16 bits)."""
    bits = np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def sum_inputs(rank: int, n: int = 4096) -> np.ndarray:
    """Rank ``rank``'s float32 gradient for the three-rank float32-sum
    case."""
    return np.random.default_rng(200 + rank).standard_normal(n).astype(np.float32)


def pp_config():
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(reduce_for_smoke(get_config("stablelm-1.6b")),
                               num_layers=PP_LAYERS)


def pp_batch(vocab: int) -> dict:
    """The pipeline's batch as numpy (the reference's test's draws)."""
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (PP_BATCH, PP_SEQ)).astype(np.int32),
            "labels": rng.integers(0, vocab, (PP_BATCH, PP_SEQ)).astype(np.int32),
            "mask": np.ones((PP_BATCH, PP_SEQ), np.float32)}


def nest(flat: dict) -> dict:
    """``{"a/b/c": x}`` as ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _torch_tree(tree):
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _compression(g, out: dict) -> None:
    from repro_torch.train.compression import _quantize, compressed_grad_sync

    grads, error = compression_inputs(g.rank)
    tg = _torch_tree(grads)
    tg["b16"] = tg["b16"].to(torch.bfloat16)
    te = _torch_tree(error)
    out["quantized"] = {k: _quantize(tg[k].to(torch.float32) + te[k]) for k in tg}
    sync = compressed_grad_sync(g)
    before = g.traffic["all_reduce"]
    mean, err = sync(tg, te)
    out["mean"] = mean
    out["error"] = err
    out["bytes"] = g.traffic["all_reduce"] - before


def _float32_sum(g, out: dict) -> None:
    from repro_torch.train.compression import compressed_grad_sync

    x = torch.from_numpy(sum_inputs(g.rank))
    mean, _ = compressed_grad_sync(g)({"w": x}, {"w": torch.zeros_like(x)})
    out["mean"] = mean["w"]


def _pipeline(g, out: dict, plan: dict) -> None:
    from repro_torch.carry import params_from_jax
    from repro_torch.launch.pipeline import make_pp_loss, stack_stage_params, stage_params
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import trainable

    cfg = pp_config()
    tree = nest(dict(np.load(plan["params"])))
    batch = {k: torch.from_numpy(v) for k, v in pp_batch(cfg.vocab_size).items()}
    for remat in (False, True):
        pol = Policy(attn_q_chunk=PP_CHUNK, attn_kv_chunk=PP_CHUNK, remat=remat)
        params = trainable(params_from_jax(tree, cfg, pol, device="cpu"))
        mine = stage_params(stack_stage_params(cfg, params, g.world_size), g.rank)
        loss_fn = make_pp_loss(cfg, pol, g, microbatches=PP_MICRO)
        before = g.traffic["shift"]
        t = time.perf_counter()
        loss = loss_fn(mine, batch)
        grads = torch.autograd.grad(loss, leaves(mine))
        out[f"pp/{remat}"] = {"loss": loss.detach(), "grads": [x.detach() for x in grads],
                              "wall_s": time.perf_counter() - t,
                              "shift_bytes": g.traffic["shift"] - before}
        if plan.get("plain") and g.rank == 0:
            loss, _ = model.loss_fn(params, batch, cfg, pol)
            grads = torch.autograd.grad(loss, leaves(params))
            out[f"plain/{remat}"] = {"loss": loss.detach(), "grads": [x.detach() for x in grads]}
    with torch.no_grad():
        out["no grad"] = make_pp_loss(cfg, pol, g, microbatches=PP_MICRO)(mine, batch)


def _pipeline_card(g, out: dict) -> None:
    """The pipeline on ``g``'s device from the port's own seeded parameters
    (float32, remat), with the flash launches each rank made."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.launch.pipeline import make_pp_loss, stack_stage_params, stage_params
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import trainable

    cfg = pp_config()
    pol = Policy(remat=True)
    params = model.init_params(cfg, 0, pol, device=g.device)
    mine = trainable(stage_params(stack_stage_params(cfg, params, g.world_size), g.rank))
    batch = {k: torch.from_numpy(v).to(g.device) for k, v in pp_batch(cfg.vocab_size).items()}
    kflash.flash_attention.launches = 0
    kflash.flash_attention_bwd_seq_major.launches = 0
    loss = make_pp_loss(cfg, pol, g, microbatches=PP_MICRO)(mine, batch)
    grads = torch.autograd.grad(loss, leaves(mine))
    out["loss"] = loss.detach().cpu()
    out["grads"] = [x.cpu() for x in grads]
    out["launches"] = (kflash.flash_attention.launches,
                       kflash.flash_attention_bwd_seq_major.launches)


def _compression_card(g, out: dict) -> None:
    from repro_torch.train.compression import compressed_grad_sync

    grads, error = compression_inputs(g.rank)
    tg = {k: torch.from_numpy(v).to(g.device) for k, v in grads.items()}
    te = {k: torch.from_numpy(v).to(g.device) for k, v in error.items()}
    mean, err = compressed_grad_sync(g)(tg, te)
    out["mean"] = {k: v.cpu() for k, v in mean.items()}
    out["error"] = {k: v.cpu() for k, v in err.items()}


def run(rank: int, world: int, store: str, plan: dict) -> None:
    """One rank: join the gloo group through ``store``, run the case
    ``plan["case"]`` names (``compression``, ``float32 sum``,
    ``pipeline``; on ``plan["device"]``, the card: ``pipeline card``,
    ``compression card``) and save the results beside the store.  Any
    failure raises, and the spawning parent re-raises it."""
    torch.set_num_threads(1)
    from repro_torch.exchange.dist import WorkerGroup

    g = WorkerGroup.init(backend="gloo", rank=rank, world_size=world,
                         init_method=f"file://{store}", device=plan.get("device", "cpu"))
    out: dict = {"rank": rank}
    case = plan["case"]
    if case == "compression":
        _compression(g, out)
    elif case == "float32 sum":
        _float32_sum(g, out)
    elif case == "pipeline":
        _pipeline(g, out, plan)
    elif case == "pipeline card":
        _pipeline_card(g, out)
    elif case == "compression card":
        _compression_card(g, out)
    elif case == "mismatched hand-off":
        # rank 0 skips a hand-off the others make: they wait on it
        if rank:
            g.shift(torch.zeros(4))
        time.sleep(3600)
    else:
        raise ValueError(case)
    g.close()
    torch.save(out, Path(store).parent / f"rank{rank}.pt")


def start(d: Path, world: int, plan: dict):
    """Start ``world`` ranks of :func:`run` with their store in ``d``;
    :func:`wait` collects them."""
    import torch.multiprocessing as mp

    d.mkdir(parents=True, exist_ok=True)
    return mp.start_processes(run, args=(world, str(d / "store"), plan), nprocs=world,
                              start_method="spawn", join=False)


def wait(ctx, d: Path, world: int, timeout_s: float = SPAWN_TIMEOUT_S) -> list:
    """Wait for the ranks of ``ctx`` (a rank that raises makes this raise;
    past ``timeout_s`` they are killed) and return their saved results, in
    rank order."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
