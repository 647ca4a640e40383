"""End-to-end training driver (a port of ``repro.launch.train``; the same
arguments plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch llama4-scout-17b-a16e --smoke --steps 8 --ckpt-dir /tmp/ckpt

Runs the production loop: data pipeline -> train step -> DR
expert-placement safe points -> checkpoints (atomic, resumable).
``--device`` defaults to ``cuda`` and raises without a card; ``--smoke``
trains the ``reduce_for_smoke`` config.  An enc-dec model (whisper-base)
gets zero frame embeddings ``[batch, enc_len, d]``, and a model with vision
tokens (qwen2-vl) zero patch embeddings ``[batch, vision_tokens, d]``, as
the reference's launcher gives them.  The patches replace each sequence's
first ``vision_tokens`` rows, so qwen2-vl-7b's full config needs ``--seq``
of at least 256 (the default 128 raises ``ValueError``; the reference's
launcher fails there too); its smoke config has 8 vision tokens.  Zero
patches keep their rows exactly zero through every layer, and each
RMSNorm's backward multiplies a zero row's gradient by ``eps**-0.5``: from
about 14 layers on the gradient overflows and the gradient norm is NaN,
in both packages (ROADMAP.md, queue 3).  The full config trains on seeded
patches (``model.vision_embeds``) in code, as ``chip_smoke.py`` phase 23
does.  The policy is the reference launcher's mesh-free
one: a MoE model runs the dense oracle ``moe_ref`` (stacked EP shards
are ``Policy(ep_shards=N)`` in code, as ``chip_smoke.py`` phase 19 trains
Scout).

At each step boundary of a MoE model the ``PlacementController`` (over
``Policy.ep_shards or 1`` shards, the port's stand-in for the reference's
``max(pol.tp, 1)``) observes the step's expert counts; when it re-places
the experts, every MoE layer's ``wi`` and ``wo`` and both of their Adam
moments are permuted in place, and the next step runs with the new
``inv_place``.  (The reference's launcher permutes the weights alone: its
moments stay at the old slots, ROADMAP.md queue 3.)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.generators import lm_token_stream
from repro_torch.models import model
from repro_torch.models.modules import Policy
from repro_torch.moe.kip_placement import PlacementController, apply_placement_in_place
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import OptConfig, init_opt, leaves
from repro_torch.train.train_step import make_train_step, moe_state


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dr-placement", action="store_true", default=True,
                    help="KIP expert placement at step boundaries (MoE archs)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    pol = Policy(attn_q_chunk=min(1024, args.seq), attn_kv_chunk=min(2048, args.seq))
    opt_cfg = OptConfig(lr=args.lr)

    params = model.init_params(cfg, 0, pol, device=dev)
    opt = init_opt(params, opt_cfg)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M layers={cfg.num_layers} device={dev}")

    step_fn = make_train_step(cfg, pol, opt_cfg)
    placement = None
    inv_place = None
    if cfg.moe is not None and args.dr_placement:
        placement = PlacementController(cfg.moe.num_experts, pol.ep_shards or 1)
        inv_place = torch.as_tensor(placement.placement.inv_place, device=dev)

    start = 0
    if args.ckpt_dir:
        got = checkpoint.restore(args.ckpt_dir, {"params": params, "opt": opt})
        if got:
            start, tree = got
            with torch.no_grad():
                for dst, src in zip(leaves({"params": params, "opt": opt}), leaves(tree)):
                    dst.copy_(src)
            print(f"resumed from step {start}")

    stream = lm_token_stream(args.steps + 1, args.batch, args.seq + 1, cfg.vocab_size)
    t0 = time.time()
    for step, toks in enumerate(stream, start=start):
        if step >= args.steps:
            break
        toks = torch.as_tensor(toks, device=dev)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": torch.ones((args.batch, args.seq), dtype=torch.float32, device=dev),
        }
        if cfg.encdec:  # the stubbed audio frontend's frames, as the reference's launcher
            batch["enc_embeds"] = torch.zeros((args.batch, cfg.enc_len, cfg.d_model),
                                              dtype=torch.float32, device=dev)
        if cfg.vision_tokens:  # the stubbed vision frontend's patches, as the reference's
            batch["vision_embeds"] = torch.zeros((args.batch, cfg.vision_tokens, cfg.d_model),
                                                 dtype=torch.float32, device=dev)
        params, opt, metrics = step_fn(params, opt, batch, inv_place)

        # DR safe point: expert-placement update between steps
        if placement is not None and "expert_counts" in metrics:
            placement.observe(metrics["expert_counts"].cpu().numpy())
            changed, _, perm = placement.maybe_update()
            if changed:
                # state migration: permute expert weights + both moments
                apply_placement_in_place(moe_state(params, opt), perm)
                inv_place = torch.as_tensor(placement.placement.inv_place, device=dev)
                print(f"  step {step}: KIP moved "
                      f"{int((perm != np.arange(len(perm))).sum())} experts")

        if step % args.log_every == 0:
            sl = placement.shard_loads(placement.loads_ewma) if placement else None
            extra = (f" expert_imb={sl.max()/max(sl.mean(),1e-9):.2f}" if sl is not None
                     and sl.sum() else "")
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f}{extra}")
        if args.ckpt_dir and step > 0 and step % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step, {"params": params, "opt": opt})
    dt = time.time() - t0
    print(f"done: {args.steps - start} steps in {dt:.1f}s "
          f"({(args.steps - start) * args.batch * args.seq / max(dt, 1e-9):.0f} tok/s)")
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, {"params": params, "opt": opt})


if __name__ == "__main__":
    main()
