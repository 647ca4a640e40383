"""Serving launcher: batched requests through the engine + DR session routing
(a port of ``repro.launch.serve``; same arguments plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 12 --max-new 6 --slots 3 --replicas 3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch llama4-scout-17b-a16e

``--device`` defaults to ``cuda`` and raises without a card.  A MoE
model's layers run the dense oracle ``moe_ref``, as on the reference
launcher's mesh-free policy.  As in the reference, ``--smoke`` is a
``store_true`` flag whose default is already True, so this CLI always
serves the ``reduce_for_smoke`` model;
``chip_smoke.py`` drives ``ServeEngine`` and ``DRScheduler`` directly at
full width.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.compat import resolve_device
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import model
from repro_torch.models.modules import Policy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import DRScheduler


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    pol = Policy(attn_q_chunk=64, attn_kv_chunk=64)
    params = model.init_params(cfg, 0, pol, device=dev)

    rng = np.random.default_rng(0)
    # heavy-tailed session keys: a hot tenant drives 30% of traffic
    sessions = np.where(rng.random(args.requests) < 0.3, 7,
                        rng.integers(0, 1000, args.requests))
    sched = DRScheduler(args.replicas)
    engines = [ServeEngine(cfg, params, pol, slots=args.slots, max_len=64, device=dev)
               for _ in range(args.replicas)]
    queues: list[list[Request]] = [[] for _ in range(args.replicas)]
    for i in range(args.requests):
        req = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                      max_new_tokens=args.max_new, session_key=int(sessions[i]))
        r = sched.route(req.session_key, cost_tokens=args.max_new)
        queues[r].append(req)

    t0 = time.time()
    for r, (eng, q) in enumerate(zip(engines, queues)):
        eng.run(q, max_ticks=200)
        print(f"replica {r}: {len(q)} requests, {eng.tokens_out} tokens, "
              f"{eng.steps} ticks")
    print(f"routed={sched.routed} imbalance={sched.imbalance():.2f} "
          f"total {time.time()-t0:.1f}s")
    info = sched.checkpoint(sessions)
    print(f"DR checkpoint: {info}")


if __name__ == "__main__":
    main()
