"""DR-based request routing across serving replicas (a port of
``repro.serve.scheduler``).

Serving-side instance of the paper's mapping: requests carry a *session
key*; replicas are partitions; the per-session KV cache is operator
state.  Session keys are heavy-tailed, so uniform routing makes some
replicas stragglers.  The scheduler runs the same DRM loop: a counter
sketch over observed session keys, KIPUPDATE at decision points, and
session (cache) migration costed against the expected balance gain.

Replicas are modelled objects (queue depths); ``ServeEngine`` is the
per-replica execution unit.  ``checkpoint`` feeds the window's telemetry
(queue depths, routed records) into ``DRMaster.evaluate`` and executes the
action — replica scale-out or scale-in (``Resize``) or session re-routing
(``Repartition``) — always returning the reference's schema.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compat import overlap_enabled
from repro_torch.control import Repartition, Resize, SwitchBackend, Telemetry
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.hashing import DEFAULT_NUM_HOSTS
from repro_torch.core.partitioner import heavy_capacity_for, uniform_partitioner
from repro_torch.exchange import ExchangeStats

__all__ = ["ReplicaState", "DRScheduler"]


@dataclasses.dataclass
class ReplicaState:
    rid: int
    queued_tokens: float = 0.0      # outstanding work
    sessions: set = dataclasses.field(default_factory=set)


class DRScheduler:
    def __init__(self, num_replicas: int, *, dr: DRConfig | None = None, seed: int = 0,
                 migration_token_cost: float = 64.0,
                 exchange_backend: str | None = None,
                 topology=None):
        self.replicas = [ReplicaState(i) for i in range(num_replicas)]
        cfg = dr or DRConfig(lam=4.0, imbalance_trigger=1.25)
        # the same tile-padded sizing rule the kernels' heavy tables use
        heavy_cap = heavy_capacity_for(cfg.lam, num_replicas)
        init = uniform_partitioner(num_replicas, DEFAULT_NUM_HOSTS, seed,
                                   heavy_capacity=heavy_cap)
        # the transport KV-cache migrations would ride; its sizing rule
        # prices session-move plans inside the policy stack
        self.drm = DRMaster(init, cfg, consumer="serve",
                            exchange_backend=exchange_backend or "dense",
                            exchange_topology=topology)
        self.telemetry = Telemetry("serve")
        self.migration_token_cost = migration_token_cost
        self.migrations = 0
        self.routed = 0

    # -- hot path ---------------------------------------------------------
    def route(self, session_key: int, cost_tokens: float) -> int:
        """Assign a request to a replica; account its load."""
        r = int(self.drm.partitioner.lookup_np(np.asarray([session_key], np.int32))[0])
        rep = self.replicas[r]
        rep.queued_tokens += cost_tokens
        rep.sessions.add(session_key)
        self.routed += 1
        return r

    def drain(self, tokens_per_replica: float) -> None:
        """Simulate service: each replica completes up to N tokens."""
        for rep in self.replicas:
            rep.queued_tokens = max(0.0, rep.queued_tokens - tokens_per_replica)

    # -- safe point: feed signals, execute the stack's action --------------
    def checkpoint(self, window_keys: np.ndarray) -> dict:
        """One decision point: telemetry in, typed action out, executed.

        Always returns the same schema — ``repartitioned``, ``resized``,
        ``num_replicas``, ``imbalance``, ``moved_sessions``, ``reason``,
        ``backend``, ``overlapped`` — whatever the decision was.
        """
        window_keys = np.asarray(window_keys, np.int64)
        keys, counts = np.unique(window_keys, return_counts=True)
        self.drm.observe(keys.reshape(1, -1), counts.reshape(1, -1))
        loads = np.array([r.queued_tokens for r in self.replicas])
        self.telemetry.record_batch(float(len(window_keys)))
        self.telemetry.record_queues(loads)
        # replicas are elastic partitions, not a fixed physical worker set:
        # num_workers=1 costs session moves replica to replica
        signals = self.telemetry.snapshot(loads=loads + 1e-9, num_workers=1)
        action = self.drm.evaluate(signals)
        moved_sessions = 0
        if isinstance(action, Resize):
            moved_sessions = self.resize(action.target)
        elif isinstance(action, Repartition):
            # migrate each moved session's KV cache
            moved_sessions = self._reroute_sessions(self.drm.partitioner)
            self.migrations += moved_sessions
        elif isinstance(action, SwitchBackend):
            pass  # the DRM installed the new transport in evaluate
        overlapped = self.overlap_active()
        if moved_sessions:
            # session moves are this consumer's exchange traffic, modelled
            # as 1 row per session, unpadded; under overlap their wall
            # counts as hidden, serially nothing is booked as hidden
            self.telemetry.record_exchange(ExchangeStats(
                rows=moved_sessions,
                padded_rows=moved_sessions,
                occupied_rows=moved_sessions,
                backend=self.drm.exchange_backend.name,
                count_wall_s=0.0 if overlapped else None,
            ))
        return {
            # a backend switch moves no sessions: taken, but not a repartition
            "repartitioned": action.taken and action.moves_state,
            "resized": isinstance(action, Resize),
            "num_replicas": len(self.replicas),
            "imbalance": float(signals.imbalance),
            "moved_sessions": moved_sessions,
            "reason": action.reason,
            "backend": self.drm.exchange_backend.name,
            "overlapped": overlapped,
        }

    def overlap_active(self) -> bool:
        """Whether exchange traffic is treated as overlapped:
        ``REPRO_DISABLE_OVERLAP=1`` wins over ``DRConfig.overlap_exchange``."""
        return self.drm.config.overlap_exchange and overlap_enabled()

    def imbalance(self) -> float:
        loads = np.array([r.queued_tokens for r in self.replicas])
        return float(loads.max() / max(loads.mean(), 1e-9))

    # -- elastic scale-out / scale-in -------------------------------------
    def resize(self, num_replicas: int) -> int:
        """Grow or shrink the replica set, the streaming resize one level up:
        the session keyspace is re-planned across sizes
        (``DRMaster.replan_resize``) and the sessions whose replica changed
        move their KV cache.  Returns the number of sessions moved.  With
        ``DRConfig(elastic=True)``, ``checkpoint`` calls it on sustained
        queue imbalance."""
        n = int(num_replicas)
        if n < 1:
            raise ValueError(f"need at least one replica, got {n}")
        if n == len(self.replicas):
            return 0
        new = self.drm.replan_resize(n)
        if n > len(self.replicas):
            self.replicas += [ReplicaState(i) for i in range(len(self.replicas), n)]
        moved = self._reroute_sessions(new)
        if n < len(self.replicas):
            # scale-in: the dying replicas handed their sessions off; their
            # queued work drains onto the replica they fold into
            for rep in self.replicas[n:]:
                self.replicas[rep.rid % n].queued_tokens += rep.queued_tokens
            self.replicas = self.replicas[:n]
        self.migrations += moved
        return moved

    def _reroute_sessions(self, new) -> int:
        """Move sessions (and their KV-cache cost) to where ``new`` maps them;
        a dying replica (``rid >= new.num_partitions``) never keeps one, so
        a scale-in drains it completely."""
        moved = 0
        for rep in self.replicas:
            stay = set()
            for s in rep.sessions:
                dst = int(new.lookup_np(np.asarray([s], np.int32))[0])
                if dst != rep.rid:
                    self.replicas[dst].sessions.add(s)
                    self.replicas[dst].queued_tokens += self.migration_token_cost
                    moved += 1
                else:
                    stay.add(s)
            rep.sessions = stay
        return moved
