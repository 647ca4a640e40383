"""Deterministic fault injection for the exchange plane.

A :class:`FaultPlan` is a seeded, serializable schedule of per-lane faults:
added latency (stragglers), transient exchange failures with bounded retry
and backoff, and hard worker loss.  :class:`FaultyBackend` is the seam that
installs it: a delegating exchange backend, so every transport (dense,
ragged, local) runs under faults without touching a consumer call site
(``resolve_backend`` passes instances through, so the wrapper flows
wherever a backend name would).

**Where faults fire.**  The wrapped verbs (``bucketize``, ``a2a_start``,
...) enqueue device work; raising or sleeping inside them would interleave
the fault with the stream.  Faults therefore fire at the *host* boundary:
the step wrappers in :mod:`repro_torch.core.shuffle` call
:func:`maybe_inject` once per issued exchange start, and
:meth:`FaultyBackend.inject` consults the plan for that tick.  The verbs
forward to the inner backend verbatim, so a plan that never fires leaves
the serial, depth-1 and depth-2 drivers bit-identical to no seam at all.

**Determinism.**  Ticks count host-issued exchange starts (one per shuffle
or migrate start; the serial fused step counts as its start, and so does a
depth-2 lookahead start that a later action discards).  For a fixed config
and input stream the start sequence is a function of the decision
trajectory, so the same plan reproduces the same faults at the same points.

**Lane identity.**  Plan lanes are *original* lane ids (the worker rows at
job construction).  Quarantine, evict and recover renumber the live lanes;
the driver keeps the current -> original map and the wrapper keeps an
``inactive`` set, so faults scheduled for a removed lane never fire while
it is out of the collective (and resume if it is recovered).

A port of ``repro.exchange.faults``: the same plans (``generate`` draws
from numpy's ``default_rng`` in the same order), the same ticks, reports
and counters, so a plan written by either package drives the other.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.exchange.backends import resolve_backend

__all__ = [
    "FaultPlan",
    "FaultyBackend",
    "LaneFault",
    "TransientExchangeError",
    "WorkerLostError",
    "maybe_inject",
]

FAULT_KINDS = ("latency", "transient", "kill")


class TransientExchangeError(RuntimeError):
    """One failed exchange attempt on a lane — retryable."""

    def __init__(self, lane: int, tick: int, attempt: int):
        super().__init__(f"transient exchange failure on lane {lane} "
                         f"(tick {tick}, attempt {attempt})")
        self.lane = int(lane)
        self.tick = int(tick)
        self.attempt = int(attempt)


class WorkerLostError(RuntimeError):
    """A lane is gone for good: hard loss, or transient failures past the
    retry budget.  The driver's recovery protocol catches this."""

    def __init__(self, lane: int, tick: int, cause: str = "killed"):
        super().__init__(f"worker lost on lane {lane} (tick {tick}: {cause})")
        self.lane = int(lane)
        self.tick = int(tick)
        self.cause = cause


@dataclasses.dataclass(frozen=True)
class LaneFault:
    """One scheduled fault: at exchange ``tick`` on (original) ``lane``.

    * ``latency`` — sleep ``delay_s`` per exchange for ``span`` consecutive
      ticks (a straggling lane).
    * ``transient`` — the exchange fails ``failures`` times before
      succeeding; each failed attempt costs one retry with exponential
      backoff.  ``failures`` beyond the plan's ``max_retries`` escalates to
      :class:`WorkerLostError`.
    * ``kill`` — hard worker loss; the lane fails every exchange until the
      driver evicts it (:meth:`FaultyBackend.note_evicted`).
    """

    tick: int
    lane: int
    kind: str
    delay_s: float = 0.0
    failures: int = 1
    span: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.tick < 0 or self.lane < 0:
            raise ValueError(f"fault tick/lane must be >= 0, got "
                             f"({self.tick}, {self.lane})")
        if self.delay_s < 0.0 or self.failures < 1 or self.span < 1:
            raise ValueError(f"degenerate fault parameters: {self!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, serializable schedule of :class:`LaneFault` records.

    ``max_retries`` bounds the per-fault retry loop (a transient fault with
    more failures than retries escalates to worker loss); ``backoff_s`` is
    the base of the exponential retry backoff (0.0: retry at once).  An
    empty plan never fires.
    """

    faults: tuple = ()
    max_retries: int = 2
    backoff_s: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0 or self.backoff_s < 0.0:
            raise ValueError("max_retries and backoff_s must be >= 0, got "
                             f"({self.max_retries}, {self.backoff_s})")
        object.__setattr__(self, "faults", tuple(self.faults))

    @property
    def never_fires(self) -> bool:
        return not self.faults

    @classmethod
    def generate(cls, seed: int, *, num_lanes: int, ticks: int,
                 latency_rate: float = 0.05, transient_rate: float = 0.02,
                 delay_s: float = 0.005, kill_at: tuple | None = None,
                 max_retries: int = 2, backoff_s: float = 0.0) -> "FaultPlan":
        """A schedule drawn from one seed: per (tick, lane) cell a latency
        fault with ``latency_rate`` and a transient fault with
        ``transient_rate``; ``kill_at`` optionally adds one hard loss as
        ``(tick, lane)``.  The same seed always gives the same plan."""
        rng = np.random.default_rng(seed)
        faults: list[LaneFault] = []
        for t in range(ticks):
            for lane in range(num_lanes):
                u = rng.random()
                if u < latency_rate:
                    faults.append(LaneFault(t, lane, "latency", delay_s=delay_s))
                elif u < latency_rate + transient_rate:
                    faults.append(LaneFault(
                        t, lane, "transient",
                        failures=int(rng.integers(1, max_retries + 1))))
        if kill_at is not None:
            kt, kl = kill_at
            faults.append(LaneFault(int(kt), int(kl), "kill"))
        return cls(faults=tuple(faults), max_retries=max_retries,
                   backoff_s=backoff_s, seed=seed)

    # -- serialization (plain JSON-ready dicts) ---------------------------
    def to_dict(self) -> dict:
        return {
            "max_retries": self.max_retries,
            "backoff_s": self.backoff_s,
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.faults],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            faults=tuple(LaneFault(**f) for f in d.get("faults", ())),
            max_retries=int(d.get("max_retries", 2)),
            backoff_s=float(d.get("backoff_s", 0.0)),
            seed=int(d.get("seed", 0)),
        )


class FaultyBackend:
    """Delegating exchange backend that injects a :class:`FaultPlan`.

    Every verb of the backend protocol forwards to ``inner`` verbatim (the
    device work is untouched); the host-side :meth:`inject` hook, called
    once per issued exchange start by the step wrappers through
    :func:`maybe_inject`, is where faults fire.

    ``drain_report`` hands the window's per-lane fault evidence (straggle
    seconds, retry counts) to the driver, which feeds it into
    :class:`~repro_torch.control.signals.Telemetry`: the lane-health
    layer's input.  ``inner`` is mutable on purpose: a backend switch or a
    restore re-points the wrapped transport while the seam stays armed.
    """

    def __init__(self, inner, plan: FaultPlan | None = None):
        self.inner = resolve_backend(inner)
        self.plan = plan or FaultPlan()
        self._tick = 0
        self._dead: dict[int, int] = {}      # lane -> tick it died
        self._inactive: set[int] = set()     # evicted / quarantined lanes
        self._report: dict[int, dict] = {}   # lane -> window fault evidence
        # lifetime counters
        self.injected_sleep_s = 0.0
        self.transients = 0
        self.retries = 0
        self.kills = 0
        # point faults by tick; latency spans as (start, end, fault)
        self._at: dict[int, list[LaneFault]] = {}
        self._spans: list[tuple[int, int, LaneFault]] = []
        for f in self.plan.faults:
            if f.kind == "latency":
                self._spans.append((f.tick, f.tick + f.span, f))
            else:
                self._at.setdefault(f.tick, []).append(f)

    # -- identity forwards to the wrapped transport -----------------------
    @property
    def name(self) -> str:
        return self.inner.name

    def __getattr__(self, attr):
        # anything beyond the protocol's verbs (attributes of one transport)
        # resolves on the inner transport
        return getattr(self.inner, attr)

    # -- the protocol's verbs: verbatim delegation ------------------------
    def bucketize(self, spec, lane, valid, payloads, slot=None, counts=None,
                  buffers=None):
        return self.inner.bucketize(spec, lane, valid, payloads, slot=slot,
                                    counts=counts, buffers=buffers)

    def a2a_start(self, spec, buffers):
        return self.inner.a2a_start(spec, buffers)

    def a2a_finish(self, spec, buffers):
        return self.inner.a2a_finish(spec, buffers)

    def all_to_all(self, spec, buffers):
        return self.inner.all_to_all(spec, buffers)

    def backhaul(self, spec, buffers, *, send_counts=None, recv_counts=None):
        return self.inner.backhaul(spec, buffers, send_counts=send_counts,
                                   recv_counts=recv_counts)

    def cost(self, spec, plan_rows, slack: float = 1.25) -> float:
        return self.inner.cost(spec, plan_rows, slack=slack)

    # -- lane lifecycle (driver bookkeeping) ------------------------------
    def note_evicted(self, lane: int) -> None:
        """The driver removed ``lane`` for good: its faults never fire again
        (a killed lane's standing failure is silenced here)."""
        self._inactive.add(int(lane))
        self._dead.pop(int(lane), None)

    def note_restarted(self, lane: int) -> None:
        """The driver restarted ``lane`` in place (single-worker recovery):
        the standing death clears but the lane stays *active*, so a
        replacement worker can fail again on later scheduled faults."""
        self._dead.pop(int(lane), None)

    def note_quarantined(self, lane: int) -> None:
        """``lane`` left the collective for a while: its faults are
        suspended until :meth:`note_recovered` re-admits it."""
        self._inactive.add(int(lane))

    def note_recovered(self, lane: int) -> None:
        self._inactive.discard(int(lane))

    def drain_report(self) -> dict:
        """Per-lane fault evidence since the last drain:
        ``{lane: {"straggle_s", "retries", "failures"}}``."""
        report, self._report = self._report, {}
        return report

    def _lane_report(self, lane: int) -> dict:
        return self._report.setdefault(
            int(lane), {"straggle_s": 0.0, "retries": 0, "failures": 0})

    # -- the host-side seam ----------------------------------------------
    def inject(self, phase: str = "exchange") -> None:
        """Consult the plan for this exchange tick; sleep, retry, or raise.

        Called by the step wrappers just before each exchange start is
        issued.  Raising :class:`WorkerLostError` here, before the device
        work is enqueued, models the transport finding a dead peer at
        connection time; the driver's recovery protocol owns the rest.
        """
        t, self._tick = self._tick, self._tick + 1
        if self.plan.never_fires and not self._dead:
            return
        # a killed, not yet evicted lane fails every later exchange: loss is
        # a standing condition, not a one-tick event
        for lane in sorted(self._dead):
            if lane not in self._inactive:
                raise WorkerLostError(lane, t, cause="lane is down")
        for start, end, f in self._spans:
            if start <= t < end and f.lane not in self._inactive:
                if f.delay_s > 0.0:
                    time.sleep(f.delay_s)
                self.injected_sleep_s += f.delay_s
                self._lane_report(f.lane)["straggle_s"] += f.delay_s
        for f in self._at.get(t, ()):
            if f.lane in self._inactive:
                continue
            if f.kind == "kill":
                self.kills += 1
                self._dead[f.lane] = t
                raise WorkerLostError(f.lane, t)
            # transient: a bounded retry loop; each failed attempt raises
            # inside, backs off exponentially and retries, and the attempt
            # past the retry budget escalates to worker loss
            self.transients += 1
            rec = self._lane_report(f.lane)
            rec["failures"] += 1
            for attempt in range(f.failures + 1):
                try:
                    if attempt < f.failures:
                        raise TransientExchangeError(f.lane, t, attempt)
                    break  # this attempt succeeded
                except TransientExchangeError:
                    if attempt >= self.plan.max_retries:
                        self._dead[f.lane] = t
                        raise WorkerLostError(
                            f.lane, t,
                            cause=f"{attempt + 1} transient failures exceed "
                                  f"retry budget {self.plan.max_retries}",
                        ) from None
                    if self.plan.backoff_s > 0.0:
                        time.sleep(self.plan.backoff_s * (2 ** attempt))
                    self.retries += 1
                    rec["retries"] += 1


def maybe_inject(backend, phase: str = "exchange") -> None:
    """Fire the backend's host-side fault hook if it has one (a plain
    transport costs one attribute probe)."""
    inject = getattr(backend, "inject", None)
    if inject is not None:
        inject(phase)
