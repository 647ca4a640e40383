"""The decision log: every control-plane decision, taken or declined.

One log per policy host.  ``BatchMetrics`` reads the latest record's reason,
and the benchmarks read the taken/declined counters into their CSV rows, so
a run's decision history (including *why* nothing happened) is first-class
output rather than something to reconstruct from prints.  ``to_arrays`` /
``from_arrays`` round-trip the log through flat (npz-friendly) arrays so
any host's snapshot can carry its history.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.control.actions import Action

__all__ = ["Decision", "DecisionLog"]


@dataclasses.dataclass(frozen=True)
class Decision:
    tick: int              # the host's safe-point counter when decided
    consumer: str          # "stream" | "serve" | "moe"
    kind: str              # "noop" | "repartition" | "resize" | "replace"
    taken: bool
    reason: str
    imbalance: float = 0.0
    detail: dict = dataclasses.field(default_factory=dict)


class DecisionLog:
    """Bounded record list + unbounded counters.

    ``records`` keeps the most recent ``max_records`` decisions (a
    long-running job makes one decision per safe point forever — the log
    must not grow with the stream); the taken/declined counters are
    cumulative so ``counts()`` stays exact after trimming.
    """

    def __init__(self, consumer: str = "", max_records: int = 10_000):
        self.consumer = consumer
        self.max_records = max_records
        self.records: list[Decision] = []
        self._taken = 0
        self._declined = 0

    def record(
        self,
        action: Action,
        *,
        tick: int,
        imbalance: float = 0.0,
        detail: dict | None = None,
    ) -> Decision:
        d = Decision(
            tick=int(tick),
            consumer=self.consumer,
            kind=action.kind,
            taken=action.taken,
            reason=action.reason,
            imbalance=float(imbalance),
            detail=detail or {},
        )
        self.records.append(d)
        if len(self.records) > self.max_records:
            del self.records[: -self.max_records]
        if d.taken:
            self._taken += 1
        else:
            self._declined += 1
        return d

    def counts(self) -> tuple[int, int]:
        """(taken, declined) decision counts over the whole run."""
        return self._taken, self._declined

    def taken(self) -> list[Decision]:
        return [d for d in self.records if d.taken]

    def declined(self) -> list[Decision]:
        return [d for d in self.records if not d.taken]

    def tail(self, n: int = 10) -> list[Decision]:
        return self.records[-n:]

    def __len__(self) -> int:
        return len(self.records)

    # -- persistence (flat arrays, npz-friendly) ---------------------------
    def to_arrays(self, prefix: str = "decisions_") -> dict:
        """Columnar snapshot of the log: records as parallel arrays (details
        JSON-encoded) plus the cumulative counters."""
        taken, declined = self.counts()
        return {
            f"{prefix}consumer": np.str_(self.consumer),
            f"{prefix}tick": np.array([d.tick for d in self.records], np.int64),
            f"{prefix}kind": np.array([d.kind for d in self.records], np.str_),
            f"{prefix}taken": np.array([d.taken for d in self.records], bool),
            f"{prefix}reason": np.array([d.reason for d in self.records], np.str_),
            f"{prefix}imbalance": np.array(
                [d.imbalance for d in self.records], np.float64
            ),
            f"{prefix}detail": np.array(
                [json.dumps(d.detail) for d in self.records], np.str_
            ),
            f"{prefix}counts": np.array([taken, declined], np.int64),
        }

    @classmethod
    def from_arrays(cls, snap: dict, prefix: str = "decisions_") -> "DecisionLog":
        """Rebuild a log from :meth:`to_arrays` output (tolerates snapshots
        that predate persistence — those restore empty)."""
        log = cls(str(snap.get(f"{prefix}consumer", "")))
        if f"{prefix}tick" not in snap:
            return log
        for tick, kind, taken, reason, imb, detail in zip(
            np.asarray(snap[f"{prefix}tick"]),
            np.asarray(snap[f"{prefix}kind"]),
            np.asarray(snap[f"{prefix}taken"]),
            np.asarray(snap[f"{prefix}reason"]),
            np.asarray(snap[f"{prefix}imbalance"]),
            np.asarray(snap[f"{prefix}detail"]),
        ):
            log.records.append(Decision(
                tick=int(tick), consumer=log.consumer, kind=str(kind),
                taken=bool(taken), reason=str(reason),
                imbalance=float(imb), detail=json.loads(str(detail)),
            ))
        log._taken, log._declined = (int(x) for x in np.asarray(snap[f"{prefix}counts"]))
        return log
