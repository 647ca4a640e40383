"""The system-aware control plane: telemetry -> signals -> policies ->
typed actions, recorded in a decision log (a port of ``repro.control``)."""
from repro_torch.control.actions import (
    Action,
    Evict,
    NoOp,
    Quarantine,
    Recover,
    Repartition,
    Replace,
    Resize,
    Split,
    SwitchBackend,
    Unsplit,
)
from repro_torch.control.health import HealthPolicy, LaneHealth
from repro_torch.control.log import Decision, DecisionLog
from repro_torch.control.policy import (
    BackendPolicy,
    CooldownGuard,
    PlacementPolicy,
    RepartitionPolicy,
    ResizePolicy,
    SplitPolicy,
)
from repro_torch.control.signals import Signals, Telemetry

__all__ = [
    "Action",
    "BackendPolicy",
    "CooldownGuard",
    "Decision",
    "DecisionLog",
    "Evict",
    "HealthPolicy",
    "LaneHealth",
    "NoOp",
    "PlacementPolicy",
    "Quarantine",
    "Recover",
    "Repartition",
    "RepartitionPolicy",
    "Replace",
    "Resize",
    "ResizePolicy",
    "Signals",
    "Split",
    "SplitPolicy",
    "SwitchBackend",
    "Telemetry",
    "Unsplit",
]
