"""Exchange plane — routed all-to-all for the shuffle and state migration,
split spec + backend, for workers stacked on one device or one a process.
See :mod:`repro_torch.exchange.plane` (binding),
:mod:`repro_torch.exchange.spec` (shapes), :mod:`repro_torch.exchange.backends`
(transports), :mod:`repro_torch.exchange.dist` (the process group) and
:mod:`repro_torch.exchange.faults` (the fault seam)."""
from repro_torch.exchange.backends import (
    DenseBackend,
    ExchangeBackend,
    HierarchicalBackend,
    LocalBackend,
    RaggedBackend,
    resolve_backend,
)
from repro_torch.exchange.dist import WorkerGroup
from repro_torch.exchange.faults import (
    FaultPlan,
    FaultyBackend,
    LaneFault,
    TransientExchangeError,
    WorkerLostError,
    maybe_inject,
)
from repro_torch.exchange.plane import (
    Exchange,
    ExchangeResult,
    ExchangeSpec,
    ExchangeStats,
    ExchangeTopology,
    Payload,
    PendingExchange,
    SendInfo,
    make_exchange,
    route_bucketize,
    route_dispatch,
    take_from,
)

__all__ = [
    "DenseBackend",
    "Exchange",
    "ExchangeBackend",
    "ExchangeResult",
    "ExchangeSpec",
    "ExchangeStats",
    "ExchangeTopology",
    "FaultPlan",
    "FaultyBackend",
    "HierarchicalBackend",
    "LaneFault",
    "LocalBackend",
    "Payload",
    "PendingExchange",
    "RaggedBackend",
    "SendInfo",
    "TransientExchangeError",
    "WorkerGroup",
    "WorkerLostError",
    "make_exchange",
    "maybe_inject",
    "resolve_backend",
    "route_bucketize",
    "route_dispatch",
    "take_from",
]
