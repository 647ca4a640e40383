"""Lane health: only the disabled branch of the failure-domain policy is
ported.  With ``DRConfig.health_enabled`` off (the default) the policy
returns its ``NoOp`` reason first in ``DRMaster.evaluate``, exactly as
``repro.control.health.HealthPolicy`` does; ``LaneHealth`` and the enabled
policy are not ported yet."""
from __future__ import annotations

from repro_torch.control.actions import Action, NoOp
from repro_torch.control.signals import Signals

__all__ = ["HealthPolicy"]


class HealthPolicy:
    """Failure-domain policy (disabled branch only)."""

    def evaluate(self, host, signals: Signals) -> Action:
        imb = signals.imbalance
        if not getattr(host.config, "health_enabled", False):
            return NoOp("health-disabled", imb, imb)
        raise NotImplementedError(
            "the HealthPolicy (lane health) is not ported yet "
            "(ROADMAP.md, queue 1 item 7)")
