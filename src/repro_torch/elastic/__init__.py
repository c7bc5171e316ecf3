"""repro_torch.elastic: fault-tolerant elastic Parsa serving, on the card.

Makes the machine count ``k`` a runtime variable over a live streaming
partition: machines join (``grow_k``), leave (``shrink_k``), die
(``repair`` — warm §4.4 recovery from surviving packed sets), and
straggle (EWMA-biased block routing) mid-stream, with every move metered
in ``TrafficCounters.migration_bytes`` and gated by a pluggable
``ElasticPolicy``.  ``ChaosSchedule`` injects deterministic kill/add/
straggle events for robustness testing (``chip_smoke.py`` phase
``elastic``).  ``SLOAutoscaler`` is the closed-loop policy: it owns the
session's grow/shrink consent and decides from windowed serving telemetry
(``repro_torch.serving``; ``chip_smoke.py`` phase ``serving``).
"""
from .autoscaler import (  # noqa: F401
    AutoscaleDecision,
    SLOAutoscaler,
    SLOConfig,
)
from .chaos import ChaosEvent, ChaosSchedule  # noqa: F401
from .policy import ElasticPolicy, FleetState, ThresholdPolicy  # noqa: F401
from .session import ElasticConfig, ElasticOp, ElasticSession  # noqa: F401

__all__ = [
    "AutoscaleDecision",
    "ChaosEvent",
    "ChaosSchedule",
    "ElasticConfig",
    "ElasticOp",
    "ElasticPolicy",
    "ElasticSession",
    "FleetState",
    "SLOAutoscaler",
    "SLOConfig",
    "ThresholdPolicy",
]
