"""``repro_torch.serving``: the serving engine of the port — the PS request
loop with async pull/compute overlap, admission control and the closed SLO
loop (``engine``), its latency and bandwidth models (``latency``), request
routing (``router``), windowed telemetry (``telemetry``) and handles
(``prefetch``).  The LM decode loop (``launch/serve.py``) runs through the
same engine."""
from .engine import (  # noqa: F401
    PSRequestSource,
    Request,
    RequestMix,
    ServingConfig,
    ServingEngine,
    ZipfWorkload,
)
from .latency import (  # noqa: F401
    BandwidthModel,
    LatencyRecorder,
    LatencyWindow,
    LinkClock,
    RequestRecord,
)
from .prefetch import OverlapMeter, ReadyHandle  # noqa: F401
from .router import Router  # noqa: F401
from .telemetry import TelemetryBus, TelemetrySnapshot  # noqa: F401

__all__ = [
    "BandwidthModel",
    "LatencyRecorder",
    "LatencyWindow",
    "LinkClock",
    "OverlapMeter",
    "PSRequestSource",
    "ReadyHandle",
    "Request",
    "RequestMix",
    "RequestRecord",
    "Router",
    "ServingConfig",
    "ServingEngine",
    "TelemetryBus",
    "TelemetrySnapshot",
    "ZipfWorkload",
]
