"""``repro_torch.serving``: the serving engine of the port — the PS request
loop with async pull/compute overlap, admission control and the closed SLO
loop (``engine``), its latency and bandwidth models (``latency``), request
routing (``router``), windowed telemetry (``telemetry``), handles and
staged batch prefetching (``prefetch``).  The LM decode loop
(``launch/serve.py``) runs through the same engine."""
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
from .prefetch import (  # noqa: F401
    OverlapMeter,
    ReadyHandle,
    prefetch_batches,
    stage_batch,
)
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
    "prefetch_batches",
    "stage_batch",
]
