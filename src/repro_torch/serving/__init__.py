"""Serving engine of the port: the request loop (``engine``), its latency
records (``latency``) and handles (``prefetch``).  The LM decode loop
(``launch/serve.py``) runs through it."""
from .engine import Request, ServingEngine  # noqa: F401
from .latency import LatencyRecorder, LatencyWindow, RequestRecord  # noqa: F401
from .prefetch import OverlapMeter, ReadyHandle  # noqa: F401

__all__ = ["LatencyRecorder", "LatencyWindow", "OverlapMeter", "ReadyHandle",
           "Request", "RequestRecord", "ServingEngine"]
