"""repro_torch.obs — virtual-clock tracing, flight recorder, metrics
export.

One ``Observability`` object bundles the two sinks and threads through
the pipeline as the single ``obs=`` hook (``StreamSession(obs=...)``).
Off by default: every instrumented call site guards on ``obs is None``
(or the empty installed-tracer registry), so the disabled path costs one
attribute check.  Pure Python, copied from ``repro.obs``: the exports of
the two packages compare byte for byte.
"""
from __future__ import annotations

import pathlib

from .trace import (Span, SpanHandle, Tracer, annotate_last_instant,
                    dispatch_instant, trace_instant)
from .recorder import (CAUSE_KINDS, Explanation, FlightRecorder, ObsEvent)
from .export import (chrome_trace_json, prometheus_text,
                     save_chrome_trace, to_chrome_trace)

__all__ = [
    "Observability",
    "Span", "SpanHandle", "Tracer", "trace_instant", "dispatch_instant",
    "annotate_last_instant",
    "ObsEvent", "Explanation", "FlightRecorder", "CAUSE_KINDS",
    "to_chrome_trace", "chrome_trace_json", "save_chrome_trace",
    "prometheus_text",
]


class Observability:
    """Tracer + flight recorder under one handle."""

    def __init__(self, tracer: Tracer | None = None,
                 recorder: FlightRecorder | None = None,
                 max_spans: int = 65536, max_events: int = 8192):
        self.tracer = tracer if tracer is not None else Tracer(max_spans)
        self.recorder = (recorder if recorder is not None
                         else FlightRecorder(max_events))

    def record(self, kind: str, step: int = 0, v: float = 0.0,
               data: dict | None = None, **extra):
        return self.recorder.record(kind, step=step, v=v, data=data,
                                    **extra)

    def explain(self, window_idx: int, lookback_windows: int = 2):
        return self.recorder.explain(window_idx,
                                     lookback_windows=lookback_windows)

    def save(self, dir_path, prefix: str = "obs",
             include_wall: bool = True) -> dict[str, pathlib.Path]:
        """Snapshot both sinks next to the stream npz: returns
        ``{"trace": ..., "events": ...}`` paths."""
        d = pathlib.Path(dir_path)
        d.mkdir(parents=True, exist_ok=True)
        return {
            "trace": save_chrome_trace(self.tracer,
                                       d / f"{prefix}_trace.json",
                                       include_wall=include_wall),
            "events": self.recorder.save(d / f"{prefix}_events.json"),
        }
