"""Exporters: Chrome-trace/Perfetto JSON for spans, Prometheus-style text
for the scattered counters.

``to_chrome_trace`` emits the standard Trace Event Format (complete
``"X"`` events + ``"i"`` instants) that Perfetto / ``chrome://tracing``
open directly.  Timestamps are the *virtual* microseconds, so the trace
is the modeled timeline the closed loop actually decided on; tracks
(tids) are the span ``track`` labels (one row per home machine, one for
the stream, one for elastic ops).  ``include_wall=False`` (default)
drops the measured wall-clock annotations so two seeded replays export
byte-identical JSON (``chrome_trace_json`` is separator/sort-stable for
exactly that comparison).

``prometheus_text`` unifies the counter objects under one naming scheme
(``parsa_<subsystem>_<metric>``): ``TrafficCounters`` (stream push/pull
and migration bytes), a ``LatencyRecorder`` (serving latency + per-tenant
sheds), a ``TelemetryBus`` (windowed gauges, EWMA speeds), a PS
``TrafficMeter``, and the labeled dispatch log.  Every argument is read
by attribute, so any object with those fields serializes.

A copy of ``repro.obs.export``: the same spans and counters give the same
bytes in both packages.
"""
from __future__ import annotations

import json
import pathlib

from .recorder import _json_default
from .trace import Tracer

__all__ = ["to_chrome_trace", "chrome_trace_json", "save_chrome_trace",
           "prometheus_text"]


def to_chrome_trace(tracer: Tracer, include_wall: bool = False) -> dict:
    """Spans → Trace Event Format dict (Perfetto-loadable)."""
    tracks: dict[str, int] = {}
    events = []
    for sp in tracer.spans:
        tid = tracks.setdefault(sp.track, len(tracks))
        args = dict(sp.attrs)
        args["trace_id"] = sp.trace_id
        args["span_id"] = sp.span_id
        if sp.parent_id >= 0:
            args["parent_id"] = sp.parent_id
        if include_wall and sp.wall_s is not None:
            args["wall_ms"] = sp.wall_s * 1e3
        if not include_wall:
            # replay-variant evidence: compile caches are warm on the
            # second run of a process, so hit/miss labels would break the
            # byte-identical replay comparison exactly like wall clocks
            args.pop("cache_miss", None)
        ev = {"name": sp.name, "cat": "parsa", "pid": 0, "tid": tid,
              "ts": round(sp.v_start * 1e6, 3), "args": args}
        if sp.instant:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(sp.v_dur * 1e6, 3)
        events.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "parsa virtual clock"}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
              "args": {"name": trk}}
             for trk, tid in sorted(tracks.items(), key=lambda kv: kv[1])]
    return {"displayTimeUnit": "ms", "traceEvents": meta + events}


def chrome_trace_json(tracer: Tracer, include_wall: bool = False) -> str:
    """Deterministic serialization (sorted keys, fixed separators): the
    byte stream two seeded replays must reproduce identically."""
    return json.dumps(to_chrome_trace(tracer, include_wall=include_wall),
                      sort_keys=True, separators=(",", ":"),
                      default=_json_default)


def save_chrome_trace(tracer: Tracer, path,
                      include_wall: bool = True) -> pathlib.Path:
    """Write a Perfetto-openable trace; wall-clock annotations included
    by default (a human is reading this one, not a diff)."""
    path = pathlib.Path(path)
    path.write_text(chrome_trace_json(tracer, include_wall=include_wall)
                    + "\n")
    return path


# --------------------------------------------------------------- metrics
def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(latency=None, telemetry=None, traffic=None,
                    meter=None, dispatches=None) -> str:
    """One text snapshot over every counter surface the repo keeps.

    All arguments optional: ``latency`` a ``LatencyRecorder``,
    ``telemetry`` a ``TelemetryBus``, ``traffic`` a ``TrafficCounters``,
    ``meter`` a PS ``TrafficMeter``, ``dispatches`` a
    ``dispatch_counter`` log (plain counts or the labeled form).
    """
    import numpy as np

    # family -> (type, help, [(labels, value), ...])
    fams: dict[str, tuple[str, str, list]] = {}

    def add(name, typ, help_, value, **labels):
        fam = fams.setdefault(name, (typ, help_, []))
        fam[2].append((labels, value))

    if latency is not None:
        recs = [r for r in latency.records if not r.warmup]
        add("parsa_serving_requests_total", "counter",
            "Served requests (post-warmup).", len(recs))
        for tenant, n in sorted(latency.shed.items()):
            add("parsa_serving_shed_total", "counter",
                "Admission-shed requests by tenant.", n, tenant=tenant)
        if recs:
            modeled = np.array([r.modeled_s for r in recs]) * 1e3
            for stat, val in (("p50", np.percentile(modeled, 50)),
                              ("p99", np.percentile(modeled, 99)),
                              ("mean", modeled.mean())):
                add("parsa_serving_latency_ms", "gauge",
                    "Modeled request latency (virtual clock).",
                    float(val), stat=stat)
            add("parsa_serving_pull_bytes_total", "counter",
                "Inter-machine pull bytes.",
                int(sum(r.pull_inter_bytes for r in recs)))
            add("parsa_serving_push_bytes_total", "counter",
                "Inter-machine push bytes.",
                int(sum(r.push_inter_bytes for r in recs)))
            add("parsa_serving_stale_entries_total", "counter",
                "Entries served from the stale buffer.",
                int(sum(r.stale_entries for r in recs)))

    if telemetry is not None:
        add("parsa_telemetry_served_total", "counter",
            "Requests folded into the telemetry windows.",
            telemetry.served)
        for tenant, n in sorted(telemetry.shed.items()):
            add("parsa_telemetry_shed_total", "counter",
                "Sheds metered by the telemetry bus, by tenant.", n,
                tenant=tenant)
        add("parsa_telemetry_p99_ms", "gauge",
            "Sliding-window p99 latency.",
            float(telemetry.modeled.percentile(99)), clock="modeled")
        add("parsa_telemetry_p99_ms", "gauge",
            "Sliding-window p99 latency.",
            float(telemetry.measured.percentile(99)), clock="measured")
        for m, w in enumerate(telemetry.ewma.weights()):
            add("parsa_telemetry_speed_ratio", "gauge",
                "Per-machine delivery speed (StragglerEWMA, mean 1).",
                float(w), machine=m)

    if traffic is not None:
        for field in ("pushed_bytes", "pulled_bytes", "tasks",
                      "stale_pushes_missed", "migration_bytes"):
            add(f"parsa_stream_{field}_total", "counter",
                "Stream/elastic traffic counter (bitmask-word bytes).",
                int(getattr(traffic, field)))

    if meter is not None:
        add("parsa_ps_inner_bytes_total", "counter",
            "PS traffic staying inside a machine.",
            int(meter.inner_bytes))
        add("parsa_ps_inter_bytes_total", "counter",
            "PS traffic crossing machines (the paper's objective).",
            int(meter.inter_bytes))

    if dispatches is not None:
        for phase, n in sorted(dispatches.items()):
            add("parsa_dispatch_total", "counter",
                "Device pipeline launches by phase.", n, phase=phase)
        records = getattr(dispatches, "records", None)
        if records:
            by_phase: dict[str, int] = {}
            for r in records:
                by_phase[r.phase] = by_phase.get(r.phase, 0) + r.nbytes
            for phase, nbytes in sorted(by_phase.items()):
                add("parsa_dispatch_bytes_total", "counter",
                    "Donated-carry bytes shipped into dispatches.",
                    nbytes, phase=phase)

    lines = []
    for name in sorted(fams):
        typ, help_, samples = fams[name]
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")
        for labels, value in samples:
            lines.append(f"{name}{_fmt_labels(labels)} "
                         f"{_fmt_value(value)}")
    return "\n".join(lines) + "\n"
