"""Flight recorder: one bounded timeline for everything that explains an
SLO outcome.

Every layer records structured events keyed by the engine slot
(``step``) and the virtual time (``v``), and ``explain(window_idx)``
walks that single timeline to produce the causal chain behind a violated
decision window.  The emitters are the serving source
(``repro_torch.serving.engine.PSRequestSource``: chaos, elastic ops,
windows, sheds, breaker transitions) and the autoscaler
(``repro_torch.elastic.autoscaler``: decisions).

Event kinds:

  * ``chaos``        — a ``ChaosEvent`` applied (kind/machine/factor);
  * ``elastic_op``   — an ``ElasticOp`` (with its triggering
    ``TelemetrySnapshot``'s p99/step when the closed loop supplied one);
  * ``window``       — one autoscaler decision window's verdict
    (p99 vs SLO, action, reason);
  * ``decision``     — the autoscaler's own record (when its config
    carries the obs hook);
  * ``breaker_open`` / ``breaker_close`` — circuit transitions;
  * ``shed``         — one admission drop (tenant, backlog).

Events are plain dicts inside a bounded deque (oldest dropped), are
serialized deterministically (``to_json`` — byte-identical across seeded
replays), and snapshot alongside the stream npz via ``save``/``load``.

A copy of ``repro.obs.recorder``: the same events give the same bytes and
the same ``explain()`` text in both packages.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from collections import deque

__all__ = ["ObsEvent", "Explanation", "FlightRecorder"]

# cause kinds explain() may attribute a violated window to — the
# vocabulary bench_slo's attribution gate checks against
CAUSE_KINDS = ("burst", "kill", "straggle", "migration")


def _json_default(o):
    """JSON for numpy and torch scalars (a 0-d tensor becomes its Python
    number), so payloads read from either serialize alike."""
    try:
        import numpy as np
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
    except ImportError:       # pragma: no cover
        pass
    torch = sys.modules.get("torch")   # a tensor implies torch is loaded
    if torch is not None and isinstance(o, torch.Tensor) and o.dim() == 0:
        return o.item()
    raise TypeError(f"not JSON-serializable: {type(o)}")


@dataclasses.dataclass
class ObsEvent:
    """One recorded fact: (sequence, engine slot, virtual time, kind,
    payload)."""

    seq: int
    step: int
    v: float
    kind: str
    data: dict

    def as_dict(self) -> dict:
        return {"seq": self.seq, "step": self.step, "v": self.v,
                "kind": self.kind, "data": self.data}


@dataclasses.dataclass
class Explanation:
    """The causal chain behind one decision window's verdict."""

    window: int
    step: int
    verdict: str              # "within-slo" | "violated"
    p99_ms: float | None
    slo_ms: float | None
    causes: list[dict]        # [{"kind", "step", "detail"}, ...]
    evidence: list[dict]      # supporting events in the lookback interval

    @property
    def attributed(self) -> bool:
        return self.verdict != "violated" or bool(self.causes)

    def __str__(self) -> str:
        head = (f"window {self.window} (slot {self.step}): "
                f"p99 {self.p99_ms:.1f}ms "
                if self.p99_ms is not None
                else f"window {self.window} (slot {self.step}): ")
        if self.verdict == "within-slo":
            return head + (f"within SLO {self.slo_ms:.1f}ms"
                           if self.slo_ms is not None else "within SLO")
        lines = [head + (f"VIOLATED SLO {self.slo_ms:.1f}ms"
                         if self.slo_ms is not None else "VIOLATED SLO")]
        if not self.causes:
            lines.append("  no recorded cause (unattributed)")
        for c in self.causes:
            lines.append(f"  <- {c['kind']} @ slot {c['step']}: "
                         f"{c['detail']}")
        return "\n".join(lines)


class FlightRecorder:
    """Bounded structured event log over the serving timeline."""

    def __init__(self, maxlen: int = 8192):
        self._events: deque[ObsEvent] = deque(maxlen=maxlen)
        self._seq = 0

    # ----------------------------------------------------------- record
    def record(self, kind: str, step: int = 0, v: float = 0.0,
               data: dict | None = None, **extra) -> ObsEvent:
        # data= takes payload keys that collide with the parameters here
        # (a chaos event's own "kind", e.g.); **extra is the common path
        payload = dict(data) if data else {}
        payload.update(extra)
        ev = ObsEvent(seq=self._seq, step=int(step), v=float(v),
                      kind=kind, data=payload)
        self._seq += 1
        self._events.append(ev)
        return ev

    @property
    def events(self) -> list[ObsEvent]:
        return list(self._events)

    def of_kind(self, kind: str) -> list[ObsEvent]:
        return [ev for ev in self._events if ev.kind == kind]

    def __len__(self) -> int:
        return len(self._events)

    # ---------------------------------------------------------- explain
    def explain(self, window_idx: int,
                lookback_windows: int = 2) -> Explanation:
        """Causal chain behind decision window ``window_idx``.

        A cause is a recorded condition whose *effect interval* overlaps
        the window's lookback interval ``(lo, step]`` where ``lo`` is the
        slot of the window ``lookback_windows`` earlier (covers backlog
        drain: a burst that calmed one window ago still explains the
        queue the current window is paying down):

          * ``burst``     — load factor > 1 from the burst event until
            the calming event (open-ended if never calmed);
          * ``kill``      — from the kill until that machine's committed
            repair op (open-ended while dead);
          * ``straggle``  — from the straggle until its recover;
          * ``migration`` — a committed elastic op (grow/shrink/repair):
            point effect at its slot (+ the tau-escalation stale window
            it triggers, covered by the lookback).
        """
        windows = self.of_kind("window")
        target = idx_in = None
        for i, ev in enumerate(windows):
            if ev.data.get("window") == window_idx:
                target, idx_in = ev, i
                break
        if target is None:
            raise KeyError(f"no recorded window {window_idx}")
        step, d = target.step, target.data
        p99, slo = d.get("p99_ms"), d.get("slo_ms")
        within = d.get("within")
        if within is None:
            within = (p99 is not None and slo is not None and p99 <= slo)
        if within:
            return Explanation(window_idx, step, "within-slo", p99, slo,
                               [], [])
        lo = (windows[max(idx_in - lookback_windows, 0)].step
              if idx_in > 0 else -1)

        INF = float("inf")
        intervals: list[tuple[str, float, float, str]] = []
        burst = None                # (start step, factor)
        straggles: dict = {}        # machine -> (start step, factor)
        kills: dict = {}            # machine -> kill step
        evidence: list[dict] = []
        for ev in self._events:
            if ev.step > step:
                continue
            if lo < ev.step <= step and ev.kind != "window":
                evidence.append(ev.as_dict())
            if ev.kind == "chaos":
                ck = ev.data.get("kind")
                m = ev.data.get("machine")
                f = ev.data.get("factor", 1.0)
                if ck == "burst":
                    if f is not None and f > 1.0:
                        if burst is None:
                            burst = (ev.step, f)
                    elif burst is not None:
                        intervals.append((
                            "burst", burst[0], ev.step,
                            f"load burst x{burst[1]:g} slots "
                            f"[{burst[0]}, {ev.step}) — queue drains "
                            f"after"))
                        burst = None
                elif ck == "kill":
                    kills[m] = ev.step
                elif ck == "straggle":
                    straggles[m] = (ev.step, f)
                elif ck == "recover":
                    if m in straggles:
                        s0, f0 = straggles.pop(m)
                        intervals.append((
                            "straggle", s0, ev.step,
                            f"machine {m} straggling x{f0:g} slots "
                            f"[{s0}, {ev.step})"))
            elif ev.kind == "elastic_op" and ev.data.get("committed"):
                kind = ev.data.get("kind", "?")
                m = ev.data.get("machine")
                intervals.append((
                    "migration", ev.step, ev.step,
                    f"{kind} op (k {ev.data.get('k_before')}->"
                    f"{ev.data.get('k_after')}, machine {m}, "
                    f"{ev.data.get('migration_bytes', 0)} B moved, "
                    f"tau-escalated serving follows)"))
                if kind == "repair" and m in kills:
                    s0 = kills.pop(m)
                    # inclusive of the repair slot: the retry storm the
                    # kill caused still owns the slot the repair lands in
                    # (under prefetch the end-of-slot repair is even
                    # numbered one slot *before* the kill it answers)
                    intervals.append((
                        "kill", s0, max(ev.step, s0) + 1,
                        f"machine {m} killed at slot {s0}, repaired at "
                        f"{ev.step}"))
        if burst is not None:
            intervals.append(("burst", burst[0], INF,
                              f"load burst x{burst[1]:g} since slot "
                              f"{burst[0]} (still in force)"))
        for m, (s0, f0) in straggles.items():
            intervals.append(("straggle", s0, INF,
                              f"machine {m} straggling x{f0:g} since "
                              f"slot {s0} (not recovered)"))
        for m, s0 in kills.items():
            intervals.append(("kill", s0, INF,
                              f"machine {m} killed at slot {s0} "
                              f"(not repaired)"))
        causes = [{"kind": kind, "step": int(s0), "detail": detail}
                  for kind, s0, s1, detail in intervals
                  if s0 <= step and s1 > lo]
        causes.sort(key=lambda c: (c["step"], c["kind"]))
        return Explanation(window_idx, step, "violated", p99, slo,
                           causes, evidence[:50])

    # -------------------------------------------------------- serialize
    def to_json(self) -> str:
        """Deterministic byte stream — seeded replays compare equal."""
        return json.dumps([ev.as_dict() for ev in self._events],
                          sort_keys=True, separators=(",", ":"),
                          default=_json_default)

    def save(self, path) -> pathlib.Path:
        """Snapshot alongside the stream npz (same basename, .json)."""
        path = pathlib.Path(path)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path, maxlen: int = 8192) -> "FlightRecorder":
        rec = cls(maxlen=maxlen)
        for d in json.loads(pathlib.Path(path).read_text()):
            ev = ObsEvent(seq=d["seq"], step=d["step"], v=d["v"],
                          kind=d["kind"], data=d["data"])
            rec._events.append(ev)
            rec._seq = max(rec._seq, ev.seq + 1)
        return rec
