"""Virtual-clock tracing: nested spans over the deterministic timeline.

Spans live on a *virtual clock*: every span's ``v_start``/``v_dur`` is a
modeled quantity (wire seconds, retry penalty, virtual queue and service
time of a served request; a stream feed is one virtual unit, its phases
fixed fractions of it), never a wall-clock reading, so two replays of the
same seeded schedule emit byte-identical trace streams.  Measured
wall-clock durations (the host's ``perf_counter`` around each phase, the
engine's synchronize-closed compute) ride along in ``Span.wall_s`` as
optional evidence and are *excluded* from the deterministic export by
default (``export.chrome_trace_json(include_wall=False)``).

Span trees emitted by the instrumented layers:

  * ``request → pull(wire/retry/queue)/compute/push`` — built by
    ``ServingEngine`` from the ``PullHandle``'s modeled breakdown;
  * ``feed → pack/scan/merge/metrics`` — ``StreamSession.feed``;
  * ``elastic_op → plan/scan/migrate`` — ``ElasticSession`` ops.

Trace/span ids are plain ordinals (deterministic).  Context propagates
two ways: explicitly (a ``SpanHandle`` adds children at offsets inside
its parent) and implicitly through the *installed-tracer registry* —
``Tracer.installed()`` registers the tracer for the duration of an
engine run, and deep layers that hold no reference to it
(``PSCluster.plan_pull/pull_nowait``, ``Router.refresh``, the dispatch
counter of ``core.dispatch``) call the module-level ``trace_instant`` /
``dispatch_instant``, which attach an instant event to the innermost
open span of every installed tracer.  With no tracer installed those
hooks are a truthiness test on an empty list.

A copy of ``repro.obs.trace``: both packages emit the same spans, so
their exports compare byte for byte.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque

__all__ = ["Span", "SpanHandle", "Tracer", "trace_instant",
           "dispatch_instant", "annotate_last_instant"]

# Tracers currently installed (engine runs, `with tracer.installed()`);
# module-level like core.dispatch's _ACTIVE_COUNTERS so layers without an
# obs reference can still emit into the active trace context.
_ACTIVE: list["Tracer"] = []


@dataclasses.dataclass
class Span:
    """One interval (or instant) on the virtual timeline."""

    name: str
    trace_id: int
    span_id: int
    parent_id: int            # -1 for trace roots
    v_start: float            # virtual seconds (deterministic)
    v_dur: float              # virtual seconds; 0 for instants
    track: str                # Perfetto row ("home3", "stream", ...)
    wall_s: float | None = None   # measured wall clock, replay-variant
    instant: bool = False
    attrs: dict = dataclasses.field(default_factory=dict)


class SpanHandle:
    """A handle on one span: add children at offsets inside it."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span

    def child(self, name: str, offset: float, dur: float,
              wall_s: float | None = None, track: str | None = None,
              **attrs) -> "SpanHandle":
        """Child span at ``[v_start + offset, v_start + offset + dur)``."""
        parent = self.span
        sp = Span(name=name, trace_id=parent.trace_id,
                  span_id=self.tracer._next_span(),
                  parent_id=parent.span_id,
                  v_start=parent.v_start + offset, v_dur=dur,
                  track=track if track is not None else parent.track,
                  wall_s=wall_s, attrs=attrs)
        self.tracer._add(sp)
        return SpanHandle(self.tracer, sp)

    def set(self, v_dur: float | None = None,
            wall_s: float | None = None, **attrs) -> "SpanHandle":
        """Finalize fields known only after the fact (retrospective
        duration / measured wall time)."""
        if v_dur is not None:
            self.span.v_dur = v_dur
        if wall_s is not None:
            self.span.wall_s = wall_s
        self.span.attrs.update(attrs)
        return self


class Tracer:
    """Bounded span sink on the virtual clock.

    ``now`` is the tracer's current virtual time: the serving source sets
    it to ``vtime`` every slot; a standalone stream advances it one unit
    per feed.  ``begin`` opens a new trace (root span); ``instant``
    records a point event parented to the innermost pushed span.
    """

    def __init__(self, max_spans: int = 65536):
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self.now = 0.0
        self._trace_seq = 0
        self._span_seq = 0
        self._stack: list[Span] = []

    # ------------------------------------------------------------ clock
    def set_time(self, v: float) -> None:
        self.now = float(v)

    def advance(self, dv: float) -> None:
        self.now += float(dv)

    # ------------------------------------------------------------ spans
    def _next_span(self) -> int:
        self._span_seq += 1
        return self._span_seq

    def _add(self, sp: Span) -> None:
        self.spans.append(sp)

    def begin(self, name: str, v_start: float | None = None,
              v_dur: float = 0.0, track: str = "main",
              wall_s: float | None = None, **attrs) -> SpanHandle:
        """Open a new trace; returns the root span's handle."""
        self._trace_seq += 1
        sp = Span(name=name, trace_id=self._trace_seq,
                  span_id=self._next_span(), parent_id=-1,
                  v_start=self.now if v_start is None else float(v_start),
                  v_dur=v_dur, track=track, wall_s=wall_s, attrs=attrs)
        self._add(sp)
        return SpanHandle(self, sp)

    def instant(self, name: str, track: str | None = None,
                **attrs) -> None:
        """Point event at ``now``, inside the innermost pushed span."""
        parent = self._stack[-1] if self._stack else None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
            trk = parent.track if track is None else track
        else:
            self._trace_seq += 1
            trace_id, parent_id = self._trace_seq, -1
            trk = "main" if track is None else track
        self._add(Span(name=name, trace_id=trace_id,
                       span_id=self._next_span(), parent_id=parent_id,
                       v_start=self.now, v_dur=0.0, track=trk,
                       instant=True, attrs=attrs))

    # ------------------------------------------------- context stack
    def push(self, handle: SpanHandle) -> None:
        self._stack.append(handle.span)

    def pop(self) -> None:
        self._stack.pop()

    # --------------------------------------------- installed registry
    def install(self) -> None:
        _ACTIVE.append(self)

    def uninstall(self) -> None:
        for i, t in enumerate(_ACTIVE):
            if t is self:      # identity, like dispatch_counter teardown
                del _ACTIVE[i]
                break

    @contextlib.contextmanager
    def installed(self):
        """Register this tracer for module-level ``trace_instant`` hooks
        (the engine wraps its run loop in this)."""
        self.install()
        try:
            yield self
        finally:
            self.uninstall()


def trace_instant(name: str, **attrs) -> None:
    """Emit an instant into every installed tracer; no-op (one truthiness
    check) when tracing is off — safe to call on hot paths."""
    if not _ACTIVE:
        return
    for t in _ACTIVE:
        t.instant(name, **attrs)


def dispatch_instant(name: str, nbytes: int = 0,
                     meta: dict | None = None) -> None:
    """The dispatch counter's trace hook: one instant per counted
    pipeline dispatch."""
    if not _ACTIVE:
        return
    for t in _ACTIVE:
        t.instant("dispatch:" + name, nbytes=int(nbytes), **(meta or {}))


def annotate_last_instant(**attrs) -> None:
    """Attach after-the-fact labels to the dispatch instant just emitted —
    only touches a trailing ``dispatch:`` span."""
    for t in _ACTIVE:
        if t.spans and t.spans[-1].name.startswith("dispatch:"):
            t.spans[-1].attrs.update(attrs)
