"""Dispatch accounting: one counted entry per pipeline phase launch, plus
the CUDA kernel launches each phase really made.

The counter API of ``repro.core.jax_partition`` (``DispatchEvent``,
``DispatchLog``, ``dispatch_counter``, ``_count_dispatch``,
``annotate_dispatch``).  Every counted
dispatch also emits a ``dispatch:<name>`` instant into the installed
tracers (``obs.trace.dispatch_instant``), as the JAX counter does.  One
counted dispatch per phase can hide thousands of kernel launches, so a
phase run under ``phase(name)`` also records, in
``DispatchLog.launches[name]``, how far each kernel's launch counter moved
while it ran (``{"parsa_select_tile": 6647, ...}``).
"""
from __future__ import annotations

import contextlib
import dataclasses

from ..kernels.parsa_cost.ops import LAUNCHES
from ..obs.trace import annotate_last_instant, dispatch_instant

__all__ = ["DispatchEvent", "DispatchLog", "annotate_dispatch",
           "dispatch_counter", "phase", "reset_dispatch_counts"]


@dataclasses.dataclass
class DispatchEvent:
    """One labeled pipeline launch: phase, carry bytes, extras."""

    phase: str
    nbytes: int = 0
    meta: dict = dataclasses.field(default_factory=dict)


class DispatchLog(dict):
    """A ``phase -> count`` dict with the ordered ``DispatchEvent`` records
    behind it and the kernel launches per phase (``launches``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.records: list[DispatchEvent] = []
        self.launches: dict[str, dict[str, int]] = {}

    def bytes_by_phase(self) -> dict[str, int]:
        """The carry bytes of the counted dispatches, summed by phase."""
        out: dict[str, int] = {}
        for r in self.records:
            out[r.phase] = out.get(r.phase, 0) + r.nbytes
        return out


_ACTIVE_COUNTERS: list[DispatchLog] = []


def _count_dispatch(name: str, nbytes: int = 0, **meta) -> None:
    for counts in _ACTIVE_COUNTERS:
        counts[name] = counts.get(name, 0) + 1
        counts.records.append(DispatchEvent(name, int(nbytes), dict(meta)))
    dispatch_instant(name, nbytes=nbytes, meta=meta or None)


def annotate_dispatch(**meta) -> None:
    """Attach after-the-fact labels to the dispatch just counted: its
    record in every active log and its instant in every installed
    tracer.  Nothing in the port calls it: the JAX package's one caller
    labels ``cache_miss`` from jit's cache, which the port has no
    counterpart of.  It is kept so that the counter API matches JAX's."""
    for counts in _ACTIVE_COUNTERS:
        if counts.records:
            counts.records[-1].meta.update(meta)
    annotate_last_instant(**meta)


@contextlib.contextmanager
def phase(name: str, nbytes: int = 0, **meta):
    """Count one dispatch of ``name`` and attribute the kernel launches made
    inside the ``with`` block to it."""
    _count_dispatch(name, nbytes, **meta)
    before = dict(LAUNCHES)
    try:
        yield
    finally:
        moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        for counts in _ACTIVE_COUNTERS:
            per = counts.launches.setdefault(name, {})
            for k, n in moved.items():
                per[k] = per.get(k, 0) + n


@contextlib.contextmanager
def dispatch_counter():
    """Yield a fresh ``{"partition_scan": 0, ...}`` log that records only
    the pipeline launches issued inside this ``with`` block."""
    counts = DispatchLog({"partition_scan": 0})
    _ACTIVE_COUNTERS.append(counts)
    try:
        yield counts
    finally:
        # remove by identity: equal-valued dicts from nested scopes must not
        # deregister each other
        for i, c in enumerate(_ACTIVE_COUNTERS):
            if c is counts:
                del _ACTIVE_COUNTERS[i]
                break


def reset_dispatch_counts() -> None:
    """Zero every active counter: its counts, its records and its kernel
    launches by phase (a test-isolation helper)."""
    for counts in _ACTIVE_COUNTERS:
        for key in counts:
            counts[key] = 0
        counts.records.clear()
        counts.launches.clear()
