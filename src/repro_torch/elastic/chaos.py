"""Deterministic fault injection for elastic streaming runs.

A ``ChaosSchedule`` is a seeded, pre-declared list of fleet events —
machine kills, joins, stragglers and recoveries — keyed by *feed index*,
so a chaos run is exactly reproducible: the same schedule, seed and
chunk sequence produce bit-identical partitions (``chip_smoke.py``
phase ``elastic`` replays it twice on the card).  Events whose target is
left unspecified are resolved from the schedule's own RNG in declaration
order, never from global state, so resolution is part of the determinism
contract.

This is the streaming analogue of the JAX package's
``runtime.fault.FaultConfig.fail_at_step`` — scheduled, not sampled,
because robustness tests want to replay the exact same disaster until the
recovery path is boring.  A copy of ``repro.elastic.chaos``: the seeded
draws are the same, so a schedule kills the same machines in both
packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ChaosEvent", "ChaosSchedule"]

_KINDS = ("kill", "add", "straggle", "recover", "burst")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fleet event, applied just before feed ``feed``.

    ``machine`` targets a part/machine id for ``kill`` and a *worker*
    lane for ``straggle``/``recover`` (``None`` = let the schedule's RNG
    pick); ``factor`` is the straggler's slowdown multiplier.  ``add``
    events take no target — the new machine is always the split of the
    current largest part.  ``burst`` is a *load* event (serving layer
    only): ``factor`` multiplies request batch sizes from this point on
    — factor 1.0 calms the burst; streams ignore it."""

    feed: int
    kind: str
    machine: int | None = None
    factor: float = 4.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"kind must be one of {_KINDS}, got {self.kind!r}")
        if self.feed < 0:
            raise ValueError(f"feed must be >= 0, got {self.feed}")
        if self.kind == "straggle" and self.factor <= 1.0:
            raise ValueError(
                f"straggle factor must be > 1, got {self.factor}")
        if self.kind == "burst" and self.factor <= 0.0:
            raise ValueError(
                f"burst factor must be > 0, got {self.factor}")


class ChaosSchedule:
    """Ordered, seeded event schedule consumed by ``ElasticSession``.

    ``at(feed)`` returns the events due at one feed index in declaration
    order; each event is handed out exactly once.  Unspecified targets
    are drawn eagerly at construction (one ``integers`` call per open
    event, in declaration order) so lookup order cannot perturb the
    resolution.
    """

    def __init__(self, events: list[ChaosEvent] | tuple[ChaosEvent, ...],
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.seed = seed
        resolved = []
        for ev in events:
            if ev.machine is None and ev.kind in ("kill", "straggle",
                                                  "recover"):
                # bound by a huge range; the session reduces modulo the
                # live fleet/worker width at apply time, so the draw stays
                # valid across k changes yet is fixed at construction
                ev = dataclasses.replace(
                    ev, machine=int(rng.integers(0, 2**31 - 1)))
            resolved.append(ev)
        self.events = tuple(sorted(resolved, key=lambda e: e.feed))
        self._served = [False] * len(self.events)

    def at(self, feed: int) -> list[ChaosEvent]:
        """Pop every not-yet-served event scheduled for ``feed``."""
        due = []
        for i, ev in enumerate(self.events):
            if ev.feed == feed and not self._served[i]:
                self._served[i] = True
                due.append(ev)
        return due

    @property
    def remaining(self) -> int:
        return sum(not s for s in self._served)

    def reset(self) -> None:
        """Re-arm every event (replay the same disaster)."""
        self._served = [False] * len(self.events)
