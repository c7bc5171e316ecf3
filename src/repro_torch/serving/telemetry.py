"""Windowed serving telemetry: the signal layer of the closed SLO loop.

The autoscaler (``repro_torch.elastic.autoscaler``) never reads engine state
directly — it sees immutable ``TelemetrySnapshot``s taken from a
``TelemetryBus`` that the request source feeds one observation per
served (or shed) request:

  * sliding-window p50/p99 latency, twice — *modeled* (the deterministic
    virtual-clock latency: wire + queue + retry penalty + service time)
    and *measured* (wall clock).  Decisions gate on the modeled window so
    a seeded chaos replay is bit-deterministic; the measured window is
    reported alongside as evidence the model tracks reality;
  * per-machine NIC occupancy — the virtual ``LinkClock`` backlog at
    snapshot time, i.e. how many seconds of already-booked transfer a new
    request to that home would queue behind;
  * live popcount footprints and row-shard sizes from the cluster (what a
    grow decision uses to pick the hot part to split);
  * a ``StragglerEWMA`` over per-source delivery speeds, fed from the
    priced transfer times of each request's pull (a straggling machine's
    slices arrive slower than its bytes/bandwidth baseline, so the EWMA
    converges to the straggle factor without being told it);
  * shed/served counters from admission control and the breaker's open
    circuits.

Snapshots carry tuples, not arrays, so two replays of the same seeded
schedule produce snapshot objects that compare ``==`` field-for-field —
the determinism contract the closed-loop replay asserts end to end.

A copy of ``repro.serving.telemetry``: host numpy over the port's
``StragglerEWMA`` (whose ``_ewma`` and ``_seen`` keep the reference's
names, so ``resize`` carries them the same way).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..runtime.straggler import StragglerEWMA
from .latency import LatencyWindow

__all__ = ["TelemetrySnapshot", "TelemetryBus"]


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """One immutable reading of the serving loop, as the autoscaler saw it
    when deciding.  All sequence fields are tuples (hashable, ``==`` by
    value) so decision records replay bit-identically."""

    step: int                        # engine slot the snapshot closed at
    k: int                           # live machine count
    window: int                      # observations in the sliding window
    p50_ms: float                    # modeled sliding-window p50
    p99_ms: float                    # modeled sliding-window p99 (gated)
    mean_ms: float                   # modeled sliding-window mean
    p99_measured_ms: float           # wall-clock p99 (reported, not gated)
    occupancy: tuple[float, ...]     # per-machine NIC backlog seconds
    footprint: tuple[int, ...]       # per-machine hosted-parameter popcount
    sizes: tuple[int, ...]           # per-machine example rows
    speeds: tuple[float, ...]        # StragglerEWMA weights (mean 1)
    shed: int                        # admission drops so far (cumulative)
    served: int                      # served requests so far (cumulative)
    open_circuits: tuple[int, ...]   # links currently open/half-open
    load_factor: float               # current burst multiplier

    @property
    def max_occupancy(self) -> float:
        return max(self.occupancy) if self.occupancy else 0.0

    @property
    def hot_part(self) -> int:
        """The grow split target: the machine hosting the most parameters
        (ties → lowest id), restricted to parts that can be split."""
        if not self.footprint:
            return 0
        best, best_foot = 0, -1
        for m, foot in enumerate(self.footprint):
            if m < len(self.sizes) and self.sizes[m] < 2:
                continue  # a 0/1-row part cannot be split
            if foot > best_foot:
                best, best_foot = m, foot
        return best


class TelemetryBus:
    """Accumulates per-request observations; closes them into snapshots.

    One bus instance is owned by the request source and survives elastic
    resizes (``resize`` keeps the EWMA history of surviving machines).
    The latency windows are ``LatencyWindow`` rings — lazily seeded, so
    the first decision window never averages preallocated zeros."""

    def __init__(self, k: int, window_requests: int = 64,
                 ewma_alpha: float = 0.3, ewma_floor: float = 0.1):
        if window_requests < 1:
            raise ValueError(
                f"window_requests must be >= 1, got {window_requests}")
        self.k = k
        self.window_requests = window_requests
        self._alpha, self._floor = ewma_alpha, ewma_floor
        self.modeled = LatencyWindow(window_requests)
        self.measured = LatencyWindow(window_requests)
        self.ewma = StragglerEWMA(k, alpha=ewma_alpha, floor=ewma_floor)
        self.served = 0
        self.shed: dict[str, int] = {}

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())

    def resize(self, k: int) -> None:
        """Track an elastic k change; EWMA history of surviving machines
        is preserved, new machines start unobserved (no penalty before
        evidence — the ``StragglerEWMA`` contract)."""
        if k == self.k:
            return
        new = StragglerEWMA(k, alpha=self._alpha, floor=self._floor)
        keep = min(k, self.k)
        new._ewma[:keep] = self.ewma._ewma[:keep]
        new._seen[:keep] = self.ewma._seen[:keep]
        self.ewma = new
        self.k = k

    def observe(self, modeled_s: float, measured_s: float,
                src_times: np.ndarray | None = None) -> None:
        """Fold one served request: modeled + measured latency, and
        (optionally) per-source delivery times — a (k,) vector with NaN
        for machines that shipped nothing this request."""
        self.modeled.add(modeled_s * 1e3)
        self.measured.add(measured_s * 1e3)
        if src_times is not None:
            times = np.asarray(src_times, np.float64)
            if times.shape[0] != self.k:
                fixed = np.full(self.k, np.nan)
                n = min(self.k, times.shape[0])
                fixed[:n] = times[:n]
                times = fixed
            self.ewma.update(times)
        self.served += 1

    def observe_shed(self, tenant: str) -> None:
        self.shed[tenant] = self.shed.get(tenant, 0) + 1

    def snapshot(self, step: int, occupancy, footprint, sizes,
                 open_circuits=(), load_factor: float = 1.0
                 ) -> TelemetrySnapshot:
        """Close the current window into an immutable snapshot."""
        return TelemetrySnapshot(
            step=step, k=self.k, window=self.modeled.filled,
            p50_ms=self.modeled.percentile(50),
            p99_ms=self.modeled.percentile(99),
            mean_ms=self.modeled.mean(),
            p99_measured_ms=self.measured.percentile(99),
            occupancy=tuple(float(x) for x in occupancy),
            footprint=tuple(int(x) for x in footprint),
            sizes=tuple(int(x) for x in sizes),
            speeds=tuple(float(x) for x in self.ewma.weights()),
            shed=self.shed_total, served=self.served,
            open_circuits=tuple(int(x) for x in open_circuits),
            load_factor=float(load_factor))
