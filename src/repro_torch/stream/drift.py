"""Sliding-window objective tracking for streaming Parsa (drift detection).

Online greedy never reshuffles vertices it has already placed, so as the
arriving distribution drifts (topic drift, campaign churn, preferential
attachment) the live partition's objective decays relative to what a fresh
partition of the same graph would achieve.  The tracker watches the only
signal that is free to compute every feed — the popcount metrics over
the live packed sets (objective (6)/(7) with ``parts_v=None``:
``traffic_max`` = max footprint) — and triggers a repartition when the
*imbalance ratio*

    drift = traffic_max · k / traffic_sum   (= max footprint / mean)

degrades past ``threshold`` × the best ratio seen inside a sliding window
of recent feeds.  The ratio is scale-free: footprints grow monotonically
with the stream, so comparing raw ``traffic_max`` across feeds would
always "degrade"; the max/mean ratio only rises when growth concentrates
on one machine — exactly the failure mode a repartition fixes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.costs import PartitionMetrics

__all__ = ["DriftTracker", "DriftDecision"]


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    """One tracker update: the imbalance observed and whether it tripped."""

    drift: float               # max/mean footprint ratio this feed
    baseline: float            # windowed-mean ratio (filled entries only)
    repartition: bool


class DriftTracker:
    """Sliding-window drift detector over per-feed ``PartitionMetrics``.

    ``window`` is how many recent feeds the baseline mean spans;
    ``threshold`` the multiplicative degradation that trips a repartition
    (1.0 = trip on any strict degradation past the windowed mean);
    ``min_feeds`` suppresses triggers until enough history exists.

    Cold-window behavior (as in the JAX package): the ring buffer is
    seeded *lazily* — the
    baseline is the mean over the entries actually observed so far, never
    over preallocated zeros.  A naive fixed-window mean would average in
    zeros before the window fills, deflating the baseline and tripping a
    repartition on the first feeds of every stream (and right after every
    ``reset``), exactly when a repartition is pointless.
    """

    def __init__(self, window: int = 8, threshold: float = 1.15,
                 min_feeds: int = 2):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if threshold < 1.0:
            raise ValueError(f"threshold must be >= 1.0, got {threshold}")
        if min_feeds < 1:
            raise ValueError(f"min_feeds must be >= 1, got {min_feeds}")
        self.window = window
        self.threshold = threshold
        self.min_feeds = min_feeds
        self._ring = np.zeros(window, np.float64)
        self._count = 0      # observations since the last reset

    def _baseline(self, drift: float) -> float:
        filled = min(self._count, self.window)
        if filled == 0:
            return drift     # lazy seed: first observation is its own bar
        if filled < self.window:
            return float(self._ring[:filled].mean())
        return float(self._ring.mean())

    def update(self, metrics: PartitionMetrics) -> DriftDecision:
        """Record one feed's metrics; decide whether to repartition."""
        total = max(int(metrics.traffic_sum), 1)
        drift = metrics.traffic_max * metrics.k / total
        baseline = self._baseline(drift)
        trip = (self._count >= self.min_feeds
                and drift > self.threshold * baseline)
        self._ring[self._count % self.window] = drift
        self._count += 1
        if trip:
            self.reset()
        return DriftDecision(drift=drift, baseline=baseline, repartition=trip)

    def reset(self) -> None:
        """Forget the window (called after a repartition relevels the
        baseline — the post-repartition ratio starts a fresh window)."""
        self._count = 0
