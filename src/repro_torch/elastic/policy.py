"""Pluggable elasticity policies (Parla's ``PartitioningAlgorithm`` shape).

Parla's partitioning layer separates the *algorithm object* — an
introspectable class exposing sizing properties (``n_partitions``,
``neighborhood_size``) next to per-element decision methods
(``get_vertex_master``/``get_edge_master``) — from the loop that runs
it.  ``ElasticPolicy`` mirrors that shape for fleet elasticity: sizing
bounds (``min_partitions``/``max_partitions``) as properties, one
decision method per elastic event (``grow``/``shrink``/``repair``/
``rebalance``), and a session (``repro_torch.elastic.ElasticSession``)
that consults the policy but owns all mechanism.

Every decision sees the same ``FleetState`` snapshot, which includes the
*metered* migration cost of the candidate action (``TrafficCounters``
units, 4 bytes per 32 parameters) and the projected steady-state savings
per feed — so policies weigh a one-time re-shard against its recurring
payoff instead of guessing.  A copy of ``repro.elastic.policy``.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

__all__ = ["FleetState", "ElasticPolicy", "ThresholdPolicy"]


@dataclasses.dataclass(frozen=True)
class FleetState:
    """What a policy sees when deciding one elastic action.

    ``migration_bytes``/``projected_savings`` are zero for decisions with
    no candidate plan attached (``rebalance``); ``projected_savings`` is
    the estimated per-feed steady-state byte reduction the candidate
    action buys (serving traffic scales with the max per-machine
    footprint for grow, with retired duplication for shrink)."""

    k: int                      # current machine count
    feed_index: int             # feeds consumed so far
    sizes: np.ndarray           # (k,) U rows per machine
    footprint: np.ndarray       # (k,) hosted parameters per machine
    migration_bytes: int = 0    # metered cost of the candidate action
    projected_savings: int = 0  # projected steady-state bytes saved / feed


@runtime_checkable
class ElasticPolicy(Protocol):
    """Decision protocol for the elastic session — mechanism-free.

    Implementations return plain booleans (``grow``/``shrink``), a mode
    string (``repair``), or adjusted worker weights (``rebalance``); the
    session performs the actual split/merge/scan and meters the traffic.
    """

    @property
    def min_partitions(self) -> int: ...

    @property
    def max_partitions(self) -> int: ...

    def grow(self, state: FleetState) -> bool:
        """Commit the candidate largest-part split (k → k+1)?"""
        ...

    def shrink(self, state: FleetState) -> bool:
        """Commit the candidate smallest-pair merge (k → k−1)?"""
        ...

    def repair(self, state: FleetState) -> str:
        """Recovery mode after a worker loss: ``"warm"`` (§4.4 repair
        from surviving sets, one dispatch) or ``"cold"`` (full
        repartition of the arena)."""
        ...

    def rebalance(self, state: FleetState,
                  weights: np.ndarray) -> np.ndarray | None:
        """Adjust (or veto, by returning None) the straggler-EWMA block
        weights for the next parallel feed."""
        ...


@dataclasses.dataclass
class ThresholdPolicy:
    """Default policy: amortize migration cost over a feed horizon.

    Grow/shrink commit when the candidate's one-time ``migration_bytes``
    pays for itself within ``budget_feeds`` feeds of projected steady-
    state savings (and the fleet stays inside the sizing bounds).  Repair
    is always warm — the whole point of keeping surviving ``s_masks`` —
    and rebalance passes the EWMA weights through unchanged when
    ``straggler_bias`` is on.
    """

    min_k: int = 2
    max_k: int = 64
    budget_feeds: int = 32
    straggler_bias: bool = True

    @property
    def min_partitions(self) -> int:
        return self.min_k

    @property
    def max_partitions(self) -> int:
        return self.max_k

    def grow(self, state: FleetState) -> bool:
        if state.k + 1 > self.max_k:
            return False
        return (state.migration_bytes
                <= self.budget_feeds * state.projected_savings)

    def shrink(self, state: FleetState) -> bool:
        if state.k - 1 < self.min_k:
            return False
        return (state.migration_bytes
                <= self.budget_feeds * state.projected_savings)

    def repair(self, state: FleetState) -> str:
        return "warm"

    def rebalance(self, state: FleetState,
                  weights: np.ndarray) -> np.ndarray | None:
        return weights if self.straggler_bias else None
