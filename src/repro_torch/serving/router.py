"""Request → worker routing from the live placement.

A request is served by one *home* machine: the worker whose row shard
hosts the examples the request touches.  The router keeps a per-machine
pool of example rows derived from the cluster's current ``parts_u`` and
re-derives it whenever ``PSCluster.placement_version`` moves — which is
how elastic grow/shrink/repair (``ElasticSession.sync_cluster``) become
visible to in-flight traffic without any coordination beyond the version
counter.

Sampling is Zipf *within* the home pool (production traffic is
power-law over a tenant's own hot set), with a per-tenant offset so
different tenants hammer different hot rows.  Keeping the skew inside
the shard is what lets a locality-aware placement pay off: the rows a
request batches together share features, so their working set — and the
pull bytes — concentrate on few machines.

A copy of ``repro.serving.router``: the pools are the cluster's host row
lists, and ``sample_rows`` draws from the caller's numpy generator in the
reference's order, so the same seed samples the same rows.
"""
from __future__ import annotations

import numpy as np

from ..obs.trace import trace_instant

__all__ = ["Router"]


class Router:
    """Maps requests to home machines and samples their row batches."""

    def __init__(self, cluster):
        self.version = -1
        self.pools: list[np.ndarray] = []
        self.k = 0
        self._rr = 0
        self._zipf_cache: dict[tuple[int, float], np.ndarray] = {}
        self.weights: np.ndarray | None = None
        self._swrr: np.ndarray | None = None
        self.refresh(cluster)

    def refresh(self, cluster) -> bool:
        """Re-derive the row pools if the placement moved; returns whether
        anything changed."""
        if cluster.placement_version == self.version:
            return False
        if cluster.k != self.k:
            # elastic resize: routing weights are stale for the new fleet;
            # fall back to plain round-robin until the controller re-sets
            self.weights = None
            self._swrr = None
        self.version = cluster.placement_version
        self.k = cluster.k
        self.pools = [np.asarray(rows) for rows in cluster.rows]
        trace_instant("router.refresh", version=self.version, k=self.k)
        return True

    def set_weights(self, weights) -> None:
        """Bias ``next_home`` toward fast machines (straggler-aware
        routing): per-machine weights consumed by a smooth weighted
        round-robin.  ``None`` restores plain round-robin."""
        if weights is None:
            self.weights = None
            self._swrr = None
            return
        w = np.asarray(weights, np.float64)
        if w.shape != (self.k,):
            raise ValueError(
                f"weights must have shape ({self.k},), got {w.shape}")
        if (w <= 0).any():
            raise ValueError("weights must be > 0")
        self.weights = w
        self._swrr = np.zeros(self.k, np.float64)

    def live(self, dead=()) -> list[int]:
        return [m for m in range(self.k)
                if m not in dead and self.pools[m].size > 0]

    def next_home(self, dead=()) -> int:
        """Round-robin over live machines with non-empty pools; smooth
        *weighted* round-robin when ``set_weights`` biased the fleet
        (deterministic: no RNG, ties break to the lowest machine id)."""
        live = self.live(dead)
        if not live:
            raise RuntimeError("no live machine with examples to serve")
        if self.weights is None:
            home = live[self._rr % len(live)]
            self._rr += 1
            return home
        # smooth WRR (nginx scheme): credit each live machine its weight,
        # serve the richest, debit it the round's total credit
        idx = np.array(live)
        self._swrr[idx] += self.weights[idx]
        home = int(idx[np.argmax(self._swrr[idx])])
        self._swrr[home] -= float(self.weights[idx].sum())
        return home

    def _zipf_p(self, n: int, s: float) -> np.ndarray:
        key = (n, s)
        p = self._zipf_cache.get(key)
        if p is None:
            p = 1.0 / np.arange(1, n + 1) ** s
            p /= p.sum()
            self._zipf_cache[key] = p
        return p

    def sample_rows(self, home: int, size: int, rng: np.random.Generator,
                    zipf_s: float = 1.1, hot_offset: int = 0) -> np.ndarray:
        """Zipf-skewed batch from the home machine's pool.  ``hot_offset``
        rotates the pool so tenants get distinct hot sets."""
        pool = self.pools[home]
        if pool.size == 0:
            raise ValueError(f"machine {home} hosts no examples")
        if hot_offset:
            pool = np.roll(pool, -(hot_offset % pool.size))
        idx = rng.choice(pool.size, size=size,
                         p=self._zipf_p(pool.size, zipf_s))
        return pool[idx]

    def route(self, rows: np.ndarray, parts_u: np.ndarray,
              dead=()) -> int:
        """Home for an explicit row set: majority vote of the rows'
        hosting machines, skipping dead ones."""
        owners = np.asarray(parts_u)[np.asarray(rows)]
        counts = np.bincount(owners, minlength=self.k)
        for m in dead:
            if 0 <= m < counts.shape[0]:
                counts[m] = 0
        if counts.sum() == 0:
            return self.next_home(dead)
        return int(np.argmax(counts))
