"""Latency accounting for the serving engine.

The port of ``repro/serving/latency.py``.  ``BandwidthModel`` prices each
pull against the wall-clock model ``PSCluster`` uses for training: a
machine's NIC serializes its inter-machine bytes, so a pull's transfer time
is the *sum* of the remote slices arriving at the home worker's ingress
link, each inflated by its source's straggle factor.  ``LinkClock`` extends
that to concurrent transfers: every transfer books the home NIC for its
duration, so a push still draining delays the next pull on the same
machine.  A pull's ``wire_s`` is the pure modeled transfer and ``queue_s``
the extra delay spent waiting for the home NIC to drain earlier bookings —
the overload signal the SLO autoscaler scales on.

``LatencyRecorder`` accumulates one ``RequestRecord`` per served request
and reduces them to p50/p99 request latency, examples/s and tokens/s, the
overlap split and the per-tenant shed counts.  With ``window_requests`` set
it also keeps a lazily seeded ring of recent latencies (``windowed()``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BandwidthModel", "LinkClock", "LatencyWindow", "RequestRecord",
           "LatencyRecorder"]


@dataclasses.dataclass(frozen=True)
class BandwidthModel:
    """Per-link transfer pricing: bytes / bandwidth × straggle factor."""

    bandwidth: float = 125e6  # 1 GbE, matching PSCluster's default

    def per_source(self, src_bytes: np.ndarray, home: int,
                   straggle: np.ndarray | None = None) -> np.ndarray:
        """Seconds each source machine needs to ship its slice to
        ``home``.  The home machine's slice is local (0 s)."""
        secs = np.asarray(src_bytes, np.float64) / self.bandwidth
        if straggle is not None:
            secs = secs * np.asarray(straggle, np.float64)[: secs.shape[0]]
        if 0 <= home < secs.shape[0]:
            secs[home] = 0.0
        return secs

    def ingress_seconds(self, src_bytes: np.ndarray, home: int,
                        straggle: np.ndarray | None = None,
                        exclude=()) -> float:
        """Modeled pull transfer time: the remote slices serialize into
        the home worker's ingress link."""
        secs = self.per_source(src_bytes, home, straggle)
        for j in exclude:
            if 0 <= j < secs.shape[0]:
                secs[j] = 0.0
        return float(secs.sum())


class LinkClock:
    """Per-machine NIC availability: transfers book the link in issue
    order, so a fire-and-forget push still drains real (modeled)
    bandwidth and delays the machine's next transfer."""

    def __init__(self, k: int):
        self.free_at = np.zeros(k, np.float64)

    def resize(self, k: int) -> None:
        if k > self.free_at.shape[0]:
            self.free_at = np.concatenate(
                [self.free_at, np.zeros(k - self.free_at.shape[0])])
        else:
            self.free_at = self.free_at[:k]

    def backlog(self, machine: int, now: float) -> float:
        """Seconds of already-booked transfer still ahead of ``now`` on
        the machine's link — the queueing delay a new transfer would
        inherit (the admission controller's per-home queue depth)."""
        return max(0.0, float(self.free_at[machine]) - now)

    def acquire(self, machine: int, now: float, seconds: float) -> float:
        """Book ``seconds`` of the machine's link starting no earlier than
        ``now``; returns the completion time."""
        start = max(now, float(self.free_at[machine]))
        self.free_at[machine] = start + seconds
        return start + seconds


class LatencyWindow:
    """Ring buffer of the last ``size`` observations with lazy seeding.

    ``percentile`` reduces over the entries actually observed so far —
    a cold (or freshly reset) window never averages preallocated zeros."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = size
        self._ring = np.zeros(size, np.float64)
        self._count = 0

    def add(self, value: float) -> None:
        self._ring[self._count % self.size] = value
        self._count += 1

    @property
    def filled(self) -> int:
        return min(self._count, self.size)

    @property
    def total_observed(self) -> int:
        return self._count

    def values(self) -> np.ndarray:
        """The observed entries, oldest-truncated (order unspecified)."""
        return self._ring[: self.filled]

    def percentile(self, q: float) -> float:
        if self.filled == 0:
            return 0.0
        return float(np.percentile(self._ring[: self.filled], q))

    def mean(self) -> float:
        if self.filled == 0:
            return 0.0
        return float(self._ring[: self.filled].mean())

    def reset(self) -> None:
        self._count = 0


@dataclasses.dataclass
class RequestRecord:
    """Everything measured for one served request."""

    tenant: str
    step: int
    home: int
    examples: int
    tokens: int
    latency_s: float          # pull issue → commit, wall clock
    wire_s: float             # modeled pull transfer time (pure transfer)
    wait_s: float             # retry/timeout penalty on failed links
    blocked_s: float          # wall time actually spent in handle.block()
    compute_s: float          # synchronize-metered device compute
    fresh_entries: int = 0
    stale_entries: int = 0    # entries served stale (dead/timed-out shard)
    pull_inter_bytes: int = 0
    push_inter_bytes: int = 0
    warmup: bool = False      # excluded from the summary statistics
    queue_s: float = 0.0      # NIC-backlog delay ahead of the transfer
    modeled_s: float = 0.0    # deterministic virtual-clock latency


class LatencyRecorder:
    """Accumulate ``RequestRecord`` rows; reduce to benchmark numbers.

    ``window_requests`` (optional) sizes a sliding ring over the most
    recent non-warmup requests, surfaced as ``windowed()`` and the
    ``p50_window_ms`` / ``p99_window_ms`` summary keys — the recency-aware
    percentiles a closed-loop SLO controller acts on."""

    def __init__(self, window_requests: int | None = None):
        self.records: list[RequestRecord] = []
        self.window_requests = window_requests
        self._win = (LatencyWindow(window_requests)
                     if window_requests else None)
        self.shed: dict[str, int] = {}

    def add(self, rec: RequestRecord) -> None:
        self.records.append(rec)
        if self._win is not None and not rec.warmup:
            self._win.add(rec.latency_s * 1e3)

    def add_shed(self, tenant: str) -> None:
        """Meter one admission-control drop against its tenant."""
        self.shed[tenant] = self.shed.get(tenant, 0) + 1

    @property
    def shed_requests(self) -> int:
        return sum(self.shed.values())

    def windowed(self) -> dict:
        """p50/p99/mean over the sliding window (ms).  Cold start reduces
        over what was actually observed; zero observations → zeros."""
        if self._win is None:
            raise ValueError(
                "LatencyRecorder built without window_requests")
        return {
            "requests": self._win.filled,
            "p50_ms": self._win.percentile(50),
            "p99_ms": self._win.percentile(99),
            "mean_ms": self._win.mean(),
        }

    def summary(self, wall_s: float | None = None) -> dict:
        """Reduce the non-warmup records.

        ``wall_s`` is the engine-measured wall clock of the timed window
        (throughput denominators); defaults to the sum of latencies,
        which is only correct for the sync engine."""
        recs = [r for r in self.records if not r.warmup]
        if not recs:
            return {"requests": 0,
                    "shed_requests": self.shed_requests,
                    "shed_frac": 1.0 if self.shed_requests else 0.0,
                    "shed_per_tenant": dict(self.shed)}
        lat_ms = np.array([r.latency_s for r in recs]) * 1e3
        examples = sum(r.examples for r in recs)
        tokens = sum(r.tokens for r in recs)
        if wall_s is None:
            wall_s = float(sum(r.latency_s for r in recs))
        wire = sum(r.wire_s for r in recs)
        wait = sum(r.wait_s for r in recs)
        queue = sum(r.queue_s for r in recs)
        blocked = sum(r.blocked_s for r in recs)
        compute = sum(r.compute_s for r in recs)
        hidden = max(0.0, wire + wait + queue - blocked)
        shed = self.shed_requests
        tenants = {}
        for name in sorted({r.tenant for r in recs} | set(self.shed)):
            tl = np.array([r.latency_s for r in recs if r.tenant == name])
            tenants[name] = {
                "requests": int(tl.size),
                "p50_ms": float(np.percentile(tl, 50) * 1e3)
                if tl.size else 0.0,
                "p99_ms": float(np.percentile(tl, 99) * 1e3)
                if tl.size else 0.0,
                "shed": self.shed.get(name, 0),
            }
        out = {
            "requests": len(recs),
            "examples": int(examples),
            "tokens": int(tokens),
            "wall_s": float(wall_s),
            "examples_s": examples / wall_s if wall_s > 0 else 0.0,
            "tokens_s": tokens / wall_s if wall_s > 0 else 0.0,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "mean_ms": float(lat_ms.mean()),
            "wire_s": float(wire),
            "wait_s": float(wait),
            "queue_s": float(queue),
            "blocked_s": float(blocked),
            "compute_s": float(compute),
            "hidden_s": float(hidden),
            "hidden_frac": float(hidden / (wire + wait + queue))
            if wire + wait + queue > 0 else 0.0,
            "stale_entries": int(sum(r.stale_entries for r in recs)),
            "fresh_entries": int(sum(r.fresh_entries for r in recs)),
            "pull_inter_bytes": int(sum(r.pull_inter_bytes for r in recs)),
            "push_inter_bytes": int(sum(r.push_inter_bytes for r in recs)),
            "shed_requests": shed,
            "shed_frac": shed / (shed + len(recs)),
            "shed_per_tenant": dict(self.shed),
            "per_tenant": tenants,
        }
        if self._win is not None:
            w = self.windowed()
            out["p50_window_ms"] = w["p50_ms"]
            out["p99_window_ms"] = w["p99_ms"]
        return out
