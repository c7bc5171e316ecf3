"""Pull/compute overlap accounting and the ready-payload handle.

The port of ``OverlapMeter`` and ``ReadyHandle`` from
``repro/serving/prefetch.py``.  The engine meters ``blocked_s`` (wall time
spent waiting on a handle) against the modeled wire time, with a device
synchronize closing each compute; ``hidden_s`` is the communication the
schedule removed from the critical path.  The LM decode source has no
transfer to wait for, so its handles are ``ReadyHandle``s with zeroed
metering fields.
"""
from __future__ import annotations

import dataclasses
import time

__all__ = ["OverlapMeter", "ReadyHandle"]


@dataclasses.dataclass
class OverlapMeter:
    """Cumulative pull/compute overlap accounting across a run."""

    wire_s: float = 0.0       # modeled transfer time, summed
    wait_s: float = 0.0       # retry/timeout penalties, summed
    blocked_s: float = 0.0    # wall time actually spent blocked on pulls
    compute_s: float = 0.0    # synchronize-metered device compute

    def add(self, wire_s: float, wait_s: float, blocked_s: float,
            compute_s: float) -> None:
        self.wire_s += wire_s
        self.wait_s += wait_s
        self.blocked_s += blocked_s
        self.compute_s += compute_s

    @property
    def hidden_s(self) -> float:
        """Transfer time hidden behind compute (the measured overlap)."""
        return max(0.0, self.wire_s + self.wait_s - self.blocked_s)

    def as_dict(self) -> dict:
        return {"wire_s": self.wire_s, "wait_s": self.wait_s,
                "blocked_s": self.blocked_s, "compute_s": self.compute_s,
                "hidden_s": self.hidden_s}


@dataclasses.dataclass
class ReadyHandle:
    """A handle for payloads with no transfer to wait for (already-staged
    batches, decode tokens): lets non-PS sources drive the same engine loop
    as metered pulls, with zeroed metering fields."""

    payload: object
    wire_s: float = 0.0
    wait_s: float = 0.0
    queue_s: float = 0.0
    inner_bytes: int = 0
    inter_bytes: int = 0
    fresh_entries: int = 0
    stale_entries: int = 0
    issued_at: float = dataclasses.field(
        default_factory=time.perf_counter)

    def block(self):
        return self.payload
