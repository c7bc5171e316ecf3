"""Pull/compute overlap accounting, the ready-payload handle and staged
batch prefetching.

The port of ``OverlapMeter``, ``ReadyHandle`` and ``prefetch_batches``
from ``repro/serving/prefetch.py``; ``stage_batch`` is the staging the
training driver gives ``prefetch_batches``.  The engine meters
``blocked_s`` (wall time spent waiting on a handle) against the modeled
wire time, with a device synchronize closing each compute; ``hidden_s``
is the communication the schedule removed from the critical path.  The
LM decode source has no transfer to wait for, so its handles are
``ReadyHandle``s with zeroed metering fields.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

__all__ = ["OverlapMeter", "ReadyHandle", "prefetch_batches", "stage_batch"]

T = TypeVar("T")
S = TypeVar("S")


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


def prefetch_batches(batches: Iterable[T],
                     stage: Callable[[T], S] | None = None,
                     depth: int = 2) -> Iterator[S]:
    """Yield staged batches, keeping up to ``depth`` staged ahead.

    ``stage`` typically moves a host batch to the device
    (``stage_batch``); because its copies are asynchronous, the transfer of
    batch t+1 overlaps the caller's compute on batch t.  ``depth=1``
    degenerates to the unstaged loop."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if stage is None:
        stage = lambda x: x  # noqa: E731
    buf: collections.deque = collections.deque()
    it = iter(batches)
    try:
        while len(buf) < depth:
            buf.append(stage(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(stage(next(it)))
        except StopIteration:
            pass
        yield out


def stage_batch(batch: dict, device) -> dict:
    """A host batch of numpy arrays as tensors on ``device``.  On the card
    each array is copied into freshly pinned host memory and sent with
    ``non_blocking=True`` on the current stream.  The pinned buffer is
    never reused before its copy has finished: PyTorch's pinned-memory
    allocator records the copy's stream event and holds a freed buffer
    until that event completes."""
    dev = torch.device(device)
    out = {}
    for key, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[key] = t
    return out
