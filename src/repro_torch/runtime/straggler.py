r"""Straggler mitigation: bounded-delay gradient accumulation.

The paper's consistency model (§4.3: push/pull with maximal delay τ; §5.4:
eventual consistency scales linearly because no worker ever waits) applied
to synchronous training: instead of a hard barrier on the slowest data
shard, the optimizer may apply a step once ≥ (1−ε) of shard gradients have
arrived, folding late gradients into the next step with a staleness weight.

On one host we *simulate* shard arrival order to test the numerics; on a
real fleet the same accumulator sits behind per-shard async collectives.
This is the distributed-optimization analogue of DBPG's τ-delay [19].

A copy of ``repro.runtime.straggler``: the accumulator runs over a tensor
or a nested dict/list/tuple of tensors (``tree.tree_map``), and
``StragglerEWMA`` is the reference's numpy class unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tree import tree_map

__all__ = ["StragglerConfig", "BoundedDelayAccumulator", "StragglerEWMA"]


@dataclasses.dataclass
class StragglerConfig:
    num_shards: int = 8
    quorum: float = 0.75        # fraction of shards required to step
    max_delay: int = 2          # τ: max staleness (steps) before a hard wait
    stale_decay: float = 0.5    # weight multiplier per step of staleness


class BoundedDelayAccumulator:
    """Accumulates per-shard gradients; steps on quorum; folds stragglers in
    later with decayed weight; hard-syncs any shard older than τ."""

    def __init__(self, cfg: StragglerConfig, grad_like):
        self.cfg = cfg
        self.zero = tree_map(torch.zeros_like, grad_like)
        self.pending = tree_map(torch.zeros_like, grad_like)
        self.last_seen = np.zeros(cfg.num_shards, dtype=np.int64)
        self.step = 0

    def submit(self, shard: int, grads, arrived_step: int):
        staleness = max(0, self.step - arrived_step)
        if staleness > self.cfg.max_delay:
            staleness = self.cfg.max_delay  # hard-sync clamp
        w = self.cfg.stale_decay ** staleness
        self.pending = tree_map(lambda a, g: a + w * g, self.pending, grads)
        self.last_seen[shard] = self.step

    def ready(self, arrived: int) -> bool:
        if arrived >= int(np.ceil(self.cfg.quorum * self.cfg.num_shards)):
            # τ guard: nobody may lag more than max_delay steps
            return bool(np.all(self.step - self.last_seen <= self.cfg.max_delay))
        return False

    def take(self, arrived: int):
        scale = 1.0 / max(arrived, 1)
        out = tree_map(lambda a: a * scale, self.pending)
        self.pending = self.zero
        self.step += 1
        return out


class StragglerEWMA:
    """EWMA of per-worker scan times → block-assignment weights.

    The elastic stream composes this with the bounded-delay model above:
    instead of letting a slow worker accumulate staleness toward the τ
    clamp, the scheduler *prevents* the lag by handing it fewer blocks —
    ``weights()`` are inverse-EWMA speeds, consumed by
    ``_run_parallel_packed_scan(worker_weights=...)``.  ``floor`` bounds
    how far a worker can be starved (a 10× straggler still gets ≥ floor ×
    its fair share), so a recovered worker keeps receiving enough blocks
    for its EWMA to re-converge instead of being written off forever.
    """

    def __init__(self, workers: int, alpha: float = 0.3,
                 floor: float = 0.1):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not 0.0 < floor <= 1.0:
            raise ValueError(f"floor must be in (0, 1], got {floor}")
        self.workers = workers
        self.alpha = alpha
        self.floor = floor
        self._ewma = np.zeros(workers, np.float64)   # lazy-seeded
        self._seen = np.zeros(workers, bool)

    def update(self, times: np.ndarray) -> None:
        """Fold one round of per-worker wall-clock times (seconds; NaN or
        ≤0 entries mean "no observation this round" and are skipped)."""
        times = np.asarray(times, np.float64)
        if times.shape != (self.workers,):
            raise ValueError(
                f"times must have shape ({self.workers},), got {times.shape}")
        ok = np.isfinite(times) & (times > 0)
        fresh = ok & ~self._seen
        self._ewma[fresh] = times[fresh]             # seed from first sample
        cont = ok & self._seen
        self._ewma[cont] += self.alpha * (times[cont] - self._ewma[cont])
        self._seen |= ok

    def weights(self) -> np.ndarray:
        """Per-worker speed weights (mean 1): inverse EWMA time, floored
        at ``floor`` × the fair share.  Workers never observed yet get the
        observed mean speed (no penalty before evidence)."""
        w = np.ones(self.workers, np.float64)
        if self._seen.any():
            speed = 1.0 / self._ewma[self._seen]
            w[self._seen] = speed / speed.mean()
        w = np.maximum(w, self.floor)
        return w / w.mean()
