"""Fault tolerance: checkpoint/restart with failure injection for
training, and per-link fault handling for the serving pull path.

  * ``TrainLoop`` — steps a train_step with a ``CheckpointManager``;
    resume is exact (tested bitwise on the parameters); failure injection
    raises ``SimulatedFailure`` at a chosen step; a restore may land on
    another device than the save (``TrainLoop(device=...)``), or on
    another mesh (``TrainLoop(mesh=..., specs=...)``, the reference's
    ``shardings=``), because checkpoints store logical arrays;
  * ``RetryPolicy`` — per-link retry/timeout admission: a source shard that
    cannot deliver within its (backed-off) deadlines is dropped for the
    step and the worker falls back to its stale buffer (§4.3 bounded
    staleness) instead of stalling the request.
  * ``CircuitBreaker`` — closed → open → half-open over a retry policy:
    an open link is skipped at zero cost until its cooldown elapses, then
    one trial pull probes it; a failed probe re-opens it with a
    decorrelated-jitter cooldown drawn from a seeded generator.

A port of ``repro.runtime.fault``.  The breaker is plain numpy on the
host, with its draws made from ``np.random.default_rng(seed)`` in the
reference's order, so a seeded replay opens and closes the same circuits
at the same slots.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np

from ..ckpt import CheckpointManager, latest_step, restore_checkpoint

__all__ = ["FaultConfig", "SimulatedFailure", "TrainLoop", "RetryPolicy",
           "CircuitBreaker"]


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    fail_at_step: int | None = None      # failure injection (tests)


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deadline/retry admission for one pull link.

    ``admit(wire_s)`` plays the attempts out against the modeled transfer
    time: each attempt has a deadline (``timeout_s`` growing by
    ``backoff``); an attempt whose transfer fits the deadline delivers and
    the call returns ``(True, wait_s)`` where ``wait_s`` is the time burnt
    on *earlier failed* attempts (the caller adds ``wire_s`` itself).  A
    link that never fits — a killed shard models ``wire_s = inf`` —
    returns ``(False, wait_s)`` with the full timeout budget spent, and
    the caller serves from the stale buffer instead of stalling."""

    timeout_s: float = 0.05
    retries: int = 1
    backoff: float = 2.0

    def __post_init__(self):
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")

    @property
    def budget_s(self) -> float:
        """Total time a fully failing link costs (sum of all deadlines)."""
        return sum(self.timeout_s * self.backoff ** a
                   for a in range(self.retries + 1))

    def admit(self, wire_s: float) -> tuple[bool, float]:
        deadline, wait = self.timeout_s, 0.0
        for _ in range(self.retries + 1):
            if wire_s <= deadline:
                return True, wait
            wait += deadline
            deadline *= self.backoff
        return False, wait


_CB_CLOSED, _CB_OPEN, _CB_HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-link closed → open → half-open circuit over a ``RetryPolicy``.

    A link opens after one burnt retry budget and is then skipped at zero
    cost until ``cooldown_s`` elapses; then exactly one trial pull is
    admitted.  A successful trial closes the circuit (direct serving
    restored); a failed one re-opens it with a *decorrelated-jitter*
    backoff — ``cooldown = min(cap, U(base, 3 × previous))`` from a seeded
    generator, so repeated probes against a still-dead shard spread out
    instead of thundering in lockstep, and replays stay bit-deterministic.

    The clock is caller-supplied (``now``): the serving engine feeds its
    deterministic virtual request clock, so breaker transitions replay
    exactly under a fixed seed regardless of wall-clock jitter.
    """

    def __init__(self, k: int, cooldown_s: float = 0.05,
                 max_cooldown_s: float = 2.0, seed: int = 0):
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        if max_cooldown_s < cooldown_s:
            raise ValueError(
                f"max_cooldown_s must be >= cooldown_s, got "
                f"{max_cooldown_s}")
        self.cooldown_s = cooldown_s
        self.max_cooldown_s = max_cooldown_s
        self.rng = np.random.default_rng(seed)
        self._state = [_CB_CLOSED] * k
        self._until = np.zeros(k, np.float64)     # open expires at
        self._sleep = np.full(k, cooldown_s)      # last cooldown drawn

    @property
    def k(self) -> int:
        return len(self._state)

    def resize(self, k: int) -> None:
        if k > len(self._state):
            grow = k - len(self._state)
            self._state += [_CB_CLOSED] * grow
            self._until = np.concatenate([self._until, np.zeros(grow)])
            self._sleep = np.concatenate(
                [self._sleep, np.full(grow, self.cooldown_s)])
        else:
            self._state = self._state[:k]
            self._until = self._until[:k]
            self._sleep = self._sleep[:k]

    def state(self, link: int) -> str:
        return self._state[link]

    def open_links(self) -> tuple[int, ...]:
        return tuple(i for i, s in enumerate(self._state)
                     if s != _CB_CLOSED)

    def allow(self, link: int, now: float) -> bool:
        """May this link be pulled from right now?  An open link past its
        cooldown transitions to half-open and gets ONE trial admission."""
        s = self._state[link]
        if s == _CB_CLOSED:
            return True
        if s == _CB_OPEN and now >= self._until[link]:
            self._state[link] = _CB_HALF_OPEN
            return True
        return s == _CB_HALF_OPEN and now >= self._until[link]

    def record(self, link: int, delivered: bool, now: float) -> bool:
        """Fold one admitted attempt's outcome; returns True when this
        attempt newly OPENED the circuit (the autoscaler's repair cue)."""
        if delivered:
            self._state[link] = _CB_CLOSED
            self._sleep[link] = self.cooldown_s
            return False
        was_closed = self._state[link] == _CB_CLOSED
        if self._state[link] == _CB_HALF_OPEN:
            # failed probe: decorrelated jitter on the next cooldown
            self._sleep[link] = min(
                self.max_cooldown_s,
                float(self.rng.uniform(self.cooldown_s,
                                       3.0 * self._sleep[link])))
        self._state[link] = _CB_OPEN
        self._until[link] = now + self._sleep[link]
        return was_closed

    def reset(self, link: int) -> None:
        """Force-close one link's circuit (elastic repair replaced the
        shard; the fresh slot deserves direct serving immediately)."""
        self._state[link] = _CB_CLOSED
        self._sleep[link] = self.cooldown_s
        self._until[link] = 0.0


class TrainLoop:
    """Steps ``train_step`` over a batch iterator, saving every
    ``fault.ckpt_every`` steps (async, one save in flight; the tensors are
    copied to the host first, so the next step may update them in place).
    ``device`` picks where ``resume_or`` restores: None restores into the
    tensors ``init_fn`` builds, in place; a device restores onto it.

    Over a mesh (``mesh``, the ``DeviceMesh`` the train step runs over,
    and ``specs``, ``launch.sharding.state_specs(cfg, mesh)``), every
    rank runs the loop on its blocks: a save gathers the logical arrays
    on every rank and rank 0 writes them, the format of a save without a
    mesh; ``resume_or`` restores each rank's blocks of the newest
    checkpoint, whichever mesh wrote it, in place into ``init_fn()``'s;
    the injected failure is raised on every rank at the same step, after
    every rank has met the last save's publish."""

    def __init__(self, train_step: Callable, fault: FaultConfig,
                 device=None, *, mesh=None, specs=None):
        if mesh is not None and (specs is None or device is not None):
            raise ValueError("TrainLoop(mesh=) takes specs= "
                             "(launch.sharding.state_specs) and restores "
                             "in place (no device=)")
        self.train_step = train_step
        self.fault = fault
        self.mgr = CheckpointManager(fault.ckpt_dir, fault.ckpt_every,
                                     fault.keep, mesh=mesh, specs=specs)
        self.device = device
        self.mesh, self.specs = mesh, specs

    def resume_or(self, init_fn: Callable):
        """Restore the newest checkpoint into ``init_fn()``'s structure,
        else initialize fresh: (start step, params, opt state)."""
        step = latest_step(self.fault.ckpt_dir)
        params, opt = init_fn()
        if step is None:
            return 0, params, opt
        state = restore_checkpoint(
            self.fault.ckpt_dir, step, {"params": params, "opt": opt},
            device=self.device, inplace=self.device is None,
            mesh=self.mesh, specs=self.specs)
        return step, state["params"], state["opt"]

    def run(self, params, opt_state, batches, start_step: int = 0,
            log_every: int = 0):
        metrics_hist = []
        step = start_step
        for batch in batches:
            if self.fault.fail_at_step is not None \
                    and step == self.fault.fail_at_step:
                self.mgr.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            step += 1
            self.mgr.maybe_save(step, {"params": params, "opt": opt_state})
            if log_every and step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                metrics_hist.append(m)
                print(f"step {step}: " + " ".join(
                    f"{k}={v:.4g}" for k, v in m.items()))
        self.mgr.wait()
        return params, opt_state, metrics_hist
