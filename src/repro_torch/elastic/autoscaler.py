"""Closed-loop SLO autoscaler: the policy layer over elastic mechanisms.

The elastic session supplies the *mechanisms* — grow/shrink/repair/
straggler bias — gated by a byte-budget ``ThresholdPolicy``; on their own
a kill or load burst is survived by mechanism, not by a controller holding
a user-facing SLO.  ``SLOAutoscaler`` closes that gap: it implements the
same
``ElasticPolicy`` protocol (so an ``ElasticSession`` constructed with it
consults the autoscaler before committing any move), but decides from
*windowed serving telemetry* rather than byte budgets:

  * **grow** on sustained SLO violation — ``patience`` consecutive
    decision windows with modeled sliding-window p99 over ``slo_ms``;
    the split target is the hottest part by live popcount footprint
    (``TelemetrySnapshot.hot_part``), because serving traffic scales
    with the max per-machine footprint (objective (6));
  * **shrink** on sustained underutilization — ``shrink_patience``
    windows with p99 under ``shrink_p99_frac × SLO`` *and* every NIC
    backlog under ``shrink_occupancy`` seconds;
  * **repair** immediately on circuit-open — not here but in the serving
    source's end-of-slot hook (``PSRequestSource.after_slot``), because
    a dead shard must not wait for the next decision window; the
    autoscaler records the repair (``note_repair``) for the audit trail;
  * **rebalance** on EWMA drift — when the slowest machine's telemetry
    speed falls below ``1/drift_ratio`` of the mean, the decision hands
    the speed weights to the router's weighted round-robin so slow
    machines see proportionally fewer requests.

Decisions from sampled/windowed observations rather than exact global
state is justified by the randomized-assignment guarantees the paper
builds on (arXiv:1502.02606): the windowed p99 concentrates around the
true tail as long as windows span enough requests.

Every ``decide`` call appends ``(snapshot, decision)`` to ``decisions``;
committed elastic ops additionally carry the triggering snapshot in
``ElasticOp.telemetry`` — together they make a seeded ``ChaosSchedule``
replay auditable and bit-deterministic end to end.

A copy of ``repro.elastic.autoscaler``: pure host logic over the port's
``FleetState`` and ``TelemetrySnapshot``.  With ``SLOConfig.obs`` set each
decision is also recorded in the flight recorder (``decision`` events).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .policy import FleetState

__all__ = ["SLOConfig", "AutoscaleDecision", "SLOAutoscaler"]


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Knobs of the closed loop.  All counting is in *decision windows*
    (one per ``decide_every`` engine slots), not requests."""

    slo_ms: float                    # the p99 latency target (modeled ms)
    window_requests: int = 64        # telemetry sliding-window size
    decide_every: int = 16           # engine slots between decisions
    warmup_windows: int = 2          # windows before the loop may act
    patience: int = 2                # hot windows before a grow
    shrink_patience: int = 4         # cold windows before a shrink
    cooldown_windows: int = 2        # windows to hold after any op
    shrink_p99_frac: float = 0.4     # cold: p99 < frac × SLO ...
    shrink_occupancy_s: float = 0.01  # ... and every backlog under this
    min_k: int = 2
    max_k: int = 64
    drift_ratio: float = 2.0         # slowest/mean speed gap → rebalance
    tau_escalation: int = 8          # engine slots of widened staleness
    # observability hook (repro_torch.obs.Observability); excluded from
    # equality/hash so configs stay comparable and frozen-hashable
    obs: object = dataclasses.field(default=None, compare=False,
                                    repr=False)

    def __post_init__(self):
        if self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms}")
        if self.decide_every < 1:
            raise ValueError(
                f"decide_every must be >= 1, got {self.decide_every}")
        if self.patience < 1 or self.shrink_patience < 1:
            raise ValueError("patience knobs must be >= 1")
        if not 1 <= self.min_k <= self.max_k:
            raise ValueError(
                f"need 1 <= min_k <= max_k, got ({self.min_k}, "
                f"{self.max_k})")
        if not 0.0 < self.shrink_p99_frac < 1.0:
            raise ValueError(
                f"shrink_p99_frac must be in (0, 1), got "
                f"{self.shrink_p99_frac}")
        if self.drift_ratio <= 1.0:
            raise ValueError(
                f"drift_ratio must be > 1, got {self.drift_ratio}")


@dataclasses.dataclass(frozen=True)
class AutoscaleDecision:
    """One decision-window outcome, paired with its snapshot in
    ``SLOAutoscaler.decisions``."""

    action: str          # "hold" | "grow" | "shrink" | "rebalance"
    target: int = -1     # grow: part to split; rebalance/hold: unused
    reason: str = ""


class SLOAutoscaler:
    """``ElasticPolicy`` whose grow/shrink consent is armed by its own
    ``decide`` loop.

    The two roles compose: the serving source calls ``decide(snapshot)``
    each decision window; when the decision is grow/shrink the source
    calls ``approve(action)`` and then the session's ``grow_k``/
    ``shrink_k`` — whose policy consult (``self.policy.grow(state)``)
    lands back here and succeeds exactly once for the armed action.  Any
    *other* caller asking the session to grow/shrink while no decision is
    armed is refused, so the autoscaler genuinely owns elasticity."""

    def __init__(self, config: SLOConfig):
        self.config = config
        self.obs = config.obs
        self.decisions: list[tuple[object, AutoscaleDecision]] = []
        self.repairs: list[tuple[object, int]] = []
        self._hot = 0          # consecutive over-SLO windows
        self._cold = 0         # consecutive underutilized windows
        self._cooldown = 0     # windows left to hold after an op
        self._windows = 0      # decision windows seen
        self._pending: str | None = None

    # ------------------------------------------------- ElasticPolicy
    @property
    def min_partitions(self) -> int:
        return self.config.min_k

    @property
    def max_partitions(self) -> int:
        return self.config.max_k

    def approve(self, action: str) -> None:
        """Arm one pending action; the next matching policy consult
        consumes it (single-shot consent)."""
        if action not in ("grow", "shrink"):
            raise ValueError(f"cannot approve {action!r}")
        self._pending = action

    def grow(self, state: FleetState) -> bool:
        if self._pending == "grow" and state.k < self.config.max_k:
            self._pending = None
            return True
        return False

    def shrink(self, state: FleetState) -> bool:
        if self._pending == "shrink" and state.k > self.config.min_k:
            self._pending = None
            return True
        return False

    def repair(self, state: FleetState) -> str:
        return "warm"   # circuit-open repair must be fast: always §4.4

    def rebalance(self, state: FleetState,
                  weights: np.ndarray) -> np.ndarray | None:
        return weights

    # ------------------------------------------------- the closed loop
    def note_repair(self, snapshot, machine: int) -> None:
        """Record a circuit-open repair the serving source executed; the
        loop holds one cooldown so the repaired fleet's window drains
        before the next grow/shrink."""
        self.repairs.append((snapshot, machine))
        self._cooldown = max(self._cooldown,
                             self.config.cooldown_windows)
        self._hot = self._cold = 0

    def decide(self, snap) -> AutoscaleDecision:
        """Fold one decision window; returns the action to take."""
        cfg = self.config
        self._windows += 1
        decision = AutoscaleDecision("hold")
        if self._windows <= cfg.warmup_windows or snap.window == 0:
            decision = AutoscaleDecision("hold", reason="warmup")
        elif self._cooldown > 0:
            self._cooldown -= 1
            decision = AutoscaleDecision("hold", reason="cooldown")
        else:
            p99 = snap.p99_ms
            if p99 > cfg.slo_ms:
                self._hot += 1
                self._cold = 0
            elif (p99 < cfg.shrink_p99_frac * cfg.slo_ms
                  and snap.max_occupancy < cfg.shrink_occupancy_s):
                self._cold += 1
                self._hot = 0
            else:
                self._hot = self._cold = 0
            if self._hot >= cfg.patience and snap.k < cfg.max_k:
                decision = AutoscaleDecision(
                    "grow", target=snap.hot_part,
                    reason=f"p99 {p99:.1f}ms > SLO {cfg.slo_ms:.1f}ms "
                           f"for {self._hot} windows")
                self._hot = 0
                self._cooldown = cfg.cooldown_windows
            elif self._cold >= cfg.shrink_patience and snap.k > cfg.min_k:
                decision = AutoscaleDecision(
                    "shrink",
                    reason=f"p99 {p99:.1f}ms < "
                           f"{cfg.shrink_p99_frac:.0%} of SLO and idle "
                           f"NICs for {self._cold} windows")
                self._cold = 0
                self._cooldown = cfg.cooldown_windows
            elif snap.speeds and min(snap.speeds) * cfg.drift_ratio < 1.0:
                decision = AutoscaleDecision(
                    "rebalance",
                    reason=f"slowest machine at "
                           f"{min(snap.speeds):.2f}x mean speed")
        self.decisions.append((snap, decision))
        if self.obs is not None:
            self.obs.record(
                "decision", step=snap.step,
                window=len(self.decisions) - 1, action=decision.action,
                target=decision.target, reason=decision.reason,
                p99_ms=float(snap.p99_ms), k=snap.k)
        return decision
