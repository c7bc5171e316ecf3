"""Request-driven PS serving engine: the paper's end-to-end loop, served.

The engine drives k ``PSCluster`` shards through batched
pull → compute → push steps for a multi-tenant request mix.  One request
is one batched step on its *home* worker:

  pull    — the request's working set (the features its example rows
            touch), value-delta cached, priced per source link by the
            ``BandwidthModel`` and issued as a non-blocking
            ``PullHandle`` (the device future from ``ml/ps.py``);
  compute — margins/loss, smooth gradient, and the masked proximal update
            on the worker's (≤ τ stale) weight view — the DBPG step,
            served, as plain tensor code on the cluster's device;
  push    — gradient entries metered to their owning servers (key
            caching, compression — ``PSCluster.meter_push``), then the
            update commits.

In async mode (``prefetch=True``) the engine issues request t+1's pull
*before* blocking on request t's — double buffering, so the next
transfer ticks behind the current compute.  The buffered view is then
one commit stale: τ = 1, the §4.3 bounded-delay model.  Overlap is
measured, never assumed: ``PullHandle.block()`` sleeps out only the
transfer time still outstanding and a synchronize of the output's device
closes the compute, so ``blocked_s`` vs ``wire_s`` is wall-clock evidence.

Fault handling composes the existing layers: a ``ChaosSchedule`` kills /
straggles shards mid-serve; a source link that cannot deliver within its
``RetryPolicy`` deadlines is dropped for the step and the worker serves
from its stale buffer (bounded-staleness fallback).  The per-link
``CircuitBreaker`` (``runtime.fault``) opens after the first burnt
budget — the link is skipped at zero cost — and *half-opens* after a
cooldown: one trial pull probes the link, so a recovered shard returns
to direct serving without operator intervention.  With an
``ElasticSession`` attached, kills trigger a warm repair whose new
placement reaches the router through ``PSCluster.placement_version``.

Closed-loop mode attaches an ``SLOAutoscaler``: the source keeps a
*virtual clock* — ``vtime`` advances ``service_model_s`` per engine slot,
and a second, virtual ``LinkClock`` books every pull/push on it — so each
request has a deterministic modeled latency (wire + queue + retry penalty
+ service time) independent of wall-clock jitter.  A ``TelemetryBus``
windows those latencies; every ``decide_every`` slots the autoscaler reads
a snapshot and may grow / shrink / repair / rebalance through the elastic
session, with each committed op followed by ``tau_escalation`` slots of
fully-stale serving (widened §4.3 staleness while the migration settles).
Under overload the engine degrades instead of falling over:
``max_backlog_s`` bounds each home's virtual NIC backlog, shedding
lowest-weight tenants first (the threshold scales with tenant weight) with
every drop metered per tenant.  Decisions replay bit-identically because
nothing they read comes from the wall clock.

With an ``Observability`` hook (``ServingConfig.obs`` or the autoscaler's
``SLOConfig.obs``) the engine runs under ``tracer.installed()``: each
request is a ``request → pull(wire/retry/queue)/compute/push`` span tree
at modeled offsets, and the flight recorder receives the ``chaos``,
``elastic_op``, ``window``, ``shed`` and ``breaker_open``/``breaker_close``
events ``explain()`` attributes.

A port of ``repro/serving/engine.py``.  One numpy generator
(``default_rng(config.seed)``) feeds the tenant draw, then the row sample,
of every request, as in the reference; the pulls, meters and clocks are
host numpy, the compute runs on the cluster's device (the card unless the
cluster was built with ``device="cpu"``).  The reference labels each
compute dispatch ``cache_miss`` from its jit cache; the port compiles
nothing per shape and adds no such label.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.dispatch import _count_dispatch
from ..ml.dbpg import soft_threshold
from ..ml.lr import SparseBatch, _grad_from_margins, _margins, batch_columns
from ..ml.ps import PSCluster
from ..runtime.fault import CircuitBreaker, RetryPolicy
from .latency import BandwidthModel, LatencyRecorder, LinkClock, RequestRecord
from .prefetch import OverlapMeter
from .router import Router
from .telemetry import TelemetryBus

__all__ = ["Request", "ZipfWorkload", "RequestMix", "ServingConfig",
           "PSRequestSource", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ZipfWorkload:
    """One tenant: Zipf-skewed batches against its home shard's rows."""

    name: str
    batch: int = 256
    zipf_s: float = 1.1
    hot_offset: int = 0      # rotates the pool: distinct hot set per tenant
    weight: float = 1.0

    def __post_init__(self):
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")


@dataclasses.dataclass(frozen=True)
class RequestMix:
    """Weighted tenant mix; ``sample`` draws the next request's tenant."""

    workloads: tuple[ZipfWorkload, ...]

    def __post_init__(self):
        if not self.workloads:
            raise ValueError("need at least one workload")

    def sample(self, rng: np.random.Generator) -> ZipfWorkload:
        w = np.array([wl.weight for wl in self.workloads])
        return self.workloads[int(rng.choice(len(self.workloads),
                                             p=w / w.sum()))]


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    prefetch: bool = True          # async double-buffered pulls
    bandwidth: float | None = None  # None → the cluster's modeled link
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    update: bool = True            # online DBPG update per request
    warmup: int = 3                # requests excluded from the stats
    pad_multiple: int = 2048       # nnz pad bucket of a request's batch
    seed: int = 0
    # --- closed-loop knobs; the defaults serve open loop ----------------
    service_model_s: float = 2e-3  # virtual-clock arrival interval / slot
    max_backlog_s: float | None = None  # admission bound (None = off)
    tau_escalation: int = 0        # fully-stale slots after an elastic op
    breaker_cooldown_s: float = 0.05    # circuit half-open probe delay
    breaker_max_cooldown_s: float = 2.0  # decorrelated-jitter backoff cap
    window_requests: int | None = None  # recorder sliding-window size
    # observability hook (repro_torch.obs.Observability); None = off —
    # every instrumented site is behind an `obs is None` check.  Excluded
    # from equality/hash so the frozen config stays comparable.
    obs: object = dataclasses.field(default=None, compare=False,
                                    repr=False)


@dataclasses.dataclass
class Request:
    tenant: str
    home: int
    rows: object              # the example rows (None for LM decode)
    batch: object             # their SparseBatch (None for LM decode)
    need: object              # (V,) bool working set (None for LM decode)
    examples: int
    tokens: int               # nnz processed (LM decode: the batch)


def _serve_step(batch: SparseBatch, w: torch.Tensor, need: torch.Tensor,
                lr: float, lam: float, update: bool):
    """One served DBPG step: loss + smooth gradient + masked prox update.

    The update touches only the request's working set — the server slice
    semantics of ``PSCluster.step`` restricted to the coordinates this
    worker may push.  ``w`` (the pulled buffer) is read, never written."""
    m = _margins(batch, w)
    loss = torch.sum(torch.logaddexp(torch.zeros_like(m), -m))
    g = _grad_from_margins(batch, m)
    if update:
        new_w = torch.where(need, soft_threshold(w - lr * g, lr * lam), w)
    else:
        new_w = w
    return new_w, g, loss


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class PSRequestSource:
    """Generates, prices, and commits PS requests for the engine, on the
    cluster's device."""

    def __init__(self, cluster: PSCluster, mix: RequestMix,
                 config: ServingConfig | None = None, chaos=None,
                 elastic=None, autoscaler=None, telemetry=None):
        self.cluster = cluster
        self.mix = mix
        self.config = config if config is not None else ServingConfig()
        self.chaos = chaos
        self.elastic = elastic
        self.autoscaler = autoscaler
        self.router = Router(cluster)
        self.bw = BandwidthModel(self.config.bandwidth
                                 if self.config.bandwidth is not None
                                 else cluster.bandwidth)
        self.rng = np.random.default_rng(self.config.seed)
        self.link = LinkClock(cluster.k)      # wall-clock NIC bookings
        self.vlink = LinkClock(cluster.k)     # virtual-clock NIC bookings
        self.vtime = 0.0                      # deterministic request clock
        self.straggle = np.ones(cluster.k, np.float64)
        self.dead: set[int] = set()
        self.suspect: set[int] = set()   # links past their retry budget
        self.breaker = CircuitBreaker(
            cluster.k, cooldown_s=self.config.breaker_cooldown_s,
            max_cooldown_s=self.config.breaker_max_cooldown_s,
            seed=self.config.seed)
        self.load_factor = 1.0                # burst batch multiplier
        self.events: list[tuple[int, str, int]] = []
        self._pending_repairs: set[int] = set()
        self._tau_until = -1                  # τ-escalation deadline (slot)
        if autoscaler is not None and telemetry is None:
            telemetry = TelemetryBus(
                cluster.k,
                window_requests=autoscaler.config.window_requests)
        self.telemetry: TelemetryBus | None = telemetry
        obs = self.config.obs
        if obs is None and autoscaler is not None:
            obs = getattr(autoscaler.config, "obs", None)
        self.obs = obs
        if obs is not None and elastic is not None:
            elastic.obs = obs   # one hook covers the whole closed loop

    @property
    def device(self) -> torch.device:
        return self.cluster.device

    # ----------------------------------------------------------- chaos
    def on_step(self, t: int) -> None:
        # the virtual clock: requests arrive every service_model_s, full
        # stop — nothing downstream of a decision reads the wall clock
        self.vtime = t * self.config.service_model_s
        if self.obs is not None:
            self.obs.tracer.set_time(self.vtime)
        if self.chaos is None:
            return
        for ev in self.chaos.at(t):
            self._apply_event(ev, t)

    def _apply_event(self, ev, t: int) -> None:
        k = self.cluster.k
        if ev.kind == "kill":
            m = ev.machine % k
            if self.elastic is not None and self.autoscaler is None:
                # warm repair under load: re-place, re-shard the cluster,
                # and let the router pick it up via placement_version
                op = self.elastic.repair(m)
                self._sync_placement(op)
                self._sync_fleet()
                self.dead.discard(m)
                self.suspect.discard(m)
                self.breaker.reset(m)
                self._record_op(op, t)
            else:
                # closed loop (or no elastic): the controller discovers
                # the loss through its own circuit breaker and repairs
                self.dead.add(m)
        elif ev.kind == "add":
            if self.elastic is not None:
                op = self.elastic.grow_k(force=True)
                self._sync_placement(op)
                self._sync_fleet()
                self._record_op(op, t)
        elif ev.kind == "straggle":
            self.straggle[ev.machine % k] = ev.factor
        elif ev.kind == "recover":
            m = ev.machine % k
            self.straggle[m] = 1.0
            self.dead.discard(m)
            # deliberately NOT closing the circuit here: the half-open
            # probe must rediscover the link — that's the honest path a
            # real fleet has (nobody tells serving the shard came back)
        elif ev.kind == "burst":
            self.load_factor = float(ev.factor)
        m = -1 if ev.machine is None else ev.machine % max(k, 1)
        self.events.append((t, ev.kind, m))
        if self.obs is not None:
            self.obs.record(
                "chaos", step=t, v=self.vtime,
                data={"kind": ev.kind,
                      "machine": None if ev.machine is None else m,
                      "factor": getattr(ev, "factor", None)})

    def _record_op(self, op, t: int) -> None:
        """Put one elastic op on the flight-recorder timeline, with its
        triggering telemetry snapshot when the closed loop supplied one."""
        if self.obs is None or op is None:
            return
        traffic = getattr(op, "traffic", None)
        data = {"kind": op.kind, "committed": bool(op.committed),
                "machine": op.machine, "k_before": op.k_before,
                "k_after": op.k_after, "moved_u": int(op.moved_u),
                "mode": op.mode,
                "migration_bytes": (int(traffic.migration_bytes)
                                    if traffic is not None else 0)}
        snap = getattr(op, "telemetry", None)
        if snap is not None:
            data["trigger_p99_ms"] = float(snap.p99_ms)
            data["trigger_step"] = int(snap.step)
        self.obs.record("elastic_op", step=t, v=self.vtime, data=data)

    def _sync_fleet(self) -> None:
        k = self.cluster.k
        if self.straggle.shape[0] < k:
            self.straggle = np.concatenate(
                [self.straggle, np.ones(k - self.straggle.shape[0])])
        else:
            self.straggle = self.straggle[:k]
        self.link.resize(k)
        self.vlink.resize(k)
        self.breaker.resize(k)
        if self.telemetry is not None:
            self.telemetry.resize(k)
        self.dead = {m for m in self.dead if m < k}
        self.suspect = {m for m in self.suspect if m < k}
        self._pending_repairs = {m for m in self._pending_repairs if m < k}
        self.router.refresh(self.cluster)

    def _sync_placement(self, op=None) -> dict:
        """Push the elastic placement into the cluster *preserving* weight
        ownership: ``ElasticSession.sync_cluster``'s default re-stripes
        ``parts_v`` round-robin, which would destroy the feature locality
        the partitioner bought.  Instead the current owners are remapped
        per op — shrink retires machine ``op.partner`` into ``op.machine``;
        grow moves the features the split handed to the new machine
        (present in its packed mask, absent from the shrunk source's: one
        host copy of the session's live sets per committed grow)."""
        cluster = self.cluster
        owner = cluster.owner.copy().astype(np.int32)
        if op is not None and getattr(op, "committed", False):
            if op.kind == "shrink" and op.partner >= 0:
                j = op.partner
                owner[owner == j] = op.machine
                owner[owner > j] -= 1
            elif op.kind == "grow" and op.partner >= 0:
                from ..kernels.parsa_cost import unpack_bitmask
                masks = self.elastic.stream.arena.masks_np(logical=False)
                num_v = cluster.graph.num_v
                pair = unpack_bitmask(
                    masks[[op.machine, op.partner]], num_v)
                move = (owner == op.machine) & pair[1] & ~pair[0]
                owner[move] = op.partner
        owner = np.minimum(owner, self.elastic.k - 1)
        return self.elastic.sync_cluster(cluster, parts_v=owner)

    # -------------------------------------------------------- requests
    def next_request(self, t: int) -> Request:
        self.router.refresh(self.cluster)
        wl = self.mix.sample(self.rng)
        home = self.router.next_home(self.dead)
        batch_size = max(1, int(round(wl.batch * self.load_factor)))
        rows = self.router.sample_rows(home, batch_size, self.rng,
                                       zipf_s=wl.zipf_s,
                                       hot_offset=wl.hot_offset)
        g = self.cluster.graph
        _, cols = batch_columns(g, rows)
        nnz = int(cols.shape[0])
        pad = self.config.pad_multiple
        pad_to = max(pad, -(-nnz // pad) * pad)
        batch = SparseBatch.from_graph(g, rows, self.cluster._labels,
                                       pad_to=pad_to, device=self.device)
        need = np.zeros(g.num_v, bool)
        need[cols] = True
        return Request(tenant=wl.name, home=home, rows=rows, batch=batch,
                       need=need, examples=rows.size, tokens=nnz)

    # ------------------------------------------------------- admission
    def admit(self, req: Request) -> bool:
        """Bounded per-home queue: shed when the home's *virtual* NIC
        backlog exceeds ``max_backlog_s`` scaled by the tenant's relative
        weight — so as backlog climbs, the lowest-weight tenants are shed
        first and the heaviest tenant holds out to the full bound.
        Decided AFTER ``next_request`` so generator consumption is
        identical with and without shedding (determinism contract)."""
        limit = self.config.max_backlog_s
        if limit is None:
            return True
        weights = {wl.name: wl.weight for wl in self.mix.workloads}
        wmax = max(weights.values())
        scaled = limit * weights.get(req.tenant, wmax) / wmax
        return self.vlink.backlog(req.home, self.vtime) <= scaled

    def note_shed(self, req: Request) -> None:
        if self.telemetry is not None:
            self.telemetry.observe_shed(req.tenant)
        if self.obs is not None:
            step = int(round(self.vtime / self.config.service_model_s))
            self.obs.record(
                "shed", step=step, v=self.vtime, tenant=req.tenant,
                home=req.home,
                backlog_s=float(self.vlink.backlog(req.home, self.vtime)))

    def issue(self, req: Request, t: int):
        """Price and issue the request's pull; returns a ``PullHandle``.

        With obs attached, opens the ``request`` root span (pushed on the
        tracer stack so the PS/dispatch instants emitted inside nest under
        it); the span's children are finalized retrospectively in
        ``ServingEngine._serve_one`` from the handle's modeled breakdown.
        """
        if self.obs is None:
            return self._issue(req, t)
        tracer = self.obs.tracer
        sp = tracer.begin("request", v_start=self.vtime,
                          track=f"home{req.home}", tenant=req.tenant,
                          step=t, examples=req.examples)
        tracer.push(sp)
        try:
            handle = self._issue(req, t)
        finally:
            tracer.pop()
        handle._span = sp
        return handle

    def _issue(self, req: Request, t: int):
        plan = self.cluster.plan_pull(req.home, need=req.need)
        secs = self.bw.per_source(plan.src_bytes, req.home, self.straggle)
        retry = self.config.retry
        exclude: set[int] = set()
        penalty = 0.0   # timeout clocks run concurrently with the wire
        vnow = self.vtime
        src_times = np.full(self.cluster.k, np.nan)
        escalated = t < self._tau_until
        for j in np.flatnonzero(plan.src_bytes):
            j = int(j)
            if j == req.home:
                continue
            if escalated:
                # widened bounded staleness while a repair/migration is
                # in flight: serve fully stale, burn no retry budgets
                exclude.add(j)
                continue
            if not self.breaker.allow(j, vnow):
                exclude.add(j)       # circuit open: skip at zero cost
                continue
            link_s = float("inf") if j in self.dead else float(secs[j])
            delivered, spent = retry.admit(link_s)
            penalty = max(penalty, spent)
            was_open = (self.obs is not None
                        and self.breaker.state(j) != "closed")
            newly_opened = self.breaker.record(j, delivered, vnow)
            if newly_opened and self.obs is not None:
                self.obs.record("breaker_open", step=t, v=vnow, machine=j)
            if delivered:
                if was_open:
                    self.obs.record("breaker_close", step=t, v=vnow,
                                    machine=j)
                self.suspect.discard(j)
                if plan.src_bytes[j] > 0:
                    # observed delivery slowdown vs the bytes/bandwidth
                    # baseline — the telemetry EWMA's straggle evidence
                    src_times[j] = (secs[j] * self.bw.bandwidth
                                    / float(plan.src_bytes[j]))
            else:
                # retry budget exhausted: bounded-staleness fallback —
                # this source's entries stay stale in the buffer
                exclude.add(j)
                self.suspect.add(j)
                if newly_opened and self.autoscaler is not None:
                    # repair cue: the closed loop replaces the shard at
                    # the end of this slot instead of waiting for an op
                    self._pending_repairs.add(j)
        wire = self.bw.ingress_seconds(plan.src_bytes, req.home,
                                       self.straggle, exclude)
        # deterministic queueing: the virtual link clock accumulates the
        # modeled backlog the autoscaler and admission control act on
        vdone = self.vlink.acquire(req.home, vnow, wire)
        vqueue = vdone - vnow - wire
        # wall-clock booking mirrors it: a still-draining push (or a
        # previous pull) pushes this transfer's completion out for real
        now = time.perf_counter()
        done = self.link.acquire(req.home, now, wire)
        _count_dispatch("serving_pull", nbytes=int(plan.total_bytes),
                        home=req.home)
        handle = self.cluster.pull_nowait(plan, frozenset(exclude),
                                          wire_s=wire, wait_s=penalty,
                                          queue_s=done - now - wire)
        handle.modeled_s = (wire + penalty + vqueue
                            + self.config.service_model_s)
        handle.vqueue_s = vqueue
        handle._src_times = src_times
        return handle

    def observe_request(self, req: Request, handle, modeled_s: float,
                        measured_s: float) -> None:
        if self.telemetry is None:
            return
        self.telemetry.observe(modeled_s, measured_s,
                               getattr(handle, "_src_times", None))

    # ------------------------------------------------------ closed loop
    def _snapshot(self, t: int):
        k = self.cluster.k
        return self.telemetry.snapshot(
            step=t,
            occupancy=[self.vlink.backlog(m, self.vtime)
                       for m in range(k)],
            footprint=self.cluster.need.sum(axis=1),
            sizes=[r.size for r in self.cluster.rows],
            open_circuits=self.breaker.open_links(),
            load_factor=self.load_factor)

    def _commit_op(self, op, t: int) -> None:
        self._sync_placement(op)
        self._sync_fleet()
        self._tau_until = t + 1 + self.config.tau_escalation

    def after_slot(self, t: int) -> None:
        """End-of-slot hook: immediate repair on circuit-open, then (every
        ``decide_every`` slots) one autoscaler decision."""
        if (self.elastic is not None and self.telemetry is not None
                and self._pending_repairs):
            for m in sorted(self._pending_repairs):
                if m >= self.cluster.k or m not in self.dead:
                    continue
                snap = self._snapshot(t)
                op = self.elastic.repair(m)
                op.telemetry = snap
                self._commit_op(op, t)
                self._record_op(op, t)
                self.breaker.reset(m)
                self.suspect.discard(m)
                self.dead.discard(m)
                if self.autoscaler is not None:
                    self.autoscaler.note_repair(snap, m)
            self._pending_repairs.clear()
        if self.autoscaler is None or self.telemetry is None:
            return
        if (t + 1) % self.autoscaler.config.decide_every:
            return
        snap = self._snapshot(t)
        decision = self.autoscaler.decide(snap)
        if self.obs is not None:
            slo = getattr(self.autoscaler.config, "slo_ms", None)
            self.obs.record(
                "window", step=t, v=self.vtime,
                window=len(self.autoscaler.decisions) - 1,
                p99_ms=float(snap.p99_ms),
                slo_ms=None if slo is None else float(slo),
                within=(slo is None or snap.p99_ms <= slo),
                action=decision.action, reason=decision.reason,
                k=int(snap.k), load_factor=float(snap.load_factor))
        if decision.action == "grow" and self.elastic is not None:
            self.autoscaler.approve("grow")
            op = self.elastic.grow_k(target=decision.target)
            op.telemetry = snap
            if op.committed:
                self._commit_op(op, t)
            self._record_op(op, t)
        elif decision.action == "shrink" and self.elastic is not None:
            self.autoscaler.approve("shrink")
            op = self.elastic.shrink_k()
            op.telemetry = snap
            if op.committed:
                self._commit_op(op, t)
            self._record_op(op, t)
        elif decision.action == "rebalance":
            self.router.set_weights(np.asarray(snap.speeds))

    # --------------------------------------------------------- serving
    def compute(self, req: Request, payload: torch.Tensor):
        cfg = self.cluster.cfg
        _count_dispatch("serving_compute", nbytes=int(payload.nbytes),
                        tokens=req.tokens)
        need = torch.from_numpy(req.need).to(payload.device)
        return _serve_step(req.batch, payload, need, lr=cfg.lr, lam=cfg.lam,
                           update=self.config.update)

    def commit(self, req: Request, out, t: int) -> dict:
        new_w, g, loss = out
        if req.home >= self.cluster.k:
            # the home machine retired mid-flight (an elastic shrink
            # landed between issue and commit): the weight update still
            # applies, but there is no NIC left to meter the push on
            if self.config.update:
                self.cluster.commit_weights(new_w)
            return {"loss": float(loss), "push_inner_bytes": 0,
                    "push_inter_bytes": 0, "push_wire_s": 0.0}
        mask = req.need & (g != 0).cpu().numpy()
        push = self.cluster.meter_push(req.home, mask)
        # push is fire-and-forget (the τ model absorbs its latency) but
        # still drains real bandwidth: book the home NIC so the machine's
        # next pull queues behind it instead of pretending it was free
        push_wire = (push["inter_bytes"] / self.bw.bandwidth
                     * float(self.straggle[req.home]))
        if push_wire > 0:
            self.link.acquire(req.home, time.perf_counter(), push_wire)
            self.vlink.acquire(req.home, self.vtime, push_wire)
        if self.config.update:
            self.cluster.commit_weights(new_w)
        return {"loss": float(loss),
                "push_inner_bytes": push["inner_bytes"],
                "push_inter_bytes": push["inter_bytes"],
                "push_wire_s": push_wire}


class ServingEngine:
    """The event loop: sync (pull → compute → push per request) or async
    (double-buffered — issue pull t+1, then block on pull t).  Slots the
    admission controller sheds are served as no-ops: the virtual clock
    still advances, so a shed burst drains the backlog it was shed for."""

    def __init__(self, source, prefetch: bool | None = None,
                 warmup: int | None = None):
        self.source = source
        src_cfg = getattr(source, "config", None)
        self.prefetch = (src_cfg.prefetch if prefetch is None and src_cfg
                         else bool(prefetch))
        self.warmup = (src_cfg.warmup if warmup is None and src_cfg
                       else int(warmup or 0))
        self.recorder = LatencyRecorder(
            window_requests=getattr(src_cfg, "window_requests", None))
        self.overlap = OverlapMeter()
        self.obs = (getattr(source, "obs", None)
                    or getattr(src_cfg, "obs", None))

    def _produce(self, t):
        """Generate + admit + issue slot ``t``; ``None`` when shed."""
        src = self.source
        src.on_step(t)
        req = src.next_request(t)
        admit = getattr(src, "admit", None)
        if admit is not None and not admit(req):
            self.recorder.add_shed(req.tenant)
            note = getattr(src, "note_shed", None)
            if note is not None:
                note(req)
            return None
        return (req, src.issue(req, t))

    def run(self, num_requests: int) -> dict:
        if self.obs is None:
            return self._run_loop(num_requests)
        # installed for the run: the deep layers (PS pulls, router
        # refreshes, dispatches) emit instants into this tracer without
        # holding a reference to it
        with self.obs.tracer.installed():
            return self._run_loop(num_requests)

    def _run_loop(self, num_requests: int) -> dict:
        rec, meter = self.recorder, self.overlap
        after = getattr(self.source, "after_slot", None)
        wall0 = None
        cur = self._produce(0) if self.prefetch and num_requests > 0 else None
        for t in range(num_requests):
            if t == self.warmup:
                wall0 = time.perf_counter()
            if self.prefetch:
                # double buffer: issue pull t+1 BEFORE blocking on pull t —
                # its wire time ticks behind this step's compute; the view
                # it returns is ≤ 1 commit stale
                nxt = (self._produce(t + 1)
                       if t + 1 < num_requests else None)
            else:
                cur = self._produce(t)
            if cur is not None:
                req, handle = cur
                self._serve_one(req, handle, t, rec, meter)
            if after is not None:
                after(t)
            if self.prefetch:
                cur = nxt
        wall_s = (time.perf_counter() - wall0) if wall0 is not None else 0.0
        out = rec.summary(wall_s=wall_s)
        out["mode"] = "async" if self.prefetch else "sync"
        out["overlap"] = meter.as_dict()
        return out

    def _serve_one(self, req, handle, t, rec, meter) -> None:
        src = self.source
        tb = time.perf_counter()
        payload = handle.block()
        blocked = time.perf_counter() - tb
        tc = time.perf_counter()
        out = src.compute(req, payload)
        _synchronize(out)
        compute = time.perf_counter() - tc
        stats = src.commit(req, out, t)
        end = time.perf_counter()
        queue = getattr(handle, "queue_s", 0.0)
        measured = end - handle.issued_at
        modeled = getattr(handle, "modeled_s",
                          handle.wire_s + handle.wait_s + queue)
        rec.add(RequestRecord(
            tenant=req.tenant, step=t, home=req.home,
            examples=req.examples, tokens=req.tokens,
            latency_s=measured,
            wire_s=handle.wire_s, wait_s=handle.wait_s,
            blocked_s=blocked, compute_s=compute,
            fresh_entries=handle.fresh_entries,
            stale_entries=handle.stale_entries,
            pull_inter_bytes=handle.inter_bytes,
            push_inter_bytes=stats.get("push_inter_bytes", 0),
            warmup=t < self.warmup,
            queue_s=queue, modeled_s=modeled))
        observe = getattr(src, "observe_request", None)
        if observe is not None:
            observe(req, handle, modeled, measured)
        sp = getattr(handle, "_span", None)
        if sp is not None:
            self._finish_request_span(sp, handle, stats, blocked, compute,
                                      measured)
        if t >= self.warmup:
            meter.add(handle.wire_s + queue, handle.wait_s, blocked,
                      compute)

    def _finish_request_span(self, sp, handle, stats, blocked, compute,
                             measured) -> None:
        """Finalize the request span opened at issue time: children at
        explicit offsets from the handle's *modeled* breakdown (wire,
        retry penalty, virtual queue, service slot, push wire), measured
        wall times riding along as replay-variant evidence."""
        src_cfg = getattr(self.source, "config", None)
        svc = getattr(src_cfg, "service_model_s", 0.0)
        wire, wait = handle.wire_s, handle.wait_s
        vq = getattr(handle, "vqueue_s", 0.0)
        pull_end = wire + wait + vq
        push_wire = stats.get("push_wire_s", 0.0)
        sp.set(v_dur=pull_end + svc + push_wire, wall_s=measured,
               fresh=handle.fresh_entries, stale=handle.stale_entries)
        pull = sp.child("pull", 0.0, pull_end, wall_s=blocked,
                        inter_bytes=handle.inter_bytes)
        if wire > 0:
            pull.child("wire", 0.0, wire)
        if wait > 0:
            pull.child("retry", wire, wait)
        if vq > 0:
            pull.child("queue", wire + wait, vq)
        sp.child("compute", pull_end, svc, wall_s=compute,
                 loss=stats.get("loss"))
        sp.child("push", pull_end + svc, push_wire,
                 inter_bytes=stats.get("push_inter_bytes", 0))
