"""Fault-tolerant elastic Parsa serving on the card: ``k`` becomes a runtime
variable.

``ElasticSession`` wraps a ``StreamSession`` and makes the fleet mutable
mid-stream, composing primitives the port already ships:

  * ``grow_k`` — split the largest part two ways with the same scan a feed
    uses (ONE ``parsa_scan`` launch over just that part's rows, at k=2
    from empty sets); the new machine takes the second half.
  * ``shrink_k`` — OR-merge the two smallest parts (host lattice join on
    the packed words — no launch) and relabel.
  * ``repair`` — worker-loss recovery that warm-starts from the
    *surviving* packed ``s_masks``: the lost row is zeroed and the lost
    part's vertices are re-assigned in ONE ``parsa_scan`` launch, where
    §4.1 balance naturally refills the emptied slot (its replacement
    machine); ``repartition_frac`` optionally seeds the lost subgraph's
    sample per §4.4.  Cold mode falls through to the stream's full
    ``repartition()`` — the baseline the warm repair is measured against.
  * straggler-aware feeds — a ``StragglerEWMA`` of per-worker scan times
    biases the randomized block→worker assignment away from slow
    workers (``_run_parallel_packed_scan(worker_weights=...)``),
    keeping staleness inside τ instead of reacting to it.

Every mutation is metered in ``TrafficCounters.migration_bytes`` (same
4-bytes-per-32-parameters units as the steady-state counters) and gated
by an ``ElasticPolicy`` that compares the one-time cost against
projected steady-state savings BEFORE committing; uncommitted candidates
leave the live state untouched.  A ``ChaosSchedule`` drives kill/add/
straggle events deterministically through ``feed``.

A port of ``repro.elastic.session``: the same seeded chunks, schedule and
ops give the same parts, sets, sizes, traffic, ``ElasticOp`` records,
dispatch records and trace spans.  The scans update their carried sets
in place (the JAX package donates them and gets new arrays back), so
every set a meter reads after a scan is a host copy taken before it.

Over a ``torch.distributed`` group (``group=``, a ``parallel_device``
stream of ``workers`` ranks): every rank constructs the session with the
same config, feeds the same chunks and runs the same ops.  Each feed's
scan runs one worker a rank (``StreamSession(group=)``); a grow's and a
warm repair's one scan runs on every rank's own device from the same
inputs and seed (the reference runs it on one device), and a cold repair
is the grouped ``repartition()``, so every rank holds the same ``k``,
parts, sets and traffic.  After each committed op the ranks compare a
digest of (k, parts, sets) and all raise if they differ.  With
``observe_wallclock`` the ranks' measured scan walls differ; the group
feeds the EWMA the largest of them (the reference's one observation is
the wall of the whole fused dispatch, which its slowest worker sets), so
every rank keeps the same weights and the same block→worker plan.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..api_backends import TrafficCounters
from ..core.bipartite import BipartiteGraph
from ..core.dispatch import phase
from ..core.parallel import global_initialization
from ..core.partition import _partition_scan, pack_graph_blocks
from ..kernels.parsa_cost import coerce_packed_sets, packed_delta
from ..runtime.straggler import StragglerEWMA
from ..stream.online import ParsaStreamConfig, StreamSession, StreamUpdate
from .chaos import ChaosEvent, ChaosSchedule
from .policy import ElasticPolicy, FleetState, ThresholdPolicy

__all__ = ["ElasticConfig", "ElasticOp", "ElasticSession"]


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elasticity knobs on top of a ``ParsaStreamConfig``.

    ``observe_wallclock=False`` (default) feeds the straggler EWMA a
    synthetic per-worker time model (1.0 × the injected slowdown factor)
    instead of measured seconds, so chaos runs are bit-deterministic
    under a fixed seed; real deployments flip it on to track actual scan
    times."""

    stream: ParsaStreamConfig
    min_k: int = 2
    max_k: int = 64
    budget_feeds: int = 32      # horizon amortizing migration cost
    ewma_alpha: float = 0.3
    ewma_floor: float = 0.1
    straggler_bias: bool = True
    observe_wallclock: bool = False

    def __post_init__(self):
        if not 1 <= self.min_k <= self.max_k:
            raise ValueError(
                f"need 1 <= min_k <= max_k, got ({self.min_k}, "
                f"{self.max_k})")
        if self.budget_feeds < 0:
            raise ValueError(
                f"budget_feeds must be >= 0, got {self.budget_feeds}")


@dataclasses.dataclass
class ElasticOp:
    """Record of one elastic action (committed or vetoed by policy)."""

    kind: str                   # "grow" | "shrink" | "repair"
    committed: bool
    k_before: int
    k_after: int
    machine: int                # split source / merge target / lost slot
    traffic: TrafficCounters    # migration_bytes of the (candidate) move
    projected_savings: int      # projected steady-state bytes saved/feed
    moved_u: int                # example rows changing machines
    seconds: float              # wall-clock of plan + (if any) commit
    mode: str = ""              # repair only: "warm" | "cold"
    partner: int = -1           # grow: new machine id; shrink: retired id
    telemetry: object = None    # closed loop: triggering TelemetrySnapshot


def _range_gather(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate ``[s, s+c)`` ranges without a python loop."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    nonempty = counts > 0
    s, c = starts[nonempty].astype(np.int64), counts[nonempty].astype(np.int64)
    out = np.ones(total, np.int64)
    out[0] = s[0]
    bounds = np.cumsum(c)[:-1]
    out[bounds] = s[1:] - (s[:-1] + c[:-1]) + 1
    return np.cumsum(out)


class ElasticSession:
    """Elastic control over one ``StreamSession`` on ``device`` (the card
    unless the caller passes ``device="cpu"``) — policy decides, the
    session executes and meters.  See the module docstring for the op
    semantics and ``group=``; ``ops`` records every action (including
    policy vetoes)."""

    def __init__(self, config: ElasticConfig, num_v: int,
                 policy: ElasticPolicy | None = None,
                 chaos: ChaosSchedule | None = None, obs=None,
                 device: str | torch.device = "cuda", *, group=None):
        self.config = config
        self.group = group
        self.stream = StreamSession(config.stream, num_v, device=device,
                                    group=group)
        self.policy = policy if policy is not None else ThresholdPolicy(
            min_k=config.min_k, max_k=config.max_k,
            budget_feeds=config.budget_feeds,
            straggler_bias=config.straggler_bias)
        self.chaos = chaos
        workers = config.stream.workers
        self.ewma = StragglerEWMA(workers, alpha=config.ewma_alpha,
                                  floor=config.ewma_floor)
        self._straggle = np.ones(workers, np.float64)
        self.ops: list[ElasticOp] = []
        self._n_ops = 0
        self._obs = None
        if obs is not None:
            self.obs = obs

    @property
    def device(self) -> torch.device:
        return self.stream.device

    # ------------------------------------------------------ observability
    @property
    def obs(self):
        return self._obs

    @obs.setter
    def obs(self, value) -> None:
        # one hook covers the stack: the stream under this session traces
        # its feeds into the same sinks
        self._obs = value
        self.stream.obs = value

    def _finish_op(self, op: ElasticOp) -> ElasticOp:
        """Book one op: append to the audit trail and (with obs attached)
        emit the ``elastic_op → plan/scan/migrate`` span.  Child offsets
        are fixed fractions of a 1.0 virtual unit — host-side phases have
        no modeled duration, and fixed fractions keep seeded replays
        byte-identical; the measured seconds ride in ``wall_s``."""
        self.ops.append(op)
        if op.committed and self.group is not None:
            from ..core.partition import _check_ranks_agree

            _check_ranks_agree(
                self.group, self.device, self.k, self.parts,
                self.stream.arena.masks_np(logical=False),
                what=f"the ranks of the group hold different elastic states "
                     f"(k, parts, sets) after {op.kind} op {len(self.ops)}: "
                     f"every rank must feed the same chunks and run the "
                     f"same ops")
        if self._obs is not None:
            tr = self._obs.tracer
            sp = tr.begin("elastic_op", v_start=tr.now, v_dur=1.0,
                          track="elastic", kind=op.kind,
                          committed=op.committed, machine=op.machine,
                          k_before=op.k_before, k_after=op.k_after,
                          mode=op.mode, wall_s=op.seconds)
            sp.child("plan", 0.0, 0.4, moved_u=int(op.moved_u))
            sp.child("scan", 0.4, 0.4)
            sp.child("migrate", 0.8, 0.2,
                     migration_bytes=int(op.traffic.migration_bytes))
        return op

    # --------------------------------------------------------- delegation
    @property
    def k(self) -> int:
        return self.stream.k

    @property
    def parts(self) -> np.ndarray:
        return self.stream.parts

    @property
    def traffic(self) -> TrafficCounters:
        return self.stream.traffic

    @property
    def n_feeds(self) -> int:
        return self.stream.n_feeds

    def result(self, refine_v: bool | None = None):
        return self.stream.result(refine_v=refine_v)

    # ------------------------------------------------------------ feeding
    def feed(self, chunk: BipartiteGraph) -> StreamUpdate:
        """Apply due chaos events, then feed with straggler-biased block
        routing (parallel configs) and fold the round's per-worker times
        into the EWMA."""
        if self.chaos is not None:
            for ev in self.chaos.at(self.stream.n_feeds):
                self._apply_event(ev)
        weights = None
        workers = self.config.stream.workers
        if workers > 1:
            w = self.ewma.weights()
            weights = self.policy.rebalance(self._state(), w)
        upd = self.stream.feed(chunk, worker_weights=weights)
        if workers > 1:
            if self.config.observe_wallclock:
                # real mode: feed the MEASURED scan wall time — one
                # observation per lane (a single host cannot separate
                # per-worker times out of one launch), with NO synthetic
                # straggle multiply; injected chaos straggles are invisible
                # here by design, only actual slowness registers
                wall = upd.timings.get("partition_u", float("nan"))
                if self.group is not None:
                    wall = self._slowest(wall)
                self.ewma.update(np.full(workers, wall))
            else:
                # synthetic mode (default): the injected straggle factors
                # ARE the per-worker time model — bit-deterministic
                self.ewma.update(1.0 * self._straggle)
        return upd

    def _slowest(self, wall: float) -> float:
        """The largest of the group's measured walls, on every rank."""
        from ..core.partition import _gather_flat

        n = self.group.size()
        every = torch.empty(n, dtype=torch.float64, device=self.device)
        _gather_flat(every, torch.tensor([wall], dtype=torch.float64,
                                         device=self.device), self.group)
        return float(every.max())

    def _apply_event(self, ev: ChaosEvent) -> None:
        workers = self.config.stream.workers
        if ev.kind == "kill":
            self.repair(ev.machine % self.k)
        elif ev.kind == "add":
            self.grow_k(force=True)
        elif ev.kind == "straggle":
            self._straggle[ev.machine % workers] = ev.factor
        elif ev.kind == "recover":
            self._straggle[ev.machine % workers] = 1.0
        elif ev.kind == "burst":
            pass  # load events target the serving layer, not the stream

    # ------------------------------------------------------------- state
    def _state(self, migration_bytes: int = 0,
               projected_savings: int = 0) -> FleetState:
        masks = self.stream.arena.masks_np(logical=False)
        foot = np.unpackbits(
            np.ascontiguousarray(masks).view(np.uint8),
            axis=1).sum(axis=1).astype(np.int64)
        return FleetState(
            k=self.k, feed_index=self.stream.n_feeds,
            sizes=np.bincount(self.parts, minlength=self.k).astype(np.int64),
            footprint=foot, migration_bytes=migration_bytes,
            projected_savings=projected_savings)

    def _op_rng(self) -> np.random.Generator:
        # per-op stream derived from (seed, op ordinal): deterministic
        # under a fixed seed, distinct across successive ops
        return np.random.default_rng(
            [self.config.stream.base.seed, 0x454C, self._n_ops])

    def _scan(self, name: str, g_cap: BipartiteGraph, order: np.ndarray,
              s_masks: np.ndarray, sizes: np.ndarray, **meta):
        """One counted ``parsa_scan`` over ``g_cap``'s rows in ``order``
        from the entering (s_masks, sizes).  Returns (parts in ``g_cap``'s
        row order, the sets and sizes after the scan), all on the host."""
        packed = pack_graph_blocks(g_cap, self.config.stream.base.block_size,
                                   order=order,
                                   cap=self.config.stream.base.cap)
        dev = self.device
        s = torch.tensor(s_masks, dtype=torch.int32, device=dev)
        sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
        with phase(name, nbytes=int(packed.valid.nbytes), **meta):
            parts_blocks = _partition_scan(
                *(torch.from_numpy(a).to(dev)
                  for a in (packed.widx, packed.vals, packed.tr_ids,
                            packed.tr_masks, packed.valid)),
                s, sz, sketch=self.stream.sketch is not None)
        n = order.shape[0]
        parts = np.empty(n, np.int32)
        parts[order] = parts_blocks.reshape(-1)[:n].cpu().numpy()
        return parts, s.cpu().numpy(), sz.cpu().numpy()

    # ---------------------------------------------------------- grow
    def grow_k(self, target: int | None = None,
               force: bool = False) -> ElasticOp:
        """Split one part in two; the new machine ``k`` hosts the second
        half.  ``target`` picks the part to split (the closed-loop
        autoscaler passes the hottest footprint); default is the largest
        part.  ONE ``parsa_scan`` launch over the split part's rows at
        k=2 (exact neighbor sets for both halves come out of the scan's S
        carry).  Commits only when the policy accepts the metered
        migration cost (or ``force=True``)."""
        t0 = time.perf_counter()
        arena = self.stream.arena
        k = self.k
        parts = self.parts
        sizes = np.bincount(parts, minlength=k)
        if target is not None and 0 <= target < k and sizes[target] >= 2:
            src = int(target)
        else:
            src = int(np.argmax(sizes))
        rows = np.flatnonzero(parts == src)
        if rows.size < 2:
            op = ElasticOp("grow", False, k, k, src, TrafficCounters(),
                           0, 0, time.perf_counter() - t0)
            self._finish_op(op)
            return op
        g = arena.graph()
        sub_indptr, counts, sub_indices = self._sub_csr(g, rows)
        g_cap = BipartiteGraph(rows.size, arena.capacity_v, sub_indptr,
                               sub_indices)
        rng = self._op_rng()
        self._n_ops += 1
        order = rng.permutation(rows.size)
        # the live sets, read before the scan: the meters below need them
        old_masks = arena.masks_np(logical=False)
        half, m2, _ = self._scan(
            "elastic_grow_scan", g_cap, order,
            np.zeros((2, arena.W_cap), np.int32), np.zeros(2, np.int32),
            rows=int(rows.size), machine=int(src))
        new_masks = np.concatenate([old_masks, m2[1:2]], axis=0)
        new_masks[src] = m2[0]
        new_parts = parts.copy()
        moved = rows[half == 1]
        new_parts[moved] = k
        moved_edges = int(counts[half == 1].sum())
        acquired = 4 * int(np.count_nonzero(m2[1])) + 4 * moved_edges
        retired = 4 * int(np.count_nonzero(packed_delta(old_masks[src],
                                                        m2[0])))
        migration = acquired + retired
        foot_after = self._foot_after(old_masks, {src: m2[0]},
                                      extra=m2[1])
        savings = self._max_foot_savings(old_masks, foot_after)
        state = self._state(migration, savings)
        committed = bool(force or self.policy.grow(state))
        if committed:
            self.stream.apply_partition_state(new_parts, new_masks,
                                              k=k + 1)
            self.stream._accumulate(
                TrafficCounters(tasks=1, migration_bytes=migration))
        op = ElasticOp("grow", committed, k, k + 1 if committed else k,
                       src, TrafficCounters(tasks=1,
                                            migration_bytes=migration),
                       savings, int(moved.size),
                       time.perf_counter() - t0, partner=k)
        self._finish_op(op)
        return op

    # ---------------------------------------------------------- shrink
    def shrink_k(self, force: bool = False) -> ElasticOp:
        """Merge the two smallest parts (machine ``j`` retires into
        machine ``i``): a host OR on the packed words plus a relabel —
        no launch.  Projected savings are the de-duplicated parameters
        the fleet stops hosting twice."""
        t0 = time.perf_counter()
        k = self.k
        if k <= max(1, self.config.min_k - 1) or k <= 1:
            op = ElasticOp("shrink", False, k, k, -1, TrafficCounters(),
                           0, 0, time.perf_counter() - t0)
            self._finish_op(op)
            return op
        parts = self.parts
        sizes = np.bincount(parts, minlength=k)
        a, b = np.argsort(sizes, kind="stable")[:2]
        i, j = int(min(a, b)), int(max(a, b))
        arena = self.stream.arena
        old_masks = arena.masks_np(logical=False)
        merged = old_masks[i] | old_masks[j]
        new_masks = np.delete(old_masks, j, axis=0)
        new_masks[i] = merged
        new_parts = parts.copy()
        new_parts[new_parts == j] = i
        new_parts[new_parts > j] -= 1
        g = arena.graph()
        deg = np.diff(g.u_indptr)
        moved_rows = np.flatnonzero(parts == j)
        moved_edges = int(deg[moved_rows].sum())
        acquired = 4 * int(np.count_nonzero(
            packed_delta(old_masks[j], old_masks[i]))) + 4 * moved_edges
        retired = 4 * int(np.count_nonzero(old_masks[j]))
        migration = acquired + retired
        # de-duplicated hosting: params both machines carried, now one
        overlap_words = old_masks[i] & old_masks[j]
        savings = int(np.unpackbits(
            np.ascontiguousarray(overlap_words).view(np.uint8)).sum()) // 8
        state = self._state(migration, savings)
        committed = bool(force or self.policy.shrink(state))
        if committed:
            self.stream.apply_partition_state(new_parts, new_masks,
                                              k=k - 1)
            self.stream._accumulate(
                TrafficCounters(tasks=1, migration_bytes=migration))
        op = ElasticOp("shrink", committed, k, k - 1 if committed else k,
                       i, TrafficCounters(tasks=1,
                                          migration_bytes=migration),
                       savings, int(moved_rows.size),
                       time.perf_counter() - t0, partner=j)
        self._finish_op(op)
        return op

    # ---------------------------------------------------------- repair
    def repair(self, machine: int, mode: str | None = None) -> ElasticOp:
        """Recover from losing ``machine``.  Warm mode zeroes the lost
        row in the surviving packed sets and re-assigns the lost part's
        vertices in ONE ``parsa_scan`` launch — §4.1 balance refills the
        empty slot (the replacement machine) and ``repartition_frac > 0``
        additionally seeds the lost subgraph's §4.4 sample.  Cold mode is
        the stream's full ``repartition()`` (the baseline).  Repair always
        commits: the machine is already gone."""
        t0 = time.perf_counter()
        k = self.k
        if not 0 <= machine < k:
            raise ValueError(f"machine must be in [0, {k}), got {machine}")
        if mode is None:
            mode = self.policy.repair(self._state())
        if mode not in ("warm", "cold"):
            raise ValueError(f"repair mode must be warm|cold, got {mode!r}")
        if mode == "cold":
            plan = self.stream.repartition()
            op = ElasticOp("repair", True, k, k, machine, plan.traffic,
                           0, plan.moved_u, time.perf_counter() - t0,
                           mode="cold")
            self._finish_op(op)
            return op

        base = self.config.stream.base
        arena = self.stream.arena
        parts = self.parts
        rows = np.flatnonzero(parts == machine)
        masks = arena.masks_np(logical=False)
        masks[machine] = 0
        survivors = masks.copy()    # pre-seed baseline for the metering
        sizes_live = arena.sizes.cpu().numpy().copy()
        sizes_live[machine] = 0
        if rows.size == 0:
            self.stream.apply_partition_state(parts.copy(),
                                              masks, sizes=sizes_live, k=k)
            op = ElasticOp("repair", True, k, k, machine,
                           TrafficCounters(tasks=1), 0, 0,
                           time.perf_counter() - t0, mode="warm")
            self._finish_op(op)
            return op
        g = arena.graph()
        sub_indptr, counts, sub_indices = self._sub_csr(g, rows)
        frac = self.config.stream.repartition_frac
        if frac > 0:
            g_sub = BipartiteGraph(rows.size, arena.num_v, sub_indptr,
                                   sub_indices)
            dense = global_initialization(
                g_sub, k, sample_frac=frac, theta=base.theta,
                select=base.select, seed=base.seed)
            seeded = coerce_packed_sets(dense, arena.num_v)
            masks |= np.pad(
                seeded, [(0, 0), (0, arena.W_cap - seeded.shape[1])])
            self.stream._need_exact = False
        g_cap = BipartiteGraph(rows.size, arena.capacity_v, sub_indptr,
                               sub_indices)
        rng = self._op_rng()
        self._n_ops += 1
        order = rng.permutation(rows.size)
        assigned, new_masks, new_sizes = self._scan(
            "elastic_repair_scan", g_cap, order, masks, sizes_live,
            rows=int(rows.size), machine=int(machine))
        new_parts = parts.copy()
        new_parts[rows] = assigned
        # every lost row re-materializes somewhere (even slot `machine` is
        # a fresh replacement), so all its edges are re-fetched; survivors
        # only gain words under the OR-monotone scan, nothing retires
        acquired = (4 * int(np.count_nonzero(packed_delta(new_masks,
                                                          survivors)))
                    + 4 * int(counts.sum()))
        self.stream.apply_partition_state(
            new_parts, new_masks, sizes=new_sizes, k=k)
        self.stream._accumulate(
            TrafficCounters(tasks=1, migration_bytes=acquired))
        op = ElasticOp("repair", True, k, k, machine,
                       TrafficCounters(tasks=1, migration_bytes=acquired),
                       0, int(rows.size), time.perf_counter() - t0,
                       mode="warm")
        self._finish_op(op)
        return op

    # ---------------------------------------------------------- PS bridge
    def sync_cluster(self, cluster, parts_v: np.ndarray | None = None) -> dict:
        """Push the current elastic placement into a ``PSCluster`` serving
        the fed graph — metered re-shard, shard teardown/spawn when the
        machine count changed (``apply_placement(..., k=self.k)``)."""
        n = int(cluster.parts_u.shape[0])
        if n != self.parts.shape[0]:
            raise ValueError(
                f"cluster serves {n} rows but the stream holds "
                f"{self.parts.shape[0]}")
        if parts_v is None:
            parts_v = np.full(cluster.parts_v.shape[0], -1, np.int32)
        return cluster.apply_placement(self.parts.copy(), parts_v, k=self.k)

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _sub_csr(g: BipartiteGraph, rows: np.ndarray):
        indptr = np.asarray(g.u_indptr, np.int64)
        indices = np.asarray(g.u_indices)
        counts = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
        sub_indptr = np.zeros(rows.size + 1, np.int64)
        np.cumsum(counts, out=sub_indptr[1:])
        sub_indices = indices[_range_gather(indptr[rows], counts)]
        return sub_indptr, counts, sub_indices

    @staticmethod
    def _foot_after(old_masks: np.ndarray, replaced: dict,
                    extra: np.ndarray | None = None) -> np.ndarray:
        rows = [replaced.get(i, old_masks[i])
                for i in range(old_masks.shape[0])]
        if extra is not None:
            rows.append(extra)
        stack = np.ascontiguousarray(np.stack(rows))
        return np.unpackbits(stack.view(np.uint8),
                             axis=1).sum(axis=1).astype(np.int64)

    @staticmethod
    def _max_foot_savings(old_masks: np.ndarray,
                          foot_after: np.ndarray) -> int:
        before = np.unpackbits(
            np.ascontiguousarray(old_masks).view(np.uint8),
            axis=1).sum(axis=1).astype(np.int64)
        # serving traffic scales with the max per-machine footprint
        # (objective (6)); /8 converts parameters to TrafficCounters
        # bytes (4 B per 32 params)
        return max(0, int(before.max() - foot_after.max())) // 8
