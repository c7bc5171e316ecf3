r"""Online incremental Parsa on the card: partition a growing graph chunk by
chunk.

The paper's blocked greedy (§4.2) is already an online algorithm — every
block is assigned against the live neighbor sets and never revisited — so
a *streaming* partitioner needs no new math, only new plumbing: keep the
packed ``(k, W)`` server sets resident on the device across arrivals and
run each arriving chunk through the scan with the live sets as the carry
(the §4.4 warm start, used as a system).

    session = StreamSession(ParsaStreamConfig(base=ParsaConfig(
        k=16, backend="device_scan")), num_v=65_536)
    for chunk in arriving_graphs:          # BipartiteGraph chunks
        upd = session.feed(chunk)          # ONE parsa_scan launch
        upd.parts, upd.metrics             # incremental delta
    res = session.result()                 # full PartitionResult

``feed`` is O(chunk) work and O(1) dispatches: one ``parsa_scan`` launch
(the kernel ``device_scan`` runs, the live sets updated in place) plus one
popcount of the live sets.  With ``workers > 1`` the chunk's blocks fan out
over the worker axis of the Algorithm 4 scan (one ``parsa_scan`` and one
``packed_union_delta`` merge a super-step), with *randomized* block→worker
assignment (arXiv:1502.02606) and OR-merges every ``merge_every`` blocks.
On one card the workers are an axis of the carried state, so any worker
count is accepted; a session given a ``torch.distributed`` group
(``group=``, ``base.backend="parallel_device"``) runs one worker a rank
instead, each rank feeding the same chunks and holding the same state.
A feed's truncated-row width comes from its own data:
the JAX package pads it to a power of two so that its jit cache holds, and
nothing here is compiled per shape.

Drift repair: assignments are never revisited by ``feed``, so under
distribution drift the partition decays.  A ``DriftTracker`` watches the
per-feed popcount metrics and triggers ``repartition()`` — a warm-started
(§4.4 global-initialization) full repartition of the arena — whose result
is matched back onto the old labels by ``plan_migration`` so serving
machines keep the part closest to what they already host, with migration
bytes metered in ``TrafficCounters`` units.

A port of ``repro.stream.online``: the same seeded chunks give the same
parts, sets, metrics, dispatch records, traffic and trace spans, and a
snapshot saved by either package resumes in the other.  Every seeded draw
is numpy's, in the JAX package's order.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable

import numpy as np
import torch

from ..api import ParsaConfig, PartitionResult, resolve_device
from ..api_backends import TrafficCounters
from ..core.bipartite import BipartiteGraph
from ..core.costs import PartitionMetrics
from ..core.dispatch import dispatch_counter, phase
from ..core.parallel import global_initialization
from ..core.partition import (
    _partition_scan,
    _run_parallel_packed_scan,
    blocked_partition_u_impl,
    pack_graph_blocks,
    parallel_blocked_partition_u_impl,
    resolve_worker_group,
)
from ..core.refine import evaluate_device, refine_v_device
from ..kernels.parsa_cost import coerce_packed_sets, popcount32
from ..sketch import SketchSpec
from .arena import StreamArena
from .drift import DriftDecision, DriftTracker
from .migrate import MigrationPlan, plan_migration

__all__ = ["ParsaStreamConfig", "StreamSession", "StreamUpdate",
           "stream_partition"]

_STREAM_BACKENDS = ("device_scan", "parallel_device")


@dataclasses.dataclass(frozen=True)
class ParsaStreamConfig:
    """Streaming knobs on top of a device ``ParsaConfig``.

    ``base`` supplies the partitioning knobs the feed scan shares with the
    one-shot pipeline (k, block_size, cap, seed; workers/merge_every/devices
    when ``base.backend == "parallel_device"``).  The stream fields control
    drift repair and shape stability.
    """

    base: ParsaConfig
    drift_window: int = 8          # feeds the drift baseline spans
    drift_threshold: float = 1.15  # degradation ratio that trips repair
    drift_min_feeds: int = 2       # history before a trigger is allowed
    repartition: str = "drift"     # "drift" (auto) | "never" (manual only)
    repartition_frac: float = 0.02  # §4.4 global-init sample; 0 = cold
    shuffle_blocks: bool = True    # randomized block→worker assignment

    def __post_init__(self):
        if self.base.backend not in _STREAM_BACKENDS:
            raise ValueError(
                f"streaming needs a device backend {_STREAM_BACKENDS}, got "
                f"base.backend={self.base.backend!r}")
        if self.repartition not in ("drift", "never"):
            raise ValueError(
                f"repartition must be 'drift' or 'never', got "
                f"{self.repartition!r}")
        if not 0.0 <= self.repartition_frac <= 1.0:
            raise ValueError(
                f"repartition_frac must be in [0, 1], got "
                f"{self.repartition_frac}")
        # window/threshold/min_feeds: fail at construction, not first feed
        DriftTracker(self.drift_window, self.drift_threshold,
                     self.drift_min_feeds)

    @property
    def workers(self) -> int:
        if self.base.backend != "parallel_device":
            return 1
        return (self.base.devices if self.base.devices is not None
                else self.base.workers)

    def replace(self, **changes) -> "ParsaStreamConfig":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class StreamUpdate:
    """Incremental ``PartitionResult`` delta for one fed chunk."""

    chunk: int                      # feed ordinal
    u_start: int                    # global U-id range this chunk occupies
    u_stop: int
    parts: np.ndarray               # (u_stop - u_start,) int32 assignments
    metrics: PartitionMetrics       # popcount objectives after this feed
    drift: DriftDecision | None     # None when repartition == "never"
    repartitioned: bool
    migration: MigrationPlan | None  # set when this feed triggered repair
    traffic: TrafficCounters | None  # parallel feeds: push/pull this feed
    timings: dict[str, float]
    dispatches: dict[str, int]      # pipeline dispatches of this feed


class StreamSession:
    """Partition a graph that grows over time, its live state on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    The live state (packed server sets + sizes) never leaves the device
    between feeds; the arena keeps the appended CSR on the host for
    snapshots, repartitions, and exact metrics.  ``parts`` holds the
    current assignment of every fed U vertex (relabeled in place when a
    drift repair lands).

    ``group``, a ``torch.distributed`` process group of ``config.workers``
    ranks (checked here, at construction), makes every parallel feed and
    repartition run one worker a rank; each rank constructs its session
    with the same config, feeds the same chunks and holds the same state.
    """

    def __init__(self, config: ParsaStreamConfig, num_v: int, obs=None,
                 device: str | torch.device = "cuda", *, group=None):
        self.device = resolve_device(device, "StreamSession")
        if group is not None:
            # fail at construction, not mid-stream
            if config.base.backend != "parallel_device":
                raise ValueError(
                    f"group= needs base.backend='parallel_device', got "
                    f"{config.base.backend!r}")
            resolve_worker_group(config.workers, group)
        self.group = group
        self.obs = obs   # repro_torch.obs.Observability hook; None = off
        self.config = config
        self.k = config.base.k
        # Sketched arenas (base.set_repr="sketch"): the live sets, the
        # appended CSR, and every scan run at the sketched width.  Streams
        # use the IDENTITY hot prefix [0, hot_bits) — a footprint ranking
        # cannot see future data — and the hash covers arbitrary column
        # ids, so V growth is free: the arena width never grows in sketch
        # mode.  ``self.sketch`` stays None when the spec collapses to the
        # exact identity (hot_bits ≥ num_v), so that case stays exact.
        self.sketch = None
        self._true_num_v = num_v
        arena_v = num_v
        base = config.base
        if base.set_repr == "sketch":
            spec = SketchSpec.for_graph(
                num_v, base.sketch_hot_bits, base.sketch_bucket_bits,
                seed=base.seed)
            if not spec.is_exact:
                self.sketch = spec
                arena_v = spec.width_bits
        self.arena = StreamArena(config.base.k, arena_v, device=self.device)
        self._parts_buf = np.empty(1024, np.int32)  # doubles with the arena
        self.tracker = DriftTracker(config.drift_window,
                                    config.drift_threshold,
                                    config.drift_min_feeds)
        self._rng = np.random.default_rng(config.base.seed)
        self.n_feeds = 0
        self.repartitions = 0
        # S_i == N(U_i) holds for pure cold streaming; a §4.4-seeded
        # repartition may add sampled bits, after which popcount metrics
        # over s_masks are an upper bound and result() recomputes exactly.
        self._need_exact = True
        self._pushed = 0
        self._pulled = 0
        self._tasks = 0
        self._stale = 0
        self._migrated = 0

    # ------------------------------------------------------------- feeding
    def feed(self, chunk: BipartiteGraph,
             worker_weights: np.ndarray | None = None) -> StreamUpdate:
        """Assign one arriving chunk of U vertices against the live sets.

        ``worker_weights`` (parallel feeds only) biases the randomized
        block→worker assignment toward faster workers — see
        ``_run_parallel_packed_scan``.

        One ``stream_feed_scan`` dispatch (one ``parsa_scan`` launch, or
        one and a merge a super-step on parallel feeds) plus one
        ``stream_metrics`` popcount per call.  May additionally run a
        drift-triggered ``repartition()`` before returning.

        Failure atomicity: the chunk is appended to the arena only AFTER
        its scan succeeds, so an error while packing or launching leaves
        the session's graph and parts consistent (retry-safe).  An exact
        feed's scan updates the live sets in place, so a failure *inside*
        the kernel remains unrecoverable, as with the JAX package's
        donated carries.
        """
        timings: dict[str, float] = {}
        t_total = time.perf_counter()
        with dispatch_counter() as counts:
            n = chunk.num_u
            if self.sketch is not None:
                # host column remap only — the scan below stays one launch
                self._true_num_v = max(self._true_num_v, chunk.num_v)
                chunk = self.sketch.sketch_graph(chunk)
            self.arena.prepare(chunk)   # validate + capacity growth only
            order = self._rng.permutation(n)
            t0 = time.perf_counter()
            packed = pack_graph_blocks(
                self.arena.capacity_graph(chunk), self.config.base.block_size,
                order=order, cap=self.config.base.cap)
            timings["pack"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            traffic = None
            if self.config.workers == 1 and self.group is None:
                flat = self._feed_scan(packed, n)
            else:
                flat, traffic = self._feed_parallel(packed, n,
                                                    worker_weights)
            # scan succeeded — commit: CSR append, parts
            u_start, u_stop = self.arena.append(chunk)
            parts_chunk = np.empty(n, np.int32)
            parts_chunk[order] = flat
            self._store_parts(u_start, parts_chunk)
            timings["partition_u"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            metrics = self._popcount_metrics()
            timings["metrics"] = time.perf_counter() - t0

            decision = migration = None
            if self.config.repartition == "drift":
                decision = self.tracker.update(metrics)
                if decision.repartition:
                    t0 = time.perf_counter()
                    migration = self.repartition()
                    timings["repartition"] = time.perf_counter() - t0
                    metrics = self._popcount_metrics()
        self.n_feeds += 1
        timings["total"] = time.perf_counter() - t_total
        dispatches = {name: c for name, c in counts.items() if c}
        if self.obs is not None:
            self._trace_feed(n, u_start, u_stop, timings,
                             repartitioned=migration is not None)
        return StreamUpdate(
            chunk=self.n_feeds - 1, u_start=u_start, u_stop=u_stop,
            parts=self.parts[u_start:u_stop].copy(), metrics=metrics,
            drift=decision, repartitioned=migration is not None,
            migration=migration, traffic=traffic, timings=timings,
            dispatches=dispatches)

    def _tensors(self, *arrays) -> list[torch.Tensor]:
        """Copies of host arrays on the session's device (never views: the
        scan updates live state in place)."""
        return [torch.tensor(a, device=self.device) for a in arrays]

    def _feed_scan(self, packed, n: int) -> np.ndarray:
        """One worker: the chunk's blocks in one ``parsa_scan`` launch
        against the live (s_masks, sizes), updated in place.  Returns the
        chunk's parts in packed row order, on the host."""
        arena = self.arena
        with phase("stream_feed_scan",
                   nbytes=arena.s_masks.nbytes + arena.sizes.nbytes,
                   k=self.k):
            parts_blocks = _partition_scan(
                *(torch.from_numpy(a).to(self.device)
                  for a in (packed.widx, packed.vals, packed.tr_ids,
                            packed.tr_masks, packed.valid)),
                arena.s_masks, arena.sizes, sketch=self.sketch is not None)
        return parts_blocks.reshape(-1)[:n].cpu().numpy()

    def _trace_feed(self, n: int, u_start: int, u_stop: int,
                    timings: dict, repartitioned: bool) -> None:
        """Emit the ``feed → pack/scan(/merge)/metrics`` span tree.

        A feed has no modeled duration (it is host work, not a priced
        transfer), so the span occupies one fixed virtual unit with
        children at fixed fractions — deterministic across replays — and
        the measured phase seconds attached as ``wall_s`` evidence."""
        tr = self.obs.tracer
        sp = tr.begin("feed", v_start=tr.now, v_dur=1.0, track="stream",
                      feed=self.n_feeds - 1, rows=n, u_start=u_start,
                      u_stop=u_stop, k=self.k,
                      wall_s=timings.get("total"))
        sp.child("pack", 0.0, 0.25, wall_s=timings.get("pack"))
        sp.child("scan", 0.25, 0.45, wall_s=timings.get("partition_u"),
                 workers=self.config.workers)
        if self.config.workers > 1:
            # the OR-merge union-push folded into the parallel scan
            sp.child("merge", 0.7, 0.1,
                     merge_every=self.config.base.merge_every)
        sp.child("metrics", 0.8, 0.1, wall_s=timings.get("metrics"))
        if repartitioned:
            sp.child("repartition", 0.9, 0.1,
                     wall_s=timings.get("repartition"))
        tr.advance(1.0)

    def _feed_parallel(self, packed, n: int,
                       worker_weights: np.ndarray | None = None):
        """Fan one chunk's blocks over the worker axis: the shared Alg 4
        core (``_run_parallel_packed_scan``) with randomized block→worker
        assignment, against the live (S, sizes), which it replaces with
        the merged outputs."""
        base = self.config.base
        workers = self.config.workers
        shuffle = self._rng if self.config.shuffle_blocks else None
        parts_blocks, s_out, sz_out, traffic_d, perm = \
            _run_parallel_packed_scan(
                packed, self.arena.s_masks, self.arena.sizes, k=self.k,
                workers=workers, merge_every=base.merge_every,
                shuffle_rng=shuffle, worker_weights=worker_weights,
                count_name="stream_feed_scan",
                sketch=self.sketch is not None, group=self.group)
        self.arena.s_masks, self.arena.sizes = s_out, sz_out
        B = packed.valid.shape[1]
        by_block = parts_blocks.cpu().numpy().reshape(-1, B)
        if perm is not None:
            by_block = by_block[np.argsort(perm)]
        flat = by_block.reshape(-1)[:n]
        traffic = TrafficCounters(**traffic_d)
        self._accumulate(traffic)
        return flat, traffic

    @property
    def parts(self) -> np.ndarray:
        """Current assignment of every fed U vertex (view, not a copy)."""
        return self._parts_buf[: self.arena.num_u]

    def _store_parts(self, start: int, parts_chunk: np.ndarray) -> None:
        """Amortized-O(chunk) append: double the buffer like the arena
        does instead of re-concatenating the whole history every feed."""
        need = start + parts_chunk.shape[0]
        if need > self._parts_buf.shape[0]:
            cap = max(1, self._parts_buf.shape[0])
            while cap < need:
                cap *= 2
            buf = np.empty(cap, np.int32)
            buf[:start] = self._parts_buf[:start]
            self._parts_buf = buf
        self._parts_buf[start:need] = parts_chunk

    def _accumulate(self, t: TrafficCounters) -> None:
        self._pushed += t.pushed_bytes
        self._pulled += t.pulled_bytes
        self._tasks += t.tasks
        self._stale += t.stale_pushes_missed
        self._migrated += t.migration_bytes

    @property
    def traffic(self) -> TrafficCounters:
        """Cumulative session traffic: parallel-feed push/pull plus metered
        migration bytes, all in bitmask-word-byte units."""
        return TrafficCounters(self._pushed, self._pulled, self._tasks,
                               self._stale, self._migrated)

    # ------------------------------------------------------------- metrics
    def _popcount_metrics(self) -> PartitionMetrics:
        """Objectives (4)/(6) (+ the parts_v=None traffic convention) from
        the live packed sets — O(k·W) on the device, one host read."""
        with phase("stream_metrics", nbytes=self.arena.s_masks.nbytes):
            both = _popcount_rows(self.arena.s_masks, self.arena.sizes)
            sizes, footprint = both.cpu().numpy().astype(np.int64)
        return PartitionMetrics(self.k, sizes, footprint, footprint.copy(),
                                footprint.copy(), np.zeros(self.k, np.int64))

    # --------------------------------------------------------- drift repair
    def repartition(self) -> MigrationPlan:
        """Full repartition of everything fed so far, warm-started per §4.4
        (``repartition_frac`` sample seeds the sets; 0 = cold), matched back
        onto the live labels by the packed intersection matrix so serving
        machines keep their closest part.  Updates the live state in place
        and returns the metered ``MigrationPlan``."""
        base = self.config.base
        g = self.arena.graph()
        old_parts = self.parts.copy()   # the buffer is overwritten below
        old_masks = self.arena.masks_np(logical=False)
        init_sets = None
        if self.config.repartition_frac > 0:
            dense = global_initialization(
                g, self.k, sample_frac=self.config.repartition_frac,
                theta=base.theta, select=base.select, seed=base.seed)
            packed = coerce_packed_sets(dense, g.num_v)
            init_sets = np.pad(
                packed, [(0, 0), (0, self.arena.W_cap - packed.shape[1])])
            self._need_exact = False
        g_cap = BipartiteGraph(g.num_u, self.arena.capacity_v,
                               g.u_indptr, g.u_indices)
        if self.config.workers > 1 or self.group is not None:
            new_parts, new_masks, scan_traffic = \
                parallel_blocked_partition_u_impl(
                    g_cap, self.k, workers=self.config.workers,
                    block=base.block_size, merge_every=base.merge_every,
                    init_sets=init_sets, seed=base.seed, cap=base.cap,
                    device=self.device, sketch=self.sketch is not None,
                    group=self.group)
            # the repair's own Alg 4 push/pull rides on the session total,
            # same units as the per-feed counters
            self._accumulate(TrafficCounters(**scan_traffic))
        else:
            new_parts, new_masks = blocked_partition_u_impl(
                g_cap, self.k, block=base.block_size, init_sets=init_sets,
                seed=base.seed, cap=base.cap, device=self.device,
                sketch=self.sketch is not None)
        plan = plan_migration(new_parts.cpu().numpy(),
                              new_masks.cpu().numpy(), old_parts, old_masks,
                              degrees=g.degree_u())
        self._parts_buf[: plan.parts_u.shape[0]] = plan.parts_u
        self.arena.s_masks, self.arena.sizes = self._tensors(
            plan.s_masks,
            np.bincount(plan.parts_u, minlength=self.k).astype(np.int32))
        self._accumulate(plan.traffic)
        self.repartitions += 1
        self.tracker.reset()
        return plan

    # ----------------------------------------------------------- elasticity
    def apply_partition_state(self, parts_u: np.ndarray, s_masks,
                              sizes: np.ndarray | None = None,
                              k: int | None = None) -> None:
        """Commit an externally computed partition state, possibly with a
        different machine count ``k`` — the mid-run hook of grow, shrink
        and repair.

        ``s_masks`` (numpy or a tensor) must already be capacity-stable —
        shaped ``(k, arena.W_cap)`` with the padding-bit invariant intact
        (bits at columns ≥ ``num_v`` zero).  ``sizes`` defaults to the
        bincount of ``parts_u``.  The drift tracker resets: its baseline
        compares metrics at a fixed k, which just changed (or the partition
        was rebuilt in place).
        """
        parts_u = np.asarray(parts_u, np.int32)
        if parts_u.shape[0] != self.arena.num_u:
            raise ValueError(
                f"parts_u covers {parts_u.shape[0]} U rows, arena holds "
                f"{self.arena.num_u}")
        new_k = self.k if k is None else int(k)
        masks_np = (s_masks.cpu().numpy() if isinstance(s_masks, torch.Tensor)
                    else np.asarray(s_masks))
        if masks_np.shape != (new_k, self.arena.W_cap):
            raise ValueError(
                f"s_masks must be capacity-stable ({new_k}, "
                f"{self.arena.W_cap}), got {masks_np.shape}")
        if sizes is None:
            sizes = np.bincount(parts_u, minlength=new_k).astype(np.int32)
        self.k = new_k
        self.arena.set_partition_state(
            *self._tensors(masks_np.astype(np.int32, copy=False),
                           np.asarray(sizes, np.int32)), new_k)
        self._parts_buf[: parts_u.shape[0]] = parts_u
        self.tracker.reset()

    # ------------------------------------------------------------ snapshot
    def save(self, path) -> None:
        """Snapshot the FULL stream state — arena (graph + live sets),
        per-vertex parts, feed counters, and the RNG state — so ``load``
        resumes the stream exactly where it stopped (the next feed of the
        same chunk sequence is bit-identical).  The npz keys are the JAX
        package's, so either package resumes the other's snapshots.  The
        drift tracker's sliding window is not persisted: after a restore
        the baseline restarts, which can only delay (never corrupt) the
        next repair."""
        np.savez_compressed(
            path, **self.arena.state_arrays(),
            parts=self.parts,
            true_num_v=self._true_num_v,
            n_feeds=self.n_feeds, repartitions=self.repartitions,
            need_exact=self._need_exact,
            traffic=np.asarray([self._pushed, self._pulled, self._tasks,
                                self._stale, self._migrated], np.int64),
            rng_state=np.frombuffer(
                json.dumps(self._rng.bit_generator.state).encode(),
                dtype=np.uint8))

    @classmethod
    def load(cls, path, config: ParsaStreamConfig,
             device: str | torch.device = "cuda") -> "StreamSession":
        """Restore a stream saved by ``save`` (of either package), its live
        state on ``device``.  ``config.base.k`` must match the snapshot's
        k (the packed sets are k-shaped)."""
        z = np.load(path)
        if int(z["k"]) != config.base.k:
            raise ValueError(
                f"snapshot has k={int(z['k'])} but config.base.k="
                f"{config.base.k}")
        # sketched sessions store the arena at the sketched width; the
        # session is rebuilt from the TRUE extent so __init__ re-derives
        # the identical spec (identity prefix + seeded hash — no data
        # dependence), then the saved arena replaces the fresh one.
        true_v = int(z["true_num_v"]) if "true_num_v" in z else int(z["num_v"])
        session = cls(config, num_v=true_v, device=device)
        session.arena = StreamArena.from_state(z, device=session.device)
        session._store_parts(0, np.asarray(z["parts"], np.int32))
        session.n_feeds = int(z["n_feeds"])
        session.repartitions = int(z["repartitions"])
        session._need_exact = bool(z["need_exact"])
        # snapshots from before migration_bytes carry 4 counters, current 5
        t = [int(x) for x in z["traffic"]] + [0]
        (session._pushed, session._pulled, session._tasks, session._stale,
         session._migrated) = t[:5]
        session._rng.bit_generator.state = json.loads(
            bytes(z["rng_state"]).decode())
        return session

    # ------------------------------------------------------------- results
    def result(self, refine_v: bool | None = None) -> PartitionResult:
        """Assemble the current stream state into a full
        ``PartitionResult`` (Alg 2 on the device + exact metrics), the same
        record the one-shot facade returns."""
        base = self.config.base
        dev = self.device
        g = self.arena.graph()
        timings: dict[str, float] = {}
        t_total = time.perf_counter()
        s_logical = self.arena.masks_np()
        need_words = (torch.from_numpy(s_logical).to(dev)
                      if self._need_exact else None)
        parts_u = torch.from_numpy(self.parts).to(dev)
        refine = base.refine_v if refine_v is None else refine_v
        parts_v = parts_v_dev = None
        if refine:
            t0 = time.perf_counter()
            parts_v_dev, need_words = refine_v_device(
                g, parts_u, self.k, sweeps=base.sweeps,
                chunk=base.refine_chunk, need_words=need_words, device=dev)
            parts_v = parts_v_dev.cpu().numpy()
            timings["partition_v"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = evaluate_device(g, parts_u, parts_v_dev, self.k,
                                  need_words=need_words, device=dev)
        timings["metrics"] = time.perf_counter() - t0
        if self.sketch is not None and parts_v is not None:
            # sketch-space V assignment → the true parameter extent (every
            # real column served by the machine of its sketch slot)
            parts_v = self.sketch.expand_parts_v(parts_v, self._true_num_v)
        timings["total"] = time.perf_counter() - t_total
        return PartitionResult(
            parts_u=self.parts.copy(), parts_v=parts_v, s_masks=s_logical,
            num_v=g.num_v, k=self.k, config=base, metrics=metrics,
            timings=timings, device=str(dev), sketch=self.sketch,
            traffic=(self.traffic
                     if self._tasks or self._pushed or self._migrated
                     else None))


def _popcount_rows(s_masks: torch.Tensor, sizes: torch.Tensor
                   ) -> torch.Tensor:
    """(2, k) int32 on the device: the sizes and the per-row popcount of
    the packed sets (plain tensor ops, as the JAX package computes it
    outside any Pallas kernel)."""
    return torch.stack([sizes, popcount32(s_masks).sum(dim=1,
                                                       dtype=torch.int32)])


def stream_partition(
    chunks: Iterable[BipartiteGraph],
    config: ParsaStreamConfig,
    num_v: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[PartitionResult, list[StreamUpdate]]:
    """Facade convenience: feed every chunk through one ``StreamSession``
    on ``device`` and return ``(final PartitionResult, per-chunk
    StreamUpdate deltas)``.  ``num_v`` defaults to the first chunk's
    parameter extent (the arena grows if later chunks exceed it)."""
    it = iter(chunks)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("stream_partition needs at least one chunk") \
            from None
    session = StreamSession(config,
                            num_v=num_v if num_v is not None else first.num_v,
                            device=device)
    updates = [session.feed(first)]
    updates.extend(session.feed(c) for c in it)
    return session.result(), updates
