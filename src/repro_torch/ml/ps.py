r"""Parameter-server simulation with exact traffic metering (paper §2.3, §5.5).

k machines, each hosting worker i (rows U_i) and server i (weights V_i).
Per DBPG iteration:

  push  — worker i sends smooth-gradient entries for its working set
          N(U_i), split by owning server; the KKT filter drops inactive
          coordinates; values int8-compressed (w/ error feedback); keys are
          cached after the first iteration ([19]'s key caching).
  update— each server aggregates and applies the proximal step to its slice.
  pull  — worker i fetches the *changed* values it needs (value-delta
          caching); entries owned by server i are free (same machine).

Traffic is metered exactly in bytes, split inner- vs inter-machine — the
quantity in Tables 3/4.  Bounded delay τ: a worker's gradient may be
computed against weights up to τ iterations stale (deterministic schedule),
the consistency model both Parsa (§4.3) and DBPG [19] rely on.

Wall-clock is *modeled* (one host simulates the fleet): per iteration,
  t = max_i flops_i / flops_rate + max_i inter_bytes_i / bandwidth,
with compute overlapping none of the communication (conservative).

A port of ``repro.ml.ps``.  ``w``, the workers' gradients, the KKT filter,
the compression and the proximal step run on the cluster's ``device``
(the card unless the caller passes ``device="cpu"``); the meters, caches
and error-feedback residuals stay numpy on the host, as in the reference,
so a step copies ``w`` to the host once per worker.  The meters compare
floats (the KKT filter, the soft threshold's zeros, value deltas), so the
gradient's sums run in a fixed order (``ml.lr``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..api import resolve_device
from ..core.bipartite import BipartiteGraph
from ..core.costs import need_matrix
from ..obs.trace import trace_instant
from .dbpg import DBPGConfig, dequantize_int8, kkt_filter, prox_step, quantize_int8
from .lr import SparseBatch, lr_grad, lr_objective

__all__ = ["TrafficMeter", "PSCluster", "PullPlan", "PullHandle"]


@dataclasses.dataclass
class TrafficMeter:
    inner_bytes: int = 0
    inter_bytes: int = 0
    per_machine: np.ndarray | None = None

    def _ensure(self, size: int) -> None:
        # per_machine sizes itself lazily so a bare TrafficMeter() works;
        # PSCluster still pre-sizes it from k at construction
        if self.per_machine is None:
            self.per_machine = np.zeros(size, dtype=np.int64)
        elif self.per_machine.shape[0] < size:
            self.per_machine = np.concatenate(
                [self.per_machine,
                 np.zeros(size - self.per_machine.shape[0], np.int64)])

    def add(self, src: int, dst: int, nbytes: int):
        if src == dst:
            self.inner_bytes += nbytes
        else:
            self.inter_bytes += nbytes
            self._ensure(max(src, dst) + 1)
            self.per_machine[src] += nbytes
            self.per_machine[dst] += nbytes

    @property
    def total(self) -> int:
        return self.inner_bytes + self.inter_bytes


@dataclasses.dataclass
class PullPlan:
    """What a worker's next pull would fetch, before committing to it.

    ``delta`` marks the working-set entries whose server value differs from
    the worker's stale buffer (value-delta caching — the same quantity
    ``step()`` meters); ``src_bytes[j]`` is the 4 B/value payload owed by
    server machine ``j``.  Planning is separated from ``pull_nowait`` so a
    serving engine can price each source link (bandwidth × straggle, retry
    timeouts) and exclude dead shards *before* any bytes are metered."""

    worker: int
    need: np.ndarray          # (V,) bool — the request's working set
    delta: np.ndarray         # (V,) bool — entries that must be fetched
    src_bytes: np.ndarray     # (k,) int64 — bytes per source machine

    @property
    def total_bytes(self) -> int:
        return int(self.src_bytes.sum())


@dataclasses.dataclass
class PullHandle:
    """Device future for a non-blocking pull.

    The host→device transfer of the worker's refreshed buffer is issued
    at issue time; ``block()`` waits out the *remaining* modeled wire time
    (``wire_s`` + retry penalties ``wait_s``, clocked from ``issued_at``)
    and then waits on the buffer's stream — so any compute the caller
    issued in between genuinely overlaps the transfer, and the overlap is
    measured rather than assumed."""

    worker: int
    issued_at: float          # perf_counter at issue
    wire_s: float             # modeled transfer time (pure, per live links)
    wait_s: float             # retry/timeout penalty spent on failed links
    inner_bytes: int
    inter_bytes: int
    fresh_entries: int        # entries actually refreshed
    stale_entries: int        # entries left stale (excluded/dead sources)
    buffer: torch.Tensor      # (V,) f32 device copy of the worker's cache
    queue_s: float = 0.0      # NIC-backlog delay ahead of the transfer

    @property
    def done_at(self) -> float:
        return self.issued_at + self.wire_s + self.wait_s + self.queue_s

    def block(self) -> torch.Tensor:
        remaining = self.done_at - time.perf_counter()
        if remaining > 0:
            time.sleep(remaining)
        if self.buffer.is_cuda:
            torch.cuda.current_stream(self.buffer.device).synchronize()
        return self.buffer


class PSCluster:
    @classmethod
    def from_partition(cls, graph, labels, result, cfg, **kw) -> "PSCluster":
        """Build the cluster from a ``repro_torch.api.PartitionResult`` —
        the supported path for wiring a Parsa layout into the PS
        simulation."""
        if result.parts_v is None:
            raise ValueError(
                "PartitionResult has no parts_v; run repro_torch.api."
                "partition with ParsaConfig(refine_v=True)")
        return cls(graph, labels, result.parts_u, result.parts_v,
                   result.k, cfg, **kw)

    def __init__(
        self,
        graph: BipartiteGraph,
        labels: np.ndarray,
        parts_u: np.ndarray,
        parts_v: np.ndarray,
        k: int,
        cfg: DBPGConfig,
        flops_rate: float = 50e9,
        bandwidth: float = 125e6,  # 1 GbE, as in the paper's cluster
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device, "PSCluster")
        self.graph, self.k, self.cfg = graph, k, cfg
        self.parts_u = np.asarray(parts_u)
        self.parts_v = np.asarray(parts_v)
        self.flops_rate, self.bandwidth = flops_rate, bandwidth
        self.need = need_matrix(graph, self.parts_u, k)  # (k, V) bool
        self.owner = self.parts_v.copy()
        rr = np.flatnonzero(self.owner < 0)
        self.owner[rr] = rr % k  # isolated rows: arbitrary owners
        self._labels = np.asarray(labels, np.float32)
        self.rows = [np.flatnonzero(self.parts_u == i) for i in range(k)]
        # per-machine batches and the concatenated oracle batch are built on
        # first use — serving-scale clusters only ever touch a small
        # working set per request and never pay the full conversion
        self._batches: list[SparseBatch] | None = None
        self._full_batch: SparseBatch | None = None
        self.placement_version = 0  # bumped by apply_placement (router sync)
        self.w = torch.zeros(graph.num_v, dtype=torch.float32,
                             device=self.device)
        self.meter = TrafficMeter(per_machine=np.zeros(k, dtype=np.int64))
        self._keys_sent = np.zeros((k, k), dtype=bool)  # push key caching
        self._pull_cache: list[np.ndarray] = [
            np.zeros(graph.num_v, np.float32) for _ in range(k)
        ]
        self._ef = [np.zeros(graph.num_v, np.float32) for _ in range(k)]
        self._hist: list[np.ndarray] = []
        self.rng = np.random.default_rng(seed)

    @property
    def batches(self) -> list[SparseBatch]:
        if self._batches is None:
            self._batches = [
                SparseBatch.from_graph(self.graph, rows, self._labels,
                                       device=self.device)
                for rows in self.rows
            ]
        return self._batches

    @property
    def full_batch(self) -> SparseBatch:
        if self._full_batch is None:
            self._full_batch = SparseBatch.from_graph(
                self.graph, np.arange(self.graph.num_u), self._labels,
                device=self.device)
        return self._full_batch

    def _host_w(self) -> np.ndarray:
        """A host copy of ``w`` (never a view of the tensor's memory)."""
        return self.w.cpu().numpy().copy()

    # ------------------------------------------------------------------
    def apply_placement(self, parts_u: np.ndarray, parts_v: np.ndarray,
                        k: int | None = None) -> dict:
        """Apply a new Parsa placement mid-run (streaming drift repair, or
        an elastic grow/shrink/repair that changes the machine count).

        Re-shards example rows across workers and weight ownership across
        servers, metering the one-time re-sharding traffic in the same
        ``TrafficMeter`` the training loop uses: a moved example row costs
        its nnz × 8 bytes (4 B key + 4 B value per entry), a moved weight
        8 bytes — both inter-machine only when the hosting machine actually
        changes.  Weight values and the optimizer state live in the global
        vector, so training continues exactly where it left off; the push
        key caches are invalidated (working sets changed, keys must be
        re-sent).  Returns the move counts and metered bytes.

        ``k`` changes the machine count (``repro_torch.elastic``):
        departing shards are torn down after their rows/weights are
        re-metered onto their new hosts, spawned shards start with cold
        pull caches (their first pull fetches the full working set, which
        the training loop meters as ordinary pull traffic).  Labels in
        ``parts_u``/``parts_v`` must already be < the new ``k``.
        """
        parts_u = np.asarray(parts_u)
        parts_v = np.asarray(parts_v)
        new_k = self.k if k is None else int(k)
        if new_k < 1:
            raise ValueError(f"k must be >= 1, got {new_k}")
        if parts_u.shape != self.parts_u.shape:
            raise ValueError(
                f"parts_u shape {parts_u.shape} != cluster's "
                f"{self.parts_u.shape} (PSCluster serves a fixed graph)")
        if parts_v.shape != self.parts_v.shape:
            raise ValueError(
                f"parts_v shape {parts_v.shape} != cluster's "
                f"{self.parts_v.shape}")
        if parts_u.size and int(parts_u.max()) >= new_k:
            raise ValueError(
                f"parts_u labels reach {int(parts_u.max())} but k={new_k}")
        if parts_v.size and int(parts_v.max()) >= new_k:
            raise ValueError(
                f"parts_v labels reach {int(parts_v.max())} but k={new_k}")
        new_owner = parts_v.copy()
        rr = np.flatnonzero(new_owner < 0)
        new_owner[rr] = rr % new_k
        bytes_before = self.meter.total
        # src labels live in the old fleet, dst labels in the new one —
        # meter over the union so grow/shrink transfers land on both ends
        km = max(self.k, new_k)
        if km > self.meter.per_machine.shape[0]:
            self.meter.per_machine = np.concatenate(
                [self.meter.per_machine,
                 np.zeros(km - self.meter.per_machine.shape[0], np.int64)])
        # moved example rows: delta-encoded batch re-shard, 8 B per entry
        # (4 B key + 4 B value); per-(src, dst) byte totals in two
        # vectorized bincount passes instead of k² full-array masks
        deg = np.diff(self.graph.u_indptr)
        pair_u = self.parts_u.astype(np.int64) * km + parts_u
        row_bytes = np.bincount(pair_u, weights=deg * 8.0,
                                minlength=km * km).reshape(km, km)
        moved_rows = int((self.parts_u != parts_u).sum())
        # moved weights: value + key per parameter changing its server
        moved_w = self.owner != new_owner
        moved_weights = int(moved_w.sum())
        pair_v = self.owner[moved_w].astype(np.int64) * km + new_owner[moved_w]
        w_bytes = np.bincount(pair_v, minlength=km * km).reshape(km, km) * 8
        for i in range(km):
            for j in range(km):
                if i == j:
                    continue
                nbytes = int(row_bytes[i, j]) + int(w_bytes[i, j])
                if nbytes:
                    self.meter.add(i, j, nbytes)
        # rebuild the sharded state for the new placement (shard teardown /
        # spawn when the machine count changed)
        if new_k != self.k:
            if new_k > self.k:
                self._pull_cache.extend(
                    np.zeros(self.graph.num_v, np.float32)
                    for _ in range(new_k - self.k))
            else:
                del self._pull_cache[new_k:]
            self.meter.per_machine = np.concatenate(
                [self.meter.per_machine[:new_k],
                 np.zeros(max(0, new_k - self.meter.per_machine.shape[0]),
                          np.int64)])
            self._keys_sent = np.zeros((new_k, new_k), dtype=bool)
            self.k = new_k
        else:
            self.meter.per_machine = self.meter.per_machine[:new_k]
            self._keys_sent[:] = False
        self.parts_u = parts_u.copy()
        self.parts_v = parts_v.copy()
        self.owner = new_owner
        self.need = need_matrix(self.graph, self.parts_u, self.k)
        self.rows = [np.flatnonzero(self.parts_u == i)
                     for i in range(self.k)]
        self._batches = None  # rebuilt lazily for the new row shards
        self.placement_version += 1
        # error-feedback residuals are supported on the OLD working sets;
        # under the new need masks the stranded coordinates could neither
        # be sent nor dropped — start the accumulators clean instead
        self._ef = [np.zeros(self.graph.num_v, np.float32)
                    for _ in range(self.k)]
        return {
            "moved_rows": moved_rows,
            "moved_weights": moved_weights,
            "reshard_bytes": self.meter.total - bytes_before,
        }

    def _worker_view(self, i: int, t: int) -> np.ndarray:
        """Weights as seen by worker i at iteration t under delay ≤ τ."""
        tau = self.cfg.max_delay
        if tau <= 0 or not self._hist:
            return self._host_w()
        d = int(self.rng.integers(0, tau + 1))
        d = min(d, len(self._hist))
        return self._hist[-d] if d > 0 else self._host_w()

    # ------------------------------------------------------------------
    # non-blocking pull API (serving): plan → issue → overlap → block.
    # Byte accounting is identical to step()'s pull/push metering — value-
    # delta caching on pull, key caching + optional int8 compression on
    # push — but split into separate calls so a serving engine can overlap
    # the modeled wire time with device compute.

    def plan_pull(self, worker: int,
                  need: np.ndarray | None = None) -> PullPlan:
        """Price worker's next pull without transferring anything.

        ``need`` restricts the working set (a request touching few rows
        needs few weights); defaults to the worker's full §2.3 need mask."""
        need = self.need[worker] if need is None else np.asarray(need, bool)
        w_host = self._host_w()
        delta = need & (w_host != self._pull_cache[worker])
        src_bytes = np.bincount(self.owner[delta], minlength=self.k) * 4
        plan = PullPlan(worker=worker, need=need, delta=delta,
                        src_bytes=src_bytes.astype(np.int64))
        trace_instant("ps.plan_pull", worker=worker,
                      nbytes=int(plan.total_bytes))
        return plan

    def pull_nowait(self, plan: PullPlan, exclude: frozenset = frozenset(),
                    wire_s: float = 0.0, wait_s: float = 0.0,
                    queue_s: float = 0.0) -> PullHandle:
        """Issue the planned pull; returns a device future immediately.

        ``exclude`` lists source machines that failed their retry budget
        (dead or timed-out shards): their entries stay stale in the
        worker's buffer — the §4.3 bounded-staleness fallback — and cost
        no bytes.  ``wire_s``/``wait_s``/``queue_s`` are the modeled
        transfer time, retry penalty, and NIC-backlog delay (priced by the
        caller's bandwidth model and link clock); the returned handle's
        ``block()`` makes them real wall-clock."""
        worker = plan.worker
        w_host = self._host_w()
        fetch = plan.delta.copy()
        stale_entries = 0
        for j in exclude:
            if j == worker:
                continue  # local slice never travels; cannot go stale
            from_j = plan.delta & (self.owner == j)
            stale_entries += int(from_j.sum())
            fetch &= ~from_j
        inner = inter = 0
        per_src = np.bincount(self.owner[fetch], minlength=self.k)
        for j in np.flatnonzero(per_src):
            cnt = int(per_src[j])
            self.meter.add(int(j), worker, cnt * 4)
            if j == worker:
                inner += cnt * 4
            else:
                inter += cnt * 4
        cache = self._pull_cache[worker]
        cache[fetch] = w_host[fetch]
        # a copy before the device transfer: later cache mutations (the
        # next pull) must not alias into a buffer still being computed on
        buffer = torch.from_numpy(cache.copy()).to(self.device,
                                                   non_blocking=True)
        trace_instant("ps.pull_nowait", worker=worker,
                      fresh=int(fetch.sum()), stale=stale_entries,
                      inter_bytes=inter)
        return PullHandle(
            worker=worker, issued_at=time.perf_counter(),
            wire_s=float(wire_s), wait_s=float(wait_s),
            inner_bytes=inner, inter_bytes=inter,
            fresh_entries=int(fetch.sum()), stale_entries=stale_entries,
            buffer=buffer, queue_s=float(queue_s))

    def meter_push(self, worker: int, mask: np.ndarray) -> dict:
        """Meter worker's push of gradient entries ``mask`` to the owning
        servers (step()'s push accounting: per-entry values plus a 4 B key
        the first time a (worker, server) pair ships that link)."""
        mask = np.asarray(mask, bool)
        val_bytes = 1 if self.cfg.compress else 4
        inner = inter = 0
        per_server = np.bincount(self.owner[mask], minlength=self.k)
        for j in np.flatnonzero(per_server):
            cnt = int(per_server[j])
            nbytes = cnt * val_bytes
            if not self._keys_sent[worker, j]:
                nbytes += cnt * 4
                self._keys_sent[worker, j] = True
            self.meter.add(worker, int(j), nbytes)
            if j == worker:
                inner += nbytes
            else:
                inter += nbytes
        return {"inner_bytes": inner, "inter_bytes": inter}

    def commit_weights(self, new_w) -> None:
        """Server-side commit of the proximal update (serving push path)."""
        if isinstance(new_w, torch.Tensor):
            self.w = new_w.to(self.device, torch.float32)
        else:
            self.w = torch.tensor(np.asarray(new_w), dtype=torch.float32,
                                  device=self.device)

    def step(self, t: int) -> dict:
        k, cfg, dev = self.k, self.cfg, self.device
        val_bytes = 1 if cfg.compress else 4
        agg = np.zeros(self.graph.num_v, np.float64)
        flops = np.zeros(k)
        for i in range(k):
            w_view = torch.from_numpy(self._worker_view(i, t)).to(dev)
            g = lr_grad(self.batches[i], w_view).cpu().numpy()
            if cfg.error_feedback and cfg.compress:
                g = g + self._ef[i]
            flops[i] = 4.0 * self.batches[i].values.shape[0]
            send_mask = self.need[i].copy()
            if cfg.kkt_eps > 0:
                keep = kkt_filter(w_view, torch.from_numpy(g).to(dev),
                                  cfg.lam, cfg.kkt_eps).cpu().numpy()
                send_mask &= keep
            if cfg.compress:
                sent = np.zeros_like(g)
                idx = np.flatnonzero(send_mask)
                if idx.size:
                    q, scale = quantize_int8(torch.from_numpy(g[idx]).to(dev))
                    sent[idx] = dequantize_int8(q, scale).cpu().numpy()
                if cfg.error_feedback:
                    self._ef[i] = g - sent
                payload = sent
            else:
                payload = np.where(send_mask, g, 0.0)
            agg += payload
            # ---- push traffic: entries per owning server
            for j in range(k):
                cnt = int((send_mask & (self.owner == j)).sum())
                if cnt == 0:
                    continue
                nbytes = cnt * val_bytes
                if not self._keys_sent[i, j]:
                    nbytes += cnt * 4  # key list, sent once
                    self._keys_sent[i, j] = True
                self.meter.add(i, j, nbytes)
        # ---- server proximal update (each server updates its slice; we hold
        # the concatenated global vector)
        w_old = self._host_w()
        new_w_dev = prox_step(
            self.w, torch.from_numpy(agg.astype(np.float32)).to(dev), cfg)
        new_w = new_w_dev.cpu().numpy().copy()
        self._hist.append(w_old)
        if len(self._hist) > max(cfg.max_delay, 1) + 1:
            self._hist.pop(0)
        self.w = new_w_dev
        # ---- pull traffic: changed values in each worker's working set
        for i in range(k):
            stale = self._pull_cache[i]
            need_i = self.need[i]
            delta = need_i & (new_w != stale)
            for j in range(k):
                cnt = int((delta & (self.owner == j)).sum())
                if cnt:
                    self.meter.add(j, i, cnt * 4)
            stale[need_i] = new_w[need_i]
        inter_now = int(self.meter.per_machine.max())
        time = flops.max() / self.flops_rate + inter_now / self.bandwidth
        return {"modeled_time_cum": time}

    def run(self, iters: int, lam: float | None = None, log_every: int = 0) -> dict:
        lam = self.cfg.lam if lam is None else lam
        objs = []
        for t in range(iters):
            self.step(t)
            if log_every and (t % log_every == 0 or t == iters - 1):
                objs.append(float(lr_objective(self.full_batch, self.w, lam)))
        total_flops = 4.0 * self.full_batch.values.shape[0] * iters
        compute_time = total_flops / self.flops_rate / self.k
        comm_time = self.meter.per_machine.max() / self.bandwidth
        return {
            "objective": objs,
            "inner_bytes": self.meter.inner_bytes,
            "inter_bytes": self.meter.inter_bytes,
            "total_bytes": self.meter.total,
            "inner_fraction": self.meter.inner_bytes / max(self.meter.total, 1),
            "modeled_time_s": compute_time + comm_time,
            "modeled_compute_s": compute_time,
            "modeled_comm_s": comm_time,
            "nnz_w": int((self._host_w() != 0).sum()),
        }
