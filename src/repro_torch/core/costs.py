"""Partitioning objectives (paper §2.4, eqs. (4), (6), (7)) — host oracles.

Conventions: ``parts_u[i] ∈ [0,k)`` assigns example u_i to worker
``parts_u[i]``; ``parts_v[j] ∈ [0,k)`` (or -1 = unassigned/isolated) assigns
parameter v_j to server ``parts_v[j]``.  Machine m hosts worker m + server m.

``need_matrix`` / ``evaluate`` are the numpy parity oracles of the packed-word
torch versions in ``repro_torch.core.refine``; ``random_parts`` is the
paper's baseline placement.  A copy of ``repro.core.costs``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bipartite import BipartiteGraph

__all__ = ["PartitionMetrics", "evaluate", "improvement", "need_matrix",
           "random_parts"]


@dataclasses.dataclass
class PartitionMetrics:
    k: int
    sizes: np.ndarray          # |U_i|                      — objective (4)
    footprint: np.ndarray      # |N(U_i)|                   — objective (6)
    traffic: np.ndarray        # per-machine traffic        — objective (7)
    worker_recv: np.ndarray    # |N(U_i) \ V_i|
    server_send: np.ndarray    # Σ_{j≠i} |V_i ∩ N(U_j)|

    @property
    def size_max(self) -> int:
        return int(self.sizes.max())

    @property
    def mem_max(self) -> int:
        return int(self.footprint.max())

    @property
    def traffic_max(self) -> int:
        return int(self.traffic.max())

    @property
    def traffic_sum(self) -> int:
        return int(self.traffic.sum())

    def as_dict(self) -> dict:
        return {
            "k": self.k,
            "size_max": self.size_max,
            "mem_max": self.mem_max,
            "traffic_max": self.traffic_max,
            "traffic_sum": self.traffic_sum,
        }


def need_matrix(graph: BipartiteGraph, parts_u: np.ndarray, k: int) -> np.ndarray:
    """(k, |V|) bool: need[i, j] == (v_j ∈ N(U_i))  — the u_ij of eq. (8)."""
    need = np.zeros((k, graph.num_v), dtype=bool)
    edge_part = np.repeat(parts_u.astype(np.int64), np.diff(graph.u_indptr))
    need[edge_part, graph.u_indices] = True
    return need


def evaluate(
    graph: BipartiteGraph,
    parts_u: np.ndarray,
    parts_v: np.ndarray | None,
    k: int,
) -> PartitionMetrics:
    """Compute objectives (4), (6), (7) exactly.

    With ``parts_v=None`` only the V-independent terms are reported (traffic
    defaults to the worker working-set size — all pulls remote).
    """
    parts_u = np.asarray(parts_u)
    sizes = np.bincount(parts_u, minlength=k).astype(np.int64)
    need = need_matrix(graph, parts_u, k)
    footprint = need.sum(axis=1).astype(np.int64)
    if parts_v is None:
        worker = footprint.copy()
        server = np.zeros(k, dtype=np.int64)
        return PartitionMetrics(k, sizes, footprint, worker + server, worker, server)
    parts_v = np.asarray(parts_v)
    # worker i pulls parameters it needs but does not host: |N(U_i) \ V_i|
    worker = np.zeros(k, dtype=np.int64)
    # server i answers requests from other workers: Σ_{j≠i} |V_i ∩ N(U_j)|
    server = np.zeros(k, dtype=np.int64)
    nneed = need.sum(axis=0).astype(np.int64)  # how many partitions need v_j
    for i in range(k):
        mine = parts_v == i
        local_hits = need[i] & mine
        worker[i] = footprint[i] - int(local_hits.sum())
        server[i] = int((nneed[mine] - need[i][mine].astype(np.int64)).sum())
    return PartitionMetrics(k, sizes, footprint, worker + server, worker, server)


def random_parts(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Balanced random assignment — the paper's baseline."""
    rng = np.random.default_rng(seed)
    parts = np.arange(n, dtype=np.int32) % k
    rng.shuffle(parts)
    return parts


def improvement(random_val: float, proposed_val: float) -> float:
    """Paper §5.1: (random - proposed) / proposed × 100%."""
    if proposed_val == 0:
        return float("inf")
    return (random_val - proposed_val) / proposed_val * 100.0
