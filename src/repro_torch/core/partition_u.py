r"""Algorithm 3: partition U efficiently, O(k|E|) (paper §4.1).

Faithful sequential reference, on the host.  Per partition i we maintain

  * ``S_i``   — the (global-V-id) neighbor set, a bool bitmap,
  * ``A_i``   — vertex costs  cost_i(u) = |N(u) \ S_i|  in a monotone
                bucket queue (the paper's array + doubly-linked list with
                head pointers; see bucket_queue.py).

Loop (Alg 3 lines 5–15): pick a partition, pop its lowest-cost vertex,
assign, fold N(u*) into S_i, and decrement the cost of every still-
unassigned U-neighbor of each *newly covered* v — each (edge, partition)
pair is touched at most once ⇒ O(k|E|).

``select`` chooses the partition per step:
  * ``"size"``      — argmin |U_i| (Alg 1 line 7; §4.1's "assign one vertex
                      at a time to the smallest partition ⇒ perfect
                      balancing").  Default.
  * ``"footprint"`` — argmin |S_i| (Alg 3 line 6 as printed; balances the
                      memory objective (6) instead).

A copy of ``repro.core.partition_u`` without its deprecated
``partition_u`` shim (the facade's ``backend="host"`` reaches it).
"""
from __future__ import annotations

import numpy as np

from ..kernels.parsa_cost.pack import coerce_dense_sets
from .bipartite import BipartiteGraph
from .bucket_queue import BucketQueue

__all__ = ["partition_u_impl", "PartitionUResult"]


class PartitionUResult:
    def __init__(self, parts_u: np.ndarray, neighbor_sets: np.ndarray):
        self.parts_u = parts_u          # (|U|,) int32
        self.neighbor_sets = neighbor_sets  # (k, |V|) bool — updated S_i


def partition_u_impl(
    graph: BipartiteGraph,
    k: int,
    init_sets: np.ndarray | None = None,
    theta: int = 1000,
    select: str = "size",
    seed: int = 0,
    copy_init: bool = True,
) -> PartitionUResult:
    """Run Algorithm 3 on ``graph`` with optional initial neighbor sets S_i.

    ``copy_init=False`` adopts ``init_sets`` as the working S and mutates it
    in place — callers that already materialized a private dense scratch
    (e.g. the Alg 4 worker pull in ``parallel.py``) skip the per-call
    (k, |V|) copy.  ``init_sets`` may also arrive packed ((k, W) int32
    words, e.g. ``PartitionResult.s_masks``); it is unpacked into a fresh
    scratch either way.
    """
    num_u, num_v = graph.num_u, graph.num_v
    if init_sets is not None and not (
            isinstance(init_sets, np.ndarray) and init_sets.dtype == np.bool_
            and init_sets.shape == (k, num_v)):
        init_sets = coerce_dense_sets(init_sets, num_v)
    if init_sets is None:
        S = np.zeros((k, num_v), dtype=bool)
    elif copy_init:
        S = np.asarray(init_sets, dtype=bool).copy()
        assert S.shape == (k, num_v)
    else:
        S = init_sets
        assert S.dtype == bool and S.shape == (k, num_v) and S.flags.writeable

    # line 3: A_i(u) = |N(u) \ S_i| for all u — vectorized per partition.
    indptr, indices = graph.u_indptr, graph.u_indices
    deg = np.diff(indptr).astype(np.int64)
    row_of_edge = np.repeat(np.arange(num_u), deg)
    queues: list[BucketQueue] = []
    for i in range(k):
        covered = np.bincount(
            row_of_edge, weights=S[i][indices].astype(np.float64),
            minlength=num_u).astype(np.int64) if graph.num_edges else \
            np.zeros(num_u, dtype=np.int64)
        queues.append(BucketQueue(deg - covered, theta=theta))

    parts_u = np.full(num_u, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    ssize = S.sum(axis=1).astype(np.int64)
    rng = np.random.default_rng(seed)
    order_noise = rng.random(k) * 1e-9  # deterministic tie-break jitter

    v_indptr, v_indices = graph.v_indptr, graph.v_indices

    for _ in range(num_u):
        # line 6: pick the partition to grow
        crit = sizes if select == "size" else ssize
        i = int(np.argmin(crit + order_noise))
        # line 7: lowest-cost vertex for partition i
        u_star, _ = queues[i].pop_min()
        # lines 8–10: assign, remove from all queues
        parts_u[u_star] = i
        sizes[i] += 1
        for j in range(k):
            if j != i:
                queues[j].delete(u_star)
        # lines 11–14: fold new coverage into S_i, decrement affected costs
        nbrs = indices[indptr[u_star] : indptr[u_star + 1]]
        new_vs = nbrs[~S[i][nbrs]]
        if new_vs.size:
            S[i][new_vs] = True
            ssize[i] += new_vs.size
            q = queues[i]
            cost, in_q = q.cost, q.in_queue
            for v in new_vs:
                for u in v_indices[v_indptr[v] : v_indptr[v + 1]]:
                    if in_q[u]:
                        q.decrease(int(u), int(cost[u]) - 1)
    return PartitionUResult(parts_u, S)
