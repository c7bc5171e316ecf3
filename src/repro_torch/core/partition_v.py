"""Algorithm 2: partition V for given {U_i} (paper §3.2) — numpy oracle.

Greedy sweep over the totally-unimodular convex integer program (8): each
parameter v_j goes to the needing partition with the current minimum cost;
the cost update is

    cost_ξ ← cost_ξ − 1 + Σ_{i≠ξ} u_ij            (Alg 2 line 8)

Repeated sweeps re-assign one variable at a time and converge to a global
optimum.  This loop serves ``refine_backend="host"`` and is the parity
oracle of ``repro_torch.core.refine.refine_v_device``.  A copy of
``repro.core.partition_v``.
"""
from __future__ import annotations

import numpy as np

from .bipartite import BipartiteGraph
from .costs import need_matrix

__all__ = ["partition_v"]


def partition_v(
    graph: BipartiteGraph,
    parts_u: np.ndarray,
    k: int,
    sweeps: int = 1,
    need: np.ndarray | None = None,
) -> np.ndarray:
    """Return parts_v (|V|,) int32; -1 for isolated parameters (never needed)."""
    if need is None:
        need = need_matrix(graph, parts_u, k)  # (k, |V|) bool == u_ij
    num_v = graph.num_v
    nneed = need.sum(axis=0).astype(np.int64)  # Σ_i u_ij per parameter

    parts_v = np.full(num_v, -1, dtype=np.int32)
    # lines 1–4: cost_i ← |N(U_i)|
    cost = need.sum(axis=1).astype(np.int64)

    order = np.arange(num_v)
    for sweep in range(sweeps):
        changed = 0
        for j in order:
            nj = int(nneed[j])
            if nj == 0:
                continue  # isolated parameter: no server ever needs it
            cur = int(parts_v[j])
            if cur >= 0:
                # retract j's contribution before re-assigning (sweep ≥ 2)
                cost[cur] -= -1 + (nj - int(need[cur, j]))
            needers = np.flatnonzero(need[:, j])
            xi = int(needers[np.argmin(cost[needers])])
            parts_v[j] = xi
            # line 8: cost_ξ ← cost_ξ − 1 + Σ_{i≠ξ} u_ij
            cost[xi] += -1 + (nj - 1)
            changed += int(xi != cur)
        if sweep > 0 and changed == 0:
            break
    return parts_v
