"""§4.2 division into subgraphs + §4.4 neighbor-set initialization.

Parsa splits U into b blocks, builds the b induced subgraphs (V ids stay
global so the shared neighbor sets S_i compose), and feeds them sequentially
through Algorithm 3, carrying S_i forward.  b trades quality (b=1: global
greedy) against speed/IO (b=|U|: random partition).

Initialization (§4.4):
  * individual — run ``a`` extra iterations first; after each, *reset*
    S_i ← N(U_{i,j}) and drop the assignments (keeping them would pin every
    vertex to its old partition at cost 0);
  * global     — partition a small sample once, use its neighbor sets to
    seed every worker (see parallel.py);
  * incremental — seed S_i from a previous run's result.

A copy of ``repro.core.subgraphs`` without its deprecated
``sequential_parsa`` shim (the facade's ``backend="host"`` reaches it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..kernels.parsa_cost.pack import coerce_dense_sets
from .bipartite import BipartiteGraph
from .costs import need_matrix
from .partition_u import partition_u_impl

__all__ = ["divide", "sequential_parsa_impl", "SubgraphPlan"]


@dataclasses.dataclass
class SubgraphPlan:
    """b random blocks of U and their induced subgraphs (global V ids)."""

    blocks: list[np.ndarray]          # u-id arrays
    subgraphs: list[BipartiteGraph]


def divide(graph: BipartiteGraph, b: int, seed: int = 0) -> SubgraphPlan:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(graph.num_u)
    blocks = [np.sort(x) for x in np.array_split(perm, b)]
    return SubgraphPlan(blocks, [graph.subgraph_u(blk) for blk in blocks])


def sequential_parsa_impl(
    graph: BipartiteGraph,
    k: int,
    b: int = 16,
    a: int = 0,
    theta: int = 1000,
    select: str = "size",
    seed: int = 0,
    init_sets: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Single-thread Parsa: a init iterations + b real iterations (§4.2/§4.4).

    Returns (parts_u over the full graph, final neighbor sets S (k, |V|)
    bool).  ``init_sets`` supports the incremental-partitioning mode (seed
    from a previous run).
    """
    plan = divide(graph, b, seed=seed)
    if init_sets is None:
        S = np.zeros((k, graph.num_v), dtype=bool)
    else:
        S = coerce_dense_sets(init_sets, graph.num_v).copy()

    # ---- individual initialization: partition, then RESET S to the fresh
    # neighbor sets and drop assignments (§4.4).
    for t in range(a):
        sg = plan.subgraphs[t % b]
        res = partition_u_impl(sg, k, init_sets=S, theta=theta, select=select,
                               seed=seed + t)
        S = need_matrix(sg, res.parts_u, k)  # reset: S_i ← N(U_{i,t})

    # ---- real pass: union-accumulate S, keep assignments.
    parts_u = np.full(graph.num_u, -1, dtype=np.int32)
    for j in range(b):
        sg = plan.subgraphs[j]
        res = partition_u_impl(sg, k, init_sets=S, theta=theta, select=select,
                               seed=seed + a + j)
        parts_u[plan.blocks[j]] = res.parts_u
        S = res.neighbor_sets  # already S ∪ N(U_{i,j})
    return parts_u, S
