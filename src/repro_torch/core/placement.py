"""Parsa-driven vocabulary/embedding placement for the LM stack.

The (document × token-id) incidence graph is exactly the paper's Fig. 2
bipartite graph: U = documents, V = vocabulary rows.  Parsa's U-partition
assigns documents to data shards, its V-partition assigns embedding rows to
model shards.  We expose the result as a ``Placement``:

  * ``doc_to_shard``   — feeds data/pipeline.py (which documents each data
    shard reads);
  * ``vocab_perm``     — a permutation of vocab ids such that rows owned by
    shard s occupy the contiguous slice s; the embedding table sharded over
    the ``model`` axis then holds each shard's *hot* vocabulary locally;
  * traffic accounting — exact remote-row counts per step, the quantity
    Table 4 measures (reproduced for embedding gathers).

A copy of ``repro.core.placement``: the same partition gives the same
arrays.  ``build_placement`` partitions on ``device`` (the card unless
the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bipartite import BipartiteGraph
from .costs import evaluate, need_matrix

__all__ = ["Placement", "build_placement", "placement_from_parts",
           "gather_traffic"]


@dataclasses.dataclass
class Placement:
    k: int
    doc_to_shard: np.ndarray      # (num_docs,) int32
    vocab_to_shard: np.ndarray    # (vocab,) int32  (-1 = never used → round-robin)
    vocab_perm: np.ndarray        # (vocab,) new position of each vocab id
    vocab_unperm: np.ndarray      # inverse permutation
    shard_row_counts: np.ndarray  # (k,) rows per shard after permutation

    def permute_ids(self, token_ids: np.ndarray) -> np.ndarray:
        return self.vocab_perm[token_ids]


def placement_from_parts(
    parts_u: np.ndarray,
    parts_v: np.ndarray,
    num_v: int,
    k: int,
) -> Placement:
    """Derive the embedding layout from finished (parts_u, parts_v)."""
    # unused vocab rows: spread round-robin over the least-loaded shards
    parts_v = np.asarray(parts_v).copy()
    unused = np.flatnonzero(parts_v < 0)
    if unused.size:
        counts = np.bincount(parts_v[parts_v >= 0], minlength=k)
        fill = np.argsort(counts, kind="stable")
        parts_v[unused] = fill[np.arange(unused.size) % k]
    # build the contiguous permutation: rows of shard 0 first, etc.
    order = np.argsort(parts_v, kind="stable")
    vocab_perm = np.empty(num_v, dtype=np.int64)
    vocab_perm[order] = np.arange(num_v)
    counts = np.bincount(parts_v, minlength=k).astype(np.int64)
    return Placement(
        k=k,
        doc_to_shard=np.asarray(parts_u).astype(np.int32),
        vocab_to_shard=parts_v.astype(np.int32),
        vocab_perm=vocab_perm,
        vocab_unperm=order,
        shard_row_counts=counts,
    )


def build_placement(
    graph: BipartiteGraph,
    k: int,
    b: int = 8,
    a: int = 4,
    sweeps: int = 2,
    seed: int = 0,
    method: str = "parsa",
    backend: str = "host",
    device: str | torch.device = "cuda",
) -> Placement:
    """Partition the doc×vocab graph and derive the embedding layout.

    ``method="parsa"`` runs the whole pipeline through
    ``repro_torch.api.partition`` on the chosen ``backend`` and
    ``device``.  Asked for ``cuda`` with no card there, it raises, as
    ``partition`` does, whatever the method."""
    from ..api import ParsaConfig, partition, resolve_device  # lazy: cycle

    device = resolve_device(device, "build_placement")
    if method == "parsa":
        cfg = ParsaConfig(
            k=k, backend=backend,
            blocks=b if b > 1 else 1,
            init_iters=a if b > 1 else 0,  # b<=1 runs plain Alg 3
            sweeps=sweeps, seed=seed, refine_v=True, placement=True)
        return partition(graph, cfg, device=device).placement
    if method == "random":
        rng = np.random.default_rng(seed)
        parts_u = rng.permutation(np.arange(graph.num_u) % k).astype(np.int32)
        parts_v = rng.permutation(np.arange(graph.num_v) % k).astype(np.int32)
        return placement_from_parts(parts_u, parts_v, graph.num_v, k)
    raise ValueError(method)


def gather_traffic(graph: BipartiteGraph, placement: Placement) -> dict:
    """Exact embedding-gather traffic per optimizer step (unique rows model,
    as in the parameter server's key-cached pulls)."""
    m = evaluate(graph, placement.doc_to_shard, placement.vocab_to_shard, placement.k)
    need = need_matrix(graph, placement.doc_to_shard, placement.k)
    local = sum(
        int((need[i] & (placement.vocab_to_shard == i)).sum())
        for i in range(placement.k)
    )
    total_need = int(need.sum())
    return {
        "remote_rows_max": m.traffic_max,
        "remote_rows_sum": m.traffic_sum,
        "local_fraction": local / max(total_need, 1),
        "footprint_max": m.mem_max,
    }
