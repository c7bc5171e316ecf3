"""Parsa-driven MoE expert placement.

The (token-group × expert) affinity graph: U = groups of consecutive tokens
(a proxy for the sequences a data shard owns), V = experts; an edge means
the group routed ≥1 token to the expert.  Parsa's V-partition maps experts
to EP shards so that each data shard's routed experts are mostly local,
shrinking the all-to-all.  U-partition co-locates groups with correlated
routing.  Output is an expert permutation consumed by the MoE layer's
EP sharding (experts are laid out contiguously per shard).

A copy of ``repro.core.moe_placement``; ``build_expert_placement``
partitions on ``device`` (the card unless the caller passes
``device="cpu"``), and takes the refine's backend (``refine_backend``,
the reference's ``"host"`` by default; ``"device"`` runs it on the card
too, with the same bits).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bipartite import from_edges
from .placement import placement_from_parts

__all__ = ["ExpertPlacement", "build_expert_placement", "alltoall_traffic"]


@dataclasses.dataclass
class ExpertPlacement:
    k: int
    expert_to_shard: np.ndarray   # (num_experts,)
    expert_perm: np.ndarray       # new position of each expert id
    group_to_shard: np.ndarray


def build_expert_placement(
    routing_counts: np.ndarray,  # (num_groups, num_experts) int — tokens routed
    k: int,
    seed: int = 0,
    backend: str = "host",
    device: str | torch.device = "cuda",
    refine_backend: str = "host",
) -> ExpertPlacement:
    """Parsa-place experts via the ``repro_torch.api`` facade (one call:
    U + V) on ``device``."""
    from ..api import ParsaConfig, partition  # lazy: core ↔ api

    groups, experts = routing_counts.shape
    gu, gv = np.nonzero(routing_counts)
    g = from_edges(groups, experts, gu, gv)
    res = partition(g, ParsaConfig(k=k, backend=backend, seed=seed,
                                   refine_v=True, sweeps=2,
                                   refine_backend=refine_backend),
                    device=device)
    # the embedding layout's rule: unused experts round-robin over the
    # least-loaded shards, then each shard's experts contiguous
    pl = placement_from_parts(res.parts_u, res.parts_v, experts, k)
    return ExpertPlacement(k, pl.vocab_to_shard, pl.vocab_perm,
                           pl.doc_to_shard)


def alltoall_traffic(
    routing_counts: np.ndarray, placement: ExpertPlacement, token_bytes: int = 2
) -> dict:
    """Tokens crossing shards under the placement vs. round-robin experts."""
    groups, experts = routing_counts.shape
    k = placement.k

    def cross(expert_shard: np.ndarray, group_shard: np.ndarray) -> int:
        total = 0
        for gidx in range(groups):
            gs = group_shard[gidx]
            counts = routing_counts[gidx]
            remote = counts[expert_shard != gs].sum()
            total += int(remote)
        return total

    rr_expert = np.arange(experts) % k
    rr_group = np.arange(groups) % k
    base = cross(rr_expert, rr_group)
    opt = cross(placement.expert_to_shard, placement.group_to_shard)
    return {
        "crossing_tokens_roundrobin": base,
        "crossing_tokens_parsa": opt,
        "bytes_roundrobin": base * token_bytes,
        "bytes_parsa": opt * token_bytes,
        "reduction": 1.0 - opt / max(base, 1),
    }
