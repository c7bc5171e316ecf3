"""Migration planning between two partitions of the same stream.

A drift-triggered full repartition hands back fresh labels that have no
relation to the old ones: applied naively, nearly every example and server
set would "move".  The planner matches new→old parts by greedy maximum
weight on the ``(k, k)`` packed intersection matrix

    M[i, j] = |S_new_i ∩ S_old_j|     (popcounts over packed words)

and relabels the new partition through that matching — quality is
label-invariant, so the relabeled partition is the same partition, but
machine j now keeps the new part whose working set overlaps its resident
set most.  What still differs after relabeling is the true migration cost,
metered in the same units as ``TrafficCounters`` (bitmask-word bytes, 4
bytes per 32 parameters) and reported in its ``migration_bytes`` field so
recovery traffic never pollutes the steady-state push/pull counters: the
packed words each machine must newly acquire (``packed_delta(new, old)``),
the words it can retire, and moved U rows as delta-encoded example traffic
when degrees are provided.  ``MigrationPlan.acquired_bytes`` /
``retired_bytes`` keep the two directions separable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..api_backends import TrafficCounters
from ..kernels.parsa_cost import packed_delta, packed_intersect_counts

__all__ = ["MigrationPlan", "plan_migration"]


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Relabeling + metered cost of swapping a live partition for a new one.

    ``assign[i]`` is the old label that new part ``i`` takes over, so the
    relabeled assignment is ``parts = assign[new_parts]`` and machine
    ``assign[i]`` hosts new part ``i``.
    """

    assign: np.ndarray          # (k,) int32 — new part i → old label
    parts_u: np.ndarray         # (|U|,) int32 relabeled new assignment
    s_masks: np.ndarray         # (k, W) int32 relabeled new server sets
    moved_u: int                # examples whose machine changed
    kept_overlap: int           # Σ_i M[i, assign[i]] — parameters retained
    traffic: TrafficCounters    # migration_bytes, TrafficCounters units
    acquired_bytes: int = 0     # words newly hosted (+ moved example rows)
    retired_bytes: int = 0      # words machines may drop


def _greedy_match(M: np.ndarray) -> np.ndarray:
    """Greedy maximum-weight perfect matching on a (k, k) score matrix:
    repeatedly take the globally largest unmatched cell.  Returns
    ``assign`` with ``assign[i] = j`` (row i matched to column j)."""
    k = M.shape[0]
    score = M.astype(np.int64).copy()
    assign = np.full(k, -1, np.int32)
    for _ in range(k):
        i, j = np.unravel_index(np.argmax(score), score.shape)
        assign[i] = j
        score[i, :] = -1
        score[:, j] = -1
    return assign


def plan_migration(
    new_parts: np.ndarray,
    new_masks: np.ndarray,
    old_parts: np.ndarray,
    old_masks: np.ndarray,
    degrees: np.ndarray | None = None,
) -> MigrationPlan:
    """Match a fresh partition onto the live one and meter the swap.

    ``old_parts`` may cover fewer U rows than ``new_parts`` (the stream
    grew since the old labels were assigned); only the common prefix counts
    toward ``moved_u``.  ``degrees``, when given (per-U edge counts of the
    common prefix), adds the moved rows' delta-encoded example bytes
    (4 bytes per edge) to ``pushed_bytes``.
    """
    new_parts = np.asarray(new_parts, np.int32)
    old_parts = np.asarray(old_parts, np.int32)
    new_masks = np.asarray(new_masks)
    old_masks = np.asarray(old_masks)
    k, W = new_masks.shape
    if old_masks.shape != (k, W):
        raise ValueError(
            f"old/new server sets disagree: {old_masks.shape} vs {(k, W)}")
    M = packed_intersect_counts(new_masks, old_masks)    # (k, k)
    assign = _greedy_match(M)
    parts = assign[new_parts]
    masks = np.zeros_like(new_masks)
    masks[assign] = new_masks                            # row assign[i] = new i
    n_common = min(old_parts.shape[0], parts.shape[0])
    moved = parts[:n_common] != old_parts[:n_common]
    moved_u = int(moved.sum())
    gained = int(np.count_nonzero(packed_delta(masks, old_masks)))
    dropped = int(np.count_nonzero(packed_delta(old_masks, masks)))
    acquired = 4 * gained
    if degrees is not None:
        degrees = np.asarray(degrees)
        acquired += 4 * int(degrees[:n_common][moved].sum())
    retired = 4 * dropped
    return MigrationPlan(
        assign=assign,
        parts_u=parts,
        s_masks=masks,
        moved_u=moved_u,
        kept_overlap=int(M[np.arange(k), assign].sum()),
        traffic=TrafficCounters(tasks=1,
                                migration_bytes=acquired + retired),
        acquired_bytes=acquired,
        retired_bytes=retired,
    )
