"""Bipartite graph G(U, V, E) in CSR form (paper §2.2).

U is the data/example side, V the parameter side; ``u_indices[u_indptr[i]
: u_indptr[i+1]]`` = N(u_i).  Plain numpy: the port packs this structure
into bitmask words on the host and moves only the words to the card.

A copy of ``repro.core.bipartite`` (the port imports nothing of ``repro``),
cut to what the port uses: the CSR graph, ``from_edges`` and ``load_npz``.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

__all__ = ["BipartiteGraph", "from_edges", "load_npz"]


@dataclasses.dataclass
class BipartiteGraph:
    """CSR bipartite graph. ``u_indices[u_indptr[i]:u_indptr[i+1]]`` = N(u_i)."""

    num_u: int
    num_v: int
    u_indptr: np.ndarray  # int64 (num_u + 1,)
    u_indices: np.ndarray  # int32 (num_edges,)

    @property
    def num_edges(self) -> int:
        return int(self.u_indices.shape[0])

    def neighbors(self, u: int) -> np.ndarray:
        return self.u_indices[self.u_indptr[u] : self.u_indptr[u + 1]]

    def save_npz(self, path: str | pathlib.Path) -> None:
        np.savez_compressed(
            path,
            num_u=self.num_u,
            num_v=self.num_v,
            u_indptr=self.u_indptr,
            u_indices=self.u_indices,
        )

    def validate(self) -> None:
        """Raise ValueError unless the CSR arrays describe a valid graph."""
        if self.u_indptr.shape != (self.num_u + 1,):
            raise ValueError(f"u_indptr has shape {self.u_indptr.shape}, "
                             f"expected ({self.num_u + 1},)")
        if self.u_indptr[0] != 0 or self.u_indptr[-1] != self.num_edges:
            raise ValueError("u_indptr must start at 0 and end at num_edges")
        if np.any(np.diff(self.u_indptr) < 0):
            raise ValueError("u_indptr must be non-decreasing")
        if self.num_edges and (self.u_indices.min() < 0
                               or self.u_indices.max() >= self.num_v):
            raise ValueError(f"u_indices must lie in [0, {self.num_v})")


def from_edges(num_u: int, num_v: int, edges_u: np.ndarray, edges_v: np.ndarray) -> BipartiteGraph:
    """Build CSR from an edge list (duplicates removed)."""
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    key = edges_u * num_v + edges_v
    key = np.unique(key)
    eu = (key // num_v).astype(np.int64)
    ev = (key % num_v).astype(np.int32)
    counts = np.bincount(eu, minlength=num_u)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return BipartiteGraph(num_u, num_v, indptr, ev)


def load_npz(path: str | pathlib.Path) -> BipartiteGraph:
    z = np.load(path)
    return BipartiteGraph(
        int(z["num_u"]), int(z["num_v"]), z["u_indptr"], z["u_indices"]
    )
