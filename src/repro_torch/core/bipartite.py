"""Bipartite graph G(U, V, E) in CSR/CSC form (paper §2.2).

U is the data/example side, V the parameter side; ``u_indices[u_indptr[i]
: u_indptr[i+1]]`` = N(u_i).  The CSC side (``v_indptr``/``v_indices``) is
built lazily, for the cost-update sweep of the host Algorithm 3 (step 13
needs ``N(v) ∩ U``).  Plain numpy: the port packs this structure into
bitmask words on the host and moves only the words to the card.

A copy of ``repro.core.bipartite`` (the port imports nothing of ``repro``).
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
    _v_indptr: np.ndarray | None = None
    _v_indices: np.ndarray | None = None

    @property
    def num_edges(self) -> int:
        return int(self.u_indices.shape[0])

    def neighbors(self, u: int) -> np.ndarray:
        return self.u_indices[self.u_indptr[u] : self.u_indptr[u + 1]]

    def degree_u(self) -> np.ndarray:
        return np.diff(self.u_indptr).astype(np.int64)

    def degree_v(self) -> np.ndarray:
        return np.bincount(self.u_indices, minlength=self.num_v).astype(np.int64)

    # --------------------------------------------------------------- csc
    def _build_csc(self) -> None:
        order = np.argsort(self.u_indices, kind="stable")
        self._v_indices = np.repeat(
            np.arange(self.num_u, dtype=np.int32), np.diff(self.u_indptr)
        )[order]
        counts = np.bincount(self.u_indices, minlength=self.num_v)
        self._v_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    @property
    def v_indptr(self) -> np.ndarray:
        if self._v_indptr is None:
            self._build_csc()
        return self._v_indptr

    @property
    def v_indices(self) -> np.ndarray:
        if self._v_indices is None:
            self._build_csc()
        return self._v_indices

    def v_neighbors(self, v: int) -> np.ndarray:
        """N(v) ⊆ U."""
        return self.v_indices[self.v_indptr[v] : self.v_indptr[v + 1]]

    # --------------------------------------------------------------- slicing
    def subgraph_u(self, u_ids: np.ndarray) -> "BipartiteGraph":
        """Induced subgraph on a subset of U (V ids kept global, §4.2), so
        neighbor sets S_i compose across subgraphs."""
        u_ids = np.asarray(u_ids, dtype=np.int64)
        lens = self.u_indptr[u_ids + 1] - self.u_indptr[u_ids]
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        indices = np.empty(int(indptr[-1]), dtype=np.int32)
        for out_i, u in enumerate(u_ids):
            indices[indptr[out_i] : indptr[out_i + 1]] = self.neighbors(int(u))
        return BipartiteGraph(len(u_ids), self.num_v, indptr, indices)

    def slice_u(self, start: int, stop: int) -> "BipartiteGraph":
        """Contiguous U-row slice ``[start, stop)`` with global V ids."""
        if not 0 <= start <= stop <= self.num_u:
            raise ValueError(
                f"slice [{start}, {stop}) out of range for num_u={self.num_u}")
        lo, hi = self.u_indptr[start], self.u_indptr[stop]
        return BipartiteGraph(
            stop - start, self.num_v,
            (self.u_indptr[start : stop + 1] - lo).astype(np.int64),
            self.u_indices[lo:hi])

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
