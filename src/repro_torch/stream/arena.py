"""Growable graph/bitmask arena for streaming Parsa, with the live state on
the session's device.

The arena is the mutable state a ``StreamSession`` partitions against as
U-vertex chunks arrive:

  * the live packed ``(k, W_cap)`` int32 server sets ``s_masks`` and the
    ``(k,)`` partition sizes — int32 tensors on the session's device,
    updated in place by every exact feed's ``parsa_scan`` (a parallel feed
    replaces them with its merged outputs), so the hot state never
    round-trips through the host between chunks;
  * the appended CSR edge structure of everything fed so far — host numpy
    arrays with amortized O(1) appends (capacity doubling), used only for
    snapshots, drift-triggered full repartitions, and exact metrics.

The packed word width ``W_cap`` only changes when the parameter side
outgrows the current capacity, and then doubles, so a growing-V stream
changes the scan's width O(log |V|) times in all.  All bits at columns
≥ ``num_v`` (the ragged tail of the last logical word plus every capacity
word beyond it) are zero by construction — edges are validated against
``num_v`` on append, and growth pads with zero words — and every packed
operation downstream (the scan's ORs, the merge, the need paths) keeps
them zero.  A copy of ``repro.stream.arena``; snapshots use its npz keys.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..core.bipartite import BipartiteGraph

__all__ = ["StreamArena"]


class StreamArena:
    """Append-only bipartite graph + live packed partition state.

    ``num_v`` is the *logical* parameter-side extent (it may grow as chunks
    introduce new columns); ``W_cap`` the capacity in packed 32-bit words.
    ``s_masks``/``sizes`` live on ``device`` and are owned by the session's
    feed loop — read them through ``masks_np()`` when a host view is
    needed.
    """

    def __init__(self, k: int, num_v: int, u_capacity: int = 1024,
                 edge_capacity: int = 4096,
                 device: str | torch.device = "cuda"):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        if num_v <= 0:
            raise ValueError(f"num_v must be positive, got {num_v}")
        self.device = torch.device(device)
        self.k = k
        self.num_v = num_v
        self.W_cap = (num_v + 31) // 32
        self.s_masks = torch.zeros((k, self.W_cap), dtype=torch.int32,
                                   device=self.device)
        self.sizes = torch.zeros(k, dtype=torch.int32, device=self.device)
        self.num_u = 0
        self._nnz = 0
        self._indptr = np.zeros(max(2, u_capacity + 1), np.int64)
        self._indices = np.empty(max(1, edge_capacity), np.int32)

    # ------------------------------------------------------------- growth
    @property
    def capacity_v(self) -> int:
        """Column capacity in bits (W_cap * 32) — the packing width."""
        return self.W_cap * 32

    def _grow_v(self, num_v_new: int) -> bool:
        """Raise the logical V extent; double ``W_cap`` (and zero-pad the
        live ``s_masks``) only when the new extent outgrows the capacity.
        Returns True when the packed width changed."""
        self.num_v = max(self.num_v, num_v_new)
        W_need = (self.num_v + 31) // 32
        if W_need <= self.W_cap:
            return False
        W_new = self.W_cap
        while W_new < W_need:
            W_new *= 2
        self.s_masks = torch.nn.functional.pad(self.s_masks,
                                               (0, W_new - self.W_cap))
        self.W_cap = W_new
        return True

    def prepare(self, chunk: BipartiteGraph) -> None:
        """Validate a chunk and grow the V capacity for it WITHOUT
        appending.  The session packs and scans against the prepared
        capacity first and appends only after the scan succeeds, so a
        mid-feed failure leaves the appended graph state untouched
        (capacity growth alone is benign: wider zero words change no
        objective)."""
        if chunk.num_edges and int(chunk.u_indices.max()) >= chunk.num_v:
            raise ValueError("chunk edge column exceeds its declared num_v")
        self._grow_v(chunk.num_v)

    def append(self, chunk: BipartiteGraph) -> tuple[int, int]:
        """Append a chunk's U rows (V ids are global, §4.2).  Returns the
        global U-id range ``(start, stop)`` the chunk now occupies.  Grows
        the V extent when the chunk references new columns."""
        self.prepare(chunk)
        start, n, e = self.num_u, chunk.num_u, chunk.num_edges
        if start + n + 1 > self._indptr.shape[0]:
            cap = max(1, self._indptr.shape[0])  # restored snapshots may
            while cap < start + n + 1:           # carry zero-length buffers
                cap *= 2
            self._indptr = np.concatenate(
                [self._indptr, np.zeros(cap - self._indptr.shape[0], np.int64)])
        if self._nnz + e > self._indices.shape[0]:
            cap = max(1, self._indices.shape[0])
            while cap < self._nnz + e:
                cap *= 2
            self._indices = np.concatenate(
                [self._indices,
                 np.empty(cap - self._indices.shape[0], np.int32)])
        self._indptr[start + 1 : start + n + 1] = \
            self._nnz + np.asarray(chunk.u_indptr[1:], np.int64)
        self._indices[self._nnz : self._nnz + e] = chunk.u_indices
        self.num_u += n
        self._nnz += e
        return start, start + n

    # --------------------------------------------------------- elasticity
    def set_partition_state(self, s_masks: torch.Tensor, sizes: torch.Tensor,
                            k: int) -> None:
        """Swap in new live partition state, possibly at a different
        machine count ``k``; the packed width stays ``W_cap``.  Callers own
        the padding-bit invariant (columns ≥ ``num_v`` zero)."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        if tuple(s_masks.shape) != (k, self.W_cap):
            raise ValueError(
                f"s_masks must be ({k}, {self.W_cap}), got "
                f"{tuple(s_masks.shape)}")
        if tuple(sizes.shape) != (k,):
            raise ValueError(f"sizes must be ({k},), got "
                             f"{tuple(sizes.shape)}")
        self.k = k
        self.s_masks = s_masks
        self.sizes = sizes

    # ------------------------------------------------------------- views
    def graph(self) -> BipartiteGraph:
        """Snapshot of everything fed so far (trimmed copies, logical V)."""
        return BipartiteGraph(
            self.num_u, self.num_v,
            self._indptr[: self.num_u + 1].copy(),
            self._indices[: self._nnz].copy())

    def capacity_graph(self, chunk: BipartiteGraph) -> BipartiteGraph:
        """The chunk re-declared at the arena's packing width: ``num_v`` is
        ``capacity_v`` so ``pack_graph_blocks`` emits (…, W_cap) word lists
        matching the live ``s_masks``.  Columns stay < logical ``num_v``,
        so every capacity-padding bit is zero."""
        return BipartiteGraph(chunk.num_u, self.capacity_v,
                              chunk.u_indptr, chunk.u_indices)

    def masks_np(self, logical: bool = True) -> np.ndarray:
        """Host copy of the live server sets; ``logical=True`` trims the
        capacity padding to the (k, ceil(num_v/32)) wire shape."""
        m = self.s_masks.cpu().numpy()
        if logical:
            m = m[:, : (self.num_v + 31) // 32]
        return m.copy()   # on the CPU the tensor's own memory: never alias

    # ---------------------------------------------------------- snapshot
    def state_arrays(self) -> dict[str, np.ndarray | int]:
        """The arena's persistent fields as plain arrays (the npz payload
        shared by ``save`` and ``StreamSession.save``)."""
        return dict(
            k=self.k, num_u=self.num_u, num_v=self.num_v,
            u_indptr=self._indptr[: self.num_u + 1],
            u_indices=self._indices[: self._nnz],
            s_masks=self.masks_np(logical=False),
            sizes=self.sizes.cpu().numpy())

    def save(self, path: str | pathlib.Path) -> None:
        """Snapshot the graph + live server sets/sizes.  The per-vertex
        ``parts`` assignment is *session* state — use
        ``StreamSession.save`` to snapshot a restorable stream."""
        np.savez_compressed(path, **self.state_arrays())

    @classmethod
    def from_state(cls, z, device: str | torch.device = "cuda"
                   ) -> "StreamArena":
        """Rebuild an arena from a ``state_arrays()``-shaped mapping (a
        snapshot of either package), its live state on ``device``."""
        arena = cls(int(z["k"]), int(z["num_v"]), device=device)
        arena.num_u = int(z["num_u"])
        arena._indptr = np.asarray(z["u_indptr"], np.int64)
        arena._indices = np.asarray(z["u_indices"], np.int32)
        arena._nnz = int(arena._indptr[-1])
        arena.W_cap = int(z["s_masks"].shape[1])
        arena.s_masks = torch.tensor(np.asarray(z["s_masks"], np.int32),
                                     device=arena.device)
        arena.sizes = torch.tensor(np.asarray(z["sizes"], np.int32),
                                   device=arena.device)
        return arena

    @classmethod
    def load(cls, path: str | pathlib.Path,
             device: str | torch.device = "cuda") -> "StreamArena":
        return cls.from_state(np.load(path), device=device)
