r"""ℓ1-regularized logistic regression on sparse data (paper §5.5), on a
device.

minimize  Σ_i log(1 + exp(-y_i x_i·w)) + λ‖w‖₁

Data rows are CSR, row-sorted.  The two sparse reductions are ordered
segment sums, never atomics, so a run gives the same bits every time:

  * the margins ``x_i·w`` reduce each row's nonzeros in CSR order over the
    row lengths;
  * the gradient's scatter over ``col_ids`` reduces each column's
    contributions over a stable column permutation built once in
    ``from_graph``, so a column sums its nonzeros in their CSR order.

On the CPU each segment sums one term after another from 0, as the JAX
package's ``segment_sum`` does there, so the bits agree with it; on the
card each segment is reduced in one fixed order of its own
(``torch.segment_reduce``), the same on every run.  A port of
``repro.ml.lr``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.bipartite import BipartiteGraph

__all__ = ["SparseBatch", "batch_columns", "lr_objective", "lr_grad",
           "make_problem"]


@dataclasses.dataclass
class SparseBatch:
    """Padded CSR batch on a device: ``row_ids`` aligns each nonzero with
    its row; entries past ``nnz`` are padding (value 0).  ``row_lengths``,
    ``col_perm`` and ``col_lengths`` drive the ordered reductions."""

    num_rows: int
    num_features: int
    row_ids: torch.Tensor      # (nnz_pad,) int32
    col_ids: torch.Tensor      # (nnz_pad,) int32
    values: torch.Tensor       # (nnz_pad,) f32  (0 on padding)
    labels: torch.Tensor       # (num_rows,) f32 ∈ {-1, +1}
    nnz: int = 0
    row_lengths: torch.Tensor | None = None  # (num_rows,) int64
    col_perm: torch.Tensor | None = None     # (nnz,) int64, stable by column
    col_lengths: torch.Tensor | None = None  # (num_features,) int64

    @staticmethod
    def from_graph(
        graph: BipartiteGraph, rows: np.ndarray, labels: np.ndarray,
        pad_to: int | None = None, device: str | torch.device = "cuda",
    ) -> "SparseBatch":
        rows = np.asarray(rows, np.int64)
        lens, cols = batch_columns(graph, rows)
        nnz = cols.shape[0]
        pad = pad_to if pad_to is not None else nnz
        row_ids = np.zeros(pad, np.int32)
        col_ids = np.zeros(pad, np.int32)
        vals = np.zeros(pad, np.float32)
        row_ids[:nnz] = np.repeat(np.arange(rows.size, dtype=np.int32), lens)
        col_ids[:nnz] = cols
        vals[:nnz] = 1.0
        col_perm = np.argsort(col_ids[:nnz], kind="stable")
        col_lengths = np.bincount(col_ids[:nnz], minlength=graph.num_v)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return SparseBatch(
            rows.size, graph.num_v, dev(row_ids), dev(col_ids), dev(vals),
            dev(np.asarray(labels)[rows].astype(np.float32)), nnz=nnz,
            row_lengths=dev(lens), col_perm=dev(col_perm),
            col_lengths=dev(col_lengths.astype(np.int64)))


def batch_columns(graph: BipartiteGraph,
                  rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host CSR gather of ``rows``: their lengths and their column ids, row
    after row in CSR order (a batch's ``col_ids[:nnz]``)."""
    rows = np.asarray(rows, np.int64)
    indptr = np.asarray(graph.u_indptr, np.int64)
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    nnz = int(lens.sum())
    starts = np.repeat(indptr[rows], lens)
    within = np.arange(nnz, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
    return lens, np.asarray(graph.u_indices)[starts + within]


def _segment_sum(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of consecutive runs of ``data`` (one per entry of
    ``lengths``; an empty run sums to 0), each in one fixed order."""
    if data.numel() == 0:
        return torch.zeros(lengths.shape[0], dtype=data.dtype,
                           device=data.device)
    return torch.segment_reduce(data, "sum", lengths=lengths, unsafe=True)


def _margins(batch: SparseBatch, w: torch.Tensor) -> torch.Tensor:
    n = batch.nnz
    xw = _segment_sum(batch.values[:n] * w[batch.col_ids[:n].long()],
                      batch.row_lengths)
    return batch.labels * xw


def lr_objective(batch: SparseBatch, w: torch.Tensor,
                 lam: float) -> torch.Tensor:
    m = _margins(batch, w)
    # log(1 + e^{-m}) computed stably
    loss = torch.sum(torch.logaddexp(torch.zeros_like(m), -m))
    return loss + lam * torch.sum(torch.abs(w))


def lr_grad(batch: SparseBatch, w: torch.Tensor) -> torch.Tensor:
    """∇ of the smooth part: Σ -y_i σ(-y_i x_i·w) x_i, as an ordered
    segment sum over the column permutation."""
    return _grad_from_margins(batch, _margins(batch, w))


def _grad_from_margins(batch: SparseBatch, m: torch.Tensor) -> torch.Tensor:
    """``lr_grad`` from margins already computed."""
    n = batch.nnz
    coef = -batch.labels * torch.sigmoid(-m)  # (rows,)
    contrib = batch.values[:n] * coef[batch.row_ids[:n].long()]
    return _segment_sum(contrib[batch.col_perm], batch.col_lengths)


def make_problem(graph: BipartiteGraph, seed: int = 0, noise: float = 0.1):
    """Plant a sparse ground-truth w* and emit consistent ±1 labels."""
    rng = np.random.default_rng(seed)
    w_star = np.zeros(graph.num_v, np.float32)
    support = rng.choice(graph.num_v, size=max(1, graph.num_v // 20), replace=False)
    w_star[support] = rng.normal(0, 1, size=support.size).astype(np.float32)
    margins = np.zeros(graph.num_u, np.float32)
    for u in range(graph.num_u):
        margins[u] = w_star[graph.neighbors(u)].sum()
    flip = rng.random(graph.num_u) < noise
    labels = np.where(np.sign(margins + 1e-6) * (1 - 2 * flip) >= 0, 1.0, -1.0)
    return w_star, labels.astype(np.float32)
