"""Host-side (numpy) bitmask packers: the packed little-endian int32 wire
format, ``(rows, ⌈|V|/32⌉)`` words, bit ``j % 32`` of word ``j // 32``.

Copies of the packers in ``repro.kernels.parsa_cost.ops`` so both packages
put the same bits in the same words.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pack_bitmask", "unpack_bitmask", "coerce_packed_sets",
           "coerce_dense_sets", "packed_union", "packed_delta",
           "packed_intersect_counts", "pack_bitmask_csr",
           "pack_bitmask_csr_sparse", "pack_bitmask_csr_compact",
           "compact_row_words"]


def pack_bitmask(ids_per_row: list[np.ndarray] | np.ndarray, num_v: int) -> np.ndarray:
    """Pack per-row V-id sets (or a (rows, num_v) bool matrix) into
    (rows, ceil(num_v/32)) int32 bitmasks."""
    W = (num_v + 31) // 32
    if isinstance(ids_per_row, np.ndarray) and ids_per_row.ndim == 2:
        rows = ids_per_row.shape[0]
        dense = ids_per_row if ids_per_row.dtype == np.bool_ \
            else ids_per_row.astype(bool)
        packed = np.packbits(dense, axis=-1, bitorder="little")  # (rows, ⌈V/8⌉)
        out = np.zeros((rows, W * 4), dtype=np.uint8)
        out[:, : packed.shape[1]] = packed
        return out.view(np.uint32).reshape(rows, W).view(np.int32)
    out = np.zeros((len(ids_per_row), W), dtype=np.uint32)
    for r, ids in enumerate(ids_per_row):
        ids = np.asarray(ids, dtype=np.int64)
        np.bitwise_or.at(out[r], ids // 32, np.uint32(1) << (ids % 32).astype(np.uint32))
    return out.view(np.int32)


def unpack_bitmask(masks: np.ndarray, num_v: int) -> np.ndarray:
    """Inverse of ``pack_bitmask``: (rows, W) int32 words → (rows, num_v) bool."""
    masks = np.ascontiguousarray(masks).view(np.uint32)
    rows, W = masks.shape
    bits = np.unpackbits(
        masks.view(np.uint8).reshape(rows, W * 4), axis=-1, bitorder="little")
    return bits[:, :num_v].view(np.bool_)


def coerce_packed_sets(sets, num_v: int) -> np.ndarray:
    """Normalize neighbor sets to packed (k, ⌈num_v/32⌉) int32 words.
    Accepts packed int32/uint32 words (returned as-is, no copy) or a dense
    (k, num_v) membership matrix."""
    W = (num_v + 31) // 32
    a = np.asarray(sets)
    if a.ndim != 2:
        raise ValueError(f"neighbor sets must be 2-D, got shape {a.shape}")
    if a.dtype != np.bool_ and np.issubdtype(a.dtype, np.integer) \
            and a.shape[1] == W and a.shape[1] != num_v:
        return a.view(np.int32) if a.dtype == np.uint32 else \
            a.astype(np.int32, copy=False)
    if a.shape[1] != num_v:
        raise ValueError(
            f"neighbor sets width {a.shape[1]} matches neither num_v="
            f"{num_v} (dense) nor {W} packed words")
    return pack_bitmask(a.astype(bool, copy=False), num_v)


def coerce_dense_sets(sets, num_v: int) -> np.ndarray:
    """Inverse normalization: dense (k, num_v) bool view of neighbor sets
    handed in either format (packed input is unpacked into a fresh,
    writable scratch)."""
    W = (num_v + 31) // 32
    a = np.asarray(sets)
    if a.ndim != 2:
        raise ValueError(f"neighbor sets must be 2-D, got shape {a.shape}")
    if a.dtype != np.bool_ and np.issubdtype(a.dtype, np.integer) \
            and a.shape[1] == W and a.shape[1] != num_v:
        return unpack_bitmask(a, num_v)
    if a.shape[1] != num_v:
        raise ValueError(
            f"neighbor sets width {a.shape[1]} matches neither num_v="
            f"{num_v} (dense) nor {W} packed words")
    return a.astype(bool, copy=False)


def packed_union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Word-wise union of packed bitmasks: the Alg 4 server OR-merge
    (line 9) on the wire format — works on any int word dtype."""
    return a | b


def packed_delta(new: np.ndarray, old: np.ndarray) -> np.ndarray:
    """Word-wise set difference ``new \\ old`` on packed bitmasks — the
    delta a worker pushes back to the server (Alg 4 worker line 9).
    ``packed_union(old, packed_delta(new, old)) == packed_union(old, new)``."""
    return new & ~old


# per-byte popcount table: the numpy<2.0 fallback (np.bitwise_count is 2.0+)
_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8).reshape(-1, 1), axis=1).sum(
        axis=1).astype(np.int64)


def packed_intersect_counts(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """All-pairs intersection sizes of two packed bitmask stacks:
    ``out[i, j] = |rows_a[i] ∩ rows_b[j]|`` for (ka, W) × (kb, W) int32
    words → (ka, kb) int64 counts.  The stream's migration planner matches
    old→new parts with it.  The (ka, kb, W) AND transient is materialized
    in one go — fine for partition counts (k ≤ 1024)."""
    a = np.ascontiguousarray(a).view(np.uint32)
    b = np.ascontiguousarray(b).view(np.uint32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(
            f"packed stacks must share the word width, got {a.shape} "
            f"vs {b.shape}")
    inter = a[:, None, :] & b[None, :, :]
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(inter).sum(axis=-1, dtype=np.int64)
    return _POPCOUNT8[inter.view(np.uint8)].sum(axis=-1)


def _gather_row_cols(
    indptr: np.ndarray,
    indices: np.ndarray,
    rows: np.ndarray | None,
) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Gather the CSR edge array in (optionally permuted) row order.
    Returns (n, lens, row_ids, cols)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if rows is None:
        n = indptr.shape[0] - 1
        lens = np.diff(indptr)
        cols = indices
    else:
        rows = np.asarray(rows, dtype=np.int64)
        n = rows.shape[0]
        lens = indptr[rows + 1] - indptr[rows]
        total = int(lens.sum())
        ends = np.cumsum(lens)
        offs = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
        cols = indices[np.repeat(indptr[rows], lens) + offs]
    row_ids = np.repeat(np.arange(n, dtype=np.int64), lens)
    return n, lens, row_ids, cols


def pack_bitmask_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_v: int,
    rows: np.ndarray | None = None,
) -> np.ndarray:
    """Vectorized CSR → (rows, ceil(num_v/32)) int32 bitmask packing:
    ``pack_bitmask([indices[indptr[r]:indptr[r+1]] for r in rows], num_v)``
    with no per-row Python work (one gather over the edge array, one
    ``bitwise_or.at`` scatter).  ``rows`` selects or permutes rows; None
    packs all rows in CSR order."""
    n, _, row_ids, cols = _gather_row_cols(indptr, indices, rows)
    W = (num_v + 31) // 32
    out = np.zeros(n * W, dtype=np.uint32)
    np.bitwise_or.at(
        out,
        row_ids * W + (cols >> 5),
        (np.int64(1) << (cols & 31)).astype(np.uint32),
    )
    return out.reshape(n, W).view(np.int32)


def pack_bitmask_csr_sparse(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_v: int,
    rows: np.ndarray | None = None,
    cap: int = 48,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Sparse packing in one sorted pass: the bitmask as (distinct flat word
    index, word value) pairs plus per-row compact word lists of at most
    ``cap`` words.

    Returns (uniq (nnz,) int64 flat indices into the (n, W) mask,
    wordvals (nnz,) int32, widx (n, cap) int32, vals (n, cap) int32,
    truncated (n,) bool, n, W).  Padding slots point at word 0 with value 0.
    """
    n, _, row_ids, cols = _gather_row_cols(indptr, indices, rows)
    W = (num_v + 31) // 32
    widx = np.zeros((n, cap), dtype=np.int32)
    vals = np.zeros((n, cap), dtype=np.uint32)
    if cols.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32), widx,
                vals.view(np.int32), np.zeros(n, bool), n, W)
    fw = row_ids * W + (cols >> 5)            # flat (row, word) key per edge
    bit = (np.int64(1) << (cols & 31)).astype(np.uint32)
    srt = np.argsort(fw, kind="stable")
    fs, bs = fw[srt], bit[srt]
    boundary = np.empty(fs.size, bool)
    boundary[0] = True
    np.not_equal(fs[1:], fs[:-1], out=boundary[1:])
    first = np.flatnonzero(boundary)
    uniq = fs[first]                          # distinct (row, word), sorted
    acc = np.bitwise_or.reduceat(bs, first)   # the word values
    r = uniq // W
    counts = np.bincount(r, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(uniq.size, dtype=np.int64) - starts[r]
    keep = pos < cap
    flat = r[keep] * cap + pos[keep]
    widx.reshape(-1)[flat] = (uniq[keep] % W).astype(np.int32)
    vals.reshape(-1)[flat] = acc[keep]
    return (uniq, acc.view(np.int32), widx, vals.view(np.int32),
            counts > cap, n, W)


def pack_bitmask_csr_compact(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_v: int,
    rows: np.ndarray | None = None,
    cap: int = 48,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``pack_bitmask_csr`` and ``compact_row_words`` in one sorted pass.
    Returns (masks (n, W) int32, widx (n, cap) int32, vals (n, cap) int32,
    truncated (n,) bool), the two-step result exactly."""
    uniq, wordvals, widx, vals, trunc, n, W = pack_bitmask_csr_sparse(
        indptr, indices, num_v, rows=rows, cap=cap)
    masks = np.zeros(n * W, dtype=np.int32)
    masks[uniq] = wordvals
    return masks.reshape(n, W), widx, vals, trunc


def compact_row_words(
    masks: np.ndarray, cap: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row compact word lists of a packed (N, W) bitmask: (widx (N,
    cap) int32, vals (N, cap) int32, truncated (N,) bool).  A row with at
    most ``cap`` nonzero words is exact: for any mask X, Σ_d
    popcount(vals[r, d] & X[widx[r, d]]) == popcount(masks[r] & X).  A
    longer row keeps its first ``cap`` words and is flagged truncated.
    Padding slots point at word 0 with value 0."""
    n = masks.shape[0]
    r, c = np.nonzero(masks)
    counts = np.bincount(r, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(r.size, dtype=np.int64) - starts[r]
    keep = pos < cap
    widx = np.zeros((n, cap), dtype=np.int32)
    vals = np.zeros((n, cap), dtype=np.int32)
    flat = r[keep] * cap + pos[keep]
    widx.reshape(-1)[flat] = c[keep]
    vals.reshape(-1)[flat] = masks[r[keep], c[keep]]
    return widx, vals, counts > cap
