r"""Sketched server sets: break the O(k·|V|/32) bitmask width ceiling.

Every set structure in the pipeline — server-set masks, need words, the
parallel backend's per-worker stale copies, the stream arena — is a packed
(k, ⌈|V|/32⌉) uint32 bitmask.  At the paper's CTR scale (|V| ≈ 10^8,
k = 64) that is hundreds of gigabytes of replicated masks; the greedy
select's working set can never be VMEM-resident.  The submodular theory
already tolerates approximate marginal gains (GreeDi's two-round partition,
arXiv:1411.0541; the randomized-rounds block assignment of
arXiv:1502.02606), so a bounded-error estimate of |N(u) \ S_i| preserves
the approximation story while shrinking every structure by the compression
ratio.

The sketch is a *column compression*, not a new wire format: a static map

    m(c) = rank of c in the hot set            if c is hot (exact prefix)
         = hot_bits + h(c) mod bucket_bits     otherwise (hashed buckets)

sends every parameter column into a ``width_bits = hot_bits + bucket_bits``
domain, and all sets are kept as ordinary packed uint32 bitmasks over that
domain.  Consequences, each load-bearing:

  * Same wire format — union / delta / popcount / OR-merge / the arena /
    the Alg 4 all_gather run UNCHANGED on the sketched words; only the
    width shrinks.  ``sketch(a | b) == sketch(a) | sketch(b)`` exactly
    (a hash of a union is the union of the hashes), so the lattice algebra
    the parallel merge relies on is preserved, not approximated.
  * Bounded error, one-sided — a sketched popcount never exceeds the true
    cardinality (hashing only merges bits), is exact on the hot prefix,
    and the bucket region is a classic linear-counting sketch whose
    cardinality estimate −m·ln(z/m) carries the standard error band
    (``linear_counting_error``).
  * Exact-parity mode for free — ``hot_bits ≥ |V|`` makes the map the
    identity: the sketched pipeline is bit-identical to the exact one
    (regression-tested), so the sketch path cannot silently drift when it
    is not compressing.
  * The hot set is either the identity prefix ``[0, hot_bits)`` (streams,
    where future footprints are unknown) or the top-``hot_bits`` columns by
    popcount footprint (``rank_hot_columns``; membership kept as a sorted
    array + searchsorted, so the map stays O(hot_bits) memory — no
    (|V|,)-sized table exists even at |V| = 10^8).

V-side assignments in sketch space map back to real columns through the
same m: ``expand_parts_v`` gives every true column the machine of its
sketch slot — hot columns get their exact Alg 2 assignment, bucketed tail
columns are co-located by hash, i.e. the random placement of the cold tail
the randomized-rounds guarantee covers.

A copy of ``repro.sketch.spec`` (the port imports nothing of ``repro``):
the same splitmix64 constants and chunking, so both packages give the same
arrays for the same inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.bipartite import BipartiteGraph
from ..kernels.parsa_cost.pack import coerce_packed_sets, pack_bitmask

__all__ = [
    "SketchSpec",
    "rank_hot_columns",
    "set_structure_bytes",
    "packed_popcount_rows",
    "linear_counting_estimate",
]

# splitmix64 finalizer constants — the column hash must be arithmetic (no
# lookup table) so the map costs O(1) memory at |V| = 10^8
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)

# per-byte popcount (numpy < 2.0 has no np.bitwise_count)
_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8).reshape(-1, 1), axis=1).sum(
        axis=1).astype(np.int64)

_MAP_CHUNK = 1 << 24  # columns mapped per host pass (bounds transients)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer on uint64 (wrapping arithmetic)."""
    x = x * _GOLDEN + np.uint64(1)
    x ^= x >> np.uint64(30)
    x *= _MIX1
    x ^= x >> np.uint64(27)
    x *= _MIX2
    x ^= x >> np.uint64(31)
    return x


def packed_popcount_rows(masks: np.ndarray) -> np.ndarray:
    """Per-row popcount of a packed (rows, W) bitmask stack → (rows,) int64."""
    m = np.ascontiguousarray(masks).view(np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(m).sum(axis=-1, dtype=np.int64)
    return _POPCOUNT8[m.view(np.uint8).reshape(m.shape[0], -1)].sum(axis=-1)


def linear_counting_estimate(occupied: int, m: int) -> float:
    """Linear-counting cardinality estimate n̂ = −m·ln(z/m) from ``occupied``
    set buckets out of ``m``.  A saturated sketch (z = 0) is clamped to the
    z = 1/2 estimate — the caller's error band will not cover saturation,
    by design (it means the sketch is underprovisioned)."""
    z = max(m - occupied, 0)
    return float(m * math.log(m / max(z, 0.5)))


def linear_counting_error(n: int, m: int) -> float:
    """Standard deviation of the linear-counting estimate of an n-element
    set in m buckets: √m·(e^t − t − 1)^½ with load t = n/m (Whang et al.).
    Used by the property tests to set the tolerated error band."""
    t = n / m
    return math.sqrt(m * max(math.expm1(t) - t, 1e-12))


def rank_hot_columns(graph: BipartiteGraph, hot_bits: int) -> np.ndarray:
    """The ``hot_bits`` columns with the largest popcount footprint (column
    degree — the number of U rows whose mask sets the bit), as a SORTED id
    array ready for ``SketchSpec(hot_ids=...)``.  O(E) bincount + one
    argpartition; ties resolve to lower column ids."""
    deg = np.bincount(graph.u_indices, minlength=graph.num_v)
    if hot_bits >= graph.num_v:
        return np.arange(graph.num_v, dtype=np.int64)
    top = np.argpartition(-deg, hot_bits - 1)[:hot_bits]
    return np.sort(top).astype(np.int64)


def set_structure_bytes(width_bits: int, k: int, block: int,
                        workers: int = 1) -> int:
    """Peak bytes of the width-dependent set structures ONE partition scan
    holds live per its (k, W) masks: the per-worker stale server-set copy,
    the all_gather merge buffer, and each worker's rebuilt (B, W) block
    tile (plus its transposed twin on the jnp down-date path).  Everything
    here scales linearly in the packed width — the quantity the sketch
    compresses — and is what ``bench_sketch`` meters as ``mem_bytes``.
    Per-vertex compact word lists (O(cap), width-independent) are excluded
    on purpose."""
    W = (width_bits + 31) // 32
    stale = workers * k * W * 4          # per-worker stale S copies
    gather = workers * k * W * 4         # OR-merge all_gather buffer
    tiles = workers * 2 * block * W * 4  # rebuilt (B, W) nbr + transpose
    return stale + gather + tiles


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static column-compression map behind ``ParsaConfig.set_repr="sketch"``.

    ``num_v`` is the true parameter extent; columns below ``hot_bits`` (or
    in ``hot_ids``, when given) keep exact identity slots, every other
    column hashes into one of ``bucket_bits`` shared slots.  The sketched
    domain has ``width_bits`` columns and everything packed-bitmask shaped
    downstream simply runs at that width.
    """

    num_v: int
    hot_bits: int
    bucket_bits: int
    seed: int = 0
    # sorted ids of the columns granted exact slots (len == hot_bits);
    # None = the identity prefix [0, hot_bits)
    hot_ids: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.num_v <= 0:
            raise ValueError(f"num_v must be positive, got {self.num_v}")
        if self.hot_bits < 0:
            raise ValueError(
                f"hot_bits must be >= 0, got {self.hot_bits}")
        if self.bucket_bits < 0:
            raise ValueError(
                f"bucket_bits must be >= 0, got {self.bucket_bits}")
        if not self.is_exact and self.bucket_bits == 0:
            raise ValueError(
                "a compressing sketch (hot_bits < num_v) needs "
                "bucket_bits > 0")
        if self.hot_ids is not None:
            ids = np.asarray(self.hot_ids)
            if ids.shape != (self.hot_bits,):
                raise ValueError(
                    f"hot_ids must have shape ({self.hot_bits},), got "
                    f"{ids.shape}")

    # ------------------------------------------------------------ geometry
    @classmethod
    def for_graph(cls, num_v: int, hot_bits: int, bucket_bits: int,
                  seed: int = 0,
                  hot_ids: np.ndarray | None = None) -> "SketchSpec":
        """Clip the configured geometry to the graph: ``hot_bits ≥ num_v``
        collapses to the exact identity map (bucket region dropped), which
        is what makes ``set_repr="sketch"`` safe at any scale — small
        graphs run bit-identical to the exact pipeline."""
        if hot_bits >= num_v:
            return cls(num_v=num_v, hot_bits=num_v, bucket_bits=0,
                       seed=seed)
        return cls(num_v=num_v, hot_bits=hot_bits, bucket_bits=bucket_bits,
                   seed=seed, hot_ids=hot_ids)

    @property
    def is_exact(self) -> bool:
        """True when the map is the identity (no compression)."""
        return self.hot_bits >= self.num_v

    @property
    def width_bits(self) -> int:
        """Column extent of the sketched domain."""
        return self.num_v if self.is_exact else \
            self.hot_bits + self.bucket_bits

    @property
    def width_words(self) -> int:
        return (self.width_bits + 31) // 32

    @property
    def compression(self) -> float:
        """Exact-width : sketch-width ratio of every packed structure."""
        return ((self.num_v + 31) // 32) / self.width_words

    # ------------------------------------------------------------- the map
    def map_columns(self, cols: np.ndarray) -> np.ndarray:
        """m(c) for an arbitrary int column array — identity (or hot rank)
        on the hot set, splitmix64 bucket otherwise.  Columns ≥ ``num_v``
        are legal (growing streams): the hash covers any id, so the
        sketched width never grows."""
        cols = np.asarray(cols, dtype=np.int64)
        if self.is_exact:
            return cols.copy()
        with np.errstate(over="ignore"):  # uint64 wrap is the hash
            h = _splitmix64(cols.astype(np.uint64) +
                            np.uint64(self.seed) * _GOLDEN)
        bucket = (self.hot_bits +
                  (h % np.uint64(self.bucket_bits)).astype(np.int64))
        if self.hot_ids is None:
            return np.where(cols < self.hot_bits, cols, bucket)
        ids = np.asarray(self.hot_ids)
        pos = np.searchsorted(ids, cols)
        pos_c = np.minimum(pos, self.hot_bits - 1)
        is_hot = ids[pos_c] == cols
        return np.where(is_hot, pos_c, bucket)

    def sketch_graph(self, graph: BipartiteGraph) -> BipartiteGraph:
        """The graph with every edge column pushed through the map: same U
        rows and CSR structure, ``num_v = width_bits``.  Duplicate columns
        a row gains from bucket collisions are harmless — every consumer
        ORs bits.  Chunked so no second edge-sized int64 transient exists
        at the 10^8-edge scale."""
        if self.is_exact:
            return graph
        src = np.asarray(graph.u_indices)
        out = np.empty(src.shape[0], np.int32)
        for lo in range(0, src.shape[0], _MAP_CHUNK):
            hi = min(lo + _MAP_CHUNK, src.shape[0])
            out[lo:hi] = self.map_columns(src[lo:hi]).astype(np.int32)
        return BipartiteGraph(graph.num_u, self.width_bits,
                              np.asarray(graph.u_indptr), out)

    def sketch_masks(self, masks: np.ndarray, num_v: int | None = None
                     ) -> np.ndarray:
        """Packed (k, ⌈num_v/32⌉) masks over the TRUE domain → packed
        (k, width_words) masks over the sketched domain (bit b set iff
        some set column maps to b).  Warm-start / test helper — walks the
        set bits row by row, so meant for moderate |V|, not the
        unallocatable-exact regime (where no true-domain mask exists to
        convert in the first place)."""
        num_v = self.num_v if num_v is None else num_v
        packed = coerce_packed_sets(masks, num_v)
        if self.is_exact:
            return packed
        rows = []
        for r in range(packed.shape[0]):
            bits = np.unpackbits(
                np.ascontiguousarray(packed[r : r + 1]).view(np.uint8),
                bitorder="little")[:num_v]
            rows.append(self.map_columns(np.flatnonzero(bits)))
        return np.asarray(pack_bitmask(rows, self.width_bits))

    def expand_parts_v(self, parts_v_sketch: np.ndarray,
                       num_v: int | None = None) -> np.ndarray:
        """Sketch-space V assignment → true-space: column c is served by
        the machine of its sketch slot m(c).  Chunked gather, O(num_v)
        output only."""
        num_v = self.num_v if num_v is None else num_v
        parts_v_sketch = np.asarray(parts_v_sketch, np.int32)
        if self.is_exact:
            return parts_v_sketch[:num_v].copy()
        out = np.empty(num_v, np.int32)
        for lo in range(0, num_v, _MAP_CHUNK):
            hi = min(lo + _MAP_CHUNK, num_v)
            out[lo:hi] = parts_v_sketch[
                self.map_columns(np.arange(lo, hi, dtype=np.int64))]
        return out

    # ------------------------------------------------------------ estimates
    def estimate_cardinality(self, mask_row: np.ndarray) -> float:
        """Bounded-error cardinality estimate of the TRUE set behind one
        sketched packed row: exact popcount on the hot prefix + linear
        counting over the bucket region."""
        row = np.ascontiguousarray(mask_row).reshape(1, -1)
        if self.is_exact:
            return float(packed_popcount_rows(row)[0])
        bits = np.unpackbits(row.view(np.uint32).view(np.uint8),
                             bitorder="little")[: self.width_bits]
        hot = int(bits[: self.hot_bits].sum())
        occ = int(bits[self.hot_bits :].sum())
        return hot + linear_counting_estimate(occ, self.bucket_bits)

    def error_band(self, tail_n: int, sigmas: float = 4.0) -> float:
        """Tolerated |estimate − truth| for a set with ``tail_n`` elements
        outside the hot prefix: ``sigmas`` linear-counting standard
        deviations (the hot part contributes zero error)."""
        if self.is_exact:
            return 0.0
        return sigmas * linear_counting_error(tail_n, self.bucket_bits)

    # ------------------------------------------------------------- memory
    def mem_bytes(self, k: int, block: int, workers: int = 1) -> int:
        """``set_structure_bytes`` at this spec's sketched width."""
        return set_structure_bytes(self.width_bits, k, block, workers)

    def exact_mem_bytes(self, k: int, block: int, workers: int = 1) -> int:
        """``set_structure_bytes`` the exact pipeline would need at the
        true width — the denominator of the measured compression ratio."""
        return set_structure_bytes(self.num_v, k, block, workers)
