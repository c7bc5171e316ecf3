"""Synthetic analogues of the paper's datasets (Table 1), seed-deterministic.

  * text_like — documents × vocabulary, Zipfian word frequencies (rcv1 /
    news20 / KDDa analogues); document length ~ lognormal.
  * ctr_like  — impressions × (ads ∪ user features): Zipf features plus a
    dense block of frequent features (CTRa/CTRb analogue).
  * social_like — power-law (Barabási–Albert-ish) natural graph, converted
    to bipartite by the §2.2 construction U' = V (livejournal / orkut
    analogue).
  * ``*_stream`` — the same three structures arriving as U-vertex chunks
    whose distribution drifts over the stream (the stream layer's input).

Copies of ``repro.graphs.synthetic`` that draw the same numpy random stream,
so both packages build identical arrays from the same seed.
"""
from __future__ import annotations

import numpy as np

from ..core.bipartite import BipartiteGraph, from_edges

__all__ = ["text_like", "ctr_like", "social_like", "natural_to_bipartite",
           "text_like_stream", "ctr_like_stream", "social_like_stream"]


def _zipf_choice(rng, n: int, size: int, s: float = 1.1) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    w /= w.sum()
    return rng.choice(n, size=size, p=w)


def text_like(
    num_docs: int = 2000,
    vocab: int = 5000,
    mean_len: int = 60,
    zipf_s: float = 1.1,
    seed: int = 0,
) -> BipartiteGraph:
    rng = np.random.default_rng(seed)
    lens = np.maximum(1, rng.lognormal(np.log(mean_len), 0.6, num_docs).astype(int))
    total = int(lens.sum())
    words = _zipf_choice(rng, vocab, total, zipf_s)
    docs = np.repeat(np.arange(num_docs), lens)
    return from_edges(num_docs, vocab, docs, words)


def ctr_like(
    num_impressions: int = 2000,
    num_features: int = 8000,
    nnz_per_row: int = 40,
    dense_features: int = 30,
    clusters: int = 24,
    locality: float = 0.7,
    seed: int = 0,
) -> BipartiteGraph:
    """CTR analogue: a few dense head features (user-agent/geo style), plus a
    tail split between the impression's *campaign cluster* block and a
    global Zipf tail."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    head = rng.integers(0, dense_features, size=(num_impressions, 4))
    for i in range(4):
        rows.append(np.arange(num_impressions))
        cols.append(head[:, i])
    tail_n = nnz_per_row - 4
    tail_features = num_features - dense_features
    block = max(1, tail_features // clusters)
    row_cluster = rng.integers(0, clusters, size=num_impressions)
    local = rng.random((num_impressions, tail_n)) < locality
    # cluster-local draws (Zipf inside the block), global Zipf otherwise
    local_offsets = _zipf_choice(rng, block, num_impressions * tail_n, 1.1
                                 ).reshape(num_impressions, tail_n)
    local_ids = (row_cluster[:, None] * block + local_offsets) % tail_features
    global_ids = _zipf_choice(rng, tail_features, num_impressions * tail_n, 1.05
                              ).reshape(num_impressions, tail_n)
    tail = dense_features + np.where(local, local_ids, global_ids)
    rows.append(np.repeat(np.arange(num_impressions), tail_n))
    cols.append(tail.reshape(-1))
    return from_edges(
        num_impressions, num_features, np.concatenate(rows), np.concatenate(cols)
    )


def social_like(num_nodes: int = 3000, m: int = 8, seed: int = 0):
    """Preferential-attachment edge list (u < v), power-law degrees."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    repeated: list[int] = list(range(m))
    for v in range(m, num_nodes):
        picks = rng.choice(len(repeated), size=m, replace=False)
        chosen = {repeated[p] for p in picks}
        for u in chosen:
            src.append(u)
            dst.append(v)
            repeated.append(u)
        repeated.extend([v] * len(chosen))
    return np.asarray(src), np.asarray(dst), num_nodes


# --------------------------------------------------------------------------
# Streaming variants: the same three structures, arriving as U-vertex
# chunks whose distribution *drifts* over the stream — the non-stationarity
# that makes online partitioning decay and drift repair worth having.
# --------------------------------------------------------------------------
def text_like_stream(
    num_docs: int = 2000,
    vocab: int = 5000,
    chunks: int = 8,
    mean_len: int = 60,
    zipf_s: float = 1.1,
    drift: float = 0.5,
    seed: int = 0,
) -> list[BipartiteGraph]:
    """Topic drift: each chunk's Zipf head sits at a rotating vocabulary
    offset (the hot topic moves), sweeping ``drift`` of the vocabulary over
    the whole stream.  Early chunks' hot words go cold — exactly the decay
    an online partitioner accumulates."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(chunks):
        n = num_docs // chunks + (1 if c < num_docs % chunks else 0)
        lens = np.maximum(
            1, rng.lognormal(np.log(mean_len), 0.6, n).astype(int))
        words = _zipf_choice(rng, vocab, int(lens.sum()), zipf_s)
        offset = int(drift * vocab * c / max(chunks - 1, 1))
        words = (words + offset) % vocab
        docs = np.repeat(np.arange(n), lens)
        out.append(from_edges(n, vocab, docs, words))
    return out


def ctr_like_stream(
    num_impressions: int = 2000,
    num_features: int = 8000,
    chunks: int = 8,
    nnz_per_row: int = 40,
    dense_features: int = 30,
    clusters: int = 24,
    locality: float = 0.7,
    churn: float = 0.3,
    seed: int = 0,
) -> list[BipartiteGraph]:
    """Campaign churn: impressions keep the head/cluster structure of
    ``ctr_like``, but between chunks a ``churn`` fraction of campaign
    clusters is retired and relaunched over a fresh feature block — the
    ad-serving non-stationarity the paper's CTR workloads live with."""
    rng = np.random.default_rng(seed)
    tail_features = num_features - dense_features
    block = max(1, tail_features // clusters)
    n_blocks = max(1, tail_features // block)
    # live campaign → feature-block mapping, churned between chunks
    campaign_block = rng.integers(0, n_blocks, size=clusters)
    out = []
    tail_n = nnz_per_row - 4
    for c in range(chunks):
        if c > 0:
            relaunch = rng.random(clusters) < churn
            campaign_block[relaunch] = rng.integers(
                0, n_blocks, size=int(relaunch.sum()))
        n = num_impressions // chunks + (1 if c < num_impressions % chunks
                                         else 0)
        rows, cols = [], []
        head = rng.integers(0, dense_features, size=(n, 4))
        for i in range(4):
            rows.append(np.arange(n))
            cols.append(head[:, i])
        row_cluster = rng.integers(0, clusters, size=n)
        local = rng.random((n, tail_n)) < locality
        local_offsets = _zipf_choice(rng, block, n * tail_n, 1.1
                                     ).reshape(n, tail_n)
        local_ids = (campaign_block[row_cluster][:, None] * block
                     + local_offsets) % tail_features
        global_ids = _zipf_choice(rng, tail_features, n * tail_n, 1.05
                                  ).reshape(n, tail_n)
        tail = dense_features + np.where(local, local_ids, global_ids)
        rows.append(np.repeat(np.arange(n), tail_n))
        cols.append(tail.reshape(-1))
        out.append(from_edges(n, num_features,
                              np.concatenate(rows), np.concatenate(cols)))
    return out


def social_like_stream(
    num_nodes: int = 3000,
    chunks: int = 8,
    m: int = 8,
    seed: int = 0,
) -> list[BipartiteGraph]:
    """Preferential-attachment growth: the natural graph grows node by
    node; each chunk carries the newly arrived nodes' rows under the §2.2
    construction (a node's row is its adjacency at arrival — earlier rows
    are not retro-edited, the append-only streaming approximation), with
    ``num_v`` growing chunk over chunk so the arena's capacity-doubling
    path is exercised."""
    src, dst, n = social_like(num_nodes, m=m, seed=seed)
    src, dst = np.asarray(src), np.asarray(dst)
    out = []
    bounds = np.linspace(m, num_nodes, chunks + 1).astype(int)
    for c in range(chunks):
        lo, hi = bounds[c], bounds[c + 1]
        if c == 0:
            lo = 0  # the seed clique rides in the first chunk
        sel = (dst >= max(lo, m)) & (dst < hi)
        eu = dst[sel] - lo        # arriving node's local row id
        ev = src[sel]             # neighbors at arrival (global V ids)
        out.append(from_edges(hi - lo, hi, eu, ev))
    return out


def natural_to_bipartite(src: np.ndarray, dst: np.ndarray, n: int) -> BipartiteGraph:
    """§2.2 construction U' = V: u's row links every neighbor of u (both
    directions), so N(u) is u's adjacency list in the natural graph."""
    eu = np.concatenate([src, dst])
    ev = np.concatenate([dst, src])
    return from_edges(n, n, eu, ev)
