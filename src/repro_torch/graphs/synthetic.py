"""Synthetic analogues of the paper's datasets (Table 1), seed-deterministic.

  * text_like — documents × vocabulary, Zipfian word frequencies (rcv1 /
    news20 / KDDa analogues); document length ~ lognormal.
  * ctr_like  — impressions × (ads ∪ user features): Zipf features plus a
    dense block of frequent features (CTRa/CTRb analogue).

Copies of ``repro.graphs.synthetic`` that draw the same numpy random stream,
so both packages build identical arrays from the same seed.
"""
from __future__ import annotations

import numpy as np

from ..core.bipartite import BipartiteGraph, from_edges

__all__ = ["text_like", "ctr_like"]


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
