"""Data pipeline: deterministic synthetic token streams and Parsa-aware
document sharding.

``SyntheticLMData`` — seeded Zipfian token batches (training and its
tests).  Batch t is a pure function of (seed, t), so a restart from a
checkpoint replays the exact stream.

``ParsaShardedData`` — documents assigned to data shards by a Parsa
U-partition: each shard's batches draw from its own documents, shrinking
the shard's working vocabulary (the footprint objective (6)).  Batch t is
a pure function of (seed, t): the draws are numpy's
``default_rng((seed, t))``, in the order of ``repro.data.pipeline``, so
both packages give the same batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.bipartite import BipartiteGraph
from ..core.placement import Placement

__all__ = ["SyntheticLMData", "ParsaShardedData"]


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    zipf_s: float = 1.1

    def __post_init__(self):
        w = 1.0 / np.arange(1, self.vocab_size + 1) ** self.zipf_s
        self._p = w / w.sum()

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.vocab_size, size=(self.batch, self.seq + 1),
                          p=self._p)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ParsaShardedData:
    """Batches whose rows are grouped by the Parsa document partition."""

    def __init__(self, graph: BipartiteGraph, placement: Placement,
                 batch: int, seq: int, seed: int = 0):
        self.graph, self.pl = graph, placement
        self.batch, self.seq, self.seed = batch, seq, seed
        self.k = placement.k
        self.shard_docs = [np.flatnonzero(placement.doc_to_shard == i)
                           for i in range(self.k)]
        if batch % self.k:
            raise ValueError("batch must split across shards")

    def batch_at(self, step: int, permute_vocab: bool = True) -> dict:
        rng = np.random.default_rng((self.seed, step))
        per = self.batch // self.k
        rows = []
        for i in range(self.k):
            docs = rng.choice(self.shard_docs[i], size=per)
            for d in docs:
                words = self.graph.neighbors(int(d))
                if len(words) == 0:
                    words = np.zeros(1, np.int32)
                seq = rng.choice(words, size=self.seq + 1)
                rows.append(seq)
        toks = np.stack(rows).astype(np.int32)
        if permute_vocab:
            toks = self.pl.vocab_perm[toks].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def working_set_per_shard(self, step: int) -> np.ndarray:
        """Unique vocab rows touched per shard — the paper's objective (6).
        Exact: union of the drawn documents' vocabularies (not subsampled)."""
        rng = np.random.default_rng((self.seed, step))
        per = self.batch // self.k
        out = np.zeros(self.k, np.int64)
        for i in range(self.k):
            docs = rng.choice(self.shard_docs[i], size=per)
            vocab = set()
            for d in docs:
                vocab.update(self.graph.neighbors(int(d)).tolist())
            out[i] = len(vocab)
        return out
