"""The §4.1 vertex-selection structure: cost array + doubly-linked bucket list.

Per partition i, Algorithm 3 needs, over a universe of |U| vertices whose
integer costs only *decrease*:

  * extract-min            O(1) amortized
  * decrease-key (by d)    O(1) amortized
  * delete (assigned u)    O(1)

The paper stores costs in an array ``A_i`` and imposes a doubly-linked list
in increasing cost order, with "head pointers" into the first node of each
cost bucket 0..θ.  An equivalent-but-simpler formulation of the same idea is
a *bucket queue*: one doubly-linked list per cost value, plus a moving
``min_cost`` cursor.  Since costs only decrease, the cursor only needs to
move down on decrease-key and scan up on extract-min; total scan work is
bounded by (#ops + max_cost), giving the same O(1) amortized bounds the
paper claims.  Costs above ``theta`` share an overflow bucket (the paper's
θ=1000 covers >99% of vertices; overflow extract is rare).

Implemented on flat numpy arrays (prev/next/bucket-head) — no Python objects
per node — so a full Algorithm 3 run is practical from CPython.

A copy of ``repro.core.bucket_queue`` (the port imports nothing of
``repro``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["BucketQueue"]

_NIL = -1


class BucketQueue:
    """Monotone (decrease-only) integer-priority bucket queue over ids [0, n)."""

    def __init__(self, costs: np.ndarray, theta: int = 1000):
        costs = np.asarray(costs)
        n = costs.shape[0]
        self.n = n
        self.theta = int(theta)
        # cost value per id; -1 == deleted
        self.cost = costs.astype(np.int64).copy()
        if n and self.cost.min() < 0:
            raise ValueError("costs must be non-negative")
        self.nbuckets = self.theta + 2  # [0..theta] exact + overflow bucket
        self.head = np.full(self.nbuckets, _NIL, dtype=np.int64)
        self.prev = np.full(n, _NIL, dtype=np.int64)
        self.next = np.full(n, _NIL, dtype=np.int64)
        self.in_queue = np.ones(n, dtype=bool)
        self.size = n
        # bulk build: counting-sort style bucket fill (paper: counting sort O(|U|))
        for i in range(n - 1, -1, -1):  # reverse so lists come out id-ascending
            self._push(i, self._bucket(int(self.cost[i])))
        self.min_bucket = 0

    # ------------------------------------------------------------ internals
    def _bucket(self, c: int) -> int:
        return c if c <= self.theta else self.theta + 1

    def _push(self, i: int, b: int) -> None:
        h = self.head[b]
        self.prev[i] = _NIL
        self.next[i] = h
        if h != _NIL:
            self.prev[h] = i
        self.head[b] = i

    def _unlink(self, i: int) -> None:
        p, nx = self.prev[i], self.next[i]
        if p != _NIL:
            self.next[p] = nx
        else:  # head of its bucket
            self.head[self._bucket(int(self.cost[i]))] = nx
        if nx != _NIL:
            self.prev[nx] = p
        self.prev[i] = _NIL
        self.next[i] = _NIL

    # ------------------------------------------------------------ public api
    def peek_min(self) -> tuple[int, int]:
        """Return (id, cost) of the minimum-cost live entry. O(1) amortized."""
        if self.size == 0:
            raise IndexError("empty bucket queue")
        b = self.min_bucket
        while self.head[b] == _NIL:
            b += 1
        self.min_bucket = b
        i = int(self.head[b])
        if b == self.theta + 1:  # overflow bucket: linear scan (rare)
            j, best, best_c = i, i, int(self.cost[i])
            while j != _NIL:
                if self.cost[j] < best_c:
                    best, best_c = j, int(self.cost[j])
                j = int(self.next[j])
            return best, best_c
        return i, int(self.cost[i])

    def pop_min(self) -> tuple[int, int]:
        i, c = self.peek_min()
        self.delete(i)
        return i, c

    def delete(self, i: int) -> None:
        if not self.in_queue[i]:
            return
        self._unlink(i)
        self.in_queue[i] = False
        self.size -= 1

    def decrease(self, i: int, new_cost: int) -> None:
        """Decrease-key. Costs never increase in Algorithm 3 (§4.1)."""
        if not self.in_queue[i]:
            return
        old = int(self.cost[i])
        if new_cost >= old:
            return
        if new_cost < 0:
            raise ValueError("negative cost")
        ob, nb = self._bucket(old), self._bucket(new_cost)
        if ob != nb:
            self._unlink(i)
            self.cost[i] = new_cost
            self._push(i, nb)
        else:
            self.cost[i] = new_cost
        if nb < self.min_bucket:
            self.min_bucket = nb

    def __len__(self) -> int:
        return self.size
