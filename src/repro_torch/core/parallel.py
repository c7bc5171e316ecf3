r"""Algorithm 4: parallel Parsa on a (simulated) parameter server (§4.3–4.5).

Roles:
  * scheduler — divides G into b subgraphs, issues (a, τ, init) then
    (b, τ, ¬init) rounds;
  * servers   — hold the shared neighbor sets S_i; pushes *replace* S during
    initialization and *union* afterwards (Alg 4 server lines 6–10);
  * workers   — pull S, partition their subgraph with Algorithm 3, push back
    only the delta S_i^new \ S_i (Alg 4 worker line 9, traffic saving).

Consistency: pushes are asynchronous with maximal delay τ (measured in
tasks).  We simulate W concurrent workers deterministically: the pull for
global task t observes every push from tasks finished before
``t - staleness(t)``, where staleness models the W−1 in-flight peers plus an
extra bounded delay drawn from [0, τ] (τ=None ⇒ eventual consistency: a
worker never waits, it sees whatever has landed — modeled as the in-flight
window only, pushes land immediately after their task).

Wire format: the server state, every pending push, and the delta extraction
all live on *packed* uint32 bitmask words — the same (k, ceil(|V|/32))
layout the device pipelines carry.  A worker pull unpacks the packed view
into a dense bool scratch (the worker's private working set, handed to
Algorithm 3 without another copy via ``copy_init=False``).

This is the host-side runtime, in numpy: a copy of ``repro.core.parallel``
without its deprecated ``ParallelParsa`` shim.  The bulk-synchronous
mapping of the same protocol onto one card (bitmask OR == server union) is
the ``parallel_device`` backend
(``core.partition.parallel_blocked_partition_u_impl``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..kernels.parsa_cost.pack import (
    coerce_packed_sets,
    pack_bitmask,
    packed_delta,
    packed_union,
)
from .bipartite import BipartiteGraph
from .costs import need_matrix
from .partition_u import partition_u_impl
from .subgraphs import divide

__all__ = ["ParsaReport", "global_initialization", "parallel_parsa_impl"]


@dataclasses.dataclass
class ParsaReport:
    """Traffic of the partitioning run itself, in *bitmask-word bytes*.

    Both directions use the packed wire format (4 bytes per 32 parameters):
    ``pulled_bytes`` counts the words covering each task's V support
    (server→worker), ``pushed_bytes`` the delta-encoded changed words
    (worker→server, Alg 4 worker line 9) — consistent units, directly
    comparable to each other and to the ``parallel_device`` counters.
    """

    parts_u: np.ndarray
    pushed_bytes: int          # worker→server traffic (delta-encoded words)
    pulled_bytes: int          # server→worker traffic (support words)
    tasks: int
    stale_pushes_missed: int   # how many pushes were invisible due to delay


def global_initialization(
    graph: BipartiteGraph,
    k: int,
    sample_frac: float = 0.01,
    theta: int = 1000,
    select: str = "size",
    seed: int = 0,
) -> np.ndarray:
    """§4.4 global initialization: one worker partitions a small sample and
    the resulting neighbor sets seed all workers."""
    rng = np.random.default_rng(seed)
    m = max(1, int(graph.num_u * sample_frac))
    sample = np.sort(rng.choice(graph.num_u, size=m, replace=False))
    sg = graph.subgraph_u(sample)
    res = partition_u_impl(sg, k, theta=theta, select=select, seed=seed)
    return need_matrix(sg, res.parts_u, k)


def parallel_parsa_impl(
    graph: BipartiteGraph,
    k: int,
    b: int,
    a: int = 0,
    workers: int = 4,
    tau: int | None = 0,
    theta: int = 1000,
    select: str = "size",
    seed: int = 0,
    init_sets: np.ndarray | None = None,
) -> tuple[ParsaReport, np.ndarray]:
    """Deterministic simulation of Alg 4 with W workers and max delay τ.

    Returns (report, final *packed* server neighbor sets (k, ceil(|V|/32))
    int32) — the same wire format the device backends produce, so sets warm-
    start either path through the facade.
    """
    W = workers
    num_v = graph.num_v
    W_words = (num_v + 31) // 32
    plan = divide(graph, b, seed=seed)
    rng = np.random.default_rng(seed + 1)

    # server state is packed words, end to end; .copy(): the server merges
    # pushes into S_server in place, never through the caller's buffer
    S_server = (
        np.zeros((k, W_words), dtype=np.int32)
        if init_sets is None
        else coerce_packed_sets(init_sets, num_v).copy()
    )
    parts_u = np.full(graph.num_u, -1, dtype=np.int32)
    pushed_words = pulled_words = missed = 0

    # the worker's dense working set: ONE reusable (k, |V|) scratch for the
    # whole run.  A pull expands the packed words into it in place.
    unpack_buf = np.empty((k, W_words * 4, 8), dtype=np.uint8)
    scratch = unpack_buf.reshape(k, W_words * 32)[:, :num_v].view(np.bool_)
    bit_idx = np.arange(8, dtype=np.uint8)

    def pull() -> np.ndarray:
        """Expand the packed server words into the dense scratch, in place
        (little-endian bit/byte order — the exact inverse of
        ``pack_bitmask``)."""
        bytes_ = S_server.view(np.uint8).reshape(k, W_words * 4)
        np.right_shift(bytes_[:, :, None], bit_idx, out=unpack_buf)
        np.bitwise_and(unpack_buf, 1, out=unpack_buf)
        return scratch

    # pending pushes: list of (apply_at_task, replace?, packed_sets)
    pending: list[tuple[int, bool, np.ndarray]] = []

    def flush(now: int):
        still = []
        for at, replace, sets in pending:
            if at <= now:
                if replace:
                    S_server[:] = sets
                else:
                    S_server[:] = packed_union(S_server, sets)
            else:
                still.append((at, replace, sets))
        pending[:] = still

    schedule = [("init", t % b) for t in range(a)] + [("real", j) for j in range(b)]
    for t, (mode, j) in enumerate(schedule):
        flush(t)
        missed += len(pending)  # pushes in flight ⇒ invisible to this pull
        sg = plan.subgraphs[j]
        # pull: only the packed words covering this subgraph's V support
        pulled_words += k * np.unique(sg.u_indices >> 5).size
        res = partition_u_impl(
            sg, k, init_sets=pull(), theta=theta, select=select,
            seed=seed + t, copy_init=False,
        )
        delay = 1 if tau is None else 1 + int(rng.integers(0, tau + 1))
        if mode == "init":
            new_packed = pack_bitmask(need_matrix(sg, res.parts_u, k), num_v)
            pending.append((t + delay, True, new_packed))
        else:
            parts_u[plan.blocks[j]] = res.parts_u
            new_packed = pack_bitmask(res.neighbor_sets, num_v)
            # push only the change — S_server is untouched since the pull,
            # so the word delta vs the server equals the delta vs the pull
            pushed_words += int(np.count_nonzero(
                packed_delta(new_packed, S_server)))
            # model W concurrent workers: a push lands after the in-flight
            # window of W−1 peer tasks plus the bounded delay
            pending.append((t + (W - 1) + delay, False, new_packed))
    flush(len(schedule) + max(1, W) + (tau or 0) + 2)
    report = ParsaReport(parts_u, pushed_words * 4, pulled_words * 4,
                         len(schedule), missed)
    return report, S_server
