r"""Algorithm 2 and the packed-bitmask metrics, in PyTorch on the card.

The counterpart of ``repro.core.jax_refine``, over the same packed int32
wire format:

  * ``need_masks``      — the u_ij matrix of eq. (8) as packed (k, W) words
    from ``parts_u`` and the CSR edges: sort the (partition, column) keys,
    keep the first of each, scatter-add its bit (distinct bits, so add is
    OR).  No dense (k, |V|) matrix exists.
  * ``refine_v_device`` — Algorithm 2's sweeps over V in chunks of C
    parameters: every sweep of every chunk, in order, in ONE launch of the
    refine-sweep kernel (``refine_scan``), which carries the cost vector
    across chunks and sweeps and writes the parts in place.
  * ``evaluate_device`` — objectives (4)/(6)/(7) as popcount reductions,
    through the (k, k) intersection matrix M[i, j] = |V_i ∩ N(U_j)|.

Cost algebra (Alg 2 line 8): assign j → ξ adds −1 + (n_j − 1) at ξ; a
re-assignment first retracts −1 + (n_j − u_{cur,j}) at the old host.  A
converged sweep is a fixed point, so running every sweep equals the host
oracle's early break.

Divergence from the JAX package, on purpose: ``need_masks`` builds int64
keys ``partition · |V| + column`` (JAX's ``jax_enable_x64`` behaviour), so
the JAX refusal of ``k·|V| > 2³¹`` does not apply here.  As there, costs
are int32 and masked with ``BIG`` = 2³⁰, so every true cost must stay
below 2³⁰.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.parsa_cost import popcount32, refine_scan
from .bipartite import BipartiteGraph
from .costs import PartitionMetrics
from .dispatch import phase

__all__ = ["need_masks", "refine_v_device", "evaluate_device"]

# Largest k²·W word count the metrics intersection matrix may materialize
# in one broadcast; larger problems reduce row-by-row instead.
_M_BCAST_MAX_WORDS = 1 << 26

# the single-bit int32 word of each bit position (bit 31 is negative)
_BIT_WORDS = [1 << b for b in range(31)] + [-(1 << 31)]


def _device_of(device, *arrays) -> torch.device:
    """``device`` if given, else that of the first tensor among ``arrays``,
    else the card."""
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cuda")


def _bit_words(col: torch.Tensor) -> torch.Tensor:
    """(n,) column ids → (n,) int32 words with bit ``col % 32`` set."""
    table = torch.tensor(_BIT_WORDS, dtype=torch.int32, device=col.device)
    return table[col & 31]


# --------------------------------------------------------------------------
# need_matrix as packed words.
# --------------------------------------------------------------------------
def need_masks(
    graph: BipartiteGraph,
    parts_u: np.ndarray | torch.Tensor,
    k: int,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """(k, W) int32 packed need matrix: bit j of row i ⇔ v_j ∈ N(U_i).

    Runs on ``device`` (default: that of ``parts_u`` if it is a tensor,
    else the card)."""
    device = _device_of(device, parts_u)
    W = (graph.num_v + 31) // 32
    if graph.num_edges == 0:
        return torch.zeros((k, W), dtype=torch.int32, device=device)
    with phase("need_pack"):
        parts = torch.as_tensor(parts_u, device=device).long()
        edge_rows = torch.from_numpy(np.repeat(
            np.arange(graph.num_u, dtype=np.int64),
            np.diff(graph.u_indptr))).to(device)
        cols = torch.from_numpy(
            graph.u_indices.astype(np.int64, copy=False)).to(device)
        key = torch.sort(parts[edge_rows] * graph.num_v + cols).values
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        col = key % graph.num_v
        flat = (key // graph.num_v) * W + (col >> 5)
        bit = torch.where(first, _bit_words(col), 0)
        words = torch.zeros(k * W, dtype=torch.int32, device=device)
        words.index_add_(0, flat, bit)
    return words.view(k, W)


# --------------------------------------------------------------------------
# Algorithm 2, chunk by chunk.
# --------------------------------------------------------------------------
def _refine_scan(
    words: torch.Tensor,  # (n_chunks, k, cw) int32 need words per chunk
    cost: torch.Tensor,   # (k,) int32 — |N(U_i)| at entry
    parts: torch.Tensor,  # (n_chunks, C) int32 — -1 at entry, updated in place
    sweeps: int,
) -> torch.Tensor:
    """All sweeps × chunks in order (one launch on the card); returns the
    final cost vector."""
    return refine_scan(words, parts, cost, sweeps, out=parts)[0]


def refine_v_device(
    graph: BipartiteGraph,
    parts_u: np.ndarray | torch.Tensor,
    k: int,
    sweeps: int = 1,
    chunk: int = 1024,
    need_words: torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2 over packed words.  Returns (parts_v (|V|,) int32,
    need_words (k, W) int32), both on the device, so ``evaluate_device``
    can reuse the need matrix.  Bit-identical to
    ``core.partition_v(graph, parts_u, k, sweeps)``, including the −1 of
    isolated parameters."""
    if chunk <= 0 or chunk % 32:
        raise ValueError(f"chunk must be a positive multiple of 32, got {chunk}")
    device = _device_of(device, need_words, parts_u)
    if need_words is None:
        need_words = need_masks(graph, parts_u, k, device=device)
    W = (graph.num_v + 31) // 32
    cw = chunk // 32
    n_chunks = -(-W // cw)
    need_pad = torch.nn.functional.pad(need_words, (0, n_chunks * cw - W))
    words = need_pad.view(k, n_chunks, cw).transpose(0, 1).contiguous()
    cost = popcount32(need_words).sum(dim=1, dtype=torch.int32)
    parts = torch.full((n_chunks, chunk), -1, dtype=torch.int32, device=device)
    with phase("refine_scan"):
        _refine_scan(words, cost, parts, sweeps)
    return parts.view(-1)[: graph.num_v], need_words


# --------------------------------------------------------------------------
# Objectives (4)/(6)/(7) as popcount reductions over packed words.
# --------------------------------------------------------------------------
def _metrics_popcount(
    need_w: torch.Tensor,          # (k, W) int32
    parts_u: torch.Tensor,         # (|U|,) int
    parts_v: torch.Tensor | None,  # (|V|,) int, or None
    k: int,
    num_v: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sizes, footprint, worker, server), each (k,) int64."""
    W = need_w.shape[1]
    sizes = torch.bincount(parts_u.long(), minlength=k)
    footprint = popcount32(need_w).sum(dim=1, dtype=torch.int64)
    if parts_v is None:
        return sizes, footprint, footprint, torch.zeros_like(footprint)
    # pack parts_v → (k, W) server-ownership words (row k catches the -1s)
    iota_v = torch.arange(num_v, device=need_w.device)
    row = torch.where(parts_v >= 0, parts_v.long(), k)
    v_words = torch.zeros((k + 1) * W, dtype=torch.int32, device=need_w.device)
    v_words.index_add_(0, row * W + (iota_v >> 5), _bit_words(iota_v))
    v_words = v_words.view(k + 1, W)[:k]
    # M[i, j] = |V_i ∩ N(U_j)|: one (k, k, W) broadcast while it stays under
    # _M_BCAST_MAX_WORDS, else one (k, W) temp per server
    if k * k * W <= _M_BCAST_MAX_WORDS:
        M = popcount32(v_words[:, None, :] & need_w[None, :, :]).sum(
            dim=-1, dtype=torch.int64)
    else:
        M = torch.stack([popcount32(vw[None, :] & need_w).sum(
            dim=-1, dtype=torch.int64) for vw in v_words])
    local = M.diagonal()                    # |V_i ∩ N(U_i)|
    worker = footprint - local              # |N(U_i) \ V_i|
    server = M.sum(dim=1) - local           # Σ_{j≠i} |V_i ∩ N(U_j)|
    return sizes, footprint, worker, server


def evaluate_device(
    graph: BipartiteGraph,
    parts_u: np.ndarray | torch.Tensor,
    parts_v: np.ndarray | torch.Tensor | None,
    k: int,
    need_words: torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> PartitionMetrics:
    """Objectives (4)/(6)/(7), bit-equal to ``core.costs.evaluate``, from
    packed words.  Pass ``need_words`` (e.g. from ``refine_v_device``) to
    skip the need pack."""
    device = _device_of(device, need_words, parts_u, parts_v)
    if need_words is None:
        need_words = need_masks(graph, parts_u, k, device=device)
    with phase("metrics"):
        pv = None if parts_v is None else torch.as_tensor(parts_v,
                                                          device=device)
        out = _metrics_popcount(need_words, torch.as_tensor(parts_u,
                                                            device=device),
                                pv, k, graph.num_v)
        sizes, footprint, worker, server = (x.cpu().numpy() for x in out)
    return PartitionMetrics(k, sizes, footprint, worker + server, worker,
                            server)

