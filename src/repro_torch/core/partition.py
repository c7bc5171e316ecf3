r"""Blocked greedy Parsa over packed bitmasks, in PyTorch on the card.

The counterpart of ``repro.core.jax_partition`` (its kernel path):

1. *Packing* (host, numpy) — ``pack_graph_blocks`` packs the permuted U in
   one sorted pass into per-row compact word lists of at most ``cap``
   words, plus a dense side channel for the rare rows with more.  No dense
   ``(n_blocks, B, W)`` stack exists.
2. *The scan* — ``_partition_scan`` hands the whole block stack to ONE
   ``parsa_scan`` launch, which carries ``(s_masks, sizes)`` on the card,
   updated in place, and returns only when every block is assigned.
3. *Greedy rounds* — with sizes within one of each other, the next k picks
   visit each partition once: first the catch-up set (partitions at the
   minimum size, in stable-argsort order), then full rounds in index order,
   1 + ⌈(B−1)/k⌉ rounds a block.  Inside ``parsa_scan`` a cluster of 8
   CTAs computes a round's (B, k) cost tile from the block's compact lists
   into shared memory, selects the round's picks and commits them (S_i |=
   N(u), sizes, parts, retirement) on the card; exact and sketched widths
   take the same kernel.  A tile past its shared memory
   (``parsa_scan_fits``) takes the per-round route ``_scan_per_round``,
   chosen by shape before any launch: one ``parsa_cost_select`` a round
   (``sketch_cost_select`` on the block's lists at sketched widths,
   ``set_repr="sketch"``), the picks committed by tensor ops.  Both give
   the bits of the JAX scan; on the CPU the scan runs ``parsa_scan_ref``,
   the kernel's plain version.

4. *Parallel workers* (Algorithm 4, the ``parallel_device`` backend) —
   ``parallel_blocked_partition_u_impl`` shards the same packed blocks
   over W workers.  On one card the workers are a leading axis of the
   carried state, ``s_local`` (W, k, Wwords) and ``sz_local`` (W, k):
   within a super-step each worker scans its ``merge_every`` blocks against
   its own stale slice, all workers in ONE ``parsa_scan`` launch (a
   cluster per worker), then ONE ``merge_worker_sets`` launch OR-merges
   the sets, counts the pushed words, merges the sizes as ``sz_global +
   Σ_w (sz_local[w] − sz_global)`` and writes both back into every
   worker's slice on the device.  The JAX
   ``shard_map`` + ``all_gather`` image of the same protocol gives the
   same bits.  Given a ``torch.distributed`` group of W ranks, rank r is
   worker r instead (``_parallel_scan_group``): it holds only shard r on
   its device, scans it in one ``parsa_scan`` launch a super-step,
   all-gathers every rank's (k, Wwords) sets and (k,) sizes and merges the
   gathered stack in the same ``merge_worker_sets`` launch, so every rank
   ends with the bits of the one-card route.

``blocked_partition_u_hostloop_impl`` / ``_assign_block`` are the
sequential per-vertex parity oracle (the ``host_blocked_oracle`` backend),
driven by the ``parsa_cost`` kernel.  On CPU tensors every kernel wrapper
runs its plain PyTorch version; there is no ``use_kernel`` switch.  The
JAX ``use_kernel=False`` path (carried tile, sparse down-date) is another
realisation of the same integer program and is not ported.
"""
from __future__ import annotations

import hashlib
import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.parsa_cost import (
    BIG,
    coerce_packed_sets,
    merge_worker_sets,
    pack_bitmask,
    pack_bitmask_csr_sparse,
    parsa_cost,
    parsa_cost_select,
    parsa_scan,
    parsa_scan_fits,
    rebuild_block,
    sketch_cost_select,
    truncated_lists,
)
from .bipartite import BipartiteGraph
from .dispatch import _count_dispatch, phase

__all__ = [
    "PackedBlocks",
    "pack_graph_blocks",
    "blocked_partition_u_impl",
    "blocked_partition_u_hostloop_impl",
    "parallel_blocked_partition_u_impl",
    "resolve_worker_group",
    "shard_parsa_step",
]


class PackedBlocks(NamedTuple):
    """Blocked packing of (a permutation of) U, host side."""

    valid: np.ndarray     # (n_blocks, B) bool — False for padding rows
    widx: np.ndarray      # (n_blocks, B, cap) int32 nonzero-word indices
    vals: np.ndarray      # (n_blocks, B, cap) int32 word values at widx
    trunc: np.ndarray     # (n_blocks, B) bool — row has > cap nonzero words
    tr_ids: np.ndarray    # (n_blocks, TB) int32 local row of each truncated
                          #   row; B (out of range → dropped) for padding
    tr_masks: np.ndarray  # (n_blocks, TB, W) int32 full masks of those rows
    order: np.ndarray     # (num_u,) int64 — global vertex id per packed row


def pack_graph_blocks(
    graph: BipartiteGraph,
    block: int,
    order: np.ndarray | None = None,
    cap: int = 48,
) -> PackedBlocks:
    """Pack all of U (in ``order``) into padded (n_blocks, B, …) stacks with
    one CSR gather and one sorted pass; no per-vertex Python work and no
    dense (n, W) array."""
    n = graph.num_u
    if order is None:
        order = np.arange(n, dtype=np.int64)
    order = np.asarray(order, dtype=np.int64)
    uniq, wordvals, widx, vals, trunc = pack_bitmask_csr_sparse(
        graph.u_indptr, graph.u_indices, graph.num_v, rows=order, cap=cap)[:5]
    W = (graph.num_v + 31) // 32
    n_blocks = max(1, -(-n // block))
    pad = n_blocks * block - n
    if pad:
        widx = np.pad(widx, [(0, pad), (0, 0)])
        vals = np.pad(vals, [(0, pad), (0, 0)])
        trunc = np.pad(trunc, [(0, pad)])
    valid = (np.arange(n_blocks * block) < n).reshape(n_blocks, block)
    # side channel: full masks of truncated rows, grouped per block
    t_rows = np.flatnonzero(trunc)                       # padded row ids
    t_block = t_rows // block
    t_counts = np.bincount(t_block, minlength=n_blocks)
    TB = max(1, int(t_counts.max()) if t_rows.size else 1)
    tr_ids = np.full((n_blocks, TB), block, np.int32)    # block == dropped
    tr_masks = np.zeros((n_blocks, TB, W), np.int32)
    if t_rows.size:
        t_starts = np.concatenate([[0], np.cumsum(t_counts)[:-1]])
        slot = np.arange(t_rows.size, dtype=np.int64) - t_starts[t_block]
        tr_ids[t_block, slot] = (t_rows % block).astype(np.int32)
        trunc_idx = np.full(n_blocks * block, -1, np.int64)
        trunc_idx[t_rows] = t_block * TB + slot
        r = uniq // W
        member = trunc[r]
        tr_masks.reshape(-1, W)[trunc_idx[r[member]], uniq[member] % W] = \
            wordvals[member]
    return PackedBlocks(
        valid=valid,
        widx=widx.reshape(n_blocks, block, cap),
        vals=vals.reshape(n_blocks, block, cap),
        trunc=trunc.reshape(n_blocks, block),
        tr_ids=tr_ids,
        tr_masks=tr_masks,
        order=order,
    )


# --------------------------------------------------------------------------
# Sequential per-vertex reference (the host_blocked_oracle backend).
# --------------------------------------------------------------------------
def _assign_block(
    nbr: torch.Tensor,      # (B, W) int32 packed N(u)
    s_masks: torch.Tensor,  # (k, W) int32 packed S_i — updated in place
    sizes: torch.Tensor,    # (k,) int32 |U_i| — updated in place
    valid: torch.Tensor | None = None,  # (B,) bool — padding rows, if any
) -> torch.Tensor:
    """Greedy-assign every row of the block, one vertex at a time: B steps,
    each picking the smallest partition (first on ties), its cheapest row,
    and down-dating that partition's column of the (B, k) cost tile.
    Returns parts (B,) int32.  The down-date popcount(nbr & delta) is the
    ``parsa_cost`` kernel against the complement ~delta.  ``valid`` marks
    padding rows: they start retired and never enter S or the sizes, and a
    step whose cheapest row is retired assigns nothing (JAX's
    ``_assign_block(valid=)``).  Nothing reads back to the host."""
    B = nbr.shape[0]
    cost = parsa_cost(nbr, s_masks)
    if valid is not None:
        cost = torch.where(valid[:, None], cost, BIG)
    parts = torch.full((B,), -1, dtype=torch.int32, device=nbr.device)
    one = torch.ones(1, dtype=torch.int32, device=nbr.device)
    for _ in range(B):
        i = sizes.argmin().view(1)                  # partition to grow
        u = cost.index_select(1, i).argmin().view(1)  # cheapest row for it
        mask_u = nbr.index_select(0, u)             # (1, W)
        pick = i.to(torch.int32)
        if valid is None:
            grow = one
        else:
            # once only retired or padding rows remain their cost sits near
            # BIG (down-dates drift it a little): stop assigning then
            active = cost[u, i] < BIG // 2
            grow = active.to(torch.int32)
            mask_u = mask_u * grow
            pick = torch.where(active, pick, parts.index_select(0, u))
        s_i = s_masks.index_select(0, i)
        dec = parsa_cost(nbr, ~(mask_u & ~s_i))     # (B, 1) = |N(v) ∩ delta|
        cost.index_add_(1, i, -dec)                 # cost never increases
        cost.index_fill_(0, u, BIG)                 # retire u from the block
        s_masks.index_copy_(0, i, s_i | mask_u)
        sizes.index_add_(0, i, grow)
        parts.index_copy_(0, u, pick)
    return parts


def blocked_partition_u_hostloop_impl(
    graph: BipartiteGraph,
    k: int,
    block: int = 256,
    init_sets: np.ndarray | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block host packing + per-vertex greedy: the parity oracle of the
    scan.  Returns (parts_u (|U|,) int32, final packed s_masks (k, W))."""
    device = torch.device(device)
    s_masks, sizes = _init_state(graph, k, init_sets, device)
    order = np.random.default_rng(seed).permutation(graph.num_u)
    parts = torch.full((graph.num_u,), -1, dtype=torch.int32, device=device)
    for start in range(0, graph.num_u, block):
        ids = order[start : start + block]
        masks = pack_bitmask([graph.neighbors(int(u)) for u in ids], graph.num_v)
        p = _assign_block(torch.from_numpy(masks).to(device), s_masks, sizes)
        parts[torch.from_numpy(ids).to(device)] = p
    return parts, s_masks


# --------------------------------------------------------------------------
# Rounds-based blocked greedy.
# --------------------------------------------------------------------------
def _init_state(graph: BipartiteGraph, k: int, init_sets, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh (s_masks (k, W), sizes (k,)) on ``device``.  ``init_sets`` is
    copied (dense bool or packed words), never aliased: the scan updates
    its sets in place."""
    W = (graph.num_v + 31) // 32
    if init_sets is None:
        s_masks = torch.zeros((k, W), dtype=torch.int32, device=device)
    elif isinstance(init_sets, torch.Tensor):
        s_masks = init_sets.to(device=device, dtype=torch.int32, copy=True)
    else:
        s_masks = torch.tensor(coerce_packed_sets(init_sets, graph.num_v),
                               dtype=torch.int32, device=device)
    if s_masks.shape != (k, W):
        raise ValueError(f"init_sets packs to {tuple(s_masks.shape)}, "
                         f"expected ({k}, {W})")
    return s_masks, torch.zeros(k, dtype=torch.int32, device=device)


def _trunc_flags(tr_ids: torch.Tensor, B: int) -> torch.Tensor:
    """(B,) bool on the device: the block's rows truncated past ``cap``,
    from its side channel's ids (padding entries point at the sink row B).
    No host sync."""
    flags = torch.zeros(B + 1, dtype=torch.bool, device=tr_ids.device)
    flags.index_fill_(0, tr_ids.long(), True)
    return flags[:B]


def _select_round(nbr, retired, parts, s_masks, sizes, order, enabled, inv,
                  rows) -> None:
    """One greedy round over slots ``order``, committed in place: S_i |=
    N(u), sizes, parts, retirement.  ``inv`` maps partitions to slots
    (None for the identity order).  The block's compact ``rows`` (widx,
    vals, trunc) mark a sketched width: they pick ``sketch_cost_select``,
    which reads them.  Every step is a tensor op: nothing waits for the
    host."""
    B = nbr.shape[0] - 1
    if rows is None:
        u_sel, c_sel = parsa_cost_select(nbr[:B], s_masks, retired[:B],
                                         order=order, enabled=enabled)
    else:
        u_sel, c_sel = sketch_cost_select(nbr[:B], s_masks, retired[:B],
                                          order=order, enabled=enabled,
                                          rows=rows)
    act = c_sel < BIG
    idx = torch.where(act, u_sel, B).long()   # inactive slots → sink row
    picked = nbr[idx]                          # (k, W); sink row is zero
    if inv is None:
        s_masks |= picked
        sizes += act
    else:
        s_masks |= picked[inv]
        sizes += act[inv]
    parts[idx] = order                         # slot j's partition
    retired.index_fill_(0, idx, True)


def _scan_per_round(widx, vals, tr_ids, tr_masks, valid, s_masks, sizes,
                    parts, b0: int, nblk: int, sketch: bool) -> None:
    """The per-round route of ``_scan``, for tiles past ``parsa_scan``'s
    shared memory: the rounds of ``parsa_scan`` (JAX
    ``_assign_block_rounds``: the catch-up round in the stable argsort of
    the sizes, only min-sized partitions enabled, then ⌈(B−1)/k⌉ full
    rounds in index order), each one select on the card
    (``parsa_cost_select``, two launches; at sketched widths
    ``sketch_cost_select`` on the block's lists, one ``sketch_select``
    launch while its tile fits) and a few tensor ops that commit the
    picks.  One host read of the valid flags skips the blocks of padding
    rows; the layout and bits of ``parsa_scan``."""
    nw, _, B = valid.shape
    k = s_masks.shape[1]
    dev = s_masks.device
    iota_k = torch.arange(k, dtype=torch.int32, device=dev)
    en_all = torch.ones(k, dtype=torch.bool, device=dev)
    live = valid[:, b0:b0 + nblk].any(-1).tolist()
    for w in range(nw):
        s, sz = s_masks[w], sizes[w]
        for b in range(b0, b0 + nblk):
            if not live[w][b - b0]:
                continue   # padding rows only: every round picks nothing
            nbr = rebuild_block(widx[w, b], vals[w, b], tr_ids[w, b],
                                tr_masks[w, b])
            rows = ((widx[w, b], vals[w, b], _trunc_flags(tr_ids[w, b], B))
                    if sketch else None)
            retired = torch.ones(B + 1, dtype=torch.bool, device=dev)
            retired[:B] = ~valid[w, b]
            p = torch.full((B + 1,), -1, dtype=torch.int32, device=dev)
            ord0 = torch.argsort(sz, stable=True)
            _select_round(nbr, retired, p, s, sz, ord0.to(torch.int32),
                          sz[ord0] == sz.min(), torch.argsort(ord0), rows)
            for _ in range(-(-(B - 1) // k)):
                _select_round(nbr, retired, p, s, sz, iota_k, en_all, None,
                              rows)
            parts[w, b] = p[:B]


def _scan_route(device: torch.device, B: int, k: int) -> str:
    """How ``_scan`` scans blocks of B rows at k partitions on ``device``:
    ``"parsa_scan"`` (one launch on the card, its plain version on the
    CPU) or, on the card for a tile past ``parsa_scan``'s shared memory,
    ``"per_round"``.  A shape rule, decided before any launch."""
    if device.type == "cuda" and not parsa_scan_fits(B, k):
        return "per_round"
    return "parsa_scan"


def _scan(widx, vals, tr_ids, tr_masks, valid, s_masks, sizes, parts,
          b0: int, nblk: int, sketch: bool, tr_lists=None) -> None:
    """Blocks ``[b0, b0 + nblk)`` of every worker (the leading axis of
    every argument), in place, by the route of ``_scan_route``.
    ``sketch`` marks a sketched width, which only the per-round route
    reads; ``tr_lists`` are ``parsa_scan``'s truncated-row lists, built
    once by a caller that scans the stack in several calls."""
    if _scan_route(s_masks.device, valid.shape[-1],
                   s_masks.shape[1]) == "per_round":
        _scan_per_round(widx, vals, tr_ids, tr_masks, valid, s_masks, sizes,
                        parts, b0, nblk, sketch)
    else:
        parsa_scan(widx, vals, tr_ids, tr_masks, valid, s_masks, sizes,
                   parts, b0=b0, nblk=nblk, tr_lists=tr_lists)


def _partition_scan(
    widx: torch.Tensor,      # (n_blocks, B, cap) int32
    vals: torch.Tensor,      # (n_blocks, B, cap) int32
    tr_ids: torch.Tensor,    # (n_blocks, TB) int32
    tr_masks: torch.Tensor,  # (n_blocks, TB, W) int32
    valid: torch.Tensor,     # (n_blocks, B) bool
    s_masks: torch.Tensor,   # (k, W) int32 — carried, updated in place
    sizes: torch.Tensor,     # (k,) int32 — carried, updated in place
    sketch: bool = False,    # sketched width (read by the per-round route)
) -> torch.Tensor:
    """Scan the blocks in order, carrying (S, sizes) on the device: one
    ``parsa_scan`` launch on the card.  Returns parts (n_blocks, B) int32
    in packed row order."""
    nb, B = valid.shape
    parts = torch.full((1, nb, B), -1, dtype=torch.int32,
                       device=s_masks.device)
    _scan(widx[None], vals[None], tr_ids[None], tr_masks[None], valid[None],
          s_masks[None], sizes[None], parts, 0, nb, sketch)
    return parts[0]


def blocked_partition_u_impl(
    graph: BipartiteGraph,
    k: int,
    block: int = 256,
    init_sets: np.ndarray | torch.Tensor | None = None,
    seed: int = 0,
    cap: int = 48,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
    sketch: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked greedy partition of U on ``device``.
    Returns (parts_u (|U|,) int32, final packed s_masks (k, W) int32), both
    on ``device``.

    Packs the permuted U once on the host (vertex order
    ``default_rng(seed).permutation(|U|)``, as in the JAX package), moves
    the compact lists to the device and scans the blocks there.
    ``init_sets`` may be dense (k, |V|) bool or packed (k, W) words.  A
    ``timings`` dict receives the host ``"pack"`` seconds.  ``sketch=True``
    marks the packed width as a sketched domain: only the per-round route
    reads it (its rounds then select with ``sketch_cost_select``); the
    bits do not change.
    """
    device = torch.device(device)
    t_pack = time.perf_counter()
    s_masks, sizes = _init_state(graph, k, init_sets, device)
    order = np.random.default_rng(seed).permutation(graph.num_u)
    packed = pack_graph_blocks(graph, block, order=order, cap=cap)
    if timings is not None:
        timings["pack"] = time.perf_counter() - t_pack
    with phase("partition_scan", nbytes=s_masks.nbytes + sizes.nbytes,
               k=k, blocks=packed.valid.shape[0]):
        parts_blocks = _partition_scan(
            torch.from_numpy(packed.widx).to(device),
            torch.from_numpy(packed.vals).to(device),
            torch.from_numpy(packed.tr_ids).to(device),
            torch.from_numpy(packed.tr_masks).to(device),
            torch.from_numpy(packed.valid).to(device),
            s_masks, sizes, sketch)
        parts = torch.empty(graph.num_u, dtype=torch.int32, device=device)
        parts[torch.from_numpy(order).to(device)] = \
            parts_blocks.reshape(-1)[: graph.num_u]
    return parts, s_masks


# --------------------------------------------------------------------------
# Parallel workers (Algorithm 4) on one card.
# --------------------------------------------------------------------------
def _pad_block_stack(packed: PackedBlocks, n_total: int) -> PackedBlocks:
    """Append ``n_total - n_blocks`` empty blocks (all rows padding: valid
    False, tr_ids == B ⇒ dropped) so a block stack divides evenly into
    per-worker shards and merge groups.  Empty blocks assign nothing and
    leave (S, sizes) untouched, so trailing padding is parity-safe."""
    nb, B = packed.valid.shape
    if n_total == nb:
        return packed
    e = n_total - nb

    def pad0(a):
        return np.pad(a, [(0, e)] + [(0, 0)] * (a.ndim - 1))

    tr_pad = np.full((e, packed.tr_ids.shape[1]), B, np.int32)
    return PackedBlocks(
        valid=pad0(packed.valid),
        widx=pad0(packed.widx),
        vals=pad0(packed.vals),
        trunc=pad0(packed.trunc),
        tr_ids=np.concatenate([packed.tr_ids, tr_pad]),
        tr_masks=pad0(packed.tr_masks),
        order=packed.order,
    )


def _weighted_block_targets(weights: np.ndarray, nb: int) -> np.ndarray:
    """Largest-remainder apportionment of ``nb`` real blocks proportional
    to per-worker ``weights`` (higher weight ⇒ more blocks)."""
    raw = weights / weights.sum() * nb
    t = np.floor(raw).astype(np.int64)
    short = nb - int(t.sum())
    if short:
        t[np.argsort(-(raw - t), kind="stable")[:short]] += 1
    return t


def _biased_perm(targets: np.ndarray, nb: int, nb_per: int,
                 shuffle_rng: np.random.Generator | None) -> np.ndarray:
    """Block→worker permutation handing worker ``w`` exactly
    ``targets[w]`` real blocks (randomized across workers when a rng is
    given) and topping every worker up to ``nb_per`` with trailing padding
    blocks — the parity-safe no-ops ``_pad_block_stack`` appends — so every
    shard keeps the same shape while slow workers scan mostly padding."""
    real = (shuffle_rng.permutation(nb) if shuffle_rng is not None
            else np.arange(nb, dtype=np.int64))
    pad_ids = np.arange(nb, nb_per * targets.shape[0], dtype=np.int64)
    out, r0, p0 = [], 0, 0
    for t_w in targets:
        t_w = int(t_w)
        out.append(real[r0 : r0 + t_w])
        out.append(pad_ids[p0 : p0 + nb_per - t_w])
        r0 += t_w
        p0 += nb_per - t_w
    return np.concatenate(out)


def _parallel_scan(
    widx: torch.Tensor,      # (workers, nb_per, B, cap) int32
    vals: torch.Tensor,      # (workers, nb_per, B, cap) int32
    tr_ids: torch.Tensor,    # (workers, nb_per, TB) int32
    tr_masks: torch.Tensor,  # (workers, nb_per, TB, W) int32
    valid: torch.Tensor,     # (workers, nb_per, B) bool
    s_masks: torch.Tensor,   # (k, W) int32 — the shared sets at entry
    sizes: torch.Tensor,     # (k,) int32 — the shared sizes at entry
    merge_every: int,
    sketch: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every worker's blocked scan with an OR-merge each ``merge_every``
    blocks, all on the device: per super-step one ``_scan`` over every
    worker and one merge.  Returns (parts (workers, n_super,
    merge_every, B) int32 in sharded order, merged s_masks, merged sizes,
    pushed (1,) int64 changed words); ``s_masks`` and ``sizes`` themselves
    are left as they were."""
    nw, nb_per, B = valid.shape
    dev = s_masks.device
    n_super = nb_per // merge_every
    parts = torch.full((nw, nb_per, B), -1, dtype=torch.int32, device=dev)
    s_global, sz_global = s_masks, sizes
    # each worker's stale copy plus its own picks, updated in place (a
    # fresh buffer: at nw == 1 ``contiguous()`` would alias s_masks)
    fresh = torch.contiguous_format
    s_local = s_global.expand(nw, -1, -1).clone(memory_format=fresh)
    sz_local = sz_global.expand(nw, -1).clone(memory_format=fresh)
    pushed = torch.zeros(1, dtype=torch.int64, device=dev)
    # parsa_scan's truncated-row lists, built once for every super-step
    on_card = dev.type == "cuda" and parsa_scan_fits(B, s_masks.shape[0])
    tr_lists = truncated_lists(tr_masks) if on_card else None
    for step in range(n_super):
        # every worker's merge_every blocks against its own stale copy: one
        # parsa_scan launch, a cluster per worker
        _scan(widx, vals, tr_ids, tr_masks, valid, s_local, sz_local, parts,
              step * merge_every, merge_every, sketch, tr_lists)
        # server union-push, one launch: OR-merge the sets (counting the
        # pushed words), add every worker's size delta onto the pre-merge
        # totals, and write both back into every worker's copy
        s_global, sz_global = merge_worker_sets(s_local, s_global, sz_local,
                                                sz_global, pushed)
    return (parts.reshape(nw, n_super, merge_every, B), s_global,
            sz_global, pushed)


# --------------------------------------------------------------------------
# Parallel workers (Algorithm 4) across processes: rank r is worker r.
# --------------------------------------------------------------------------
def resolve_worker_group(workers: int, group) -> None:
    """Fail fast unless ``group`` (a ``torch.distributed`` process group)
    holds exactly ``workers`` ranks — cheap, so callers run it before any
    O(edges) host packing.  JAX's ``resolve_worker_devices`` takes the
    first ``workers`` devices of a larger list; a larger group raises here,
    since its other ranks would sit idle while they wait on the gathers."""
    n = group.size()
    if n != workers:
        raise ValueError(
            f"the process group has {n} ranks but the scan has {workers} "
            f"workers; Algorithm 4 over a group runs one worker a rank "
            f"(set workers, or devices, to the group's size)")


def _gather_flat(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """All-gather ``inp`` from every rank of ``group`` into ``out``, rank
    r's copy at rows ``[r·m, (r+1)·m)`` (``out`` is flat along dim 0:
    gloo refuses a stacked output).  On NCCL the gather runs on the card,
    ordered after the work queued on the current stream, with no host
    sync.  A gloo group gathers host tensors: card tensors are copied
    through host memory, explicitly, here — the transport of a gloo group
    the caller chose, never a stand-in for a failed NCCL one."""
    import torch.distributed as dist

    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    if out.device.type != "cpu" and dist.get_backend(group) == "gloo":
        host = torch.empty(out.shape, dtype=out.dtype)
        gather(host, inp.cpu(), group=group)
        out.copy_(host)
    else:
        gather(out, inp, group=group)


_PLAN_DISAGREES = ("the ranks of the group hold different block→worker "
                   "plans (permutation, block targets or shapes): every "
                   "rank must pack the same graph and draw the same "
                   "permutation")


def _check_ranks_agree(group, device: torch.device, *parts,
                       what: str = _PLAN_DISAGREES) -> None:
    """Gather a digest of ``parts`` (arrays, ints or None) from every rank
    of ``group`` and raise ``ValueError(what)`` on every rank unless all
    agree: the scans must never start on different block→worker plans."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(b"none" if p is None else
                 np.ascontiguousarray(p).tobytes() if isinstance(p, np.ndarray)
                 else repr(p).encode())
        h.update(b"|")
    mine = torch.tensor([int.from_bytes(h.digest(), "little", signed=True)],
                        dtype=torch.int64, device=device)
    every = torch.empty(group.size(), dtype=torch.int64, device=device)
    _gather_flat(every, mine, group)
    if not bool((every == every[0]).all()):
        raise ValueError(what)


def _parallel_scan_group(
    widx: torch.Tensor,      # (1, nb_per, B, cap) int32 — this rank's shard
    vals: torch.Tensor,      # (1, nb_per, B, cap) int32
    tr_ids: torch.Tensor,    # (1, nb_per, TB) int32
    tr_masks: torch.Tensor,  # (1, nb_per, TB, W) int32
    valid: torch.Tensor,     # (1, nb_per, B) bool
    s_masks: torch.Tensor,   # (k, W) int32 — the shared sets at entry
    sizes: torch.Tensor,     # (k,) int32 — the shared sizes at entry
    merge_every: int,
    sketch: bool,
    group,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """``_parallel_scan`` with one worker a rank of ``group``: this rank
    scans only its own shard, ``merge_every`` blocks a super-step against
    its stale copy (one ``parsa_scan`` launch), gathers every rank's sets
    and sizes, and merges the gathered (n, k, W) stack with the one-card
    route's ``merge_worker_sets`` launch.  OR and int32 addition do not
    depend on order, so every rank holds the same merged state and the
    same ``pushed`` count.  The parts are gathered once, at the end.
    Returns ``_parallel_scan``'s four outputs, the same on every rank, and
    the bytes this rank received by the gathers."""
    n = group.size()
    _, nb_per, B = valid.shape
    k, W = s_masks.shape
    dev = s_masks.device
    n_super = nb_per // merge_every
    parts = torch.full((1, nb_per, B), -1, dtype=torch.int32, device=dev)
    s_global, sz_global = s_masks, sizes
    s_local = s_global[None].clone(memory_format=torch.contiguous_format)
    sz_local = sz_global[None].clone(memory_format=torch.contiguous_format)
    s_all = torch.empty((n * k, W), dtype=torch.int32, device=dev)
    sz_all = torch.empty((n * k,), dtype=torch.int32, device=dev)
    pushed = torch.zeros(1, dtype=torch.int64, device=dev)
    on_card = dev.type == "cuda" and parsa_scan_fits(B, k)
    tr_lists = truncated_lists(tr_masks) if on_card else None
    for step in range(n_super):
        _scan(widx, vals, tr_ids, tr_masks, valid, s_local, sz_local, parts,
              step * merge_every, merge_every, sketch, tr_lists)
        _gather_flat(s_all, s_local[0], group)
        _gather_flat(sz_all, sz_local[0], group)
        # the server union-push over every rank's copy, on each rank
        s_global, sz_global = merge_worker_sets(
            s_all.view(n, k, W), s_global, sz_all.view(n, k), sz_global,
            pushed)
        s_local[0].copy_(s_global)
        sz_local[0].copy_(sz_global)
    parts_all = torch.empty((n * nb_per, B), dtype=torch.int32, device=dev)
    _gather_flat(parts_all, parts[0], group)
    nbytes = 4 * n * (n_super * (k * W + k) + nb_per * B)
    return (parts_all.reshape(n, n_super, merge_every, B), s_global,
            sz_global, pushed, nbytes)


def _run_parallel_packed_scan(
    packed: PackedBlocks,
    s_masks: torch.Tensor,
    sizes: torch.Tensor,
    *,
    k: int,
    workers: int,
    merge_every: int,
    shuffle_rng: np.random.Generator | None = None,
    worker_weights: np.ndarray | None = None,
    count_name: str = "parallel_partition_scan",
    sketch: bool = False,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict, np.ndarray | None]:
    """Pad the block stack to whole per-worker merge groups, shard it over
    the worker axis (optionally in a randomized block→worker order drawn
    from ``shuffle_rng``) and run every worker's scan with its merges on
    the device of ``s_masks``.

    With a ``torch.distributed`` ``group`` of ``workers`` ranks, rank r is
    worker r (``_parallel_scan_group``): every rank passes the same
    ``packed``, state and seeded draws, moves only its own shard to its
    device and returns the same outputs as every other rank and as the
    one-card route.  The ranks first gather a digest of the permutation,
    the block targets and the shapes, and all raise ``ValueError`` if any
    differ.  The bytes a rank receives by the gathers count as one
    ``parallel_merge_gather`` dispatch.

    ``worker_weights`` (workers-long, nonnegative) biases the block
    distribution: real blocks are apportioned proportionally to weight
    (largest remainder) and the shortfall is filled with parity-safe
    padding blocks, so every shard keeps the same shape.  The merge cadence
    is untouched.  The scan counts as one dispatch of ``count_name``
    (the stream's parallel feeds count as ``stream_feed_scan``).

    Returns ``(parts_blocks, s_out, sizes_out, traffic, perm)`` where
    ``parts_blocks`` is the (workers, n_super, merge_every, B) output in
    *sharded* block order (flatten + ``argsort(perm)`` to recover stack
    order when a permutation was applied; ``perm`` is None only when
    neither shuffle nor weights were given), and ``traffic`` the push/pull
    dict in bitmask-word bytes, with the formulas of the JAX package.
    Nothing reads back to the host until the scan has ended.
    """
    if group is not None:
        resolve_worker_group(workers, group)
    nb = packed.valid.shape[0]
    targets = None
    if worker_weights is not None and workers > 1:
        w = np.asarray(worker_weights, np.float64)
        if w.shape != (workers,):
            raise ValueError(
                f"worker_weights must have shape ({workers},), got {w.shape}")
        if not np.all(np.isfinite(w)) or np.any(w < 0) or w.sum() <= 0:
            raise ValueError(
                "worker_weights must be finite, nonnegative, with a "
                "positive sum")
        targets = _weighted_block_targets(w, nb)
        nb_per = max(int(targets.max()), 1)
        nb_per = -(-nb_per // merge_every) * merge_every
        packed = _pad_block_stack(packed, nb_per * workers)
        perm = _biased_perm(targets, nb, nb_per, shuffle_rng)
    else:
        # blocks per worker, rounded up to whole merge groups
        nb_per = -(-nb // workers)
        nb_per = -(-nb_per // merge_every) * merge_every
        packed = _pad_block_stack(packed, nb_per * workers)
        total = nb_per * workers
        perm = (shuffle_rng.permutation(total) if shuffle_rng is not None
                else None)
    dev = s_masks.device
    W = packed.tr_masks.shape[-1]
    n_super = nb_per // merge_every
    if group is None:
        def shard(x):
            if perm is not None:
                x = x[perm]
            return torch.from_numpy(np.ascontiguousarray(
                x.reshape((workers, nb_per) + x.shape[1:]))).to(dev)
    else:
        _check_ranks_agree(group, dev, perm, targets, nb, nb_per, workers,
                           merge_every, k, W, packed.valid.shape[1])
        r = group.rank()
        rows = (np.arange(r * nb_per, (r + 1) * nb_per) if perm is None
                else perm[r * nb_per:(r + 1) * nb_per])

        def shard(x):   # this rank's blocks only
            return torch.from_numpy(x[rows][None]).to(dev)

    with phase(count_name,
               nbytes=s_masks.nbytes + sizes.nbytes, k=k,
               workers=workers, blocks=nb_per * workers):
        args = (shard(packed.widx), shard(packed.vals), shard(packed.tr_ids),
                shard(packed.tr_masks), shard(packed.valid), s_masks, sizes,
                merge_every, sketch)
        if group is None:
            parts_blocks, s_out, sizes_out, pushed = _parallel_scan(*args)
        else:
            parts_blocks, s_out, sizes_out, pushed, gathered = \
                _parallel_scan_group(*args, group)
    if group is not None:
        _count_dispatch("parallel_merge_gather", gathered, workers=workers,
                        merges=n_super)
    traffic = {
        "pushed_bytes": 4 * int(pushed.item()),
        "pulled_bytes": 4 * workers * n_super * k * W,
        "tasks": workers * n_super,
        "stale_pushes_missed": n_super * workers * (workers - 1),
    }
    return parts_blocks, s_out, sizes_out, traffic, perm


def parallel_blocked_partition_u_impl(
    graph: BipartiteGraph,
    k: int,
    workers: int = 4,
    block: int = 256,
    merge_every: int = 1,
    init_sets: np.ndarray | torch.Tensor | None = None,
    seed: int = 0,
    cap: int = 48,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
    sketch: bool = False,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Algorithm 4 with ``workers`` workers on one device, or one worker a
    rank of a ``torch.distributed`` ``group``.

    The permuted U is packed once (the permutation of ``device_scan``) and
    split into ``workers`` contiguous shards of whole blocks; each worker
    scans its shard against a stale copy of the packed server sets, and
    every ``merge_every`` blocks the copies OR-merge (τ ≡ merge_every − 1
    blocks of staleness).  With ``workers=1`` the schedule collapses to
    ``blocked_partition_u_impl`` bit for bit, for any ``merge_every``.

    Balance: every worker keeps §4.1 perfect balance against its *stale*
    view of the global sizes, so when a merge lands with uneven sizes
    (possible whenever k ∤ |U|) each worker applies the same catch-up and
    the corrections overlap — global ``max|U_i| − min|U_i|`` is bounded by
    ``workers`` (exactly ≤ 1 at workers=1).

    Returns (parts_u (|U|,) int32, final packed s_masks (k, W) int32), both
    on ``device``, and the traffic dict: each worker pulls the full packed
    (k, W) set at every merge and pushes only its changed words;
    ``stale_pushes_missed`` counts W−1 peers per worker per merge.

    Without a ``group`` the workers are an axis of one card's state, so,
    unlike the JAX package, their count is not limited by a device count.
    With one, the group must hold exactly ``workers`` ranks (checked before
    packing: ``resolve_worker_group``); each rank passes the same graph and
    arguments, ``device`` is its own, and every rank returns the same
    outputs, those of the one-card route.  The caller creates the group.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if merge_every < 1:
        raise ValueError(f"merge_every must be >= 1, got {merge_every}")
    if group is not None:
        resolve_worker_group(workers, group)   # before the pack
    device = torch.device(device)
    t_pack = time.perf_counter()
    s_masks, sizes = _init_state(graph, k, init_sets, device)
    order = np.random.default_rng(seed).permutation(graph.num_u)
    packed = pack_graph_blocks(graph, block, order=order, cap=cap)
    if timings is not None:
        timings["pack"] = time.perf_counter() - t_pack
    parts_blocks, s_out, _, traffic, _ = _run_parallel_packed_scan(
        packed, s_masks, sizes, k=k, workers=workers,
        merge_every=merge_every, sketch=sketch, group=group)
    parts = torch.empty(graph.num_u, dtype=torch.int32, device=device)
    parts[torch.from_numpy(order).to(device)] = \
        parts_blocks.reshape(-1)[: graph.num_u]
    return parts, s_out, traffic


def shard_parsa_step(k: int, select: str = "rounds"):
    """Return the body of one Algorithm 4 round over a leading worker axis:
    (per-worker packed block stacks, S, sizes) → (parts, merged S, sizes).

    The counterpart of JAX's ``shard_parsa_step``, whose body runs on each
    device of a ``shard_map``: here the W workers are the leading axis of
    every argument on one device.  ``valid`` (W, nb, B), ``widx`` and
    ``vals`` (W, nb, B, cap), ``trunc`` (W, nb, B), ``tr_ids`` (W, nb, TB)
    and ``tr_masks`` (W, nb, TB, Wwords) are each worker's stack from
    ``pack_graph_blocks`` on its U-shard; ``s_masks`` (k, Wwords) and
    ``sizes`` (k,) int32 are every worker's copy, or (W, k, Wwords) and
    (W, k) for a copy of its own.  Each worker scans its stack against its
    copy; then the sets OR-merge across workers and the sizes add up (JAX's
    ``all_gather`` + OR and ``psum``): one round with τ = nb − 1.  Returns
    (parts (W, nb, B) int32, -1 on padding rows; merged S (k, Wwords);
    sizes (k,) int32); the arguments are left as they were.

    ``select="rounds"`` runs the balanced rounds (on the card one
    ``parsa_scan`` launch for every worker, its plain version on the
    CPU); ``select="seq"`` the sequential per-vertex loop
    (``_assign_block``, a ``parsa_cost`` launch a step on the card).
    Padding rows start retired, so they never enter S or the sizes.  The
    merge is one ``merge_worker_sets`` launch (``union_delta.cu``).
    ``trunc`` is implied by ``tr_ids`` (the port's scan reads the
    truncated rows' ids) and is taken only to keep JAX's signature.
    """
    if select not in ("rounds", "seq"):
        raise ValueError(f"select must be 'rounds' or 'seq', got {select!r}")

    def body(valid, widx, vals, trunc, tr_ids, tr_masks, s_masks, sizes):
        nw, nb, B = valid.shape
        dev = valid.device
        if s_masks.shape[-2] != k or sizes.shape[-1] != k:
            raise ValueError(f"S {tuple(s_masks.shape)} and sizes "
                             f"{tuple(sizes.shape)} do not hold k={k}")
        # each worker's copy, updated in place (a fresh buffer)
        fresh = torch.contiguous_format
        s_local = s_masks.expand(nw, *s_masks.shape[-2:]).clone(
            memory_format=fresh)
        sz_local = sizes.expand(nw, k).clone(memory_format=fresh)
        parts = torch.full((nw, nb, B), -1, dtype=torch.int32, device=dev)
        if select == "rounds":
            _scan(widx, vals, tr_ids, tr_masks, valid, s_local, sz_local,
                  parts, 0, nb, False)
        else:
            for w in range(nw):
                for b in range(nb):
                    nbr = rebuild_block(widx[w, b], vals[w, b], tr_ids[w, b],
                                        tr_masks[w, b])[:B]
                    parts[w, b] = _assign_block(nbr, s_local[w], sz_local[w],
                                                valid[w, b])
        # the server union-push against empty sets: the OR of the workers'
        # sets and the sum of their sizes
        merged, sizes_out = merge_worker_sets(
            s_local, torch.zeros_like(s_local[0]), sz_local,
            torch.zeros_like(sz_local[0]),
            torch.zeros(1, dtype=torch.int64, device=dev))
        return parts, merged, sizes_out

    return body
