"""Wrappers of the hand-written CUDA kernels in ``csrc/``.

The device of the tensors decides: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain PyTorch version from ``ref.py``.  There
is no fallback from one to the other, and no ``use_kernel`` / ``interpret``
switch as in the JAX package.  Each wrapper checks device, dtype, shape and
contiguity, allocates its outputs (and the select tile's scratch) with
``torch.empty``, launches on ``torch.cuda.current_stream()`` without a
synchronize, and raises if the launch returns a CUDA error.

``LAUNCHES`` counts kernel launches, one entry per kernel, bumped only where
that kernel is launched; ``reset_launch_counts`` zeroes it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import (
    compact_rows,
    merge_worker_sets_ref,
    packed_union_delta_ref,
    parsa_cost_ref,
    parsa_scan_ref,
    refine_scan_ref,
    select_from_cost,
    select_greedy_from_cost,
    sketch_select_ref,
    sketch_select_rows_ref,
)

__all__ = ["LAUNCHES", "reset_launch_counts", "parsa_cost",
           "parsa_select_tile", "parsa_select_reduce", "parsa_cost_select",
           "sketch_cost_select", "sketch_select_fits", "sketch_smem_bytes",
           "parsa_scan", "parsa_scan_fits", "scan_smem_bytes",
           "truncated_lists", "refine_scan", "refine_sweep_chunk",
           "packed_union_delta", "merge_worker_sets",
           "SELECT_MAX_B", "SELECT_MAX_K", "SKETCH_SELECT_MAX_SMEM_BYTES",
           "SCAN_MAX_SMEM_BYTES", "REFINE_MAX_K", "ROW_CAP", "ROWS_BUILT"]

# parsa_select_reduce keeps each thread's retired rows in one 32-bit mask
# over at most 1024 threads; the slot loop itself takes any k, capped here
# so an absurd k fails loudly instead of running for minutes.
SELECT_MAX_B = 32 * 1024
SELECT_MAX_K = 1024
# sketch_select holds the whole (B, k) int32 tile and its greedy
# epilogue's words in one CTA's shared memory (sketch_smem_bytes), at most
# the H100's opt-in limit of 227 KiB a CTA.  Larger tiles take
# parsa_cost_select.
SKETCH_SELECT_MAX_SMEM_BYTES = 227 * 1024
# parsa_scan gives each CTA the H100's opt-in maximum of dynamic shared
# memory at most (232,448 bytes): rank 0 holds the (B, k) tile and the
# scan's own words (scan_smem_bytes).  Larger shapes scan round by round.
SCAN_MAX_SMEM_BYTES = 227 * 1024
# refine_sweep holds k costs in 32 lanes × at most 32 registers
REFINE_MAX_K = 1024
# the list length sketch_cost_select gives a row when it builds the lists
# itself: the scan's packing cap (core/partition.py, cap=48)
ROW_CAP = 48

LAUNCHES: dict[str, int] = {"parsa_cost": 0, "parsa_select_tile": 0,
                            "parsa_select_reduce": 0, "sketch_select": 0,
                            "parsa_scan": 0, "refine_sweep": 0,
                            "packed_union_delta": 0}


# sketch_cost_select calls on the card that were given only the dense
# block and built the row lists themselves (the scan passes its own)
ROWS_BUILT: dict[str, int] = {"sketch_select": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROWS_BUILT):
        for name in counts:
            counts[name] = 0


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(entry: str, *args) -> None:
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = build.load(entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[entry] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(device: torch.device) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors lie on {device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return True


def _check_select(B: int, k: int, retired: torch.Tensor,
                  order: torch.Tensor | None, enabled: torch.Tensor | None,
                  device: torch.device) -> torch.Tensor | None:
    """Check a select's shape and its row / slot arguments; returns
    ``enabled``, all True by default in greedy mode."""
    if not 1 <= B <= SELECT_MAX_B or not 1 <= k <= SELECT_MAX_K:
        raise ValueError(f"select takes 1 <= B <= {SELECT_MAX_B} and "
                         f"1 <= k <= {SELECT_MAX_K}, got B={B}, k={k}")
    _check("retired", retired, torch.bool, 1, device)
    if retired.shape[0] != B:
        raise ValueError(f"retired has {retired.shape[0]} rows, tile has {B}")
    if order is None:
        return enabled
    _check("order", order, torch.int32, 1, device)
    if enabled is None:
        enabled = torch.ones(k, dtype=torch.bool, device=device)
    _check("enabled", enabled, torch.bool, 1, device)
    if order.shape[0] != k or enabled.shape[0] != k:
        raise ValueError(f"order and enabled must have {k} slots")
    return enabled


def parsa_cost(nbr_masks: torch.Tensor, s_masks: torch.Tensor) -> torch.Tensor:
    """cost[u, i] = |N(u) \\ S_i|: (U, W), (K, W) int32 words → (U, K) int32,
    for any K (past 1,024 partitions the kernel reads each row again for
    every further 1,024)."""
    dev = nbr_masks.device
    _check("nbr_masks", nbr_masks, torch.int32, 2, dev)
    _check("s_masks", s_masks, torch.int32, 2, dev)
    (U, W), K = nbr_masks.shape, s_masks.shape[0]
    if s_masks.shape[1] != W:
        raise ValueError(f"word widths differ: {W} vs {s_masks.shape[1]}")
    if not _on_cuda(dev):
        return parsa_cost_ref(nbr_masks, s_masks)
    out = torch.empty((U, K), dtype=torch.int32, device=dev)
    if U and K:
        _launch("parsa_cost", _ptr(nbr_masks), _ptr(s_masks), U, K, W,
                _ptr(out))
    return out


def parsa_select_tile(nbr_masks: torch.Tensor, s_masks: torch.Tensor
                      ) -> torch.Tensor:
    """The select's cost tile, transposed: (B, W), (k, W) → (k, B) int32."""
    dev = nbr_masks.device
    _check("nbr_masks", nbr_masks, torch.int32, 2, dev)
    _check("s_masks", s_masks, torch.int32, 2, dev)
    (B, W), k = nbr_masks.shape, s_masks.shape[0]
    if s_masks.shape[1] != W:
        raise ValueError(f"word widths differ: {W} vs {s_masks.shape[1]}")
    if not 1 <= B <= SELECT_MAX_B or not 1 <= k <= SELECT_MAX_K:
        raise ValueError(f"select takes 1 <= B <= {SELECT_MAX_B} and "
                         f"1 <= k <= {SELECT_MAX_K}, got B={B}, k={k}")
    if not _on_cuda(dev):
        return parsa_cost_ref(nbr_masks, s_masks).T.contiguous()
    tile = torch.empty((k, B), dtype=torch.int32, device=dev)
    _launch("parsa_select_tile", _ptr(nbr_masks), _ptr(s_masks), B, k, W,
            _ptr(tile))
    return tile


def parsa_select_reduce(
    tile_t: torch.Tensor,               # (k, B) int32 from parsa_select_tile
    retired: torch.Tensor,              # (B,) bool
    order: torch.Tensor | None = None,  # (k,) int32 → greedy-round mode
    enabled: torch.Tensor | None = None,  # (k,) bool slot gate (greedy mode)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce a transposed cost tile.  Independent mode (``order is None``)
    → ((k,) mins, (k,) argmins) over unretired rows; greedy mode → ((k,)
    u_sel, (k,) c_sel) of one round in ``order`` with progressive
    retirement, (-1, BIG) for an inactive slot.  Ties go to the lowest row.
    """
    dev = tile_t.device
    _check("tile_t", tile_t, torch.int32, 2, dev)
    k, B = tile_t.shape
    enabled = _check_select(B, k, retired, order, enabled, dev)
    greedy = order is not None
    if not _on_cuda(dev):
        if greedy:
            return select_greedy_from_cost(tile_t.T, retired, order, enabled)
        return select_from_cost(tile_t.T, retired)
    out_a = torch.empty(k, dtype=torch.int32, device=dev)
    out_b = torch.empty(k, dtype=torch.int32, device=dev)
    _launch("parsa_select_reduce", _ptr(tile_t), _ptr(retired),
            _ptr(order if greedy else None), _ptr(enabled if greedy else None),
            B, k, int(greedy), _ptr(out_a), _ptr(out_b))
    return out_a, out_b


def parsa_cost_select(
    nbr_masks: torch.Tensor,   # (B, W) int32 packed N(u)
    s_masks: torch.Tensor,     # (k, W) int32 packed S_i
    retired: torch.Tensor,     # (B,) bool — rows excluded from selection
    *,
    order: torch.Tensor | None = None,    # (k,) int32 → greedy-round mode
    enabled: torch.Tensor | None = None,  # (k,) bool slot gate (greedy mode)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cost+select: per-partition (min, argmin) of the (B, k) cost tile.

    Independent mode (``order is None``) returns ((k,) mins, (k,) argmins);
    greedy mode returns ((k,) u_sel, (k,) c_sel) with u_sel = -1 /
    c_sel = BIG for inactive slots — the contract of the JAX
    ``parsa_cost_select``.  On CUDA it is two launches, the tile through L2
    then a one-CTA reduction.
    """
    return parsa_select_reduce(parsa_select_tile(nbr_masks, s_masks),
                               retired, order, enabled)


# candidates a greedy slot keeps in the shared-memory epilogue of
# sketch_select and parsa_scan (csrc/select_epilogue.cuh kCand)
SELECT_CANDIDATES = 8


def sketch_smem_bytes(B: int, k: int) -> int:
    """Dynamic shared memory of one ``sketch_select`` CTA, as
    ``csrc/sketch_select.cu`` lays it out: the (k, B) int32 tile, the
    greedy slots' candidates (k · min(k, 8) keys) and the taken flags (B
    bytes), rounded up to 16."""
    return -(-(4 * (k * B + k * min(k, SELECT_CANDIDATES)) + B) // 16) * 16


def sketch_select_fits(B: int, k: int) -> bool:
    """Whether a (B, k) round runs in the one-launch ``sketch_select``
    kernel: its shared memory fits ``SKETCH_SELECT_MAX_SMEM_BYTES`` and B
    the epilogue's ``SELECT_MAX_B``.  A shape function only."""
    return (sketch_smem_bytes(B, k) <= SKETCH_SELECT_MAX_SMEM_BYTES
            and B <= SELECT_MAX_B)


def _check_rows(rows, B: int, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    widx, vals, trunc = rows
    _check("widx", widx, torch.int32, 2, device)
    _check("vals", vals, torch.int32, 2, device)
    _check("trunc", trunc, torch.bool, 1, device)
    if (widx.shape != vals.shape or widx.shape[0] != B or trunc.shape[0] != B
            or widx.shape[1] < 1):
        raise ValueError(f"rows must be (B, cap), (B, cap), (B,) with B={B} "
                         f"and cap >= 1, got {tuple(widx.shape)}, "
                         f"{tuple(vals.shape)}, {tuple(trunc.shape)}")
    return widx, vals, trunc


def sketch_cost_select(
    nbr_masks: torch.Tensor,   # (B, Ws) int32 packed sketched N(u)
    s_masks: torch.Tensor,     # (k, Ws) int32 packed sketched S_i
    retired: torch.Tensor,     # (B,) bool — rows excluded from selection
    *,
    order: torch.Tensor | None = None,    # (k,) int32 → greedy-round mode
    enabled: torch.Tensor | None = None,  # (k,) bool slot gate (greedy mode)
    rows: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cost+select at sketched widths: the contract of
    ``parsa_cost_select`` (independent → (mins, argmins), greedy → (u_sel,
    c_sel) with (-1, BIG) for an inactive slot).

    ``rows = (widx, vals, trunc)`` is the block in the compact form the scan
    keeps: each row's nonzero words as (B, cap) int32 (word index, word)
    pairs padded with (0, 0), and a (B,) bool flag for the rows truncated
    past ``cap``, whose words are read from ``nbr_masks``.  Without it the
    wrapper builds the lists from ``nbr_masks`` on the device
    (``ref.compact_rows`` with ``ROW_CAP``; counted in ``ROWS_BUILT``).

    On CUDA it is ONE ``sketch_select`` launch, which reads the lists and
    keeps the (B, k) tile in shared memory.  A tile past
    ``sketch_select_fits`` routes, by shape and before any launch, to
    ``parsa_cost_select`` on the dense block (its launches are counted
    there), as the JAX wrapper routes past its VMEM budget; the results are
    the same bits.  A CPU tensor runs ``sketch_select_rows_ref`` when given
    the lists, else ``sketch_select_ref``.
    """
    dev = nbr_masks.device
    _check("nbr_masks", nbr_masks, torch.int32, 2, dev)
    _check("s_masks", s_masks, torch.int32, 2, dev)
    (B, W), k = nbr_masks.shape, s_masks.shape[0]
    if s_masks.shape[1] != W:
        raise ValueError(f"word widths differ: {W} vs {s_masks.shape[1]}")
    enabled = _check_select(B, k, retired, order, enabled, dev)
    greedy = order is not None
    if rows is not None:
        rows = _check_rows(rows, B, dev)
    if not _on_cuda(dev):
        if rows is None:
            u, c = sketch_select_ref(nbr_masks, s_masks, retired, order,
                                     enabled, greedy=greedy)
        else:
            u, c = sketch_select_rows_ref(nbr_masks, *rows, s_masks, retired,
                                          order, enabled, greedy=greedy)
        return (u[0], c[0]) if greedy else (c[0], u[0])
    if not sketch_select_fits(B, k):
        return parsa_cost_select(nbr_masks, s_masks, retired, order=order,
                                 enabled=enabled)
    if rows is None:
        rows = compact_rows(nbr_masks, ROW_CAP)
        ROWS_BUILT["sketch_select"] += 1
    widx, vals, trunc = rows
    out_a = torch.empty(k, dtype=torch.int32, device=dev)
    out_b = torch.empty(k, dtype=torch.int32, device=dev)
    _launch("sketch_select", _ptr(nbr_masks), _ptr(widx), _ptr(vals),
            _ptr(trunc), widx.shape[1], _ptr(s_masks), _ptr(retired),
            _ptr(order), _ptr(enabled if greedy else None), B, k, W,
            int(greedy), _ptr(out_a), _ptr(out_b))
    return out_a, out_b


def scan_smem_bytes(B: int, k: int) -> int:
    """Dynamic shared memory of one ``parsa_scan`` CTA, as
    ``csrc/parsa_scan.cu`` lays it out: the (k, B) int32 tile, the row →
    truncated-slot map (B int32), sizes, catch-up order, picks and costs
    (4 · k int32), the slots' candidates (k · min(k, 8) keys), the
    live-row count (4 int32), then the retired and taken flags (2 · B
    bytes) and the catch-up gates (k bytes), rounded up to 16."""
    t = min(k, SELECT_CANDIDATES)
    return -(-(4 * (k * B + B + 4 * k + k * t + 4) + 2 * B + k) // 16) * 16


def parsa_scan_fits(B: int, k: int) -> bool:
    """Whether blocks of B rows at k partitions scan in the one-launch
    ``parsa_scan`` kernel: its shared memory fits ``SCAN_MAX_SMEM_BYTES``
    and B and k the epilogue's ``SELECT_MAX_B`` and ``SELECT_MAX_K``.  A
    shape function only."""
    return (1 <= B <= SELECT_MAX_B and 1 <= k <= SELECT_MAX_K
            and scan_smem_bytes(B, k) <= SCAN_MAX_SMEM_BYTES)


def truncated_lists(tr_masks: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The truncated rows' full masks (..., TB, W) int32 as lists of their
    nonzero words, the form ``parsa_scan`` walks: (word indices, words),
    each (..., TB, W) int32 with a row's nonzero words first in column
    order (a stable sort), and their counts (..., TB) int32.  Tensor ops
    on the mask's device; built once a scan."""
    nz = tr_masks != 0
    lw = torch.argsort((~nz).to(torch.uint8), dim=-1, stable=True)
    return (lw.to(torch.int32), tr_masks.gather(-1, lw),
            nz.sum(-1, dtype=torch.int32))


def parsa_scan(
    widx: torch.Tensor,      # (nw, nb, B, cap) int32 compact word indices
    vals: torch.Tensor,      # (nw, nb, B, cap) int32 words at widx
    tr_ids: torch.Tensor,    # (nw, nb, TB) int32 truncated rows, B = none
    tr_masks: torch.Tensor,  # (nw, nb, TB, W) int32 their full masks
    valid: torch.Tensor,     # (nw, nb, B) bool, False for padding rows
    s_masks: torch.Tensor,   # (nw, k, W) int32 — updated in place
    sizes: torch.Tensor,     # (nw, k) int32 — updated in place
    parts: torch.Tensor,     # (nw, nb, B) int32 — written in place
    *,
    b0: int = 0,
    nblk: int | None = None,
    tr_lists: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> None:
    """The blocked greedy scan (JAX ``_partition_scan``'s rounds, kernel 2
    with kernel 4's round body): worker w scans its blocks ``[b0, b0 +
    nblk)`` in order against ``s_masks[w]`` and ``sizes[w]``, each block in
    1 + ⌈(B−1)/k⌉ greedy rounds, and writes each picked row's partition
    into ``parts[w, b]``.  ``nw`` is 1 for ``device_scan``; Algorithm 4's
    workers scan one super-step in one call.

    On CUDA it is ONE ``parsa_scan`` launch, a cluster of 8 CTAs per
    worker, which keeps the round's cost tile in shared memory and commits
    every round's picks on the card.  It walks a truncated row as the list
    of its nonzero words: ``tr_lists``, ``truncated_lists(tr_masks)``,
    which a caller that scans the same stack in several calls builds once
    and passes to each; without it the wrapper builds them before the
    launch (a few tensor ops).  The shape must pass
    ``parsa_scan_fits``: the scans route larger tiles, by shape and before
    any launch, to the per-round route (``core.partition._scan_per_round``,
    one ``parsa_cost_select`` a round); this wrapper raises for them.  A
    CPU tensor runs ``parsa_scan_ref``.
    """
    dev = s_masks.device
    _check("widx", widx, torch.int32, 4, dev)
    _check("vals", vals, torch.int32, 4, dev)
    _check("tr_ids", tr_ids, torch.int32, 3, dev)
    _check("tr_masks", tr_masks, torch.int32, 4, dev)
    _check("valid", valid, torch.bool, 3, dev)
    _check("s_masks", s_masks, torch.int32, 3, dev)
    _check("sizes", sizes, torch.int32, 2, dev)
    _check("parts", parts, torch.int32, 3, dev)
    nw, nb, B, cap = widx.shape
    k, W = s_masks.shape[1:]
    TB = tr_ids.shape[2]
    if (vals.shape != widx.shape or valid.shape != (nw, nb, B)
            or parts.shape != (nw, nb, B) or tr_ids.shape[:2] != (nw, nb)
            or tr_masks.shape != (nw, nb, TB, W) or s_masks.shape[0] != nw
            or sizes.shape != (nw, k) or cap < 1):
        raise ValueError(
            f"parsa_scan shapes disagree: widx {tuple(widx.shape)}, vals "
            f"{tuple(vals.shape)}, tr_ids {tuple(tr_ids.shape)}, tr_masks "
            f"{tuple(tr_masks.shape)}, valid {tuple(valid.shape)}, s_masks "
            f"{tuple(s_masks.shape)}, sizes {tuple(sizes.shape)}, parts "
            f"{tuple(parts.shape)}")
    if nblk is None:
        nblk = nb - b0
    if b0 < 0 or nblk < 0 or b0 + nblk > nb:
        raise ValueError(f"blocks [{b0}, {b0 + nblk}) outside [0, {nb})")
    if tr_lists is not None:
        for name, t, nd in zip(("tr_lw", "tr_lv", "tr_len"), tr_lists,
                               (4, 4, 3)):
            _check(name, t, torch.int32, nd, dev)
        if (tr_lists[0].shape != tr_masks.shape
                or tr_lists[1].shape != tr_masks.shape
                or tr_lists[2].shape != tr_ids.shape):
            raise ValueError(f"tr_lists must be shaped as tr_masks "
                             f"{tuple(tr_masks.shape)} and tr_ids "
                             f"{tuple(tr_ids.shape)}")
    if not _on_cuda(dev):
        parsa_scan_ref(widx, vals, tr_ids, tr_masks, valid, s_masks, sizes,
                       parts, b0, nblk)
        return
    if not parsa_scan_fits(B, k):
        raise ValueError(
            f"parsa_scan takes B={B}, k={k} only within its shared memory "
            f"({scan_smem_bytes(B, k)} > {SCAN_MAX_SMEM_BYTES} bytes) or "
            f"B <= {SELECT_MAX_B}, k <= {SELECT_MAX_K}: scan it per round")
    if nblk == 0 or nw == 0:
        return
    tr_lw, tr_lv, tr_len = (truncated_lists(tr_masks) if tr_lists is None
                            else tr_lists)
    _launch("parsa_scan", _ptr(widx), _ptr(vals), _ptr(tr_ids), _ptr(tr_lw),
            _ptr(tr_lv), _ptr(tr_len), _ptr(valid), cap, TB, _ptr(s_masks),
            _ptr(sizes), _ptr(parts), B, k, W, nb, b0, nblk, nw)


def refine_scan(
    words: torch.Tensor,  # (n_chunks, k, cw) int32 need words per chunk
    prev: torch.Tensor,   # (n_chunks, C) int32 entering assignments
    cost: torch.Tensor,   # (k,) int32 Alg 2 cost vector at entry
    sweeps: int = 1,
    *,
    out: torch.Tensor | None = None,  # (n_chunks, C) int32; may be prev
) -> tuple[torch.Tensor, torch.Tensor]:
    """All ``sweeps`` × chunks of Algorithm 2 → (cost' (k,), parts
    (n_chunks, C)), int32, C == 32·cw.  Sweep s + 1 enters with the parts
    sweep s wrote.  ``out`` receives the parts (it may be ``prev`` itself:
    the sweep then runs in place).  ONE ``refine_sweep`` launch on CUDA;
    a CPU tensor runs ``refine_scan_ref``."""
    dev = words.device
    _check("words", words, torch.int32, 3, dev)
    _check("prev", prev, torch.int32, 2, dev)
    _check("cost", cost, torch.int32, 1, dev)
    n, k, cw = words.shape
    if not 1 <= k <= REFINE_MAX_K or cw < 1 or sweeps < 1:
        raise ValueError(f"refine_sweep takes 1 <= k <= {REFINE_MAX_K}, "
                         f"cw >= 1 and sweeps >= 1, got k={k}, cw={cw}, "
                         f"sweeps={sweeps}")
    if prev.shape != (n, 32 * cw) or cost.shape[0] != k:
        raise ValueError(f"prev must have {32 * cw} entries a chunk "
                         f"({n} chunks) and cost {k}")
    if out is None:
        out = torch.empty_like(prev)
    else:
        _check("out", out, torch.int32, 2, dev)
        if out.shape != prev.shape:
            raise ValueError(f"out must have shape {tuple(prev.shape)}")
    if not _on_cuda(dev):
        cost_out, parts = refine_scan_ref(words, prev, cost, sweeps)
        out.copy_(parts)
        return cost_out, out
    cost_out = torch.empty(k, dtype=torch.int32, device=dev)
    if n:
        _launch("refine_sweep", _ptr(words), _ptr(prev), _ptr(cost), k, cw,
                n, sweeps, _ptr(out), _ptr(cost_out))
    else:
        cost_out.copy_(cost)
    return cost_out, out


def refine_sweep_chunk(
    tile_words: torch.Tensor,  # (k, cw) int32 packed need bits of one V chunk
    prev: torch.Tensor,        # (C,) int32 entering assignments, C == 32·cw
    cost: torch.Tensor,        # (k,) int32 Alg 2 cost vector
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Algorithm 2 chunk sweep → (cost' (k,), parts (C,)), int32:
    ``refine_scan`` over one chunk and one sweep (the same kernel)."""
    dev = tile_words.device
    _check("tile_words", tile_words, torch.int32, 2, dev)
    _check("prev", prev, torch.int32, 1, dev)
    k, cw = tile_words.shape
    if prev.shape[0] != 32 * cw:
        raise ValueError(f"prev must have {32 * cw} entries and cost {k}")
    cost_out, parts = refine_scan(tile_words[None], prev[None], cost, 1)
    return cost_out, parts[0]


def packed_union_delta(new: torch.Tensor, old: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg 4's wire ops on packed (k, W) int32 words: (union = new | old,
    delta = new & ~old), for any k and W (no padding)."""
    dev = new.device
    _check("new", new, torch.int32, 2, dev)
    _check("old", old, torch.int32, 2, dev)
    if new.shape != old.shape:
        raise ValueError(f"shapes differ: {tuple(new.shape)} vs "
                         f"{tuple(old.shape)}")
    if not _on_cuda(dev):
        return packed_union_delta_ref(new, old)
    union = torch.empty_like(new)
    delta = torch.empty_like(new)
    if new.numel():
        _launch("packed_union_delta", _ptr(new), _ptr(old), 1, new.numel(),
                _ptr(union), _ptr(delta), _ptr(None), _ptr(None),
                _ptr(None), _ptr(None), 0)
    return union, delta


def merge_worker_sets(s_local: torch.Tensor, s_global: torch.Tensor,
                      sz_local: torch.Tensor, sz_global: torch.Tensor,
                      pushed: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The server merge of ``n`` workers at the end of a super-step:
    ``s_local`` (n, k, W) and ``sz_local`` (n, k) int32, each worker's sets
    and sizes grown from the pre-merge ``s_global`` (k, W) and ``sz_global``
    (k,) int32, → (merged sets ``s_global | OR_w s_local[w]``, merged sizes
    ``sz_global + Σ_w (sz_local[w] − sz_global)`` in int32), both new
    tensors.  Writes them back into every worker's copy (``s_local[w]``,
    ``sz_local[w]``) in place, and adds the number of nonzero words of
    ``s_local[w] & ~s_global`` before the merge, summed over w (the
    delta-encoded push), into ``pushed``, a one-element int64 tensor on the
    same device.  ONE launch on CUDA; nothing reads back."""
    dev = s_global.device
    _check("s_local", s_local, torch.int32, 3, dev)
    _check("s_global", s_global, torch.int32, 2, dev)
    _check("sz_local", sz_local, torch.int32, 2, dev)
    _check("sz_global", sz_global, torch.int32, 1, dev)
    _check("pushed", pushed, torch.int64, 1, dev)
    n, k = s_local.shape[:2]
    if (s_local.shape[1:] != s_global.shape or pushed.shape != (1,)
            or sz_local.shape != (n, k) or sz_global.shape != (k,)):
        raise ValueError(f"s_local {tuple(s_local.shape)} must be (n, "
                         f"*{tuple(s_global.shape)}), sz_local "
                         f"{tuple(sz_local.shape)} (n, k), sz_global "
                         f"{tuple(sz_global.shape)} (k,) and pushed (1,), "
                         f"got {tuple(pushed.shape)}")
    if not _on_cuda(dev):
        merged, sizes, n_words = merge_worker_sets_ref(s_local, s_global,
                                                       sz_local, sz_global)
        pushed += n_words
        return merged, sizes
    merged = torch.empty_like(s_global)
    sizes = torch.empty_like(sz_global)
    if k:
        _launch("packed_union_delta", _ptr(s_local), _ptr(s_global), n,
                s_global.numel(), _ptr(merged), _ptr(None), _ptr(pushed),
                _ptr(sz_local), _ptr(sz_global), _ptr(sizes), k)
    return merged, sizes
