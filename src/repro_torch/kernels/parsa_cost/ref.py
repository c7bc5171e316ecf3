r"""Plain PyTorch versions of the parsa_cost / parsa_select / sketch_select /
parsa_scan / refine-sweep / union-delta kernels: the CPU path of every
wrapper in ``ops.py`` and the yardstick each CUDA kernel is held to, bit
for bit, on the card.

    cost[u, i] = |N(u) \ S_i| = Σ_w popcount(nbr[u, w] & ~s[i, w])

torch has no popcount, and ``>>`` on uint32 is not implemented on the CPU,
so ``popcount32`` counts bits SWAR-style on int64 after ``& 0xFFFFFFFF``:
a word with bit 31 set (a negative int32) counts the same as its unsigned
twin.  Ties always go to the lowest index (``argmin`` semantics); ``BIG`` is
the int32 sentinel of retired rows and empty slots.

Ports of ``repro.kernels.parsa_cost.ref``.  The greedy select is the plain
sequential k-slot loop (the JAX oracle's vectorized fast path with its
collision fallback computes the same thing).

On CPU tensors every function here runs under one intra-op thread
(``cpu_one_thread``): the scans and sweeps run a few small ops a round on
a tile of a few KiB, and such an op spends more time in its OpenMP
barrier than in its work.  With several such processes on one host (a
test run's workers) the barriers spin against each other's threads: a
serving loop that takes 0.4 s alone took 140 s in each of six processes
(``tests/measure_thread_collapse.py``).  The results are integers, the
same bits at any thread count.
"""
from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["BIG", "cpu_one_thread", "popcount32", "parsa_cost_ref",
           "select_from_cost",
           "select_greedy_from_cost", "parsa_select_ref",
           "parsa_select_greedy_ref", "sketch_select_ref",
           "sketch_select_rows_ref", "compact_rows", "rebuild_block",
           "parsa_scan_ref",
           "refine_sweep_ref", "refine_scan_ref", "packed_union_delta_ref",
           "merge_worker_sets_ref", "unpack_bits"]

BIG = 2**30  # sentinel cost for retired / padded vertices (fits int32)

_M32 = 0xFFFFFFFF


@contextlib.contextmanager
def cpu_one_thread(device):
    """Run the body under one intra-op thread when ``device`` is the CPU,
    restoring the caller's count on exit, an exception included.  Nested
    scopes and other devices change nothing.  ``torch.set_num_threads`` is
    process-wide: another thread of the process that runs tensor code
    meanwhile runs it on one thread too."""
    n = torch.get_num_threads()
    if torch.device(device).type != "cpu" or n == 1:
        yield
        return
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _one_thread(fn):
    """``fn`` under ``cpu_one_thread`` of its first argument's device."""
    @functools.wraps(fn)
    def wrapped(first, *args, **kwargs):
        with cpu_one_thread(first.device):
            return fn(first, *args, **kwargs)
    return wrapped


@_one_thread
def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (as unsigned), int32 result."""
    x = x.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


@_one_thread
def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(r, cw) int32 words → (r, 32·cw) int32 0/1 bits, little-endian."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = ((words.to(torch.int64) & _M32)[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1).to(torch.int32)


@_one_thread
def parsa_cost_ref(nbr_masks: torch.Tensor, s_masks: torch.Tensor) -> torch.Tensor:
    """nbr_masks (U, W) int32 bit-packs, s_masks (K, W) int32 → (U, K) int32."""
    masked = nbr_masks[:, None, :] & ~s_masks[None, :, :]
    return popcount32(masked).sum(dim=-1, dtype=torch.int32)


@_one_thread
def select_from_cost(cost: torch.Tensor, retired: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Independent per-column (min, argmin) of a (B, k) tile, retired→BIG.
    Ties resolve to the lowest row index."""
    masked = torch.where(retired[:, None], BIG, cost)
    return (masked.amin(dim=0).to(torch.int32),
            masked.argmin(dim=0).to(torch.int32))


@_one_thread
def select_greedy_from_cost(
    cost: torch.Tensor,           # (B, k) int32 — current cost tile
    retired: torch.Tensor,        # (B,) bool — already-assigned rows
    order: torch.Tensor | None,   # (k,) int32 column visit order; None = 0..k-1
    enabled: torch.Tensor,        # (k,) bool — whether slot j may pick this round
) -> tuple[torch.Tensor, torch.Tensor]:
    """One greedy round over a cost tile: progressive-retirement selection.

    Returns (u_sel, c_sel), both (k,) int32: slot j picked row u_sel[j] for
    partition order[j] at cost c_sel[j]; slot j sees the retirements of
    slots < j.  Inactive slots (disabled, or no unretired row left) return
    u_sel = -1, c_sel = BIG.
    """
    B, k = cost.shape
    cols = cost if order is None else cost[:, order.long()]
    iota_b = torch.arange(B, device=cost.device)
    ret = retired.clone()
    u_sel = torch.full((k,), -1, dtype=torch.int32, device=cost.device)
    c_sel = torch.full((k,), BIG, dtype=torch.int32, device=cost.device)
    for j in range(k):
        c = torch.where(ret, BIG, cols[:, j])
        m = c.amin()
        u = c.argmin()
        act = enabled[j] & (m < BIG)
        ret |= (iota_b == u) & act
        u_sel[j] = torch.where(act, u, -1)
        c_sel[j] = torch.where(act, m, BIG)
    return u_sel, c_sel


@_one_thread
def parsa_select_ref(nbr_masks, s_masks, retired):
    """Fused cost+select, independent mode → ((k,) mins, (k,) argmins)."""
    return select_from_cost(parsa_cost_ref(nbr_masks, s_masks), retired)


@_one_thread
def parsa_select_greedy_ref(nbr_masks, s_masks, retired, order, enabled):
    """Fused cost+select, greedy-round mode → ((k,) u_sel, (k,) c_sel)."""
    return select_greedy_from_cost(
        parsa_cost_ref(nbr_masks, s_masks), retired, order, enabled)


@_one_thread
def sketch_select_ref(nbr_masks, s_masks, retired, order=None, enabled=None,
                      *, greedy=False):
    """Fused cost+select at sketched widths, the plain version of the
    ``sketch_select`` kernel: the same integer program as
    ``parsa_select_ref`` / ``parsa_select_greedy_ref``, over fewer words.
    Returns ((1, k) u_sel or argmins, (1, k) c_sel or mins), the layout of
    the JAX ``sketch_select_ref``."""
    cost = parsa_cost_ref(nbr_masks, s_masks)
    if greedy:
        if enabled is None:
            enabled = torch.ones(cost.shape[1], dtype=torch.bool,
                                 device=cost.device)
        u, c = select_greedy_from_cost(cost, retired, order, enabled)
    else:
        c, u = select_from_cost(cost, retired)
    return u[None, :], c[None, :]


@_one_thread
def compact_rows(nbr_masks: torch.Tensor, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compact form of a (B, W) int32 block, as the scan packs it:
    (widx (B, cap) int32, vals (B, cap) int32, trunc (B,) bool).  Row u
    lists its first ``cap`` nonzero words in column order, padded with
    (0, 0); ``trunc[u]`` marks a row with more than ``cap`` nonzero words
    (only its first ``cap`` are listed).  A stable argsort puts each row's
    nonzero columns first, so on the card nothing waits for the host."""
    B, W = nbr_masks.shape
    nz = nbr_masks != 0
    c = min(cap, W)
    idx = torch.argsort((~nz).to(torch.uint8), dim=1, stable=True)[:, :c]
    vals = nbr_masks.gather(1, idx)
    keep = vals != 0
    widx = torch.where(keep, idx, 0).to(torch.int32)
    vals = torch.where(keep, vals, 0)
    if c < cap:
        widx = torch.nn.functional.pad(widx, (0, cap - c))
        vals = torch.nn.functional.pad(vals, (0, cap - c))
    return (widx.contiguous(), vals.contiguous(),
            nz.sum(dim=1) > cap)


@_one_thread
def sketch_select_rows_ref(nbr_masks, widx, vals, trunc, s_masks, retired,
                           order=None, enabled=None, *, greedy=False):
    """The plain version of the ``sketch_select`` kernel's list route: the
    cost of each row from its compact (word index, word) pairs,
    ``cost[u, i] = Σ_e popcount(vals[u, e] & ~s[i, widx[u, e]])`` (padding
    pairs (0, 0) count nothing), and from the dense ``nbr_masks`` row where
    ``trunc`` marks it; then the select of ``sketch_select_ref``, the same
    bits.  Returns ((1, k) u_sel or argmins, (1, k) c_sel or mins)."""
    gathered = s_masks[:, widx.long()]                  # (k, B, cap)
    cost = popcount32(vals[None] & ~gathered).sum(dim=-1, dtype=torch.int32).T
    rows = trunc.nonzero().flatten()
    if rows.numel():
        cost = cost.clone()
        cost[rows] = parsa_cost_ref(nbr_masks[rows], s_masks)
    if greedy:
        if enabled is None:
            enabled = torch.ones(cost.shape[1], dtype=torch.bool,
                                 device=cost.device)
        u, c = select_greedy_from_cost(cost, retired, order, enabled)
    else:
        c, u = select_from_cost(cost, retired)
    return u[None, :], c[None, :]


@_one_thread
def rebuild_block(widx: torch.Tensor, vals: torch.Tensor,
                  tr_ids: torch.Tensor, tr_masks: torch.Tensor) -> torch.Tensor:
    """Densify a block's bitmask from its compact word lists into a
    (B + 1, W) buffer whose last row is an all-zero sink.

    A scatter-add: padding slots add 0 into word 0, and a row's real words
    are distinct, so add equals OR.  Truncated rows are then overwritten
    with their full masks; padding entries (``tr_ids == B``) land in the
    sink, which is zeroed last.  The first B rows are a contiguous view.
    """
    B, cap = widx.shape
    W = tr_masks.shape[-1]
    nbr = torch.zeros((B + 1, W), dtype=torch.int32, device=widx.device)
    rows = torch.arange(B, device=widx.device, dtype=torch.int64)[:, None] * W
    nbr.view(-1).index_add_(0, (rows + widx).view(-1), vals.reshape(-1))
    nbr[tr_ids.long()] = tr_masks
    nbr[B] = 0
    return nbr


@_one_thread
def parsa_scan_ref(
    widx: torch.Tensor,      # (nw, nb, B, cap) int32 compact word indices
    vals: torch.Tensor,      # (nw, nb, B, cap) int32 words at widx
    tr_ids: torch.Tensor,    # (nw, nb, TB) int32 truncated rows, B = none
    tr_masks: torch.Tensor,  # (nw, nb, TB, W) int32 their full masks
    valid: torch.Tensor,     # (nw, nb, B) bool, False for padding rows
    s_masks: torch.Tensor,   # (nw, k, W) int32 — updated in place
    sizes: torch.Tensor,     # (nw, k) int32 — updated in place
    parts: torch.Tensor,     # (nw, nb, B) int32 — written in place
    b0: int = 0,
    nblk: int | None = None,
) -> None:
    """The plain version of the ``parsa_scan`` kernel: worker w scans its
    blocks ``[b0, b0 + nblk)`` in order against its own ``s_masks[w]``
    and ``sizes[w]``, each block in 1 + ⌈(B−1)/k⌉ greedy rounds (JAX
    ``_assign_block_rounds``): the catch-up round visits the partitions in
    the stable argsort of the sizes, only those at the minimum size
    enabled, slot j picking for partition ``order[j]``; then full rounds
    in index order.  A round is the dense cost tile and the sequential
    greedy select, and each active slot commits S |= N(u), sizes + 1,
    ``parts[w, b, u]`` and u's retirement.  Rows the scan never picks keep
    their value in ``parts``."""
    nw, nb, B = valid.shape
    k = s_masks.shape[1]
    dev = s_masks.device
    if nblk is None:
        nblk = nb - b0
    iota_k = torch.arange(k, dtype=torch.int32, device=dev)
    en_all = torch.ones(k, dtype=torch.bool, device=dev)
    for w in range(nw):
        s, sz = s_masks[w], sizes[w]
        for b in range(b0, b0 + nblk):
            if not bool(valid[w, b].any()):
                continue   # padding rows only: every round picks nothing
            nbr = rebuild_block(widx[w, b], vals[w, b], tr_ids[w, b],
                                tr_masks[w, b])[:B]
            retired = ~valid[w, b]
            for r in range(1 + -(-(B - 1) // k)):
                if r == 0:
                    order = torch.argsort(sz, stable=True).to(torch.int32)
                    enabled = sz[order.long()] == sz.min()
                else:
                    order, enabled = iota_k, en_all
                u, _ = select_greedy_from_cost(parsa_cost_ref(nbr, s),
                                               retired, order, enabled)
                act = u >= 0
                rows, to = u[act].long(), order[act].long()
                s[to] |= nbr[rows]     # the active slots' partitions differ
                sz[to] += 1
                parts[w, b, rows] = to.to(torch.int32)
                retired[rows] = True


@_one_thread
def refine_sweep_ref(
    tile_words: torch.Tensor,  # (k, cw) int32 — packed need bits of one V chunk
    prev: torch.Tensor,        # (C,) int32 — assignments entering the sweep (C = 32·cw)
    cost: torch.Tensor,        # (k,) int32 — Alg 2 cost vector at chunk entry
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Algorithm 2 greedy chunk, parameter by parameter.
    Returns (cost' (k,), parts (C,)), both int32.

    Assigning j → ξ adds −1 + (n_j − 1) at ξ; a re-assignment
    (``prev[j] ≥ 0``) first retracts −1 + (n_j − u_{cur,j}) at the old
    host.  Parameters nobody needs stay −1 and touch nothing.
    """
    tile = unpack_bits(tile_words)                     # (k, C)
    nneed = tile.sum(dim=0, dtype=torch.int32)
    C = tile.shape[1]
    c = cost.clone()
    parts = torch.empty(C, dtype=torch.int32, device=cost.device)
    # one-element index tensors throughout: no host sync inside the loop
    for j in range(C):
        col, nj, cur = tile[:, j], nneed[j:j + 1], prev[j:j + 1]
        cs = cur.clamp(min=0).long()
        c.index_add_(0, cs, torch.where(cur >= 0, 1 - nj + col[cs], 0)
                     .to(torch.int32))
        xi = torch.where(col > 0, c, BIG).argmin().view(1)
        act = nj > 0
        c.index_add_(0, torch.where(act, xi, 0),
                     torch.where(act, nj - 2, 0).to(torch.int32))
        parts[j:j + 1] = torch.where(act, xi, -1)
    return c, parts


@_one_thread
def refine_scan_ref(
    words: torch.Tensor,  # (n_chunks, k, cw) int32 need words per chunk
    prev: torch.Tensor,   # (n_chunks, C) int32 entering assignments
    cost: torch.Tensor,   # (k,) int32 Alg 2 cost vector at entry
    sweeps: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All ``sweeps`` × chunks of Algorithm 2 in order, each chunk a
    ``refine_sweep_ref``; sweep s + 1 enters with the parts sweep s wrote.
    Returns (cost' (k,), parts (n_chunks, C)), int32."""
    parts = prev.clone()
    for _ in range(sweeps):
        for c in range(words.shape[0]):
            cost, parts[c] = refine_sweep_ref(words[c], parts[c], cost)
    return cost, parts


@_one_thread
def packed_union_delta_ref(new: torch.Tensor, old: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg 4's wire ops on packed words: (union, delta) = (new | old,
    new & ~old), word-wise over any common shape."""
    return new | old, new & ~old


@_one_thread
def merge_worker_sets_ref(s_local: torch.Tensor, s_global: torch.Tensor,
                          sz_local: torch.Tensor, sz_global: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The server merge of ``n`` workers: ``s_local`` (n, k, W) and
    ``sz_local`` (n, k), each worker's sets and sizes grown from the
    pre-merge ``s_global`` (k, W) and ``sz_global`` (k,) → (merged (k, W) =
    s_global | OR_w s_local[w], merged sizes (k,) = sz_global + Σ_w
    (sz_local[w] − sz_global) in int32, pushed = Σ_w #nonzero words of
    s_local[w] & ~s_global, an int64 scalar tensor).  Writes the merged
    sets and sizes back into every worker's copy, in place."""
    merged = s_global.clone()
    for w in range(s_local.shape[0]):
        merged |= s_local[w]
    pushed = torch.count_nonzero(s_local & ~s_global).to(torch.int64)
    sizes = sz_global + (sz_local - sz_global).sum(dim=0, dtype=torch.int32)
    s_local.copy_(merged.expand_as(s_local))
    sz_local.copy_(sizes.expand_as(sz_local))
    return merged, sizes, pushed
