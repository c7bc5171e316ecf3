"""Mixture-of-experts layer: top-k routing, capacity-based dispatch and
shared experts.

The port of the local path of ``repro/models/moe.py`` (one device, no
mesh): the float32 router, a stable sort of the assignments by expert, a
capacity buffer of ``capacity(cfg, T)`` rows an expert, the expert MLPs as
batched products, and the weighted combine back to (T, D).  The
reference's expert-parallel ``_routed_shard_map`` needs a mesh and is not
ported (``ROADMAP.md`` Queue 1 item 7, the multi-card pieces).

Determinism.  The dispatch writes each kept assignment to its own buffer
row (dropped ones to a spare row that is sliced off), and the combine sums
each token's K slots in the order of the sorted assignments, as the
reference's ``segment_sum`` adds them: no float atomics, so two runs on the
card give the same bits.  The backward keeps that: the dispatch's gather
sums each token's K slot gradients in a fixed order (``_SlotGather``), so
two training runs give the same bits too.  The expert counts are an integer ``scatter_add_``
(exact).  On a CUDA tensor nothing here reads a value back to the host
(no ``bincount``, ``nonzero``, boolean-mask index or ``.item()``).
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import _dense_init, silu_stepwise

__all__ = ["init_moe", "capacity", "apply_moe"]


def init_moe(gen, cfg, dtype, device):
    """Router (D, E), experts wg/wu (E, D, F) and wd (E, F, D), and the
    shared experts' MLP when ``cfg.num_shared_experts``.  The router stays
    float32 whatever ``dtype`` is: the reference casts it to float32 where
    it routes."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": _dense_init(gen, (D, E), 0, torch.float32, device),
        "wg": _dense_init(gen, (E, D, Fd), 1, dtype, device),
        "wu": _dense_init(gen, (E, D, Fd), 1, dtype, device),
        "wd": _dense_init(gen, (E, Fd, D), 1, dtype, device),
    }
    if cfg.num_shared_experts:
        Fs = cfg.d_ff * cfg.num_shared_experts
        p["shared"] = {
            "wg": _dense_init(gen, (D, Fs), 0, dtype, device),
            "wu": _dense_init(gen, (D, Fs), 0, dtype, device),
            "wd": _dense_init(gen, (Fs, D), 0, dtype, device),
        }
    return p


def capacity(cfg, tokens: int) -> int:
    c = int(np.ceil(tokens * cfg.num_experts_per_tok / cfg.num_experts
                    * cfg.moe_capacity_factor))
    return max(8, int(np.ceil(c / 8) * 8))


def _expert_counts(flat_e, E: int, dtype=torch.int64):
    """Assignments an expert, counted exactly on the device (a
    ``bincount`` on the card reads its input's max back to size its
    output)."""
    return torch.zeros(E, dtype=dtype, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones(flat_e.shape, dtype=dtype,
                              device=flat_e.device))


class _SlotGather(torch.autograd.Function):
    """``xt[st]``, the dispatch's gather of each assignment's token row,
    whose backward sums each token's K slot gradients in a fixed order: a
    stable sort of the slots by token, then one ordered segment sum a
    token (``torch.segment_reduce``), as ``model._EmbeddingLookup`` does.
    The default backward of an index accumulates with ``index_put_``, in
    an order the library chooses on the card.  ``st`` holds every token
    exactly K times (a permutation of ``arange(T).repeat_interleave(K)``),
    so every segment is K long and nothing is read back to the host."""

    @staticmethod
    def forward(ctx, xt, st, K: int):
        ctx.save_for_backward(st)
        ctx.K = K
        return xt[st]

    @staticmethod
    def backward(ctx, g):
        (st,) = ctx.saved_tensors
        T = st.numel() // ctx.K
        order = torch.argsort(st, stable=True)
        lengths = torch.full((T,), ctx.K, dtype=torch.int64, device=g.device)
        return torch.segment_reduce(g[order], "sum", lengths=lengths,
                                    axis=0), None, None


def _gather_slots(xt, st, K: int):
    if torch.is_grad_enabled() and xt.requires_grad:
        return _SlotGather.apply(xt, st, K)
    return xt[st]


def _route(p, xt, cfg):
    """float32 router -> (probs (T, E), weights (T, K), ids (T, K)), the
    weights renormalised.  ``jax.lax.top_k`` puts the lower expert first
    among equal probabilities; so does the head of a stable descending
    sort (``torch.topk`` promises no order for ties)."""
    K = cfg.num_experts_per_tok
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    return probs, top_w, top_e


def _pack_compute_combine(xt, top_e, top_w, wg, wu, wd, cfg, *, e_lo, e_num,
                          dtype):
    """Sort-pack the assignments of experts [e_lo, e_lo+e_num) into a
    capacity buffer, run the expert MLPs, combine back to (T, D)."""
    T, D = xt.shape
    K = cfg.num_experts_per_tok
    C = capacity(cfg, T)
    idx = torch.arange(T * K, device=xt.device)
    flat_e = top_e.reshape(-1)
    flat_t = idx // K                  # jnp.repeat(arange(T), K)
    flat_w = top_w.reshape(-1).to(dtype)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    group_sizes = _expert_counts(flat_e, cfg.num_experts)
    group_start = torch.cumsum(group_sizes, 0) - group_sizes
    pos = idx - group_start[se]
    mine = (se >= e_lo) & (se < e_lo + e_num) & (pos < C)
    spare = e_num * C                  # dropped assignments land here
    dest = torch.where(mine, (se - e_lo) * C + pos, spare)

    # The backward of every index op here sums in a fixed order: the
    # gather of the token rows through _SlotGather; ``flat_w[order]`` and
    # ``picked[by_token[:, k]]`` repeat no index; the buffer write's
    # backward is a gather; ``y[dest.clamp(...)]`` repeats an index only
    # for dropped slots, whose gradient ``torch.where`` makes 0.
    rows = _gather_slots(xt, st, K).to(dtype)
    buf = rows.new_zeros((spare + 1, D)).index_put((dest,), rows)
    buf = buf[:spare].view(e_num, C, D)
    g = torch.bmm(buf, wg.to(dtype))
    u = torch.bmm(buf, wu.to(dtype))
    h = silu_stepwise(g) * u
    del g, u
    y = torch.bmm(h, wd.to(dtype)).view(spare, D)
    picked = torch.where(mine[:, None], y[dest.clamp(max=spare - 1)], 0.0)
    picked = picked * sw[:, None]
    # segment_sum over st: each token's slots added in sorted order
    rank = torch.empty_like(order).scatter_(0, order, idx)
    by_token = torch.sort(rank.view(T, K), dim=1).values
    out = picked[by_token[:, 0]]
    for k in range(1, K):
        out = out + picked[by_token[:, k]]
    return out


def _routed_local(p, xt, top_e, top_w, cfg, dtype):
    return _pack_compute_combine(xt, top_e, top_w, p["wg"], p["wu"], p["wd"],
                                 cfg, e_lo=0, e_num=cfg.num_experts,
                                 dtype=dtype)


def apply_moe(p, x, cfg, dtype=torch.bfloat16, return_aux=False):
    """x: (B, S, D) -> (B, S, D).  Router in float32 for stability.  With
    ``return_aux``: (out, {"aux_loss": the load-balancing term (float32),
    "expert_counts": (E,) int32 assignments an expert})."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    xt = x.reshape(T, D)
    probs, top_w, top_e = _route(p, xt, cfg)
    out = _routed_local(p, xt, top_e, top_w, cfg, dtype)
    if "shared" in p:
        sh = p["shared"]
        xs = xt.to(dtype)
        g = xs @ sh["wg"].to(dtype)
        u = xs @ sh["wu"].to(dtype)
        out = out + (silu_stepwise(g) * u) @ sh["wd"].to(dtype)
    out = out.reshape(B, S, D).to(dtype)
    if return_aux:
        K = cfg.num_experts_per_tok
        counts = _expert_counts(top_e.reshape(-1), E, torch.int32)
        me = counts.float() / (T * K)   # mean of one_hot(top_e) over (T, K)
        ce = torch.mean(probs, dim=0)
        aux = E * torch.sum(me * ce)
        return out, {"aux_loss": aux, "expert_counts": counts}
    return out
