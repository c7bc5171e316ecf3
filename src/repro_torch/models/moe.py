"""Mixture-of-experts layer: top-k routing, capacity-based dispatch and
shared experts, on one card or over a (data x model) mesh.

The port of ``repro/models/moe.py``: the float32 router, a stable sort of
the assignments by expert, a capacity buffer of ``capacity(cfg, T)`` rows
an expert, the expert MLPs as batched products, and the weighted combine
back to (T, D).  Two routes, as in the reference:

  * LOCAL (no rules, or a model axis of one place): the whole dispatch.
    Where the rules split the batch over several places, the rank gathers
    its peers' tokens over the batch axes in rank order, routes and
    dispatches the global batch as the reference does (capacity is the
    global batch's), and keeps its own rows.
  * SHARDED (``shardctx.logical_axis_rules`` active, a model axis larger
    than one): ``_routed_sharded``, the reference's ``_routed_shard_map``
    run by each rank on its own blocks.  The rank holds its batch rows and
    its expert blocks (``launch.sharding.shard_params``): E % tp == 0 is
    expert-parallel (the rank packs only the assignments of its E/tp
    experts), else hidden-sharded (every expert on the rank's FFN slice).
    With ``cfg.fsdp`` and a data axis the weights' other dim is sharded
    over data too, and the rank either all-gathers its weights (the weight
    path, ``launch.mesh.gather_weight``) or, where that moves fewer bytes
    (the reference's rule, decode), all-gathers the tokens of its data
    peers instead (the token path, never taken where autograd records:
    a train step gathers the weights, the same function).
    The partial (T, D) outputs are gathered over the model axis (the
    token path: model and data together) and added in rank order, in the
    compute dtype, where the reference has one ``psum``: every rank,
    backend and run gives the same bits.  Capacity is that of the tokens
    the rank's body holds, as in the reference, so drops differ from the
    local route's.  ``aux_loss`` and ``expert_counts`` are the global
    batch's: their sums are gathered over the batch axes first.
    ``_routed_sharded_plain`` runs every place of a mesh in one process
    (``launch.mesh.emulate_mesh``): the reference the ranks are held to on
    the card.
  * The backward over a mesh (``launch.mesh``'s convention): the sharded
    route ``enter``s the tokens and their gates, whole on every place of
    the model axis, before the place's experts; the experts' gather over
    data (FSDP) reduce-scatters their cotangents; the local route over a
    split batch takes its aux term's probabilities from the place's own
    rows, summed over the batch axes, so that every term's gradient runs
    through the place's rows (the parameters' gradients are summed over
    those axes after the backward).

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

from .layers import _dense_init, apply_mlp, silu_stepwise, sub_keep
from .shardctx import axis_size, current_rules

__all__ = ["init_moe", "capacity", "apply_moe"]


def init_moe(gen, cfg, dtype, device, keep=None):
    """Router (D, E), experts wg/wu (E, D, F) and wd (E, F, D), and the
    shared experts' MLP when ``cfg.num_shared_experts``.  The router stays
    float32 whatever ``dtype`` is: the reference casts it to float32 where
    it routes.  ``keep``: see ``layers.kept``."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(dtype=dtype, device=device, keep=keep)
    p = {
        "router": _dense_init(gen, (D, E), 0, torch.float32, device,
                              keep=keep, name="router"),
        "wg": _dense_init(gen, (E, D, Fd), 1, name="wg", **kw),
        "wu": _dense_init(gen, (E, D, Fd), 1, name="wu", **kw),
        "wd": _dense_init(gen, (E, Fd, D), 1, name="wd", **kw),
    }
    if cfg.num_shared_experts:
        Fs = cfg.d_ff * cfg.num_shared_experts
        kw["keep"] = sub_keep(keep, "shared")
        p["shared"] = {
            "wg": _dense_init(gen, (D, Fs), 0, name="wg", **kw),
            "wu": _dense_init(gen, (D, Fs), 0, name="wu", **kw),
            "wd": _dense_init(gen, (Fs, D), 0, name="wd", **kw),
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


class _Plan:
    """The reference's branch of ``_routed_shard_map`` for one rank's
    body: expert-parallel or hidden-sharded, ZeRO-sharded weights or not,
    the weight path or the token path."""

    def __init__(self, cfg, mesh, rules, T_loc: int, w_numel: int,
                 recording: bool = False):
        from ..launch.mesh import axis_sizes

        sizes = axis_sizes(mesh)
        self.tp_ax, self.fsdp_ax = rules.get("tp"), rules.get("fsdp")
        E = cfg.num_experts
        self.tp = sizes[self.tp_ax] if self.tp_ax else 1
        self.ep = E % self.tp == 0
        self.nd = sizes[self.fsdp_ax] if self.fsdp_ax else 1
        self.fsdp = (self.fsdp_ax is not None and cfg.fsdp
                     and cfg.d_model % self.nd == 0)
        self.token_path = False
        if self.fsdp and self.ep and not recording:
            nd = self.nd
            gather_bytes = w_numel * 2 * (nd - 1)
            token_bytes = 3 * T_loc * cfg.d_model * 2 * (nd - 1) * nd
            # decode: tokens are tiny — move tokens to the F-sliced weights
            # instead of re-gathering GBs of expert weights per step
            self.token_path = token_bytes < gather_bytes
        self.e_num = E // self.tp if self.ep else E

    @property
    def branch(self) -> str:
        return (("expert" if self.ep else "hidden") + "/"
                + ("token" if self.token_path else
                   "weight" if self.fsdp else "local-weights"))


def _gather_experts(ws, ep: bool, group, dtype) -> tuple:
    """The experts' (wg, wu, wd) whole over the data axis's ``group``
    from the place's blocks, in ``dtype``: expert-parallel blocks are cut
    along F (wg's and wu's dim 2, wd's dim 1), hidden-sharded ones along
    D (dim 1, and wd's dim 2).  The backward reduce-scatters
    (``launch.mesh.gather_weight``)."""
    from ..launch.mesh import gather_weight

    dims = (2, 2, 1) if ep else (1, 1, 2)
    return tuple(gather_weight(w, group, d, dtype) for w, d in zip(ws, dims))


def _check_blocks(p, cfg, plan):
    """The expert weights must be the rank's blocks (``shard_params``),
    never the full tensors: a full tensor here would compute the wrong
    experts without a word."""
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    tp, nd = plan.tp, plan.nd if plan.fsdp else 1
    if plan.ep:
        want = {"wg": (E // tp, D, Fd // nd), "wd": (E // tp, Fd // nd, D)}
    else:
        want = {"wg": (E, D // nd, Fd // tp), "wd": (E, Fd // tp, D // nd)}
    want["wu"] = want["wg"]
    for name, shape in want.items():
        if tuple(p[name].shape) != shape:
            raise ValueError(
                f"the sharded MoE route needs this rank's block of "
                f"{name}, {shape}, got {tuple(p[name].shape)}: cut the "
                f"parameters with launch.sharding.shard_params")


def _routed_sharded(p, x, top_w, top_e, cfg, dtype, info=None):
    """The reference's ``_routed_shard_map`` body on this rank (see the
    module docstring): x (B_loc, S, D), the rank's routing (T_loc, K),
    the rank's expert blocks in ``p``.  Returns (T_loc, D).  ``info``, a
    dict, receives the branch and the bytes this rank gathered."""
    from ..launch.mesh import axis_group, enter, gather_stack, ordered_sum

    mesh, rules = current_rules()
    B_loc, S, D = x.shape
    T_loc = B_loc * S
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, top_w, wg, wu, wd))
    plan = _Plan(cfg, mesh, rules, T_loc,
                 wg.numel() + wu.numel() + wd.numel(), recording)
    _check_blocks(p, cfg, plan)
    # the tokens and their gates, whole on every place of the model axis,
    # meet the place's experts: entered (their backward sums the places'
    # cotangents in rank order)
    tp_group = axis_group(mesh, plan.tp_ax)
    xt = enter(x.reshape(T_loc, D), tp_group)
    te2 = top_e.reshape(T_loc, -1)
    tw2 = enter(top_w.reshape(T_loc, -1), tp_group)
    gathered = 0
    if plan.fsdp:
        fgroup = axis_group(mesh, plan.fsdp_ax)
    if plan.fsdp and not plan.token_path:
        # ZeRO-3: re-materialize full weights in the compute dtype
        wg, wu, wd = _gather_experts((wg, wu, wd), plan.ep, fgroup, dtype)
        gathered += sum(w.numel() * w.element_size() for w in (wg, wu, wd))
    if plan.token_path:
        if recording:
            raise RuntimeError("the MoE token path has no backward over "
                               "data: a train step takes the weight path")
        tok = []
        for t in (xt, te2, tw2):
            stack = gather_stack(t, fgroup)
            gathered += stack.numel() * stack.element_size()
            tok.append(stack.reshape((-1,) + tuple(t.shape[1:])))
        xt, te2, tw2 = tok
    e_lo = mesh.get_local_rank(plan.tp_ax) * plan.e_num if plan.ep else 0
    out = _pack_compute_combine(xt, te2, tw2, wg, wu, wd, cfg, e_lo=e_lo,
                                e_num=plan.e_num, dtype=dtype)
    group = axis_group(mesh, (plan.tp_ax, plan.fsdp_ax) if plan.token_path
                       else plan.tp_ax)
    gathered += out.numel() * out.element_size() * group.size()
    out = ordered_sum(out, group)
    if plan.token_path:
        didx = mesh.get_local_rank(plan.fsdp_ax)
        out = out[didx * T_loc:(didx + 1) * T_loc]
    if info is not None:
        info["branch"] = plan.branch
        info["gathered_bytes"] = gathered
    return out


def _batch_sum(x, mesh, rules):
    """``x`` summed over the ranks that hold the other batch rows (the
    batch axes' group, in rank order); ``x`` itself without a split
    batch."""
    from ..launch.mesh import axis_group, ordered_sum

    ax = rules.get("batch")
    return x if ax is None else ordered_sum(x, axis_group(mesh, ax))


def _uses_sharded_route(rules_ctx) -> bool:
    if rules_ctx is None:
        return False
    from ..launch.mesh import axis_sizes

    mesh, rules = rules_ctx
    tp_ax = rules.get("tp")
    return bool(tp_ax) and axis_sizes(mesh)[tp_ax] > 1


def _split_batch(rules_ctx) -> bool:
    """Whether the rules cut the batch over more than one place."""
    if rules_ctx is None:
        return False
    from ..launch.mesh import axis_sizes

    mesh, rules = rules_ctx
    ax = rules.get("batch")
    if ax is None:
        return False
    sizes = axis_sizes(mesh)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return n > 1


def apply_moe(p, x, cfg, dtype=torch.bfloat16, return_aux=False, info=None):
    """x: (B, S, D) -> (B, S, D).  Router in float32 for stability.  With
    ``return_aux``: (out, {"aux_loss": the load-balancing term (float32),
    "expert_counts": (E,) int32 assignments an expert}).  Under rules with
    a model axis larger than one, x is the rank's batch rows, ``p`` holds
    the rank's expert blocks, and the sharded route runs; ``aux_loss``
    and ``expert_counts`` are then the global batch's.  ``info`` (a dict)
    receives the sharded route's branch and gathered bytes."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    xt = x.reshape(T, D)
    ctx = current_rules()
    global_batch = not _uses_sharded_route(ctx) and _split_batch(ctx)
    if global_batch:
        # the local route over a split batch: the global batch's tokens,
        # gathered over the batch axes in rank order, routed and
        # dispatched as the reference does; the rank keeps its rows
        from ..launch.mesh import axis_group, gather_cat
        from ..launch.sharding import batch_rows

        mesh, rules = ctx
        x_all = gather_cat(x, axis_group(mesh, rules["batch"]), dim=0)
        rows = batch_rows(mesh, rules, x_all.shape[0])
        xt_all = x_all.reshape(-1, D)
        probs, top_w, top_e = _route(p, xt_all, cfg)
        if rules.get("fsdp") and D % axis_size("fsdp") == 0:
            # the experts cut over data (hidden-sharded specs: a model
            # axis of one place), gathered whole
            ws = _gather_experts((p["wg"], p["wu"], p["wd"]), False,
                                 axis_group(mesh, rules["fsdp"]), dtype)
            p = dict(p, wg=ws[0], wu=ws[1], wd=ws[2])
        out = _routed_local(p, xt_all, top_e, top_w, cfg, dtype)
        out = out.view(x_all.shape[0], S, D)[rows].reshape(T, D)
    else:
        probs, top_w, top_e = _route(p, xt, cfg)
        if _uses_sharded_route(ctx):
            out = _routed_sharded(p, x, top_w, top_e, cfg, dtype, info=info)
        else:
            out = _routed_local(p, xt, top_e, top_w, cfg, dtype)
    if "shared" in p:
        # a dense MLP: the rank's column block under tensor parallelism,
        # its partial output summed over the model axis in rank order
        out = out + apply_mlp(p["shared"], xt.to(dtype), "swiglu", dtype,
                              role="shared")
    out = out.reshape(B, S, D).to(dtype)
    if return_aux:
        K = cfg.num_experts_per_tok
        counts = _expert_counts(top_e.reshape(-1), E, torch.int32)
        if global_batch:
            # the global batch's counts; the probabilities of the place's
            # rows, summed over the batch axes in rank order, so that the
            # aux term's gradient runs through the place's own rows (its
            # parameters' gradients are summed over those axes after the
            # backward, as every other term's)
            T_all = top_e.shape[0]
            own = probs.view(-1, S, E)[rows].reshape(T, E)
            me = counts.float() / (T_all * K)
            ce = _batch_sum(torch.sum(own, dim=0), *ctx) / T_all
        elif _split_batch(ctx):
            # GSPMD's means run over every token: the sums of the other
            # batch rows are gathered and added in rank order
            from ..launch.mesh import axis_sizes

            mesh, rules = ctx
            counts = _batch_sum(counts, mesh, rules)
            psum = _batch_sum(torch.sum(probs, dim=0), mesh, rules)
            sizes, ax = axis_sizes(mesh), rules["batch"]
            T_all = T
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                T_all *= sizes[a]
            me = counts.float() / (T_all * K)
            ce = psum / T_all
        else:   # the routed tokens' means (the global batch's, gathered)
            me = counts.float() / (probs.shape[0] * K)  # one_hot(top_e)'s
            ce = torch.mean(probs, dim=0)
        aux = E * torch.sum(me * ce)
        return out, {"aux_loss": aux, "expert_counts": counts}
    return out


def _routed_sharded_plain(p, x, cfg, mesh_shape, dtype=torch.bfloat16,
                          return_aux=False):
    """The in-process emulation of ``apply_moe`` over a mesh: every place
    of ``mesh_shape`` (a dict {axis name: extent}, row-major in its order)
    runs in one process (``launch.mesh.emulate_mesh``) on its batch rows
    of ``x`` (B, S, D) and its blocks of the full parameters ``p``, and
    adds the gathered partials in rank order, as the ranks do.  Returns
    the (B, S, D) output assembled from the places' rows (and the aux of
    place 0 with ``return_aux``).  The reference the ranks are held to on
    the card; nothing on the main path calls it."""
    from ..launch.mesh import emulate_mesh
    from ..launch.sharding import (
        activation_rules,
        batch_rows,
        mesh_rules,
        shard_params,
    )
    from .transformer import _gathered as gathered_layer

    B = x.shape[0]

    def place(mesh):
        rules = activation_rules(cfg, mesh, B)
        p_loc = shard_params(cfg, {"moe": p}, mesh)["moe"]
        rows = batch_rows(mesh, rules, B)
        with mesh_rules(cfg, mesh, B):
            # the router and the shared experts, gathered over data as
            # the layer gathers them (transformer.apply_layer)
            p_loc = gathered_layer(p_loc, "stack/moe")
            return rows, apply_moe(p_loc, x[rows], cfg, dtype=dtype,
                                   return_aux=return_aux)

    results = emulate_mesh(mesh_shape, place)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    for rows, res in results:
        out[rows] = res[0] if return_aux else res
    return (out, results[0][1][1]) if return_aux else out
