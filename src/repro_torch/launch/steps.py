"""train_step / eval_step / prefill_step / serve_step factories: the units
the launchers run.

The port of ``repro/launch/steps.py``.  ``train_step`` updates the
parameters and the optimizer state in place and returns them (the
reference donates them to a jitted step that returns new ones).

Over a mesh (``mesh=``, a ``DeviceMesh`` of the ranks; ``launch.mesh``)
the prefill, serve and eval steps run the model under the logical-axis
rules (``models.shardctx``) on the rank's rows of the batch, which is
split along the axes that ``activation_rules(...)["batch"]`` names.  The
rank passes the global ``tokens`` (or ``token``) and its own block of the
cache (``Model.init_cache`` under ``launch.sharding.mesh_rules``, or a
prefill's), and holds ``launch.sharding.shard_params``'s parameters: over
the model axis its blocks of the attention heads (or head_dim where the
heads do not divide it), MLA's heads, the MLP columns (``wg``, ``wu``,
``wi``, ``bi``) and rows (``wd``), the vocab rows of ``embed`` and
columns of ``lm_head``, the experts, the mLSTM value dim, the sLSTM
``wo`` rows and Mamba2's heads (``models.layers``, ``models.model``,
``models.moe``, ``models.xlstm``, ``models.ssm``); with ``cfg.fsdp`` and
a data axis, over data too (``launch.sharding.fsdp_plan``), each block
of parameters gathered whole over data where a layer reads it
(``models.shardctx.fsdp()``).  Every family runs on any
(data x model) mesh whose specs split evenly, ``context_parallel``
attention where the reference takes it; the recurrent families' prefill,
and every eval step, return the loss over the global batch.

The train step over a mesh runs the forward and the backward on the
rank's rows of each microbatch under the rules: the gradients go through
every collective (``launch.mesh``'s convention), each rank's gradient of
a leaf whole over data is its rows' share of its block's, and the step
sums them over the batch axes in rank order; a leaf cut over data
(FSDP) has its gradient complete over data from its gather's
reduce-scatter, and is summed over the other batch axes only (``pod``).
Then the step clips by the whole tree's norm and updates the rank's
blocks (``optim``).  ``init_state`` draws the rank's blocks a leaf at a
time (``Model.init(keep=)``), never the whole tree.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.model import build_model
from ..optim import (
    AdamWConfig,
    apply_updates,
    compress_grads,
    global_norm,
    init_compression,
    init_opt_state,
)
from ..tree import tree_leaves, tree_leaves_with_path, tree_map
from .mesh import axis_group, axis_sizes, gather_stack, ordered_sum
from .sharding import (
    activation_rules,
    batch_rows,
    keep_blocks,
    mesh_rules,
    replica_axes,
)

__all__ = ["make_train_step", "make_eval_step", "make_prefill_step",
           "make_serve_step"]


def _rules_ctx(cfg, mesh, batch_size):
    if mesh is None:
        return contextlib.nullcontext()
    return mesh_rules(cfg, mesh, batch_size)


def _effective_microbatches(cfg, mesh, B: int) -> int:
    """Largest n <= cfg.microbatches with (B/n) still dividing the dp axes;
    without a mesh, ``cfg.microbatches`` (at most B) when it divides B,
    else 1."""
    n = max(1, cfg.microbatches)
    if mesh is None:
        return min(n, B) if B % min(n, B) == 0 else 1
    sizes = axis_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    while n > 1 and (B % n or (B // n) % dp):
        n -= 1
    return max(n, 1)


def _axes(ax) -> tuple:
    """A rule's mesh axes as a tuple (None: none)."""
    return () if ax is None else ax if isinstance(ax, tuple) else (ax,)


def _rows(x, mesh, rules):
    """The rank's rows of a global (B, ...) tensor."""
    return x[batch_rows(mesh, rules, x.shape[0])]


def _on(batch, device):
    """The batch's arrays as tensors on ``device`` (a staged batch's
    tensors are already there)."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


class _MeshPlan:
    """What the train step over ``mesh`` reads of the parameter tree, by
    leaf in tree order: the group each leaf's block is cut over (None
    where the rank holds it whole) and the mesh axes it is replicated
    over, from ``replica_axes`` over the whole shapes; one group an axis
    tuple, made once (``axis_group``)."""

    def __init__(self, cfg, mesh):
        from ..models.model import Model

        shapes = Model(cfg, torch.device("meta")).init(master=True)
        names = tuple(axis_sizes(mesh))
        groups: dict = {}

        def group(axes):
            if axes not in groups:
                groups[axes] = axis_group(mesh, axes)
            return groups[axes]

        reps = replica_axes(cfg, shapes, mesh)
        self.cut, self.reps = [], []
        for path, _ in tree_leaves_with_path(shapes):
            rep = reps
            for k in path:
                rep = rep[k]
            axes = tuple(a for a in names if a not in rep)
            self.cut.append(group(axes) if axes else None)
            self.reps.append(rep)
        self.group = group
        self.fsdp = any("data" not in r for r in self.reps) and \
            axis_sizes(mesh).get("data", 1) > 1

    def batch_sums(self, batch_ax) -> list:
        """[(group, leaf indices)]: the leaves' gradients summed over the
        batch axes ``batch_ax`` (the rules' "batch") that each is
        replicated over, one group of axes at a time: every batch axis
        for a leaf whole over data, the others (``pod``) for one cut over
        data, whose gather's reduce-scatter summed it over data already;
        none where those axes are one place."""
        by: dict = {}
        for i, rep in enumerate(self.reps):
            over = tuple(a for a in _axes(batch_ax) if a in rep)
            if over:
                by.setdefault(over, []).append(i)
        out = []
        for over, idx in by.items():
            g = self.group(over)
            if g.size() > 1:
                out.append((g, idx))
        return out


def _sum_over(grads: list, group) -> None:
    """Each float32 gradient replaced, in place, by its sum over
    ``group`` in rank order: one ``ordered_sum`` of them all, flattened
    into one buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = ordered_sum(flat, group)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()


def make_train_step(cfg: ModelConfig, device="cuda",
                    opt_cfg: AdamWConfig | None = None, *, mesh=None):
    """(model, train_step, init_state, opt_cfg).

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients, accumulated over
    ``_effective_microbatches`` slices of the batch (activation memory ÷
    n, the same math: each backward adds into the float32 ``.grad``, which
    gives the reference's ``0 + g1 + g2 ...``), divided by n, optionally
    compressed (``cfg.grad_compress``), then one AdamW update.
    ``init_state(seed)`` gives float32 master parameters and a fresh
    optimizer state.

    With ``mesh`` (a ``DeviceMesh`` of the ranks, or an ``emulate_mesh``
    place): ``batch`` is the global batch and the parameters and the
    optimizer state are the rank's blocks (``init_state`` draws them a
    leaf at a time, each cut as ``launch.sharding.shard_params`` cuts
    it).  The microbatches are cut from the
    global batch first, in the reference's order (microbatch i is rows
    i·B/n .. (i+1)·B/n - 1), and the rank runs its rows of each under the
    rules; the gradients are summed over the batch axes in rank order,
    divided by n, compressed with the whole leaves' scales, clipped by
    the whole tree's norm (``optim.global_norm(grads, cut)``) and
    applied to the rank's blocks.  The loss, the label count and the
    norm are the global batch's, the same bits on every rank.  With
    ``cfg.fsdp`` the blocks are cut over data too (module docstring); a
    microbatch whose rows do not split over the data axis then raises
    ``ValueError``: its places would run the same rows, and the gathers'
    reduce-scatter would count each row's gradient once a place."""
    model = build_model(cfg, device)
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=cfg.opt_dtype)
    plan = None if mesh is None else _MeshPlan(cfg, mesh)

    def train_step(params, opt_state, batch):
        batch = _on(batch, model.device)
        B = batch["tokens"].shape[0]
        n = _effective_microbatches(cfg, mesh, B)
        bs = B // n
        rules = None if mesh is None else activation_rules(cfg, mesh, bs)
        if plan is not None and plan.fsdp and "data" not in _axes(
                rules["batch"]):
            raise ValueError(
                f"{cfg.name}: a microbatch of {bs} rows does not split "
                f"over the data axis, which cuts the weights (fsdp=True)")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        l_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        tok = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n):
            mb = batch if n == 1 else {k: v[i * bs:(i + 1) * bs]
                                       for k, v in batch.items()}
            if mesh is not None:
                mb = {k: _rows(v, mesh, rules) for k, v in mb.items()}
            with _rules_ctx(cfg, mesh, bs):
                loss_i, m_i = model.loss_fn(params, mb)
                loss_i.backward()
            if n == 1:
                metrics = {k: v.detach() for k, v in m_i.items()}
            else:
                l_sum = l_sum + loss_i.detach()
                tok = tok + m_i["tokens"]
        for p in leaves:
            p.requires_grad_(False)
        grads = tree_map(lambda p: p.grad, params)
        for p in leaves:
            p.grad = None
        if rules is not None and rules["batch"] is not None:
            flat = tree_leaves(grads)
            for group, idx in plan.batch_sums(rules["batch"]):
                _sum_over([flat[i] for i in idx], group)
        if n > 1:
            n_t = torch.full((), float(n), device=model.device)
            for g in tree_leaves(grads):
                g.div_(n_t)
            metrics = {"loss": l_sum / n_t, "tokens": tok}
        cut = None if plan is None else plan.cut
        if cfg.grad_compress:
            grads, comp = compress_grads(grads, opt_state["comp"], cut)
        gn = None if cut is None else global_norm(grads, cut)
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg, grad_norm=gn)
        del grads
        if cfg.grad_compress:
            opt_state["comp"] = comp
        metrics.update(om)
        return params, opt_state, metrics

    def init_state(seed: int = 0):
        params = model.init(seed, master=True, keep=None if mesh is None
                            else keep_blocks(cfg, mesh))
        opt = init_opt_state(params, opt_cfg)
        if cfg.grad_compress:
            opt["comp"] = init_compression(params)
        return params, opt

    return model, train_step, init_state, opt_cfg


def _loss_over_mesh(model, cfg, mesh, params, arrays):
    """``model.loss_fn``'s metrics on the place's rows of the global batch
    under the rules: the loss and the label count of the global batch,
    the same on every place (``Model.loss_fn``)."""
    B = arrays["tokens"].shape[0]
    rules = activation_rules(cfg, mesh, B)
    arrays = {k: _rows(v, mesh, rules) for k, v in arrays.items()}
    with _rules_ctx(cfg, mesh, B):
        return model.loss_fn(params, arrays)[1]


def make_eval_step(cfg: ModelConfig, device="cuda", *, mesh=None):
    """``eval_step(params, batch) -> {"loss", "tokens"}``: the loss and the
    label count of the batch (``Model.loss_fn``).  With ``mesh``: the
    batch is the global one, the parameters the rank's blocks
    (``launch.sharding.shard_params``); the rank runs its rows under the
    rules and returns the global batch's loss and count, the same on
    every rank."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def eval_step(params, batch):
        arrays = _on(batch, model.device)
        if mesh is None:
            return model.loss_fn(params, arrays)[1]
        return _loss_over_mesh(model, cfg, mesh, params, arrays)

    return model, eval_step


def make_prefill_step(cfg: ModelConfig, device="cuda", *, flash: bool = True,
                      mesh=None):
    """Inference prefill: forward + KV-cache population (no gradients).
    ``flash`` routes every layer's attention to the flash kernel (see
    ``Model.prefill``).  The batch's arrays (``tokens``, and the
    encoder-decoder's ``frames``) are moved to the model's device;
    ``cache_seq`` stays an int.  The recurrent families (xlstm, hybrid)
    run the parallel forward pass and return its loss (their batch
    carries ``labels``), as the reference does: their states are warmed
    by the serving loop.  With ``mesh``: the rank's rows of the global
    batch under the rules (module docstring); the logits and the cache
    returned are the rank's rows (the logits over the whole padded
    vocab, the cache the rank's block); the recurrent families' loss is
    the global batch's, the same on every rank."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def prefill_step(params, batch):
        arrays = _on({k: v for k, v in batch.items() if k != "cache_seq"},
                     model.device)
        if cfg.family in ("xlstm", "hybrid"):
            if mesh is None:
                return model.loss_fn(params, arrays)[1]["loss"]
            return _loss_over_mesh(model, cfg, mesh, params, arrays)["loss"]
        if mesh is None:
            return model.prefill(params, dict(batch, **arrays), flash=flash)
        B = arrays["tokens"].shape[0]
        rules = activation_rules(cfg, mesh, B)
        arrays = {k: _rows(v, mesh, rules) for k, v in arrays.items()}
        with _rules_ctx(cfg, mesh, B):
            return model.prefill(params, dict(batch, **arrays), flash=flash)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig, device="cuda", *, mesh=None):
    """One greedy decode step: ``serve_step(params, batch) -> (next_token
    (B,) int32, logits, cache)``.  With ``mesh``: ``batch["token"]`` is
    the global (B, 1), ``batch["cache"]`` the rank's block; the logits
    (over the whole padded vocab) and the cache returned are the rank's
    rows, and ``next_token`` is the global batch's, gathered over the
    batch axes in rank order, the same on every rank, ready to feed the
    next step."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def serve_step(params, batch):
        if mesh is None:
            logits, new_cache = model.decode_step(params, batch)
            # greedy sample (first index on ties, as jnp.argmax) — the
            # serving loop feeds it back
            next_token = torch.argmax(logits, dim=-1).to(torch.int32)
            return next_token, logits, new_cache
        token = torch.as_tensor(batch["token"], device=model.device)
        rules = activation_rules(cfg, mesh, token.shape[0])
        with _rules_ctx(cfg, mesh, token.shape[0]):
            logits, new_cache = model.decode_step(
                params, dict(batch, token=_rows(token, mesh, rules)))
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        if rules["batch"] is not None:
            next_token = gather_stack(
                next_token, axis_group(mesh, rules["batch"])).reshape(-1)
        return next_token, logits, new_cache

    return model, serve_step
