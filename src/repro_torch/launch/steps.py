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
``models.moe``, ``models.xlstm``, ``models.ssm``); whole over the data
axis (FSDP of the dense weights is not ported).  Every family runs on any
(data x model) mesh whose specs split evenly, ``context_parallel``
attention where the reference takes it; the recurrent families' prefill,
and every eval step, return the loss over the global batch.  A train step
over a mesh raises ``NotImplementedError`` naming its ROADMAP items.
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
    init_compression,
    init_opt_state,
)
from ..tree import tree_leaves, tree_map
from .mesh import axis_group, axis_sizes, gather_stack
from .sharding import activation_rules, batch_rows, mesh_rules

__all__ = ["make_train_step", "make_eval_step", "make_prefill_step",
           "make_serve_step"]

_ROADMAP = "ROADMAP.md Queue 1, the multi-card slices"


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


def _rows(x, mesh, rules):
    """The rank's rows of a global (B, ...) tensor."""
    return x[batch_rows(mesh, rules, x.shape[0])]


def _on(batch, device):
    """The batch's arrays as tensors on ``device`` (a staged batch's
    tensors are already there)."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


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
    optimizer state.  A mesh raises: a train step over a mesh is not
    ported."""
    if mesh is not None:
        raise NotImplementedError(
            f"a train step over a mesh (FSDP of the dense weights and the "
            f"gradient reduction) is not ported ({_ROADMAP}, items 3b and "
            f"3c)")
    model = build_model(cfg, device)
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=cfg.opt_dtype)

    def train_step(params, opt_state, batch):
        batch = _on(batch, model.device)
        B = batch["tokens"].shape[0]
        n = _effective_microbatches(cfg, None, B)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if n == 1:
            loss, metrics = model.loss_fn(params, batch)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            bs = B // n
            l_sum = torch.zeros((), dtype=torch.float32, device=model.device)
            tok = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(n):
                mb = {k: v[i * bs:(i + 1) * bs] for k, v in batch.items()}
                loss_i, m_i = model.loss_fn(params, mb)
                loss_i.backward()
                l_sum = l_sum + loss_i.detach()
                tok = tok + m_i["tokens"]
            n_t = torch.full((), float(n), device=model.device)
            for p in leaves:
                p.grad.div_(n_t)
            loss = l_sum / n_t
            metrics = {"loss": loss, "tokens": tok}
        for p in leaves:
            p.requires_grad_(False)
        grads = tree_map(lambda p: p.grad, params)
        for p in leaves:
            p.grad = None
        if cfg.grad_compress:
            grads, comp = compress_grads(grads, opt_state["comp"])
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg)
        del grads
        if cfg.grad_compress:
            opt_state["comp"] = comp
        metrics.update(om)
        return params, opt_state, metrics

    def init_state(seed: int = 0):
        params = model.init(seed, master=True)
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
