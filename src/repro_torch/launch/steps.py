"""train_step / eval_step / prefill_step / serve_step factories: the units
the launchers run.

The port of ``repro/launch/steps.py``.  ``train_step`` updates the
parameters and the optimizer state in place and returns them (the
reference donates them to a jitted step that returns new ones).

Over a mesh (``mesh=``, a ``DeviceMesh`` of the ranks; ``launch.mesh``)
the prefill and serve steps run the model under the logical-axis rules
(``models.shardctx``) on the rank's rows of the batch, which is split
along the axes that ``activation_rules(...)["batch"]`` names.  The rank
passes the global ``tokens`` (or ``token``) and its own rows of the cache
and holds ``launch.sharding.shard_params``'s parameters: the dense weights
whole, the expert weights its blocks, which the MoE layer's sharded route
reads (``models.moe``).  The MoE family runs on any (data x model) mesh;
another family only with a model axis of one place (its rows are
independent), the recurrent families not at all.  What the port does not
run across ranks raises ``NotImplementedError`` naming its ROADMAP item:
dense tensor parallelism, ``context_parallel`` attention, a train or eval
step over a mesh.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.model import build_model
from ..models.shardctx import logical_axis_rules
from ..optim import (
    AdamWConfig,
    apply_updates,
    compress_grads,
    init_compression,
    init_opt_state,
)
from ..tree import tree_leaves, tree_map
from .mesh import axis_group, axis_sizes, gather_stack
from .sharding import activation_rules, batch_rows

__all__ = ["make_train_step", "make_eval_step", "make_prefill_step",
           "make_serve_step"]

_ROADMAP = "ROADMAP.md Queue 1, the multi-card slices"


def _rules_ctx(cfg, mesh, batch_size):
    if mesh is None:
        return contextlib.nullcontext()
    return logical_axis_rules(mesh, activation_rules(cfg, mesh, batch_size))


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


def _check_mesh(cfg, mesh, seq: int | None = None) -> None:
    """Raise ``NotImplementedError`` where the port would run something
    across ranks that it does not compute as the reference does."""
    tp = axis_sizes(mesh).get("model", 1)
    if cfg.family in ("xlstm", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family} family over a mesh (its prefill is a loss "
            f"over the global batch; {_ROADMAP})")
    if tp > 1 and cfg.family != "moe":
        raise NotImplementedError(
            f"dense tensor parallelism (the {cfg.family} family on a model "
            f"axis of {tp}) is not ported ({_ROADMAP})")
    if (tp > 1 and seq is not None and not cfg.mla
            and cfg.num_heads % tp != 0 and seq % tp == 0
            and cfg.attn_impl == "chunked"):
        raise NotImplementedError(
            f"context_parallel attention ({cfg.num_heads} heads on a model "
            f"axis of {tp}) is not ported ({_ROADMAP})")


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
            f"gradient reduction) is not ported ({_ROADMAP})")
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


def make_eval_step(cfg: ModelConfig, device="cuda", *, mesh=None):
    if mesh is not None:
        raise NotImplementedError(
            f"an eval step over a mesh (a loss over the global batch) is "
            f"not ported ({_ROADMAP})")
    model = build_model(cfg, device)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss_fn(params, _on(batch, model.device))
        return metrics

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
    returned are the rank's rows."""
    model = build_model(cfg, device)
    if mesh is not None:
        _check_mesh(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        arrays = _on({k: v for k, v in batch.items() if k != "cache_seq"},
                     model.device)
        if mesh is None:
            if cfg.family in ("xlstm", "hybrid"):
                return model.loss_fn(params, arrays)[1]["loss"]
            return model.prefill(params, dict(batch, **arrays), flash=flash)
        B, S = arrays["tokens"].shape
        _check_mesh(cfg, mesh, S)
        rules = activation_rules(cfg, mesh, B)
        arrays = {k: _rows(v, mesh, rules) for k, v in arrays.items()}
        with _rules_ctx(cfg, mesh, B):
            return model.prefill(params, dict(batch, **arrays), flash=flash)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig, device="cuda", *, mesh=None):
    """One greedy decode step: ``serve_step(params, batch) -> (next_token
    (B,) int32, logits, cache)``.  With ``mesh``: ``batch["token"]`` is
    the global (B, 1), ``batch["cache"]`` the rank's rows; the logits and
    the cache returned are the rank's rows, and ``next_token`` is the
    global batch's, gathered over the batch axes in rank order, the same
    on every rank, ready to feed the next step."""
    model = build_model(cfg, device)
    if mesh is not None:
        _check_mesh(cfg, mesh)

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
