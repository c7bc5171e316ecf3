"""train_step / eval_step / prefill_step / serve_step factories: the units
the launchers run.

The port of ``repro/launch/steps.py`` without a mesh (one card) and
without the logical-axis rules context (it only binds sharding
constraints).  ``train_step`` updates the parameters and the optimizer
state in place and returns them (the reference donates them to a jitted
step that returns new ones).
"""
from __future__ import annotations

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

__all__ = ["make_train_step", "make_eval_step", "make_prefill_step",
           "make_serve_step"]


def _effective_microbatches(cfg, mesh, B: int) -> int:
    """Largest n <= cfg.microbatches with (B/n) still dividing the dp axes;
    without a mesh, ``cfg.microbatches`` (at most B) when it divides B,
    else 1."""
    if mesh is not None:
        raise NotImplementedError("the port runs without a mesh (one card)")
    n = max(1, cfg.microbatches)
    return min(n, B) if B % min(n, B) == 0 else 1


def _on(batch, device):
    """The batch's arrays as tensors on ``device`` (a staged batch's
    tensors are already there)."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, device="cuda",
                    opt_cfg: AdamWConfig | None = None):
    """(model, train_step, init_state, opt_cfg).

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients, accumulated over
    ``_effective_microbatches`` slices of the batch (activation memory ÷
    n, the same math: each backward adds into the float32 ``.grad``, which
    gives the reference's ``0 + g1 + g2 ...``), divided by n, optionally
    compressed (``cfg.grad_compress``), then one AdamW update.
    ``init_state(seed)`` gives float32 master parameters and a fresh
    optimizer state."""
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


def make_eval_step(cfg: ModelConfig, device="cuda"):
    model = build_model(cfg, device)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss_fn(params, _on(batch, model.device))
        return metrics

    return model, eval_step


def make_prefill_step(cfg: ModelConfig, device="cuda", *, flash: bool = True):
    """Inference prefill: forward + KV-cache population (no gradients).
    ``flash`` routes every layer's attention to the flash kernel (see
    ``Model.prefill``).  The batch's arrays (``tokens``, and the
    encoder-decoder's ``frames``) are moved to the model's device;
    ``cache_seq`` stays an int.  The recurrent families (xlstm, hybrid)
    run the parallel forward pass and return its loss (their batch
    carries ``labels``), as the reference does: their states are warmed
    by the serving loop."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def prefill_step(params, batch):
        arrays = _on({k: v for k, v in batch.items() if k != "cache_seq"},
                     model.device)
        if cfg.family in ("xlstm", "hybrid"):
            return model.loss_fn(params, arrays)[1]["loss"]
        return model.prefill(params, dict(batch, **arrays), flash=flash)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig, device="cuda"):
    model = build_model(cfg, device)

    @torch.no_grad()
    def serve_step(params, batch):
        logits, new_cache = model.decode_step(params, batch)
        # greedy sample (first index on ties, as jnp.argmax) — the serving
        # loop feeds it back
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return model, serve_step
