"""prefill_step / serve_step factories: the units the serving loop runs.

The port of ``make_prefill_step`` and ``make_serve_step`` of
``repro/launch/steps.py``, without a mesh (one card) and without the
logical-axis rules context (it only binds sharding constraints).  The
training and eval steps come with training.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models.model import build_model

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig, device="cuda", *, flash: bool = True):
    """Inference prefill: forward + KV-cache population (no gradients).
    ``flash`` routes every layer's attention to the flash kernel (see
    ``Model.prefill``)."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, flash=flash)

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
