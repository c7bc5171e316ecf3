r"""DBPG: delayed block proximal gradient (the paper's solver, ref [19]).

Per iteration each worker computes the smooth gradient on its data block and
pushes it; servers apply the proximal update

    w ← prox_{ηλ‖·‖₁}(w − η·g)   (soft threshold)

Communication-reduction filters from [19], all implemented:
  * KKT filter   — a coordinate with w_j = 0 and |g_j| ≤ λ·(1−ε) already
    satisfies the ℓ1 KKT condition; its gradient entry need not be sent.
  * key caching  — key lists are sent once; steady-state messages carry
    values only (we meter bytes accordingly).
  * value compression — gradients quantized to int8 with a per-message
    scale and *error feedback* so quantization noise doesn't accumulate.

A port of ``repro.ml.dbpg``: elementwise float32 tensor ops on the
tensors' own device.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DBPGConfig", "soft_threshold", "kkt_filter", "quantize_int8",
           "dequantize_int8", "prox_step"]


@dataclasses.dataclass
class DBPGConfig:
    lam: float = 0.1
    lr: float = 0.1
    max_delay: int = 0          # τ: bounded-delay consistency
    kkt_eps: float = 0.1        # KKT filter slack ε
    compress: bool = True       # int8 value compression
    error_feedback: bool = True


def soft_threshold(w: torch.Tensor, t: float | torch.Tensor) -> torch.Tensor:
    return torch.sign(w) * torch.clamp_min(torch.abs(w) - t, 0.0)


def kkt_filter(w: torch.Tensor, g: torch.Tensor, lam: float,
               eps: float) -> torch.Tensor:
    """Bool mask of coordinates whose gradient MUST be communicated."""
    inactive = (w == 0.0) & (torch.abs(g) <= lam * (1.0 - eps))
    return ~inactive


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def prox_step(w: torch.Tensor, g: torch.Tensor,
              cfg: DBPGConfig) -> torch.Tensor:
    return soft_threshold(w - cfg.lr * g, cfg.lr * cfg.lam)
