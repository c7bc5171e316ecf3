"""The bf16 gradient barrier of ``repro/models/shardctx.py``.

The rest of the reference's module binds logical-axis sharding rules to a
device mesh; on one card there is no mesh, and ``constrain`` is the
identity (``ROADMAP.md`` Queue 1, the multi-pod pieces).
"""
from __future__ import annotations

import torch

__all__ = ["bf16_grad_barrier"]


class _BF16GradBarrier(torch.autograd.Function):
    """The identity in the forward pass; casts the cotangent to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def bf16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity that *retypes* the cotangent to bf16 (the loss head emits an
    f32 dx that otherwise stays f32 through every layer's backward).
    Applied only to bf16 activations that autograd records (fp32 smoke
    configs and the serving path pass through)."""
    if x.dtype == torch.bfloat16 and x.requires_grad \
            and torch.is_grad_enabled():
        return _BF16GradBarrier.apply(x)
    return x
