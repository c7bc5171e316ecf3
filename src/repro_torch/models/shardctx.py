"""Logical-axis rules for model code, and the bf16 gradient barrier.

The port of ``repro/models/shardctx.py``.  ``logical_axis_rules(mesh,
rules)`` binds logical names ("batch", "tp", "fsdp", "expert", "vocab") to
mesh axes for the code under it, thread-locally, as in the reference;
``resolve`` and ``axis_size`` read them.  The MoE layer's sharded route
(``models.moe``) reads the rules to pick its branch and its groups.

``constrain(x, *axes)`` returns ``x`` unchanged, with or without rules: a
rank's tensor already is its shard, and there is no compiler to hint (the
reference binds ``with_sharding_constraint``).  A spec here is a tuple
with one entry a dim, a mesh-axis name, a tuple of names or None, equal
element by element to the reference's ``PartitionSpec``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["current_rules", "logical_axis_rules", "resolve", "axis_size",
           "constrain", "bf16_grad_barrier"]

_state = threading.local()


def current_rules():
    """(mesh, rules) of the innermost ``logical_axis_rules``, or None."""
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, object]):
    """rules: logical name -> mesh axis (str | tuple | None)."""
    prev = getattr(_state, "rules", None)
    _state.rules = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.rules = prev


def resolve(logical_axes: tuple) -> tuple | None:
    """The spec of ``logical_axes`` under the current rules (None without
    rules)."""
    ctx = current_rules()
    if ctx is None:
        return None
    _, rules = ctx
    return tuple(None if ax is None else rules.get(ax)
                 for ax in logical_axes)


def axis_size(logical: str) -> int:
    """Mesh extent of a logical axis (1 when no context / unmapped)."""
    ctx = current_rules()
    if ctx is None:
        return 1
    mesh, rules = ctx
    ax = rules.get(logical)
    if ax is None:
        return 1
    from ..launch.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= sizes[a]
    return size


def constrain(x, *logical_axes):
    """The identity: a rank already holds its shard (see the module
    docstring)."""
    return x


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
