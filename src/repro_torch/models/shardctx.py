"""Logical-axis rules for model code, and the bf16 gradient barrier.

The port of ``repro/models/shardctx.py``.  ``logical_axis_rules(mesh,
rules)`` binds logical names ("batch", "tp", "fsdp", "expert", "vocab") to
mesh axes for the code under it, thread-locally, as in the reference;
``resolve`` and ``axis_size`` read them.  The MoE layer's sharded route
(``models.moe``) reads the rules to pick its branch and its groups;
``tensor_parallel()`` gives the dense layers (``models.layers``,
``models.model``, the shared experts of ``models.moe``) the model axis
as ``launch.sharding.tensor_parallel`` made it: its extent, the calling
place's coordinate on it, its gather and ordered sum, and how each dense
block is cut (the layout is decided there, once, from the same specs
that cut the parameters); ``ONE`` is a single place, every block whole.

``constrain(x, *axes)`` returns ``x`` unchanged, with or without rules: a
rank's tensor already is its shard, and there is no compiler to hint (the
reference binds ``with_sharding_constraint``).  A spec here is a tuple
with one entry a dim, a mesh-axis name, a tuple of names or None, equal
element by element to the reference's ``PartitionSpec``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

__all__ = ["current_rules", "logical_axis_rules", "resolve", "axis_size",
           "TensorParallel", "ONE", "tensor_parallel", "bind_rules",
           "constrain",
           "bf16_grad_barrier"]

_state = threading.local()


def current_rules():
    """(mesh, rules) of the innermost ``logical_axis_rules``, or None."""
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, object],
                       tp: "TensorParallel | None" = None):
    """rules: logical name -> mesh axis (str | tuple | None); ``tp`` the
    model axis the dense layers read under them (``tensor_parallel()``;
    None: every dense block whole)."""
    prev = getattr(_state, "rules", None), getattr(_state, "tp", None)
    _state.rules, _state.tp = (mesh, dict(rules)), tp
    try:
        yield
    finally:
        _state.rules, _state.tp = prev


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


class TensorParallel:
    """The model axis as the dense layers read it: its extent ``n``, the
    calling place's coordinate ``rank`` on it, ``gather(x, dim)`` (every
    place's ``x`` concatenated along ``dim`` in rank order), ``sum(x)``
    (their sum in rank order), ``enter(x)`` (the identity where a tensor
    whole on every place meets the place's block or slice; its backward
    sums the places' cotangents in rank order: ``launch.mesh.enter``),
    and ``layout``: role -> how the place's
    block of it is cut ("q", "kv", "o", "cache", "ssm_o": "heads", "hd"
    or None; "mlp", "shared", "embed", "head", MLA's "mla", "latent",
    "rope", the mLSTM's "mlstm", the sLSTM's "slstm", Mamba2's "ssm",
    "conv_x", "conv_bc": True where cut; a missing role is whole;
    ``launch.sharding.tp_layout`` says which leaves each role covers)."""

    def __init__(self, n: int, rank: int, layout: dict,
                 gather: Callable, sum: Callable,
                 enter: Callable = lambda x: x):
        self.n, self.rank, self.layout = n, rank, dict(layout)
        self.gather, self.sum, self.enter = gather, sum, enter

    def cut(self, size: int) -> slice:
        """This place's block of a dim of ``size`` cut ``n`` ways."""
        m = size // self.n
        return slice(self.rank * m, (self.rank + 1) * m)


ONE = TensorParallel(1, 0, {}, lambda x, dim: x, lambda x: x)


def tensor_parallel() -> TensorParallel | None:
    """The model axis under the current rules when it spans more than one
    place (the dense layers' weights are then the place's blocks,
    ``launch.sharding.shard_params``), else None."""
    return getattr(_state, "tp", None)


def bind_rules(fn: Callable) -> Callable:
    """``fn`` run under the rules and the ``TensorParallel`` current now,
    on whichever thread calls it.  Remat reruns a layer's forward inside
    the backward, on the autograd engine's own thread for a card's
    tensors, where the caller's thread-local rules are not set; a rerun
    without them would skip the layer's gathers and read its blocks as
    whole.  ``fn`` itself where no rules are set."""
    saved = getattr(_state, "rules", None), getattr(_state, "tp", None)
    if saved == (None, None):
        return fn

    def run(*args, **kwargs):
        prev = getattr(_state, "rules", None), getattr(_state, "tp", None)
        _state.rules, _state.tp = saved
        try:
            return fn(*args, **kwargs)
        finally:
            _state.rules, _state.tp = prev

    return run


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
