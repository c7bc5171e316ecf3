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
``fsdp()`` gives the layers the data axis's cut of the dense weights
(``launch.sharding.fsdp_gather``): a block of parameters gathered whole
over data at the top of the layer that reads it; None without a data
cut, and under ``ONE``.

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
           "TensorParallel", "ONE", "tensor_parallel", "Fsdp", "fsdp",
           "bind_rules",
           "constrain",
           "bf16_grad_barrier"]

_state = threading.local()


def current_rules():
    """(mesh, rules) of the innermost ``logical_axis_rules``, or None."""
    return getattr(_state, "rules", None)


def _saved() -> tuple:
    return tuple(getattr(_state, k, None) for k in ("rules", "tp", "fsdp"))


def _restore(saved: tuple) -> None:
    _state.rules, _state.tp, _state.fsdp = saved


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, object],
                       tp: "TensorParallel | None" = None,
                       fsdp: "Fsdp | None" = None):
    """rules: logical name -> mesh axis (str | tuple | None); ``tp`` the
    model axis the dense layers read under them (``tensor_parallel()``;
    None: every dense block whole); ``fsdp`` the data axis's cut of the
    dense weights (``fsdp()``; None: whole over data)."""
    prev = _saved()
    _restore(((mesh, dict(rules)), tp, fsdp))
    try:
        yield
    finally:
        _restore(prev)


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


class Fsdp:
    """The data axis's cut of the dense weights as the layers read it.
    ``plan``: parameter key (its path without list indices) -> (the dim
    cut over data, the place's block shape, the dtype the layers read
    it in), ``launch.sharding.fsdp_plan``; ``gather(w, dim, dtype)`` the
    whole weight from the place's block (``launch.mesh.gather_weight``);
    ``lookup(block, tokens, dtype)`` the embedding lookup from the
    place's block of a table cut along d_model (``launch.mesh.
    lookup_cut``).  Called on a block of parameters (a layer's dict, a
    recurrent block's, the model's) and the key of its root, it returns
    the same structure with every leaf the plan cuts gathered whole; a
    leaf that is not the place's block raises, as the experts'
    ``models.moe._check_blocks`` does: a whole tensor where a block is
    expected would be read wrong without a word."""

    def __init__(self, plan: dict, gather: Callable, lookup: Callable):
        self.plan, self._gather, self._lookup = dict(plan), gather, lookup

    def cuts(self, key: str) -> bool:
        return key in self.plan

    def _block(self, w, key: str) -> tuple:
        dim, block, dtype = self.plan[key]
        if tuple(w.shape) != block:
            raise ValueError(
                f"{key} is cut over the data axis: this place's block is "
                f"{block}, got {tuple(w.shape)}; cut the parameters with "
                f"launch.sharding.shard_params")
        return dim, dtype

    def leaf(self, w, key: str):
        """The whole (over data) weight of the place's block ``w`` at
        ``key``, in the dtype the layers read it in."""
        dim, dtype = self._block(w, key)
        return self._gather(w, dim, dtype)

    def lookup(self, block, tokens, key: str, dtype):
        """``table[tokens]`` in ``dtype`` from the place's block of the
        table at ``key``, cut along its last dim."""
        dim, _ = self._block(block, key)
        if dim != block.dim() - 1:
            raise ValueError(f"{key}: a lookup needs the table cut along "
                             f"d_model, its dim {dim} is cut")
        return self._lookup(block, tokens, dtype)

    def __call__(self, tree, prefix: str):
        def walk(t, key):
            if isinstance(t, dict):
                return {k: walk(v, f"{key}/{k}") for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v, key) for v in t)
            return self.leaf(t, key) if key in self.plan else t

        return walk(tree, prefix)


def fsdp() -> Fsdp | None:
    """The data axis's cut of the dense weights under the current rules
    (the layers' weights are then the place's blocks over data too), or
    None where nothing is cut over data."""
    return getattr(_state, "fsdp", None)


def bind_rules(fn: Callable) -> Callable:
    """``fn`` run under the rules, the ``TensorParallel`` and the ``Fsdp``
    current now, on whichever thread calls it.  Remat reruns a layer's
    forward inside the backward, on the autograd engine's own thread for
    a card's tensors, where the caller's thread-local rules are not set; a rerun
    without them would skip the layer's gathers and read its blocks as
    whole (the layer's FSDP gathers included, which remat reruns).
    ``fn`` itself where no rules are set."""
    saved = _saved()
    if saved == (None, None, None):
        return fn

    def run(*args, **kwargs):
        prev = _saved()
        _restore(saved)
        try:
            return fn(*args, **kwargs)
        finally:
            _restore(prev)

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
