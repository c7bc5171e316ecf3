"""Production meshes over ``torch.distributed.device_mesh``.

A port of ``repro.launch.mesh``: the same shapes and axis names.

Single pod: (16, 16)  ("data", "model").
Multi-pod : (2, 16, 16) ("pod", "data", "model"); the ``pod`` axis is pure
data parallelism (the sharding rules place only the gradient all-reduce
there).

``REPRO_MESH`` (e.g. ``"2,2"``) overrides the shape for test-scale meshes,
its axes the last ``len(shape)`` of ``("pod", "data", "model")``.  A
``DeviceMesh`` spans the default process group, which the caller starts
(``torchrun`` and ``init_process_group``) with exactly as many ranks as the
mesh has places; the mesh lies on the card unless the caller passes
``device_type="cpu"``.  Functions, not module constants: importing this
module touches no process group.  The JAX module's ``HW`` figures (TPU
chips) are not carried over; ``launch.roofline`` holds the H100's.

What the MoE layer's sharded route needs of a mesh, in place of
``shard_map``'s ``axis_index``, ``all_gather`` and ``psum``: a rank's
coordinate along an axis (``DeviceMesh.get_local_rank``), the group of
one axis or of several together (``axis_group``), every member's tensor stacked in rank
order (``gather_stack``) and their sum in rank order (``ordered_sum``).
Dense tensor parallelism adds the all-gather along a dimension in rank
order (``gather_cat``): the query rows of context-parallel attention, a
head_dim cut back to whole heads, the vocab-sharded logits;
``launch.sharding.tensor_parallel`` hands it and ``ordered_sum`` over the
model axis to the dense layers (``models.layers``, ``models.model``).
Every cross-rank sum of the port is ``ordered_sum``, never an
all-reduce, so every rank, backend and run gives the same bits;
``GATHERED`` counts the bytes a rank receives.
``emulate_mesh`` runs every place of a mesh in one process, one thread a
place, their gathers meeting in memory: the reference the ranks are held
to bit for bit.

Gradients through the collectives (the train step over a mesh) follow
Megatron's convention.  A tensor that every place of an axis holds whole
(the same on each) has the whole gradient as its cotangent, the same on
each place.  So ``ordered_sum``'s backward is the identity (its output is
whole; its input a place's partial), ``gather_cat``'s and
``gather_stack``'s is the place's own slice of the cotangent (no
collective), and ``enter(x, group)``, the identity forward, marks every
spot where a whole ``x`` meets work that differs between the places (a
product with the place's block, a ``TensorParallel.cut`` slice, the
place's query rows): its backward is ``ordered_sum`` of the places'
partial cotangents over the group (float32 for bfloat16, rank order, the
same bits on every place).  The parameters are whole over the batch
axes and each place runs its own rows: their gradients are summed over
those axes after the backward (``launch.steps``), the same rule at the
step's scale.  Every rank runs the same graph, so every rank reaches the
backward's collectives in the same order (remat reruns a layer's forward
gathers in the backward, on every rank alike).  ``GATHERED`` counts the
forward's bytes and gathers ("bytes", "calls"), the backward's
("bwd_bytes", "bwd_calls") and the forward gathers that remat reruns
inside the backward ("remat_bytes", "remat_calls") apart.

One rule more covers a weight cut over the data axis (FSDP, ZeRO-3:
``launch.sharding.fsdp_plan``).  Gathered for use (``gather_weight``),
it meets each data place's own rows of the batch, so its cotangent on a
place is a partial, not the whole gradient.  The backward of that
gather is an ordered reduce-scatter: the places' cotangents are added in
rank order (in float32 for bfloat16) and the place keeps its own slice,
so the leaf's gradient is complete over data, and the batch-axes sum
after the backward skips the data axis for it (it still sums over
``pod``).  The embedding lookup of a table cut over data
(``lookup_cut``) moves the tokens' rows instead of the table, the same
rule: its backward sends each place the cotangents of its slice.
``GATHERED`` counts these bytes under their own keys ("fsdp_bytes",
"fsdp_calls"; the backward's "fsdp_bwd_bytes", "fsdp_bwd_calls"); the
forward gathers that remat reruns stay in "remat_bytes".
"""
from __future__ import annotations

import math
import os

import torch

__all__ = ["make_production_mesh", "make_host_mesh", "mesh_name", "dp_axes",
           "tp_axis", "dp_size", "mesh_shape", "axis_sizes", "axis_group",
           "gather_stack", "gather_cat", "ordered_sum", "enter",
           "gather_weight", "lookup_cut", "GATHERED",
           "reset_gathered", "PlaceMesh", "emulate_mesh"]

AXES = ("pod", "data", "model")

# bytes a rank received through ``gather_stack`` (every member's tensor,
# its own included) and the gathers that moved them, since the last
# ``reset_gathered``: the forward's, the backward's (``enter``) and the
# forward gathers that remat reruns in the backward apart, and the
# FSDP gathers of weights cut over data and their reduce-scatters apart;
# over a process group only (an emulated mesh's places share the module)
GATHERED = {"bytes": 0, "calls": 0, "bwd_bytes": 0, "bwd_calls": 0,
            "remat_bytes": 0, "remat_calls": 0, "fsdp_bytes": 0,
            "fsdp_calls": 0, "fsdp_bwd_bytes": 0, "fsdp_bwd_calls": 0}


def reset_gathered() -> None:
    for k in GATHERED:
        GATHERED[k] = 0


def _count(nbytes: int, backward: bool = False, fsdp: bool = False) -> None:
    """Count a gather of ``nbytes``: the backward's, a forward rerun by
    remat inside the backward (the autograd engine is running a graph
    task), or the forward's; an FSDP one (``fsdp``) under its own keys,
    but for remat's reruns."""
    if backward:
        pre = "fsdp_bwd_" if fsdp else "bwd_"
    elif torch._C._current_graph_task_id() != -1:
        pre = "remat_"
    else:
        pre = "fsdp_" if fsdp else ""
    GATHERED[pre + "bytes"] += nbytes
    GATHERED[pre + "calls"] += 1


def mesh_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh, ``REPRO_MESH`` first."""
    override = os.environ.get("REPRO_MESH")  # e.g. "2,2" — test-scale meshes
    if override:
        shape = tuple(int(x) for x in override.split(","))
        return shape, AXES[-len(shape):]
    if multi_pod:
        return (2, 16, 16), AXES
    return (16, 16), AXES[1:]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))


def make_host_mesh(device_type: str = "cuda"):
    """Degenerate 1-place mesh for smoke tests (a group of one rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def dp_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in dp_axes(mesh))


# ------------------------------------------------------------ axis groups
def axis_sizes(mesh) -> dict:
    """{axis name: extent} of a ``DeviceMesh``, or of a stand-in with the
    JAX mesh's ``shape`` mapping and ``axis_names`` (the spec functions
    of ``launch.sharding`` need no ranks)."""
    if hasattr(mesh, "mesh_dim_names"):
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_group(mesh, names):
    """The process group of the calling rank's ranks along the axes
    ``names`` (one name, or a tuple of names taken together, as JAX's
    ``psum(x, (tp, fsdp))``), its ranks in ascending order, which is the
    mesh's row-major order.  One axis is the mesh's own group
    (``DeviceMesh.get_group``); several are created at first use with
    ``new_subgroups_by_enumeration``, a collective every rank of the mesh
    reaches in the same order (every rank runs the same layers), and kept
    on the mesh."""
    if isinstance(mesh, PlaceMesh):
        return mesh.group(names)
    if isinstance(names, str):
        return mesh.get_group(names)
    names = tuple(names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    key = tuple(sorted(names))
    if key not in cache:
        import torch.distributed as dist

        dims = [mesh.mesh_dim_names.index(a) for a in key]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.size(d) for d in dims))
        cache[key], _ = dist.new_subgroups_by_enumeration(
            [sorted(r) for r in ranks.tolist()])
    return cache[key]


def _group_rank(group) -> int:
    return group.rank if isinstance(group, _PlaceGroup) else group.rank()


def _stack_raw(x, group, backward: bool = False, fsdp: bool = False):
    """Every rank's ``x`` of ``group`` stacked in rank order, outside
    autograd: the bytes (see ``gather_stack``)."""
    from ..core.partition import _gather_flat

    if isinstance(group, _PlaceGroup):
        return group.gather(x)
    n = group.size()
    x = x.detach().contiguous()
    if n == 1:
        return x[None]
    _count(n * x.numel() * x.element_size(), backward, fsdp)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _gather_flat(out.view(-1).view(torch.uint8), x.view(-1).view(torch.uint8),
                 group)
    return out


def _exchange_raw(parts, group, backward: bool = False):
    """The all-to-all of ``parts`` (n, ...), one slice a member: returns
    (n, ...) whose slice j is member j's ``parts[rank]``, outside
    autograd, the bits copied as bytes (``all_to_all_single``; a gloo
    group's card tensors go through host memory, as ``gather_stack``'s
    do).  A member receives n slices, where a gather of the whole
    ``parts`` would bring n times as many."""
    import torch.distributed as dist

    if isinstance(group, _PlaceGroup):
        return group.exchange(parts)
    parts = parts.detach().contiguous()
    n = group.size()
    if n == 1:
        return parts
    _count(parts.numel() * parts.element_size(), backward, fsdp=True)
    flat = parts.view(-1).view(torch.uint8)
    out = torch.empty_like(flat)
    if flat.device.type != "cpu" and dist.get_backend(group) == "gloo":
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.all_to_all_single(host, flat.cpu(), group=group)
        out.copy_(host)
    else:
        dist.all_to_all_single(out, flat, group=group)
    return out.view(parts.dtype).view(parts.shape)


def _widened(dtype: torch.dtype) -> torch.dtype:
    """float32 for a floating dtype of fewer than 32 bits, else ``dtype``:
    what a sum of such parts is accumulated in."""
    if dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return torch.float32
    return dtype


# bytes of the cotangent a piece of a weight's reduce-scatter moves at a
# time: its buffers are a few pieces beside the sum, not a few weights
_PIECE_BYTES = 1 << 26


def _reduce_scatter(g, group, dim: int):
    """The place's slice along ``dim`` of the sum of every member's ``g``
    (the members' partials of one whole weight of two or more dims),
    added in rank order in ``_widened(g.dtype)`` and not rounded back:
    one all-to-all a piece along another dim (``_PIECE_BYTES`` of ``g`` a
    piece), so that the send and receive buffers stay small beside the
    sum."""
    n = group.size()
    shape = list(g.shape)
    shape[dim] //= n
    out = torch.empty(shape, dtype=_widened(g.dtype), device=g.device)
    pdim = 1 if dim == 0 else 0
    rows = g.shape[pdim]
    step = max(1, _PIECE_BYTES * rows // (g.numel() * g.element_size()))
    for a in range(0, rows, step):
        size = min(step, rows - a)
        mine = _exchange_raw(torch.stack(g.narrow(pdim, a, size).chunk(
            n, dim=dim)), group, backward=True)
        acc = out.narrow(pdim, a, size)
        acc.copy_(mine[0])
        for i in range(1, n):
            acc.add_(mine[i])
    return out


def _add_in_order(parts):
    """The sum of ``parts`` (n, ...) over its first dim, one after another
    in order; a floating dtype of fewer than 32 bits accumulated in
    float32 and rounded once."""
    widen = parts.is_floating_point() and parts.element_size() < 4
    out = parts[0].float() if widen else parts[0].clone()
    for i in range(1, parts.shape[0]):
        out = out + parts[i]
    return out.to(parts.dtype) if widen else out


class _GatherStack(torch.autograd.Function):
    """``gather_stack`` where autograd records: its output is whole on
    every place, so its cotangent is the whole gradient, and the place's
    own slice of it is its input's (the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = _group_rank(group)
        return _stack_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class _Enter(torch.autograd.Function):
    """``enter``: the identity; the backward sums the places' cotangents
    over the group in rank order."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _add_in_order(_stack_raw(g, ctx.group, backward=True)), None


class _GatherWeight(torch.autograd.Function):
    """``gather_weight``: the forward casts the block and gathers the
    places' blocks along ``dim``; the backward (where autograd records)
    is the ordered reduce-scatter of the module docstring."""

    @staticmethod
    def forward(ctx, w, group, dim, dtype):
        ctx.group, ctx.dim, ctx.wdtype = group, dim, w.dtype
        parts = _stack_raw(w.to(dtype), group, fsdp=True)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.group, ctx.dim).to(ctx.wdtype), None,
                None, None)


def gather_weight(w, group, dim: int, dtype):
    """The whole weight from the place's block ``w`` of a weight cut along
    ``dim`` over ``group`` (the data axis, FSDP): ``w`` cast to ``dtype``
    (the dtype the layers read it in) and the places' blocks concatenated
    along ``dim`` in rank order.  The cast is inside: where autograd
    records ``w`` (a float32 master), the backward adds the places'
    ``dtype`` cotangents in float32 in rank order (one ``all_to_all``:
    each place receives the others' partials of its own slice only) and
    returns the sum in ``w``'s dtype, never rounded to ``dtype`` first;
    a large weight's in pieces (``_reduce_scatter``)."""
    return _GatherWeight.apply(w, group, dim, dtype)


class _LookupCut(torch.autograd.Function):
    """``lookup_cut``; the backward where autograd records the table's
    block."""

    @staticmethod
    def forward(ctx, block, tokens, group, dtype):
        every = _stack_raw(tokens, group, fsdp=True)
        rows = block[every.long()].to(dtype)     # (n, *tokens, D/n)
        mine = _exchange_raw(rows, group)
        ctx.save_for_backward(every)
        ctx.group, ctx.rows, ctx.bdtype = group, block.shape[0], block.dtype
        return torch.cat(mine.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        (every,) = ctx.saved_tensors
        n = ctx.group.size()
        theirs = _exchange_raw(torch.stack(g.chunk(n, dim=-1)), ctx.group,
                               backward=True)
        flat = every.reshape(-1).long()
        order = torch.argsort(flat, stable=True)
        lengths = torch.bincount(flat, minlength=ctx.rows)
        rows = theirs.reshape(flat.numel(), -1)[order].to(ctx.bdtype)
        return torch.segment_reduce(rows, "sum", lengths=lengths,
                                    axis=0), None, None, None


def lookup_cut(block, tokens, group, dtype):
    """``table[tokens]`` in ``dtype`` from the place's block (V, D/n) of a
    table cut along its last dim over ``group`` (the data axis, FSDP),
    ``tokens`` the place's own: the group's tokens are gathered, each
    place looks up its columns of every member's rows and sends each
    member its own (``all_to_all``), so no place holds the whole table.
    The same bits as the whole table's lookup.  Where autograd records
    the block, the backward sends each place the members' cotangents of
    its columns and sums them a table row at a time in a fixed order (a
    stable sort of the group's positions by token, then one ordered
    segment sum a row, in the block's dtype), as
    ``models.model._EmbeddingLookup`` does for a whole table: the
    block's gradient is then complete over the group."""
    return _LookupCut.apply(block, tokens, group, dtype)


def _records(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def gather_stack(x, group):
    """Every rank's ``x`` of ``group``, stacked in the group's rank order:
    (n, *x.shape), the bits copied as bytes (so a gloo group gathers any
    dtype, bfloat16 included; card tensors go through host memory there,
    as ``core.partition._gather_flat`` says).  Where autograd records
    ``x``, the backward hands ``x`` its own slice of the cotangent."""
    if group.size() == 1:
        return x.contiguous()[None]
    if _records(x):
        return _GatherStack.apply(x, group)
    return _stack_raw(x, group)


def gather_cat(x, group, dim: int):
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in the
    group's rank order: the all-gather of a tensor cut along ``dim``
    (``shape[dim]`` times the group's size).  Backward: the place's own
    slice of the cotangent."""
    parts = gather_stack(x, group)
    if parts.shape[0] == 1:
        return parts[0]
    return torch.cat(parts.unbind(0), dim=dim)


def ordered_sum(x, group):
    """The sum of every rank's ``x`` over ``group``, added one rank after
    another in rank order: the same bits on every rank, backend and run
    (an all-reduce sums in an order of its own).  A floating ``x`` of
    fewer than 32 bits is accumulated in float32 and rounded once, as
    XLA's CPU all-reduce does with bfloat16: bfloat16 adds part from
    JAX's ``psum`` in the last bit of many outputs
    (``tests/test_torch_dist_moe.py`` holds at most 1% of them an ulp
    off).  Backward: the identity (the output is whole on every place)."""
    return _add_in_order(gather_stack(x, group))


def enter(x, group):
    """``x``, whole and the same on every place of ``group``, where it
    meets work that differs between the places: the identity forward;
    the backward sums the places' cotangents in rank order
    (``ordered_sum``), so that ``x`` gets the whole gradient on every
    place.  Without autograd recording ``x``, or on a group of one place,
    ``x`` itself."""
    if not _records(x) or group.size() == 1:
        return x
    return _Enter.apply(x, group)


# ------------------------------------------------ a mesh in one process
class _Hub:
    """What the places of one emulated mesh share: a barrier and the
    gathered slots of each group."""

    def __init__(self, timeout_s: float):
        import threading

        self.lock = threading.Lock()
        self.timeout_s = timeout_s
        self.groups: dict = {}
        self.barriers: list = []

    def group(self, key, n: int):
        import threading

        with self.lock:
            if key not in self.groups:
                b = threading.Barrier(n, timeout=self.timeout_s)
                self.barriers.append(b)
                self.groups[key] = (b, [None] * n)
            return self.groups[key]

    def abort(self) -> None:
        with self.lock:
            for b in self.barriers:
                b.abort()


class _PlaceGroup:
    """One place's handle on a group of an emulated mesh: ``size()`` and
    ``gather(x)``, every member's ``x`` stacked in rank order."""

    def __init__(self, hub: _Hub, key, n: int, rank: int):
        self._barrier, self._slots = hub.group(key, n)
        self._n, self.rank = n, rank

    def size(self) -> int:
        return self._n

    def gather(self, x):
        """The stack of every member's ``x``, outside autograd (the
        members' tensors are detached: the places do not share a graph;
        ``gather_stack`` gives it its backward).  Contiguous, as over a
        process group: the layout of what a gather returns decides the
        order of later reductions, so both routes give the same bits."""
        x = x.detach().contiguous()
        if self._n == 1:
            return x[None]
        self._slots[self.rank] = x
        self._barrier.wait()
        out = torch.stack(self._slots)
        self._barrier.wait()    # every member has read the slots
        return out

    def exchange(self, parts):
        """The all-to-all of ``parts`` (n, ...): slice j of the result is
        member j's ``parts[rank]`` (``_exchange_raw``), contiguous."""
        parts = parts.detach().contiguous()
        if self._n == 1:
            return parts
        self._slots[self.rank] = parts
        self._barrier.wait()
        out = torch.stack([p[self.rank] for p in self._slots])
        self._barrier.wait()
        return out


class PlaceMesh:
    """One place of a mesh emulated in one process (``emulate_mesh``): the
    ``DeviceMesh`` calls the port makes (``mesh_dim_names``, ``ndim``,
    ``size``, ``get_local_rank``) and its groups (``axis_group``), whose
    gathers meet the other places' threads in memory."""

    def __init__(self, sizes: dict, coords: dict, hub: _Hub):
        self.mesh_dim_names = tuple(sizes)
        self.ndim = len(sizes)
        self._sizes, self._coords, self._hub = dict(sizes), coords, hub

    def size(self, dim: int | None = None) -> int:
        if dim is None:
            return math.prod(self._sizes.values())
        return self._sizes[self.mesh_dim_names[dim]]

    def get_local_rank(self, name: str) -> int:
        return self._coords[name]

    def group(self, names) -> _PlaceGroup:
        names = (names,) if isinstance(names, str) else tuple(names)
        rest = tuple((a, self._coords[a]) for a in self.mesh_dim_names
                     if a not in names)
        mine = [a for a in self.mesh_dim_names if a in names]
        n, rank = 1, 0
        for a in mine:      # row-major over the group's axes
            n, rank = n * self._sizes[a], rank * self._sizes[a] + \
                self._coords[a]
        return _PlaceGroup(self._hub, (tuple(sorted(names)), rest), n, rank)


def emulate_mesh(sizes: dict, fn, timeout_s: float = 900.0) -> list:
    """Run ``fn(place_mesh)`` for every place of a mesh of ``sizes`` ({axis
    name: extent}) in one process, one thread a place, the places'
    gathers meeting in memory; returns the results in row-major place
    order (a ``DeviceMesh``'s rank order).  A place that raises aborts the
    others' gathers, and the first error is raised.  The in-process
    reference of the ranks' sharded routes."""
    import itertools
    import threading

    hub = _Hub(timeout_s)
    names = tuple(sizes)
    places = [dict(zip(names, c)) for c in
              itertools.product(*(range(sizes[a]) for a in names))]
    results: list = [None] * len(places)
    errors: list = []

    def run(i, coords):
        try:
            results[i] = fn(PlaceMesh(sizes, coords, hub))
        except BaseException as e:     # noqa: BLE001 — re-raised below
            errors.append(e)
            hub.abort()

    threads = [threading.Thread(target=run, args=(i, c))
               for i, c in enumerate(places)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
