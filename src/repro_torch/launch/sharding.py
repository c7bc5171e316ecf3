"""Sharding rules: logical placement for every param / batch / cache leaf.

The port of ``repro/launch/sharding.py``.  Axis roles
  model ("tp")        — tensor parallel: attention heads, FFN hidden, expert
                        dim (EP) or vocab rows; chosen per-leaf with
                        divisibility guards (GQA kv=8 < tp=16 ⇒ replicate
                        heads, shard head_dim instead where legal).
  data  ("fsdp"/dp)   — batch, plus ZeRO-3 weight sharding when cfg.fsdp.
  pod   (dp only)     — pure data parallelism across pods: batch and
                        gradient all-reduce, never weight storage.

A spec is a tuple with one entry a dim (a mesh-axis name, a tuple of
names, or None), equal element by element to the reference's
``PartitionSpec``.  The port's parameter trees hold a list of per-layer
dicts where the reference stacks the layers: the reference's leading scan
dims (``_leading_scan_dims``) are the list levels here, so a parameter's
spec covers its per-layer dims only.  Caches keep the reference's stacked
layout and their specs are the reference's.  ``mesh`` is a
``DeviceMesh``, or any stand-in with the mesh's ``shape`` mapping and
``axis_names``: the production shapes (16, 16) and (2, 16, 16) need no
ranks here.

In place of the reference's ``to_named``, ``shard_tree`` cuts full
tensors to the blocks the calling rank holds, by its mesh coordinates;
``shard_params`` is the placement every step over a mesh takes
(``launch.steps``): every leaf cut as its ``param_pspecs`` spec cuts it,
over the model axis (attention heads or head_dim, MLP columns and rows,
the vocab rows of ``embed`` and columns of ``lm_head``, biases, MLA's
heads, the mLSTM's value dim, the sLSTM's ``wo`` rows and Mamba2's
heads) and, with ``cfg.fsdp`` and a data axis, over data (ZeRO-3: the
embedding's and the head's d_model, the projections' input or output
dim, MLA's ranks, the router, the experts).  ``fsdp_plan`` says, for
each dense leaf, the dim cut over data; under ``mesh_rules`` the layers
gather such a leaf a block of parameters at a time
(``shardctx.fsdp()``, ``launch.mesh.gather_weight``), and the MoE layer
its experts itself.
"""
from __future__ import annotations

import functools
import math
import re
import types
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models.shardctx import Fsdp, TensorParallel, logical_axis_rules
from ..tree import tree_leaves_with_path, tree_map_with_path
from .mesh import (
    axis_group,
    axis_sizes,
    enter,
    gather_cat,
    gather_weight,
    lookup_cut,
    ordered_sum,
)

__all__ = ["activation_rules", "param_pspecs", "opt_pspecs", "batch_specs",
           "cache_specs", "cache_block_shape", "shard_tree", "shard_spec",
           "shard_params", "keep_blocks", "tp_layout", "tensor_parallel",
           "fsdp_plan", "fsdp_gather", "mesh_rules", "block_slices",
           "mesh_coords", "batch_rows", "replica_axes"]


def _axsize(mesh, name) -> int:
    return axis_sizes(mesh).get(name, 1)


def _div(dim: int, mesh, axis: str):
    """axis if it divides dim, else None (replicate)."""
    n = _axsize(mesh, axis)
    return axis if dim % max(n, 1) == 0 and n > 1 else None


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _dp(mesh, dim: int):
    axes = _dp_axes(mesh)
    if not axes:
        return None
    if dim % math.prod(_axsize(mesh, a) for a in axes) == 0:
        return axes if len(axes) > 1 else axes[0]
    # try data-only (e.g. batch 16 on a 2x16 dp grid)
    if "data" in axes and dim % _axsize(mesh, "data") == 0:
        return "data"
    return None


def activation_rules(cfg: ModelConfig, mesh, batch: int) -> dict:
    """Logical-name -> mesh-axes map for ``models.shardctx``."""
    return {
        "batch": _dp(mesh, batch),
        "vocab": _div(cfg.padded_vocab, mesh, "model"),
        "expert": _div(cfg.num_experts, mesh, "model") if cfg.num_experts else None,
        "tp": "model",
        "fsdp": "data" if (cfg.fsdp and _axsize(mesh, "data") > 1) else None,
    }


# --------------------------------------------------------------------- params
def _param_spec(path: str, shape: tuple, cfg: ModelConfig, mesh) -> tuple:
    """Spec for a parameter's per-layer dims.  ``path`` is the '/'-joined
    key path without list indices (the reference's path)."""
    fsdp = "data" if (cfg.fsdp and _axsize(mesh, "data") > 1) else None
    tp = "model"
    name = path.split("/")[-1]
    nd = len(shape)

    def fs(dim_idx):
        return fsdp if fsdp and shape[dim_idx] % _axsize(mesh, "data") == 0 else None

    # embeddings / head
    if name == "embed":
        return (_div(shape[0], mesh, tp), fs(1))
    if name == "lm_head":
        return (fs(0), _div(shape[1], mesh, tp))

    # MoE experts: (E, D, F) / (E, F, D) — EP over tp when E divides, else
    # hidden-sharded; with cfg.fsdp the FFN dim (EP) or the d_model dim
    # (hidden-sharded) also shards over data (models/moe.py gathers it, or
    # moves the tokens instead)
    if re.search(r"moe/(wg|wu|wd)$", path):
        ep = _div(shape[0], mesh, tp)
        if ep:
            if name in ("wg", "wu"):
                return (ep, None, fs(2))
            return (ep, fs(1), None)
        if name in ("wg", "wu"):
            return (None, fs(1), _div(shape[2], mesh, tp))
        return (None, _div(shape[1], mesh, tp), fs(2))
    if name == "router":
        return (fs(0), None)

    # xlstm mLSTM: shard the value/output dim (state output axis)
    if "/mlstm/" in path or "/slstm/" in path:
        if name in ("wv", "wz"):
            return (fs(0), None, _div(shape[2], mesh, tp))
        if name in ("wq", "wk"):
            return (fs(0), None, None)
        if name == "wo":
            return (None, _div(shape[1], mesh, tp), fs(2))
        if name == "out_norm":
            return (None, _div(shape[1], mesh, tp))
        return (None,) * nd

    # mamba2: shard SSM heads
    if "/mamba/" in path or "cell/" in path and name in (
        "wz", "wx", "wB", "wC", "w_dt", "dt_bias", "A_log", "D_skip",
        "conv_x", "conv_B", "conv_C", "out_norm",
    ):
        if name in ("wz", "wx"):
            return (fs(0), _div(shape[1], mesh, tp), None)
        if name in ("wB", "wC"):
            return (fs(0), None)
        if name == "w_dt":
            return (fs(0), _div(shape[1], mesh, tp))
        if name in ("dt_bias", "A_log", "D_skip"):
            return (_div(shape[0], mesh, tp),)
        if name == "conv_x":
            return (None, _div(shape[1], mesh, tp), None)
        if name in ("conv_B", "conv_C"):
            return (None, None)
        if name == "out_norm":
            return (_div(shape[0], mesh, tp), None)

    # attention
    if name in ("wq", "wk", "wv"):          # (D, H, hd)
        h_ax = _div(shape[1], mesh, tp)
        hd_ax = _div(shape[2], mesh, tp) if h_ax is None else None
        return (fs(0), h_ax, hd_ax)
    if name == "wo" and nd == 3:             # (H, hd, D)
        h_ax = _div(shape[0], mesh, tp)
        hd_ax = _div(shape[1], mesh, tp) if h_ax is None else None
        return (h_ax, hd_ax, fs(2))
    if name in ("bq", "bk", "bv"):            # (H, hd)
        return (_div(shape[0], mesh, tp), None)
    # MLA
    if name in ("wq_a", "wkv_a"):             # (D, r)
        return (fs(0), None)
    if name in ("wq_b", "wk_b", "wv_b"):      # (r, H, d)
        return (fs(0), _div(shape[1], mesh, tp), None)

    # dense MLPs (incl. shared experts): (D, F) / (F, D)
    if name in ("wg", "wu", "wi"):
        return (fs(0), _div(shape[1], mesh, tp))
    if name == "wd":
        return (_div(shape[0], mesh, tp), fs(1))
    if name in ("bi",):
        return (_div(shape[0], mesh, tp),)
    if name in ("bd",):
        return (None,)

    # norms, biases, gates — replicate
    return (None,) * nd


def _path_str(path, keep_index: bool = True) -> str:
    """'/'-joined keys of a ``tree`` path; a parameter path drops its
    list indices (the layer lists stand where the reference's scan dims
    do)."""
    return "/".join(str(k) for k in path
                    if keep_index or not isinstance(k, int))


def param_pspecs(cfg: ModelConfig, params, mesh):
    """A tree of specs matching a parameter tree (tensors, or anything
    with ``shape``, such as meta tensors)."""

    def one(path, leaf):
        return _param_spec(_path_str(path, keep_index=False),
                           tuple(leaf.shape), cfg, mesh)

    return tree_map_with_path(one, params)


def opt_pspecs(cfg: ModelConfig, params, mesh):
    ps = param_pspecs(cfg, params, mesh)
    return {"m": ps, "v": ps, "step": ()}


# --------------------------------------------------------------------- batch
def batch_specs(cfg: ModelConfig, batch_shapes: dict, mesh) -> dict:
    out: dict[str, Any] = {}
    for k, v in batch_shapes.items():
        if k == "cache":
            out[k] = cache_specs(cfg, v, mesh)
            continue
        if k == "pos" or not hasattr(v, "shape"):
            out[k] = ()
            continue
        b = v.shape[0] if v.ndim else 1
        dp = _dp(mesh, b)
        if k in ("frames", "patches"):
            out[k] = (dp, None, None)
        else:
            out[k] = (dp,) + (None,) * (v.ndim - 1)
    return out


def _cache_spec(path: str, shape: tuple, mesh) -> tuple:
    """The spec of one cache leaf of global ``shape`` at ``path`` (its
    '/'-joined keys, tuple indices included: the reference's path)."""
    name = path.split("/")[-1]
    nd = len(shape)
    if name == "kpos":
        return (None,) * nd
    if name in ("c_kv", "k_rope"):     # (L, B, S, r)
        return (None, _dp(mesh, shape[1]), None,
                _div(shape[3], mesh, "model"))
    if name in ("k", "v") or "cross" in path:
        # (L_or_G, B, S, KV, hd) or the cross (k, v) (L, B, Se, KV, hd)
        if nd == 5:
            kv_ax = _div(shape[3], mesh, "model")
            hd_ax = _div(shape[4], mesh, "model") if kv_ax is None else None
            return (None, _dp(mesh, shape[1]), None, kv_ax, hd_ax)
    if "ssm" in path and nd == 6:       # (G, n_m, B, H, P, N)
        return (None, None, _dp(mesh, shape[2]),
                _div(shape[3], mesh, "model"), None, None)
    if "conv" in path and nd == 5:      # (G, n_m, B, ks, C)
        return (None, None, _dp(mesh, shape[2]), None,
                _div(shape[4], mesh, "model"))
    # xlstm states: shard batch over dp; value dim over tp when present
    if nd == 6:                          # mLSTM C (G, n_m, B, H, dv, dk)
        return (None, None, _dp(mesh, shape[2]),
                None, _div(shape[4], mesh, "model"), None)
    if nd == 5:                          # mLSTM n (G, n_m, B, H, d)
        return (None, None, _dp(mesh, shape[2]), None, None)
    if nd == 4:                          # sLSTM states (G, B, H, dh) / mLSTM m
        # (dim 1 of the mLSTM m (G, n_m, B, H) is n_m, not the batch: the
        # reference's rule, kept; models.model keeps m whole over the batch)
        return (None, _dp(mesh, shape[1]), None, None)
    if nd == 3:
        return (None, _dp(mesh, shape[1]), None)
    return (None,) * nd


def cache_specs(cfg: ModelConfig, cache_shapes, mesh):
    """Decode caches: batch over dp, heads (or head_dim / latent dim) over
    tp.  A None leaf (the encoder-decoder's unfilled ``cross``) gets
    None."""

    def one(path_t, leaf):
        if leaf is None:
            return None
        return _cache_spec(_path_str(path_t), tuple(leaf.shape), mesh)

    return tree_map_with_path(one, cache_shapes)


def cache_block_shape(path: str, shape: tuple, mesh) -> tuple:
    """The shape of a place's block of a cache leaf of global ``shape`` at
    ``path`` under ``cache_specs``' cut (every place's block has the same
    shape: the cuts are even)."""
    sizes = axis_sizes(mesh)
    return tuple(b - a for a, b in block_slices(
        shape, _cache_spec(path, tuple(shape), mesh), sizes,
        {a: 0 for a in sizes}))


# --------------------------------------------------------------- placement
def mesh_coords(mesh) -> dict:
    """{axis name: the calling rank's coordinate} on a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def block_slices(shape: tuple, spec, sizes: dict, coords: dict) -> tuple:
    """The (start, stop) of each dim of a tensor of ``shape`` that the place
    at ``coords`` holds under ``spec``: a dim cut over several axes takes
    their row-major index, the first axis major, as a ``NamedSharding``
    does."""
    out = []
    for d, size in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            out.append((0, size))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coords[a]
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways over {axes}")
        m = size // n
        out.append((idx * m, (idx + 1) * m))
    return tuple(out)


def _block(t: torch.Tensor, spec, sizes: dict, coords: dict) -> torch.Tensor:
    """The block of the full tensor ``t`` that the place at ``coords``
    holds under ``spec`` (``block_slices``).  A copy where it cuts, so that
    the full tensor can be freed; ``t`` itself where it does not."""
    cut = False
    for d, (a, b) in enumerate(block_slices(tuple(t.shape), spec, sizes,
                                            coords)):
        if b - a < t.shape[d]:
            t = t.narrow(d, a, b - a)
            cut = True
    return t.clone(memory_format=torch.contiguous_format) if cut else t


def batch_rows(mesh, rules: dict, batch: int,
               coords: dict | None = None) -> slice:
    """The rows of a global batch of ``batch`` that the place at
    ``coords`` (default: the calling rank's) holds under ``rules``
    (``activation_rules``): all of them when the batch is not split."""
    ax = rules.get("batch")
    if ax is None:
        return slice(0, batch)
    sizes = axis_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    n, idx = 1, 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n, idx = n * sizes[a], idx * sizes[a] + coords[a]
    b = batch // n
    return slice(idx * b, (idx + 1) * b)


def shard_tree(tree, specs, mesh, coords: dict | None = None):
    """``tree`` with each tensor cut to the block that the place at
    ``coords`` (default: the calling rank's) holds under its spec in
    ``specs`` (a tree of the same structure; None and ``()`` keep a leaf
    whole).  Every rank builds the whole tree from one seed, or converts
    it from the reference's arrays, and keeps its blocks."""
    sizes = axis_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords

    def at(path):
        s = specs
        for k in path:
            s = s[k]
        return s

    def one(path, leaf):
        spec = at(path)
        if not isinstance(leaf, torch.Tensor) or not spec:
            return leaf
        return _block(leaf, spec, sizes, coords)

    return tree_map_with_path(one, tree)


def shard_spec(cfg: ModelConfig, key: str, shape: tuple, mesh) -> tuple:
    """The spec ``shard_params`` cuts a parameter by: its ``param_pspecs``
    spec, the data axis included (``cfg.fsdp``)."""
    return _param_spec(key, shape, cfg, mesh)


def keep_blocks(cfg: ModelConfig, mesh, coords: dict | None = None):
    """``keep(path, tensor)``: the block of the whole parameter ``tensor``
    at ``path`` (a ``tree`` path, list indices included) that the place at
    ``coords`` (default: the calling rank's) holds under ``shard_spec``,
    a copy where it cuts; ``Model.init(keep=)`` draws through it a leaf at
    a time, ``shard_params`` cuts a whole tree with it."""
    sizes = axis_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords

    def keep(path, leaf):
        key = _path_str(path, keep_index=False)
        return _block(leaf, shard_spec(cfg, key, tuple(leaf.shape), mesh),
                      sizes, coords)

    return keep


def shard_params(cfg: ModelConfig, params, mesh, coords: dict | None = None):
    """The parameters a rank holds for the steps over a mesh: each leaf's
    block under ``shard_spec`` (``keep_blocks``).  Dense tensor parallelism
    (``models.layers``, ``models.model``) reads the blocks of attention
    (heads, or head_dim where the heads do not divide the model axis),
    MLPs (``wg``, ``wu``, ``wi``, ``bi`` by column, ``wd`` by row), the
    vocab-sharded ``embed`` and ``lm_head``; MLA the heads of ``wq_b``,
    ``wk_b``, ``wv_b`` and ``wo``; the recurrent blocks the mLSTM's value
    dim, the sLSTM's ``wo`` rows and Mamba2's heads (``models.xlstm``,
    ``models.ssm``); the MoE layer's sharded route the experts'; a leaf
    its spec does not cut over the model axis (norms, ``bd``, the router,
    ``wq_a``, ``wkv_a``, the gates, a dim that does not divide) stays
    whole over it.  With ``cfg.fsdp`` and a data axis every leaf whose
    spec names ``data`` is cut over it too (``fsdp_plan``)."""
    return tree_map_with_path(keep_blocks(cfg, mesh, coords), params)


def replica_axes(cfg: ModelConfig, params, mesh):
    """A tree like ``params`` (whole tensors, or meta stand-ins of their
    shapes: ``Model(cfg, "meta").init()``): for each leaf the mesh axes,
    in the mesh's order, over which the places hold the same block of it
    under ``shard_spec`` (the axes its spec does not cut): the batch axes
    for every leaf but those cut over data (``cfg.fsdp``), and the model
    axis too for a leaf whole over it (norms, ``bd``, the router,
    ``wq_a``, ``wkv_a``, the gates, a dim that does not divide).
    The train step over a mesh counts such a leaf once in the global
    norm, takes its scale over the other axes, and its replicas stay
    equal bit for bit."""
    names = tuple(axis_sizes(mesh))

    def one(path, leaf):
        spec = shard_spec(cfg, _path_str(path, keep_index=False),
                          tuple(leaf.shape), mesh)
        cut = set()
        for a in spec:
            if a is not None:
                cut.update(a if isinstance(a, tuple) else (a,))
        return tuple(a for a in names if a not in cut)

    return tree_map_with_path(one, params)


def tp_layout(cfg: ModelConfig, mesh) -> dict:
    """How ``shard_spec`` and ``cache_specs`` cut each block over the model
    axis, by the role the layers read it in (``shardctx.TensorParallel.
    layout``).  "q", "kv", "o" (``wq``; ``wk`` and ``wv``; ``wo``, MLA's
    too) and "cache" (the k and v caches and the cross (k, v)) are
    "heads", "hd" (a head_dim slice of every head) or None; "ssm_o" (the
    Mamba2 ``wo``) likewise.  True where cut, else False: "mlp" and
    "shared" (``wd``'s rows, the dense and the shared experts' MLP),
    "embed" (``embed``'s vocab rows), "head" (the vocab columns of
    ``lm_head``, or of the tied ``embed.T``); MLA's "mla" (``wq_b``,
    ``wk_b``, ``wv_b`` by heads), "latent" and "rope" (the ``c_kv`` cache
    over r, the ``k_rope`` cache over dr); the mLSTM's "mlstm" (``wv``,
    ``wz``, ``out_norm``, the rows of ``wo`` and the C state, by the
    value dim); the sLSTM's "slstm" (the dh rows of ``wo``); Mamba2's
    "ssm" (``wz``, ``wx``, ``w_dt``, ``dt_bias``, ``A_log``,
    ``D_skip``, ``out_norm``, ``conv_x`` and the SSM state, by heads),
    "conv_x" and "conv_bc" (the conv windows' channels: x's, B's and
    C's)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    V = cfg.padded_vocab

    def cut(key, shape, dim):
        return shard_spec(cfg, key, shape, mesh)[dim] is not None

    def heads(key, shape, h):
        spec = shard_spec(cfg, key, shape, mesh)
        return "heads" if spec[h] else "hd" if spec[h + 1] else None

    def cache_cut(path, shape, dim):
        return _cache_spec(path, shape, mesh)[dim] is not None

    lay = {"embed": cut("embed", (V, D), 0),
           "head": (cut("embed", (V, D), 0) if cfg.tie_embeddings
                    else cut("lm_head", (D, V), 1)),
           "mlp": cut("mlp/wd", (cfg.d_ff, D), 0)}
    if cfg.num_shared_experts:
        lay["shared"] = cut("moe/shared/wd",
                            (cfg.d_ff * cfg.num_shared_experts, D), 0)
    if cfg.mla:
        r_q, r, dr = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
        dv = cfg.v_head_dim
        lay["mla"] = cut("attn/wq_b", (r_q, H, hd + dr), 1)
        lay["o"] = heads("attn/wo", (H, dv, D), 0)
        lay["latent"] = cache_cut("c_kv", (1, 1, 1, r), 3)
        lay["rope"] = cache_cut("k_rope", (1, 1, 1, dr), 3)
    elif H and cfg.family != "xlstm":
        lay["q"] = heads("attn/wq", (D, H, hd), 1)
        lay["kv"] = heads("attn/wk", (D, KV, hd), 1)
        lay["o"] = heads("attn/wo", (H, hd, D), 0)
        spec = _cache_spec("k", (1, 1, 1, KV, hd), mesh)
        lay["cache"] = "heads" if spec[3] else "hd" if spec[4] else None
    if cfg.family == "xlstm":
        lay["mlstm"] = cut("stack/mlstm/cell/wv", (D, H, hd), 2)
        lay["slstm"] = cut("stack/slstm/cell/wo", (H, hd, D), 1)
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * D
        Hs, P, N = d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state
        lay["ssm"] = cut("stack/mamba/cell/wx", (D, Hs, P), 1)
        lay["ssm_o"] = heads("stack/mamba/cell/wo", (Hs, P, D), 0)
        ks = cfg.ssm_conv
        lay["conv_x"] = cache_cut("conv/x", (1, 1, 1, ks, d_inner), 4)
        lay["conv_bc"] = cache_cut("conv/B", (1, 1, 1, ks, N), 4)
    return lay


def tensor_parallel(cfg: ModelConfig, mesh) -> TensorParallel | None:
    """The model axis of ``mesh`` as the dense layers read it (``shardctx.
    tensor_parallel()``): the calling place's coordinate on it, the
    gather and ordered sum over its group (``launch.mesh``) and
    ``tp_layout``; None where the axis is one place."""
    n = axis_sizes(mesh).get("model", 1)
    if n <= 1:
        return None
    group = axis_group(mesh, "model")
    return TensorParallel(
        n, mesh.get_local_rank("model"), tp_layout(cfg, mesh),
        gather=lambda x, dim: gather_cat(x, group, dim),
        sum=lambda x: ordered_sum(x, group),
        enter=lambda x: enter(x, group))


_EXPERTS = re.compile(r"moe/(wg|wu|wd)$")


def fsdp_plan(cfg: ModelConfig, mesh) -> dict:
    """{parameter key (its path without list indices): (the dim cut over
    data, the place's block shape, the dtype the layers read it in)} for
    every dense leaf that ``shard_spec`` cuts over the data axis; empty
    without ``cfg.fsdp`` or a data axis of more than one place.  Worked
    out from the whole shapes on the meta device: whether a dim divides
    decides the cut, and a block cannot tell.  The dtype is the leaf's
    in the serving tree (the compute dtype of a matrix, float32 of the
    router and the gate projections), so a float32 master is cast where
    the layers would cast it.  The experts are the MoE layer's own
    (``models.moe`` gathers them).  Worked out once for a config and the
    mesh's axis sizes (``mesh_rules`` asks on every step), and read-only."""
    sizes = axis_sizes(mesh)
    if not cfg.fsdp or sizes.get("data", 1) <= 1:
        return {}
    return _fsdp_plan(cfg, tuple(sizes.items()))


@functools.lru_cache(maxsize=64)
def _fsdp_plan(cfg: ModelConfig, sizes: tuple) -> types.MappingProxyType:
    from ..models.model import Model

    sizes = dict(sizes)
    mesh = types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
    meta = Model(cfg, torch.device("meta"))
    dtypes = {_path_str(p, keep_index=False): t.dtype
              for p, t in tree_leaves_with_path(meta.init())}
    plan = {}
    for path, leaf in tree_leaves_with_path(meta.init(master=True)):
        key = _path_str(path, keep_index=False)
        spec = shard_spec(cfg, key, tuple(leaf.shape), mesh)
        if "data" not in spec or _EXPERTS.search(key) or key in plan:
            continue
        block = tuple(b - a for a, b in block_slices(
            tuple(leaf.shape), spec, sizes, {a: 0 for a in sizes}))
        plan[key] = (spec.index("data"), block, dtypes[key])
    return types.MappingProxyType(plan)


def fsdp_gather(cfg: ModelConfig, mesh) -> Fsdp | None:
    """The data axis's cut of the dense weights as the layers read it
    (``shardctx.fsdp()``): ``fsdp_plan`` and the gathers over the data
    axis's group (``launch.mesh.gather_weight``, ``lookup_cut``); None
    where nothing is cut over data."""
    plan = fsdp_plan(cfg, mesh)
    if not plan:
        return None
    group = axis_group(mesh, "data")
    return Fsdp(plan,
                gather=lambda w, dim, dtype: gather_weight(w, group, dim,
                                                           dtype),
                lookup=lambda block, tokens, dtype: lookup_cut(
                    block, tokens, group, dtype))


def mesh_rules(cfg: ModelConfig, mesh, batch: int):
    """The context the model runs under on a place of ``mesh`` with a
    global batch of ``batch``: ``activation_rules``,
    ``tensor_parallel`` and ``fsdp_gather``."""
    return logical_axis_rules(mesh, activation_rules(cfg, mesh, batch),
                              tp=tensor_parallel(cfg, mesh),
                              fsdp=fsdp_gather(cfg, mesh))
