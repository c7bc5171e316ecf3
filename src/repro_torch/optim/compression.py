"""Gradient compression for the data-parallel reduce: per-leaf int8
quantization with error feedback (the distributed-optimization analogue of
DBPG's value compression, [19] §5; beyond-paper applied to LM training).

Semantics: q = quantize(g + e);  e' = (g + e) − dequant(q);  the reduce sees
dequant(q).  On a real fabric the wire carries int8; here the numerics are
modelled exactly.

The port of ``repro/optim/compression.py``.  A leaf of the reference's
tree has one scale, max|g + e| / 127.  The reference stacks the layers'
parameters on a leading axis, so each of a layer's leaves shares its scale
with the same leaf of every other layer: the port, whose ``stack`` is a
list of per-layer dicts, groups its leaves by their path with the list
index left out and gives each group one scale.  The divisions are
divisions by a tensor, as in the reference (see ``adamw``).
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves_with_path, tree_map, tree_map_with_path

__all__ = ["CompressionState", "init_compression", "compress_grads"]

CompressionState = dict  # error-feedback buffers mirroring grads


def init_compression(params) -> CompressionState:
    return {"ef": tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)}


@torch.no_grad()
def compress_grads(grads, state: CompressionState, cut=None):
    """(wire, {"ef": e'}): the dequantized int8 values each leaf sends and
    the new error-feedback buffers.  Over a mesh ``grads`` and the
    buffers are the place's blocks and ``cut`` lists, a leaf in tree
    order, the group its leaf is cut over, or None (``adamw.
    global_norm``): a group of leaves' max|g + e| is then the whole
    leaves', the max over the places of that group (exact in any order),
    so the scale is the reference's."""
    groups: dict = {}
    cuts: dict = {}
    leaves = zip(tree_leaves_with_path(grads),
                 tree_leaves_with_path(state["ef"]))
    for i, ((path, g), (_, e)) in enumerate(leaves):
        key = tuple("*" if isinstance(k, int) else k for k in path)
        groups.setdefault(key, []).append((path, g.float() + e))
        if cut is not None:
            cuts.setdefault(key, cut[i])
    amaxes = {key: torch.amax(torch.stack([torch.amax(torch.abs(tot))
                                           for _, tot in members]))
              for key, members in groups.items()}
    if cut is not None:
        from ..launch.mesh import gather_stack

        by_group: dict = {}
        for key, g in cuts.items():
            if g is not None:
                by_group.setdefault(id(g), (g, []))[1].append(key)
        for g, keys in by_group.values():
            every = gather_stack(torch.stack([amaxes[k] for k in keys]), g)
            for j, key in enumerate(keys):
                amaxes[key] = torch.amax(every[:, j])
    wire, ef = {}, {}
    for key, members in groups.items():
        amax = torch.clamp(amaxes[key], min=1e-12)
        scale = amax / torch.full_like(amax, 127.0)
        for path, tot in members:
            w = torch.clamp(torch.round(tot / scale), -127, 127) * scale
            wire[path], ef[path] = w, tot - w
    return (tree_map_with_path(lambda p, _: wire[p], grads),
            {"ef": tree_map_with_path(lambda p, _: ef[p], grads)})
