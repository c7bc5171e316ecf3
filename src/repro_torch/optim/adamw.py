"""AdamW with dtype-policied moments (bf16 for the 200B+ configs) and
global-norm clipping.

The port of ``repro/optim/adamw.py``.  The state is a dict of trees of
tensors, {"m", "v", "step"}, with ``step`` an int32 tensor on the
parameters' device.  ``apply_updates`` updates the parameters and the
moments in place under ``torch.no_grad()`` and returns them, so a step
keeps one copy of each.  Every operation rounds as the reference's does:
float32 throughout, a Python scalar rounded to float32 before it meets a
tensor (JAX's weakly typed constants), the bias correction
``1 - b1 ** step`` computed in float32 on the device, and the divisions by
a tensor (on the card a division by a Python scalar is a multiplication
by its reciprocal, which may differ in the last bit).
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "global_norm", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    md = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=md, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def global_norm(tree, cut=None) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in float32: one sum a leaf, then their sum in
    tree order.  Over a mesh ``tree`` holds the place's blocks and
    ``cut`` lists, a leaf in tree order, the group its leaf is cut over
    (``launch.mesh.axis_group`` of the axes that cut it), or None where
    the place holds it whole: each cut leaf's square sum is summed over
    its group in rank order (one ``ordered_sum`` a group, of every such
    leaf's sum at once), a whole leaf counted once, so every place gets
    the whole tree's norm, the same bits on each."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if cut is not None:
        from ..launch.mesh import ordered_sum

        if len(cut) != len(sums):
            raise ValueError(f"cut names {len(cut)} leaves, the tree has "
                             f"{len(sums)}")
        by_group: dict = {}
        for i, g in enumerate(cut):
            if g is not None:
                by_group.setdefault(id(g), (g, []))[1].append(i)
        for g, idx in by_group.values():
            total = ordered_sum(torch.stack([sums[i] for i in idx]), g)
            for j, i in enumerate(idx):
                sums[i] = total[j]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamWConfig,
                  grad_norm: torch.Tensor | None = None):
    """One AdamW step, in place: (params, state, {"grad_norm"}).  ``grads``
    is a tree like ``params`` (float32 or the parameters' dtype); it is
    consumed (scaled in place when it is float32).  ``grad_norm``: the
    norm the clipping reads (over a mesh, the whole tree's:
    ``global_norm(grads, cut)``); by default ``global_norm(grads)``."""
    step = state["step"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(
        torch.full_like(gn, cfg.clip_norm) / torch.clamp(gn, min=1e-12),
        max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    # every leaf is contiguous (drawn, cut to a copy, zeros, or autograd's
    # gradient in its parameter's layout), so its flat view is in place
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(state["m"]), tree_leaves(state["v"])):
        flat = [t.view(-1) for t in leaf]
        for i in range(0, flat[0].numel(), _PIECE):
            _update(*(t[i:i + _PIECE] for t in flat), cfg, scale, bc1, bc2)
    state["step"] = step
    return params, state, {"grad_norm": gn}


# elements a piece of a leaf's update: its temporaries are a few pieces,
# not a few leaves (a rank's 0.5 G-element embedding block would take 6 GB)
_PIECE = 1 << 24


def _update(p, g, m, v, cfg: AdamWConfig, scale, bc1, bc2) -> None:
    """The update of one leaf, or of a piece of its flattened elements
    (every operation is elementwise: the same bits either way), in
    place."""
    g = g.float().mul_(scale) if g.dtype == torch.float32 else \
        g.float() * scale
    m32 = m.mul_(cfg.b1) if m.dtype == torch.float32 else m.float() * cfg.b1
    m32.add_(g * (1 - cfg.b1))
    v32 = v.mul_(cfg.b2) if v.dtype == torch.float32 else v.float() * cfg.b2
    v32.add_(torch.square(g) * (1 - cfg.b2))
    del g
    den = torch.div(v32, bc2).sqrt_().add_(cfg.eps)   # sqrt(v̂) + eps
    u = torch.div(m32, bc1).div_(den)                  # m̂ / (sqrt(v̂) + eps)
    del den
    p32 = p.float()
    u.add_(p32 * cfg.weight_decay).mul_(cfg.lr)
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(p32 - u)
    if m32 is not m:
        m.copy_(m32)
        v.copy_(v32)
