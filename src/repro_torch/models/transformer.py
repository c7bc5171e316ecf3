"""The block stacks of the dense and MoE families:
  dense — [ln -> attn(GQA/SWA/qk-norm) -> ln -> mlp] x L
  moe   — [ln -> attn(GQA/SWA, or MLA) -> ln -> moe] x L

The port of the dense/moe part of ``repro/models/transformer.py``.  A
Python loop over a list of per-layer parameter dicts takes the place of
``lax.scan`` over stacked parameters.  Each layer returns its MoE
auxiliary loss (0 for a dense layer), summed in float32 in layer order.
Where autograd records the stack (training), ``cfg.remat`` picks what a
layer keeps for the backward pass, as the reference's ``jax.checkpoint``
policies do: ``none`` keeps everything, ``full`` recomputes the whole layer
(``torch.utils.checkpoint``, non-reentrant), ``dots`` keeps the outputs of
the matrix products without batch dimensions (``aten.mm``; the attention
and expert products are batched) and recomputes the rest.  Caches keep the
reference's stacked layout, {"k", "v"}: (L, B, Smax, KV, dh), plus
``kpos`` (L, Smax) for the SWA ring buffer, or MLA's latent cache
{"c_kv": (L, B, Smax, r_kv), "k_rope": (L, B, Smax, dr)}, and each layer
writes its slice in place.  Cross-attention and the recurrent stacks are
not ported yet (``ROADMAP.md`` Queue 1, the other model families).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from . import layers as LL
from . import moe as MOE
from .shardctx import bf16_grad_barrier

__all__ = ["init_layer", "apply_layer", "init_dense_stack",
           "apply_dense_stack", "init_kv_caches"]


def init_layer(gen, cfg, dtype, device):
    p = {"ln1": LL.init_norm(cfg, device), "ln2": LL.init_norm(cfg, device),
         "attn": (LL.init_mla if cfg.mla else LL.init_attention)(
             gen, cfg, dtype, device)}
    if cfg.num_experts:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = LL.init_mlp(gen, cfg, dtype, device)
    return p


def apply_layer(p, x, cfg, positions, *, cache=None, cache_len=None,
                flash=False):
    """(x, aux): the layer's output and its MoE auxiliary loss (float32),
    None for a dense layer (the reference's 0: nothing to add)."""
    dt = getattr(torch, cfg.dtype)
    h = LL.apply_norm(p["ln1"], x, cfg.norm)
    if cfg.mla:
        a = LL.mla_block(p["attn"], h, cfg, positions, cache=cache,
                         cache_len=cache_len, dtype=dt, flash=flash)
    else:
        a = LL.attention_block(p["attn"], h, cfg, positions, kv_cache=cache,
                               cache_len=cache_len, dtype=dt, flash=flash)
    # the reference's constrain() here is the identity without a mesh
    x = bf16_grad_barrier(x + a)
    h = LL.apply_norm(p["ln2"], x, cfg.norm)
    if "moe" in p:
        m, info = MOE.apply_moe(p["moe"], h, cfg, dtype=dt, return_aux=True)
        aux = info["aux_loss"]
    else:
        m = LL.apply_mlp(p["mlp"], h, cfg.mlp, dtype=dt)
        aux = None
    return bf16_grad_barrier(x + m), aux


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` under the checkpoint policy ``cfg.remat``."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} is not none, full or dots")
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def init_dense_stack(gen, cfg, dtype, device):
    """One parameter dict per layer, drawn one tensor at a time."""
    return [init_layer(gen, cfg, dtype, device)
            for _ in range(cfg.num_layers)]


def apply_dense_stack(params_L, x, cfg, positions, *, caches=None,
                      cache_len=None, flash=False):
    """A loop over the layers (and the layer slices of the caches); each
    layer under ``cfg.remat`` where autograd records it.  Returns (x,
    caches, aux), aux the layers' auxiliary losses summed in float32 in
    layer order."""
    layer = apply_layer
    if torch.is_grad_enabled() and caches is None:
        layer = _remat(apply_layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, p in enumerate(params_L):
        cache_l = (None if caches is None
                   else {name: c[l] for name, c in caches.items()})
        x, a = layer(p, x, cfg, positions, cache=cache_l,
                     cache_len=cache_len, flash=flash)
        if a is not None:
            aux = aux + a
    return x, caches, aux


def init_kv_caches(cfg, batch, cache_seq, device, dtype=torch.bfloat16):
    L = cfg.num_layers
    if cfg.mla:
        return {"c_kv": torch.zeros((L, batch, cache_seq, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((L, batch, cache_seq,
                                       cfg.rope_head_dim),
                                      dtype=dtype, device=device)}
    shape = (L, batch, cache_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
