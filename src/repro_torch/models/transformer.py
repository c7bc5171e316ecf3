"""The block stacks of the dense, MoE and encoder-decoder families:
  dense  — [ln -> attn(GQA/SWA/qk-norm) -> ln -> mlp] x L
  moe    — [ln -> attn(GQA/SWA, or MLA) -> ln -> moe] x L
  encdec — encoder [ln -> attn(bidirectional) -> ln -> mlp] x Le, then
           decoder [ln -> self-attn -> ln -> cross-attn -> ln -> mlp] x Ld

The port of the dense/moe/encdec part of ``repro/models/transformer.py``.  A
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
writes its slice in place.  A decoder layer's cross-attention reads its
layer's slice of the encoder's keys and values, (L, B, Se, KV, dh) each.
The recurrent stacks are not ported yet (``ROADMAP.md`` Queue 1, the
other model families).
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


def init_layer(gen, cfg, dtype, device, cross=False):
    """A layer's parameters; ``cross=True`` adds the decoder's
    cross-attention (``ln_x``, ``xattn``)."""
    p = {"ln1": LL.init_norm(cfg, device), "ln2": LL.init_norm(cfg, device),
         "attn": (LL.init_mla if cfg.mla else LL.init_attention)(
             gen, cfg, dtype, device)}
    if cross:
        p["ln_x"] = LL.init_norm(cfg, device)
        p["xattn"] = LL.init_attention(gen, cfg, dtype, device)
    if cfg.num_experts:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = LL.init_mlp(gen, cfg, dtype, device)
    return p


def apply_layer(p, x, cfg, positions, *, cache=None, cache_len=None,
                cross_kv=None, causal=True, flash=False):
    """(x, aux): the layer's output and its MoE auxiliary loss (float32),
    None for a dense layer (the reference's 0: nothing to add).  A layer
    with ``xattn`` (the decoder's) attends ``cross_kv``, its (k, v)."""
    dt = getattr(torch, cfg.dtype)
    h = LL.apply_norm(p["ln1"], x, cfg.norm)
    if cfg.mla:
        a = LL.mla_block(p["attn"], h, cfg, positions, cache=cache,
                         cache_len=cache_len, dtype=dt, flash=flash)
    else:
        a = LL.attention_block(p["attn"], h, cfg, positions, kv_cache=cache,
                               cache_len=cache_len, causal=causal, dtype=dt,
                               flash=flash)
    # the reference's constrain() here is the identity without a mesh
    x = bf16_grad_barrier(x + a)
    if "xattn" in p:
        if cross_kv is None:
            raise ValueError("a cross-attention layer needs the encoder's "
                             "(k, v): prefill, or launch.serve._init_cache")
        h = LL.apply_norm(p["ln_x"], x, cfg.norm)
        x = x + LL.attention_block(p["xattn"], h, cfg, positions,
                                   cross_kv=cross_kv, dtype=dt, flash=flash)
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


def init_dense_stack(gen, cfg, dtype, device, n_layers=None, cross=False):
    """One parameter dict per layer (``n_layers``, default
    ``cfg.num_layers``), drawn one tensor at a time."""
    return [init_layer(gen, cfg, dtype, device, cross=cross)
            for _ in range(n_layers or cfg.num_layers)]


def apply_dense_stack(params_L, x, cfg, positions, *, caches=None,
                      cache_len=None, cross_kv=None, causal=True,
                      flash=False):
    """A loop over the layers (and the layer slices of the caches); each
    layer under ``cfg.remat`` where autograd records it.  ``cross_kv``:
    the decoder's cross (k, v), a pair of (L, B, Se, KV, dh) tensors whose
    layer slices go to the layers; under remat each layer's slices go
    through the checkpoint as inputs, whose backward reaches the encoder.
    Returns
    (x, caches, aux), aux the layers' auxiliary losses summed in float32
    in layer order."""
    layer = apply_layer
    if torch.is_grad_enabled() and caches is None:
        layer = _remat(apply_layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, p in enumerate(params_L):
        cache_l = (None if caches is None
                   else {name: c[l] for name, c in caches.items()})
        ckv_l = None if cross_kv is None else (cross_kv[0][l],
                                                cross_kv[1][l])
        x, a = layer(p, x, cfg, positions, cache=cache_l,
                     cache_len=cache_len, cross_kv=ckv_l, causal=causal,
                     flash=flash)
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
