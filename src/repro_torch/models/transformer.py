"""The block stacks of every family:
  dense / vlm — [ln -> attn(GQA/SWA/qk-norm) -> ln -> mlp] x L
  moe    — [ln -> attn(GQA/SWA, or MLA) -> ln -> moe] x L
  encdec — encoder [ln -> attn(bidirectional) -> ln -> mlp] x Le, then
           decoder [ln -> self-attn -> ln -> cross-attn -> ln -> mlp] x Ld
  xlstm  — G groups of (xlstm_group - 1) mLSTM blocks and one sLSTM block
  hybrid — G groups of (hybrid_group - 1) Mamba2 blocks, each group
           followed by one weight-tied shared attention layer

The port of ``repro/models/transformer.py``.  A
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

The recurrent stacks keep their parameters as lists: xLSTM's {"mlstm": G
lists of n_m block dicts, "slstm": G block dicts}, the hybrid's {"mamba":
G lists of n_m block dicts, "shared_attn": one ``init_layer`` dict}, each
block dict {"ln", "cell"} (a pre-norm and a residual around the cell).
Their states keep the reference's stacked layout, written in place:
xLSTM's {"m": (C, n, m) at (G, n_m, B, H, dh, dh), (G, n_m, B, H, dh),
(G, n_m, B, H) and "s": (c, n, h, m), each (G, B, H, dh)}, all float32;
the hybrid's {"ssm": (G, n_m, B, H, P, N), "conv": {"x", "B", "C"} at
(G, n_m, B, ks, .), "attn": {"k", "v"} (G, B, Smax, KV, dh)}, in the
compute dtype: each group's shared attention writes its own slice of the
KV cache, although the weights are one.  ``cfg.remat`` wraps a whole
group, as the reference's ``_remat`` does.

Under a data axis's cut of the dense weights (``shardctx.fsdp()``: FSDP
over a mesh) a layer, a recurrent block and the shared attention gather
their blocks whole over data at their top, inside the remat checkpoint:
a place holds one block's gathered weights beside its own blocks, and
remat gathers them again in the backward, on every rank alike.
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
from . import ssm as SSM
from . import xlstm as XL
from .shardctx import bf16_grad_barrier, bind_rules, fsdp

__all__ = ["init_layer", "apply_layer", "init_dense_stack",
           "apply_dense_stack", "init_kv_caches", "init_xlstm_stack",
           "apply_xlstm_stack", "init_xlstm_states", "init_hybrid_stack",
           "apply_hybrid_stack", "init_hybrid_states"]


def init_layer(gen, cfg, dtype, device, cross=False, keep=None):
    """A layer's parameters; ``cross=True`` adds the decoder's
    cross-attention (``ln_x``, ``xattn``).  ``keep(path, tensor)``
    (``Model.init``) takes each drawn tensor right after its draw."""
    sub = functools.partial(LL.sub_keep, keep)
    p = {"ln1": LL.init_norm(cfg, device), "ln2": LL.init_norm(cfg, device),
         "attn": (LL.init_mla if cfg.mla else LL.init_attention)(
             gen, cfg, dtype, device, keep=sub("attn"))}
    if cross:
        p["ln_x"] = LL.init_norm(cfg, device)
        p["xattn"] = LL.init_attention(gen, cfg, dtype, device,
                                       keep=sub("xattn"))
    if cfg.num_experts:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device, keep=sub("moe"))
    else:
        p["mlp"] = LL.init_mlp(gen, cfg, dtype, device, keep=sub("mlp"))
    return p


def _gathered(p, prefix: str):
    """``p``, a block of parameters at ``prefix``, with every leaf cut
    over data gathered whole (``shardctx.fsdp()``); ``p`` itself without
    a data cut."""
    fs = fsdp()
    return p if fs is None else fs(p, prefix)


def apply_layer(p, x, cfg, positions, *, cache=None, cache_len=None,
                cross_kv=None, causal=True, flash=False, prefix="stack"):
    """(x, aux): the layer's output and its MoE auxiliary loss (float32),
    None for a dense layer (the reference's 0: nothing to add).  A layer
    with ``xattn`` (the decoder's) attends ``cross_kv``, its (k, v).
    ``prefix``: the key of the layer's parameters in the model's tree
    (``stack``, ``enc``, ``stack/shared_attn``), which names its leaves
    in the data axis's cut."""
    dt = getattr(torch, cfg.dtype)
    p = _gathered(p, prefix)
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
    """``fn`` under the checkpoint policy ``cfg.remat``.  Under the rules
    of a mesh the recomputed forward runs under the rules current when
    the layer first ran (``shardctx.bind_rules``), and reruns its forward
    gathers in the backward, on every rank alike."""
    if cfg.remat == "none":
        return fn
    fn = bind_rules(fn)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} is not none, full or dots")
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def init_dense_stack(gen, cfg, dtype, device, n_layers=None, cross=False,
                     keep=None):
    """One parameter dict per layer (``n_layers``, default
    ``cfg.num_layers``), drawn one tensor at a time."""
    return [init_layer(gen, cfg, dtype, device, cross=cross,
                       keep=LL.sub_keep(keep, l))
            for l in range(n_layers or cfg.num_layers)]


def apply_dense_stack(params_L, x, cfg, positions, *, caches=None,
                      cache_len=None, cross_kv=None, causal=True,
                      flash=False, prefix="stack"):
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
                     flash=flash, prefix=prefix)
        if a is not None:
            aux = aux + a
    return x, caches, aux


def _full(path, shape, fill, block, **kw):
    """A cache leaf of global ``shape`` filled with ``fill``; ``block``
    (``Model._cache_block``: (path, global shape) -> the place's block
    shape under ``launch.sharding.cache_specs``) makes it a place's
    block."""
    if block is not None:
        shape = block(path, tuple(shape))
    return torch.full(shape, fill, **kw)


def init_kv_caches(cfg, batch, cache_seq, device, dtype=torch.bfloat16,
                   block=None):
    """Zero caches of every layer; ``block`` gives a place's block of each
    (``_full``) under tensor parallelism (``Model.init_cache``)."""
    L = cfg.num_layers
    kw = dict(dtype=dtype, device=device)
    if cfg.mla:
        return {"c_kv": _full("c_kv", (L, batch, cache_seq, cfg.kv_lora_rank),
                              0, block, **kw),
                "k_rope": _full("k_rope", (L, batch, cache_seq,
                                           cfg.rope_head_dim), 0, block,
                                **kw)}
    shape = (L, batch, cache_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": _full("k", shape, 0, block, **kw),
            "v": _full("v", shape, 0, block, **kw)}


# ---------------------------------------------------------------- xlstm
def _groups(cfg, group: int) -> tuple[int, int]:
    """(G groups, n_m recurrent blocks a group)."""
    return cfg.num_layers // group, group - 1


def init_xlstm_stack(gen, cfg, dtype, device, keep=None):
    G, n_m = _groups(cfg, cfg.xlstm_group)

    def block(init, *path):
        return {"ln": LL.init_norm(cfg, device),
                "cell": init(gen, cfg, dtype, device,
                             keep=LL.sub_keep(keep, *path, "cell"))}

    return {"mlstm": [[block(XL.init_mlstm, "mlstm", g, i)
                       for i in range(n_m)] for g in range(G)],
            "slstm": [block(XL.init_slstm, "slstm", g) for g in range(G)]}


def _xlstm_group(mlstm, slstm, x, cfg, g=None, states=None):
    """One group: its mLSTM blocks, then its sLSTM block.  With ``states``
    (decode) each block steps from its slice of them, written in place."""
    dt = getattr(torch, cfg.dtype)
    for i, p in enumerate(mlstm):
        p = _gathered(p, "stack/mlstm")
        h = LL.apply_norm(p["ln"], x, cfg.norm)
        if states is None:
            h, _ = XL.mlstm_block(p["cell"], h, cfg, chunk=cfg.attn_chunk,
                                  dtype=dt)
        else:
            st = tuple(s[g, i] for s in states["m"])
            h, new = XL.mlstm_block(p["cell"], h, cfg, state=st, dtype=dt)
            for s, n in zip(st, new):
                s.copy_(n)
        x = x + h
    slstm = _gathered(slstm, "stack/slstm")
    h = LL.apply_norm(slstm["ln"], x, cfg.norm)
    st = None if states is None else tuple(s[g] for s in states["s"])
    h, new = XL.slstm_block(slstm["cell"], h, cfg, state=st, dtype=dt)
    if st is not None:
        for s, n in zip(st, new):
            s.copy_(n)
    return x + h


def apply_xlstm_stack(params, x, cfg, *, states=None):
    """(x, states): the groups in order, each under ``cfg.remat`` where
    autograd records the stack; ``states`` (``init_xlstm_states``) are
    stepped in place (decode, one token)."""
    group = _xlstm_group
    if torch.is_grad_enabled() and states is None:
        group = _remat(_xlstm_group, cfg)
    for g, (mlstm, slstm) in enumerate(zip(params["mlstm"],
                                           params["slstm"])):
        x = group(mlstm, slstm, x, cfg, g, states)
    return x, states


def init_xlstm_states(cfg, batch, device, block=None):
    """Zero states (the sLSTM n ones), float32; ``block``: a place's
    blocks (``_full``)."""
    G, n_m = _groups(cfg, cfg.xlstm_group)
    H, dh = cfg.num_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    m_shapes = ((G, n_m, batch, H, dh, dh), (G, n_m, batch, H, dh),
                (G, n_m, batch, H))
    s = (G, batch, H, dh)
    return {
        "m": tuple(_full(f"m/{i}", sh, 0, block, **f32)
                   for i, sh in enumerate(m_shapes)),
        "s": tuple(_full(f"s/{i}", s, 1 if i == 1 else 0, block, **f32)
                   for i in range(4)),
    }


# ---------------------------------------------------------------- hybrid
def init_hybrid_stack(gen, cfg, dtype, device, keep=None):
    G, n_m = _groups(cfg, cfg.hybrid_group)
    return {"mamba": [[{"ln": LL.init_norm(cfg, device),
                        "cell": SSM.init_mamba2(
                            gen, cfg, dtype, device,
                            keep=LL.sub_keep(keep, "mamba", g, i, "cell"))}
                       for i in range(n_m)] for g in range(G)],
            "shared_attn": init_layer(gen, cfg, dtype, device,
                                      keep=LL.sub_keep(keep, "shared_attn"))}


def _hybrid_group(mamba, shared, x, cfg, positions, g=None, states=None,
                  cache_len=None):
    """One group: its Mamba2 blocks, then the shared attention layer.  With
    ``states`` (decode) each block steps from its SSM state and conv
    window and the attention writes the group's KV slice, all in place."""
    dt = getattr(torch, cfg.dtype)
    for i, p in enumerate(mamba):
        p = _gathered(p, "stack/mamba")
        h = LL.apply_norm(p["ln"], x, cfg.norm)
        if states is None:
            h, _, _ = SSM.mamba2_block(p["cell"], h, cfg,
                                       chunk=min(cfg.attn_chunk, 256),
                                       dtype=dt)
        else:
            conv = {k: c[g, i] for k, c in states["conv"].items()}
            h, st, new_conv = SSM.mamba2_block(
                p["cell"], h, cfg, state=states["ssm"][g, i],
                conv_cache=conv, dtype=dt)
            states["ssm"][g, i].copy_(st)
            for k, c in conv.items():
                c.copy_(new_conv[k])
        x = x + h
    cache = (None if states is None
             else {k: c[g] for k, c in states["attn"].items()})
    x, _ = apply_layer(shared, x, cfg, positions, cache=cache,
                       cache_len=cache_len, prefix="stack/shared_attn")
    return x


def apply_hybrid_stack(params, x, cfg, positions, *, states=None,
                       cache_len=None):
    """(x, states): the groups in order, each under ``cfg.remat`` where
    autograd records the stack; ``states`` (``init_hybrid_states``) are
    stepped in place (decode, one token at ``cache_len``)."""
    group = _hybrid_group
    if torch.is_grad_enabled() and states is None:
        group = _remat(_hybrid_group, cfg)
    for g, mamba in enumerate(params["mamba"]):
        x = group(mamba, params["shared_attn"], x, cfg, positions, g,
                  states, cache_len)
    return x, states


def init_hybrid_states(cfg, batch, cache_seq, device, dtype=torch.bfloat16,
                       block=None):
    """Zero states in ``dtype``; ``block``: a place's blocks (``_full``)."""
    G, n_m = _groups(cfg, cfg.hybrid_group)
    _, H, P, N = SSM.ssm_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    conv = SSM.init_conv_cache(cfg, batch, "meta", dtype)
    kv = (G, batch, cache_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "ssm": _full("ssm", (G, n_m, batch, H, P, N), 0, block, **kw),
        "conv": {k: _full(f"conv/{k}", (G, n_m) + tuple(v.shape), 0, block,
                          **kw) for k, v in conv.items()},
        "attn": {k: _full(f"attn/{k}", kv, 0, block, **kw)
                 for k in ("k", "v")},
    }
