"""Transformer layers: norms, rotary, GQA attention with a KV cache (full
or the SWA ring buffer), multi-head latent attention (MLA) with its latent
cache, MLPs.

The port of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors (``init_*`` builds them, ``apply_*`` reads them).  Dtype policy as
in the reference: matrices are used in the compute ``dtype``, cast at
every product.  Training keeps float32 masters, as the reference does
(``Model.init(master=True)``, ``convert.model_params_from_numpy(...,
master=True)``); serving stores the cast once, so its casts are no-ops
and give the same values.  Vectors (norm scales, biases) stay float32 and
are cast where the reference casts them.

Attention routes:
  * ``naive``   — the full (Sq, Skv) score matrix;
  * ``chunked`` — a loop over query chunks, bounding the live score tensor
    to (B, KV, G, chunk, Skv); where autograd records it, each chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``, the
    reference's per-chunk ``jax.checkpoint``) instead of keeping every
    chunk's probabilities;
  * the flash kernel (``kernels/flash_attention``) — prefill from cache
    slot 0, where query and key positions are both ``arange``: the caller
    (``Model.prefill``) asks for it with ``flash=True``.  Decode, one query
    against a cache whose unwritten slots are pushed to position 2**30,
    stays on the plain routes, as it stays in XLA in the reference.
The SWA ring buffer (a cache with ``kpos``, ``Model.init_cache(...,
ring=True)``) holds the last Smax keys at slot ``pos % Smax`` and their
positions in ``kpos``; it takes one token a call (decode), as the
reference only ever calls it.
MLA (DeepSeek-V2, ``mla_block``) caches the normalised latent ``c_kv``
(B, Smax, r_kv) and the rotary key ``k_rope`` (B, Smax, dr) in place of
per-head keys and values.  With a cache it takes the reference's absorbed
form (queries projected by W_uk and scored against the latent; the
context projected by W_uv), over query chunks of ``attn_chunk`` on a
chunked config; without one (training) it rebuilds per-head k (dn + dr
wide) and v (dv wide) and calls ``attention``.  ``flash=True`` (prefill
from slot 0) writes the latent cache, rebuilds k and v and launches the
flash kernel once at (Dqk, Dv) = (dn + dr, dv): the same function in
another order of rounding, where the reference's prefill takes the
absorbed form.
Cross-attention (the encoder-decoder, ``attention_block(...,
cross_kv=(k, v))``) takes the encoder's keys and values as given, biases
added (``Model._cross_kv``), projects only the queries, writes no cache
and attends over every key (``causal=False``); ``causal=False`` without
``cross_kv`` is the encoder's bidirectional self-attention.  Both take
the flash kernel at prefill (non-causal: the kernel's left-aligned query
positions then mask nothing), and cross-attention stays on the plain
route in decode.  Positions of that family are absolute and sinusoidal
(``sinusoidal_positions``), added to the inputs.
Tensor parallelism (a model axis of n > 1 places, ``shardctx.
tensor_parallel()``, which ``launch.sharding.mesh_rules`` installs): a
place holds the blocks of ``launch.sharding.shard_params`` and its own
batch rows, and reads each block by ``tp.layout`` (``launch.sharding.
tp_layout``, from the same specs); without it every layout is whole and
the same code runs with the identity for its gathers and sums.
  * Attention heads over the model axis where they divide it, else
    head_dim (q and ``wo`` by the query heads, k and v by the kv heads).
    A head_dim cut is gathered back to whole heads (``tp.gather``, rank
    order) before the biases, qk-norm and rotary embedding, which read
    the whole head.  Head-sharded q with
    head-sharded k and v attends the place's own heads (the GQA groups
    line up); head-sharded q with whole or head_dim-sharded k and v takes
    the kv heads of its own q heads.  Where the query heads do not divide
    n, the query sequence divides it and ``cfg.attn_impl == "chunked"``,
    attention is ``context_parallel`` as in the reference: every place
    holds q, k and v whole, attends its S/n query rows from row
    r S/n (on the flash route one launch with ``q_offset``) against every
    key, and the rows are gathered back in rank order.  Otherwise (decode,
    Sq = 1) a head_dim-sharded q reduces the score over head_dim: each
    place's partial q.k of its head_dim slice, their ordered sum, the
    softmax, and the place's head_dim slice of the output.
  * The output projection ``wo`` (rows of the place's heads or head_dim
    slice) and an MLP's ``wd`` (rows of its columns) give partial sums,
    added in rank order (``tp.sum``, float32 accumulation for bfloat16)
    where the reference has one all-reduce; ``bd`` is added once, after
    the sum.
  * A KV cache holds the place's kv heads, or its head_dim slice of every
    kv head (``launch.sharding.cache_specs``), written in place as without
    a mesh; cross-attention reads the encoder's (k, v) projected to the
    place's block (``Model._cross_kv``).
  * MLA (``mla_block``): the place's heads of the up-projections and of
    ``wo``; the latent cache cut over r (and k_rope's over dr), gathered
    back to whole over its written prefix where the absorbed form attends
    it.
  * Training (``launch.mesh``'s gradient convention): every whole tensor
    that meets the place's block or slice is ``tp.enter``-ed first, its
    backward the ordered sum of the places' cotangents: x into cut
    projections (once for q, k and v), a whole qk-norm scale on the
    place's heads, whole k and v cut to the place's kv heads, q, k and v
    into context parallel's rows, a whole output cut to a head_dim slice,
    MLA's latent and rotary key into the place's heads, the MLP's x.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import elementwise as EW
from ..kernels.flash_attention import flash_attention
from .shardctx import ONE, tensor_parallel

__all__ = ["NEG_INF", "apply_norm", "rms_head_norm", "rope_freqs",
           "apply_rope", "sinusoidal_positions", "sinusoidal_on",
           "init_norm", "init_attention", "attention", "q_projection",
           "qkv_projection", "attention_block", "init_mla",
           "mla_projection", "mla_qkv", "mla_block", "init_mlp",
           "apply_mlp", "silu_stepwise", "gelu_stepwise"]

NEG_INF = -1e30


# --------------------------------------------------------------------- init
def _dense_init(gen: torch.Generator, shape, scale_axis, dtype, device,
                keep=None, name=None):
    """Normal(0, 1/fan_in) drawn on ``device`` from ``gen``, in ``dtype``
    (the reference's ``_dense_init`` scale; other numbers than
    ``jax.random`` for the same seed); passed to ``keep`` as ``name``
    where it is given (``kept``)."""
    axes = (scale_axis,) if isinstance(scale_axis, int) else scale_axis
    fan_in = int(np.prod([shape[a] for a in axes]))
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return kept(keep, name, w.mul_(1.0 / math.sqrt(fan_in)))


def kept(keep, name, t):
    """``keep((name,), t)``: what the caller of ``Model.init(keep=)``
    keeps of the tensor just drawn (a rank's block of it), so that the
    whole tensor can be freed before the next draw; ``t`` without
    ``keep``."""
    return t if keep is None else keep((name,), t)


def sub_keep(keep, *prefix):
    """``keep`` of a sub-tree at ``prefix`` (keys and list indices): the
    paths it is handed are taken from the sub-tree's root."""
    if keep is None:
        return None
    return lambda path, t: keep(prefix + tuple(path), t)


# --------------------------------------------------------------------- norms
def init_norm(cfg, device):
    D = cfg.d_model
    p = {"scale": torch.ones(D, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm" and cfg.use_bias:
        p["bias"] = torch.zeros(D, dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    """Norm with float32 statistics and elementwise math in x.dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        out = x * inv * p["scale"].to(x.dtype)
    else:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        out = (x - mu.to(x.dtype)) * inv * p["scale"].to(x.dtype)
        if "bias" in p:
            out = out + p["bias"].to(x.dtype)
    return out.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm (qwen3): normalize the trailing head_dim."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class _StepwiseSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return EW.silu_stepwise(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.float()
        s = torch.sigmoid(xf)
        return (g.float() * s * (1 + xf * (1 - s))).to(g.dtype)


class _StepwiseGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return EW.gelu_stepwise(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(
            g.float(), x.float(), approximate="tanh").to(g.dtype)


def silu_stepwise(x):
    """silu(x) = x * sigmoid(x) with the sigmoid as the reference computes
    it: ``jax.nn.sigmoid`` is ``lax.logistic``, which XLA expands to
    1 / (1 + exp(-x)) with each operation rounded to x.dtype.  In bfloat16
    ``F.silu`` (one rounding) parts from it by an ulp in about 40% of
    entries, which the recurrent blocks' per-head RMS norms amplify.  On
    the card it is one launch of the ``elementwise`` kernel
    (``kernels.elementwise.silu_stepwise``), on the CPU that kernel's plain
    version, the chain of ATen ops.  The backward is silu's derivative in
    float32 (the chain's own would give 0 * inf where exp overflows)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return EW.silu_stepwise(x)
    return _StepwiseSilu.apply(x)


def gelu_stepwise(x):
    """``jax.nn.gelu(x)`` (the tanh form, its default) with each operation
    rounded to x.dtype, as XLA computes it; ``F.gelu(approximate="tanh")``
    rounds once and parts from it in about 40% of bfloat16 entries.  One
    launch of the ``elementwise`` kernel on the card, its plain version on
    the CPU; the backward is the tanh form's derivative in float32."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return EW.gelu_stepwise(x)
    return _StepwiseGelu.apply(x)


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # made once per device: a copy from host memory at every call would
    # block the host until the device drains, twice a layer
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) with positions (..., S)."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float()[..., None, :] * freqs  # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int) -> torch.Tensor:
    """(seq, d_model) float32 absolute positions (sin on even columns, cos
    on odd), on the host: the reference's numpy table, bit for bit."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / (10000 ** (dim / d_model))
    out = np.zeros((seq, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


_SINUSOIDAL_ON: dict[tuple[int, torch.device], torch.Tensor] = {}


def sinusoidal_on(seq: int, d_model: int, device: torch.device):
    """The first ``seq`` rows of ``sinusoidal_positions`` on ``device``: a
    view of one table per (d_model, device), made again, at least twice as
    long, only when a longer one is asked for (a row does not depend on
    the table's length).  A copy from host memory at every decode step
    would block the host until the device drains."""
    key = (d_model, torch.device(device))
    table = _SINUSOIDAL_ON.get(key)
    if table is None or table.shape[0] < seq:
        n = seq if table is None else max(seq, 2 * table.shape[0])
        table = _SINUSOIDAL_ON[key] = sinusoidal_positions(
            n, d_model).to(device)
    return table[:seq]


# ----------------------------------------------------------------- attention
def init_attention(gen, cfg, dtype, device, keep=None):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, keep=keep)
    p = {
        "wq": _dense_init(gen, (D, H, hd), 0, name="wq", **kw),
        "wk": _dense_init(gen, (D, KV, hd), 0, name="wk", **kw),
        "wv": _dense_init(gen, (D, KV, hd), 0, name="wv", **kw),
        "wo": _dense_init(gen, (H, hd, D), (0, 1), name="wo", **kw),
    }
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.use_bias:
        p["bq"] = torch.zeros((H, hd), **f32)
        p["bk"] = torch.zeros((KV, hd), **f32)
        p["bv"] = torch.zeros((KV, hd), **f32)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, **f32)
        p["k_norm"] = torch.ones(hd, **f32)
    return p


def _scores_mask(q_pos, k_pos, window, causal: bool):
    """(..., Sq, Skv) additive float32 mask from position vectors."""
    ok = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= k_pos[..., None, :] > q_pos[..., :, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _sdpa(q, k, v, mask, dtype):
    """q (B,Sq,H,dh) k/v (B,Skv,KV,dh) -> (B,Sq,H,dh); GQA via head
    grouping.  Scores from a product in the compute dtype, softmax in
    float32, probabilities rounded to ``dtype`` before the PV product."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, dh).permute(0, 2, 3, 1, 4)    # (B,KV,G,Sq,dh)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                     # (B,KV,1,dh,Skv)
    scores = torch.matmul(qg, kt).float()
    scores = scores / math.sqrt(dh) + mask[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3)[:, :, None])  # (B,KV,G,Sq,dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1])


def attention(q, k, v, *, q_positions, k_positions, causal=True,
              window=None, impl="chunked", chunk=1024, dtype=torch.bfloat16):
    """Masked GQA attention; chunked over queries when impl == 'chunked'."""
    B, Sq = q.shape[:2]
    if impl == "naive" or Sq <= chunk:
        mask = _scores_mask(q_positions, k_positions, window, causal)
        return _sdpa(q, k, v, mask, dtype)
    while Sq % chunk:  # non-multiple sequence
        chunk //= 2
        if chunk < 64:
            mask = _scores_mask(q_positions, k_positions, window, causal)
            return _sdpa(q, k, v, mask, dtype)

    def one_chunk(qc, qp):
        mask = _scores_mask(qp, k_positions, window, causal)
        return _sdpa(qc, k, v, mask, dtype)

    remat = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    outs = []
    for c in range(Sq // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (q[:, sl], q_positions[:, sl])
        outs.append(checkpoint(one_chunk, *args, use_reentrant=False)
                    if remat else one_chunk(*args))
    return torch.cat(outs, dim=1)


def _project(x, w, b, lay, tp, dtype):
    """x (B,S,D) through a (D, heads, hd) projection block and its bias:
    (B,S,heads,hd), the place's heads where ``lay`` is "heads"; where it
    is "hd" the place's head_dim slice, gathered to whole heads in rank
    order before the bias (whole then) is added."""
    B, S, D = x.shape
    h, d = w.shape[1], w.shape[2]
    y = (x @ w.to(dtype).reshape(D, h * d)).view(B, S, h, d)
    if lay == "hd":
        y = tp.gather(y, dim=3)
    if b is not None:
        y = y + b.to(dtype)
    return y


def q_projection(p, x, cfg, dtype=torch.bfloat16, entered=None):
    """q (B,S,H,dh) of an attention sub-block before any rotary embedding:
    the projection, its bias and qk-norm (cross-attention's whole query;
    the place's heads, or whole heads, under tensor parallelism, x then
    ``tp.enter``-ed, or ``entered``, the caller's)."""
    tp = tensor_parallel() or ONE
    lay = tp.layout.get("q")
    if lay is not None:
        x = tp.enter(x) if entered is None else entered
    xq = _project(x, p["wq"], p.get("bq"), lay, tp, dtype)
    if cfg.qk_norm:
        # a whole scale on the place's heads is entered too
        xq = rms_head_norm(tp.enter(p["q_norm"]) if lay == "heads"
                           else p["q_norm"], xq)
    return xq


def qkv_projection(p, x, cfg, positions, dtype=torch.bfloat16):
    """q (B,S,H,dh), k and v (B,S,KV,dh) of an attention sub-block: the
    projections, biases, qk-norm and rotary embedding."""
    tp = tensor_parallel() or ONE
    lay = tp.layout.get("kv")
    # x meets the place's blocks: entered once for every cut projection
    xe = tp.enter(x) if lay is not None or tp.layout.get("q") else x
    xq = q_projection(p, x, cfg, dtype, entered=xe)
    if lay is not None:
        x = xe
    xk = _project(x, p["wk"], p.get("bk"), lay, tp, dtype)
    xv = _project(x, p["wv"], p.get("bv"), lay, tp, dtype)
    if cfg.qk_norm:
        xk = rms_head_norm(tp.enter(p["k_norm"]) if lay == "heads"
                           else p["k_norm"], xk)
    if cfg.rope_theta:
        xq = apply_rope(xq, positions, cfg.rope_theta)
        xk = apply_rope(xk, positions, cfg.rope_theta)
    return xq, xk, xv


def _kv_for_q_heads(k, v, h0: int, hq: int, G: int):
    """The kv heads of query heads h0 .. h0 + hq - 1 (GQA group G) from k, v
    holding every kv head: a slice where the groups line up, else one kv
    head a query head (index_select)."""
    if hq % G == 0:
        sl = slice(h0 // G, h0 // G + hq // G)
        return k[:, :, sl], v[:, :, sl]
    if G % hq == 0 and h0 // G == (h0 + hq - 1) // G:
        sl = slice(h0 // G, h0 // G + 1)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(h0, h0 + hq, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _sdpa_hd(q, k, v, mask, dtype, hd: int, tp):
    """``_sdpa`` over a head_dim cut: q (B,Sq,H,hd/n), k and v (B,Skv,KV,
    hd/n) the place's slices; the partial scores of the slice summed over
    the places in rank order, then the scale (of the whole head_dim), the
    mask, the softmax, and the place's slice of the output (B,Sq,H,hd/n)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, dh).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]
    scores = tp.sum(torch.matmul(qg, kt)).float()
    scores = scores / math.sqrt(hd) + mask[:, None, None]
    # whole probabilities against the place's slice of v
    probs = tp.enter(torch.softmax(scores, dim=-1).to(dtype))
    out = torch.matmul(probs, v.permute(0, 2, 1, 3)[:, :, None])
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1])


def attention_block(p, x, cfg, positions, *, kv_cache=None, cache_len=None,
                    cross_kv=None, causal=True, dtype=torch.bfloat16,
                    flash=False):
    """Attention sub-block: qkv proj -> rope -> (cache) -> attention -> out
    proj; causal self-attention unless told otherwise.

    kv_cache: optional dict {"k","v"} (B, Smax, KV, dh), written IN PLACE
    at ``cache_len`` (a Python int; the reference returns a new cache, the
    port saves the copy).  With ``"kpos"`` (Smax,) int32 it is the SWA
    ring buffer: the token at position ``cache_len`` goes to slot
    ``cache_len % Smax``, its position to ``kpos``, and the keys' positions
    are read from ``kpos`` (empty slots hold -2**30, outside every
    window).  A ring takes S == 1 only: the reference's
    ``dynamic_update_slice`` would clamp a longer write's slot.
    cross_kv: precomputed (k, v), (B, Se, KV, dh) with their biases
    (cross-attention): only q is projected (no rotary), no cache is
    written, and every one of the Se keys is attended (non-causal).
    causal=False without ``cross_kv``: bidirectional self-attention (the
    encoder's).
    ``flash=True`` routes the attention to the flash kernel; the caller
    sets it only where positions are ``arange`` from 0 and the cache is
    written from slot 0 (prefill).
    Under tensor parallelism the blocks are read by ``tp.layout`` (the
    module docstring); without it every layout is whole and the gathers
    and sums are the identity.
    """
    tp = tensor_parallel() or ONE
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ring = kv_cache is not None and "kpos" in kv_cache
    # whether xk, xv hold only the place's head_dim slice of every kv head
    # (a cache or the cross (k, v) cut by head_dim), not whole heads
    kv_slice = False
    if cross_kv is not None:
        xq = q_projection(p, x, cfg, dtype)
        xk, xv = cross_kv
        kv_slice = tp.layout.get("cache") == "hd"
        causal = False
        k_positions = torch.arange(xk.shape[1], device=x.device).expand(
            B, xk.shape[1])
    else:
        if ring and (S != 1 or flash):
            raise ValueError(f"the SWA ring cache takes one token a call "
                             f"(decode), not S={S}" + (
                                 " on the flash route" if flash else ""))
        xq, xk, xv = qkv_projection(p, x, cfg, positions, dtype)
        k_positions = positions
        if kv_cache is not None:
            # the cache holds the place's kv heads, or its head_dim slice
            # of every kv head, as the weights are cut
            hd_cut = tp.layout.get("cache") == "hd"
            own = tp.cut(hd) if hd_cut else slice(None)
            ck, cv = kv_cache["k"], kv_cache["v"]
            Smax = ck.shape[1]
            if ring:
                slot = cache_len % Smax
                ck[:, slot] = xk[:, 0, :, own].to(ck.dtype)
                cv[:, slot] = xv[:, 0, :, own].to(cv.dtype)
                kv_cache["kpos"][slot] = cache_len
                k_positions = kv_cache["kpos"].expand(B, Smax)
            else:
                ck[:, cache_len:cache_len + S] = xk[..., own].to(ck.dtype)
                cv[:, cache_len:cache_len + S] = xv[..., own].to(cv.dtype)
                # unwritten slots pushed past every query
                k_positions = torch.arange(Smax, device=x.device).expand(
                    B, Smax)
                k_positions = torch.where(k_positions < cache_len + S,
                                          k_positions, 2**30)
            if flash:
                if cache_len != 0:
                    raise ValueError(
                        "flash=True needs cache_len == 0 (prefill)")
                # q and k positions are both 0..S-1; the cache slots past
                # S are masked by causality, so the fresh keys are all it
                # needs
                k_positions = positions
            else:
                xk, xv = ck.to(dtype), cv.to(dtype)
                kv_slice = hd_cut

    def whole_heads(k, v):
        if not kv_slice:
            return k, v
        return tp.gather(k, dim=3), tp.gather(v, dim=3)

    def attend(q, k, v, q_pos, q_offset=0):
        if flash:
            return flash_attention(q, k, v, causal=causal,
                                   window=cfg.swa_window, q_offset=q_offset)
        return attention(q, k, v, q_positions=q_pos, k_positions=k_positions,
                         causal=causal, window=cfg.swa_window,
                         impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                         dtype=dtype)

    # a whole tensor that meets the place's heads, rows or slice is
    # ``tp.enter``-ed first (its backward sums the places' cotangents)
    q_lay = tp.layout.get("q")
    if q_lay == "heads":
        hq = xq.shape[2]
        xk, xv = whole_heads(xk, xv)
        if xk.shape[2] == KV:
            xk, xv = _kv_for_q_heads(tp.enter(xk), tp.enter(xv),
                                     tp.rank * hq, hq, H // KV)
        out = attend(xq, xk, xv, positions)
    elif tp.n > 1 and S % tp.n == 0 and cfg.attn_impl == "chunked":
        # context_parallel: the place's query rows against every key
        rows = tp.cut(S)
        xk, xv = whole_heads(xk, xv)
        out = attend(tp.enter(xq)[:, rows], tp.enter(xk), tp.enter(xv),
                     positions[:, rows], q_offset=rows.start)
        out = tp.gather(out, dim=1)
    elif q_lay == "hd":
        # the head_dim reduction of the score (decode)
        own = tp.cut(hd)
        if not kv_slice:
            xk, xv = tp.enter(xk)[..., own], tp.enter(xv)[..., own]
        mask = _scores_mask(positions, k_positions, cfg.swa_window, causal)
        out = _sdpa_hd(tp.enter(xq)[..., own], xk, xv, mask, dtype, hd, tp)
    else:
        xk, xv = whole_heads(xk, xv)
        out = attend(xq, xk, xv, positions)
    o_lay = tp.layout.get("o")
    if o_lay == "hd" and out.shape[3] == hd:
        out = tp.enter(out)[..., tp.cut(hd)]
    y = out.reshape(B, S, -1) @ p["wo"].to(dtype).reshape(-1, D)
    return y if o_lay is None else tp.sum(y)


# ----------------------------------------------------------------- MLA
def init_mla(gen, cfg, dtype, device, keep=None):
    """The low-rank query path (wq_a, q_a_norm, wq_b), the latent kv path
    (wkv_a, kv_a_norm) and the up-projections of the latent to per-head
    keys (wk_b) and values (wv_b), and wo, at the reference's scales; the
    norm scales float32."""
    D, H = cfg.d_model, cfg.num_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(dtype=dtype, device=device, keep=keep)
    return {
        "wq_a": _dense_init(gen, (D, r_q), 0, name="wq_a", **kw),
        "q_a_norm": torch.ones(r_q, **f32),
        "wq_b": _dense_init(gen, (r_q, H, dn + dr), 0, name="wq_b", **kw),
        "wkv_a": _dense_init(gen, (D, r_kv + dr), 0, name="wkv_a", **kw),
        "kv_a_norm": torch.ones(r_kv, **f32),
        "wk_b": _dense_init(gen, (r_kv, H, dn), 0, name="wk_b", **kw),
        "wv_b": _dense_init(gen, (r_kv, H, dv), 0, name="wv_b", **kw),
        "wo": _dense_init(gen, (H, dv, D), (0, 1), name="wo", **kw),
    }


def mla_projection(p, x, cfg, positions, dtype=torch.bfloat16):
    """q_nope (B,S,H,dn), q_rope (B,S,H,dr) with rotary, the normalised
    latent c_kv (B,S,r_kv) and the rotary key k_rope (B,S,dr); H the heads
    of the ``wq_b`` block (a place's, under tensor parallelism)."""
    B, S, D = x.shape
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn = cfg.head_dim
    H, dq = p["wq_b"].shape[1:]
    q_lat = apply_norm({"scale": p["q_a_norm"]}, x @ p["wq_a"].to(dtype),
                       "rmsnorm")
    tp = tensor_parallel()
    if tp is not None and tp.layout.get("mla"):
        q_lat = tp.enter(q_lat)     # into the place's heads of wq_b
    q = (q_lat @ p["wq_b"].to(dtype).reshape(r_q, H * dq)).view(B, S, H, dq)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"].to(dtype)
    c_kv = apply_norm({"scale": p["kv_a_norm"]}, kv_a[..., :r_kv], "rmsnorm")
    k_rope = apply_rope(kv_a[:, :, None, r_kv:], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_qkv(p, q_nope, q_rope, c_kv, k_rope, dtype=torch.bfloat16):
    """The per-head q, k (B,S,H,dn+dr) and v (B,S,H,dv) rebuilt from the
    latent, contiguous: k's rotary part is k_rope written out for every
    head (the flash kernel's TMA takes no zero stride)."""
    B, S, r_kv = c_kv.shape
    H, dn = q_nope.shape[2], q_nope.shape[3]
    dv = p["wv_b"].shape[2]
    k_nope = (c_kv @ p["wk_b"].to(dtype).reshape(r_kv, H * dn)).view(
        B, S, H, dn)
    v = (c_kv @ p["wv_b"].to(dtype).reshape(r_kv, H * dv)).view(B, S, H, dv)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, -1)], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


def _mla_absorbed(p, q_nope, q_rope, c_all, kr_all, q_pos, valid, scale,
                  dtype):
    """The reference's absorbed attention of queries (B,Sq,H,.) against the
    latent cache (B,Smax,.): scores (q_nope W_uk) c + q_rope k_rope, each
    product in ``dtype`` and summed in float32, the mask ``valid`` &
    causal, softmax in float32, probabilities in ``dtype``, the context
    through W_uv -> (B,Sq,H,dv)."""
    Smax = c_all.shape[1]
    k_pos = torch.arange(Smax, device=c_all.device)
    ok = valid[None, None, :] & (k_pos[None, None, :] <= q_pos[:, :, None])
    mask = torch.where(ok, 0.0, NEG_INF)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(dtype))
    scores = torch.einsum("bshr,btr->bhst", q_abs, c_all).float()
    scores += torch.einsum("bshk,btk->bhst", q_rope, kr_all)
    # in place: a full-width chunk's float32 scores are 4.3 GB
    scores.div_(scale).add_(mask[:, None])
    probs = torch.softmax(scores, dim=-1).to(dtype)
    del scores
    ctx = torch.einsum("bhst,btr->bshr", probs, c_all)
    return torch.einsum("bshr,rhv->bshv", ctx, p["wv_b"].to(dtype))


def _mla_window(cache, c_kv, k_rope, cache_len: int, tp, dtype):
    """The latent window the absorbed form attends, in ``dtype``, and its
    valid slots: the whole cache as it stands, or, where a place holds
    only its r (or dr) slice of it, the written prefix: the slots before
    ``cache_len`` gathered over the model axis in rank order (none at
    prefill), then the fresh c_kv and k_rope, which every place computes
    whole (rounded to the cache's dtype as the cache holds them)."""
    cc, cr = cache["c_kv"], cache["k_rope"]
    lat, rope = tp.layout.get("latent"), tp.layout.get("rope")
    if not (lat or rope):
        valid = torch.arange(cc.shape[1], device=cc.device) < \
            cache_len + c_kv.shape[1]
        return cc.to(dtype), cr.to(dtype), valid
    parts = []
    for past, fresh, cut in ((cc, c_kv, lat), (cr, k_rope, rope)):
        past = past[:, :cache_len]
        if cut and cache_len:
            past = tp.gather(past, dim=2)
        parts.append(torch.cat([past, fresh.to(past.dtype)], dim=1).to(dtype))
    valid = torch.ones(parts[0].shape[1], dtype=torch.bool,
                       device=cc.device)
    return parts[0], parts[1], valid


def mla_block(p, x, cfg, positions, *, cache=None, cache_len=None,
              dtype=torch.bfloat16, flash=False):
    """DeepSeek-V2 multi-head latent attention.

    cache: optional dict {"c_kv" (B,Smax,r_kv), "k_rope" (B,Smax,dr)},
    written IN PLACE at ``cache_len`` (a Python int), then attended in the
    absorbed form, over query chunks of ``cfg.attn_chunk`` when
    ``cfg.attn_impl == "chunked"`` (each element's value is the unchunked
    one; at full width the unchunked float32 scores would take 17 GB).
    Without a cache (training): per-head k and v rebuilt and ``attention``.
    ``flash=True`` (the caller sets it only where positions are ``arange``
    from 0 and the cache is written from slot 0): the cache written, k and
    v rebuilt, one flash kernel launch at (dn + dr, dv).
    Under tensor parallelism (``tp.layout``: "mla", "o", "latent",
    "rope"): the place's heads of ``wq_b``, ``wk_b``, ``wv_b`` and ``wo``
    (or ``wo``'s dv rows where the heads do not divide the model axis);
    c_kv and k_rope are computed whole (``wkv_a`` is whole) and the place
    writes its r slice of c_kv and its dr slice of k_rope to its cache
    block; the absorbed form attends the latent prefix gathered back to
    whole (``_mla_window``); the ``wo`` partials are added in rank order."""
    tp = tensor_parallel() or ONE
    B, S, D = x.shape
    r_kv, dr, dv = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    if flash and cache is not None and cache_len != 0:
        raise ValueError("flash=True needs cache_len == 0 (prefill)")
    q_nope, q_rope, c_kv, k_rope = mla_projection(p, x, cfg, positions,
                                                  dtype)
    if tp.layout.get("mla"):
        # the whole latent and rotary key meet the place's heads
        c_kv, k_rope = tp.enter(c_kv), tp.enter(k_rope)
    if cache is not None:
        r_own = tp.cut(r_kv) if tp.layout.get("latent") else slice(None)
        d_own = tp.cut(dr) if tp.layout.get("rope") else slice(None)
        cache["c_kv"][:, cache_len:cache_len + S] = c_kv[..., r_own].to(
            cache["c_kv"].dtype)
        cache["k_rope"][:, cache_len:cache_len + S] = k_rope[..., d_own].to(
            cache["k_rope"].dtype)
    if flash:
        q, k, v = mla_qkv(p, q_nope, q_rope, c_kv, k_rope, dtype)
        out = flash_attention(q, k, v, causal=True)
    elif cache is not None:
        c_all, kr_all, valid = _mla_window(cache, c_kv, k_rope, cache_len,
                                           tp, dtype)
        chunk = cfg.attn_chunk if cfg.attn_impl == "chunked" else S
        scale = math.sqrt(cfg.head_dim + dr)
        out = torch.cat([
            _mla_absorbed(p, q_nope[:, c:c + chunk], q_rope[:, c:c + chunk],
                          c_all, kr_all, positions[:, c:c + chunk], valid,
                          scale, dtype)
            for c in range(0, S, chunk)], dim=1)
    else:
        q, k, v = mla_qkv(p, q_nope, q_rope, c_kv, k_rope, dtype)
        out = attention(q, k, v, q_positions=positions, k_positions=positions,
                        causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                        dtype=dtype)
    o_lay = tp.layout.get("o")
    if o_lay == "hd":
        out = tp.enter(out)[..., tp.cut(dv)]
    y = out.reshape(B, S, -1) @ p["wo"].to(dtype).reshape(-1, D)
    return y if o_lay is None else tp.sum(y)


# ----------------------------------------------------------------- MLPs
def init_mlp(gen, cfg, dtype, device, keep=None):
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device, keep=keep)
    if cfg.mlp == "swiglu":
        return {
            "wg": _dense_init(gen, (D, Fd), 0, name="wg", **kw),
            "wu": _dense_init(gen, (D, Fd), 0, name="wu", **kw),
            "wd": _dense_init(gen, (Fd, D), 0, name="wd", **kw),
        }
    p = {"wi": _dense_init(gen, (D, Fd), 0, name="wi", **kw),
         "wd": _dense_init(gen, (Fd, D), 0, name="wd", **kw)}
    if cfg.use_bias:
        p["bi"] = torch.zeros(Fd, dtype=torch.float32, device=device)
        p["bd"] = torch.zeros(D, dtype=torch.float32, device=device)
    return p


def apply_mlp(p, x, kind: str, dtype=torch.bfloat16, role: str = "mlp"):
    """The MLP of ``kind``.  Under tensor parallelism where ``role``'s
    layout ("mlp", or "shared" for the shared experts) is cut: ``wg``,
    ``wu``, ``wi`` and ``bi`` by column, ``wd`` by row, the partial
    outputs added in rank order, then ``bd``."""
    tp = tensor_parallel()
    if tp is not None and tp.layout.get(role):
        x = tp.enter(x)     # whole x into the place's columns
    if kind == "swiglu":
        g = x @ p["wg"].to(dtype)
        u = x @ p["wu"].to(dtype)
        h = silu_stepwise(g) * u
    else:
        h = x @ p["wi"].to(dtype)
        if "bi" in p:
            h = h + p["bi"].to(dtype)
        if kind == "squared_relu":
            h = torch.square(F.relu(h))
        else:  # gelu (tanh approximation, as jax.nn.gelu's default)
            h = gelu_stepwise(h)
    out = h @ p["wd"].to(dtype)
    if tp is not None and tp.layout.get(role):
        out = tp.sum(out)
    if "bd" in p:
        out = out + p["bd"].to(dtype)
    return out
