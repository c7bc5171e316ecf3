"""xLSTM blocks: mLSTM (matrix memory; a parallel form chunked over queries
for training and the loss, a recurrent step for decode) and sLSTM (scalar
memory with exponential gating; a recurrence over the sequence).

The port of ``repro/models/xlstm.py``.  mLSTM, stabilised:
    C_t = f_t C_{t-1} + i_t v_t k_t^T,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t)).
Its parallel form weighs source j at query i by
    w_ij = exp(li_j + F_i - F_j - m_i),  F = cumsum(log f),
m_i = max(row max, 0), over query chunks of ``chunk`` (one L x L chunk
when L is not a multiple of it); where autograd records it each chunk is
recomputed in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``).

Dtypes as in the reference: the input and forget gates (``w_i``, ``w_f``,
their biases), every sLSTM input projection ``w_{i,f,z,o}`` and recurrent
``r_*``, the per-head ``out_norm`` and the recurrent states are float32;
``wq``, ``wk``, ``wv``, ``wz`` and both blocks' ``wo`` are used in the
compute dtype.  The query is scaled by 1/sqrt(dh) in float32 (the
reference divides by a NumPy scalar, which promotes), so the parallel
form's scores are a float32 product.  The output gate's silu rounds each
operation of its sigmoid as the reference's does
(``layers.silu_stepwise``).
The sLSTM recurrence is a Python loop over the sequence, as the
reference's is a ``lax.scan``: no kernel exists for it in either package.
A step is about 20 launches of PyTorch's own kernels (forward), so a
training step at 1,024 tokens is launch-bound on the card.
Tensor parallelism (the model axis's ``tp``, ``launch.sharding.
tp_layout``): an mLSTM place holds a dv slice of every head (``wv``,
``wz``, ``out_norm``, the rows of ``wo``, the C state) and q, k, the gates
and n whole, so the parallel form and the step need no collective; the
per-head norm's sum of squares (over dv, the cut dim) and the ``wo``
partials are added over the places in rank order.  The sLSTM recurrence
runs whole on every place, which holds the dh rows of ``wo``.  Where
autograd records (the train step over a mesh), every whole tensor that
meets the place's slice (x into ``wv`` and ``wz``; q, k, the cumulative
forget gate and the input gate into the parallel form; the summed norm;
the sLSTM's hidden states into ``wo``'s rows) is ``tp.enter``-ed, so
its backward sums the places' cotangents (``launch.mesh``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import _dense_init, kept, silu_stepwise
from .shardctx import ONE, tensor_parallel

__all__ = ["NEG", "init_mlstm", "mlstm_block", "init_slstm", "slstm_block"]

NEG = -1e30
_GATES = ("i", "f", "z", "o")


def init_mlstm(gen, cfg, dtype, device, keep=None):
    """An mLSTM block's parameters: ``wq``, ``wk``, ``wv``, ``wz`` (D, H,
    dh) and ``wo`` (H, dh, D) in ``dtype``; the gates ``w_i``, ``w_f``
    (D, H), ``b_i`` (zeros), ``b_f`` (3: open forget gates) and
    ``out_norm`` (H, dh) float32.  ``keep``: see ``layers.kept``."""
    D, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    p = {w: _dense_init(gen, (D, H, dh), 0, dtype, device, keep=keep,
                        name=w)
         for w in ("wq", "wk", "wv", "wz")}
    p.update(w_i=_dense_init(gen, (D, H), 0, torch.float32, device,
                             keep=keep, name="w_i"),
             w_f=_dense_init(gen, (D, H), 0, torch.float32, device,
                             keep=keep, name="w_f"),
             b_i=torch.zeros(H, **f32), b_f=torch.full((H,), 3.0, **f32),
             out_norm=torch.ones((H, dh), **f32),
             wo=_dense_init(gen, (H, dh, D), (0, 1), dtype, device,
                            keep=keep, name="wo"))
    return p


def _heads(x, w, dtype):
    """x (B, L, D) @ w (D, H, dh) in ``dtype``: (B, L, H, dh)."""
    B, L, D = x.shape
    return (x @ w.to(dtype).reshape(D, -1)).view(B, L, *w.shape[1:])


def _out(p, y, z, dtype, tp=None, dh: int = 0):
    """The per-head RMS norm (float32 statistics), the output gate silu(z)
    and the output projection: (B, L, H, dv) -> (B, L, D).  ``tp``: the
    place holds a dv slice of every head (the model axis's ``tp``, dh the
    whole head's width): the norm's sum of squares is added over the
    places in rank order, and so are the ``wo`` partials."""
    B, L, H, dv = y.shape
    yf = y.float()
    if tp is None:
        var = (yf * yf).mean(dim=-1, keepdim=True)
    else:
        # whole over the places, then against the place's slice of y
        var = tp.enter(tp.sum((yf * yf).sum(dim=-1, keepdim=True)) / dh)
    y = (yf * torch.rsqrt(var + 1e-6) * p["out_norm"]).to(dtype)
    y = y * silu_stepwise(z)
    out = y.reshape(B, L, H * dv) @ p["wo"].to(dtype).reshape(H * dv, -1)
    return out if tp is None else tp.sum(out)


def _mlstm_chunk(q, k, v, F_, li, start: int, cq: int, dtype):
    """Queries start..start+cq of the parallel form against every key:
    (B, cq, H, dh)."""
    L = k.shape[1]
    qc, Fc = q[:, start:start + cq], F_[:, start:start + cq]
    # log weight li_j + F_i - F_j, causal: (B, H, cq, L)
    lw = (Fc[:, :, None] - F_[:, None, :] + li[:, None, :]).permute(0, 3, 1, 2)
    pos_q = torch.arange(start, start + cq, device=q.device)
    causal = pos_q[:, None] >= torch.arange(L, device=q.device)[None, :]
    lw = torch.where(causal, lw, torch.full_like(lw, NEG))
    m = torch.maximum(torch.amax(lw, dim=-1, keepdim=True),
                      torch.zeros((), device=lw.device))
    w = torch.exp(lw - m)
    scores = torch.einsum("bihk,bjhk->bhij", qc, k.float())
    ws = w * scores
    y = torch.einsum("bhij,bjhk->bihk", ws.to(dtype), v)
    denom = torch.maximum(torch.abs(ws.sum(dim=-1)), torch.exp(-m[..., 0]))
    return y / denom.transpose(1, 2)[..., None].to(dtype)


def mlstm_block(p, x, cfg, *, state=None, chunk=1024, dtype=torch.bfloat16):
    """x (B, L, D) -> (out (B, L, D), state).  Without a state and L > 1 the
    parallel form (state None); else the recurrent step from ``state`` (C
    (B, H, dh, dh), n (B, H, dh), m (B, H), float32; zeros when None) over
    one token, returning the new (C, n, m)."""
    B, L, D = x.shape
    dh = cfg.head_dim
    tp = tensor_parallel()
    if tp is not None and not tp.layout.get("mlstm"):
        tp = None
    q = _heads(x, p["wq"], dtype).float() / math.sqrt(dh)
    k = _heads(x, p["wk"], dtype)
    # x into the place's value-dim blocks of wv and wz
    xe = x if tp is None else tp.enter(x)
    v = _heads(xe, p["wv"], dtype)
    z = _heads(xe, p["wz"], dtype)
    xf = x.float()
    li = xf @ p["w_i"] + p["b_i"]                             # log input gate
    lf = F.logsigmoid(xf @ p["w_f"] + p["b_f"])

    new_state = None
    if state is None and L > 1:
        F_ = torch.cumsum(lf, dim=1)                          # (B, L, H)
        if tp is not None:
            # whole, against the place's value-dim slice of v
            q, k, F_, li = (tp.enter(t) for t in (q, k, F_, li))
        nq = max(1, L // chunk) if L % chunk == 0 else 1
        cq = L // nq
        remat = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, li, lf))
        outs = []
        for c in range(nq):
            args = (q, k, v, F_, li, c * cq, cq, dtype)
            outs.append(checkpoint(_mlstm_chunk, *args, use_reentrant=False)
                        if remat else _mlstm_chunk(*args))
        y = torch.cat(outs, dim=1)
    else:
        if state is None:
            H = cfg.num_heads
            f32 = dict(dtype=torch.float32, device=x.device)
            C0 = torch.zeros((B, H, v.shape[-1], dh), **f32)
            n0 = torch.zeros((B, H, dh), **f32)
            m0 = torch.zeros((B, H), **f32)
        else:
            C0, n0, m0 = state
        lf0, li0 = lf[:, 0], li[:, 0]
        m1 = torch.maximum(lf0 + m0, li0)
        fw = torch.exp(lf0 + m0 - m1)[..., None]
        iw = torch.exp(li0 - m1)[..., None]
        k0, v0, q0 = (t[:, 0].float() for t in (k, v, q))
        C1 = fw[..., None] * C0 + iw[..., None] * torch.einsum(
            "bhv,bhk->bhvk", v0, k0)
        n1 = fw * n0 + iw * k0
        num = torch.einsum("bhvk,bhk->bhv", C1, q0)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n1, q0)),
                            torch.exp(-m1))
        y = (num / den[..., None]).to(dtype)[:, None]
        new_state = (C1, n1, m1)
    return _out(p, y, z, dtype, tp, dh), new_state


def init_slstm(gen, cfg, dtype, device, keep=None):
    """An sLSTM block's parameters: for each gate g in i, f, z, o the input
    projection ``w_g`` (D, H, dh), the recurrent ``r_g`` (H, dh, dh, scaled
    by 0.1) and the bias ``b_g`` (H, dh; ones for f, else zeros), all
    float32; ``wo`` (H, dh, D) in ``dtype``.  ``keep``: see
    ``layers.kept``."""
    D, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    p = {"wo": _dense_init(gen, (H, dh, D), (0, 1), dtype, device,
                           keep=keep, name="wo")}
    for g in _GATES:
        p[f"w_{g}"] = _dense_init(gen, (D, H, dh), 0, torch.float32, device,
                                  keep=keep, name=f"w_{g}")
        # scaled before it is kept: keep's block of the scaled tensor
        p[f"r_{g}"] = kept(keep, f"r_{g}", _dense_init(
            gen, (H, dh, dh), 1, torch.float32, device).mul_(0.1))
        p[f"b_{g}"] = (torch.ones if g == "f" else torch.zeros)((H, dh), **f32)
    return p


def slstm_block(p, x, cfg, *, state=None, dtype=torch.bfloat16):
    """The scalar-memory LSTM over x (B, L, D), one step a token from
    ``state`` (c, n, h, m), each (B, H, dh) float32 (None: zeros, n ones):
    (out (B, L, D), (c, n, h, m)).  The four gates' input projections run
    once over the sequence and their recurrent products as one batched
    product a step (``r_i``, ``r_f``, ``r_z``, ``r_o`` side by side): the
    reference's four einsums a step, its dot products unchanged."""
    B, L, D = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    xf = x.float()
    pre = torch.cat([_heads(xf, p[f"w_{g}"], torch.float32) + p[f"b_{g}"]
                     for g in _GATES], dim=-1)             # (B, L, H, 4 dh)
    R = torch.cat([p[f"r_{g}"] for g in _GATES], dim=-1)   # (H, dh, 4 dh)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        c = torch.zeros((B, H, dh), **f32)
        n = torch.ones((B, H, dh), **f32)
        h = torch.zeros((B, H, dh), **f32)
        m = torch.zeros((B, H, dh), **f32)
    else:
        c, n, h, m = state
    hs = []
    for t in range(L):
        gates = pre[:, t] + torch.bmm(h.transpose(0, 1), R).transpose(0, 1)
        gi, gf, gz, go = gates.split(dh, dim=-1)
        lfm = F.logsigmoid(gf) + m
        m1 = torch.maximum(lfm, gi)
        iw = torch.exp(gi - m1)
        fw = torch.exp(lfm - m1)
        c = torch.addcmul(fw * c, iw, torch.tanh(gz))
        n = torch.addcmul(iw, fw, n)
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m1
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(dtype)                     # (B, L, H, dh)
    tp = tensor_parallel() or ONE
    cut = tp.layout.get("slstm")
    if cut:
        # the place's dh rows of wo: a partial, added in rank order
        hs = tp.enter(hs)[..., tp.cut(dh)]
    out = hs.reshape(B, L, -1) @ p["wo"].to(dtype).reshape(-1, D)
    return (tp.sum(out) if cut else out), (c, n, h, m)
