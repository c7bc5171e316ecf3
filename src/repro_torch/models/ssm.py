"""Mamba2 (SSD, state-space duality) block: the chunked parallel form for
training and the loss, and the recurrent step for decode (zamba2's
backbone).

The port of ``repro/models/ssm.py``.  The chunked form is the Mamba2
paper's matrix formulation (its listing 1): a quadratic term inside each
chunk and a recurrence of chunk states across chunks.  ``mamba2_block``
halves its chunk until it divides the sequence (``ssd_chunked`` asserts
that it does).

Dtypes as in the reference: the SSM state and the conv window are held
in the compute dtype (decode starts from zeros of it, updates
``s0 * a + upd`` in it and returns the state in it); ``w_dt``,
``dt_bias``, ``A_log`` and ``out_norm`` are used in float32; ``wz``,
``wx``, ``wB``, ``wC``, ``wo``, the conv weights and ``D_skip`` in the
compute dtype.  The conv cache holds the last ``ssm_conv`` raw inputs of
x, B and C; decode rolls it by one and applies silu after the window's
dot product.  Each silu rounds the operations of its sigmoid as the
reference's does (``layers.silu_stepwise``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _dense_init, silu_stepwise
from .shardctx import ONE, tensor_parallel

__all__ = ["ssm_dims", "init_mamba2", "_causal_conv", "_segsum",
           "ssd_chunked", "mamba2_block", "init_conv_cache"]


def ssm_dims(cfg):
    """(d_inner, heads, head dim P, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state


def init_mamba2(gen, cfg, dtype, device, keep=None):
    """A Mamba2 block's parameters: the projections ``wz``, ``wx`` (D, H,
    P), ``wB``, ``wC`` (D, N), ``wo`` (H, P, D) and the conv weights
    ``conv_x`` (ks, H, P), ``conv_B``, ``conv_C`` (ks, N) in ``dtype``;
    ``w_dt`` (D, H), ``dt_bias`` (zeros), ``A_log`` (zeros), ``D_skip``
    (ones) and ``out_norm`` (H, P) float32.  ``keep``: see
    ``layers.kept``."""
    D = cfg.d_model
    _, H, P, N = ssm_dims(cfg)
    ks = cfg.ssm_conv
    f32 = dict(dtype=torch.float32, device=device)

    def w(name, shape, axis=0, dt=dtype):
        return _dense_init(gen, shape, axis, dt, device, keep=keep,
                           name=name)

    return {
        "wz": w("wz", (D, H, P)), "wx": w("wx", (D, H, P)),
        "wB": w("wB", (D, N)), "wC": w("wC", (D, N)),
        "w_dt": w("w_dt", (D, H), dt=torch.float32),
        "dt_bias": torch.zeros(H, **f32), "A_log": torch.zeros(H, **f32),
        "D_skip": torch.ones(H, **f32),
        "conv_x": w("conv_x", (ks, H, P)), "conv_B": w("conv_B", (ks, N)),
        "conv_C": w("conv_C", (ks, N)),
        "out_norm": torch.ones((H, P), **f32),
        "wo": w("wo", (H, P, D), (0, 1)),
    }


def _causal_conv(x, w):
    """Depthwise causal conv along axis 1: x (B, L, C), w (ks, C); the
    taps summed in the reference's order."""
    ks, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, ks - 1, 0))
    out = 0
    for i in range(ks):
        out = out + xp[:, i:i + L] * w[i]
    return out


def _segsum(x):
    """x (..., L) -> (..., L, L): the sum of x over (j, i] at [i, j] on and
    below the diagonal, -inf above it."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def ssd_chunked(x, log_a, B_, C_, chunk: int):
    """The SSD scan: x (B, L, H, P) (already scaled by dt), log_a (B, L, H)
    <= 0, B_ and C_ (B, L, N) shared by the heads.  Returns y (B, L, H, P)
    and the final state (B, H, P, N)."""
    Bsz, L, H, P = x.shape
    N = B_.shape[-1]
    assert L % chunk == 0, (L, chunk)
    nc = L // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    ac = log_a.reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)   # (B,H,nc,Q)
    Bc = B_.reshape(Bsz, nc, chunk, N)
    Cc = C_.reshape(Bsz, nc, chunk, N)

    A_cum = torch.cumsum(ac, dim=-1)                             # (B,H,nc,Q)
    Lmat = torch.exp(_segsum(ac))                                # (B,H,nc,Q,Q)
    # inside each chunk
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)             # (B,nc,Q,Q)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp",
                          scores, Lmat.to(scores.dtype), xc)
    # each chunk's final state
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)            # (B,H,nc,Q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn",
                          Bc, decay_states.to(Bc.dtype), xc)     # (B,nc,H,P,N)
    # the recurrence across chunks
    chunk_decay = A_cum[..., -1]                                 # (B,H,nc)
    padded = F.pad(chunk_decay, (1, 0))
    decay_chunk = torch.exp(_segsum(padded))                     # (B,H,nc+1,nc+1)
    states_in = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn",
                              decay_chunk.to(states.dtype), states_in)
    prev_states = new_states[:, :-1]                             # entering a chunk
    final_state = new_states[:, -1]
    # the state entering each chunk, decayed to each position
    state_decay = torch.exp(A_cum)                               # (B,H,nc,Q)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp",
                         Cc, prev_states, state_decay.to(Cc.dtype))
    return (y_diag + y_off).reshape(Bsz, L, H, P), final_state


def _window(cache, fresh, lay: bool, own: slice, tp):
    """A conv window rolled by one: the place's cache block ``cache`` (B,
    ks, C or its ``own`` channel slice where ``lay``) without its oldest
    row, then ``fresh`` (B, 1, C'), whose channels C' cover the block's.
    Where they are not the block's channels the block is first gathered
    to whole over the model axis in rank order.  Returns (the window over
    C', the new block to write back)."""
    past = cache[:, 1:]
    if past.shape[2] != fresh.shape[2]:
        past = tp.gather(past, dim=2)
    win = torch.cat([past, fresh], dim=1)
    if lay and win.shape[2] != cache.shape[2]:
        return win, win[..., own]
    return win, win


def mamba2_block(p, x, cfg, *, state=None, conv_cache=None, chunk=256,
                 dtype=torch.bfloat16):
    """x (B, L, D) -> (out (B, L, D), final state (B, H, P, N) in
    ``dtype``, conv cache).  Decode: L == 1 with ``state`` and
    ``conv_cache`` {"x" (B, ks, H*P), "B", "C" (B, ks, N)}, whose rolled
    window is returned (a new dict; the caller writes it back).
    Under tensor parallelism (``tp.layout`` "ssm", "ssm_o", "conv_x",
    "conv_bc"): H is the place's SSM heads (its blocks of ``wz``, ``wx``,
    ``w_dt``, ``dt_bias``, ``A_log``, ``D_skip``, ``out_norm``,
    ``conv_x`` and the state); B and C are whole (``wB``, ``wC`` and
    their convs are), the heads independent, the gated norm per head; the
    conv windows are the place's channels (``_window``); the ``wo``
    partials (its heads, or its P rows where the heads are whole) are
    added in rank order.  Where autograd records, x into the place's
    heads, the whole B and C, and a whole y cut to its P rows are
    ``tp.enter``-ed (``launch.mesh``)."""
    tp = tensor_parallel() or ONE
    Bsz, L, D = x.shape
    _, _, P, N = ssm_dims(cfg)
    H = p["wx"].shape[1]
    heads_cut = bool(tp.layout.get("ssm"))
    # x into the place's heads of wz, wx and w_dt
    xe = tp.enter(x) if heads_cut else x

    def proj(w, x=xe):
        return x @ p[w].to(dtype).reshape(D, -1)

    z = proj("wz").view(Bsz, L, H, P)
    xin = proj("wx").view(Bsz, L, H, P)
    B_, C_ = proj("wB", x), proj("wC", x)
    dt = F.softplus(xe.float() @ p["w_dt"] + p["dt_bias"])       # (B,L,H)
    A = -torch.exp(p["A_log"])                                   # (H,) < 0

    new_conv_cache = None
    if conv_cache is None:
        xin = silu_stepwise(_causal_conv(
            xin.reshape(Bsz, L, H * P),
            p["conv_x"].reshape(-1, H * P).to(dtype))).view(Bsz, L, H, P)
        B_ = silu_stepwise(_causal_conv(B_, p["conv_B"].to(dtype)))
        C_ = silu_stepwise(_causal_conv(C_, p["conv_C"].to(dtype)))
        if heads_cut:
            # whole B and C against the place's heads
            B_, C_ = tp.enter(B_), tp.enter(C_)
    else:
        ks = cfg.ssm_conv
        cx, bx = _window(conv_cache["x"], xin.reshape(Bsz, 1, H * P),
                         tp.layout.get("conv_x"),
                         tp.cut(conv_cache["x"].shape[2] * tp.n), tp)
        own = tp.cut(N)
        cB, bB = _window(conv_cache["B"], B_, tp.layout.get("conv_bc"), own,
                         tp)
        cC, bC = _window(conv_cache["C"], C_, tp.layout.get("conv_bc"), own,
                         tp)
        new_conv_cache = {"x": bx, "B": bB, "C": bC}
        wx_ = p["conv_x"].reshape(ks, H * P).to(dtype)
        xin = silu_stepwise(torch.einsum("bkc,kc->bc", cx, wx_)).view(
            Bsz, 1, H, P)
        B_ = silu_stepwise(torch.einsum("bkn,kn->bn", cB,
                                 p["conv_B"].to(dtype)))[:, None]
        C_ = silu_stepwise(torch.einsum("bkn,kn->bn", cC,
                                 p["conv_C"].to(dtype)))[:, None]

    x_dt = xin * dt.to(dtype)[..., None]
    log_a = (dt * A).float()                                     # (B,L,H)

    if state is None and L > 1:
        ch = min(chunk, L)
        while L % ch:
            ch //= 2
        y, final_state = ssd_chunked(x_dt, log_a, B_, C_, ch)
    else:
        s0 = state if state is not None else torch.zeros(
            (Bsz, H, P, N), dtype=dtype, device=x.device)
        a = torch.exp(log_a[:, 0])                               # (B,H)
        upd = torch.einsum("bhp,bn->bhpn", x_dt[:, 0], B_[:, 0])
        final_state = s0 * a[..., None, None].to(dtype) + upd
        y = torch.einsum("bhpn,bn->bhp", final_state, C_[:, 0])[:, None]
    y = y + xin * p["D_skip"].to(dtype)[None, None, :, None]
    # the gated RMS norm of mamba2, then the output projection; the gate's
    # product stays float32, as XLA computes the reference's bf16 product
    # followed by its cast to float32 (the round trip is elided)
    yf = y.float() * silu_stepwise(z).float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * p["out_norm"]).to(dtype)
    o_lay = tp.layout.get("ssm_o")
    if o_lay == "hd":
        y = tp.enter(y)[..., tp.cut(P)]
    out = y.reshape(Bsz, L, -1) @ p["wo"].to(dtype).reshape(-1, D)
    if o_lay is not None:
        out = tp.sum(out)
    return out, final_state.to(dtype), new_conv_cache


def init_conv_cache(cfg, batch: int, device, dtype=torch.bfloat16):
    _, H, P, N = ssm_dims(cfg)
    ks = cfg.ssm_conv
    return {"x": torch.zeros((batch, ks, H * P), dtype=dtype, device=device),
            "B": torch.zeros((batch, ks, N), dtype=dtype, device=device),
            "C": torch.zeros((batch, ks, N), dtype=dtype, device=device)}
