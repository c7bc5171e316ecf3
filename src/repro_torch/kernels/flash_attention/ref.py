"""Plain PyTorch versions of forward flash attention.

``flash_attention_ref`` is what ``ops.flash_attention`` computes: the
contract of the TPU kernel ``flash_attention_kernel`` in
``repro/kernels/flash_attention/flash_attention.py`` with GQA read by head
index.  On the CPU the wrapper runs it; on the card the kernel is held to
it.  ``attention_ref`` is the port of the reference's right-aligned oracle
(``repro/kernels/flash_attention/ref.py``), which the tests use where the
two agree (Sq == Skv).

Positions.  The kernel LEFT-aligns query positions: query row i sits at
position ``q_offset + i`` (``q_offset`` 0 by default), key column j at
position j, whatever Sq and Skv are (``q_pos = q_start + iota`` in the TPU
kernel, whose offset is 0).  That is the prefill of a cache from slot 0: a
prompt of S tokens attends to keys 0..S-1, and cache slots past S are
masked by causality.  A slice of a prompt's query rows that starts at row
r (context-parallel attention, ``models.layers``) passes ``q_offset=r``
with every key, and its rows equal the whole prompt's rows r.. .  ``attention_ref`` right-aligns
(``q_pos = i + Skv - Sq``), the decode convention; the two agree only when
Sq == Skv.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "attention_ref", "admissible"]

# the finite mask value of the TPU kernel: a row whose first visited block
# is fully masked gets p = exp(0) there, and the next admissible score
# clears it with alpha = exp(NEG_INF - m) = 0 (-inf would give NaN)
NEG_INF = -1e30


def admissible(sq: int, skv: int, *, causal: bool, window: int | None,
               device=None, q_offset: int = 0) -> torch.Tensor:
    """(Sq, Skv) bool: key j admissible for query i, query row i at
    position ``q_offset + i``."""
    q_pos = torch.arange(q_offset, q_offset + sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Skv, KV, D), v (B, Skv, KV, Dv) with KV | H;
    query row i at position ``q_offset + i``;
    query head h reads KV head h // (H / KV).  Scores, softmax and the PV
    product in float32 (probabilities are not rounded to q's dtype), scale
    1/sqrt(D) (q's and k's head dim: MLA's 1/sqrt(dn + dr)), masked scores
    NEG_INF, output (B, Sq, H, Dv) in q's dtype.  A row with no admissible
    key is not defined (the TPU kernel's answer for it depends on its
    blocks)."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    qg = q.float().reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B, KV, 1, Skv, D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qg, kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    ok = admissible(Sq, Skv, causal=causal, window=window, device=q.device,
                    q_offset=q_offset)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, vf)                                # (B, KV, G, Sq, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """The reference's oracle: q (B, Sq, H, D), k/v (B, Skv, H, D) with the
    same head count, query positions RIGHT-aligned.  Scores from a product
    in q's dtype, softmax in float32, probabilities rounded to q's dtype
    before the PV product."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    scores = torch.where(ok[None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
