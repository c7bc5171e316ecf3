"""Wrapper of the hand-written flash attention kernel in ``csrc/``.

``flash_attention(q, k, v, causal=, window=)`` takes the model's layout,
q (B, Sq, H, Dqk), k (B, Skv, KV, Dqk) and v (B, Skv, KV, Dv) with KV | H
and Dv <= Dqk <= 256, in float32 or bfloat16, and returns (B, Sq, H, Dv)
in q's dtype (Dv < Dqk: multi-head latent attention's prefill, q/k 192
and v 128).  Query positions are left-aligned and shifted by
``q_offset`` (0 by default): row i of q sits at position ``q_offset + i``,
key j at position j (see ``ref.py``).  The
device of the tensors decides: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs ``ref.flash_attention_ref``.  There is no
fallback from one to the other.

On the card the wrapper picks the kernel's route from dtype and shape: the
Hopper tensor-core route (TMA + wgmma) for bfloat16 with (Dqk, Dv) in
``WGMMA_DIMS``, 16-byte aligned data and strides that are multiples of 8
elements, which
TMA requires; the FMA route otherwise.  It
reads q, k and v through their strides (the last dimension must be
contiguous), so a view of a cache or of a projection needs no copy.

``LAUNCHES["flash_attention"]`` counts kernel launches, bumped only where
the kernel is launched, and ``LAUNCH_SHAPES`` counts the same launches by
(causal, Sq, Skv); ``reset_launch_counts`` zeroes both.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["LAUNCHES", "LAUNCH_SHAPES", "reset_launch_counts", "flash_attention", "MAX_D",
           "WGMMA_DIMS", "uses_tensor_cores"]

MAX_D = 256
# the (q/k, v) head dims the tensor-core route is built for
WGMMA_DIMS = ((64, 64), (128, 128), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# flash_attention_fwd returns this plus the CUresult of a tensor map that
# could not be encoded (csrc/flash_attention.cu, kEncodeError)
_ENCODE_ERROR = 100000

LAUNCHES: dict[str, int] = {"flash_attention": 0}
LAUNCH_SHAPES: dict[tuple[bool, int, int], int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, q_offset: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, S, heads, D), got "
                         f"{q.dim()}-D, {k.dim()}-D, {v.dim()}-D")
    B, _, H, D = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D
            or not 0 < v.shape[3] <= D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (v's head dim at most "
                         "q's)")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype of float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < D <= MAX_D:
        raise ValueError(f"head dim {D} outside 1..{MAX_D}")
    if 0 in q.shape or 0 in k.shape:
        raise ValueError("empty q or k")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int or None, got {window}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


def uses_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> bool:
    """True when the kernel takes its tensor-core route (TMA + wgmma) for
    these tensors."""
    return (q.dtype == torch.bfloat16
            and (q.shape[3], v.shape[3]) in WGMMA_DIMS
            and all(t.data_ptr() % 16 == 0
                    and all(s % 8 == 0 for s in t.stride()[:3])
                    for t in (q, k, v)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Forward attention of ``flash_attention_kernel``'s contract (see
    ``ref.flash_attention_ref``), GQA by head index, query row i at
    position ``q_offset + i``."""
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dimension of q, k, v must be contiguous")
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = build.load("flash_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, H, KV, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window or 0), q_offset,
            int(uses_tensor_cores(q, k, v)),
            stream)
    if rc >= _ENCODE_ERROR:
        raise RuntimeError("flash_attention_fwd: cuTensorMapEncodeTiled "
                           f"failed with CUresult {rc - _ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd: kernel launch failed with CUDA error {rc}")
    LAUNCHES["flash_attention"] += 1
    key = (bool(causal), Sq, Skv)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
    return out
