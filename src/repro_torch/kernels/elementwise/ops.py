"""Wrappers of the elementwise kernels in ``csrc/silu_stepwise.cu``.

``silu_stepwise(x)`` and ``gelu_stepwise(x)`` take a float32 or bfloat16
tensor of any shape and return one of the same shape and dtype.  The
device of the tensor decides: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version from ``ref.py``.  There is no
fallback from one to the other.  The output keeps the input's strides
when its elements fill one dense block in some order of its dimensions (a
transposed product's output, as Mamba2's decode makes); any other input is
copied to a contiguous one first.

``LAUNCHES`` counts kernel launches, one entry per kernel, bumped only
where the kernel is launched; ``reset_launch_counts`` zeroes it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import gelu_constants, gelu_stepwise_ref, silu_stepwise_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "silu_stepwise",
           "gelu_stepwise"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: dict[str, int] = {"silu_stepwise": 0, "gelu_stepwise": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _dense(x: torch.Tensor) -> bool:
    """Whether x's elements fill ``numel`` consecutive slots from its data
    pointer, in some order of its dimensions (a contiguous tensor, or a
    permutation of one such as a transposed product)."""
    expect = 1
    for stride, size in sorted((st, n) for st, n in zip(x.stride(), x.shape)
                               if n != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")


def _launch(name: str, x: torch.Tensor, *consts) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if not _dense(x):
        x = x.contiguous()
    # the same strides: the kernel maps the storage element by element
    y = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                            device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        rc = build.load(f"{name}_fwd")(
            x.data_ptr(), y.data_ptr(), x.numel(), _DTYPES[x.dtype],
            *consts, stream)
    if rc != 0:
        raise RuntimeError(f"{name}_fwd: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES[name] += 1
    return y


def silu_stepwise(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), each operation rounded to x.dtype."""
    _check("silu_stepwise", x)
    if x.device.type == "cpu":
        return silu_stepwise_ref(x)
    return _launch("silu_stepwise", x)


def gelu_stepwise(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form, each operation rounded to x.dtype."""
    _check("gelu_stepwise", x)
    if x.device.type == "cpu":
        return gelu_stepwise_ref(x)
    return _launch("gelu_stepwise", x,
                   *(ctypes.c_float(c) for c in gelu_constants(x.dtype)))
