"""Plain PyTorch versions of the elementwise kernels in ``csrc/``.

Each is the chain of ATen ops that rounds as the reference's activation
rounds: every operation's result in the input's dtype.  On the CPU the
wrappers in ``ops`` run these; on the card the kernels are held to them
bit for bit.

``silu_stepwise_ref`` is ``jax.nn.silu``: x * logistic(x), which XLA
expands to 1 / (1 + exp(-x)).  ``gelu_stepwise_ref`` is
``jax.nn.gelu(approximate=True)``: x * (0.5 * (1 + tanh(c0 * (x + c1 *
x**3)))) with x**3 lowered as (x * x) * x and c0 = sqrt(2 / pi), c1 =
0.044715 rounded to the dtype (a Python float in an ATen op is not: it
stays float32 in the op's arithmetic).
"""
from __future__ import annotations

import math

import torch

__all__ = ["GELU_C0", "GELU_C1", "gelu_constants", "gelu_stepwise_ref",
           "silu_stepwise_ref"]

GELU_C0 = math.sqrt(2.0 / math.pi)
GELU_C1 = 0.044715


def gelu_constants(dtype: torch.dtype) -> tuple[float, float]:
    """(c0, c1) rounded to ``dtype``, as Python floats."""
    return tuple(float(torch.tensor(c, dtype=torch.float64).to(dtype))
                 for c in (GELU_C0, GELU_C1))


def silu_stepwise_ref(x: torch.Tensor) -> torch.Tensor:
    return x * (1 + torch.exp(-x)).reciprocal()


def gelu_stepwise_ref(x: torch.Tensor) -> torch.Tensor:
    c0, c1 = (torch.tensor(c, dtype=x.dtype) for c in gelu_constants(x.dtype))
    inner = c0 * (x + c1 * ((x * x) * x))
    return x * (0.5 * (1 + torch.tanh(inner)))
