"""Elementwise activations rounded as the reference rounds them: a
hand-written CUDA kernel for Hopper (``csrc/silu_stepwise.cu``), its
wrappers (``ops``) and the plain PyTorch versions (``ref``)."""
from .ops import LAUNCHES, gelu_stepwise, reset_launch_counts, silu_stepwise  # noqa: F401
from .ref import gelu_constants, gelu_stepwise_ref, silu_stepwise_ref  # noqa: F401
