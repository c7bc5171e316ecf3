"""Build ``csrc/silu_stepwise.cu`` with ``nvcc`` for ``sm_90a`` and load it
with ``ctypes``, at first use (``repro_torch.kernels.nvcc`` does the
building).  The build directory is ``_build/`` beside this file (listed in
``.gitignore``), or ``$REPRO_TORCH_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import pathlib

from ..nvcc import KernelFamily

__all__ = ["SOURCES", "FAMILY", "build_dir", "build_all", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("silu_stepwise",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# x, y, n, dtype, [c0, c1,] stream
_ENTRIES = {
    "silu_stepwise_fwd": ("silu_stepwise", (_P, _P, _L, _I, _P)),
    "gelu_stepwise_fwd": ("silu_stepwise", (_P, _P, _L, _I, _F, _F, _P)),
}

FAMILY = KernelFamily(CSRC, SOURCES, _ENTRIES)
build_dir = FAMILY.build_dir
build_all = FAMILY.build_all
load = FAMILY.load
