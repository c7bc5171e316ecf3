"""Build ``csrc/flash_attention.cu`` with ``nvcc`` for ``sm_90a`` and load
it with ``ctypes``, at first use (``repro_torch.kernels.nvcc`` does the
building).  The build directory is ``_build/`` beside this file (listed in
``.gitignore``), or ``$REPRO_TORCH_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import pathlib

from ..nvcc import KernelFamily

__all__ = ["SOURCES", "FAMILY", "build_dir", "build_all", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# q, k, v, o, dtype, B, Sq, Skv, H, KV, D, Dv, 9 strides, causal, window,
# q_offset, use_wgmma, stream
_ENTRIES = {
    "flash_attention_fwd": ("flash_attention",
                            (_P, _P, _P, _P) + (_I,) * 8 + (_L,) * 9
                            + (_I, _I, _I, _I, _P)),
}

FAMILY = KernelFamily(CSRC, SOURCES, _ENTRIES)
build_dir = FAMILY.build_dir
build_all = FAMILY.build_all
load = FAMILY.load
