"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``, at first use
(``repro_torch.kernels.nvcc`` does the building).  The build directory is
``_build/`` beside this file (listed in ``.gitignore``), or
``$REPRO_TORCH_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import pathlib

from ..nvcc import NVCC_FLAGS, KernelFamily

__all__ = ["SOURCES", "NVCC_FLAGS", "FAMILY", "build_dir", "build_all", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("parsa_cost", "parsa_select", "sketch_select", "parsa_scan",
           "refine_sweep", "union_delta")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signature of every entry point: name -> (library, argtypes)
_ENTRIES = {
    "parsa_cost": ("parsa_cost", (_P, _P, _I, _I, _I, _P, _P)),
    "parsa_select_tile": ("parsa_select", (_P, _P, _I, _I, _I, _P, _P)),
    "parsa_select_reduce": ("parsa_select",
                            (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P)),
    "sketch_select": ("sketch_select",
                      (_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                       _P, _P, _P)),
    "parsa_scan": ("parsa_scan",
                   (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                    _I, _I, _I, _I, _I, _P)),
    "refine_sweep": ("refine_sweep",
                     (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P)),
    "packed_union_delta": ("union_delta",
                           (_P, _P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _P)),
}

FAMILY = KernelFamily(CSRC, SOURCES, _ENTRIES)
build_dir = FAMILY.build_dir
build_all = FAMILY.build_all
load = FAMILY.load
