"""Hand-written CUDA kernels for Hopper (sm_90a), one folder per family.

parsa_cost/       — packed-bitmask popcount cost tile, the fused greedy
                    select, the sketched select, the whole blocked scan in
                    one persistent launch, the Algorithm 2 refine and the
                    Algorithm 4 merge
flash_attention/  — forward flash attention (causal and sliding-window
                    masks, GQA by head index), the attention of the LM
                    prefill
elementwise/      — silu and tanh-gelu with every operation rounded to
                    the dtype, as the reference's activations round

Each family ships ``csrc/*.cu`` (the kernels), ``build.py`` (nvcc + ctypes,
at first use, through ``nvcc.KernelFamily``), ``ops.py`` (checked wrappers
with launch counters) and ``ref.py`` (the plain PyTorch versions the CPU
runs and the card is held to).  ``build_all()`` compiles every family's
libraries at once.
"""
from __future__ import annotations


def build_all(verbose: bool = False):
    """Compile every kernel library of every family, one ``nvcc`` per
    source, all started together; return ``{library: path}``."""
    from . import nvcc
    from .elementwise import build as ew_build
    from .flash_attention import build as fa_build
    from .parsa_cost import build as pc_build

    return nvcc.build_all((pc_build.FAMILY, fa_build.FAMILY, ew_build.FAMILY),
                          verbose)
