"""Forward flash attention: a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``), its wrapper (``ops``) and the plain PyTorch
versions (``ref``)."""
from .ops import (  # noqa: F401
    LAUNCH_SHAPES,
    LAUNCHES,
    MAX_D,
    WGMMA_DIMS,
    flash_attention,
    reset_launch_counts,
    uses_tensor_cores,
)
from .ref import NEG_INF, admissible, attention_ref, flash_attention_ref  # noqa: F401
