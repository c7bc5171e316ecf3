"""Packed-bitmask Parsa kernels: hand-written CUDA for Hopper (``csrc/``),
their wrappers (``ops``), plain PyTorch versions (``ref``) and the numpy
packers of the wire format (``pack``)."""
from .ops import (  # noqa: F401
    LAUNCHES,
    REFINE_MAX_K,
    SELECT_MAX_B,
    SELECT_MAX_K,
    SKETCH_SELECT_MAX_TILE_BYTES,
    merge_worker_sets,
    packed_union_delta,
    parsa_cost,
    parsa_cost_select,
    parsa_select_reduce,
    parsa_select_tile,
    refine_sweep_chunk,
    reset_launch_counts,
    sketch_cost_select,
    sketch_select_fits,
)
from .pack import (  # noqa: F401
    coerce_dense_sets,
    coerce_packed_sets,
    pack_bitmask,
    pack_bitmask_csr_sparse,
    packed_delta,
    packed_union,
    unpack_bitmask,
)
from .ref import (  # noqa: F401
    BIG,
    merge_worker_sets_ref,
    packed_union_delta_ref,
    parsa_cost_ref,
    parsa_select_greedy_ref,
    parsa_select_ref,
    popcount32,
    refine_sweep_ref,
    select_from_cost,
    select_greedy_from_cost,
    sketch_select_ref,
)
