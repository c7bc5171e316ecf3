"""Sketched server sets: bounded-error compression of the packed wire
format (see ``repro_torch.sketch.spec``)."""
from .spec import (  # noqa: F401
    SketchSpec,
    linear_counting_estimate,
    packed_popcount_rows,
    rank_hot_columns,
    set_structure_bytes,
)

__all__ = [
    "SketchSpec",
    "linear_counting_estimate",
    "packed_popcount_rows",
    "rank_hot_columns",
    "set_structure_bytes",
]
