"""Parsa core of the port: the numpy host oracles (``bipartite``, ``costs``,
``partition_v``), the numpy host algorithms (``bucket_queue``,
``partition_u``, ``subgraphs``, ``parallel``) and the torch pipeline
(``partition``, ``refine``, ``dispatch``)."""
from .bipartite import BipartiteGraph, from_edges, load_npz  # noqa: F401
from .costs import (  # noqa: F401
    PartitionMetrics,
    evaluate,
    improvement,
    need_matrix,
    random_parts,
)
from .partition_v import partition_v  # noqa: F401
