"""Parsa in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (which stays the reference).  This
package imports nothing of ``repro`` or of JAX; it keeps its own copies of
the numpy pieces it needs.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, which runs
every kernel's plain PyTorch version.  The dense LM family is served by
``launch.steps`` / ``launch.serve`` (prefill through the hand-written
flash attention kernel, greedy decode through ``serving.ServingEngine``)
and trained by ``launch.train`` (``runtime.TrainLoop`` with checkpoints,
``optim`` AdamW).

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.graphs import text_like

    res = partition(text_like(100_000, 65_536, mean_len=20, seed=0),
                    ParsaConfig(k=16, refine_backend="device"))
"""
from .api import ParsaConfig, PartitionResult, partition  # noqa: F401
