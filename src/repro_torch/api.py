"""Public Parsa facade of the PyTorch port: one config, one ``partition()``
entry point, one result type.

    from repro_torch.api import ParsaConfig, partition

    cfg = ParsaConfig(k=16, backend="device_scan", refine_backend="device")
    res = partition(graph, cfg)             # runs on the card
    res.parts_u, res.parts_v                # Alg 3 + Alg 2 assignments
    res.metrics.traffic_max                 # objectives (4)/(6)/(7)
    res.timings["partition_u"]              # wall clock per phase
    res2 = res.refine(tomorrows_graph)      # warm start from res.s_masks

The device decides where everything runs: ``partition(..., device="cuda")``
(the default) launches the hand-written kernels and raises when there is
no card; ``device="cpu"`` runs their plain PyTorch versions.  The JAX
``ParsaConfig`` fields ``use_kernel`` and ``interpret`` are gone for that
reason, and the config holds only the fields this port implements.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .api_backends import BACKENDS, available_backends, get_backend
from .core.bipartite import BipartiteGraph
from .core.costs import PartitionMetrics, evaluate
from .core.partition_v import partition_v
from .core.refine import evaluate_device, refine_v_device
from .kernels.parsa_cost import unpack_bitmask

__all__ = ["ParsaConfig", "PartitionResult", "PartitionMetrics", "partition"]

_REFINE_BACKENDS = ("host", "device")


@dataclasses.dataclass(frozen=True)
class ParsaConfig:
    """Every knob of the port's Parsa pipeline, validated at construction."""

    k: int
    backend: str = "device_scan"
    seed: int = 0
    block_size: int = 256      # B: vertices greedily assigned per block
    cap: int = 48              # compact word-list width per vertex
    refine_v: bool = True      # run Alg 2 after partition_u
    sweeps: int = 2            # Alg 2 re-assignment sweeps
    refine_backend: str = "host"   # "host" = numpy oracle; "device" = the
                                   #   packed-word refine + metrics on torch
    refine_chunk: int = 1024   # C: parameters swept per refine launch

    def __post_init__(self):
        if not isinstance(self.k, (int, np.integer)) or self.k <= 0:
            raise ValueError(f"k must be a positive int, got {self.k!r}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown Parsa backend {self.backend!r}; available: "
                f"{', '.join(available_backends())}")
        if self.block_size <= 0 or self.block_size % 8 != 0:
            raise ValueError(
                f"block_size must be a positive multiple of 8, got "
                f"{self.block_size}")
        if self.cap <= 0:
            raise ValueError(f"cap must be > 0, got {self.cap}")
        if self.sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {self.sweeps}")
        if self.refine_backend not in _REFINE_BACKENDS:
            raise ValueError(
                f"refine_backend must be one of {_REFINE_BACKENDS}, got "
                f"{self.refine_backend!r}")
        if self.refine_chunk <= 0 or self.refine_chunk % 32 != 0:
            raise ValueError(
                f"refine_chunk must be a positive multiple of 32 (the packed "
                f"word width), got {self.refine_chunk}")

    def replace(self, **changes) -> "ParsaConfig":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class PartitionResult:
    """Output of ``partition``: host numpy arrays and the device it ran on."""

    parts_u: np.ndarray                 # (|U|,) int32
    parts_v: np.ndarray | None          # (|V|,) int32 or None (refine_v=False)
    s_masks: np.ndarray                 # (k, ⌈|V|/32⌉) int32 packed sets
    num_v: int
    k: int
    config: ParsaConfig
    metrics: PartitionMetrics | None    # None for a result converted in
    timings: dict[str, float]           # seconds per phase + "total"
    device: str = "cuda"

    @property
    def neighbor_sets(self) -> np.ndarray:
        """(k, |V|) bool — dense view of the packed neighbor sets."""
        return unpack_bitmask(self.s_masks, self.num_v)

    def refine(self, graph: BipartiteGraph, config: ParsaConfig | None = None,
               *, device: str | torch.device | None = None
               ) -> "PartitionResult":
        """Warm-start repartitioning: partition ``graph`` seeding the
        neighbor sets with this result's packed ``s_masks`` (§4.4
        incremental mode), on this result's device unless told otherwise."""
        if graph.num_v != self.num_v:
            raise ValueError(
                f"refine() needs a graph over the same parameter side: "
                f"result has num_v={self.num_v}, graph has "
                f"num_v={graph.num_v}")
        return partition(graph, config or self.config, init_sets=self.s_masks,
                         device=self.device if device is None else device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def partition(
    graph: BipartiteGraph,
    config: ParsaConfig,
    *,
    init_sets: np.ndarray | torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> PartitionResult:
    """Run the Parsa pipeline described by ``config`` on ``graph``.

    Phases: backend partition_u → optional Alg 2 V-refinement → exact
    metrics.  ``timings`` gets ``pack`` (host packing, device backends),
    ``partition_u`` (the scan alone), ``partition_v``, ``metrics`` and
    ``total``; each phase ends in a device synchronize so no phase's
    queued work leaks into the next one's clock.

    With ``refine_backend="device"`` the refinement and metrics run on
    ``device`` over packed words; on a cold start (no ``init_sets``) every
    backend's final S_i is exactly N(U_i), so its ``s_masks`` are reused as
    the need matrix and the need pack is skipped.  ``device="cuda"`` (the
    default) raises when there is no card: nothing falls back to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "partition(device='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    backend = get_backend(config.backend)
    timings: dict[str, float] = {}
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    out = backend(graph, config, init_sets=init_sets, device=device)
    _sync(device)
    elapsed = time.perf_counter() - t0
    pack_s = (out.timings or {}).get("pack")
    if pack_s is not None:
        timings["pack"] = pack_s
        timings["partition_u"] = elapsed - pack_s
    else:
        timings["partition_u"] = elapsed

    on_device = config.refine_backend == "device"
    # cold-start invariant: S_i == N(U_i), so the sets ARE the need matrix
    need_words = out.s_masks if on_device and init_sets is None else None
    parts_v = parts_v_dev = None
    if config.refine_v:
        t0 = time.perf_counter()
        if on_device:
            parts_v_dev, need_words = refine_v_device(
                graph, out.parts_u, config.k, sweeps=config.sweeps,
                chunk=config.refine_chunk, need_words=need_words,
                device=device)
            parts_v = parts_v_dev.cpu().numpy()
        else:
            parts_v = partition_v(graph, out.parts_u.cpu().numpy(), config.k,
                                  sweeps=config.sweeps)
        timings["partition_v"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if on_device:
        metrics = evaluate_device(graph, out.parts_u, parts_v_dev, config.k,
                                  need_words=need_words, device=device)
    else:
        metrics = evaluate(graph, out.parts_u.cpu().numpy(), parts_v,
                           config.k)
    timings["metrics"] = time.perf_counter() - t0
    timings["total"] = time.perf_counter() - t_start

    return PartitionResult(
        parts_u=out.parts_u.cpu().numpy(),
        parts_v=parts_v,
        s_masks=out.s_masks.cpu().numpy(),
        num_v=graph.num_v,
        k=config.k,
        config=config,
        metrics=metrics,
        timings=timings,
        device=str(device),
    )
