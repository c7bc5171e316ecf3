"""Backend registry of the ``repro_torch.api`` facade.

Every strategy is one registered function with the signature
``fn(graph, config, init_sets=None, device=...) -> BackendOutput``:

  * ``host``                — Algorithm 3 on the host (numpy); with
    ``config.blocks > 1`` or ``config.init_iters > 0`` the §4.2/§4.4
    subgraph-streaming driver (``sequential_parsa_impl``).
  * ``device_scan``         — the blocked rounds pipeline on the device:
    fused select kernel per round (``blocked_partition_u_impl``); with
    ``set_repr="sketch"`` the one-launch ``sketch_select``.
  * ``host_blocked_oracle`` — the sequential per-block loop, driven by the
    ``parsa_cost`` kernel; the parity oracle of ``device_scan``.
  * ``parallel_sim``        — the deterministic Alg 4 parameter-server
    simulation with W workers and bounded delay τ, on the host, on the
    packed-word wire format; fills ``BackendOutput.traffic``.
  * ``parallel_device``     — Alg 4 on the device: W workers' blocked
    scans as an axis of the carried state, OR-merged by the
    ``packed_union_delta`` kernel every ``merge_every`` blocks
    (``parallel_blocked_partition_u_impl``); fills ``traffic`` in the same
    word-byte units.  It alone also takes ``group=``, a
    ``torch.distributed`` process group of W ranks, one worker a rank.

The host backends take ``device`` only to agree with the signature: they
return numpy arrays, which the facade moves where it needs them.

This module is imported by ``repro_torch.api`` and must not import it back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .core.bipartite import BipartiteGraph
from .core.parallel import global_initialization, parallel_parsa_impl
from .core.partition import (
    blocked_partition_u_hostloop_impl,
    blocked_partition_u_impl,
    parallel_blocked_partition_u_impl,
)
from .core.partition_u import partition_u_impl
from .core.subgraphs import sequential_parsa_impl

__all__ = ["BackendOutput", "TrafficCounters", "register_backend",
           "get_backend", "available_backends", "BACKENDS"]


@dataclasses.dataclass(frozen=True)
class TrafficCounters:
    """Parameter-server traffic of the partitioning run itself (Alg 4).

    Units are *bitmask-word bytes* in both directions (4 bytes per 32
    parameters, the packed wire format shared by ``parallel_sim`` and
    ``parallel_device``): pulls count the packed words a worker reads
    (``parallel_sim``: the words covering the task's V support;
    ``parallel_device``: the full (k, W) set per merge), pushes count the
    delta-encoded changed words (Alg 4 worker line 9)."""

    pushed_bytes: int = 0          # worker→server traffic (delta-encoded words)
    pulled_bytes: int = 0          # server→worker traffic (packed words)
    tasks: int = 0
    stale_pushes_missed: int = 0   # pushes invisible to a pull due to delay
    migration_bytes: int = 0       # one-time recovery/re-shard traffic,
                                   #   kept apart from push/pull

    def __add__(self, other: "TrafficCounters") -> "TrafficCounters":
        """Component-wise accumulation (same units, so the sum is
        meaningful)."""
        if not isinstance(other, TrafficCounters):
            return NotImplemented
        return TrafficCounters(
            self.pushed_bytes + other.pushed_bytes,
            self.pulled_bytes + other.pulled_bytes,
            self.tasks + other.tasks,
            self.stale_pushes_missed + other.stale_pushes_missed,
            self.migration_bytes + other.migration_bytes)


@dataclasses.dataclass
class BackendOutput:
    """What a backend hands back to the facade.

    ``parts_u`` (|U|,) int32, and exactly one of ``s_masks`` (packed (k, W)
    int32) or ``neighbor_sets`` (dense (k, |V|) bool, the host backends).
    Device backends return tensors on the device, host backends numpy
    arrays.  ``traffic`` is set by the Alg 4 backends; ``timings`` carries
    backend-internal phases (``"pack"``, the host packing seconds)."""

    parts_u: torch.Tensor | np.ndarray
    s_masks: torch.Tensor | np.ndarray | None = None
    neighbor_sets: np.ndarray | None = None
    traffic: TrafficCounters | None = None
    timings: dict | None = None


BackendFn = Callable[..., BackendOutput]
BACKENDS: dict[str, BackendFn] = {}


def register_backend(name: str) -> Callable[[BackendFn], BackendFn]:
    """Decorator: register ``fn(graph, config, init_sets=None, device=...)``
    under ``name`` so ``ParsaConfig(backend=name)`` can reach it."""

    def deco(fn: BackendFn) -> BackendFn:
        BACKENDS[name] = fn
        return fn

    return deco


def get_backend(name: str) -> BackendFn:
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown Parsa backend {name!r}; available: "
            f"{', '.join(available_backends())}") from None


def available_backends() -> list[str]:
    return sorted(BACKENDS)


def _host_sets(init_sets):
    """Warm-start sets for a host algorithm: numpy, wherever they lie."""
    if isinstance(init_sets, torch.Tensor):
        return init_sets.cpu().numpy()
    return init_sets


def _global_init(graph: BipartiteGraph, config, init_sets):
    """§4.4 global initialization when asked for and no warm start is
    given: one worker partitions a sample and its sets seed every worker."""
    if init_sets is None and config.global_init_frac > 0:
        return global_initialization(
            graph, config.k, sample_frac=config.global_init_frac,
            theta=config.theta, select=config.select, seed=config.seed)
    return init_sets


@register_backend("host")
def host_backend(graph: BipartiteGraph, config, init_sets=None,
                 device="cuda") -> BackendOutput:
    """Sequential reference: Alg 3, optionally streamed over ``blocks``
    subgraphs with ``init_iters`` individual-initialization passes."""
    init_sets = _host_sets(init_sets)
    if config.blocks <= 1 and config.init_iters == 0:
        res = partition_u_impl(
            graph, config.k, init_sets=init_sets, theta=config.theta,
            select=config.select, seed=config.seed)
        return BackendOutput(res.parts_u, neighbor_sets=res.neighbor_sets)
    parts_u, sets = sequential_parsa_impl(
        graph, config.k, b=config.blocks, a=config.init_iters,
        theta=config.theta, select=config.select, seed=config.seed,
        init_sets=init_sets)
    return BackendOutput(parts_u, neighbor_sets=sets)


@register_backend("device_scan")
def device_scan_backend(graph: BipartiteGraph, config, init_sets=None,
                        device="cuda") -> BackendOutput:
    """Blocked rounds pipeline: one fused select per greedy round."""
    timings: dict = {}
    parts_u, s_masks = blocked_partition_u_impl(
        graph, config.k, block=config.block_size, init_sets=init_sets,
        seed=config.seed, cap=config.cap, device=device, timings=timings,
        sketch=config.set_repr == "sketch")
    return BackendOutput(parts_u, s_masks, timings=timings)


@register_backend("host_blocked_oracle")
def host_blocked_oracle_backend(graph: BipartiteGraph, config, init_sets=None,
                                device="cuda") -> BackendOutput:
    """Sequential per-block loop — the parity oracle for ``device_scan``."""
    parts_u, s_masks = blocked_partition_u_hostloop_impl(
        graph, config.k, block=config.block_size, init_sets=init_sets,
        seed=config.seed, device=device)
    return BackendOutput(parts_u, s_masks)


@register_backend("parallel_sim")
def parallel_sim_backend(graph: BipartiteGraph, config, init_sets=None,
                         device="cuda") -> BackendOutput:
    """Alg 4 parameter-server simulation (W workers, bounded delay τ), on
    the host.  With ``config.global_init_frac > 0`` and no warm start, runs
    §4.4 global initialization first and seeds every worker from it."""
    init_sets = _global_init(graph, config, _host_sets(init_sets))
    report, s_masks = parallel_parsa_impl(
        graph, config.k, b=config.blocks, a=config.init_iters,
        workers=config.workers, tau=config.tau, theta=config.theta,
        select=config.select, seed=config.seed, init_sets=init_sets)
    traffic = TrafficCounters(
        pushed_bytes=report.pushed_bytes, pulled_bytes=report.pulled_bytes,
        tasks=report.tasks, stale_pushes_missed=report.stale_pushes_missed)
    return BackendOutput(report.parts_u, s_masks=s_masks, traffic=traffic)


def config_workers(config) -> int:
    """The Alg 4 worker count of a config: ``devices`` when set, else
    ``workers``, as the JAX package reads it."""
    return config.devices if config.devices is not None else config.workers


@register_backend("parallel_device")
def parallel_device_backend(graph: BipartiteGraph, config, init_sets=None,
                            device="cuda", group=None) -> BackendOutput:
    """Alg 4 on the device: ``config.workers`` shards of U scanned against
    stale copies of the packed sets, OR-merged every ``config.merge_every``
    blocks by one ``packed_union_delta`` launch.  ``config.devices``, when
    set, overrides ``workers``, as in the JAX package; without a ``group``
    it is a worker count on one card, not a mesh.  With a
    ``torch.distributed`` ``group`` of that many ranks, each rank scans its
    own shard on its own ``device`` and the merges gather over the group;
    every rank returns the same output.  With one worker the output is
    bit-identical to ``device_scan``.  Supports §4.4 global initialization
    via ``global_init_frac`` like ``parallel_sim``."""
    init_sets = _global_init(graph, config, init_sets)
    timings: dict = {}
    parts_u, s_masks, traffic = parallel_blocked_partition_u_impl(
        graph, config.k, workers=config_workers(config),
        block=config.block_size, merge_every=config.merge_every,
        init_sets=init_sets, seed=config.seed, cap=config.cap, device=device,
        timings=timings, sketch=config.set_repr == "sketch", group=group)
    return BackendOutput(parts_u, s_masks=s_masks,
                         traffic=TrafficCounters(**traffic), timings=timings)
