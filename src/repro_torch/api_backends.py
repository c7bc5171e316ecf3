"""Backend registry of the ``repro_torch.api`` facade.

Every strategy is one registered function with the signature
``fn(graph, config, init_sets=None, device=...) -> BackendOutput``:

  * ``device_scan``         — the blocked rounds pipeline on the device:
    fused select kernel per round (``blocked_partition_u_impl``); with
    ``set_repr="sketch"`` the one-launch ``sketch_select``.
  * ``host_blocked_oracle`` — the sequential per-block loop, driven by the
    ``parsa_cost`` kernel; the parity oracle of ``device_scan``.

This module is imported by ``repro_torch.api`` and must not import it back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .core.bipartite import BipartiteGraph
from .core.partition import (
    blocked_partition_u_hostloop_impl,
    blocked_partition_u_impl,
)

__all__ = ["BackendOutput", "register_backend", "get_backend",
           "available_backends", "BACKENDS"]


@dataclasses.dataclass
class BackendOutput:
    """What a backend hands back to the facade: ``parts_u`` (|U|,) int32 and
    the final packed ``s_masks`` (k, W) int32, both on the device, plus
    backend-internal timings (``"pack"``, the host packing seconds)."""

    parts_u: torch.Tensor
    s_masks: torch.Tensor
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


@register_backend("device_scan")
def device_scan_backend(graph: BipartiteGraph, config, init_sets=None,
                        device="cuda") -> BackendOutput:
    """Blocked rounds pipeline: one fused select per greedy round."""
    timings: dict = {}
    parts_u, s_masks = blocked_partition_u_impl(
        graph, config.k, block=config.block_size, init_sets=init_sets,
        seed=config.seed, cap=config.cap, device=device, timings=timings,
        sketch=config.set_repr == "sketch")
    return BackendOutput(parts_u, s_masks, timings)


@register_backend("host_blocked_oracle")
def host_blocked_oracle_backend(graph: BipartiteGraph, config, init_sets=None,
                                device="cuda") -> BackendOutput:
    """Sequential per-block loop — the parity oracle for ``device_scan``."""
    parts_u, s_masks = blocked_partition_u_hostloop_impl(
        graph, config.k, block=config.block_size, init_sets=init_sets,
        seed=config.seed, device=device)
    return BackendOutput(parts_u, s_masks)
