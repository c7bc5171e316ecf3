"""Production meshes over ``torch.distributed.device_mesh``.

A port of ``repro.launch.mesh``: the same shapes and axis names.

Single pod: (16, 16)  ("data", "model").
Multi-pod : (2, 16, 16) ("pod", "data", "model"); the ``pod`` axis is pure
data parallelism (the sharding rules place only the gradient all-reduce
there).

``REPRO_MESH`` (e.g. ``"2,2"``) overrides the shape for test-scale meshes,
its axes the last ``len(shape)`` of ``("pod", "data", "model")``.  A
``DeviceMesh`` spans the default process group, which the caller starts
(``torchrun`` and ``init_process_group``) with exactly as many ranks as the
mesh has places; the mesh lies on the card unless the caller passes
``device_type="cpu"``.  Functions, not module constants: importing this
module touches no process group.  The JAX module's ``HW`` figures (TPU
chips) are not carried over; ``launch.roofline`` holds the H100's.
"""
from __future__ import annotations

import math
import os

__all__ = ["make_production_mesh", "make_host_mesh", "mesh_name", "dp_axes",
           "tp_axis", "dp_size", "mesh_shape"]

AXES = ("pod", "data", "model")


def mesh_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh, ``REPRO_MESH`` first."""
    override = os.environ.get("REPRO_MESH")  # e.g. "2,2" — test-scale meshes
    if override:
        shape = tuple(int(x) for x in override.split(","))
        return shape, AXES[-len(shape):]
    if multi_pod:
        return (2, 16, 16), AXES
    return (16, 16), AXES[1:]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))


def make_host_mesh(device_type: str = "cuda"):
    """Degenerate 1-place mesh for smoke tests (a group of one rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def dp_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in dp_axes(mesh))
