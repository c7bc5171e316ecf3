"""Checkpoints: npz shards + JSON manifest, async save, restore onto any
device.

Layout:  <dir>/step_<n>/manifest.json
         <dir>/step_<n>/shard_0.npz

The port of ``repro/ckpt/checkpoint.py``, in its on-disk format: an npz
(a zip of ``.npy`` members, stored uncompressed) whose keys are the tree
paths joined with ``::`` (a list item's key is its index), and a manifest
of each array's logical shape and dtype.  A bfloat16 tensor is stored as
its 16-bit patterns (numpy has no bfloat16) under the manifest dtype
``bfloat16``; a checkpoint of the JAX package stores the same bits.

Fault-tolerance contract (``runtime/fault.py`` builds on it):
  * host copy first: every tensor is copied to host memory before the
    save thread starts, so the next step may update the parameters in
    place while the thread writes;
  * atomic: writes go to step_<n>.tmp, renamed (``os.replace``) only when
    complete, so a crash mid-save never corrupts the latest checkpoint;
  * restart: ``latest_step`` finds the newest complete manifest;
  * any device: the manifest records logical shapes, so a restore may land
    on another device than the save (``restore_checkpoint(device=...)``);
  * any mesh (the reference's ``restore_checkpoint(..., shardings=)``):
    a save over a mesh (``mesh=`` and ``specs=``, a tree of each leaf's
    spec, ``launch.sharding.state_specs``) writes the logical arrays,
    the same files as a save of the whole tree without a mesh: each
    leaf's blocks are gathered over the axes its spec cuts, a leaf at a
    time on the caller's thread (host copy first), and the place at
    coordinate 0 of every axis writes and publishes; every place then
    meets the others once (``_agree``) before the step is seen.  A
    restore over a mesh reads the members on every place and keeps the
    place's block of each (``launch.sharding.block_slices``), so the
    mesh may differ from the saving one (another shape, another data
    width), or be none.

Each array is written with one write of its buffer and read back with a
few large reads into a preallocated array (``np.savez`` / ``np.load`` go
through 16 MiB and 256 KiB chunks): the same files at several times the
rate, which matters at tens of GB.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from ..tree import tree_leaves_with_path, tree_map_with_path

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "read_arrays", "CheckpointManager"]

_SEP = "::"
_READ_CHUNK = 64 << 20


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of the leaf as numpy, its logical dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        a = np.array(leaf)
        return a, str(a.dtype)
    t = leaf.detach()
    bf16 = t.dtype == torch.bfloat16
    if bf16:
        t = t.view(torch.int16)
    a = t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    if bf16:
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _flatten(tree, mesh=None, specs=None) -> dict:
    """{key: a leaf's host copy and logical dtype}.  Over a mesh, of the
    logical tree of the place's blocks ``tree``: every place gathers
    each leaf (a leaf at a time, the collectives in tree order on every
    place), and the writing place keeps the host copies."""
    writes, out = mesh is None or _writes(mesh), {}
    for path, leaf in tree_leaves_with_path(tree):
        if mesh is not None and isinstance(leaf, torch.Tensor):
            from ..launch.sharding import _at

            leaf = _whole(leaf, _at(specs, path), mesh)
        if writes:
            out[_key(path)] = _to_host(leaf)
    return out


def _writes(mesh) -> bool:
    """Whether the calling place writes the files: the place at
    coordinate 0 of every axis (rank 0 of a ``DeviceMesh``)."""
    return all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names)


def _whole(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The logical tensor of the place's block ``leaf`` under ``spec``:
    gathered along each dim the spec cuts over its axes' group in rank
    order (``launch.mesh.gather_cat``), a dim after another.  A leaf
    whole over an axis is the place's own (each place holds the same)."""
    from ..launch.mesh import axis_group, gather_cat

    names = mesh.mesh_dim_names
    t = leaf.detach()
    for d, ax in enumerate(spec or ()):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        t = gather_cat(t, axis_group(mesh, axes), d)
    return t


def _agree(mesh, ok: bool) -> bool:
    """Every place's ``ok``, met over the whole mesh (one gather of a flag
    in rank order: the barrier every place reaches before a saved step
    can be seen); True when every place's was."""
    from ..launch.mesh import axis_group, gather_stack

    dev = getattr(mesh, "device_type", "cpu")
    if dev == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
    return bool(gather_stack(flag, axis_group(
        mesh, mesh.mesh_dim_names)).min().item())


class _MeshSave:
    """A save over a mesh in flight: ``join()`` waits for the writing
    place's thread, then meets every place (``_agree``) and raises on
    every place if the write failed."""

    def __init__(self, thread, mesh, errors: list):
        self.thread, self.mesh, self.errors = thread, mesh, errors

    def join(self):
        if self.thread is not None:
            self.thread.join()
        if not _agree(self.mesh, not self.errors):
            raise RuntimeError("checkpoint write failed on the writing "
                               f"place: {self.errors or 'see its error'}")


def _write_npz(path, arrays: dict) -> None:
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            a = a if a.flags.c_contiguous else a.copy()
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1)).cast("B"))


def _read_npy(zf: zipfile.ZipFile, key: str) -> np.ndarray:
    with zf.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version[0] == 1
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        out = np.empty(shape, dtype, order="F" if fortran else "C")
        buf = memoryview(out.reshape(-1, order="A")).cast("B")
        pos = 0
        while pos < len(buf):
            chunk = f.read(min(_READ_CHUNK, len(buf) - pos))
            if not chunk:
                raise ValueError(f"array {key!r} is truncated")
            buf[pos:pos + len(chunk)] = chunk
            pos += len(chunk)
    return out


def save_checkpoint(directory, step: int, tree, *, blocking: bool = True,
                    mesh=None, specs=None, timings: dict | None = None):
    """Write ``tree`` as step ``step`` of ``directory``.  The tensors are
    copied to the host before this returns; with ``blocking=False`` a
    thread writes and publishes the files, and is returned.

    Over a mesh (``mesh``, a ``DeviceMesh`` or an ``emulate_mesh`` place,
    and ``specs``, each leaf's spec), ``tree`` is the place's blocks and
    every place calls this: the logical arrays are gathered (module
    docstring) and the place at coordinate 0 writes them; a blocking
    save returns once every place has met after the publish, a
    non-blocking one returns a handle whose ``join()`` does.  A failed
    write raises on every place.  ``timings`` (a dict) receives the
    seconds of the host copy (``gather_s``, the gathers included), of
    the write (``write_s``, once it ends) and the bytes of the arrays
    (``bytes``)."""
    if mesh is not None and specs is None:
        raise ValueError("a save over a mesh needs each leaf's spec "
                         "(specs=; launch.sharding.state_specs)")
    writes = mesh is None or _writes(mesh)
    directory = pathlib.Path(directory)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if writes:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    t0 = time.perf_counter()
    flat = _flatten(tree, mesh, specs)
    if timings is not None:
        timings.update(gather_s=time.perf_counter() - t0, bytes=sum(
            a.nbytes for a, _ in flat.values()))
    errors: list = []

    def _write():
        t1 = time.perf_counter()
        try:
            _write_npz(tmp / "shard_0.npz",
                       {k: a for k, (a, _) in flat.items()})
            manifest = {
                "step": step,
                "arrays": {k: {"shape": list(a.shape), "dtype": dt}
                           for k, (a, dt) in flat.items()},
                "format": 1,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            os.replace(tmp, final)  # atomic publish
        except BaseException as e:      # noqa: BLE001 — raised on join
            if mesh is None:
                raise
            errors.append(repr(e))
        if timings is not None:
            timings["write_s"] = time.perf_counter() - t1

    thread = None
    if writes:
        if blocking:
            _write()
        else:
            thread = threading.Thread(target=_write, daemon=True)
            thread.start()
    if mesh is None:
        return thread
    handle = _MeshSave(thread, mesh, errors)
    if blocking:
        handle.join()
        return None
    return handle


def latest_step(directory) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.name.startswith("step_") and not p.name.endswith(".tmp") \
                and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def read_arrays(directory, step: int) -> tuple[dict, dict]:
    """(every array of step ``step`` as numpy, the manifest's entries).  A
    ``bfloat16`` entry is its 16-bit patterns."""
    directory = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((directory / "manifest.json").read_text())
    with zipfile.ZipFile(directory / "shard_0.npz") as zf:
        arrays = {name[:-4]: _read_npy(zf, name[:-4])
                  for name in zf.namelist() if name.endswith(".npy")}
    return arrays, manifest["arrays"]


def _as_tensor(a: np.ndarray, logical: str) -> torch.Tensor:
    a = a if a.flags.c_contiguous else a.copy()
    if logical == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore_checkpoint(directory, step: int, like_tree, *, device=None,
                       inplace: bool = False, mesh=None, specs=None):
    """Restore into the structure of ``like_tree``: a tree of the same
    paths whose leaves are tensors of each like leaf's dtype, on
    ``device`` (default: the like leaf's device).  ``inplace=True`` copies
    the values into ``like_tree``'s own tensors and returns it, so a
    restore needs no second copy of the state on the device.  The like
    leaves may be tensors on the ``meta`` device (a structure only), given
    a ``device``.

    Over a mesh (``mesh`` and ``specs``, each leaf's spec on this mesh:
    ``launch.sharding.state_specs``), ``like_tree`` is the place's
    blocks: each logical array is read and the place keeps its block
    (``block_slices``), whatever mesh, or none, saved it."""
    if mesh is not None and specs is None:
        raise ValueError("a restore over a mesh needs each leaf's spec "
                         "(specs=; launch.sharding.state_specs)")
    path_dir = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((path_dir / "manifest.json").read_text())["arrays"]
    if mesh is not None:
        from ..launch.mesh import axis_sizes
        from ..launch.sharding import _at, _block, mesh_coords

        sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    with zipfile.ZipFile(path_dir / "shard_0.npz") as zf:
        members = set(zf.namelist())

        def one(path, like):
            key = _key(path)
            if key + ".npy" not in members:
                raise KeyError(f"checkpoint missing array {key!r}")
            t = _as_tensor(_read_npy(zf, key),
                           manifest.get(key, {}).get("dtype", ""))
            if mesh is not None:
                t = _block(t, _at(specs, path) or (), sizes, coords)
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{key!r}: checkpoint shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(like.shape)}")
            if inplace:
                with torch.no_grad():
                    like.copy_(t)
                return like
            dev = like.device if device is None else torch.device(device)
            return t.to(device=dev, dtype=like.dtype)

        tree = tree_map_with_path(one, like_tree)
    return like_tree if inplace else tree


class CheckpointManager:
    """Every-N-steps manager with async saves and bounded retention.  Over
    a mesh (``mesh``, ``specs``) every place calls ``maybe_save`` and
    ``wait`` alike: each save gathers on every place, the writing place
    writes and collects, and ``wait`` holds every place until the save is
    published.  ``timings`` holds the last save's (``save_checkpoint``)."""

    def __init__(self, directory, every: int = 100, keep: int = 3, *,
                 mesh=None, specs=None):
        self.directory = pathlib.Path(directory)
        self.every = every
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self.timings: dict = {}
        self._pending = None

    def maybe_save(self, step: int, tree, *, blocking: bool = False):
        if step % self.every:
            return False
        if self._pending is not None:
            self._pending.join()  # backpressure: one in-flight save
        self.timings = {"step": step}
        self._pending = save_checkpoint(
            self.directory, step, tree, blocking=blocking, mesh=self.mesh,
            specs=self.specs, timings=self.timings)
        if self.mesh is None or _writes(self.mesh):
            self._gc()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.iterdir()
            if p.name.startswith("step_") and not p.name.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)
