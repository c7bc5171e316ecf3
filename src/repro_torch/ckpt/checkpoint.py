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
    on another device than the save (``restore_checkpoint(device=...)``).

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


def _flatten(tree) -> dict:
    return {_key(path): _to_host(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


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


def save_checkpoint(directory, step: int, tree, *, blocking: bool = True):
    """Write ``tree`` as step ``step`` of ``directory``.  The tensors are
    copied to the host before this returns; with ``blocking=False`` a
    thread writes and publishes the files, and is returned."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = _flatten(tree)

    def _write():
        _write_npz(tmp / "shard_0.npz", {k: a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(a.shape), "dtype": dt}
                       for k, (a, dt) in flat.items()},
            "format": 1,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.replace(tmp, final)  # atomic publish

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


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
                       inplace: bool = False):
    """Restore into the structure of ``like_tree``: a tree of the same
    paths whose leaves are tensors of each like leaf's dtype, on
    ``device`` (default: the like leaf's device).  ``inplace=True`` copies
    the values into ``like_tree``'s own tensors and returns it, so a
    restore needs no second copy of the state on the device.  The like
    leaves may be tensors on the ``meta`` device (a structure only), given
    a ``device``."""
    path_dir = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((path_dir / "manifest.json").read_text())["arrays"]
    with zipfile.ZipFile(path_dir / "shard_0.npz") as zf:
        members = set(zf.namelist())

        def one(path, like):
            key = _key(path)
            if key + ".npy" not in members:
                raise KeyError(f"checkpoint missing array {key!r}")
            t = _as_tensor(_read_npy(zf, key),
                           manifest.get(key, {}).get("dtype", ""))
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
    """Every-N-steps manager with async saves and bounded retention."""

    def __init__(self, directory, every: int = 100, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.every = every
        self.keep = keep
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, tree, *, blocking: bool = False):
        if step % self.every:
            return False
        if self._pending is not None:
            self._pending.join()  # backpressure: one in-flight save
        self._pending = save_checkpoint(
            self.directory, step, tree, blocking=blocking)
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
