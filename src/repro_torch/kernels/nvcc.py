"""Build hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

A ``KernelFamily`` is one folder's ``csrc/``: each listed ``<name>.cu``
compiles for ``sm_90a`` into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The build runs
at first use, never at import, one ``nvcc`` per source, all started
together (``build_all`` starts every family's at once).  Libraries are named
by a hash of the family's sources and the flags, so an edited source
rebuilds and an unchanged one is reused.

A family builds into ``_build/`` beside its ``csrc/`` (listed in
``.gitignore``), or into ``$REPRO_TORCH_BUILD_DIR``.  ``nvcc`` is taken
from ``$CUDA_HOME/bin``, else from ``PATH``, else from
``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["NVCC_FLAGS", "KernelFamily", "build_all"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class KernelFamily:
    """The libraries of one ``csrc/`` folder and their C entry points
    (``entries``: name -> (library, ctypes argtypes); every entry returns
    an ``int``, the CUDA error of its launch).  ``logs`` holds the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    of each library this object built, by library name."""

    def __init__(self, csrc: pathlib.Path, sources: tuple[str, ...],
                 entries: dict[str, tuple[str, tuple]]):
        self.csrc = csrc
        self.sources = sources
        self.entries = entries
        self._lock = threading.Lock()
        self._libs: dict[str, ctypes.CDLL] = {}
        self._fns: dict[str, ctypes._CFuncPtr] = {}
        self.logs: dict[str, str] = {}

    def build_dir(self) -> pathlib.Path:
        env = os.environ.get("REPRO_TORCH_BUILD_DIR")
        return pathlib.Path(env) if env else self.csrc.parent / "_build"

    def _tag(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(self.csrc.iterdir()):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:12]

    def lib_path(self, name: str) -> pathlib.Path:
        return self.build_dir() / f"{name}-{self._tag()}.so"

    def _start(self) -> list[tuple]:
        """Start one ``nvcc`` for each missing library; return the jobs."""
        out = self.build_dir()
        out.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in self.sources:
            path = self.lib_path(name)
            if path.exists():
                continue
            # compile to a private name, then rename: concurrent builds of
            # the same tag never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
                   str(self.csrc / f"{name}.cu")]
            jobs.append((self, name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        return jobs

    def build_all(self, verbose: bool = False) -> dict[str, pathlib.Path]:
        return build_all((self,), verbose)

    def load(self, entry: str):
        """The ctypes function of one entry point, building on first use."""
        fn = self._fns.get(entry)
        if fn is not None:
            return fn
        lib_name, argtypes = self.entries[entry]
        with self._lock:
            lib = self._libs.get(lib_name)
            if lib is None:
                path = self.lib_path(lib_name)
                if not path.exists():
                    self.build_all()
                lib = self._libs[lib_name] = ctypes.CDLL(str(path))
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        return fn


def build_all(families, verbose: bool = False) -> dict[str, pathlib.Path]:
    """Compile every missing library of ``families``, all ``nvcc`` processes
    at once; return ``{library: path}``.  Raises RuntimeError with the
    compiler's output if any build fails."""
    jobs = [job for fam in families for job in fam._start()]
    failed = []
    for fam, name, path, tmp, proc in jobs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            pathlib.Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
        fam.logs[name] = log
        if verbose:
            print(f"--- {name}.cu\n{log}", end="", flush=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: fam.lib_path(name) for fam in families
            for name in fam.sources}
