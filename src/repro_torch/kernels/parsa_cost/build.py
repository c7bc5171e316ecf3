"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build runs at first use, never at
import: all sources start together, one ``nvcc`` each.  Libraries are named
by a hash of every source and the flags, so an edited source rebuilds and
an unchanged one is reused.

The build directory is ``_build/`` beside this file (listed in
``.gitignore``), or ``$REPRO_TORCH_BUILD_DIR``.  ``nvcc`` is taken from
``$CUDA_HOME/bin``, else from ``PATH``, else from ``/usr/local/cuda/bin``.
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

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build_all", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("parsa_cost", "parsa_select", "sketch_select", "refine_sweep",
           "union_delta")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signature of every entry point: name -> (library, argtypes)
_ENTRIES = {
    "parsa_cost": ("parsa_cost", (_P, _P, _I, _I, _I, _P, _P)),
    "parsa_select_tile": ("parsa_select", (_P, _P, _I, _I, _I, _P, _P)),
    "parsa_select_reduce": ("parsa_select",
                            (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P)),
    "sketch_select": ("sketch_select",
                      (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P)),
    "refine_sweep": ("refine_sweep", (_P, _P, _P, _I, _I, _P, _P, _P)),
    "packed_union_delta": ("union_delta", (_P, _P, _I, _L, _P, _P, _P, _P)),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(env) if env else CSRC.parent / "_build"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> pathlib.Path:
    return build_dir() / f"{name}-{_tag()}.so"


def build_all(verbose: bool = False) -> dict[str, pathlib.Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once.
    Raises RuntimeError with the compiler's output if any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = []
    for name, path in paths.items():
        if path.exists():
            continue
        # compile to a private name, then rename: concurrent builds of the
        # same tag never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, path, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            pathlib.Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
        if verbose:
            print(f"--- {name}.cu\n{log}", end="", flush=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(entry: str):
    """The ctypes function of one kernel entry point, building on first use."""
    fn = _fns.get(entry)
    if fn is not None:
        return fn
    lib_name, argtypes = _ENTRIES[entry]
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            path = _lib_path(lib_name)
            if not path.exists():
                build_all()
            lib = _libs[lib_name] = ctypes.CDLL(str(path))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn
