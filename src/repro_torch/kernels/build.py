"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library under ``build/kernels/`` at the repository root, at first use.
All sources compile at once, one ``nvcc`` process each.  A library's file
name carries a hash of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

Nothing here runs at import: importing the package needs no ``nvcc``;
the first launch of a kernel on a CUDA tensor builds the libraries.
Several processes may start at once (one per rank of a grid): a file lock
beside the libraries lets the first one compile while the others wait,
and then they load what it built.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("dft_matmul", "sphere_pack", "gamma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# argtypes per exported symbol: pointers and the stream as c_void_p (a
# bare int would be passed as 32 bits and cut the pointer)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "dft_matmul_launch": (_P, _P, _P, _L, _I, _I, _I, _P),
    "dft_matmul_cols_launch": (_P, _P, _P, _L, _I, _I, _I, _P),
    "dft_matmul_twiddle_launch": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "dft_factored_launch": (_P, _P, _P, _P, _L, _I, _I, _P),
    "dft_factored_cols_launch": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    "unpack_dft_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _L, _I, _I, _I, _I, _P),
    "dft_pack_launch": (_P, _P, _P, _P, _P, _P, _P,
                        _I, _L, _I, _I, _I, _I, _I, _P),
    "pack_zero_tail_launch": (_P, _P, _I, _L, _P),
    "unpack_factored_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _L, _I, _I, _I, _I, _P),
    "pack_factored_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _L, _I, _I, _I, _I, _I, _P),
    "gamma_fold_launch": (_P, _P, _P, _P, _I, _I, _L, _L, _P),
    "gamma_unfold_launch": (_P, _P, _P, _P, _I, _I, _L, _L, _P),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _load(stem: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library (all ``nvcc`` runs at once), load all.

    Returns the loaded libraries by source stem.  Raises ``RuntimeError``
    with the compiler's output if a source does not build.
    """
    with _LOCK:
        missing = [s for s in SOURCES if s not in _LIBS]
        if not missing:
            return dict(_LIBS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # threads of this process wait on _LOCK, other processes on the
        # file lock; a process that waited finds the libraries built
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            _compile(missing)
        for stem in missing:
            _LIBS[stem] = _load(stem, _lib_path(stem))
        return dict(_LIBS)


def _compile(missing: list[str]) -> None:
    """Run ``nvcc`` on every source of ``missing`` whose library is not
    on disk yet, all at once; raise with the output of any that fails."""
    procs = {}
    for stem in missing:
        path = _lib_path(stem)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path)
    errors = []
    for stem, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        _LOGS[stem] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {stem}.cu:\n{out}")
            continue
        os.replace(tmp, path)         # atomic: readers never see halves
    if errors:
        raise RuntimeError("\n".join(errors))


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _LIBS.get(stem)
    return lib if lib is not None else build_all()[stem]


def build_logs() -> dict[str, str]:
    """Compiler output (``-Xptxas -v``: registers, shared memory, spills)
    of the libraries this process built; empty for ones it reused."""
    return dict(_LOGS)


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
