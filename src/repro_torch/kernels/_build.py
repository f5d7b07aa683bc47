"""Build the port's CUDA kernels from the sources in this checkout.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, written to ``build/torch_ext/`` at the root
of the checkout and loaded with :mod:`ctypes`.  The file name carries a digest
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is never served from a stale library.  Nothing here runs at
import time: the first call that needs a kernel builds it, and :func:`build`
lets a caller compile every kernel at once (one ``nvcc`` process per source,
all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "torch_ext"
HEADERS = _PKG / "csrc"            # shared by the sources that include them

SOURCES: Dict[str, Path] = {
    "ssd_fwd": _PKG / "ssd" / "csrc" / "ssd_fwd.cu",
    "ssd_fwd_wgmma": _PKG / "ssd" / "csrc" / "ssd_fwd_wgmma.cu",
    "flash_fwd": _PKG / "flash_attention" / "csrc" / "flash_fwd.cu",
    "flash_fwd_wgmma": _PKG / "flash_attention" / "csrc" / "flash_fwd_wgmma.cu",
    "rglru_fwd": _PKG / "rglru" / "csrc" / "rglru_fwd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Loaded libraries, by kernel name.  A shared library stays mapped for the
# life of the process whatever holds it, so this cache adds no lifetime.
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(HEADERS.glob("*.cuh")))
    digest = hashlib.sha256(SOURCES[name].read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns {name: library path}.  Raises RuntimeError with nvcc's output if
    any build fails.  ptxas's register and shared-memory report for each
    kernel is kept beside its library as ``<library>.log``.
    """
    targets = {name: _target(name) for name in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        target = todo[name]
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        target.with_name(target.name + ".log").write_text(out)
        os.replace(tmp, target)      # atomic: concurrent builders agree
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
