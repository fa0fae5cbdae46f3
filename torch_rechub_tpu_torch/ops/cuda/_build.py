"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

Libraries go to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of source and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built at import time:
the first launch builds, or a caller runs :func:`build_all` up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"hstu_rab_fwd": CSRC / "hstu_rab_fwd.cu", "hstu_rab_bwd": CSRC / "hstu_rab_bwd.cu", "hstu_attn_fwd": CSRC / "hstu_attn_fwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # name -> nvcc output (ptxas register/shared-memory report) of this process's builds


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit with nvcc (sm_90a) to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns the wall seconds spent; raises with nvcc's output if one fails.
    """
    t0 = time.perf_counter()
    todo = [n for n in (names or SOURCES) if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        build_log[name] = output
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))  # atomic: a concurrent builder sees a whole file or none
        else:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{output}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
