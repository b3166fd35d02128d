"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, from the repository's sources only, into
``build/repro_torch/`` at the repository root (git-ignored). A library's
file name carries a hash of its sources, so an edited kernel rebuilds
and an unchanged one loads at once. All sources build in parallel, one
``nvcc`` each.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("serve_matmul", "fedpara_matmul", "fedpara_grad", "agg",
           "fedpara_compose")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the built library for source ``name`` lives."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Tuple[str, ...] = SOURCES) -> Dict[str, Dict[str, object]]:
    """Compile every missing library of ``names`` in parallel.

    Returns ``{name: {"path", "seconds", "log"}}`` for the libraries
    built by this call (already-built ones are skipped). Raises when
    ``nvcc`` fails, with its output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    t0 = time.perf_counter()
    procs: List[Tuple[str, subprocess.Popen, Path, Path]] = []
    try:
        for n in todo:
            procs.append((n, *_start(n)))
        built = {}
        for n, proc, tmp, out in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
            os.replace(tmp, out)
            built[n] = {"path": str(out),
                        "seconds": time.perf_counter() - t0, "log": log}
    finally:
        for _n, proc, tmp, _out in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, building all sources on
    first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
