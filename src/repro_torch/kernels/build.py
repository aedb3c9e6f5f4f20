"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C launcher; it is compiled for
Hopper (``sm_90a``) into its own shared library under ``build/kernels/``
at the repository root, at first use.  All sources that need a build are
compiled at once, one ``nvcc`` process each.  A library's file name carries
a hash of its source, so an edited source is rebuilt and a stale build is
never loaded.  Nothing here runs at import time: the CPU tests import this
module on hosts with no ``nvcc``.
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
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("elastic_matmul", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None   # wall time of the last build


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's kernels "
                       "are built from source on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path,
                 verbose: bool = False) -> List[str]:
    cmd = [nvcc, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Sequence[str] = SOURCES, verbose: bool = False
          ) -> Dict[str, str]:
    """Compile every listed source that has no current library, all at once.

    Returns {name: compiler output} for the sources compiled now (the
    ``-Xptxas -v`` register/spill report when ``verbose``).  Raises with
    the compiler's output when a build fails.
    """
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if verbose or not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, out, subprocess.Popen(
            nvcc_command(nvcc, n, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, out, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (builds all at first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            for n in SOURCES:
                _libs[n] = ctypes.CDLL(str(library_path(n)))
            lib = _libs[name]
        return lib
