"""Build the hand-written CUDA kernels of ``csrc/`` at first use and load them.

Each source compiles with nvcc for Hopper (``sm_90a``) into a shared library
with a plain C interface, loaded with ``ctypes``. Each links the shared CUDA
runtime, ``libcudart.so.12``, which the loader resolves to the one PyTorch
has loaded, so the process holds one CUDA runtime, not one more a library
(nvcc's default is a static runtime in each). Libraries land in ``_build/``
beside this package, named by a hash of their source, so an edited source
rebuilds and an unchanged one loads at once. Nothing builds at import time:
the CPU tests import every module on machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

from cilrs_tpu_torch.utils.profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared", "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels build "
                       "at first use on a machine with the CUDA toolkit")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` goes, keyed by its source hash."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def build(names) -> dict[str, str]:
    """Compile every ``csrc/<name>.cu`` not built yet, one nvcc each, all
    started together, in one ``kernel_build`` span. Returns {name: ptxas
    report} for what was compiled."""
    todo = {name: library_path(name) for name in names}
    todo = {name: out for name, out in todo.items() if not os.path.exists(out)}
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with span("kernel_build"):
        procs = {}
        for name, out in todo.items():
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            reports[name] = log
    return reports


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(library_path(name))
