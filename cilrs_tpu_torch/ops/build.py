"""How the port reaches its native code: build, bind and launch.

A native source compiles at first use (never at import: the CPU tests import
every module on machines without nvcc) into ``_build/`` beside this package,
named by a hash of the source and the compiler's flags, so an edited source
rebuilds and an unchanged one loads at once: the CUDA kernels of ``csrc/``
with nvcc for Hopper (``sm_90a``), each a library with a plain C interface
loaded with ``ctypes``, and ``maps/native_graph.py``'s road graph with g++.
The kernels link the shared CUDA runtime, ``libcudart.so.12``, which the
loader resolves to the one PyTorch has loaded (nvcc's default is a static
runtime in each library).

Every kernel launch goes through ``launch``: the device and its current
stream, a profiler operation ``kernel::<name>`` (a profiler links a kernel to
the ranges around it only through an operation), the launcher's status
checked, and the launch counted on the public entry point (``fn.launches``),
the proof that a path ran on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

from cilrs_tpu_torch.utils.profiling import kernel_launch, span

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


def cached_library(src: str, flags, stem: str) -> str:
    """Where ``src`` compiled with ``flags`` goes: ``_build/<stem>_<digest>.so``,
    keyed by a hash of both."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{stem}_{digest}.so")


def compile_sources(compiler, flags, jobs: dict) -> dict[str, str]:
    """Compile each of ``jobs`` {key: (source, library)} whose library is not
    built yet, with ``compiler()`` (asked only if one is) and ``flags``, all
    started together, in one ``kernel_build`` span. Returns {key: the
    compiler's output} for what was compiled; raises RuntimeError with that
    output if a compile fails."""
    todo = {key: job for key, job in jobs.items() if not os.path.exists(job[1])}
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with span("kernel_build"):
        argv = [compiler(), *flags]
        procs = {}
        for key, (src, out) in todo.items():
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[key] = (subprocess.Popen([*argv, "-o", tmp, src], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), src, tmp, out)
        logs = {}
        for key, (proc, src, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(argv[0])} failed on {src}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            logs[key] = log
    return logs


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` goes, keyed by its source hash."""
    return cached_library(os.path.join(CSRC_DIR, f"{name}.cu"), NVCC_FLAGS, name)


def build(names) -> dict[str, str]:
    """Compile every ``csrc/<name>.cu`` not built yet, one nvcc each, all
    started together, in one ``kernel_build`` span. Returns {name: ptxas
    report} for what was compiled."""
    return compile_sources(nvcc_path, NVCC_FLAGS, {
        name: (os.path.join(CSRC_DIR, f"{name}.cu"), library_path(name)) for name in names})


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(library_path(name))


def bind_launchers(lib: ctypes.CDLL, name: str, argtypes: dict) -> ctypes.CDLL:
    """Declares ``lib``'s functions {C name: argtypes}, each returning an int
    status, and its ``<name>_error_string``, which ``launch`` reads as
    ``lib.error_string``."""
    for fn_name, types in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    lib.error_string = getattr(lib, f"{name}_error_string")
    lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


class Kernel:
    """A kernel's name for the profiler and, once it decorates it, its public
    entry point, whose ``.launches`` counts. The count goes on the function
    itself, not on the module's name for it, so a caller that wraps that name
    (a profiler range, a capture) still counts."""

    __slots__ = ("name", "entry")

    def __init__(self, name: str):
        self.name, self.entry = name, None

    def __call__(self, entry):
        entry.launches = 0
        self.entry = entry
        return entry


def launch(kernel: Kernel, lib: ctypes.CDLL, launcher, on: torch.Tensor, *args,
           counted: bool = True) -> None:
    """``launcher(*args, device, stream)`` of ``lib`` in ``kernel``'s profiler
    operation, on ``on``'s device and current stream (-1 and none for the CPU
    tensors of a host build). Raises on an error status, else counts a launch
    on the entry point if ``counted`` (a kernel was put on the stream)."""
    dev = on.device
    if dev.type == "cuda":
        index, stream = dev.index, torch.cuda.current_stream(dev).cuda_stream
    else:
        index, stream = -1, None
    with kernel_launch(kernel.name):
        status = launcher(*args, index, stream)
    if status:
        raise RuntimeError(f"{kernel.name} kernel launch failed: "
                           + lib.error_string(status).decode())
    if counted:
        kernel.entry.launches += 1
