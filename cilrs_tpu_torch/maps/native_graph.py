"""ctypes bindings for the native C++ road-graph engine, ``native/roadgraph.cpp``
(port of ``cilrs_tpu/maps/native_graph.py``).

The source is shared with the JAX package; the port compiles its own copy
with g++ at first use (not at import) into ``cilrs_tpu_torch/_build/``, named
by a hash of the source (``ops/build.py``). ``maps/routing.py`` falls back to
a pure-Python Dijkstra when no C++ compiler is present.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from cilrs_tpu_torch.ops.build import cached_library, compile_sources

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "roadgraph.cpp")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_MAX_PATH = 8192


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled engine, built first if needed. Raises OSError (no g++)
    or RuntimeError (g++ failed) when it cannot be built."""
    path = cached_library(SRC, _FLAGS, "libroadgraph")
    compile_sources(lambda: "g++", _FLAGS, {"roadgraph": (SRC, path)})
    lib = ctypes.CDLL(path)
    lib.rg_build.restype = ctypes.c_void_p
    lib.rg_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
    ]
    lib.rg_free.restype = None
    lib.rg_free.argtypes = [ctypes.c_void_p]
    lib.rg_shortest_path.restype = ctypes.c_int32
    lib.rg_shortest_path.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    return lib


class NativeGraph:
    """One road graph held by the native engine; freed with the object."""

    def __init__(self, xy: np.ndarray, nxt: np.ndarray, num_next: np.ndarray):
        self._lib = library()
        self._arrays = (np.ascontiguousarray(xy, np.float32),
                        np.ascontiguousarray(nxt, np.int32),
                        np.ascontiguousarray(num_next, np.int32))
        xy, nxt, num_next = self._arrays
        W, max_next = nxt.shape
        if xy.shape != (W, 2) or num_next.shape != (W,):
            raise ValueError(f"graph arrays disagree: xy {xy.shape}, next {nxt.shape}, "
                             f"num_next {num_next.shape}")
        self.W = W
        self._h = self._lib.rg_build(
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nxt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_next.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            W, max_next,
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rg_free(self._h)
            self._h = None

    def shortest_path(self, src: int, dst: int) -> np.ndarray:
        if not (0 <= src < self.W and 0 <= dst < self.W):
            raise IndexError(f"waypoint out of range: {src} -> {dst} (W={self.W})")
        out = np.empty(_MAX_PATH, np.int32)
        n = self._lib.rg_shortest_path(
            self._h, src, dst, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _MAX_PATH)
        return out[:n].copy()
