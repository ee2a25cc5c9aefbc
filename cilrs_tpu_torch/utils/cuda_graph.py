"""CUDA graphs of the port's per-tick calls: a call captured once as a
``torch.cuda.CUDAGraph`` over static copies of its inputs, then replayed.

At a fleet's batch the host takes longer to issue a layer's hundreds of
small operations than the card takes to run them; a replay issues them all
in one launch. ``capture`` warms the call up and captures it; ``replay``
copies fresh inputs into the capture's static buffers and replays. What a
replay returns is the capture's own output, which the next replay
overwrites: a caller clones what it hands on. The callers keep their
captures by what a graph holds fixed (devices, shapes, dtypes, the objects
whose tensors it reads by address) and decide when a call may replay
(``models/policy_graph.py``, ``agent/controller.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from cilrs_tpu_torch.utils.profiling import kernel_launch

# Eager calls on a side stream before a capture, as
# ``torch.cuda.make_graphed_callables`` makes them: cuDNN and cuBLAS settle
# their algorithms and workspaces, and lazily made constants
# (``core/geometry.py:const``) exist, before the graph fixes them.
WARMUP_CALLS = 3


class Graph(NamedTuple):
    """A captured call: the graph, its static inputs and its output."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    out: Any


def capture(fn: Callable, *args: torch.Tensor) -> Graph:
    """Warm ``fn`` up on a side stream on copies of ``args`` (tensors on one
    card), then capture ``fn`` over those copies."""
    dev = args[0].device
    with torch.cuda.device(dev):
        # Normal tensors, not inference tensors: a later call may copy into
        # them outside ``inference_mode``.
        with torch.inference_mode(False):
            inputs = tuple(torch.empty_like(x) for x in args)
        for static, x in zip(inputs, args):
            static.copy_(x)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # Thread-local: only this thread's calls are checked during the
        # capture, so a collective library's watchdog thread (the sharded
        # fleet's) cannot fail it.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn(*inputs)
    return Graph(graph, inputs, out)


def replay(g: Graph, args: tuple, name: str):
    """Copy ``args`` into ``g``'s static inputs and replay it in a
    ``kernel::<name>`` operation (so a profiler links the graph's kernels to
    the ranges around it); returns ``g.out``, which the next replay
    overwrites."""
    # One call, each input's copy in turn (a copy kernel apiece unless all
    # share a dtype and layout), without a Python dispatch a copy.
    torch._foreach_copy_(g.inputs, args)
    with kernel_launch(name):
        g.graph.replay()
    return g.out
