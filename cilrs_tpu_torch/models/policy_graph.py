"""A CILRS model as a fleet policy (``agent/driver.py:model_policy``): its
controls, without the speed head, replayed from a CUDA graph on the card.

The forward is about 220 small operations (the ResNet-34's convolutions,
BatchNorms and elementwise work, then the heads), and at a fleet's batch the
host takes longer to issue them than the card takes to run them. So on the
card, in eval mode and with grad off, ``ModelPolicy`` captures the forward
once for each input signature (``graph_key``) as a ``torch.cuda.CUDAGraph``
(``utils/cuda_graph.py``) and replays it on every later call: the inputs
are copied into the graph's static buffers, the graph replays, and the
controls are cloned out, so each call returns a fresh tensor. Every other
call runs the forward eagerly, as the model does: on the CPU, in train mode,
with grad on, and for a new signature while a ``torch.profiler`` runs
(nothing is captured under one).

A replay reads the parameters and buffers where they were at capture and
casts the weights to bf16 inside the graph, so an update in place
(``load_state_dict``, an optimizer step) carries over to the next replay; a
rebinding (``param.data = ...``, another module) does not: make a new policy
then. The forward draws nothing at random in eval mode, so no RNG is
captured.

Spans: ``policy_graph`` around each replay, with the copies in and the clone
out (its calls against the ``policy`` span's are the share of the fleet's
policy calls that replayed a graph); ``policy_capture`` around each capture,
its warm-up included.
"""

from __future__ import annotations

import torch

from cilrs_tpu_torch.utils.cuda_graph import Graph, capture, replay
from cilrs_tpu_torch.utils.profiling import profiler_running, span

_GRAPH = span("policy_graph")
_CAPTURE = span("policy_capture")


def graph_key(model: torch.nn.Module, image: torch.Tensor, speed_norm: torch.Tensor,
              cmd: torch.Tensor) -> tuple:
    """What a captured graph holds fixed: the device, the inputs' shapes and
    dtypes, and the model's autocast dtype (``model.dtype``)."""
    return (image.device, image.shape, image.dtype, speed_norm.shape, speed_norm.dtype,
            cmd.shape, cmd.dtype, model.dtype)


def graphable(model: torch.nn.Module, image) -> bool:
    """Whether a call may replay a graph: its inputs on the card, the model
    in eval mode, grad off (``inference_mode`` or ``no_grad``)."""
    return image.is_cuda and not model.training and not torch.is_grad_enabled()


class ModelPolicy:
    """``policy(image [E, H, W, 3] normalized, speed_norm [E], cmd [E]) ->
    controls [E, 3]``: ``model``'s controls, a fresh tensor each call, from a
    graph of its forward where ``graphable`` holds (see the module
    docstring). ``graphs`` holds the captures by ``graph_key``."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.graphs: dict[tuple, Graph] = {}

    def __call__(self, image: torch.Tensor, speed_norm: torch.Tensor,
                 cmd: torch.Tensor) -> torch.Tensor:
        model = self.model
        if not graphable(model, image):
            return model(image, speed_norm, cmd)[0]
        key = graph_key(model, image, speed_norm, cmd)
        g = self.graphs.get(key)
        if g is None:
            if profiler_running():
                return model(image, speed_norm, cmd)[0]
            with _CAPTURE:
                g = self.graphs[key] = capture(lambda *x: model(*x)[0], image, speed_norm, cmd)
        with _GRAPH:
            return replay(g, (image, speed_norm, cmd), "cilrs_policy_graph").clone()
