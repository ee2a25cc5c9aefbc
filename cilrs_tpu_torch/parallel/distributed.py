"""Process-group initialization (port of ``cilrs_tpu/parallel/distributed.py``).

The JAX package runs one process that sees every device of a host, and
``jax.distributed`` joins the hosts. PyTorch's idiom is one process a GPU,
launched by ``torchrun`` (``python -m torch.distributed.run``), which exports
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``
to each process. A rank here is a device of the JAX mesh.

A plain ``python -m ...`` launch exports none of those, and then
``initialize_distributed()`` is a no-op: the entry points keep their
single-device path.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    device: str | torch.device | None = None,
) -> bool:
    """Join the default process group. Returns True when a group exists
    afterwards (made here or before), False for a single-process run.

    Explicit arguments win over torchrun's variables: ``coordinator_address``
    ("host:port") over ``MASTER_ADDR``/``MASTER_PORT``, ``num_processes``
    over ``WORLD_SIZE``, ``process_id`` over ``RANK``, ``local_device_ids[0]``
    over ``LOCAL_RANK``. A world of 1 that they describe does join, so the
    sharded paths run in it. ``device`` is the type of device the ranks
    compute on (the GPU when one is present, else the CPU, by default): NCCL
    on a CUDA device, whose rank's GPU is set first, and gloo on the CPU."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        return False  # single process: nothing to do

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        if local_device_ids:
            local = local_device_ids[0]
        else:
            local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_coordinator() -> bool:
    """True on the process that writes checkpoints, histories and prints:
    rank 0, or the only process when there is no group."""
    return not dist.is_initialized() or dist.get_rank() == 0
