"""Entry points for an outside harness (port of ``__graft_entry__.py``): the
full-width policy's forward, and a multi-rank dry run.

    from cilrs_tpu_torch.graft_entry import entry, dryrun_multichip
    fn, args = entry()          # on the card; entry("cpu") on the CPU
    controls, pred_speed = fn(*args)
    dryrun_multichip(2)         # two gloo ranks on the CPU
"""

from __future__ import annotations

import os
import socket
import tempfile

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import configure_numerics, require_cuda
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.train.state import flax_init_

BATCH = 8
FRAME_SHAPE = (88, 200, 3)
INIT_SEED = 0
DRYRUN_TICKS = 40
DRYRUN_MIN_DISTANCE_M = 1.0


def entry(device="cuda", state_dict: dict | None = None):
    """(fn, example_args): the forward of the full-width CILRS (ResNet-34
    trunk, dropout 0, eval mode) at batch 8 on ``device``. The weights are
    Flax's initialisers drawn from seed 0, or ``state_dict``. On the card the
    trunk runs in bf16 under autocast with ``channels_last`` weights and the
    float32 heads without TF32 (``configure_numerics``), as ``load_policy``
    runs a policy; on the CPU in float32."""
    dev = require_cuda(device)
    if dev.type == "cuda":
        configure_numerics()
    model = CILRS(dropout=0.0, dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    flax_init_(model, torch.Generator().manual_seed(INIT_SEED))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    img = torch.zeros((BATCH,) + FRAME_SHAPE, dtype=torch.float32, device=dev)
    speed = torch.zeros((BATCH,), dtype=torch.float32, device=dev)
    cmd = torch.zeros((BATCH,), dtype=torch.int32, device=dev)

    @torch.inference_mode()
    def fn(image, speed, command):
        controls, pred_speed = model(image, speed, command)
        return controls, pred_speed

    return fn, (img, speed, cmd)


def _dryrun_rank(rank: int, world: int, port: int, out_dir: str):
    """One rank of the dry run: a data-parallel train step, a sharded
    collect rollout and the sharded fused loop, on the CPU over gloo."""
    from cilrs_tpu_torch.agent.npc import draw_pedestrians
    from cilrs_tpu_torch.config import ModelConfig, TrainConfig, TrainingConfig
    from cilrs_tpu_torch.data.collect import make_collect_fleet
    from cilrs_tpu_torch.data.dataset import make_synthetic_dataset
    from cilrs_tpu_torch.maps.town import make_mini_town
    from cilrs_tpu_torch.parallel.distributed import initialize_distributed
    from cilrs_tpu_torch.parallel.fleet import make_sharded_rollout
    from cilrs_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from cilrs_tpu_torch.render.camera import CameraSpec
    from cilrs_tpu_torch.train.fused import fused_collect_train
    from cilrs_tpu_torch.train.state import create_train_state
    from cilrs_tpu_torch.train.steps import make_train_step

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(world, device="cpu")
        # A full data-parallel train step on tiny shapes: the sharded program
        # (batch split, gradient all-reduce, replicated weights) is the
        # full-width one; the block count only scales its cost.
        cfg = TrainConfig(model=ModelConfig(dropout=0.5, image_height=32, image_width=64,
                                            stage_sizes=(1, 1, 1, 1)),
                          training=TrainingConfig(batch_size=2 * world))
        state = create_train_state(cfg, 0, steps_per_epoch=10, device="cpu")
        ds = make_synthetic_dataset(4 * world, h=32, w=64)
        batch = shard_batch(mesh, {"images": ds.images[:2 * world],
                                   "speed": ds.speed_norm[:2 * world],
                                   "command": ds.command[:2 * world],
                                   "controls": ds.controls[:2 * world]})
        parts = make_train_step(cfg, mesh)(state, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()}, 1)
        loss = float(parts["loss"])

        # The sharded collect rollout: 2 envs a rank on the mini town, each
        # ego on its route's start; every ego must drive.
        cam = CameraSpec(width=64, height=32)
        envs = 2 * world
        fleet = make_collect_fleet(make_mini_town(), envs, 3, 2, None, 0, DRYRUN_TICKS, cam,
                                   device="cpu")
        draws = draw_pedestrians(torch.Generator().manual_seed(0), DRYRUN_TICKS, envs, 2, "cpu")
        run = make_sharded_rollout(mesh, DRYRUN_TICKS, fleet.wt, fleet.params, mode="collect",
                                   cam=cam, want_frames=False, pool_batched=True)
        finals, _ = run(fleet.state, fleet.net, fleet.pool, draws)
        distance = finals.metrics.total_distance.numpy()

        # The sharded fused collect -> train loop, one train step.
        out = fused_collect_train(make_mini_town(), cfg, num_envs=world, num_vehicles=3,
                                  num_pedestrians=2, buffer_frames=64 * world, collect_ticks=4,
                                  train_steps_per_chunk=1, total_train_steps=1, warmup_chunks=2,
                                  cam=cam, eval_every=1, verbose=False, mesh=mesh, device="cpu")
        fused_loss = out["history"][-1]["val_loss"] if out["history"] else float("nan")
        torch.save({"train_loss": loss, "fleet_distances": distance.tolist(),
                    "fused_val_loss": fused_loss},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> dict:
    """Run the data-parallel train step, the sharded rollout and the sharded
    fused loop on ``n_devices`` gloo ranks on the CPU (spawned here), check
    that the loss is finite and that every ego drove more than 1 m, and
    return rank 0's readings."""
    with tempfile.TemporaryDirectory(prefix="cilrs_dryrun_") as out_dir:
        torch.multiprocessing.spawn(_dryrun_rank, args=(n_devices, _free_port(), out_dir),
                                    nprocs=n_devices, join=True)
        res = torch.load(os.path.join(out_dir, "rank0.pt"), weights_only=False)
    d = np.asarray(res["fleet_distances"])
    if not np.isfinite(res["train_loss"]):
        raise AssertionError(f"non-finite loss {res['train_loss']}")
    if d.shape != (2 * n_devices,) or not np.isfinite(d).all():
        raise AssertionError(f"fleet distances {d.tolist()}")
    # 40 ticks = 2 s of sim from a standstill on a route start: every env's
    # teacher must drive, or the sharded rollout is broken in a way a run
    # that merely finishes cannot show.
    if not (d > DRYRUN_MIN_DISTANCE_M).all():
        raise AssertionError(f"sharded fleet egos did not move: {d.tolist()}")
    print(f"dryrun_multichip({n_devices}): train loss {res['train_loss']:.3f}, "
          f"fleet distances {d.round(2).tolist()}, "
          f"fused DP val loss {res['fused_val_loss']:.3f}")
    return res
