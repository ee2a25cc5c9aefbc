"""Fused collect -> train on the card: frames never leave the device (port of
``cilrs_tpu/train/fused.py``, its single-device path).

BASELINE.json config 5 ("fused rollout+train loop: parallel data collection
feeding on-TPU CILRS training"). A fleet of autopilot envs streams rendered
frames and labels into a device-resident uint8 ring; train steps sample from
the ring directly. The host issues the work and reads scalar losses at an
eval; no frame crosses to it.

The ring's frames are one page of the row-gather kernel
(``ops/gather.py``): ``[N, padded_row_elems(H*W*3)]`` uint8, so a train
batch and the validation snapshot each come out of it in one launch. The
ring's cursor and fill count depend only on the fixed chunk size, so they are
host ints: a draw bounded by the fill never reads the device.

Oversampling parity: the notebook's WeightedRandomSampler equalizes command
frequencies; here the equivalent inverse-frequency weighting is applied to
the per-sample loss, with running command counts kept on the device.

With a mesh (``parallel.mesh``: one process a GPU), the loop follows the JAX
package's ``shard_map`` program: each rank owns a block of the envs and a ring
of ``buffer_frames / N`` rows, collects with no collective but the sum of the
ring's counters, and trains on a local batch from its own ring with a sampler
stream of its own; the gradients, the BatchNorm running statistics and the
losses are averaged over the ranks in one flat all-reduce a step, so the
replicated weights stay bit-identical. BatchNorm normalizes by the local
batch's statistics in the forward, as under ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from cilrs_tpu_torch.agent.controller import ST_OK
from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import SPEED_NORM_FACTOR, TrainConfig
from cilrs_tpu_torch.data.collect import MIN_SPEED_KMH, CollectFleet, make_collect_fleet
from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.models.losses import cilrs_loss
from cilrs_tpu_torch.ops.gather import gather_rows_paged, padded_row_elems
from cilrs_tpu_torch.ops.image import normalize
from cilrs_tpu_torch.parallel.fleet import shard_collect_fleet
from cilrs_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_, all_reduce_sum_, replicate
from cilrs_tpu_torch.render.camera import CameraSpec
from cilrs_tpu_torch.render.raster import CAMERA
from cilrs_tpu_torch.train.loop import EMA, running_stats
from cilrs_tpu_torch.train.state import TrainState, create_train_state
from cilrs_tpu_torch.train.steps import make_train_forward

VAL_SEED_OFFSET = 10_000  # the val fleet is seeded seed + 10,000
SAMPLE_SEED_OFFSET = 7  # the sampler's draws: the JAX loop's PRNGKey(seed + 7)
# Rank r's sampler and step draws are seeded seed + 7 + RANK_SEED_STRIDE * r
# (the JAX loop folds the rank into its key): rank 0 draws the single path's.
RANK_SEED_STRIDE = 1_000_003
REDRAWS = 3  # redraws of an invalid pick


@dataclasses.dataclass
class ReplayBuffer:
    """Device-resident ring of labelled frames."""

    images: torch.Tensor  # [N, d_pad] uint8: a one-page table of the row-gather kernel
    speed: torch.Tensor  # [N] f32 normalized
    command: torch.Tensor  # [N] i32
    controls: torch.Tensor  # [N, 3] f32
    valid: torch.Tensor  # [N] bool
    total_written: torch.Tensor  # [] i64: valid frames ever written
    cmd_counts: torch.Tensor  # [4] f32: running command histogram, from ones
    image_shape: tuple
    cursor: int = 0
    filled: int = 0  # slots ever written, capped at N

    @property
    def capacity(self) -> int:
        return self.images.shape[0]


def make_buffer(capacity: int, h: int, w: int, device="cuda") -> ReplayBuffer:
    dev = require_cuda(device)
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
    return ReplayBuffer(
        images=z(capacity, padded_row_elems(h * w * 3, torch.uint8), dtype=torch.uint8),
        speed=z(capacity), command=z(capacity, dtype=torch.int32), controls=z(capacity, 3),
        valid=z(capacity, dtype=torch.bool), total_written=z(dtype=torch.int64),
        cmd_counts=torch.ones(4, dtype=torch.float32, device=dev), image_shape=(h, w, 3))


def _ring_slices(cursor: int, m: int, n: int):
    """(ring slots, chunk rows) slice pairs of the slots (cursor + arange(m)) % n."""
    first = min(m, n - cursor)
    yield slice(cursor, cursor + first), slice(0, first)
    if first < m:
        yield slice(0, m - first), slice(first, m)


def write_chunk(buf: ReplayBuffer, frames, speed_kmh, command, controls, moving,
                mesh: Mesh | None = None) -> ReplayBuffer:
    """Append a flattened chunk [M, ...] at the cursor (ring semantics), in
    place. Stationary frames are written but marked invalid (the reference
    skips them, collect_data.py:678-679). With a mesh, the ring is the rank's
    and the counters global: every rank adds the sum over the ranks of the
    chunk's valid frames and command counts (one all-reduce)."""
    m, n = frames.shape[0], buf.capacity
    if m > n:
        raise ValueError(f"a chunk of {m} frames does not fit a ring of {n}")
    d = int(np.prod(buf.image_shape))
    # XLA turns the division by a constant into a product with its reciprocal.
    cols = {"speed": torch.clamp(speed_kmh * (1.0 / SPEED_NORM_FACTOR), 0.0, 1.0), "command": command,
            "controls": controls, "valid": moving}
    for dst, src in _ring_slices(buf.cursor, m, n):
        buf.images[dst, :d].copy_(frames[src].reshape(-1, d))
        for k, v in cols.items():
            getattr(buf, k)[dst].copy_(v[src])
    cmds = torch.arange(4, dtype=command.dtype, device=command.device)
    counts = ((command[:, None] == cmds) & moving[:, None]).sum(0)
    inc = torch.cat([moving.sum()[None], counts]).double()  # exact integers
    if mesh is not None:
        all_reduce_sum_(mesh, [inc])
    buf.total_written += inc[0].long()
    buf.cmd_counts += inc[1:].float()
    buf.cursor = (buf.cursor + m) % n
    buf.filled = min(buf.filled + m, n)
    return buf


def _recent_rows(buf: ReplayBuffer, size: int) -> torch.Tensor:
    """The ring slots of the freshest ``size`` frames, oldest first."""
    return (buf.cursor - size + torch.arange(size, device=buf.images.device)) % buf.capacity


def _frames(buf: ReplayBuffer, rows: torch.Tensor) -> torch.Tensor:
    """Frames of ``rows`` [B] as [B, H, W, 3] uint8, through one launch of
    the row-gather kernel."""
    d = int(np.prod(buf.image_shape))
    out = gather_rows_paged((buf.images,), rows, buf.capacity)
    return out[:, :d].reshape((-1,) + tuple(buf.image_shape))


def snapshot_val_slice(buf: ReplayBuffer, size: int) -> dict:
    """Snapshot the freshest ``size`` frames of a ring as a validation set."""
    rows = _recent_rows(buf, size)
    return {"images": _frames(buf, rows), "speed": buf.speed[rows], "command": buf.command[rows],
            "controls": buf.controls[rows], "valid": buf.valid[rows]}


def freeze_val_slice(buf: ReplayBuffer, size: int):
    """snapshot_val_slice, then mark those entries invalid in the ring (when
    the val slice is carved out of the training stream). Returns (buf, val)."""
    val = snapshot_val_slice(buf, size)
    buf.valid[_recent_rows(buf, size)] = False
    return buf, val


def draw_indices(gen: torch.Generator, batch: int, high: int) -> torch.Tensor:
    """The sampler's draws: [1 + REDRAWS, batch] uniform ints in [0, high),
    the first draw and its redraws, on ``gen``'s device."""
    return torch.randint(0, high, (1 + REDRAWS, batch), generator=gen, device=gen.device)


def sample_batch(buf: ReplayBuffer, draws: torch.Tensor) -> dict:
    """A batch from the written region of the ring: picks from ``draws``
    (``draw_indices`` over [0, max(filled, 1))), an invalid pick (stationary
    or held out) replaced by the next redraw, and inverse-command-frequency
    loss weights, normalized to mean 1 and zeroed on a pick that stays
    invalid. ``idx`` holds the picks."""
    idx = draws[0]
    for alt in draws[1:]:
        idx = torch.where(buf.valid[idx], idx, alt)
    ok = buf.valid[idx]
    freq = buf.cmd_counts / buf.cmd_counts.sum()
    command = buf.command[idx]
    w = 1.0 / torch.clamp(freq[command.long()], min=1e-6)
    w = w / w.mean() * ok.float()
    return {"images": _frames(buf, idx), "speed": buf.speed[idx], "command": command,
            "controls": buf.controls[idx], "weights": w, "idx": idx}


def make_weighted_train_step(cfg: TrainConfig, mesh: Mesh | None = None):
    """The per-sample-weighted train step. The loss weights are ``cfg.loss``
    as they are (no train-time boosts, unlike ``train.steps.make_train_step``);
    ``plain_loss`` is the unweighted ``cilrs_loss``. The step's draws depend
    only on (seed, step). With a mesh (the JAX step's ``axis_name``), the
    gradients, the BatchNorm running statistics and both losses are averaged
    over the ranks in one flat all-reduce before the update (so the clip
    sees the averaged gradient)."""
    loss_cfg = cfg.loss
    forward = make_train_forward()

    def step(state: TrainState, batch: dict, seed: int) -> dict:
        """Updates ``state`` in place; returns the losses on the device."""
        controls, pred_speed = forward(state, batch, seed)
        w = batch["weights"]
        l1 = (controls - batch["controls"]).abs()
        per = (loss_cfg.steer_weight * l1[:, 0] + loss_cfg.throttle_weight * l1[:, 1]
               + loss_cfg.brake_weight * l1[:, 2]
               + loss_cfg.speed_weight * (pred_speed - batch["speed"]) ** 2)
        total = (per * w).sum() / torch.clamp(w.sum(), min=1e-6)
        # Unweighted loss, comparable with the reference's val metric.
        plain, _ = cilrs_loss(controls, pred_speed, batch["controls"], batch["speed"], loss_cfg)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        losses = torch.stack([total.detach(), plain.detach()])
        if mesh is not None:
            model = state.model
            all_reduce_mean_(mesh, [p.grad for p in model.parameters() if p.grad is not None]
                             + running_stats(model) + [losses])
        state.apply_gradients()
        return {"loss": losses[0], "plain_loss": losses[1]}

    return step


def collect_chunk(fleet: CollectFleet, buf: ReplayBuffer, mesh: Mesh | None = None) -> None:
    """One chunk of the fleet into the ring, flattened env-major (row e*T +
    t). Label hygiene: only moving frames of nominal driving are valid;
    recovery episodes steer by a hash, which behaviour cloning cannot learn."""
    outs = fleet.chunk()
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    speed = flat(outs["speed_kmh"])
    write_chunk(buf, flat(outs["frame"]), speed, flat(outs["command"]), flat(outs["control"]),
                (speed > MIN_SPEED_KMH) & (flat(outs["status"]) == ST_OK), mesh)


def train_chunk(state: TrainState, buf: ReplayBuffer, gen: torch.Generator, step, batch: int,
                steps: int, seed: int) -> torch.Tensor:
    """``steps`` weighted train steps from the ring; the last step's plain
    loss, on the device."""
    for _ in range(steps):
        parts = step(state, sample_batch(buf, draw_indices(gen, batch, max(buf.filled, 1))), seed)
    return parts["plain_loss"]


@torch.inference_mode()
def eval_loss(model: torch.nn.Module, val: dict, batch: int, loss_cfg,
              mesh: Mesh | None = None) -> torch.Tensor:
    """Loss over the validation set in batches of ``batch``, masked by
    validity, with ``model`` in eval mode: [5] on the device, the total and
    the weighted steer/throttle/brake/speed terms. With a mesh, ``val`` is the
    rank's block, and the sums and the count are summed over the ranks."""
    model.eval()
    dev = val["speed"].device
    s, c = torch.zeros(4, device=dev), torch.zeros((), device=dev)
    for i in range(0, val["speed"].shape[0], batch):
        sl = {k: v[i:i + batch] for k, v in val.items()}
        controls, pred_speed = model(normalize(sl["images"].float() / 255.0), sl["speed"],
                                     sl["command"])
        l1 = (controls - sl["controls"]).abs()
        terms = torch.stack([loss_cfg.steer_weight * l1[:, 0], loss_cfg.throttle_weight * l1[:, 1],
                             loss_cfg.brake_weight * l1[:, 2],
                             loss_cfg.speed_weight * (pred_speed - sl["speed"]) ** 2])  # [4, B]
        m = sl["valid"].float()
        s = s + (terms * m).sum(1)
        c = c + m.sum()
    if mesh is not None:
        sums = torch.cat([s, c[None]])
        all_reduce_sum_(mesh, [sums])
        s, c = sums[:4], sums[4]
    terms = s / torch.clamp(c, min=1.0)
    return torch.cat([terms.sum()[None], terms])


def fused_collect_train(
    net: RoadNetwork,
    cfg: TrainConfig | None = None,
    num_envs: int = 32,
    num_vehicles: int = 12,
    num_pedestrians: int = 6,
    buffer_frames: int = 65_536,
    collect_ticks: int = 20,
    train_steps_per_chunk: int = 4,
    total_train_steps: int = 2_000,
    warmup_chunks: int = 24,
    settle_fraction: float = 0.25,
    seed: int = 0,
    cam: CameraSpec = CAMERA,
    eval_every: int = 200,
    verbose: bool = True,
    mesh=None,
    device="cuda",
) -> dict[str, Any]:
    """Run the fused loop on ``device``. Returns {state (the EMA weights
    deployed), history, frames_collected, train_steps, wall_s,
    frames_per_sec_train}.

    A train fleet (env e in weather e % 5, each ego at its route's start
    waypoint) fills the ring for ``warmup_chunks`` chunks. An independent val
    fleet (seed + 10,000) fills a ring of its own, whose freshest V frames
    become the held-out set before that ring is freed. Then each round
    collects a chunk (until the settle tail: the last ``settle_fraction`` of
    the steps train on the final ring) and trains ``train_steps_per_chunk``
    steps, followed by one EMA update; every ``eval_every`` steps both the
    EMA and the raw weights are scored on the held-out set.

    With ``mesh`` (``parallel.mesh.make_mesh()``), this rank runs its block
    of both fleets (every rank builds the whole fleets, so the host's draws
    and the per-env seeds are the world-1 ones), a ring of ``buffer_frames /
    N`` rows and a local batch of ``max(B // N, 1)``; its held-out set is the
    freshest ``max(V_local_total, B)`` frames of its val ring (``V_local_total
    = (min(4096, buffer_frames // 4) // (B N)) B``), and the evals sum over
    the ranks. Only rank 0 prints."""
    cfg = cfg or TrainConfig()
    dev = require_cuda(device)
    B = cfg.training.batch_size
    n = 1 if mesh is None else mesh.world
    if num_envs % n or buffer_frames % n:
        raise ValueError(f"{num_envs} envs and a {buffer_frames}-frame ring must split "
                         f"over {n} ranks")
    verbose = verbose and (mesh is None or mesh.rank == 0)
    # Each ego starts at its route's start waypoint: spawned elsewhere, pure
    # pursuit toward a distant route makes off-route labels that poison the
    # early data. The val stream is a second fleet, not a slice of the train
    # stream's warm-up (a young synchronized fleet, and train frames until
    # the ring recycles them).
    fleet = make_collect_fleet(net, num_envs, num_vehicles, num_pedestrians, None, seed,
                               collect_ticks, cam, dev)
    vfleet = make_collect_fleet(net, num_envs, num_vehicles, num_pedestrians, None,
                                seed + VAL_SEED_OFFSET, collect_ticks, cam, dev)
    state = create_train_state(cfg, seed, steps_per_epoch=max(total_train_steps // cfg.training.epochs, 1),
                               schedule="cosine", total_steps=total_train_steps, device=dev)
    sample_seed = seed + SAMPLE_SEED_OFFSET
    # Held-out set: at least one batch (B > buffer/4 would floor V to 0).
    V = max((min(4096, buffer_frames // 4) // B) * B, B)
    if mesh is not None:
        fleet, vfleet = shard_collect_fleet(fleet, mesh), shard_collect_fleet(vfleet, mesh)
        replicate(mesh, list(state.model.parameters()) + list(state.model.buffers()))
        sample_seed += RANK_SEED_STRIDE * mesh.rank
        val_size = max((min(4096, buffer_frames // 4) // (B * n)) * B, B)
        B_local = max(B // n, 1)
    else:
        val_size, B_local = V, B
    buf = make_buffer(buffer_frames // n, cam.height, cam.width, dev)
    # Polyak average of the params and the BatchNorm statistics together,
    # for evaluation and deployment: one update a chunk.
    ema = EMA(state.model)
    step = make_weighted_train_step(cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(sample_seed)

    t0 = time.time()
    for _ in range(warmup_chunks):
        collect_chunk(fleet, buf, mesh)
    if verbose:
        frames0 = int(buf.total_written)
        print(f"  warmup: {frames0} frames in {time.time() - t0:.1f}s "
              f"({frames0 / max(time.time() - t0, 1e-9):,.0f} frames/s)", flush=True)

    vbuf = make_buffer(buffer_frames // n, cam.height, cam.width, dev)
    for _ in range(max(warmup_chunks, (2 * V) // max(num_envs * collect_ticks, 1) + 1)):
        collect_chunk(vfleet, vbuf, mesh)
    val_set = snapshot_val_slice(vbuf, val_size)
    del vbuf, vfleet  # free the val ring before training starts

    # Settle tail: the stream is about one pass over each frame, so the last
    # settle_fraction of the steps trains on the final ring with the cosine
    # schedule riding to its end.
    stream_steps = int(total_train_steps * (1.0 - settle_fraction))
    steps_done = 0
    history = []
    t1 = time.time()
    while steps_done < total_train_steps:
        if steps_done < stream_steps:
            collect_chunk(fleet, buf, mesh)
        loss = train_chunk(state, buf, gen, step, B_local, train_steps_per_chunk, sample_seed)
        ema.update(state.model, train_steps_per_chunk)
        steps_done += train_steps_per_chunk
        if steps_done % eval_every < train_steps_per_chunk:
            terms = eval_loss(ema.model, val_set, B, cfg.loss, mesh).cpu().numpy()
            raw = eval_loss(state.model, val_set, B, cfg.loss, mesh).cpu().numpy()
            frames = int(buf.total_written)
            history.append({
                "step": steps_done, "val_loss": float(terms[0]),
                "val_steer": float(terms[1]), "val_throttle": float(terms[2]),
                "val_brake": float(terms[3]), "val_speed": float(terms[4]),
                "raw_val_loss": float(raw[0]), "raw_val_steer": float(raw[1]),
                "frames": frames, "time_s": time.time() - t1, "train_loss": float(loss),
            })
            if verbose:
                print(f"  step {steps_done}: holdout loss {terms[0]:.4f} "
                      f"[st {terms[1]:.3f} th {terms[2]:.3f} br {terms[3]:.3f} sp {terms[4]:.3f}] "
                      f"raw {raw[0]:.4f} [st {raw[1]:.3f}] (train {float(loss):.4f}, "
                      f"{frames:,} frames seen, {time.time() - t1:.0f}s)", flush=True)

    wall = time.time() - t1
    # Deploy the EMA iterate: it is what the holdout numbers measured.
    return {
        "state": dataclasses.replace(state, model=ema.model),
        "history": history,
        "frames_collected": int(buf.total_written),
        "train_steps": steps_done,
        "wall_s": wall,
        "frames_per_sec_train": steps_done * B / wall,
    }
