"""The training loop from a card-resident frame table (port of
``cilrs_tpu/train/loop.py``): epochs of K-step groups, a Polyak average
(EMA) of the weights, validation, early stopping, history and checkpoints.

Every group of K = 25 train batches, and every group of up to 50 eval
batches, gathers its frames from the table with one launch of the row-gather
kernel (``ops.gather.gather_rows_paged``); the labels come by plain indexing
on the device. The per-step losses stay on the device and cross to the host
once an epoch. The group functions are at module level, so that a caller can
time them alone.

The table is either the caller's (``resident=``, the dict that
``data.resident.ship_resident`` returns: global rows, val rows read in place,
or snapshotted through the kernel into their own table when ``refresh_fn``
swaps the train table) or shipped once from ``ds`` (the train split and a val
subset, each capped as the JAX package caps them).

With a mesh of more than one rank (``parallel.mesh``), the loop takes the
JAX package's host-batch branch instead: the weighted sampler draws the
global batch on every rank, each rank gathers its block from the host
arrays, pins it and copies it to its GPU on a prefetch thread, and the train
step is data parallel (``train.steps``: global-batch BatchNorm, averaged
gradients). The EMA updates once a step, and validation runs the whole val
split in sharded host batches whose loss and per-command sums are
all-reduced. A mesh of 1 keeps the resident path.

The JAX package's multi-page split gather and its ``CILRS_TPU_FUSED_GATHER``
/ ``CILRS_TPU_EVAL_ONESHOT`` switches work around TPU compiler faults and
have no counterpart here (one kernel launch serves every page).
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import COMMAND_NAMES, TrainConfig
from cilrs_tpu_torch.data.dataset import DriveDataset, WeightedBatchSampler, stratified_split
from cilrs_tpu_torch.data.resident import LABEL_KEYS, gather_group, ship_resident, snapshot_rows
from cilrs_tpu_torch.parallel.distributed import is_coordinator
from cilrs_tpu_torch.parallel.mesh import Mesh, all_reduce_sum_, block, replicate
from cilrs_tpu_torch.train import checkpoint as ckpt
from cilrs_tpu_torch.train.state import TrainState, create_train_state
from cilrs_tpu_torch.train.steps import make_eval_step, make_train_step

STEPS_PER_CALL = 25  # train batches per gather launch (K)
EVAL_GROUP_BATCHES = 50  # eval batches per gather launch: <= 6,000 rows at batch 120


def _slices(batch: dict, k: int, b: int):
    for i in range(k):
        yield {key: v[i * b:(i + 1) * b] for key, v in batch.items()}


def train_group(state: TrainState, table: dict, idxs: np.ndarray, seed: int, train_step) -> torch.Tensor:
    """One gather and ``len(idxs)`` train steps; the steps' losses [K] on the device."""
    k, b = idxs.shape
    return torch.stack([train_step(state, batch, seed)["loss"]
                        for batch in _slices(gather_group(table, idxs), k, b)])


def eval_group(model: torch.nn.Module, table: dict, idxs: np.ndarray, eval_step):
    """One gather and ``len(idxs)`` eval steps: (losses [K], per-command
    |steer error| sums [K, 4], counts [K, 4]) on the device."""
    k, b = idxs.shape
    outs = [eval_step(model, batch) for batch in _slices(gather_group(table, idxs), k, b)]
    return (torch.stack([o["loss"] for o in outs]), torch.stack([o["cmd_steer_err_sum"] for o in outs]),
            torch.stack([o["cmd_count"] for o in outs]))


def _prefetch(it, make, depth: int = 3):
    """``make(item)`` for each item of ``it`` on a worker thread, up to
    ``depth`` results queued ahead, so the host gather and the copy to the
    card overlap the card's current step. An exception in the worker is
    raised here."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(make(item))
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)
        q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while (out := q.get()) is not stop:
        if isinstance(out, BaseException):
            raise out
        yield out


def host_batch(ds: DriveDataset, rows: np.ndarray, mesh: Mesh, device: torch.device) -> dict:
    """The rank's block of the global batch ``rows`` from the host arrays, on
    ``device`` (through pinned memory, without waiting, on a GPU)."""
    rows = rows[block(mesh, len(rows))]
    batch = {"images": ds.images[rows], "speed": ds.speed_norm[rows], "command": ds.command[rows],
             "controls": ds.controls[rows]}
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def _validate_dp(model: torch.nn.Module, ds: DriveDataset, val_batches: np.ndarray, eval_step,
                 mesh: Mesh, device: torch.device):
    """_validate over sharded host batches: each rank evaluates its block of
    every batch; the batch losses (means over equal blocks) and the
    per-command sums are summed over the ranks in one all-reduce."""
    model.eval()
    sums = torch.zeros(9, dtype=torch.float64, device=device)
    for batch in _prefetch(val_batches, lambda r: host_batch(ds, r, mesh, device)):
        parts = eval_step(model, batch)
        sums += torch.cat([parts["loss"][None], parts["cmd_steer_err_sum"], parts["cmd_count"]])
    all_reduce_sum_(mesh, [sums])
    sums = sums.cpu().numpy()
    vl = float(sums[0] / (len(val_batches) * mesh.world)) if len(val_batches) else float("nan")
    return vl, sums[1:5], sums[5:]


def _table(src: dict, page_rows: int, image_shape: tuple) -> dict:
    images = src["images"] if isinstance(src["images"], tuple) else (src["images"],)
    return {"images": images, "page_rows": page_rows, "image_shape": image_shape,
            **{k: src[k] for k in LABEL_KEYS}}


def running_stats(model: torch.nn.Module) -> list[torch.Tensor]:
    """The BatchNorm running statistics of ``model`` (``num_batches_tracked``
    is a counter, not a statistic)."""
    return [b for name, b in model.named_buffers() if not name.endswith("num_batches_tracked")]


def _averaged(model: torch.nn.Module) -> list[torch.Tensor]:
    """The tensors the EMA averages: every parameter and BN running statistic."""
    return list(model.parameters()) + running_stats(model)


class EMA:
    """Polyak average of a model's parameters and BatchNorm statistics, held
    in a copy of the model (the eval/deploy iterate). Decay per update of a
    dispatch of K steps: min(0.999**K, (1+n)/(10+n)), n the update count, so
    the average forgets the random init fast."""

    def __init__(self, model: torch.nn.Module):
        self.model = copy.deepcopy(model).eval().requires_grad_(False)
        for p in self.model.parameters():
            p.grad = None
        self.updates = 0

    @torch.no_grad()
    def update(self, model: torch.nn.Module, steps_in_dispatch: int):
        self.updates += 1
        d = min(0.999 ** steps_in_dispatch, (1.0 + self.updates) / (10.0 + self.updates))
        dst = _averaged(self.model)
        torch._foreach_mul_(dst, d)
        torch._foreach_add_(dst, _averaged(model), alpha=1.0 - d)


def _validate(model: torch.nn.Module, table: dict, val_batches: np.ndarray, eval_step):
    """Full val pass in groups of <= EVAL_GROUP_BATCHES: (mean loss,
    per-command |steer error| sums [4], counts [4]); one host sync."""
    model.eval()
    outs = [eval_group(model, table, val_batches[s:s + EVAL_GROUP_BATCHES], eval_step)
            for s in range(0, len(val_batches), EVAL_GROUP_BATCHES)]
    losses, errs, cnts = (torch.cat(t).cpu().numpy() for t in zip(*outs))
    vl = float(np.mean(losses.astype(np.float64))) if len(losses) else float("nan")
    return vl, errs.sum(axis=0).astype(np.float64), cnts.sum(axis=0).astype(np.float64)


def train(
    ds: DriveDataset,
    cfg: TrainConfig | None = None,
    ckpt_dir: str | None = None,
    resume: bool = False,
    device="cuda",
    steps_per_epoch: int | None = None,
    verbose: bool = True,
    pretrained_backbone: str | None = None,
    resident: dict | None = None,
    ckpt_every: int = 5,
    refresh_fn=None,
    refresh_every: int = 0,
    init_from: str | None = None,
    max_train_frames: int | None = None,
    train_row_mask: np.ndarray | None = None,
    eval_every: int = 1,
    stream_seed: int | None = None,
    mesh: Mesh | None = None,
) -> dict:
    """Full training run on ``device``. Returns {"history", "best_val_loss",
    "state" (the raw iterate, the resume point), "eval_state" (the deployed
    weights: the EMA when enabled), "val_table", "val_rows", "group_losses"
    (the mean train loss of every K-step group, in order)}.

    With ``resident`` (a paged table on ``device``: images tuple, page_rows,
    image_shape and device labels), nothing ships: train batches gather from
    it by global row, and ``ds`` carries only host labels (images=None) for
    the stratified split and the weighted sampler. With ``refresh_fn``
    (resident mode only), every ``refresh_every`` epochs the train table is
    swapped for ``refresh_fn(i)`` = (table, labels_ds) with the same
    ``page_rows``; the val rows were snapshotted first, so val_loss stays
    comparable across refreshes.

    With ``mesh`` of more than one rank (``parallel.mesh.make_mesh()``, one
    process a GPU on ``device``), the data-parallel host-batch branch runs
    (see the module docstring): the batch is rounded to a multiple of the
    world size, ``ds`` must hold the images, and ``resident`` is refused.
    Only rank 0 prints and writes checkpoints.
    """
    cfg = cfg or TrainConfig()
    dev = require_cuda(device)
    dp = mesh is not None and mesh.world > 1
    if dp and resident is not None:
        raise ValueError("resident-table training is the single-device path: a mesh of "
                         f"{mesh.world} ranks trains from host batches")
    # Only rank 0 prints and writes; every rank reads a resume checkpoint.
    verbose = verbose and is_coordinator()
    save_dir = ckpt_dir if is_coordinator() else None
    if refresh_fn is not None and (max_train_frames is not None or train_row_mask is not None):
        # The restrictions hold for the INITIAL split only; a refresh would
        # silently drop them.
        raise ValueError(
            "max_train_frames / train_row_mask cannot be combined with "
            "refresh_fn: the restriction would be silently dropped at the "
            "first table refresh")

    train_idx, val_idx = stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
    if max_train_frames is not None and len(train_idx) > max_train_frames:
        # Train-split subsample at a FIXED val split (dataset-scaling bisects).
        sub = np.random.RandomState(cfg.training.seed + 7).choice(
            len(train_idx), max_train_frames, replace=False)
        train_idx = train_idx[np.sort(sub)]
        if verbose:
            print(f"  train split subsampled to {len(train_idx)} frames "
                  f"(max_train_frames)", flush=True)
    if train_row_mask is not None:
        before = len(train_idx)
        train_idx = train_idx[train_row_mask[train_idx]]
        if verbose:
            print(f"  train split restricted {before} -> {len(train_idx)} rows "
                  f"(train_row_mask)", flush=True)
    B = cfg.training.batch_size
    if dp:  # even blocks
        B = max(mesh.world, (B // mesh.world) * mesh.world)
    spe = steps_per_epoch or max(1, len(train_idx) // B)

    # stream_seed reseeds init, sampler and the step draws, leaving the split
    # at cfg.training.seed.
    sseed = cfg.training.seed if stream_seed is None else stream_seed
    state = create_train_state(cfg, sseed, spe, device=dev)
    if init_from:
        # Warm start from another run's best slot (params + BN stats; fresh
        # optimizer and schedule).
        state = ckpt.restore_best_params(init_from, state)
        if verbose:
            print(f"  params initialized from {init_from} (best slot)")
    if pretrained_backbone:
        from cilrs_tpu_torch.models.convert import load_torchvision_trunk

        load_torchvision_trunk(state.model, pretrained_backbone)
        if verbose:
            print(f"  trunk initialized from {pretrained_backbone} "
                  f"(ImageNet-pretrained resnet34, notebook PART B parity)")
    if dp:
        replicate(mesh, list(state.model.parameters()) + list(state.model.buffers()))
    start_epoch, best_val = 0, float("inf")
    if resume and ckpt_dir:
        state, start_epoch, best_val = ckpt.restore_latest(ckpt_dir, state)
        if verbose and start_epoch:
            print(f"  resumed from epoch {start_epoch} (val {best_val:.4f})")

    train_step = make_train_step(cfg, mesh if dp else None)
    eval_step = make_eval_step(cfg)
    ema = EMA(state.model) if cfg.training.ema_eval else None

    res_mode = resident is not None
    if res_mode:
        # A bare images tensor is a single page.
        page_rows = int(resident.get("page_rows", 0))
        image_shape = tuple(resident["image_shape"])
        train_table = _table(resident, page_rows, image_shape)
        if train_table["images"][0].device.type != dev.type:
            raise ValueError(f"resident table on {train_table['images'][0].device}, training on {dev}")
        resident = None  # must not pin the table once refresh_fn swaps it
        if refresh_fn is None:
            # Fixed table: the val rows are read in place by global row.
            val_table, val_rows = train_table, np.asarray(val_idx)
        else:
            val_table, val_rows = snapshot_rows(train_table, val_idx), np.arange(len(val_idx))
    elif dp:  # host batches of the whole split, as the JAX package's
        train_table = val_table = None
        val_rows = np.asarray(val_idx)
    else:
        frame_bytes = int(np.prod(ds.images.shape[1:])) * ds.images.itemsize
        # The JAX package's caps (a 16 GB TPU's HBM), kept so both packages
        # train and validate on the same rows.
        cap_train = int(8.4e9 // frame_bytes)
        cap_val = int(0.5e9 // frame_bytes)
        rng_np = np.random.RandomState(cfg.training.seed + 5)
        if len(train_idx) > cap_train:
            sel = rng_np.choice(len(train_idx), cap_train, replace=False)
            train_idx = train_idx[np.sort(sel)]
            if verbose:
                print(f"  resident train subset: {cap_train} frames (8.4 GB cap)", flush=True)
        val_res = (val_idx if len(val_idx) <= cap_val else
                   val_idx[np.sort(rng_np.choice(len(val_idx), cap_val, replace=False))])
        train_table = ship_resident(ds, dev, idx=train_idx)
        val_table = ship_resident(ds, dev, idx=val_res)
        val_rows = np.arange(len(val_res))

    sampler = WeightedBatchSampler(
        ds.command[train_idx], B, sseed,
        controls=ds.controls[train_idx],
        hard_boost=cfg.training.hard_frame_boost,
    )
    seed = sseed + 1  # the JAX loop's PRNGKey(sseed + 1)

    # When the val split is smaller than one batch, wrap around so that one
    # (padded) batch runs; otherwise whole batches, the tail dropped.
    if len(val_rows) < B:
        val_batches = np.resize(val_rows, B)[None]
    else:
        val_batches = np.stack([val_rows[s:s + B] for s in range(0, len(val_rows) - B + 1, B)])

    history, group_losses = [], []
    patience = 0
    refresh_round = 1
    for epoch in range(start_epoch, cfg.training.epochs):
        t0 = time.time()
        # Local positions within train_idx: rows of the shipped split, or
        # global rows of the caller's table through train_idx.
        its = np.stack(list(sampler.epoch(spe)))
        losses = []
        if dp:
            for batch in _prefetch(its, lambda it: host_batch(ds, train_idx[it], mesh, dev)):
                losses.append(train_step(state, batch, seed)["loss"])
                if ema is not None:
                    ema.update(state.model, 1)
            losses = [torch.stack(losses[s:s + STEPS_PER_CALL]) for s in range(0, spe, STEPS_PER_CALL)]
        else:
            for s in range(0, spe, STEPS_PER_CALL):
                grp = its[s:s + STEPS_PER_CALL]
                losses.append(train_group(state, train_table, train_idx[grp] if res_mode else grp,
                                          seed, train_step))
                if ema is not None:
                    ema.update(state.model, len(grp))
        losses = [l.cpu().numpy() for l in losses]  # the epoch's one sync of train losses
        group_losses += [float(np.mean(l)) for l in losses]
        train_loss = float(np.mean(np.concatenate(losses)))

        # Validation on the EMA when enabled (the deployed weights are then
        # exactly what the val numbers measured), and on the raw iterate.
        eval_state = dataclasses.replace(state, model=ema.model) if ema is not None else state
        do_eval = (epoch + 1) % max(eval_every, 1) == 0 or epoch + 1 == cfg.training.epochs
        if dp:
            validate = lambda model: _validate_dp(model, ds, val_batches, eval_step, mesh, dev)
        else:
            validate = lambda model: _validate(model, val_table, val_batches, eval_step)
        if do_eval:
            val_loss, err_sum, cnt = validate(eval_state.model)
            val_loss_raw = validate(state.model)[0] if ema is not None else val_loss
        else:
            val_loss = val_loss_raw = float("nan")
            err_sum, cnt = np.zeros(4), np.zeros(4)
        cmd_err = {COMMAND_NAMES[i]: float(err_sum[i] / max(cnt[i], 1)) for i in range(4)}

        ep_time = time.time() - t0
        history.append({
            "epoch": epoch + 1, "train_loss": train_loss, "val_loss": val_loss,
            "val_loss_raw": val_loss_raw, "time_s": ep_time,
            **{f"steer_err_{k}": v for k, v in cmd_err.items()},
        })
        if verbose:
            raw_note = f" raw {val_loss_raw:.4f}" if ema is not None else ""
            print(f"  epoch {epoch + 1}/{cfg.training.epochs}: train {train_loss:.4f} "
                  f"val {val_loss:.4f}{raw_note} ({ep_time:.1f}s) cmd_err {cmd_err}", flush=True)

        # Deploy whichever iterate the val pass scored lower.
        cand_val, cand_state = val_loss, eval_state
        if ema is not None and val_loss_raw < cand_val:
            cand_val, cand_state = val_loss_raw, state
        improved = do_eval and cand_val < best_val
        if improved:
            best_val = cand_val
            patience = 0
        elif do_eval:  # skipped-eval epochs advance neither patience nor best
            patience += 1
        if save_dir:
            # Latest slot = the RAW resume state, every ckpt_every epochs and
            # at the end; best slot = the weights the val pass measured.
            if ((epoch + 1) % ckpt_every == 0 or epoch + 1 == cfg.training.epochs
                    or patience >= cfg.training.early_stop_patience):
                ckpt.save_checkpoint(save_dir, state, epoch + 1, val_loss,
                                     extra={"cmd_steer_errors": cmd_err}, is_best=False,
                                     latest=True)
            if improved:
                ckpt.save_checkpoint(save_dir, cand_state, epoch + 1, cand_val,
                                     extra={"cmd_steer_errors": cmd_err}, is_best=True,
                                     latest=False)
            # Rewritten every epoch: a run killed mid-way keeps its curve.
            _write_history(os.path.join(save_dir, "training_history.csv"), history)
        if patience >= cfg.training.early_stop_patience:
            if verbose:
                print(f"  early stop at epoch {epoch + 1}")
            break
        if (res_mode and refresh_fn is not None and refresh_every > 0
                and (epoch + 1) % refresh_every == 0 and epoch + 1 < cfg.training.epochs):
            train_table = None  # free the table before collecting anew
            t_r = time.time()
            new_table, new_ds = refresh_fn(refresh_round)
            refresh_round += 1
            if int(new_table.get("page_rows", 0)) != page_rows:
                raise ValueError(
                    f"refresh table page_rows {new_table.get('page_rows')} "
                    f"!= initial {page_rows}: refresh collections must use "
                    "the same frame count / page layout as the initial one")
            train_table = _table(new_table, page_rows, image_shape)
            del new_table
            train_idx = np.arange(len(new_ds))
            # As the JAX package: the sampler reseeds from cfg.training.seed,
            # not stream_seed (a known fault, kept for parity).
            sampler = WeightedBatchSampler(
                new_ds.command, B, cfg.training.seed + 131 * refresh_round,
                controls=new_ds.controls,
                hard_boost=cfg.training.hard_frame_boost)
            if verbose:
                print(f"  train table refreshed: {len(new_ds)} fresh frames "
                      f"({time.time() - t_r:.0f}s)", flush=True)

    if save_dir:
        _write_history(os.path.join(save_dir, "training_history.csv"), history)
        try:
            from cilrs_tpu_torch.train.plots import plot_training_curves

            plot_training_curves(history, os.path.join(save_dir, "training_curves.png"))
        except Exception as e:  # matplotlib optional
            if verbose:
                print(f"  (training curves skipped: {e})")
    final_eval = dataclasses.replace(state, model=ema.model) if ema is not None else state
    return {"history": history, "best_val_loss": best_val, "state": state,
            "eval_state": final_eval,
            # The val table outlives any refresh: callers run the offline
            # report against it; val_rows maps the val split into it.
            "val_table": val_table if res_mode else None,
            "val_rows": val_rows if res_mode else None,
            "group_losses": group_losses}


def _write_history(path: str, history: list[dict]):
    if not history:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(history[0].keys()))
        w.writeheader()
        w.writerows(history)
