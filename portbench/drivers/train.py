"""Training from the card-resident table: ``train/loop.py:train`` as
``cli.train`` calls it, on a table of random u8 frames and synthetic labels
made on the device from the seed (the reference collection's row count, in
the program's page layout), with the run's weights loaded into the program's
model as ``create_train_state`` returns it. It trains the CILRS: its
``ModelConfig`` and its FLOPs come from ``policies/cilrs.py``.

Set-up runs the first train group (``train_group``: one gather launch of
K x B rows and K steps) and its EMA update. The window opens at the second
group and closes at the first group boundary at or after ``--seconds``, where
a wrapper of the module-level ``train_group`` stops the loop; epoch ends
(the loss read-back and validation) inside the window count.
``train_frames_per_s`` is the window's steps x batch over its wall. Traced
run: the same window, then the next group under the profiler. Check: the
reference follows the first three steps, from the batches the program's step
received (``reference/train.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from portbench import counts, harness, trace
from portbench.harness import sync
from portbench.reference import train as ref_train
from portbench.reference.frozen.render.camera import CameraSpec
from portbench.weights import load_into, seeded_state_dict


class StopWindow(Exception):
    """Raised from the wrapped ``train_group`` to end the program's loop."""


def make_table(ctx):
    """The table on the device and the host labels: random frames from a
    generator on the card, a page at a call; labels as the program's
    synthetic dataset draws them, from the seed."""
    from cilrs_tpu_torch.data.resident import labels_dataset
    from cilrs_tpu_torch.ops.gather import paged_layout

    dev, ds_cfg = ctx.device, ctx.config["dataset"]
    n = ctx.traffic.get("frames", ds_cfg["frames"])
    shape = tuple(ds_cfg["frame_shape"])
    row = int(np.prod(shape))
    num_pages, page_rows, _ = paged_layout(n, row, 0)
    g = torch.Generator(device=dev).manual_seed(ctx.seed_for(6))
    pages = tuple(torch.randint(0, 256, (min(page_rows, n - p * page_rows), row), generator=g,
                                device=dev, dtype=torch.uint8) for p in range(num_pages))
    rng = np.random.RandomState(ctx.seed_for(7))
    labels = {"speed": rng.uniform(0, 0.5, n).astype(np.float32),
              "command": rng.randint(0, 4, n).astype(np.int32),
              "controls": np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(0, 0.8, n),
                                    (rng.uniform(0, 1, n) < 0.1) * rng.uniform(0, 1, n)],
                                   axis=1).astype(np.float32)}
    table = {"images": pages, "page_rows": page_rows, "image_shape": shape,
             **{k: torch.from_numpy(v).to(dev) for k, v in labels.items()}}
    return table, labels_dataset(labels)


def cilrs(ctx):
    """``policies/cilrs.py``, the architecture this driver trains; a
    configuration of another refuses."""
    if ctx.config["model"].get("arch") != "cilrs":
        raise ValueError(f"drivers/train.py trains the CILRS, not model.arch "
                         f"{ctx.config['model'].get('arch')!r}")
    return harness.architecture(ctx.config["model"])


def train_config(ctx):
    from cilrs_tpu_torch.config import (LossConfig, OptimizerConfig, TrainConfig,
                                        TrainingConfig)

    c, m, t = ctx.config, ctx.config["model"], ctx.config["training"]
    return TrainConfig(
        model=cilrs(ctx).program_config(m, m["dropout"]),
        loss=LossConfig(**c["loss"]), optimizer=OptimizerConfig(**c["optimizer"]),
        training=TrainingConfig(batch_size=t["batch_size"], epochs=t["epochs"],
                                val_fraction=t["val_fraction"],
                                early_stop_patience=t["early_stop_patience"],
                                seed=ctx.seed_for(5), ema_eval=t["ema_eval"],
                                hard_frame_boost=t["hard_frame_boost"]))


@dataclasses.dataclass
class Probe:
    """The taps on one run of the program's loop and what they took."""

    sd: dict
    steps: list = dataclasses.field(default_factory=list)  # (batch, loss) of steps 1-3
    grad1: dict | None = None
    params3: dict | None = None
    idxs: object = None
    model: object = None
    ema: object = None
    averaged: list | None = None
    averaged_names: list | None = None
    ema_now: list | None = None
    group_steps: int = 0
    groups: int = 0  # groups in the window
    window_steps: int = 0
    issue_s: float = 0.0
    wall_s: float = 0.0
    profile: dict | None = None


def run_loop(ctx, probe: Probe, table, ds, stop_after_setup=False, fp32=False):
    """``train()`` with its state's weights replaced by the run's, the first
    steps tapped, and ``train_group`` wrapped to open and close the window."""
    from cilrs_tpu_torch.train import loop

    cfg = train_config(ctx)
    orig_state, orig_step, orig_group, orig_ema = (loop.create_train_state, loop.make_train_step,
                                                    loop.train_group, loop.EMA)

    def create_state(*a, **k):
        state = orig_state(*a, **k)
        load_into(state.model, probe.sd)
        if fp32:  # a witness for the check, never a run
            state.model.dtype = torch.float32
        probe.model = state.model
        return state

    def make_step(*a, **k):
        step = orig_step(*a, **k)
        calls = [0]

        def tapped(state, batch, seed):
            calls[0] += 1
            n = calls[0]
            if n == ref_train.STEPS + 1:
                probe.params3 = {k: p.detach().clone() for k, p in state.model.named_parameters()}
            out = step(state, batch, seed)
            if n <= ref_train.STEPS:
                probe.steps.append(({k: v.clone() for k, v in batch.items()}, out["loss"].clone()))
            if n == 1:
                opt = state.optimizer
                # A step that never updated leaves no moment: its gradient reads 0.
                probe.grad1 = {k: opt.state[p].get("exp_avg", torch.zeros_like(p)) / 0.1
                               for k, p in state.model.named_parameters()}
            return out

        return tapped

    class TappedEMA(orig_ema):
        def __init__(self, model):
            super().__init__(model)
            probe.ema = self

    calls = [0]

    def group(state, tbl, idxs, seed, train_step):
        calls[0] += 1
        if calls[0] == 1:  # set-up: the first group
            probe.idxs = np.asarray(idxs)[:ref_train.STEPS]
            probe.group_steps = len(idxs)
            return orig_group(state, tbl, idxs, seed, train_step)
        if calls[0] == 2:  # its EMA update has run: snapshot, open the window
            sync(ctx.device)
            avg = loop._averaged(probe.model)
            names = ([n for n, _ in probe.model.named_parameters()]
                     + [n for n, b in probe.model.named_buffers()
                        if not n.endswith("num_batches_tracked")])
            probe.averaged = [t.detach().clone() for t in avg]
            probe.averaged_names = names
            probe.ema_now = [t.detach().clone() for t in loop._averaged(probe.ema.model)]
            if stop_after_setup:
                raise StopWindow
            ctx.open_window()
        elif time.perf_counter() - ctx.t_open >= ctx.seconds:
            sync(ctx.device)
            probe.wall_s = time.perf_counter() - ctx.t_open
            if ctx.trace:
                probe.profile = trace.profile(
                    lambda: orig_group(state, tbl, idxs, seed, train_step), len(idxs),
                    train_ranges(probe.model))
            raise StopWindow
        t0 = time.perf_counter()
        out = orig_group(state, tbl, idxs, seed, train_step)
        probe.issue_s += time.perf_counter() - t0
        probe.groups += 1
        probe.window_steps += len(idxs)
        return out

    with contextlib.ExitStack() as stack:
        for attr, new in (("create_train_state", create_state), ("make_train_step", make_step),
                          ("train_group", group), ("EMA", TappedEMA)):
            stack.enter_context(trace.patched(loop, attr, lambda _, new=new: new))
        try:
            loop.train(ds, cfg, device=ctx.device, resident=table, verbose=False)
            raise RuntimeError("the loop ended before the window closed")
        except StopWindow:
            pass


def train_ranges(model) -> list:
    """A train group's layers in profiler ranges: the group's gather, the
    augmentation, the model's forward, the loss, and the update (clip, Adam,
    schedule)."""
    from cilrs_tpu_torch.train import loop, steps
    from cilrs_tpu_torch.train.state import TrainState

    return [(loop, "gather_group", "gather_group"), (steps, "augment_batch", "augment"),
            (model, "forward", "forward"), (steps, "cilrs_loss", "loss"),
            (TrainState, "apply_gradients", "update")]


def program_readings(probe: Probe) -> dict:
    return {"batches": [b for b, _ in probe.steps], "losses": [float(l) for _, l in probe.steps],
            "grad1": probe.grad1, "params3": probe.params3, "ema": probe.ema_now,
            "averaged": probe.averaged, "averaged_names": probe.averaged_names,
            "group_steps": probe.group_steps}


def readings(ctx, probe: Probe, table, quant=False) -> dict:
    prog = program_readings(probe)
    batches = ref_train.table_rows(table["images"], table["page_rows"],
                                   {k: table[k] for k in ("speed", "command", "controls")},
                                   probe.idxs, table["image_shape"])
    out = ref_train.gaps(ctx.config, probe.sd, prog, batches, ctx.seed_for(5) + 1, ctx.device,
                         quant)
    out["batch_mismatch"] = ref_train.batch_mismatch(prog["batches"], batches)
    return out


def _release(probe: Probe):
    probe.model = probe.ema = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    dev, B = ctx.device, ctx.config["training"]["batch_size"]
    table, ds = make_table(ctx)
    probe = Probe(seeded_state_dict(ctx.config["model"], ctx.seed_for(2), dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run_loop(ctx, probe, table, ds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = probe.window_steps
    rate = steps * B / probe.wall_s
    rec = {"issue_ms_per_unit": probe.issue_s * 1e3 / steps,
           "wall_ms_per_unit": probe.wall_s * 1e3 / steps,
           "mfu_pct": rate * train_flops(ctx) / counts.PEAK_BF16_FLOPS * 100}
    if probe.profile is not None:
        rec.update(probe.profile)
        k = trace.kernel_ms(probe.profile, "gather_rows")
        if k is not None:
            rec["gather_kernel_ms"] = k[0] / k[1]
            rec["gather_least_ms"] = counts.least_ms(counts.gather_bytes(probe.group_steps * B))
    _release(probe)
    got = readings(ctx, probe, table)
    lim = ctx.workload["limits"]
    finite = all(np.isfinite(l) for l in program_readings(probe)["losses"])
    return {"e2e": {"train_frames_per_s": rate}, "rec": rec, "attempted": probe.groups,
            "failed": 0 if finite else probe.groups, "memory_peak_bytes": peak,
            "checked": {k: (got[k], lim[k]) for k in lim}}


def train_flops(ctx) -> int:
    """The CILRS's FLOPs of one trained frame of the table's frame shape."""
    h, w, _ = ctx.config["dataset"]["frame_shape"]
    return cilrs(ctx).train_flops(ctx.config["model"], CameraSpec(height=h, width=w))


def calibrate(ctx, control=True, fp32=False) -> dict:
    """The check's readings of the program (its autocast off with ``fp32``)
    and of the control on one seed: set-up's first group only, no window."""
    table, ds = make_table(ctx)
    probe = Probe(seeded_state_dict(ctx.config["model"], ctx.seed_for(2), ctx.device))
    run_loop(ctx, probe, table, ds, stop_after_setup=True, fp32=fp32)
    _release(probe)
    out = {"program": readings(ctx, probe, table)}
    if control:
        out["control"] = readings(ctx, probe, table, quant=True)
    return out
