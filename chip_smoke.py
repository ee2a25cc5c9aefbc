#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cilrs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, and drives the offline-evaluation path
end to end at the full width of the repo's model (CILRS, ResNet-34 trunk,
88x200x3 u8 frames, speed skip on, random weights from a seed):

  1. build + kernel check: the row-gather kernel (a persistent grid of TMA
     bulk copies through a shared-memory ring) against its plain version,
     bit-exact, on u8 and f32 tables, one and two pages, repeated and
     out-of-range indices, and a single page past 2^31 bytes; ptxas's
     registers and shared memory;
  2. the normal entry point: a synthetic session on disk and a .pth policy go
     through ``python -m cilrs_tpu_torch.cli.report``'s main();
  3. train_cli: the same session trained for 2 epochs through ``python -m
     cilrs_tpu_torch.cli.train``'s main() (history, latest and best slots,
     best_epoch.txt, gather launches), resumed for a third epoch, and the best
     slot scored by the report CLI: collect -> train -> report on the card;
  4. full size: a 176,256-frame u8 table on the card (9.31 GB, 2 pages), the
     seed-42 val split evaluated with collect_predictions_resident at batch
     120 and 25 batches a gather; kernel / plain / index_select timings at the
     path's 3,000-row gather beside a contiguous copy_ of the same bytes (the
     practical ceiling of a copy on the card) and the HBM bound, the kernel's
     GB/s, and the host microseconds a call of the wrapper and of
     index_select takes to issue; frames per second; the card's bf16 forward
     on 8 frames against the same weights in float32 on the CPU;
  5. train_step_check: the train step's loss parts and gradients on the card
     against float32 on the CPU, same weights and 120 frames of the table
     (bf16 with eval-mode and train-mode BatchNorm, float32 in train mode);
     the augmentation on the card against the CPU on the same draws;
  6. train_full_size: ``train.loop.train`` from that table for 2 epochs of
     100 steps (augmentation, dropout 0.5, EMA, epoch eval over the whole val
     split), every train and eval group gathered by the kernel (launches
     counted); train frames/s and ms a step through the loop's group function
     after a warm-up group, peak memory, one train group under the profiler,
     and the kernel at an eval group's 6,000 rows against its bound;
  7. collect_check: the closed-loop simulator in collect mode (Town01, 4
     envs, clear and night, 12 vehicles, 6 walkers, 88x200 camera) for 50
     ticks on the card and on the CPU from the same fleet and the same
     pedestrian draws: per-tick ego pose, speed, control, command, status,
     teleport cause and the u8 frames, held to the tolerances of the CPU
     tests (tests/test_torch_agent.py);
  8. collect_full_size: the full-width fleet (Town01, 16 envs, 12 vehicles,
     6 walkers, 4 chained routes an env, 88x200 camera) through the chunk
     function of ``data.collect.collect_session``: one warm-up chunk of 100
     ticks, 3 timed chunks (env-steps/s, kept frames/s, ms a tick, host ms
     to issue a tick, the chunk's copy to the host), one chunk under the
     profiler (busy share, device activities a tick, top items), one under
     CUDA's sync check, peak memory, and a 5-weather strip (20 ticks each,
     mean frame luminance; night darker than clear by more than 0.05);
  9. collect_cli: ``python -m cilrs_tpu_torch.cli.collect --frames 3000
     --envs 16`` into a temp dir, ``cli.train`` for 1 epoch on that session
     and ``cli.report`` on its best checkpoint: collect -> train -> report
     with no JAX in the chain.

Prints one JSON line per phase, then the kernels line, the card's name and
power limit, and last {"ok": true, "device": {...}}. A failed phase ends the
run with a non-zero exit and no ok line; so does a machine without CUDA.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

from cilrs_tpu_torch.agent import driver as driver_mod
from cilrs_tpu_torch.agent.driver import fleet_rollout
from cilrs_tpu_torch.agent.npc import draw_pedestrians
from cilrs_tpu_torch.bench.timing import card_line, copy_bound_ms, host_us_per_call, median_ms
from cilrs_tpu_torch.cli import collect as collect_cli
from cilrs_tpu_torch.cli import report as report_cli
from cilrs_tpu_torch.cli import train as train_cli
from cilrs_tpu_torch.config import WEATHER_NAMES, load_train_config
from cilrs_tpu_torch.data.collect import HOST_KEYS, MIN_SPEED_KMH, make_collect_fleet
from cilrs_tpu_torch.data.dataset import (WeightedBatchSampler, load_sessions,
                                          make_synthetic_dataset, save_session, stratified_split)
from cilrs_tpu_torch.data.resident import gather_group, labels_dataset
from cilrs_tpu_torch.evaluation.report import GROUP_BATCHES, collect_predictions_resident
from cilrs_tpu_torch.maps.town import make_town01
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.models.losses import cilrs_loss
from cilrs_tpu_torch.ops.build import build
from cilrs_tpu_torch.ops.gather import (bulk_plan, gather_rows_paged, gather_rows_plain,
                                        paged_layout)
from cilrs_tpu_torch.ops.image import apply_augment, draw_augment, normalize
from cilrs_tpu_torch.render import raster as raster_mod
from cilrs_tpu_torch.train import checkpoint as ckpt_mod
from cilrs_tpu_torch.train.checkpoint import load_policy, save_checkpoint_pth
from cilrs_tpu_torch.train.loop import EVAL_GROUP_BATCHES, STEPS_PER_CALL, train, train_group
from cilrs_tpu_torch.train.state import create_train_state
from cilrs_tpu_torch.train.steps import make_train_step

FULL_FRAMES = 176_256
FRAME_SHAPE = (88, 200, 3)
ROW_BYTES = int(np.prod(FRAME_SHAPE))  # 52,800: already 16-byte aligned
BATCH = 120
SESSION_FRAMES = 3_000
EVAL_PASSES = 3
# bf16 card forward vs float32 CPU forward of the same weights: bf16 keeps 8
# significant bits, and ~36 layers of rounding leave errors of a few 1e-3 of
# each output's scale; 5% of the scale (and a correlation above 0.99 across
# frames and features) still fails a wrong layout or a wrong weight outright.
FWD_REL_TOL = 0.05
FWD_MIN_CORR = 0.99
# The train step on the card against float32 on the CPU, same weights and
# batch, as three comparisons of the loss parts (relative error) and the
# flattened gradient (cosine). The phase also measures the CPU against itself
# ("cpu_against_itself"), the floor each tolerance rests on:
#  - eval-mode BatchNorm, card bf16: the trunk's backward is then a linear
#    map of the output gradient, and bf16's 8 significant bits leave the
#    gradient about 1% off (bf16 autocast on the CPU: cosine 0.99991); a
#    cosine above 0.99 still fails a wrong layout, weight or loss term;
#  - train-mode BatchNorm, card float32 (TF32 off): at a random init the
#    backward through 36 train-mode BatchNorms amplifies rounding (the
#    gradient explosion of BatchNorm networks at init): float32 on the CPU
#    with another reduction order agrees at cosine 0.99990, loss parts within
#    3e-4. Held to 0.99 and 1e-3;
#  - train-mode BatchNorm, card bf16, the step as it trains: the same
#    amplification of bf16's rounding leaves bf16 autocast on the CPU at
#    cosine 0.91; held to 0.7, a sanity bound that a layout or sign fault
#    (cosine near 0) still fails. The loss parts, means over 120 frames of
#    outputs within FWD_REL_TOL of their scale, are held to 5%.
# (Floors as this phase read them on an H100 machine's CPU, full width, 120
# frames; PERF.md has the run.)
STEP_REL_TOL = 0.05
F32_REL_TOL = 1e-3
GRAD_MIN_COS = {"eval_bn_bf16": 0.99, "train_bn_f32": 0.99, "train_bn_bf16": 0.7}
# The augmentation on the card against the CPU on the same draws, as
# tests/test_torch_augment.py holds the CPU to the JAX package: at most 1e-4
# of the values may differ by more than 1e-5 (hue-sector boundaries).
AUG_ATOL = 1e-5
AUG_MAX_SHARE = 1e-4
SESSION_NAME = "session_000"
TRAIN_EPOCHS = 2
TRAIN_STEPS = 100  # steps an epoch of train_full_size
TIMED_GROUPS = 4
EVAL_GROUP_ROWS = BATCH * EVAL_GROUP_BATCHES  # 6,000
# The closed loop in collect mode. Full width: the collect CLI's defaults
# (Town01, 16 envs, 12 vehicles, 6 walkers, chunks of 100 ticks).
SIM_ENVS, SIM_VEHICLES, SIM_WALKERS, SIM_CHUNK = 16, 12, 6, 100
SIM_TIMED_CHUNKS = 3
STRIP_TICKS = 20
NIGHT_DARKER_BY = 0.05  # tests/test_render.py:71-76 holds the JAX renderer to it
# collect_check: the card against the CPU on one fleet, 50 ticks, with the
# tolerances the CPU tests hold the port to the JAX package with
# (tests/test_torch_agent.py): integers exact; poses 1e-4 m and 1e-5 rad,
# speed 1e-4 km/h, controls 1e-5; u8 frames: at most 0.5% of the values off
# by more than 1, mean difference under 0.05.
CHECK_ENVS, CHECK_TICKS, CHECK_WEATHERS = 4, 50, (0, 3, 0, 3)  # clear, night
CHECK_TOL = {"pos": 1e-4, "yaw": 1e-5, "speed_kmh": 1e-4, "control": 1e-5,
             "steer_hint": 1e-5, "obstacle_dist": 1e-4}
CHECK_EXACT = ("command", "status", "tp_cause", "tl_state", "route_idx", "completed")
FRAME_MAX_SHARE, FRAME_MAX_MEAN = 0.005, 0.05
COLLECT_CLI_FRAMES = 3000
# The tick's layers, as their callers call them (env_observe holds the
# render, the render its [pixels x 72] ground pass and its box solve,
# env_act the NPC controller and the physics).
SIM_LAYERS = (("driver", "env_observe"), ("driver", "render_frame"), ("raster", "_ground_masks"),
              ("raster", "_ray_obb"), ("driver", "env_act"), ("driver", "npc_controller"),
              ("driver", "world_physics_step"))


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_vs_plain(pages, idx, page_rows) -> float:
    got = gather_rows_paged(pages, idx, page_rows)
    torch.cuda.synchronize()
    want = gather_rows_plain(tuple(p.reshape(p.shape[0], -1) for p in pages), idx, page_rows)
    err = max_abs_err(got, want)
    if err != 0.0 or not torch.equal(got, want):
        raise AssertionError(f"gather kernel differs from its plain version (max abs err {err})")
    return err


def phase_build_and_check(dev) -> dict:
    t0 = time.time()
    ptxas = build(["gather_rows"])
    build_s = time.time() - t0
    g = torch.Generator(device=dev).manual_seed(1)

    def table(rows, width, dtype):
        t = torch.randint(0, 256, (rows, width), generator=g, device=dev, dtype=torch.uint8)
        return t if dtype == torch.uint8 else t.to(dtype) * 0.37 - 11.0

    def indices(n, lo, hi, extra):
        r = torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)
        r[: n // 4] = r[0]  # repeated rows
        return torch.cat([r, torch.tensor(extra, dtype=torch.int32, device=dev)])

    cases = {}
    for dtype, width in ((torch.uint8, ROW_BYTES), (torch.float32, 1024)):
        name = str(dtype).split(".")[-1]
        one = (table(1000, width, dtype),)
        cases[f"{name}_1page"] = kernel_vs_plain(
            one, indices(517, 0, 1000, [-1, -2 ** 31, 1000, 2 ** 31 - 1, 999, 0]), 1000)
        two = (table(607, width, dtype), table(450, width, dtype))  # 600 logical + 7 slack
        cases[f"{name}_2pages"] = kernel_vs_plain(
            two, indices(517, 0, 1050, [-1, -600, -601, 599, 600, 1049, 1050, 1200, 10 ** 6]), 600)
    # One page past 2^31 bytes: 64-bit offsets, indices at its far end.
    big_rows = 2 ** 31 // ROW_BYTES + 5_000
    big = (table(big_rows, ROW_BYTES, torch.uint8),)
    tail = indices(300, big_rows - 200, big_rows, [big_rows - 1, big_rows, big_rows + 10, 0])
    cases["uint8_1page_past_2^31_bytes"] = kernel_vs_plain(big, tail, big_rows)
    last = gather_rows_paged(big, tail[-4:-3], big_rows)
    if not torch.equal(last[0], big[0][big_rows - 1]):
        raise AssertionError("last row of the >2^31-byte page read wrong")
    big_bytes = big[0].numel()
    del big
    torch.cuda.empty_cache()
    return {"phase": "build_and_kernel_check", "ok": True, "build_s": round(build_s, 3),
            "cases": cases, "big_page_bytes": big_bytes,
            "ptxas": [ln.strip() for ln in ptxas.get("gather_rows", "").splitlines()
                      if "registers" in ln or "spill" in ln or "smem" in ln],
            # The ring is dynamic shared memory, which ptxas does not see: the
            # launch plan at the path's 3,000 rows, smem_bytes a block.
            "launch_plan": dict(zip(
                ("chunk_bytes", "chunks_per_row", "stages", "grid", "smem_bytes"),
                bulk_plan(ROW_BYTES, BATCH * GROUP_BATCHES,
                          torch.cuda.get_device_properties(dev).multi_processor_count)))}


def phase_cli(dev, workdir: str) -> tuple[dict, str]:
    cfg = load_train_config()
    ds = make_synthetic_dataset(SESSION_FRAMES, seed=0)
    session = os.path.join(workdir, SESSION_NAME)
    save_session(session, ds)
    torch.manual_seed(0)
    model = CILRS(num_commands=cfg.model.num_commands, dropout=cfg.model.dropout,
                  stage_sizes=tuple(cfg.model.stage_sizes), speed_skip=True)
    with torch.no_grad():
        model.speed_skip_w.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(0))
    ckpt = os.path.join(workdir, "policy.pth")
    save_checkpoint_pth(ckpt, model, epoch=0, val_loss=float("nan"))
    out = os.path.join(workdir, "evaluation_report.json")

    gather_rows_paged.launches = 0
    t0 = time.time()
    report = report_cli.main(["--data", session, "--checkpoint", ckpt, "--out", out])
    wall = time.time() - t0
    launches = gather_rows_paged.launches

    with open(out) as f:
        if json.load(f) != report:
            raise AssertionError("report file differs from the returned report")
    expected = {"num_samples", "steer", "throttle", "brake", "speed", "per_command",
                "steer_percentiles", "steer_accuracy"}
    if set(report) != expected:
        raise AssertionError(f"report keys {sorted(report)}")
    leaves = [v for k in expected - {"num_samples"} for v in _leaves(report[k])]
    if not all(math.isfinite(v) for v in leaves):
        raise AssertionError("non-finite report values")
    n_val = len(stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)[1])
    if report["num_samples"] != n_val:
        raise AssertionError(f"{report['num_samples']} samples, val split has {n_val}")
    if launches < 1:
        raise AssertionError("the CLI's path launched no gather kernel")
    return {"phase": "cli_report", "ok": True, "frames": SESSION_FRAMES,
            "num_samples": report["num_samples"], "gather_launches": launches,
            "wall_s": round(wall, 3), "steer_mae": report["steer"]["mae"]}, ckpt


def _leaves(d):
    if isinstance(d, dict):
        for v in d.values():
            yield from _leaves(v)
    else:
        yield float(d)


def phase_full_size(dev, ckpt: str) -> tuple:
    cfg = load_train_config()
    num_pages, page_rows, _ = paged_layout(FULL_FRAMES, ROW_BYTES, 0)
    g = torch.Generator(device=dev).manual_seed(42)
    pages = tuple(
        torch.randint(0, 256, (min(page_rows, FULL_FRAMES - p * page_rows), ROW_BYTES),
                      generator=g, device=dev, dtype=torch.uint8)
        for p in range(num_pages))
    lab = make_synthetic_dataset(FULL_FRAMES, seed=42, h=1, w=1)  # labels only
    table = {"images": pages, "page_rows": page_rows, "image_shape": FRAME_SHAPE,
             "speed": torch.from_numpy(lab.speed_norm).to(dev),
             "command": torch.from_numpy(lab.command).to(dev),
             "controls": torch.from_numpy(lab.controls).to(dev)}
    labels = {"speed": lab.speed_norm, "command": lab.command, "controls": lab.controls}
    _, val_idx = stratified_split(lab, cfg.training.val_fraction, cfg.training.seed)
    model = load_policy(ckpt, cfg, dev)

    # Warm-up on one group (cuDNN picks its algorithms), then the timed passes:
    # the pass lasts about a second, so its wall time is the median of three.
    collect_predictions_resident(model, table, labels, val_idx[:BATCH * GROUP_BATCHES], BATCH, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    want_launches = -(-len(val_idx) // (BATCH * GROUP_BATCHES))
    walls = []
    for _ in range(EVAL_PASSES):
        gather_rows_paged.launches = 0
        t0 = time.time()
        pred, _, _ = collect_predictions_resident(model, table, labels, val_idx, BATCH, cfg)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches = gather_rows_paged.launches
        if launches != want_launches:
            raise AssertionError(f"{launches} gather launches, expected {want_launches}")
        if pred.shape != (len(val_idx), 4) or not np.all(np.isfinite(pred)):
            raise AssertionError(f"predictions {pred.shape}, finite={np.all(np.isfinite(pred))}")
    wall = float(np.median(walls))
    profile = profile_device(lambda: collect_predictions_resident(
        model, table, labels, val_idx[:BATCH * GROUP_BATCHES], BATCH, cfg), BATCH * GROUP_BATCHES)

    # The path's gather: 3,000 val rows across both 4.65 GB pages.
    b = BATCH * GROUP_BATCHES
    idx = torch.from_numpy(val_idx[:b].astype(np.int32)).to(dev)
    err = kernel_vs_plain(pages, idx, page_rows)
    err = max(err, kernel_vs_plain(pages, torch.cat([idx[:100], torch.tensor(
        [-1, FULL_FRAMES, page_rows - 1, page_rows, 2 * page_rows + 5], dtype=torch.int32,
        device=dev)]), page_rows))
    local = (idx.long() % page_rows)
    contiguous = pages[0][:b]  # the same 158.4 MB, contiguous
    dst = torch.empty_like(contiguous)
    kernel_fn = functools.partial(gather_rows_paged, pages, idx, page_rows)
    library_fn = functools.partial(torch.index_select, pages[0], 0, local)
    kernel_ms = median_ms(kernel_fn)
    plain_ms = median_ms(lambda: gather_rows_plain(pages, idx, page_rows))
    library_ms = median_ms(library_fn)
    copy_ms = median_ms(lambda: dst.copy_(contiguous))
    bound_ms = copy_bound_ms(b * ROW_BYTES)
    host_us = {"kernel_wrapper": host_us_per_call(kernel_fn),
               "index_select": host_us_per_call(library_fn)}
    del dst

    # The card's bf16 forward against the same weights in float32 on the CPU.
    rows = torch.from_numpy(val_idx[:8].astype(np.int64)).to(dev)
    frames = gather_rows_paged(pages, rows.int(), page_rows).reshape((8,) + FRAME_SHAPE)
    x = normalize(frames.float() / 255.0)
    speed, cmd = table["speed"][rows], table["command"][rows]
    cpu_model = CILRS(num_commands=cfg.model.num_commands, dropout=cfg.model.dropout,
                      dtype=torch.float32, stage_sizes=tuple(cfg.model.stage_sizes),
                      speed_skip=model.speed_skip)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_model.eval()
    with torch.inference_mode():
        gpu_out = [t.cpu() for t in model(x, speed, cmd)]
        gpu_feat = model.encode(x).cpu()
        cpu_x, cpu_s, cpu_c = x.cpu(), speed.cpu(), cmd.cpu()
        cpu_out = cpu_model(cpu_x, cpu_s, cpu_c)
        cpu_feat = cpu_model.encode(cpu_x)
    fwd = {}
    for name, a, ref in (("trunk", gpu_feat, cpu_feat), ("controls", gpu_out[0], cpu_out[0]),
                         ("pred_speed", gpu_out[1], cpu_out[1])):
        rel = float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-12))
        corr = float(np.corrcoef(a.flatten().numpy(), ref.flatten().numpy())[0, 1])
        fwd[name] = {"rel_err": rel, "corr": corr}
        if not (rel <= FWD_REL_TOL and corr >= FWD_MIN_CORR):
            raise AssertionError(f"bf16 card forward vs float32 CPU: {name} {fwd[name]}")

    line = {"phase": "full_size", "ok": True, "frames": FULL_FRAMES, "pages": num_pages,
            "page_rows": page_rows, "table_bytes": sum(p.numel() for p in pages),
            "val_rows": len(val_idx), "batch": BATCH, "gather_launches": launches,
            "eval_wall_s": wall, "eval_walls_s": walls, "frames_per_s": len(val_idx) / wall,
            "profile_one_group": profile,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "gather_rows_per_launch": b, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "index_select_ms": library_ms, "copy_ms": copy_ms, "bound_ms": bound_ms,
            "kernel_gbps": 2 * b * ROW_BYTES / (kernel_ms * 1e-3) / 1e9,
            "kernel_ms_over_bound_ms": kernel_ms / bound_ms,
            "host_us_per_call": host_us,
            "bf16_vs_cpu_f32": fwd, "tolerance": {"rel": FWD_REL_TOL, "corr": FWD_MIN_CORR}}
    kernel = {"name": "gather_rows", "route": "cuda",
              "source": "cilrs_tpu_torch/csrc/gather_rows.cu",
              "replaces": "cilrs_tpu/ops/gather.py:80",
              "tpu_origin": "cilrs_tpu/ops/gather.py:_gather_rows_impl",
              "launches": launches, "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": library_ms}
    return line, kernel, table, labels, val_idx


def profile_device(fn, rows: int) -> dict:
    """Device time by kernel over one call of ``fn`` (one group of ``rows``
    frames) under torch.profiler: the busy share of the call's wall time and
    the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # Device activity by name; a record_function range (Adam's step is one)
    # spans kernels already counted, so user annotations are left out.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in events]
    busy_ms = sum(ms for _, ms in kernels)
    if busy_ms == 0:
        return {"device_time": "not measured (the profiler saw no device time)"}
    gather_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                    if "gather_rows_kernel" in e.key)
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return {"rows": rows, "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "gather_kernel_ms": gather_ms,
            "device_activities": sum(e.count for e in events),
            "top_kernels_ms": [[k[:80], ms] for k, ms in top]}


def phase_train_cli(dev, workdir: str) -> dict:
    """collect -> train -> resume -> report through the CLIs, at full width
    on the 3,000-frame session of phase cli_report."""
    cfg = load_train_config()
    session = os.path.join(workdir, SESSION_NAME)
    run = os.path.join(workdir, "run")
    train_idx, val_idx = stratified_split(load_sessions([session]), cfg.training.val_fraction,
                                          cfg.training.seed)
    spe = max(1, len(train_idx) // BATCH)
    per_epoch = -(-spe // STEPS_PER_CALL) + 2 * -(-max(1, len(val_idx) // BATCH) // EVAL_GROUP_BATCHES)

    gather_rows_paged.launches = 0
    t0 = time.time()
    out = train_cli.main(["--data", session, "--ckpt-dir", run, "--epochs", "2"])
    wall = time.time() - t0
    launches = gather_rows_paged.launches
    if launches != 2 * per_epoch:
        raise AssertionError(f"{launches} gather launches in 2 epochs, expected {2 * per_epoch}")
    hist = out["history"]
    if [h["epoch"] for h in hist] != [1, 2] or not all(
            math.isfinite(h[k]) for h in hist for k in ("train_loss", "val_loss", "val_loss_raw")):
        raise AssertionError(f"history {hist}")
    with open(os.path.join(run, "training_history.csv")) as f:
        lines = f.read().splitlines()
    if lines[0].split(",") != list(hist[0]) or len(lines) != 3:
        raise AssertionError(f"training_history.csv: {lines}")
    latest = sorted(os.listdir(os.path.join(run, ckpt_mod.LATEST_DIR)))
    if latest != ["checkpoint_epoch_0002.pth"]:
        raise AssertionError(f"latest slot holds {latest}")
    best = os.path.join(run, ckpt_mod.BEST_NAME)
    with open(os.path.join(run, "best_epoch.txt")) as f:
        best_epoch = int(f.read().split()[0])
    if not os.path.exists(best) or best_epoch not in (1, 2):
        raise AssertionError(f"best slot missing or best epoch {best_epoch}")

    t1 = time.time()
    resumed = train_cli.main(["--data", session, "--ckpt-dir", run, "--epochs", "3", "--resume"])
    resume_wall = time.time() - t1
    if [h["epoch"] for h in resumed["history"]] != [3] or resumed["state"].step != 3 * spe:
        raise AssertionError(f"resume: history {resumed['history']}, step {resumed['state'].step}")

    report_path = os.path.join(workdir, "evaluation_report_trained.json")
    report = report_cli.main(["--data", session, "--checkpoint", best, "--out", report_path])
    if report["num_samples"] != len(val_idx) or not all(
            math.isfinite(v) for k in ("steer", "throttle", "brake", "speed")
            for v in _leaves(report[k])):
        raise AssertionError(f"report on the best slot: {report['num_samples']} samples")
    return {"phase": "train_cli", "ok": True, "frames": SESSION_FRAMES,
            "train_rows": len(train_idx), "val_rows": len(val_idx), "steps_per_epoch": spe,
            "gather_launches_2_epochs": launches, "train_wall_s": wall,
            "resume_wall_s": resume_wall, "history": hist + resumed["history"],
            "best_epoch": best_epoch, "report_steer_mae": report["steer"]["mae"]}


def phase_train_step_check(dev, table: dict, val_idx: np.ndarray) -> dict:
    """The train step's loss parts and gradients on the card against the same
    weights in float32 on the CPU (see GRAD_MIN_COS): full width, dropout 0,
    no augmentation, 120 frames gathered from the table. Then the
    augmentation on the card against the CPU on the same draws."""
    cfg = load_train_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
    card_bf16 = create_train_state(cfg, 0, device=dev).model
    weights = {k: v.detach().cpu().clone() for k, v in card_bf16.state_dict().items()}

    def f32_model():
        return CILRS(num_commands=cfg.model.num_commands, dropout=0.0, dtype=torch.float32,
                     stage_sizes=tuple(cfg.model.stage_sizes), speed_skip=cfg.model.speed_skip)

    card_f32 = f32_model().to(dev, memory_format=torch.channels_last)
    cpu_f32 = f32_model()
    batch = gather_group(table, val_idx[None, :BATCH])
    cpu_batch = {k: v.cpu() for k, v in batch.items()}

    def loss_and_grads(model, b, train: bool):
        model.load_state_dict(weights)  # the same weights and BN statistics every time
        model.zero_grad(set_to_none=True)
        x = normalize(b["images"].float() / 255.0)
        controls, pred_speed = model.train(train)(x, b["speed"], b["command"])
        total, parts = cilrs_loss(controls, pred_speed, b["controls"], b["speed"], cfg.loss)
        total.backward()
        return ({k: v.item() for k, v in parts.items()},
                torch.cat([p.grad.double().flatten().cpu() for p in model.parameters()]))

    def compare(parts, g, ref_parts, ref_g):
        return {"loss_rel_err": max(abs(parts[k] - ref_parts[k]) / max(abs(ref_parts[k]), 1e-12)
                                    for k in parts),
                "grad_cosine": float(g @ ref_g / (g.norm() * ref_g.norm())),
                "grad_rel_l2": float((g - ref_g).norm() / ref_g.norm())}

    checks, cpu_floor, refs = {}, {}, {}
    for train in (False, True):
        refs[train] = loss_and_grads(cpu_f32, cpu_batch, train)
    for name, model, train in (("eval_bn_bf16", card_bf16, False), ("train_bn_f32", card_f32, True),
                               ("train_bn_bf16", card_bf16, True)):
        parts, g = loss_and_grads(model, batch, train)
        checks[name] = {"loss_parts": parts, "loss_parts_cpu_f32": refs[train][0],
                        **compare(parts, g, *refs[train])}
    # The CPU's own agreement with itself, the floor the tolerances rest on:
    # bf16 autocast on the CPU, and float32 with another reduction order
    # (channels_last, half the threads).
    cpu_bf16 = CILRS(num_commands=cfg.model.num_commands, dropout=0.0, dtype=torch.bfloat16,
                     stage_sizes=tuple(cfg.model.stage_sizes), speed_skip=cfg.model.speed_skip)
    cpu_bf16 = cpu_bf16.to(memory_format=torch.channels_last)
    for train in (False, True):
        mode = "train_bn" if train else "eval_bn"
        cpu_floor[f"{mode}_bf16_autocast"] = compare(*loss_and_grads(cpu_bf16, cpu_batch, train),
                                                     *refs[train])
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    try:
        cpu_floor["train_bn_f32_other_order"] = compare(*loss_and_grads(
            cpu_f32.to(memory_format=torch.channels_last), cpu_batch, True), *refs[True])
    finally:
        torch.set_num_threads(threads)

    gen = torch.Generator(device=dev).manual_seed(0)
    x01 = batch["images"].float() / 255.0
    draws = draw_augment(gen, BATCH, *FRAME_SHAPE[:2])
    card_aug = apply_augment(x01, draws)
    cpu_aug = apply_augment(x01.cpu(), {k: v.cpu() for k, v in draws.items()})
    diff = (card_aug.cpu() - cpu_aug).abs()
    aug_bad_share = float((diff > AUG_ATOL).float().mean())
    augment_ms = median_ms(lambda: apply_augment(x01, draws), reps=10, rounds=5)
    line = {"phase": "train_step_check", "ok": True, "frames": BATCH, "checks": checks,
            "cpu_against_itself": cpu_floor,
            "grad_elems": sum(p.numel() for p in cpu_f32.parameters()),
            "augment_max_abs_err": float(diff.max()), "augment_bad_share": aug_bad_share,
            "augment_ms_batch_120": augment_ms,
            "augment_applied": {k: int(v.sum()) for k, v in draws.items() if k.startswith("apply")},
            "tolerance": {"loss_rel": STEP_REL_TOL, "loss_rel_f32": F32_REL_TOL,
                          "grad_cos": GRAD_MIN_COS, "augment_atol": AUG_ATOL,
                          "augment_share": AUG_MAX_SHARE}}
    emit(line)  # the readings first, so a failed check still shows them
    for name, c in checks.items():
        rel_tol = F32_REL_TOL if name == "train_bn_f32" else STEP_REL_TOL
        if not (c["loss_rel_err"] <= rel_tol and c["grad_cosine"] >= GRAD_MIN_COS[name]):
            raise AssertionError(f"card train step vs float32 CPU, {name}: {c['loss_rel_err']}, "
                                 f"cosine {c['grad_cosine']}")
    if aug_bad_share > AUG_MAX_SHARE:
        raise AssertionError(f"card augmentation vs CPU: {aug_bad_share} of values beyond {AUG_ATOL}")
    return line


def phase_train_full_size(dev, table: dict, labels: dict, val_idx: np.ndarray) -> tuple[dict, dict]:
    """train() from the 9.31 GB 2-page table: full-width CILRS, batch 120,
    augmentation, dropout 0.5 and the EMA on, TRAIN_EPOCHS epochs of
    TRAIN_STEPS steps, epoch eval over the whole val split. Then train
    frames/s through the loop's group function, one train group under the
    profiler, and the gather at an eval group's 6,000 rows."""
    cfg = load_train_config()
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, epochs=TRAIN_EPOCHS))
    ds = labels_dataset(labels)
    val_batches = len(val_idx) // BATCH
    want_launches = TRAIN_EPOCHS * (-(-TRAIN_STEPS // STEPS_PER_CALL)
                                    + 2 * -(-val_batches // EVAL_GROUP_BATCHES))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gather_rows_paged.launches = 0
    t0 = time.time()
    out = train(ds, cfg, device=dev, steps_per_epoch=TRAIN_STEPS, resident=table)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = gather_rows_paged.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != want_launches:
        raise AssertionError(f"{launches} gather launches, expected {want_launches}")
    groups = out["group_losses"]
    hist = out["history"]
    if not (all(math.isfinite(v) for v in groups) and all(
            math.isfinite(h[k]) for h in hist for k in ("train_loss", "val_loss", "val_loss_raw"))):
        raise AssertionError(f"non-finite losses: groups {groups}, history {hist}")
    if not groups[-1] < groups[0]:
        raise AssertionError(f"last group's mean train loss {groups[-1]} not under the first's {groups[0]}")

    # Train frames/s through the loop's group function, after a warm-up group.
    state = out["state"]
    train_step = make_train_step(cfg)
    train_idx, _ = stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
    sampler = WeightedBatchSampler(ds.command[train_idx], BATCH, 1, controls=ds.controls[train_idx])
    its = train_idx[np.stack(list(sampler.epoch(STEPS_PER_CALL * (TIMED_GROUPS + 2))))]
    grps = its.reshape(TIMED_GROUPS + 2, STEPS_PER_CALL, BATCH)
    train_group(state, table, grps[0], 1, train_step)
    torch.cuda.synchronize()
    t1 = time.time()
    for g in grps[1:1 + TIMED_GROUPS]:
        train_group(state, table, g, 1, train_step)
    torch.cuda.synchronize()
    timed = time.time() - t1
    frames = TIMED_GROUPS * STEPS_PER_CALL * BATCH
    profile = profile_device(lambda: train_group(state, table, grps[-1], 1, train_step),
                             STEPS_PER_CALL * BATCH)
    # One more group with CUDA's sync checker on: inside a group the loop
    # never waits for the card (the losses stay there until the epoch ends).
    # The host clock over it, which stops before the closing synchronise, is
    # the time the host takes to issue the group's work.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t2 = time.perf_counter()
            train_group(state, table, grps[1], 1, train_step)
            issue_ms = (time.perf_counter() - t2) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({str(w.message)[:160] for w in caught
                    if "called a synchronizing" in str(w.message)})
    if syncs:
        raise AssertionError(f"the train group waits for the card: {syncs}")

    # The gather at an eval group's 6,000 rows across both pages.
    pages, page_rows = table["images"], table["page_rows"]
    idx = torch.from_numpy(val_idx[:EVAL_GROUP_ROWS].astype(np.int32)).to(dev)
    err = kernel_vs_plain(pages, idx, page_rows)
    kernel_ms = median_ms(functools.partial(gather_rows_paged, pages, idx, page_rows))
    plain_ms = median_ms(lambda: gather_rows_plain(pages, idx, page_rows))
    local = idx.long() % page_rows
    library_ms = median_ms(functools.partial(torch.index_select, pages[0], 0, local))
    bound_ms = copy_bound_ms(EVAL_GROUP_ROWS * ROW_BYTES)
    line = {"phase": "train_full_size", "ok": True, "frames": FULL_FRAMES, "pages": len(pages),
            "batch": BATCH, "epochs": TRAIN_EPOCHS, "steps_per_epoch": TRAIN_STEPS,
            "val_rows": len(val_idx), "gather_launches": launches,
            "expected_launches": want_launches, "train_wall_s": wall, "history": hist,
            "group_losses": groups, "peak_mem_bytes": peak,
            "timed_groups": TIMED_GROUPS, "train_frames_per_s": frames / timed,
            "ms_per_step": timed * 1e3 / (TIMED_GROUPS * STEPS_PER_CALL),
            "host_issue_ms_per_step": issue_ms / STEPS_PER_CALL, "host_syncs_in_group": 0,
            "profile_one_train_group": profile,
            "gather_6000": {"rows": EVAL_GROUP_ROWS, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                            "index_select_ms": library_ms, "bound_ms": bound_ms,
                            "kernel_ms_over_bound_ms": kernel_ms / bound_ms,
                            "max_abs_err": err}}
    return line, {"launches": launches, "max_abs_err": err, "ms_6000_rows": kernel_ms,
                  "plain_ms_6000_rows": plain_ms, "library_ms_6000_rows": library_ms,
                  "bound_ms_6000_rows": bound_ms}


def profile_ops(fn, ticks: int) -> dict:
    """One call of fn (``ticks`` simulator ticks) under torch.profiler: busy
    share of the wall under the profiler, device time and device activities
    a tick, and the device time by torch op (the kernels' names are
    templates that say little; the op that launched them says what it is)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        return {"device_time": "not measured (the profiler saw no device time)"}
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in avg
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    # The layers' ranges (SIM_LAYERS): host and device ms a tick in each.
    layers = {e.key[len("sim::"):]: {"host_ms_per_tick": e.cpu_time_total / 1e3 / ticks,
                                     "device_ms_per_tick": e.device_time_total / 1e3 / ticks,
                                     "calls": e.count}
              for e in avg if e.key.startswith("sim::")
              and e.device_type == torch.autograd.DeviceType.CPU}
    activities = sum(e.count for e in kernels)
    return {"ticks": ticks, "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
            "busy_share_under_profiler": busy_ms / wall_ms, "device_ms_per_tick": busy_ms / ticks,
            "device_activities": activities, "device_activities_per_tick": activities / ticks,
            "layers_under_profiler": layers,
            "top_ops_device_ms_calls": [[k, ms, n] for k, ms, n in ops[:12]]}


def profile_sim_layers(fn, ticks: int) -> dict:
    """profile_ops over fn with each simulator layer of SIM_LAYERS in a named
    range: the driver's calls are wrapped for this one run and restored.
    Every layer runs once a tick; one that is not reached through the patched
    name (a renamed function, a ``from x import f``) fails the phase instead of
    dropping out of the table."""
    modules = {"driver": driver_mod, "raster": raster_mod}
    saved = {(m, name): getattr(modules[m], name) for m, name in SIM_LAYERS}

    def annotated(name, f):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"sim::{name}"):
                return f(*args, **kwargs)
        return call

    try:
        for (m, name), f in saved.items():
            setattr(modules[m], name, annotated(name, f))
        profile = profile_ops(fn, ticks)
    finally:
        for (m, name), f in saved.items():
            setattr(modules[m], name, f)
    layers = profile.get("layers_under_profiler")
    if layers is not None:
        calls = {name: layers.get(name, {}).get("calls", 0) for _, name in SIM_LAYERS}
        if any(n != ticks for n in calls.values()):
            raise AssertionError(f"layer ranges over {ticks} ticks: {calls}")
    return profile


_VIEW_OPS = {"view", "_unsafe_view", "unsqueeze", "squeeze", "select", "slice", "expand",
             "permute", "t", "alias", "as_strided", "detach"}


def count_aten_calls(fn) -> dict:
    """The aten calls one call of fn makes (no timing): all of them, the
    views among them (no kernel) and the CPU scalars torch wraps around
    Python numbers (no kernel either)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket).split(".")[-1]
            self.calls[name] = self.calls.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    mode = Count()
    with mode:
        fn()
    return {"all": sum(mode.calls.values()),
            "views": sum(n for k, n in mode.calls.items() if k in _VIEW_OPS),
            "scalar_tensor": mode.calls.get("scalar_tensor", 0)}


def sync_check(fn) -> list:
    """Run fn with CUDA's sync checker on; the messages of the syncs it made."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({str(w.message)[:160] for w in caught
                   if "called a synchronizing" in str(w.message)})


def phase_collect_check(dev) -> dict:
    """The same fleet, 50 ticks on the card and on the CPU on the same
    pedestrian draws, compared tick by tick (see CHECK_TOL)."""
    net = make_town01()
    draws = draw_pedestrians(torch.Generator().manual_seed(3), CHECK_TICKS, CHECK_ENVS,
                             SIM_WALKERS, "cpu")
    outs = {}
    for d in ("cpu", "cuda"):
        f = make_collect_fleet(net, CHECK_ENVS, SIM_VEHICLES, SIM_WALKERS, seed=7,
                               chunk_steps=CHECK_TICKS, device=d)
        state = f.state.replace(world=f.state.world.replace(
            weather_idx=torch.tensor(CHECK_WEATHERS, dtype=torch.int64, device=d)))
        t0 = time.time()
        _, o = fleet_rollout(state, CHECK_TICKS, f.net, f.pool, f.wt, f.params, draws.to(d),
                             cam=f.cam)
        outs[d] = {k: v.cpu().numpy() for k, v in o.items()}
        outs[d]["_wall_s"] = time.time() - t0
    cpu, gpu = outs["cpu"], outs["cuda"]
    errs = {k: float(np.abs(gpu[k].astype(np.float64) - cpu[k]).max()) for k in CHECK_TOL}
    mismatches = {k: int((gpu[k] != cpu[k]).sum()) for k in CHECK_EXACT}
    fd = np.abs(gpu["frame"].astype(int) - cpu["frame"].astype(int))
    frame = {"share_beyond_1": float((fd > 1).mean()), "mean_abs": float(fd.mean()),
             "max_abs": int(fd.max())}
    line = {"phase": "collect_check", "ok": True, "map": "town01", "envs": CHECK_ENVS,
            "ticks": CHECK_TICKS, "weathers": list(CHECK_WEATHERS), "max_abs_err": errs,
            "int_mismatches": mismatches, "frames_u8": frame,
            "ego_path_m": np.linalg.norm(np.diff(cpu["pos"], axis=1), axis=-1).sum(axis=1).tolist(),
            "statuses_seen": sorted(set(cpu["status"].flatten().tolist())),
            "wall_s": {"cpu": cpu["_wall_s"], "cuda": gpu["_wall_s"]},
            "tolerance": {**CHECK_TOL, "frame_share_beyond_1": FRAME_MAX_SHARE,
                          "frame_mean": FRAME_MAX_MEAN}}
    emit(line)  # the readings first, so a failed check still shows them
    bad = [k for k, e in errs.items() if not e <= CHECK_TOL[k]] + \
        [k for k, n in mismatches.items() if n] + \
        (["frame"] if not (frame["share_beyond_1"] <= FRAME_MAX_SHARE
                           and frame["mean_abs"] <= FRAME_MAX_MEAN) else [])
    if bad:
        raise AssertionError(f"card rollout differs from the CPU's in {bad}")
    return line


def phase_collect_full_size(dev) -> dict:
    """The full-width fleet through collect_session's chunk function."""
    t0 = time.time()
    fleet = make_collect_fleet(make_town01(), SIM_ENVS, SIM_VEHICLES, SIM_WALKERS, seed=0,
                               chunk_steps=SIM_CHUNK, device=dev)
    setup_s = time.time() - t0
    E, T = SIM_ENVS, SIM_CHUNK
    gather_rows_paged.launches = 0
    t0 = time.time()
    fleet.chunk()  # warm-up: caches the constants, cuDNN/cuBLAS handles
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    walls, issues, copies, kept = [], [], [], 0
    for _ in range(SIM_TIMED_CHUNKS):
        t0 = time.perf_counter()
        outs = fleet.chunk()
        issues.append(time.perf_counter() - t0)  # host time to issue the chunk's ticks
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        t1 = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in outs.items() if k in HOST_KEYS}
        copies.append(time.perf_counter() - t1)
        kept += int(((host["speed_kmh"] > MIN_SPEED_KMH) & (host["status"] == 0)).sum())
        frames = host["frame"]
        if frames.shape != (E, T, 88, 200, 3) or not np.isfinite(host["control"]).all():
            raise AssertionError(f"chunk outputs: frames {frames.shape}")
    peak = torch.cuda.max_memory_allocated(dev)
    wall = sum(walls)
    t0 = time.time()
    profile = profile_sim_layers(fleet.chunk, T)
    profile["profile_and_analysis_s"] = time.time() - t0
    one_tick = draw_pedestrians(fleet.generator, 1, E, SIM_WALKERS, dev)
    aten_calls = count_aten_calls(lambda: fleet_rollout(
        fleet.state, 1, fleet.net, fleet.pool, fleet.wt, fleet.params, one_tick, cam=fleet.cam))
    syncs = sync_check(fleet.chunk)
    if syncs:
        raise AssertionError(f"a collect chunk waits for the card: {syncs}")
    k1 = gather_rows_paged.launches

    # The 5-weather strip: every env in one weather for STRIP_TICKS ticks.
    strip = {}
    for w, name in enumerate(WEATHER_NAMES):
        st = fleet.state.replace(world=fleet.state.world.replace(
            weather_idx=torch.full((E,), w, dtype=torch.int64, device=dev)))
        draws = draw_pedestrians(fleet.generator, STRIP_TICKS, E, SIM_WALKERS, dev)
        _, o = fleet_rollout(st, STRIP_TICKS, fleet.net, fleet.pool, fleet.wt, fleet.params,
                             draws, cam=fleet.cam)
        strip[name] = float(o["frame"].float().mean() / 255.0)
    line = {"phase": "collect_full_size", "ok": True, "map": "town01", "envs": E,
            "vehicles": SIM_VEHICLES, "walkers": SIM_WALKERS, "chunk_ticks": T,
            "camera": [88, 200], "timed_chunks": SIM_TIMED_CHUNKS, "setup_s": setup_s,
            "warmup_chunk_s": warmup_s, "chunk_walls_s": walls,
            "env_steps_per_s": SIM_TIMED_CHUNKS * E * T / wall,
            "kept_frames_per_s": kept / wall, "kept_share": kept / (SIM_TIMED_CHUNKS * E * T),
            "ms_per_tick": wall * 1e3 / (SIM_TIMED_CHUNKS * T),
            "host_issue_ms_per_tick": sum(issues) * 1e3 / (SIM_TIMED_CHUNKS * T),
            "copy_out_ms_per_chunk": float(np.mean(copies)) * 1e3,
            "peak_mem_bytes": peak, "peak_mem_above_start_bytes": peak - base_mem,
            # Device time a tick over the unprofiled ms a tick (the profiler
            # slows the host, so its own busy share reads low).
            "busy_share_unprofiled": profile.get("device_ms_per_tick", 0) * SIM_TIMED_CHUNKS * T
            / (wall * 1e3),
            "profile_one_chunk": profile, "aten_calls_one_tick": aten_calls,
            "host_syncs_in_chunk": 0,
            "gather_launches": k1, "mean_luminance_by_weather": strip}
    emit(line)
    if k1 != 0:
        raise AssertionError(f"the collect path launched the gather kernel {k1} times")
    if not strip["night"] < strip["clear"] - NIGHT_DARKER_BY:
        raise AssertionError(f"night {strip['night']} not darker than clear {strip['clear']}")
    return line


def phase_collect_cli(dev, workdir: str) -> dict:
    """collect -> train -> report through the port's CLIs, no JAX."""
    session = os.path.join(workdir, "session_collected")
    run = os.path.join(workdir, "run_collected")
    t0 = time.time()
    stats = collect_cli.main(["--out", session, "--frames", str(COLLECT_CLI_FRAMES),
                              "--envs", str(SIM_ENVS)])
    collect_s = time.time() - t0
    ds = load_sessions([session])
    if len(ds) != stats["frames"] or len(ds) < COLLECT_CLI_FRAMES or ds.images.shape[1:] != FRAME_SHAPE:
        raise AssertionError(f"session holds {len(ds)} frames {ds.images.shape}, stats {stats['frames']}")
    t1 = time.time()
    out = train_cli.main(["--data", session, "--ckpt-dir", run, "--epochs", "1"])
    train_s = time.time() - t1
    hist = out["history"]
    if len(hist) != 1 or not all(math.isfinite(hist[0][k]) for k in ("train_loss", "val_loss")):
        raise AssertionError(f"history {hist}")
    cfg = load_train_config()
    _, val_idx = stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
    report = report_cli.main(["--data", session, "--checkpoint",
                              os.path.join(run, ckpt_mod.BEST_NAME),
                              "--out", os.path.join(workdir, "report_collected.json")])
    if report["num_samples"] != len(val_idx) or not all(
            math.isfinite(v) for k in ("steer", "throttle", "brake", "speed")
            for v in _leaves(report[k])):
        raise AssertionError(f"report: {report['num_samples']} samples, val split {len(val_idx)}")
    return {"phase": "collect_cli", "ok": True, "frames": stats["frames"],
            "command_distribution": stats["command_distribution"],
            "collect_wall_s": collect_s, "collect_frames_per_s": stats["frames_per_sec"],
            "train_wall_s": train_s, "history": hist, "val_rows": len(val_idx),
            "report_steer_mae": report["steer"]["mae"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    emit({"phase": "setup", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "python": sys.version.split()[0]})
    phase = "build_and_kernel_check"
    try:
        emit(phase_build_and_check(dev))
        with tempfile.TemporaryDirectory(prefix="cilrs_smoke_") as workdir:
            phase = "cli_report"
            line, ckpt = phase_cli(dev, workdir)
            emit(line)
            phase = "train_cli"
            emit(phase_train_cli(dev, workdir))
            phase = "full_size"
            line, kernel, table, labels, val_idx = phase_full_size(dev, ckpt)
            emit(line)
        phase = "train_step_check"
        phase_train_step_check(dev, table, val_idx)
        phase = "train_full_size"
        line, train_kernel = phase_train_full_size(dev, table, labels, val_idx)
        emit(line)
        del table, labels
        torch.cuda.empty_cache()
        phase = "collect_check"
        phase_collect_check(dev)
        phase = "collect_full_size"
        collect_line = phase_collect_full_size(dev)
        with tempfile.TemporaryDirectory(prefix="cilrs_smoke_collect_") as workdir:
            phase = "collect_cli"
            emit(phase_collect_cli(dev, workdir))
        phase = "report"
        kernel["launches_by_path"] = {"eval_full_size": kernel["launches"],
                                      "train_full_size": train_kernel.pop("launches"),
                                      "collect_full_size": collect_line["gather_launches"]}
        kernel["launches"] = sum(kernel["launches_by_path"].values())
        kernel["max_abs_err"] = max(kernel["max_abs_err"], train_kernel.pop("max_abs_err"))
        kernel.update(train_kernel)
        emit({"kernels": [kernel]})
        print(card_line(), flush=True)
    except Exception as e:  # a failed phase ends the run: report it, no ok line
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
