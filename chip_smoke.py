#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cilrs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, and drives the offline-evaluation path
end to end at the full width of the repo's model (CILRS, ResNet-34 trunk,
88x200x3 u8 frames, speed skip on, random weights from a seed):

  1. build + kernel check: both kernels built at once (one nvcc each); the
     row-gather kernel (a persistent grid of TMA bulk copies through a
     shared-memory ring) against its plain version, bit-exact, on u8 and f32
     tables, one and two pages, repeated and out-of-range indices, and a
     single page past 2^31 bytes; ptxas's registers and shared memory;
     then hash_sinf_check: the sin-hash kernels (glibc's sinf of a hash
     argument) against their plain versions on the CPU, bit for bit: the
     bare sin on 4M random bit patterns and the rain, grain, recovery and
     random hash sets (``bench/hash_sets.py``), and each fused hash (rain
     columns, ground grain, reverse steer; one launch a hash) on its set and
     at a 32-env tick's shape; their times there beside the plain version,
     the unfused composition (the bare sin and the torch epilogue) and the
     bound;
     their launches a tick are counted in 8 and 11 (four a tick: two rain,
     one grain, one steer) and on 14's run;
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
     to issue a tick, the chunk's copy to the host), 50 ticks under the
     profiler (busy share, device activities a tick, top items), a chunk under
     CUDA's sync check, peak memory, and a 5-weather strip (20 ticks each,
     mean frame luminance; night darker than clear by more than 0.05);
  9. collect_cli: ``python -m cilrs_tpu_torch.cli.collect --frames 3000
     --envs 16`` into a temp dir, ``cli.train`` for 1 epoch on that session
     and ``cli.report`` on its best checkpoint: collect -> train -> report
     with no JAX in the chain;
 10. drive_check: the closed loop in drive mode (Town01, 4 envs in clear,
     rain, night and hard rain, the benchmark's 40 vehicles and 5 walkers, a
     deterministic policy that reads the frame) for 60 ticks on the card and
     on the CPU, compared tick by tick as collect_check compares; and the
     full-width CILRS's raw controls on one tick, card bf16 against the same
     weights in float32 on the CPU;
 11. drive_full_size: the benchmark protocol at full width (Town01, spawn
     249 -> destination 219, 40 vehicles, 5 walkers, one env, the full-width
     CILRS in bf16) through ``cli.drive``'s chunk function: a warm-up chunk
     of 40 ticks, 5 timed chunks (ticks/s, real-time factor, ms and host ms a
     tick), one chunk under the profiler with a range per layer (render,
     safety controller, policy forward, NPC controller, physics), one under
     CUDA's sync check, peak memory;
 12. benchmark_cli: ``python -m cilrs_tpu_torch.cli.benchmark --duration
     20`` on the checkpoint directory collect_cli trained, all five weathers
     (markdown, JSON, event files);
 13. pipeline_cli: ``python -m cilrs_tpu_torch.cli.pipeline --resident
     --frames 6000 --envs 16 --epochs 1 --bench-duration 10``: on-card
     collection into the resident table, training and the offline report
     from it (the gather kernel's launches counted) and the benchmark;
 14. fused_full_size: ``python -m cilrs_tpu_torch.cli.fused`` at full width
     (Town01, 32 envs, 12 vehicles, 6 walkers, a 65,536-frame ring, 20 ticks
     and 4 train steps a chunk, batch 120, the full-width CILRS in bf16)
     with ``--steps 200`` instead of 2,000: frames collected and frames/s,
     ms and host ms a collect chunk and a train chunk (4 synchronised calls
     of each), one of each under the profiler and one under CUDA's sync
     check, peak memory, the history; the gather kernel's launches (train
     steps + 1 val snapshot), a sampled batch bit-exact against the plain
     gather, the kernel at the path's 120 and 4,096 rows, the checkpoint
     through load_policy;
 15. residuals_cli: ``python -m cilrs_tpu_torch.evaluation.residuals`` on
     that checkpoint, 32 envs, 20,000 frames (its defaults);
 16. prepare_check: a 512-frame 600x800 .npz session and two PNGs through
     ``data.prepare.process_session`` on the card against the CPU, u8
     within 1 level;
 17. osm_collect: the inline OSM campus through ``build_map("osm:...")``,
     one 20-tick collect chunk of 4 envs on the card, finite poses;
 18. fused_sharded_full_size: the call of 14 under ``torchrun --standalone
     --nproc_per_node 1`` (its rank program is this script with
     ``--fused-rank``): the sharded path in a world of 1 over NCCL, held to
     14's run (frames, the first batch's rows, the first chunk's losses, the
     history), ms a collect and a train chunk on both paths, the NCCL calls a
     chunk, peak memory, the gather kernel's launches, the rank-0 checkpoint
     through load_policy;
 19. parallel_two_ranks_one_card: two ranks on the one card over gloo (NCCL
     refuses two ranks on one GPU): the sharded collect rollout (16 envs,
     20 ticks) and one weighted fused step and one data-parallel loop step
     (dropout 0.5) at full width, batch 120 (60 a rank), world 2 against
     world 1, the ranks' weights bit-identical;
 20. switches_check: the renderer's three switches (a night and a clear
     frame, card against CPU) and drive_check with the drive switches, each
     in a process of its own (``--phase``), then the gather kernel on one
     page past 2^33 bytes (CILRS_TPU_ALLOW_BIG_TABLE's layout).

Prints one JSON line per phase, then the kernels line, the card's name and
power limit, and last {"ok": true, "device": {...}}. A failed phase ends the
run with a non-zero exit and no ok line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from cilrs_tpu_torch.agent import driver as driver_mod
from cilrs_tpu_torch.agent.driver import fleet_rollout, model_policy
from cilrs_tpu_torch.agent.npc import draw_pedestrians
from cilrs_tpu_torch.bench import hash_sets
from cilrs_tpu_torch.bench.timing import (HBM_BYTES_PER_S, card_line, copy_bound_ms,
                                          host_us_per_call, median_ms, queued_ms)
from cilrs_tpu_torch.cli import benchmark as benchmark_cli
from cilrs_tpu_torch.cli import collect as collect_cli
from cilrs_tpu_torch.cli import drive as drive_cli
from cilrs_tpu_torch.cli import fused as fused_cli
from cilrs_tpu_torch.cli import pipeline as pipeline_cli
from cilrs_tpu_torch.cli import report as report_cli
from cilrs_tpu_torch.cli import train as train_cli
from cilrs_tpu_torch.cli.common import build_map
from cilrs_tpu_torch.config import WEATHER_NAMES, load_train_config
from cilrs_tpu_torch.core.state import make_world
from cilrs_tpu_torch.data import prepare as prepare_mod
from cilrs_tpu_torch.data.collect import HOST_KEYS, MIN_SPEED_KMH, make_collect_fleet
from cilrs_tpu_torch.data.dataset import (WeightedBatchSampler, load_sessions,
                                          make_synthetic_dataset, save_session, stratified_split)
from cilrs_tpu_torch.data.resident import gather_group, labels_dataset
from cilrs_tpu_torch.evaluation import residuals as residuals_mod
from cilrs_tpu_torch.evaluation.report import GROUP_BATCHES, collect_predictions_resident
from cilrs_tpu_torch.evaluation.scoring import compute_scores
from cilrs_tpu_torch.maps.network import light_states
from cilrs_tpu_torch.maps.town import make_town01
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.models.losses import cilrs_loss
from cilrs_tpu_torch.ops.build import build
from cilrs_tpu_torch.ops.gather import (bulk_plan, gather_rows_paged, gather_rows_plain,
                                        paged_layout)
from cilrs_tpu_torch.ops.image import apply_augment, draw_augment, normalize
from cilrs_tpu_torch.ops import sinf as sinf_mod
from cilrs_tpu_torch.ops.sinf import (SIN_HASHES, TOP12_120, TOP12_INF, TOP12_PIO4, TOP12_TINY,
                                      hash_argument, hash_sinf, hash_sinf_plain)
from cilrs_tpu_torch.parallel.fleet import make_sharded_rollout
from cilrs_tpu_torch.parallel.mesh import make_mesh, shard_batch
from cilrs_tpu_torch.render import raster as raster_mod
from cilrs_tpu_torch.train import checkpoint as ckpt_mod
from cilrs_tpu_torch.train import fused as fused_mod
from cilrs_tpu_torch.train.checkpoint import load_policy, save_checkpoint_pth
from cilrs_tpu_torch.train.loop import (EVAL_GROUP_BATCHES, STEPS_PER_CALL, running_stats, train,
                                        train_group)
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
SIM_PROFILE_TICKS = 50  # the profiled run: the analysis costs about a second a tick
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
# The drive tick's layers; "run" is the drive run, whose policy is the
# CILRS forward.
DRIVE_LAYERS = (("driver", "env_observe"), ("driver", "render_frame"), ("run", "policy"),
                ("driver", "env_act"), ("driver", "safety_controller"),
                ("driver", "npc_controller"), ("driver", "world_physics_step"))
# The closed loop in drive mode: the benchmark's traffic (cli/benchmark.py),
# chunks of cli/drive.py's 40 ticks.
DRIVE_VEHICLES, DRIVE_WALKERS = 40, 5
DRIVE_CHECK_TICKS, DRIVE_CHECK_WEATHERS = 60, (0, 1, 3, 4)  # clear, rain, night, hardrain
DRIVE_TIMED_CHUNKS = 5
BENCH_SPAWN, BENCH_DESTINATION = 249, 219
BENCH_CLI_DURATION = 20
PIPELINE_FRAMES, PIPELINE_BENCH_DURATION = 6000, 10
# The fused loop at cli.fused's full width; the one cut: 200 train steps of
# the CLI's 2,000 (38 streaming chunks and a 50-step settle tail after 24
# warm-up and 24 val chunks; one eval, at the end).
FUSED_ENVS, FUSED_BUFFER, FUSED_TICKS, FUSED_PER_CHUNK, FUSED_STEPS = 32, 65_536, 20, 4, 200
FUSED_WARMUP_CHUNKS = 24  # fused_collect_train's default
FUSED_TIMED = {"collect": range(3, 7), "train": range(3, 7)}  # synchronised calls, by number
FUSED_SYNC_CALL, FUSED_PROFILE_CALL = 8, 10
RESIDUAL_FRAMES = 20_000  # the residuals CLI's default
PREPARE_FRAMES, PREPARE_SOURCE = 512, (600, 800)
# The campus is small: chained_route_pool (both packages') finds no chain of
# 60-280 m routes for some env of some seeds (0 and 2 among them), so the
# phase uses a seed for which all four envs trace.
OSM_ENVS, OSM_TICKS, OSM_SEED = 4, 20, 1
# The campus of tests/test_osm.py: two streets crossing, a service spur and
# a footway the import drops.
OSM_XML = """<?xml version='1.0' encoding='UTF-8'?>
<osm version='0.6'>
  <node id='1' lat='10.0400' lon='76.3300'/><node id='2' lat='10.0400' lon='76.3340'/>
  <node id='3' lat='10.0400' lon='76.3380'/><node id='4' lat='10.0380' lon='76.3340'/>
  <node id='5' lat='10.0420' lon='76.3340'/><node id='6' lat='10.0420' lon='76.3380'/>
  <node id='7' lat='10.0400' lon='76.3341'/>
  <way id='100'><nd ref='1'/><nd ref='2'/><nd ref='3'/><tag k='highway' v='residential'/></way>
  <way id='101'><nd ref='4'/><nd ref='2'/><nd ref='5'/><tag k='highway' v='tertiary'/></way>
  <way id='102'><nd ref='5'/><nd ref='6'/><tag k='highway' v='service'/></way>
  <way id='103'><nd ref='2'/><nd ref='7'/><tag k='highway' v='footway'/></way>
</osm>
"""
# fused_sharded_full_size: cli.fused's full-width call under torchrun, a
# world of 1 over NCCL, held to fused_full_size's run on the same seed (rank
# 0's sampler stream and pedestrian draws are the single path's): frames and
# the first batch's rows exact, the first train chunk's losses within 1e-3
# relative, the history at step 200 within SHARDED_HISTORY_TOL. A world of 1
# computes the single path's arithmetic (the all-reduces copy), and on an
# H100 the two histories were bit-identical (PERF.md); the tolerance is
# the margin for a cuDNN backward that sums with atomics, whose rounding 200
# Adam steps would carry into the held-out losses.
SHARDED_TIMEOUT_S = 600
SHARDED_LOSS_RTOL = 1e-3
SHARDED_HISTORY_TOL = {"rtol": 1e-2, "atol": 1e-3}
# parallel_two_ranks_one_card: two ranks on cuda:0 over gloo. (a) the
# sharded collect rollout, world 2 against world 1, at collect_check's
# tolerances; (b) one weighted fused step and one data-parallel loop step at
# full width, batch 120 (60 a rank), at tests/test_parallel.py:171-172's
# bounds. The fused step normalizes each shard by its own batch statistics
# (the JAX loop's shard_map), so its world-1 reference is the two 60-frame
# shards computed in one process with their gradients, running statistics
# and losses averaged; the loop's step is one global batch, held to world 1
# on all 120 frames at the config's dropout (0.5): each rank applies its
# rows of the global batch's masks, which are world 1's.
TWO_RANK_ENVS, TWO_RANK_TICKS, TWO_RANK_SEED = 16, 20, 5
FUSED_STEP_SEED = 7
DP_LOSS_RTOL, DP_PARAM_ATOL = 5e-3, 5e-4
TWO_RANK_TIMEOUT_S = 600
# switches_check: the renderer's three switches on a night and a clear
# frame (Town01, the ego 9 m before a light, braking NPCs), card against
# CPU, at test_torch_render's bounds; drive_check with the drive switches;
# K1 on one page past 2^33 B, CILRS_TPU_ALLOW_BIG_TABLE's layout.
RENDER_SWITCH_ENV = {"CILRS_TPU_LAMPS": "1", "CILRS_TPU_NIGHT_LAMPS": "1",
                     "CILRS_TPU_CROSSWALKS": "1"}
DRIVE_SWITCH_ENV = {"CILRS_TPU_NO_REDHOLD": "1", "CILRS_TPU_NO_OFFROAD_ASSIST": "1"}
RENDER_HASH_BOUND, RENDER_MAX_SHARE, RENDER_MAX_MEAN = 0.05, 0.005, 1e-3
BIG_PAGE_ROWS = 2 ** 33 // ROW_BYTES + 5_000  # 8.85 GB, one page
SWITCH_TIMEOUT_S = 300

# hash_sinf_check: the sin-hash kernels against their plain versions on the
# CPU, bit for bit: the bare sin on 4M random bit patterns (every exponent,
# infinities and NaNs) and the hash sets, timed at a 32-env tick's rain pass
# (x [32, 88, 200], a scalar y) and grain pass (x a column of [32, 17,600, 2]
# read in place, y [32, 17,600]); each fused hash on its set and at a 32-env
# tick's shape (rain x [32, 88, 200], grain points [32, 17,600, 2], steer
# [32]), timed there.
SINF_RANDOM, SINF_ENVS = 1 << 22, 32
# Launches of each sin-hash kernel a simulator tick: the renderer's two rain
# hashes and its grain, the recovery machine's reverse steer.
SINF_LAUNCHES_PER_TICK = {"hash_sinf": 0, "hash01": 2, "grain_texture": 1, "reverse_steer": 1}
# Float64 peak of an H100 SXM outside the tensor cores (NVIDIA's data sheet).
FP64_FLOPS_PER_S = 34e12


_START = time.time()


def emit(obj: dict):
    """One JSON line; a phase's line also says when the phase ended
    (``at_s``, seconds since the script started)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.time() - _START}
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


def _gather_times(pages, idx: torch.Tensor, page_rows: int) -> dict:
    """The kernel, its plain version and index_select (the same rows' local
    indices, from the first page) on one call's rows, beside the HBM bound,
    and the kernel's error against the plain gather."""
    row_bytes = pages[0].shape[1] * pages[0].element_size()
    err = kernel_vs_plain(pages, idx, page_rows)
    kernel_ms = median_ms(functools.partial(gather_rows_paged, pages, idx, page_rows))
    bound_ms = copy_bound_ms(len(idx) * row_bytes)
    index_select = functools.partial(torch.index_select, pages[0], 0, idx.long() % page_rows)
    return {"rows": len(idx), "kernel_ms": kernel_ms,
            "plain_ms": median_ms(lambda: gather_rows_plain(pages, idx, page_rows)),
            "index_select_ms": median_ms(index_select),
            # Queued behind a sleep: the card's time alone, where a call at
            # few rows may be shorter than the host's time to issue it.
            "kernel_ms_queued": queued_ms(functools.partial(gather_rows_paged, pages, idx,
                                                            page_rows)),
            "index_select_ms_queued": queued_ms(index_select),
            "bound_ms": bound_ms, "kernel_ms_over_bound_ms": kernel_ms / bound_ms,
            "max_abs_err": err}


def phase_build_and_check(dev) -> dict:
    t0 = time.time()
    ptxas = build(["gather_rows", "hash_sinf"])  # one nvcc each, started together
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
            "ptxas": {name: [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln or "smem" in ln]
                      for name, log in ptxas.items()},
            # The ring is dynamic shared memory, which ptxas does not see: the
            # launch plan at the path's 3,000 rows, smem_bytes a block.
            "launch_plan": dict(zip(
                ("chunk_bytes", "chunks_per_row", "stages", "grid", "smem_bytes"),
                bulk_plan(ROW_BYTES, BATCH * GROUP_BATCHES,
                          torch.cuda.get_device_properties(dev).multi_processor_count)))}


def _sin_ops(arg: torch.Tensor) -> int:
    """The float64 operations glibc's sinf does on these float32 arguments:
    by the range of |argument| the reduction's (2^-12 and below: none; under
    0.75: x*x; under 120: five; larger: three, besides integer work not
    counted) and ten for the polynomial (the cos branch's; the sin branch
    takes eight)."""
    top = (arg.cpu().view(torch.int32).long() >> 20) & 0x7FF
    per = torch.where(top < TOP12_TINY, 0, torch.where(top < TOP12_PIO4, 11, torch.where(
        top < TOP12_120, 15, torch.where(top < TOP12_INF, 13, 0))))
    return int(per.sum())


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for the work: bytes at the HBM rate, float64 operations
    at the float64 peak, the larger of the two."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "float64_ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _sinf_times(x: torch.Tensor, a: float, y) -> dict:
    """The bare kernel and its plain version (torch ops on the card) on one
    call's arguments, beside the bound: bytes (4 B of x, 4 of a y tensor, 4
    out an element) at the HBM rate, and the float64 operations (the
    argument's product and sum, then the sin's) at the float64 peak. Device
    times with the calls queued behind a sleep (``queued_ms``: a call of the
    kernel is shorter than the host's cost to issue it), and back to back as
    the path issues them (``median_ms``), which is the host's pace where it
    is the slower."""
    n = x.numel()
    yc = y.cpu() if isinstance(y, torch.Tensor) else y
    ops = _sin_ops(hash_argument(x.cpu(), a, yc)) + n * (1 if y is None else 2)
    return {"elements": n, "x_shape": list(x.shape), "x_stride": list(x.stride()),
            "y": "tensor" if isinstance(y, torch.Tensor) else y,
            "kernel_ms": queued_ms(lambda: hash_sinf(x, a, y)),
            # Some 60 launches a call: 5 calls stay inside the launch queue.
            "plain_ms": queued_ms(lambda: hash_sinf_plain(x, a, y), reps=5),
            "kernel_ms_back_to_back": median_ms(lambda: hash_sinf(x, a, y)),
            "host_us_per_call": host_us_per_call(lambda: hash_sinf(x, a, y)),
            **_bound(n * (8 if isinstance(y, torch.Tensor) else 4) + n * 4, ops)}


@contextlib.contextmanager
def _sin_in_torch_ops():
    """The fused hashes' plain versions with their sin in torch ops too
    (``hash_sinf_plain`` in place of the bare kernel they call), for timing
    the plain version on the card; outside this, on a CUDA tensor they run
    the unfused composition: the bare kernel and the torch epilogue."""
    bare = sinf_mod.hash_sinf
    sinf_mod.hash_sinf = hash_sinf_plain
    try:
        yield
    finally:
        sinf_mod.hash_sinf = bare


# Each fused hash: its entry point, its plain version, and its float64 work
# and bytes on an input: (the float32 arguments its sins take, float64
# operations besides the sins, bytes read and written).
def _hash01_work(x):
    n = x.numel()
    return [hash_argument(x, sinf_mod.HASH_A, sinf_mod.HASH_C)], 2 * n, 8 * n


def _grain_work(sxy):
    args = []
    for cell in sinf_mod.GRAIN_CELLS:
        q = torch.floor(sxy * sinf_mod.cell_reciprocal(cell))
        args.append(hash_argument(q[..., 0], sinf_mod.HASH_A, q[..., 1] * sinf_mod.HASH_C))
    n = sxy.numel() // 2
    return args, 6 * n, 12 * n  # two arguments' product and sum, then the weighted sum


def _steer_work(x):
    return [hash_argument(x, sinf_mod.STEER_A, None)], 0, 8 * x.numel()


FUSED_HASHES = {
    "hash01": (lambda x: sinf_mod.hash01(x, sinf_mod.HASH_A, sinf_mod.HASH_C, sinf_mod.HASH_SCALE),
               lambda x: sinf_mod.hash01_plain(x, sinf_mod.HASH_A, sinf_mod.HASH_C,
                                               sinf_mod.HASH_SCALE), _hash01_work),
    "grain_texture": (sinf_mod.grain_texture, sinf_mod.grain_texture_plain, _grain_work),
    "reverse_steer": (sinf_mod.reverse_steer, sinf_mod.reverse_steer_plain, _steer_work),
}


def _fused_hash_times(name: str, x: torch.Tensor) -> dict:
    """A fused hash at one call's input: the kernel (queued behind a sleep,
    and back to back), the unfused composition (the bare kernel and the torch
    epilogue, some 4-21 launches) and the plain version in torch ops alone,
    queued; beside the bound."""
    fn, plain, work = FUSED_HASHES[name]
    args, extra_ops, nbytes = work(x.cpu())
    times = {"elements": x.numel() // (2 if name == "grain_texture" else 1),
             "x_shape": list(x.shape),
             "kernel_ms": queued_ms(lambda: fn(x)),
             "composition_ms": queued_ms(lambda: plain(x), reps=10),
             "kernel_ms_back_to_back": median_ms(lambda: fn(x)),
             "host_us_per_call": host_us_per_call(lambda: fn(x))}
    with _sin_in_torch_ops():
        times["plain_ms"] = queued_ms(lambda: plain(x), reps=3)
    return {**times, **_bound(nbytes, sum(_sin_ops(a) for a in args) + extra_ops)}


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(got.cpu().view(torch.int32),
                                                   want.cpu().view(torch.int32))


def sinf_launches() -> dict:
    """Launches of each sin-hash kernel since the counts were last reset."""
    return {fn.__name__: fn.launches for fn in SIN_HASHES}


def reset_sinf_launches():
    for fn in SIN_HASHES:
        fn.launches = 0


def check_sinf_launches(counts: dict, ticks: int, path: str):
    want = {name: per * ticks for name, per in SINF_LAUNCHES_PER_TICK.items()}
    if counts != want:
        raise AssertionError(f"sin-hash launches in {ticks} {path} ticks: {counts}, "
                             f"expected {want}")


def _grain_points(q: np.ndarray) -> np.ndarray:
    """Points of the grain set's cells, moved inside them, at both sizes."""
    inside = np.random.default_rng(2).uniform(0.0, 1.0, q.shape)
    return np.concatenate([((q + inside) * np.float32(cell)).astype(np.float32)
                           for cell in sinf_mod.GRAIN_CELLS])


def phase_hash_sinf_check(dev) -> tuple[dict, dict]:
    """The sin-hash kernels (csrc/hash_sinf.cu) against their plain versions
    on the CPU, bit for bit, then their times at a 32-env tick's shapes."""
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(-2 ** 31, 2 ** 31, (SINF_RANDOM,), generator=g, dtype=torch.int64)
    x = bits.to(torch.int32).view(torch.float32)
    before = sinf_launches()
    if not _same_bits(hash_sinf(x.to(dev), 1.0), hash_sinf_plain(x, 1.0)):
        raise AssertionError("hash_sinf kernel differs from its plain version on random bits")
    checked = {f"random_bits_{SINF_RANDOM}": SINF_RANDOM}
    sets = {name: torch.from_numpy(hash_sets.argument_set(name)) for name in hash_sets.SETS}
    for name, t in sets.items():
        if not _same_bits(hash_sets.port_hash(name, t.to(dev)), hash_sets.port_hash(name, t)):
            raise AssertionError(f"hash_sinf kernel differs from its plain version on {name}")
        checked[name] = t.shape[0]
    # Each fused hash on its set: the rain columns, the grain's cells as
    # points, the recovery starts.
    fused_sets = {"hash01": sets["rain"],
                  "grain_texture": torch.from_numpy(_grain_points(sets["grain"].numpy())),
                  "reverse_steer": sets["recovery"]}
    # And at a 32-env tick's shapes, from the card's generator: streak columns
    # plus a time offset, ground points of Town01's extent, recovery starts.
    gd = torch.Generator(device=dev).manual_seed(1)
    H, W = FRAME_SHAPE[:2]
    E = SINF_ENVS
    rand = lambda *shape: torch.rand(shape, generator=gd, device=dev)
    tick = {"hash01": torch.floor(rand(1, H, W) * 60.0) + torch.floor(rand(E, 1, 1) * 1.2e3 * 1.7),
            "grain_texture": rand(E, H * W, 2) * 500.0 - 50.0,
            "reverse_steer": rand(E) * 1.2e3}
    for name, (fn, plain, _) in FUSED_HASHES.items():
        for case, t in ((f"{name}_set", fused_sets[name]), (f"{name}_tick", tick[name])):
            if not _same_bits(fn(t.to(dev)), plain(t.cpu())):
                raise AssertionError(f"{name} kernel differs from its plain version at {case}")
            checked[case] = t.numel() // (2 if name == "grain_texture" else 1)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in sinf_launches().items()}
    want = {"hash_sinf": 1 + len(hash_sets.SETS), "hash01": 2, "grain_texture": 2,
            "reverse_steer": 2}
    if launched != want:
        raise AssertionError(f"launches {launched} for calls {want}")
    # The bare sin as the unfused hashes called it: the second rain hash over
    # every pixel, and a grain hash of quantized ground points.
    col = torch.floor(rand(E, H, W) * 60.0) + 1234.0
    q = torch.floor(rand(E, H * W, 2) * 2e4 - 1e4)
    passes = {"rain_pass": (col, 12.9898, 78.233),
              "grain_pass": (q[..., 0], 12.9898, q[..., 1] * 78.233)}
    times = {}
    for name, (xs, a, y) in passes.items():
        yc = y.cpu() if isinstance(y, torch.Tensor) else y
        if not _same_bits(hash_sinf(xs, a, y), hash_sinf_plain(xs.cpu(), a, yc)):
            raise AssertionError(f"hash_sinf kernel differs from its plain version at {name}")
        times[name] = _sinf_times(xs, a, y)
    for name in FUSED_HASHES:
        times[name] = _fused_hash_times(name, tick[name])
    line = {"phase": "hash_sinf_check", "ok": True, "bit_exact_elements": checked,
            "max_abs_err": 0.0, "times": times}
    emit(line)
    grain = times["grain_texture"]
    keys = ("kernel_ms", "composition_ms", "plain_ms", "kernel_ms_back_to_back", "bound_ms",
            "bound_by")
    kernel = {"name": "hash_sinf", "route": "cuda", "source": "cilrs_tpu_torch/csrc/hash_sinf.cu",
              "replaces": "no TPU kernel: XLA's float32 sin and the hashes around it at "
                          "cilrs_tpu/render/weather.py:71-74, cilrs_tpu/render/raster.py:246-252 "
                          "and :402, cilrs_tpu/agent/driver.py:273-274",
              "max_abs_err": 0.0, "ms": grain["kernel_ms"], "plain_ms": grain["plain_ms"],
              "bound_ms": grain["bound_ms"], "bound_by": grain["bound_by"], "library_ms": None,
              "timed_at": "grain_texture, 32 envs",
              "modes": {name: {k: times[name][k] for k in keys} for name in FUSED_HASHES},
              "bare_pass_ms": {name: times[name]["kernel_ms"] for name in passes}}
    return line, kernel


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
    idx = torch.from_numpy(val_idx[:EVAL_GROUP_ROWS].astype(np.int32)).to(dev)
    gather = _gather_times(table["images"], idx, table["page_rows"])
    line = {"phase": "train_full_size", "ok": True, "frames": FULL_FRAMES, "pages": len(table["images"]),
            "batch": BATCH, "epochs": TRAIN_EPOCHS, "steps_per_epoch": TRAIN_STEPS,
            "val_rows": len(val_idx), "gather_launches": launches,
            "expected_launches": want_launches, "train_wall_s": wall, "history": hist,
            "group_losses": groups, "peak_mem_bytes": peak,
            "timed_groups": TIMED_GROUPS, "train_frames_per_s": frames / timed,
            "ms_per_step": timed * 1e3 / (TIMED_GROUPS * STEPS_PER_CALL),
            "host_issue_ms_per_step": issue_ms / STEPS_PER_CALL, "host_syncs_in_group": 0,
            "profile_one_train_group": profile, "gather_6000": gather}
    return line, {"launches": launches, "max_abs_err": gather["max_abs_err"],
                  "ms_6000_rows": gather["kernel_ms"], "plain_ms_6000_rows": gather["plain_ms"],
                  "library_ms_6000_rows": gather["index_select_ms"],
                  "bound_ms_6000_rows": gather["bound_ms"]}


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


def profile_sim_layers(fn, ticks: int, layers=SIM_LAYERS, run=None) -> dict:
    """profile_ops over fn with each simulator layer of ``layers`` in a named
    range: the driver's calls (and a drive run's policy) are wrapped for this
    one run and restored. Every layer runs once a tick; one that is not
    reached through the patched name (a renamed function, a ``from x import
    f``) fails the phase instead of dropping out of the table."""
    modules = {"driver": driver_mod, "raster": raster_mod, "run": run}
    saved = {(m, name): getattr(modules[m], name) for m, name in layers}

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
    seen = profile.get("layers_under_profiler")
    if seen is not None:
        calls = {name: seen.get(name, {}).get("calls", 0) for _, name in layers}
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
    reset_sinf_launches()
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
    sinf_counts = sinf_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    wall = sum(walls)
    t0 = time.time()
    profiled = dataclasses.replace(fleet, chunk_steps=SIM_PROFILE_TICKS)
    profile = profile_sim_layers(profiled.chunk, SIM_PROFILE_TICKS)
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
            "gather_launches": k1, "sin_hash_launches": sinf_counts,
            "sin_hash_launches_per_tick": sum(sinf_counts.values()) / (SIM_TIMED_CHUNKS * T),
            "mean_luminance_by_weather": strip}
    emit(line)
    if k1 != 0:
        raise AssertionError(f"the collect path launched the gather kernel {k1} times")
    check_sinf_launches(sinf_counts, SIM_TIMED_CHUNKS * T, "collect")
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


def _frame_policy(img, speed_norm, cmd):
    """A deterministic policy that reads the frame: its mean sets the controls."""
    m = torch.tanh(img.mean(dim=(1, 2, 3)))
    return torch.stack([0.1 * m, 0.5 + 0.1 * m, 0.3 + 0.2 * m], dim=-1)


def phase_drive_check(dev) -> dict:
    """The same drive-mode fleet, 60 ticks on the card and on the CPU on the
    same pedestrian draws, compared tick by tick (CHECK_TOL); then the
    full-width CILRS's raw controls on one tick, card bf16 against float32 on
    the CPU (FWD_REL_TOL)."""
    net = make_town01()
    E = len(DRIVE_CHECK_WEATHERS)
    draws = draw_pedestrians(torch.Generator().manual_seed(5), DRIVE_CHECK_TICKS, E,
                             DRIVE_WALKERS, "cpu")
    cfg = load_train_config()
    card_model = create_train_state(cfg, 0, device=dev).model.eval()
    cpu_model = CILRS(num_commands=cfg.model.num_commands, dropout=cfg.model.dropout,
                      dtype=torch.float32, stage_sizes=tuple(cfg.model.stage_sizes),
                      speed_skip=cfg.model.speed_skip)
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    cpu_model.eval()
    outs, raw = {}, {}
    for d, model in (("cpu", cpu_model), (dev, card_model)):
        f = make_collect_fleet(net, E, DRIVE_VEHICLES + 1, DRIVE_WALKERS, seed=11,
                               chunk_steps=DRIVE_CHECK_TICKS, device=d)
        state = f.state.replace(world=f.state.world.replace(
            weather_idx=torch.tensor(DRIVE_CHECK_WEATHERS, dtype=torch.int64, device=d)))
        t0 = time.time()
        _, o = fleet_rollout(state, DRIVE_CHECK_TICKS, f.net, f.pool, f.wt, f.params,
                             draws.to(d), mode="drive", cam=f.cam, policy=_frame_policy)
        side = "cpu" if d == "cpu" else "card"
        outs[side] = {k: v.cpu().numpy() for k, v in o.items()}
        outs[side]["_wall_s"] = time.time() - t0
        seen = []
        policy = model_policy(model)
        fleet_rollout(state, 1, f.net, f.pool, f.wt, f.params, draws[:1].to(d), mode="drive",
                      cam=f.cam, policy=lambda *a: seen.append(policy(*a)) or seen[-1])
        raw[side] = seen[0].float().cpu()
    cpu, gpu = outs["cpu"], outs["card"]
    errs = {k: float(np.abs(gpu[k].astype(np.float64) - cpu[k]).max()) for k in CHECK_TOL}
    mismatches = {k: int((gpu[k] != cpu[k]).sum()) for k in CHECK_EXACT}
    fd = np.abs(gpu["frame"].astype(int) - cpu["frame"].astype(int))
    frame = {"share_beyond_1": float((fd > 1).mean()), "mean_abs": float(fd.mean()),
             "max_abs": int(fd.max())}
    rel = float((raw["card"] - raw["cpu"]).abs().max() / raw["cpu"].abs().max().clamp_min(1e-12))
    line = {"phase": "drive_check", "ok": True, "map": "town01", "envs": E,
            "vehicles": DRIVE_VEHICLES, "walkers": DRIVE_WALKERS, "ticks": DRIVE_CHECK_TICKS,
            "weathers": list(DRIVE_CHECK_WEATHERS), "max_abs_err": errs,
            "int_mismatches": mismatches, "frames_u8": frame,
            "ego_path_m": np.linalg.norm(np.diff(cpu["pos"], axis=1), axis=-1).sum(axis=1).tolist(),
            "statuses_seen": sorted(set(cpu["status"].flatten().tolist())),
            "wall_s": {"cpu": cpu["_wall_s"], "card": gpu["_wall_s"]},
            "cilrs_one_tick": {"controls_bf16_card": raw["card"].tolist(),
                               "controls_f32_cpu": raw["cpu"].tolist(), "rel_err": rel},
            "tolerance": {**CHECK_TOL, "frame_share_beyond_1": FRAME_MAX_SHARE,
                          "frame_mean": FRAME_MAX_MEAN, "cilrs_rel": FWD_REL_TOL}}
    emit(line)  # the readings first, so a failed check still shows them
    bad = [k for k, e in errs.items() if not e <= CHECK_TOL[k]] + \
        [k for k, n in mismatches.items() if n] + \
        (["frame"] if not (frame["share_beyond_1"] <= FRAME_MAX_SHARE
                           and frame["mean_abs"] <= FRAME_MAX_MEAN) else []) + \
        (["cilrs_controls"] if not rel <= FWD_REL_TOL else [])
    if bad:
        raise AssertionError(f"card drive rollout differs from the CPU's in {bad}")
    return line


def phase_drive_full_size(dev) -> dict:
    """The benchmark protocol at full width through cli.drive's chunk function."""
    t0 = time.time()
    run, route_m = drive_cli.make_drive_run(
        make_town01(), BENCH_SPAWN, BENCH_DESTINATION, DRIVE_VEHICLES, DRIVE_WALKERS, "clear",
        seed=0, device=dev)
    setup_s = time.time() - t0
    T = drive_cli.CHUNK_TICKS
    gather_rows_paged.launches = 0
    t0 = time.time()
    run.chunk()  # warm-up: cuDNN picks its algorithms, constants are cached
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    walls, issues = [], []
    reset_sinf_launches()
    for _ in range(DRIVE_TIMED_CHUNKS):
        t0 = time.perf_counter()
        outs = run.chunk()
        issues.append(time.perf_counter() - t0)  # host time to issue the chunk's ticks
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not torch.isfinite(outs["control"]).all():
            raise AssertionError("non-finite controls")
    sinf_counts = sinf_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    wall = sum(walls)
    ticks = DRIVE_TIMED_CHUNKS * T
    t0 = time.time()
    profile = profile_sim_layers(run.chunk, T, DRIVE_LAYERS, run)
    profile["profile_and_analysis_s"] = time.time() - t0
    aten_calls = count_aten_calls(lambda: run.chunk(1))
    syncs = sync_check(run.chunk)
    if syncs:
        raise AssertionError(f"a drive chunk waits for the card: {syncs}")
    k1 = gather_rows_paged.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = compute_scores(run.state.metrics)  # what cli.drive reads a chunk
    scoring_ms = (time.perf_counter() - t0) * 1e3
    line = {"phase": "drive_full_size", "ok": True, "map": "town01", "envs": 1,
            "spawn": BENCH_SPAWN, "destination": BENCH_DESTINATION, "route_m": route_m,
            "vehicles": DRIVE_VEHICLES, "walkers": DRIVE_WALKERS, "chunk_ticks": T,
            "camera": [88, 200], "policy": "CILRS ResNet-34, bf16, random init (seed 0)",
            "setup_s": setup_s, "warmup_chunk_s": warmup_s, "chunk_walls_s": walls,
            "ticks_per_s": ticks / wall, "real_time_factor": ticks * driver_mod.DT / wall,
            "ms_per_tick": wall * 1e3 / ticks,
            "host_issue_ms_per_tick": sum(issues) * 1e3 / ticks,
            "peak_mem_bytes": peak, "peak_mem_above_start_bytes": peak - base_mem,
            "busy_share_unprofiled": profile.get("device_ms_per_tick", 0) * ticks / (wall * 1e3),
            "profile_one_chunk": profile, "aten_calls_one_tick": aten_calls,
            "host_syncs_in_chunk": 0, "gather_launches": k1, "sin_hash_launches": sinf_counts,
            "sin_hash_launches_per_tick": sum(sinf_counts.values()) / ticks,
            "scoring_ms": scoring_ms,
            "scores_after_run": {k: scores[k] for k in ("overall", "total_distance_m",
                                                        "collisions", "teleports")}}
    emit(line)
    if k1 != 0:
        raise AssertionError(f"the drive path launched the gather kernel {k1} times")
    check_sinf_launches(sinf_counts, ticks, "drive")
    return line


def phase_benchmark_cli(dev, workdir: str, ckpt_dir: str) -> dict:
    """cli.benchmark on collect_cli's checkpoint directory, five weathers."""
    out = os.path.join(workdir, "RESULTS_bench.md")
    events = os.path.join(workdir, "bench_events")
    t0 = time.time()
    results = benchmark_cli.main(["--checkpoint", ckpt_dir, "--duration", str(BENCH_CLI_DURATION),
                                  "--out", out, "--json-out", os.path.join(workdir, "bench.json"),
                                  "--events-dir", events, "--device", str(dev)])
    wall = time.time() - t0
    with open(out) as f:
        md = f.read().splitlines()
    rows = [ln for ln in md if ln.startswith("| ") and not ln.startswith("| Weather")]
    if list(results) != list(WEATHER_NAMES) or len(rows) != len(WEATHER_NAMES):
        raise AssertionError(f"benchmark weathers {list(results)}, {len(rows)} markdown rows")
    if not all(math.isfinite(s[k]) for s in results.values()
               for k in ("overall", "safety", "comfort", "route_completion")):
        raise AssertionError(f"non-finite scores {results}")
    files = sorted(os.listdir(events))
    if files != sorted(f"events_{w}.json" for w in WEATHER_NAMES):
        raise AssertionError(f"event files {files}")
    return {"phase": "benchmark_cli", "ok": True, "duration_s": BENCH_CLI_DURATION,
            "wall_s": wall, "markdown_rows": rows,
            "scores": {w: {k: s[k] for k in ("overall", "grade", "total_distance_m",
                                             "collisions", "teleports", "total_frames")}
                       for w, s in results.items()}}


def phase_pipeline_cli(dev, workdir: str) -> dict:
    """cli.pipeline --resident: collect into the card-resident table, train
    and report from it through the gather kernel, then the benchmark."""
    work = os.path.join(workdir, "pipeline")
    gather_rows_paged.launches = 0
    t0 = time.time()
    timing = pipeline_cli.main(["--workdir", work, "--resident", "--frames", str(PIPELINE_FRAMES),
                                "--envs", str(SIM_ENVS), "--epochs", "1",
                                "--bench-duration", str(PIPELINE_BENCH_DURATION),
                                "--device", str(dev)])
    wall = time.time() - t0
    launches = gather_rows_paged.launches
    # The launches the path must make: the train groups of the epoch, two
    # val passes (EMA and raw) and the report, from the split of the labels.
    cfg = load_train_config()
    ds = load_sessions_labels(os.path.join(work, "session_resident"))
    train_idx, val_idx = stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
    spe = max(1, len(train_idx) // BATCH)
    want = (-(-spe // STEPS_PER_CALL) + 2 * -(-max(1, len(val_idx) // BATCH) // EVAL_GROUP_BATCHES)
            + -(-len(val_idx) // (BATCH * GROUP_BATCHES)))
    if launches != want:
        raise AssertionError(f"{launches} gather launches on the pipeline path, expected {want}")
    with open(os.path.join(work, "evaluation_report.json")) as f:
        report = json.load(f)
    with open(os.path.join(work, "benchmark.json")) as f:
        bench = json.load(f)
    if len(ds) != PIPELINE_FRAMES or report["num_samples"] != len(val_idx) or \
            list(bench) != list(WEATHER_NAMES) or not math.isfinite(report["steer"]["mae"]):
        raise AssertionError(f"pipeline: {len(ds)} frames, report {report['num_samples']}, "
                             f"benchmark {list(bench)}")
    return {"phase": "pipeline_cli", "ok": True, "frames": PIPELINE_FRAMES, "envs": SIM_ENVS,
            "wall_s": wall, "timing": timing, "gather_launches": launches,
            "expected_launches": want, "val_rows": len(val_idx),
            "report_steer_mae": report["steer"]["mae"],
            "bench_overall": {w: s["overall"] for w, s in bench.items()}}


def _probe(module, name: str, timed, sync_call: int, profile_call: int, ticks: int):
    """Wrap ``module.name`` for one run: calls numbered in ``timed`` are
    synchronised before and after (host ms to issue, wall ms), call
    ``sync_call`` runs under CUDA's sync check and call ``profile_call``
    under the profiler (``profile_ops`` over ``ticks``). Returns (the
    original function, the record)."""
    orig = getattr(module, name)
    rec = {"calls": 0, "issue_ms": [], "wall_ms": [], "syncs": None, "profile": None}

    def call(*args, **kwargs):
        rec["calls"] += 1
        n, box = rec["calls"], []
        run = lambda: box.append(orig(*args, **kwargs))
        if n in timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            rec["issue_ms"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            rec["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        elif n == sync_call:
            rec["syncs"] = sync_check(run)
        elif n == profile_call:
            rec["profile"] = profile_ops(run, ticks)
        else:
            run()
        return box[0]

    setattr(module, name, call)
    return orig, rec


def _fused_args(ckpt: str, hist_path: str, dev) -> list:
    """cli.fused's arguments at full width (fused_full_size and its sharded
    twin run the same call)."""
    return ["--map", "town01", "--steps", str(FUSED_STEPS), "--envs", str(FUSED_ENVS),
            "--vehicles", str(SIM_VEHICLES), "--walkers", str(SIM_WALKERS),
            "--buffer", str(FUSED_BUFFER), "--collect-ticks", str(FUSED_TICKS),
            "--train-per-chunk", str(FUSED_PER_CHUNK), "--ckpt-dir", ckpt,
            "--history-json", hist_path, "--device", str(dev)]


def _record_steps(rec: dict):
    """Wrap train.fused's weighted step for one run: the first chunk's
    losses (kept on the card, read after the run) go to ``rec["first_chunk"]``,
    the step's mesh to ``rec["mesh"]``. Returns the original maker."""
    orig = fused_mod.make_weighted_train_step

    def make(cfg, mesh=None):
        rec["mesh"] = mesh
        step = orig(cfg, mesh)

        def recorded(state, batch, seed):
            parts = step(state, batch, seed)
            if len(rec["first_chunk"]) < FUSED_PER_CHUNK:
                rec["first_chunk"].append(torch.stack([parts["loss"], parts["plain_loss"]]).clone())
            return parts

        return recorded

    fused_mod.make_weighted_train_step = make
    return orig


def phase_fused_full_size(dev, workdir: str) -> tuple[dict, dict, str]:
    """cli.fused at full width, FUSED_STEPS train steps (see the module
    docstring), with its chunk functions probed (``_probe``) and its first
    sampled batch held bit-exact against the plain gather."""
    ckpt = os.path.join(workdir, "fused_ckpt")
    hist_path = os.path.join(workdir, "fused_history.json")
    d = int(np.prod(FRAME_SHAPE))
    sampled = {}
    steps = {"first_chunk": []}
    orig_sample = fused_mod.sample_batch

    def sample_checked(buf, draws):
        out = orig_sample(buf, draws)
        if not sampled:  # the first batch: its frames against the plain gather
            want = gather_rows_plain((buf.images,), out["idx"], buf.capacity)[:, :d]
            sampled.update(max_abs_err=max_abs_err(out["images"].reshape(len(want), d), want),
                           rows=len(want), ring=buf.images, idx=out["idx"].int())
        return out

    probes = {}
    fused_mod.sample_batch = sample_checked
    orig_step = _record_steps(steps)
    try:
        probes["collect"] = _probe(fused_mod, "collect_chunk", FUSED_TIMED["collect"],
                                   FUSED_SYNC_CALL, FUSED_PROFILE_CALL, FUSED_TICKS)
        probes["train"] = _probe(fused_mod, "train_chunk", FUSED_TIMED["train"],
                                 FUSED_SYNC_CALL, FUSED_PROFILE_CALL, FUSED_PER_CHUNK)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        gather_rows_paged.launches = 0
        reset_sinf_launches()
        t0 = time.time()
        out = fused_cli.main(_fused_args(ckpt, hist_path, dev))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, sinf_counts = gather_rows_paged.launches, sinf_launches()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        fused_mod.sample_batch = orig_sample
        fused_mod.make_weighted_train_step = orig_step
        for orig, _ in probes.values():
            setattr(fused_mod, orig.__name__, orig)
    col, trn = probes["collect"][1], probes["train"][1]
    hist = out["history"]
    with open(hist_path) as f:
        if json.load(f)["history"] != json.loads(json.dumps(hist)):
            raise AssertionError("the history JSON differs from the returned history")
    model = load_policy(ckpt, device=dev)
    with torch.inference_mode():
        x = normalize(torch.rand((8,) + FRAME_SHAPE, device=dev))
        ctl, ps = model(x, torch.full((8,), 0.3, device=dev), torch.arange(8, device=dev) % 4)
    # The kernel at the path's shapes, on the run's ring: a train batch (120
    # rows; 60, a rank's at world 2) and the val snapshot (V = 4,080 rows,
    # whole batches of at most 4,096).
    ring, idx = sampled.pop("ring"), sampled.pop("idx")
    first_batch_rows = idx.tolist()
    val_rows = (min(4096, FUSED_BUFFER // 4) // BATCH) * BATCH
    snap_rows = torch.arange(val_rows, device=dev, dtype=torch.int32) * 7 % FUSED_BUFFER
    gathers = {"batch": _gather_times((ring,), idx, FUSED_BUFFER),
               "batch_a_rank_at_world_2": _gather_times((ring,), idx[:BATCH // 2], FUSED_BUFFER),
               "val_snapshot": _gather_times((ring,), snap_rows, FUSED_BUFFER)}
    del ring
    torch.cuda.empty_cache()

    chunk_ms = float(np.mean(col["wall_ms"]))
    collect_chunks = FUSED_WARMUP_CHUNKS + -(-int(FUSED_STEPS * 0.75) // FUSED_PER_CHUNK)
    train_ms = float(np.mean(trn["wall_ms"]))
    line = {"phase": "fused_full_size", "ok": True, "map": "town01", "envs": FUSED_ENVS,
            "vehicles": SIM_VEHICLES, "walkers": SIM_WALKERS, "ring_frames": FUSED_BUFFER,
            "collect_ticks": FUSED_TICKS, "train_steps_per_chunk": FUSED_PER_CHUNK,
            "batch": BATCH, "train_steps": out["train_steps"],
            "cut": f"--steps {FUSED_STEPS} instead of 2,000",
            "wall_s": wall, "loop_wall_s": out["wall_s"],
            "frames_collected": out["frames_collected"], "train_fleet_chunks": collect_chunks,
            "kept_share": out["frames_collected"] / (collect_chunks * FUSED_ENVS * FUSED_TICKS),
            "collected_frames_per_s": out["frames_collected"] / (collect_chunks * chunk_ms / 1e3),
            "env_steps_per_s": FUSED_ENVS * FUSED_TICKS / (chunk_ms / 1e3),
            "collect_chunk_ms": col["wall_ms"], "collect_chunk_issue_ms": col["issue_ms"],
            "train_chunk_ms": trn["wall_ms"], "train_chunk_issue_ms": trn["issue_ms"],
            "train_frames_per_s": FUSED_PER_CHUNK * BATCH / (train_ms / 1e3),
            "loop_train_frames_per_s": out["frames_per_sec_train"],
            "profile_one_collect_chunk": col["profile"], "profile_one_train_chunk": trn["profile"],
            "peak_mem_bytes": peak, "ring_bytes": FUSED_BUFFER * d,
            "history_last": hist[-1] if hist else None, "gather_launches": launches,
            "expected_launches": out["train_steps"] + 1, "sin_hash_launches": sinf_counts,
            "sampled_batch_vs_plain": sampled,
            "gather": gathers, "host_syncs": {"collect": col["syncs"], "train": trn["syncs"]},
            "checkpoint_controls_finite": bool(torch.isfinite(ctl).all() and torch.isfinite(ps).all())}
    emit(line)  # the readings first, so a failed check still shows them
    if not hist or not all(math.isfinite(v) for h in hist for k, v in h.items()
                           if isinstance(v, float)):
        raise AssertionError(f"history {hist}")
    if launches != out["train_steps"] + 1:
        raise AssertionError(f"{launches} gather launches, expected {out['train_steps'] + 1}")
    if not all(sinf_counts[name] >= 1 for name, per in SINF_LAUNCHES_PER_TICK.items() if per):
        raise AssertionError(f"the fused loop's sin-hash launches: {sinf_counts}")
    if sampled.get("max_abs_err") != 0.0:
        raise AssertionError(f"a sampled batch differs from the plain gather: {sampled}")
    if col["syncs"] or trn["syncs"] or col["syncs"] is None or trn["syncs"] is None:
        raise AssertionError(f"a fused chunk waits for the card: {line['host_syncs']}")
    if not line["checkpoint_controls_finite"]:
        raise AssertionError("the saved checkpoint's forward is not finite")
    reference = {"frames_collected": out["frames_collected"], "history": hist,
                 "first_batch_rows": first_batch_rows,
                 "first_chunk_losses": torch.stack(steps["first_chunk"]).tolist(),
                 "collect_chunk_ms": col["wall_ms"], "train_chunk_ms": trn["wall_ms"],
                 "peak_mem_bytes": peak, "wall_s": wall}
    return line, {"launches": launches, "max_abs_err": max(g["max_abs_err"] for g in gathers.values()),
                  "fused_gathers": gathers, "sin_hash_launches": sinf_counts}, ckpt, reference


def phase_residuals_cli(dev, workdir: str, ckpt: str) -> dict:
    """evaluation.residuals on the fused checkpoint, at its defaults."""
    out_path = os.path.join(workdir, "residuals.json")
    t0 = time.time()
    rep = residuals_mod.main(["--checkpoint", ckpt, "--envs", str(FUSED_ENVS),
                              "--frames", str(RESIDUAL_FRAMES), "--out", out_path,
                              "--device", str(dev)])
    wall = time.time() - t0
    line = {"phase": "residuals_cli", "ok": True, "frames": RESIDUAL_FRAMES, "envs": FUSED_ENVS,
            "wall_s": wall, "n": rep["n"], "mae": rep["mae"], "corr": rep["corr"],
            "speed_mae": rep["speed_mae"], "segments": len(rep.get("segments", {}))}
    emit(line)
    values = list(rep["mae"].values()) + list(rep["corr"].values()) + [rep["speed_mae"]]
    if rep["n"] != RESIDUAL_FRAMES or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"residual report: n {rep['n']}, {values}")
    return line


def phase_prepare_check(dev, workdir: str) -> dict:
    """process_session on the card against the CPU: a 512-frame 600x800
    .npz shard and two PNGs, u8 within 1 level."""
    from PIL import Image

    raw = os.path.join(workdir, "prepare_raw")
    os.makedirs(raw)
    h, w = PREPARE_SOURCE
    yy, xx = (a.astype(np.uint8) for a in np.mgrid[0:h, 0:w])  # uint8 arithmetic wraps at 256
    k = np.arange(PREPARE_FRAMES, dtype=np.uint8)[:, None, None]
    frames = np.stack([xx[None] + 3 * k, yy[None] * 2 + k, (xx ^ yy)[None] + 5 * k], -1)
    np.savez_compressed(os.path.join(raw, "frames_0000.npz"), frames=frames)
    for i in range(2):
        Image.fromarray(frames[i * (PREPARE_FRAMES // 2)]).save(os.path.join(raw, f"frame_{i:08d}.png"))
    with open(os.path.join(raw, "measurements.csv"), "w") as f:
        f.write("frame,image_filename\n")
    walls = {}
    for d in (dev, "cpu"):
        t0 = time.time()
        rep = prepare_mod.process_session(raw, os.path.join(workdir, f"prepared_{d}"), verbose=False,
                                          device=d)
        walls[str(d)] = time.time() - t0
    diffs = {}
    for name in sorted(os.listdir(os.path.join(workdir, "prepared_cpu"))):
        a, b = (os.path.join(workdir, f"prepared_{d}", name) for d in (dev, "cpu"))
        if name.endswith(".npz"):
            fa, fb = np.load(a)["frames"], np.load(b)["frames"]
        elif name.endswith(".png"):
            fa, fb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        else:
            continue
        if fa.shape != fb.shape or fa.shape[-3:] != FRAME_SHAPE:
            raise AssertionError(f"{name}: {fa.shape} against {fb.shape}")
        diffs[name] = int(np.abs(fa.astype(int) - fb.astype(int)).max())
    line = {"phase": "prepare_check", "ok": True, "frames_in": rep["frames_in"],
            "source": list(PREPARE_SOURCE), "wall_s": walls, "max_abs_u8_card_vs_cpu": diffs}
    emit(line)
    if rep["frames_in"] != PREPARE_FRAMES + 2 or max(diffs.values()) > 1:
        raise AssertionError(f"prepare: {rep}, u8 differences {diffs}")
    return line


def phase_osm_collect(dev, workdir: str) -> dict:
    """The inline OSM campus through build_map("osm:..."), one collect chunk
    of OSM_ENVS envs on the card."""
    path = os.path.join(workdir, "campus.osm")
    with open(path, "w") as f:
        f.write(OSM_XML)
    net = build_map(f"osm:{path}")
    fleet = make_collect_fleet(net, OSM_ENVS, 4, 2, seed=OSM_SEED, chunk_steps=OSM_TICKS, device=dev)
    t0 = time.time()
    outs = {k: v.cpu().numpy() for k, v in fleet.chunk().items()}
    wall = time.time() - t0
    line = {"phase": "osm_collect", "ok": True, "waypoints": net.num_waypoints,
            "spawn_points": net.num_spawn_points, "lights": net.num_lights, "envs": OSM_ENVS,
            "ticks": OSM_TICKS, "wall_s": wall,
            "ego_path_m": np.linalg.norm(np.diff(outs["pos"], axis=1), axis=-1).sum(axis=1).tolist(),
            "frame_mean": float(outs["frame"].mean() / 255.0)}
    emit(line)
    if outs["frame"].shape != (OSM_ENVS, OSM_TICKS) + FRAME_SHAPE or not (
            np.isfinite(outs["pos"]).all() and np.isfinite(outs["yaw"]).all()):
        raise AssertionError(f"osm chunk: frames {outs['frame'].shape}, poses finite "
                             f"{np.isfinite(outs['pos']).all()}")
    return line


def _count_collectives(name: str, rec: dict, calls: int = 3):
    """Wrap ``train.fused.<name>`` for one run: the mesh's collective calls
    made by each of its first ``calls`` calls go to ``rec[name]``."""
    orig = getattr(fused_mod, name)
    rec[name] = []

    def call(*args, **kwargs):
        mesh = rec.get("mesh")
        before = mesh.collectives if mesh is not None else 0
        out = orig(*args, **kwargs)
        if len(rec[name]) < calls and mesh is not None:
            rec[name].append(mesh.collectives - before)
        return out

    setattr(fused_mod, name, call)


def fused_rank_main(out_json: str, argv: list) -> int:
    """The rank program of fused_sharded_full_size, which torchrun starts:
    cli.fused's main with ``argv``, its chunk functions timed (``_probe``)
    and their collectives counted, the first sampled batch's rows and the
    first train chunk's losses recorded. Rank 0 writes ``out_json``."""
    rec = {"first_chunk": []}
    orig_sample = fused_mod.sample_batch

    def sample(buf, draws):
        out = orig_sample(buf, draws)
        rec.setdefault("first_batch_rows", out["idx"])
        return out

    fused_mod.sample_batch = sample
    _record_steps(rec)
    col = _probe(fused_mod, "collect_chunk", FUSED_TIMED["collect"], 0, 0, FUSED_TICKS)[1]
    trn = _probe(fused_mod, "train_chunk", FUSED_TIMED["train"], 0, 0, FUSED_PER_CHUNK)[1]
    _count_collectives("collect_chunk", rec)
    _count_collectives("train_chunk", rec)
    build(["gather_rows"])
    gather_rows_paged.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fused_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    mesh = rec["mesh"]
    result = {"rank": mesh.rank, "world": mesh.world, "backend": dist.get_backend(),
              "device": torch.cuda.get_device_name(mesh.device), "wall_s": wall,
              "loop_wall_s": out["wall_s"], "frames_collected": out["frames_collected"],
              "train_steps": out["train_steps"], "history": out["history"],
              "first_batch_rows": rec["first_batch_rows"].tolist(),
              "first_chunk_losses": torch.stack(rec["first_chunk"]).tolist(),
              "collect_chunk_ms": col["wall_ms"], "collect_chunk_issue_ms": col["issue_ms"],
              "train_chunk_ms": trn["wall_ms"], "train_chunk_issue_ms": trn["issue_ms"],
              "collectives_per_chunk": {"collect": rec["collect_chunk"],
                                        "train": rec["train_chunk"]},
              "collectives_total": mesh.collectives,
              "gather_launches": gather_rows_paged.launches,
              "peak_mem_bytes": torch.cuda.max_memory_allocated(mesh.device)}
    if mesh.rank == 0:
        with open(out_json, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
    return 0


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def phase_fused_sharded_full_size(dev, workdir: str, ref: dict) -> dict:
    """cli.fused under ``torchrun --standalone --nproc_per_node 1``: the
    sharded path in a world of 1 over NCCL, at fused_full_size's call, held
    to that run (``ref``)."""
    ckpt = os.path.join(workdir, "sharded_ckpt")
    hist_path = os.path.join(workdir, "sharded_history.json")
    out_json = os.path.join(workdir, "sharded_rank0.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           os.path.abspath(__file__), "--fused-rank", out_json,
           *_fused_args(ckpt, hist_path, "cuda")]
    t0 = time.time()
    # A session of its own, so that a timeout stops torchrun's worker too.
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        _, err = proc.communicate(timeout=SHARDED_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}: {err[-3000:]}")
    with open(out_json) as f:
        r = json.load(f)
    with open(hist_path) as f:
        written = json.load(f)["history"]
    loss_err = max(_rel(a, b) for got, want in zip(r["first_chunk_losses"], ref["first_chunk_losses"])
                   for a, b in zip(got, want))
    hist_err, hist_bad = {}, []
    for got, want in zip(r["history"], ref["history"]):
        for k, v in want.items():
            if k in ("step", "frames", "time_s"):
                continue
            err = abs(got[k] - v)
            hist_err[k] = max(hist_err.get(k, 0.0), err / max(abs(v), 1e-12))
            if err > SHARDED_HISTORY_TOL["atol"] + SHARDED_HISTORY_TOL["rtol"] * abs(v):
                hist_bad.append(k)
    model = load_policy(ckpt, device=dev)
    with torch.inference_mode():
        x = normalize(torch.rand((8,) + FRAME_SHAPE, device=dev))
        ctl, ps = model(x, torch.full((8,), 0.3, device=dev), torch.arange(8, device=dev) % 4)
    line = {"phase": "fused_sharded_full_size", "ok": True,
            "launch": "torchrun --standalone --nproc_per_node 1 -m cilrs_tpu_torch.cli.fused",
            "world": r["world"], "backend": r["backend"], "wall_s": wall,
            "loop_wall_s": {"sharded": r["loop_wall_s"], "single": ref["wall_s"]},
            "frames_collected": {"sharded": r["frames_collected"], "single": ref["frames_collected"]},
            "first_batch_rows_equal": r["first_batch_rows"] == ref["first_batch_rows"],
            "first_chunk_losses": {"sharded": r["first_chunk_losses"],
                                   "single": ref["first_chunk_losses"], "max_rel_err": loss_err},
            "history_max_rel_err": hist_err, "history_last": r["history"][-1] if r["history"] else None,
            "collect_chunk_ms": {"sharded": r["collect_chunk_ms"], "single": ref["collect_chunk_ms"]},
            "train_chunk_ms": {"sharded": r["train_chunk_ms"], "single": ref["train_chunk_ms"]},
            "collect_chunk_issue_ms": r["collect_chunk_issue_ms"],
            "train_chunk_issue_ms": r["train_chunk_issue_ms"],
            "nccl_collectives_per_chunk": r["collectives_per_chunk"],
            "nccl_collectives_total": r["collectives_total"],
            "peak_mem_bytes": {"sharded": r["peak_mem_bytes"], "single": ref["peak_mem_bytes"]},
            "gather_launches": r["gather_launches"], "expected_launches": r["train_steps"] + 1,
            "history_json_written": written == r["history"],
            "checkpoint_controls_finite": bool(torch.isfinite(ctl).all() and torch.isfinite(ps).all()),
            "tolerance": {"first_chunk_rel": SHARDED_LOSS_RTOL, "history": SHARDED_HISTORY_TOL}}
    emit(line)
    bad = [k for k, ok in (
        ("world", r["world"] == 1 and r["backend"] == "nccl"),
        ("frames_collected", r["frames_collected"] == ref["frames_collected"]),
        ("first_batch_rows", line["first_batch_rows_equal"]),
        ("first_chunk_losses", loss_err <= SHARDED_LOSS_RTOL),
        ("history", not hist_bad and len(r["history"]) == len(ref["history"]) > 0),
        ("gather_launches", r["gather_launches"] == r["train_steps"] + 1),
        ("history_json", line["history_json_written"]),
        ("checkpoint", line["checkpoint_controls_finite"])) if not ok]
    if bad:
        raise AssertionError(f"the sharded world-1 run differs from the single path in {bad} "
                             f"(history keys {sorted(set(hist_bad))})")
    return line


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _params_sha(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _flat_params(model: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])


def _step_batch(dev, cfg) -> dict:
    """BATCH full-width frames and labels from a seed; the weights have mean
    1 in each half, as each rank's sampler normalizes its own."""
    g = torch.Generator().manual_seed(TWO_RANK_SEED)
    b = BATCH
    w = torch.rand(b, generator=g) * 2.0 + 0.2
    w = torch.cat([w[:b // 2] / w[:b // 2].mean(), w[b // 2:] / w[b // 2:].mean()])
    batch = {"images": torch.randint(0, 256, (b,) + FRAME_SHAPE, generator=g, dtype=torch.uint8),
             "speed": torch.rand(b, generator=g) * 0.5,
             "command": torch.randint(0, cfg.model.num_commands, (b,), generator=g, dtype=torch.int32),
             "controls": torch.stack([torch.rand(b, generator=g) * 0.6 - 0.3,
                                      torch.rand(b, generator=g) * 0.8,
                                      torch.rand(b, generator=g) * 0.3], 1),
             "weights": w}
    return {k: v.to(dev) for k, v in batch.items()}


def _two_shards_in_one(cfg, batch: dict, seeds, dev):
    """The weighted fused step of two ranks, computed in one process: each
    60-frame shard's gradient, running statistics and losses from the same
    weights, averaged, then one update. Returns (losses [2], state)."""
    ref = create_train_state(cfg, 0, device=dev)
    grads, runs, losses = [], [], []
    for r, seed in enumerate(seeds):
        st = create_train_state(cfg, 0, device=dev)
        st.apply_gradients = lambda: None  # keep the shard's raw gradient
        half = slice(r * BATCH // 2, (r + 1) * BATCH // 2)
        parts = fused_mod.make_weighted_train_step(cfg)(st, {k: v[half] for k, v in batch.items()},
                                                        seed)
        grads.append([p.grad for p in st.model.parameters()])
        runs.append(running_stats(st.model))
        losses.append(torch.stack([parts["loss"], parts["plain_loss"]]))
    with torch.no_grad():
        for p, g0, g1 in zip(ref.model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        for b, s0, s1 in zip(running_stats(ref.model), *runs):
            b.copy_((s0 + s1) / 2)
    ref.apply_gradients()
    return (losses[0] + losses[1]) / 2, ref


def _two_rank_work(mesh) -> dict:
    """What each of the two ranks runs (see parallel_two_ranks_one_card)."""
    dev = mesh.device
    res = {"rank": mesh.rank}
    # (a) The sharded collect rollout, world 2 against world 1.
    fleet = make_collect_fleet(make_town01(), TWO_RANK_ENVS, SIM_VEHICLES, SIM_WALKERS, None,
                               TWO_RANK_SEED, TWO_RANK_TICKS, device=dev)
    draws = draw_pedestrians(torch.Generator(device=dev).manual_seed(TWO_RANK_SEED),
                             TWO_RANK_TICKS, TWO_RANK_ENVS, SIM_WALKERS, dev)
    run = make_sharded_rollout(mesh, TWO_RANK_TICKS, fleet.wt, fleet.params, mode="collect",
                               want_frames=True, pool_batched=True)
    torch.cuda.synchronize()
    t0 = time.time()
    _, outs2 = run(fleet.state, fleet.net, fleet.pool, draws)
    torch.cuda.synchronize()
    res["rollout_world2_s"] = time.time() - t0
    res["rollout_collectives"] = mesh.collectives
    if mesh.rank == 0:
        t0 = time.time()
        _, outs1 = fleet_rollout(fleet.state, TWO_RANK_TICKS, fleet.net, fleet.pool, fleet.wt,
                                 fleet.params, draws, mode="collect")
        torch.cuda.synchronize()
        res["rollout_world1_s"] = time.time() - t0
        a = {k: v.cpu().numpy() for k, v in outs2.items()}
        b = {k: v.cpu().numpy() for k, v in outs1.items()}
        fd = np.abs(a["frame"].astype(int) - b["frame"].astype(int))
        res["rollout"] = {
            "shapes_equal": all(a[k].shape == b[k].shape for k in b) and set(a) == set(b),
            "max_abs_err": {k: float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in CHECK_TOL},
            "int_mismatches": {k: int((a[k] != b[k]).sum()) for k in CHECK_EXACT},
            "frames_u8": {"share_beyond_1": float((fd > 1).mean()), "mean_abs": float(fd.mean())}}
    # (b) One weighted fused step, world 2 against the two shards in one
    # process; one data-parallel loop step, world 2 against world 1.
    cfg = load_train_config()
    batch = _step_batch(dev, cfg)
    seeds = [FUSED_STEP_SEED + fused_mod.RANK_SEED_STRIDE * r for r in range(mesh.world)]
    st = create_train_state(cfg, 0, device=dev)
    parts = fused_mod.make_weighted_train_step(cfg, mesh)(st, shard_batch(mesh, batch),
                                                          seeds[mesh.rank])
    res["fused"] = {"loss": [float(parts["loss"]), float(parts["plain_loss"])],
                    "sha": _params_sha(st.model)}
    if mesh.rank == 0:
        ref_loss, ref = _two_shards_in_one(cfg, batch, seeds, dev)
        res["fused"]["reference_loss"] = ref_loss.tolist()
        res["fused"]["param_max_abs_err"] = float(
            (_flat_params(st.model) - _flat_params(ref.model)).abs().max())
    dp_batch = {k: v for k, v in batch.items() if k != "weights"}
    st = create_train_state(cfg, 0, device=dev)
    parts = make_train_step(cfg, mesh)(st, shard_batch(mesh, dp_batch), FUSED_STEP_SEED)
    res["dp"] = {"loss": float(parts["loss"]), "sha": _params_sha(st.model),
                 "dropout": cfg.model.dropout}
    if mesh.rank == 0:
        ref = create_train_state(cfg, 0, device=dev)
        ref_parts = make_train_step(cfg)(ref, dp_batch, FUSED_STEP_SEED)
        res["dp"]["reference_loss"] = float(ref_parts["loss"])
        res["dp"]["param_max_abs_err"] = float(
            (_flat_params(st.model) - _flat_params(ref.model)).abs().max())
    res["collectives"] = mesh.collectives
    return res


def _two_rank_main(rank: int, port: int, out_dir: str):
    """A rank of parallel_two_ranks_one_card: gloo on cuda:0."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    try:
        res = _two_rank_work(make_mesh(2))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_parallel_two_ranks_one_card(dev, workdir: str) -> dict:
    """Two ranks on the one card over gloo, world 2 against world 1 (see the
    constants' note)."""
    out_dir = os.path.join(workdir, "two_ranks")
    os.makedirs(out_dir)
    t0 = time.time()
    torch_mp.spawn(_two_rank_main, args=(_free_port(), out_dir), nprocs=2, join=True)
    wall = time.time() - t0
    r0, r1 = (json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2))
    roll = r0["rollout"]
    fl, dp = r0["fused"], r0["dp"]
    line = {"phase": "parallel_two_ranks_one_card", "ok": True, "backend": "gloo", "world": 2,
            "wall_s": wall, "rollout": {"envs": TWO_RANK_ENVS, "ticks": TWO_RANK_TICKS,
                                        "world2_s": r0["rollout_world2_s"],
                                        "world1_s": r0["rollout_world1_s"],
                                        "collectives": r0["rollout_collectives"], **roll},
            "fused_step": {**fl, "loss_rel_err": _rel(fl["loss"][0], fl["reference_loss"][0]),
                           "ranks_identical": fl["sha"] == r1["fused"]["sha"]},
            "dp_step": {**dp, "loss_rel_err": _rel(dp["loss"], dp["reference_loss"]),
                        "ranks_identical": dp["sha"] == r1["dp"]["sha"]},
            "batch": BATCH, "batch_per_rank": BATCH // 2,
            "tolerance": {**CHECK_TOL, "frame_share_beyond_1": FRAME_MAX_SHARE,
                          "frame_mean": FRAME_MAX_MEAN, "loss_rel": DP_LOSS_RTOL,
                          "param_abs": DP_PARAM_ATOL}}
    emit(line)
    f = roll["frames_u8"]
    bad = [k for k, e in roll["max_abs_err"].items() if not e <= CHECK_TOL[k]] + \
        [k for k, n in roll["int_mismatches"].items() if n] + \
        [k for k, ok in (
            ("rollout_shapes", roll["shapes_equal"]),
            ("frame", f["share_beyond_1"] <= FRAME_MAX_SHARE and f["mean_abs"] <= FRAME_MAX_MEAN),
            ("fused_loss", line["fused_step"]["loss_rel_err"] <= DP_LOSS_RTOL),
            ("fused_params", fl["param_max_abs_err"] <= DP_PARAM_ATOL),
            ("fused_ranks", line["fused_step"]["ranks_identical"]),
            ("dp_loss", line["dp_step"]["loss_rel_err"] <= DP_LOSS_RTOL),
            ("dp_params", dp["param_max_abs_err"] <= DP_PARAM_ATOL),
            ("dp_ranks", line["dp_step"]["ranks_identical"])) if not ok]
    if bad:
        raise AssertionError(f"world 2 on one card differs from world 1 in {bad}")
    return line


def phase_switches_render(dev) -> dict:
    """The three renderer switches (set before this process imported the
    renderer): a night and a clear frame on the card against the CPU, and the
    pixels the switches add on both."""
    if not (raster_mod._LAMPS and raster_mod._NIGHT_LAMPS and raster_mod._CROSSWALKS):
        raise AssertionError("the renderer switches are not set in this process")
    net = make_town01()
    h = net.host
    E, weathers = 3, (3, 0, 3)
    world = make_world(E, 5, 2)
    pos, yaw_all = np.zeros((E, 5, 2), np.float32), np.zeros((E, 5), np.float32)
    ped = np.zeros((E, 2, 2), np.float32)
    for e in range(E):
        li = (7 * e + 3) % len(h.light_xy)
        yaw = float(h.light_yaw[li])
        fwd = np.array([np.cos(yaw), np.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        xy = h.light_xy[li] - 9.0 * fwd
        pos[e] = [xy, xy + fwd * 12 + left * 3.4, xy + fwd * 16 - left * 3.4, xy + fwd * 30,
                  xy + fwd * 45 + left * 3.5]
        yaw_all[e] = [yaw, yaw, yaw + 0.1, yaw, yaw + 3.14]
        ped[e] = [xy + fwd * 9 + left * 5, xy - fwd * 5 - left * 5]
    ctl = np.tile(np.array([[0, 0, 0], [0, 0, 0.8], [0, 0, 0.3], [0, 0, 0.9], [0, 0, 0.6]],
                           np.float32), (E, 1, 1))
    world = world.replace(
        veh_pos=torch.from_numpy(pos), veh_yaw=torch.from_numpy(yaw_all),
        veh_alive=torch.ones(E, 5, dtype=torch.bool), veh_control=torch.from_numpy(ctl),
        veh_reverse=torch.tensor([[False, False, False, True, False]] * E),
        ped_pos=torch.from_numpy(ped), ped_alive=torch.ones(E, 2, dtype=torch.bool),
        weather_idx=torch.tensor(weathers), time_s=torch.tensor([4.0, 13.0, 22.0]))
    frames, walls = {}, {}
    for side, d in (("cpu", "cpu"), ("card", dev)):
        n, w = net.to(d), dataclasses.replace(world, **{
            f.name: getattr(world, f.name).to(d) for f in dataclasses.fields(world)})
        t0 = time.time()
        frames[side] = raster_mod.render_frame(n, w, light_states(n, w.time_s)).cpu().numpy()
        flags = {k: getattr(raster_mod, k) for k in ("_LAMPS", "_NIGHT_LAMPS", "_CROSSWALKS")}
        walls[side] = time.time() - t0
        for k in flags:
            setattr(raster_mod, k, False)
        try:
            frames[side + "_default"] = raster_mod.render_frame(
                n, w, light_states(n, w.time_s)).cpu().numpy()
        finally:
            for k, v in flags.items():
                setattr(raster_mod, k, v)
    diff = np.abs(frames["card"] - frames["cpu"])
    added = {s: np.abs(frames[s] - frames[s + "_default"]).max(-1) > RENDER_HASH_BOUND
             for s in ("cpu", "card")}
    line = {"phase": "switches_render", "ok": True, "map": "town01", "envs": E,
            "weathers": list(weathers), "switches": sorted(RENDER_SWITCH_ENV),
            "share_beyond_0.05": float((diff > RENDER_HASH_BOUND).mean()),
            "mean_abs": float(diff.mean()),
            "added_pixels": {s: int(a.sum()) for s, a in added.items()},
            "added_pixels_differing": int((added["cpu"] != added["card"]).sum()),
            "wall_s": walls}
    emit(line)
    if not (line["share_beyond_0.05"] <= RENDER_MAX_SHARE and line["mean_abs"] <= RENDER_MAX_MEAN
            and line["added_pixels"]["cpu"] > 100
            and line["added_pixels_differing"] <= 0.01 * line["added_pixels"]["cpu"]):
        raise AssertionError(f"the switched frame differs between card and CPU: {line}")
    return line


def _phase_in_subprocess(name: str, env: dict) -> dict:
    """``chip_smoke.py --phase name`` in a fresh process with ``env`` added:
    its phase line, or its failure."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--phase", name],
                         env={**os.environ, **env}, capture_output=True, text=True,
                         timeout=SWITCH_TIMEOUT_S)
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    got = [ln for ln in lines if ln.get("phase") == name]
    if res.returncode != 0 or not got or not got[-1].get("ok"):
        raise AssertionError(f"{name} with {sorted(env)} failed (exit {res.returncode}): "
                             f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
    return got[-1]


def phase_switches_check(dev) -> dict:
    """The opt-in switches on the card: the renderer's and the drive ones in
    subprocesses (the renderer reads its switches at import), then K1
    bit-exact on one page past 2^33 B, the layout CILRS_TPU_ALLOW_BIG_TABLE
    gives a table."""
    t0 = time.time()
    render = _phase_in_subprocess("switches_render", RENDER_SWITCH_ENV)
    drive = _phase_in_subprocess("drive_check", DRIVE_SWITCH_ENV)
    pages, page_rows, _ = paged_layout(BIG_PAGE_ROWS, ROW_BYTES, 0, 2 ** 40)
    g = torch.Generator(device=dev).manual_seed(33)
    big = (torch.randint(0, 256, (BIG_PAGE_ROWS, ROW_BYTES), generator=g, device=dev,
                         dtype=torch.uint8),)
    first_past = -(-2 ** 33 // ROW_BYTES)  # the first row that starts past 2^33 B
    idx = torch.cat([torch.randint(first_past - 100, BIG_PAGE_ROWS, (400,), generator=g,
                                   device=dev, dtype=torch.int32),
                     torch.tensor([first_past, BIG_PAGE_ROWS - 1, 0], dtype=torch.int32,
                                  device=dev)])
    gather_rows_paged.launches = 0
    err = kernel_vs_plain(big, idx, page_rows)
    launches = gather_rows_paged.launches
    big_bytes = big[0].numel()
    del big
    torch.cuda.empty_cache()
    line = {"phase": "switches_check", "ok": True, "wall_s": time.time() - t0,
            "switches_render": {k: v for k, v in render.items() if k not in ("phase", "ok")},
            "drive_check_switches": sorted(DRIVE_SWITCH_ENV),
            "drive_check": {k: drive[k] for k in ("max_abs_err", "int_mismatches", "frames_u8",
                                                  "statuses_seen", "ego_path_m", "cilrs_one_tick")},
            "big_page": {"pages": pages, "page_rows": page_rows, "page_bytes": big_bytes,
                         "rows_past_2^33_bytes": BIG_PAGE_ROWS - first_past,
                         "max_abs_err": err, "launches": launches}}
    emit(line)
    if pages != 1 or big_bytes <= 2 ** 33 or err != 0.0:
        raise AssertionError(f"the big page: {line['big_page']}")
    return line


def load_sessions_labels(session: str):
    """A resident session's labels (measurements.csv) as a DriveDataset."""
    import csv

    from cilrs_tpu_torch.data.dataset import DriveDataset

    with open(os.path.join(session, "measurements.csv")) as f:
        rows = list(csv.DictReader(f))
    col = lambda k, dt: np.array([r[k] for r in rows], dtype=np.float64).astype(dt)
    return DriveDataset(images=None, speed_norm=col("speed_normalized", np.float32),
                        command=col("high_level_command", np.int32),
                        controls=np.stack([col(k, np.float32)
                                           for k in ("steer", "throttle", "brake")], axis=1))


# Phases that ``--phase NAME`` runs alone (switches_check runs them in a
# process of their own, with its switches set).
ALONE = {"switches_render": phase_switches_render, "drive_check": phase_drive_check,
         "hash_sinf_check": phase_hash_sinf_check}


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if argv[:1] == ["--fused-rank"]:
        return fused_rank_main(argv[1], argv[2:])
    dev = torch.device("cuda")
    if argv[:1] == ["--phase"]:
        try:
            ALONE[argv[1]](dev)
        except Exception as e:
            traceback.print_exc()
            emit({"phase": argv[1], "ok": False, "error": f"{type(e).__name__}: {e}"})
            return 1
        return 0
    emit({"phase": "setup", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "python": sys.version.split()[0]})
    phase = "build_and_kernel_check"
    try:
        emit(phase_build_and_check(dev))
        phase = "hash_sinf_check"
        _, sinf_kernel = phase_hash_sinf_check(dev)
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
            phase = "drive_check"
            phase_drive_check(dev)
            phase = "drive_full_size"
            drive_line = phase_drive_full_size(dev)
            phase = "benchmark_cli"
            emit(phase_benchmark_cli(dev, workdir, os.path.join(workdir, "run_collected")))
            phase = "pipeline_cli"
            pipeline_line = phase_pipeline_cli(dev, workdir)
            emit(pipeline_line)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="cilrs_smoke_fused_") as workdir:
            phase = "fused_full_size"
            _, fused_kernel, fused_ckpt, fused_ref = phase_fused_full_size(dev, workdir)
            phase = "residuals_cli"
            phase_residuals_cli(dev, workdir, fused_ckpt)
            phase = "prepare_check"
            phase_prepare_check(dev, workdir)
            phase = "osm_collect"
            phase_osm_collect(dev, workdir)
            torch.cuda.empty_cache()
            phase = "fused_sharded_full_size"
            sharded_line = phase_fused_sharded_full_size(dev, workdir, fused_ref)
            phase = "parallel_two_ranks_one_card"
            phase_parallel_two_ranks_one_card(dev, workdir)
        phase = "switches_check"
        phase_switches_check(dev)
        phase = "report"
        kernel["launches_by_path"] = {"eval_full_size": kernel["launches"],
                                      "train_full_size": train_kernel.pop("launches"),
                                      "collect_full_size": collect_line["gather_launches"],
                                      "drive_full_size": drive_line["gather_launches"],
                                      "pipeline_cli": pipeline_line["gather_launches"],
                                      "fused_full_size": fused_kernel.pop("launches"),
                                      "fused_sharded_full_size": sharded_line["gather_launches"]}
        kernel["launches"] = sum(kernel["launches_by_path"].values())
        kernel["max_abs_err"] = max(kernel["max_abs_err"], train_kernel.pop("max_abs_err"),
                                    fused_kernel.pop("max_abs_err"))
        # The source's kernels on the main paths, every mode: each path's
        # counts by mode, and their sum.
        by_path = {"collect_full_size": collect_line["sin_hash_launches"],
                   "drive_full_size": drive_line["sin_hash_launches"],
                   "fused_full_size": fused_kernel.pop("sin_hash_launches")}
        sinf_kernel["launches_by_path"] = by_path
        sinf_kernel["launches"] = sum(sum(c.values()) for c in by_path.values())
        for name, mode in sinf_kernel["modes"].items():
            mode["launches"] = sum(c[name] for c in by_path.values())
        sinf_kernel["launches_per_tick"] = {
            "collect": collect_line["sin_hash_launches_per_tick"],
            "drive": drive_line["sin_hash_launches_per_tick"]}
        # Every kernel a tick launches, under the profiler.
        sinf_kernel["tick_device_activities"] = {
            "collect": collect_line["profile_one_chunk"].get("device_activities_per_tick"),
            "drive": drive_line["profile_one_chunk"].get("device_activities_per_tick")}
        kernel.update(train_kernel)
        kernel.update(fused_kernel)
        emit({"kernels": [kernel, sinf_kernel]})
        print(card_line(), flush=True)
    except Exception as e:  # a failed phase ends the run: report it, no ok line
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
