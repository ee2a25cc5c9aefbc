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
  3. full size: a 176,256-frame u8 table on the card (9.31 GB, 2 pages), the
     seed-42 val split evaluated with collect_predictions_resident at batch
     120 and 25 batches a gather; kernel / plain / index_select timings at the
     path's 3,000-row gather beside a contiguous copy_ of the same bytes (the
     practical ceiling of a copy on the card) and the HBM bound, the kernel's
     GB/s, and the host microseconds a call of the wrapper and of
     index_select takes to issue; frames per second; the card's bf16 forward
     on 8 frames against the same weights in float32 on the CPU.

Prints one JSON line per phase, then the kernels line, the card's name and
power limit, and last {"ok": true, "device": {...}}. A failed phase ends the
run with a non-zero exit and no ok line; so does a machine without CUDA.
"""

from __future__ import annotations

import functools
import json
import math
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from cilrs_tpu_torch.bench.timing import card_line, copy_bound_ms, host_us_per_call, median_ms
from cilrs_tpu_torch.cli import report as report_cli
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.dataset import make_synthetic_dataset, save_session, stratified_split
from cilrs_tpu_torch.evaluation.report import GROUP_BATCHES, collect_predictions_resident
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.ops.build import build
from cilrs_tpu_torch.ops.gather import (bulk_plan, gather_rows_paged, gather_rows_plain,
                                        paged_layout)
from cilrs_tpu_torch.ops.image import normalize
from cilrs_tpu_torch.train.checkpoint import load_policy, save_checkpoint_pth

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
    session = os.path.join(workdir, "session_000")
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


def phase_full_size(dev, ckpt: str) -> tuple[dict, dict]:
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
    profile = profile_group(model, table, labels, val_idx[:BATCH * GROUP_BATCHES], cfg)

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
    return line, kernel


def profile_group(model, table, labels, rows, cfg) -> dict:
    """Device time by kernel over one group (25 batches) under torch.profiler:
    the busy share of the group's wall time and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        collect_predictions_resident(model, table, labels, rows, BATCH, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in kernels)
    if busy_ms == 0:
        return {"device_time": "not measured (the profiler saw no device time)"}
    gather_ms = sum(ms for k, ms in kernels if "gather_rows_kernel" in k)
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return {"rows": len(rows), "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "gather_kernel_ms": gather_ms,
            "top_kernels_ms": [[k[:80], ms] for k, ms in top]}


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
            phase = "full_size"
            line, kernel = phase_full_size(dev, ckpt)
            emit(line)
        phase = "report"
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
