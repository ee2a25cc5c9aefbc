"""Card-resident frame tables.

``ship_resident`` copies a host ``DriveDataset`` to the card once, into the
table dict that ``cilrs_tpu/data/resident.py:collect_resident`` returns (the
counterpart of the JAX trainer's ship-once path): ``images`` a tuple of pages
sized by ``paged_layout``, each [n_p, row_elems] uint8 with rows padded to 16
bytes; ``page_rows`` (logical rows per non-final page; global row g lives at
pages[g // page_rows][g % page_rows]); ``image_shape``; and ``speed``
(normalized), ``command`` and ``controls`` as flat device tensors.
``gather_group`` reads a group of batches from such a table with one launch
of the row-gather kernel, ``snapshot_rows`` copies rows into a table of their
own, and ``labels_dataset`` is the host-label view the split and sampler use.

``collect_resident`` builds the same table on the card from a collecting
fleet (port of ``cilrs_tpu/data/resident.py:collect_resident``): no frame
crosses to the host, only the labels do (the split, the sampler, the session
CSV). Label hygiene is ``data/collect.py``'s: stationary frames and recovery
or teleport frames never enter the table. JAX's ``make_fleet`` is
``data/collect.py:make_collect_fleet``, which ``collect_resident`` calls.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from cilrs_tpu_torch.agent.controller import ST_OK
from cilrs_tpu_torch.agent.driver import DT
from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import COMMAND_NAMES, SPEED_NORM_FACTOR, WEATHER_NAMES
from cilrs_tpu_torch.data.collect import MIN_SPEED_KMH, make_collect_fleet
from cilrs_tpu_torch.data.dataset import DriveDataset
from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.render.camera import CameraSpec
from cilrs_tpu_torch.render.raster import CAMERA
from cilrs_tpu_torch.ops.gather import (PAGE_BYTE_LIMIT, gather_rows_paged, padded_row_elems,
                                        paged_layout)

SHIP_CHUNK_ROWS = 16384  # bounds the host fancy-index temp (~865 MB of 88x200 frames)
LABEL_KEYS = ("speed", "command", "controls")
# Labels of the session CSV and the label tooling that stay on the host only.
AUX_KEYS = ("speed_kmh", "pos", "yaw", "obstacle_dist", "tl_state", "env", "tick")
SESSION_SEED_STRIDE = 7919  # the fresh session of page s is seeded seed + 7919 * s


def ship_resident(ds: DriveDataset, device="cuda", idx: np.ndarray | None = None,
                  max_page_bytes: int = PAGE_BYTE_LIMIT) -> dict:
    """Copy rows ``idx`` of ``ds`` (all rows by default, in that order) to
    ``device`` as a paged resident table. Frames go over in chunks of
    ``SHIP_CHUNK_ROWS``, so no host temp holds the whole table."""
    dev = require_cuda(device)
    idx = np.arange(len(ds)) if idx is None else np.asarray(idx)
    if len(idx) == 0:
        raise ValueError("no rows to ship")
    img_shape = tuple(ds.images.shape[1:])
    d = int(np.prod(img_shape))
    dtype = torch.from_numpy(ds.images[:0]).dtype
    d_pad = padded_row_elems(d, dtype)
    row_bytes = d_pad * ds.images.itemsize
    num_pages, page_rows, _ = paged_layout(len(idx), row_bytes, 0, max_page_bytes)
    pages = []
    for p in range(num_pages):
        rows = idx[p * page_rows:(p + 1) * page_rows]
        page = torch.empty((len(rows), d_pad), dtype=dtype, device=dev)
        page[:, d:].zero_()
        for s in range(0, len(rows), SHIP_CHUNK_ROWS):
            sub = rows[s:s + SHIP_CHUNK_ROWS]
            page[s:s + len(sub), :d].copy_(torch.from_numpy(ds.images[sub].reshape(len(sub), -1)))
        pages.append(page)
    return {
        "images": tuple(pages),
        "page_rows": page_rows,
        "image_shape": img_shape,
        "speed": torch.from_numpy(ds.speed_norm[idx]).to(dev),
        "command": torch.from_numpy(ds.command[idx]).to(dev),
        "controls": torch.from_numpy(ds.controls[idx]).to(dev),
    }


def labels_dataset(labels: dict) -> DriveDataset:
    """Host-label view as a DriveDataset (images=None) for the split/sampler."""
    return DriveDataset(
        images=None,
        speed_norm=labels["speed"],
        command=labels["command"],
        controls=labels["controls"],
    )


def _index_tensor(idx: np.ndarray, dev: torch.device) -> torch.Tensor:
    """int32 indices on ``dev``. On the card they go through pinned memory
    without a sync: a pageable copy would wait for the work already queued."""
    t = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def gather_group(table: dict, idxs: np.ndarray) -> dict:
    """Rows ``idxs`` (any shape, e.g. [K, B] for K batches) of ``table`` ->
    a batch dict of flat [K*B, ...] tensors: the frames through one launch of
    the row-gather kernel, the labels by indexing."""
    pages = table["images"] if isinstance(table["images"], tuple) else (table["images"],)
    flat = _index_tensor(np.reshape(idxs, -1), pages[0].device)
    shape = tuple(table["image_shape"])
    d = int(np.prod(shape))
    frames = gather_rows_paged(pages, flat, int(table.get("page_rows", 0)))
    batch = {"images": frames[:, :d].reshape((-1,) + shape)}
    sel = flat.long()
    batch.update({k: table[k][sel] for k in LABEL_KEYS})
    return batch


def snapshot_rows(table: dict, rows: np.ndarray) -> dict:
    """An independent one-page table of ``rows`` of ``table``, copied through
    one launch of the row-gather kernel."""
    flat = _index_tensor(rows, table["images"][0].device)
    sel = flat.long()
    return {"images": (gather_rows_paged(table["images"], flat, table["page_rows"]),),
            "page_rows": len(rows), "image_shape": tuple(table["image_shape"]),
            **{k: table[k][sel] for k in LABEL_KEYS}}


def collect_resident(
    net: RoadNetwork,
    num_frames: int,
    num_envs: int = 64,
    num_vehicles: int = 12,
    num_pedestrians: int = 6,
    weather_idx: int | None = None,
    seed: int = 0,
    chunk_steps: int = 50,
    cam: CameraSpec = CAMERA,
    output_dir: str | None = None,
    verbose: bool = True,
    max_page_bytes: int = PAGE_BYTE_LIMIT,
    device="cuda",
) -> tuple[dict, dict, dict]:
    """Collect exactly ``num_frames`` teacher-labelled frames into a table on
    ``device``. Returns (table, labels, stats):

      - table: the dict ``ship_resident`` returns, which ``train()``,
        ``gather_group`` and ``collect_predictions_resident`` read: ``images``
        a tuple of [page_slots, d_pad] u8 pages laid out by ``paged_layout``
        (each page has ``chunk`` rows of slack after its ``page_rows``
        logical rows), ``page_rows``, ``image_shape``, and ``speed``
        (normalized), ``command`` and ``controls`` on the device;
      - labels: the same labels as host numpy, plus speed_kmh, pos, yaw,
        obstacle_dist, tl_state, env and tick (the env's tick in its session);
      - stats: frames/s, env-steps/s, sim Hz, the command distribution.

    Weathers are mixed when ``weather_idx`` is None (env e in weather e % 5).
    A chunk keeps its frames with a stable sort, kept rows first in (tick,
    env) order, and its whole block of E*T rows lands at the page's cursor
    in one contiguous copy; the cursor then advances by the kept count, the
    one number the host reads a chunk. A page whose cursor passes its logical
    rows drops the overshoot and the next page starts a fresh session: a new
    fleet seeded ``seed + 7919 * s``, its clock back at 0. With
    ``output_dir``, writes measurements.csv (image_filename
    ``resident#<row>``), aux.csv and summary.txt: everything but the frames.

    The JAX package's switches, read at each call: ``CILRS_TPU_ALLOW_BIG_TABLE=1``
    builds one page whatever its size (``max_page_bytes = 2**40``; the
    row-gather kernel's offsets are 64-bit), and ``CILRS_TPU_CONTINUOUS_COLLECT=1``
    keeps one session across the pages (the fleet and its clock run on).
    """
    if os.environ.get("CILRS_TPU_ALLOW_BIG_TABLE") == "1":
        max_page_bytes = 2 ** 40
    dev = require_cuda(device)
    H, W = cam.height, cam.width
    D = H * W * 3
    d_pad = padded_row_elems(D, torch.uint8)
    N = num_frames
    M = num_envs * chunk_steps
    num_pages, page_rows, page_slots = paged_layout(N, d_pad, M, max_page_bytes)

    def fleet_for(session_seed: int):
        return make_collect_fleet(net, num_envs, num_vehicles, num_pedestrians, weather_idx,
                                  session_seed, chunk_steps, cam, dev)

    def new_page():
        z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
        return {"images": z(page_slots, d_pad, dtype=torch.uint8), "speed": z(page_slots),
                "command": z(page_slots, dtype=torch.int32), "controls": z(page_slots, 3),
                "speed_kmh": z(page_slots), "pos": z(page_slots, 2), "yaw": z(page_slots),
                "obstacle_dist": z(page_slots), "tl_state": z(page_slots, dtype=torch.int32),
                "env": z(page_slots, dtype=torch.int32), "tick": z(page_slots, dtype=torch.int32)}

    # A chunk's rows are ordered (t, e): row = t * num_envs + e.
    env_ids = torch.arange(num_envs, dtype=torch.int32, device=dev).repeat(chunk_steps)
    tick_ids = torch.arange(chunk_steps, dtype=torch.int32, device=dev).repeat_interleave(num_envs)

    def chunk(fleet, page: dict, cursor: int, base_tick: int) -> torch.Tensor:
        """One chunk into ``page`` at ``cursor``; returns the kept count (on
        the device)."""
        outs = fleet.chunk()
        flat = lambda x: x.transpose(0, 1).reshape((M,) + x.shape[2:])
        speed_kmh = flat(outs["speed_kmh"])
        keep = (speed_kmh > MIN_SPEED_KMH) & (flat(outs["status"]) == ST_OK)
        perm = torch.argsort((~keep).to(torch.int8), stable=True)
        rows = slice(cursor, cursor + M)
        page["images"][rows, :D].copy_(flat(outs["frame"]).reshape(M, D).index_select(0, perm))
        block = {"speed": torch.clamp(speed_kmh / SPEED_NORM_FACTOR, 0.0, 1.0),
                 "command": flat(outs["command"]), "controls": flat(outs["control"]),
                 "speed_kmh": speed_kmh, "pos": flat(outs["pos"]), "yaw": flat(outs["yaw"]),
                 "obstacle_dist": flat(outs["obstacle_dist"]),
                 "tl_state": flat(outs["tl_state"]), "env": env_ids, "tick": tick_ids + base_tick}
        for k, v in block.items():
            page[k][rows].copy_(v.index_select(0, perm))
        return keep.sum()

    def logical(p: int) -> int:
        return page_rows if p < num_pages - 1 else N - (num_pages - 1) * page_rows

    fresh_sessions = os.environ.get("CILRS_TPU_CONTINUOUS_COLLECT") != "1"
    fleet = fleet_for(seed)
    page, done_pages = new_page(), []
    cursor = chunks = session_chunks = filled = 0
    max_chunks = 20 * (N // M + 1) + 20 * num_pages  # the stall guard
    t0 = time.time()
    while filled < N:
        cursor += int(chunk(fleet, page, cursor, session_chunks * chunk_steps))
        if chunks == 0:
            first_chunk_s = time.time() - t0
            if verbose:
                print(f"  resident-collect first chunk: {first_chunk_s:.1f}s", flush=True)
            t0 = time.time()  # steady-state rates exclude the first chunk
            filled0 = min(cursor, logical(0))
        chunks += 1
        session_chunks += 1
        if chunks >= max_chunks:
            raise RuntimeError(
                f"collection stalled: {filled}/{N} frames after {chunks} chunks "
                f"(fleet mostly stationary or in recovery?)")
        if cursor >= page_rows and len(done_pages) < num_pages - 1:
            if verbose:
                print(f"  page {len(done_pages)} full: rolled over, "
                      f"{cursor - page_rows} overshoot frames dropped", flush=True)
            done_pages.append(page)
            page, cursor = new_page(), 0
            if fresh_sessions:
                s = len(done_pages)
                fleet = fleet_for(seed + SESSION_SEED_STRIDE * s)
                session_chunks = 0
                if verbose:
                    print(f"  session {s + 1}/{num_pages}: fresh world "
                          f"(seed {seed + SESSION_SEED_STRIDE * s})", flush=True)
        filled = len(done_pages) * page_rows + min(cursor, logical(len(done_pages)))
        if verbose and chunks % 20 == 0:
            print(f"  resident-collect {filled}/{N} frames "
                  f"({filled / max(time.time() - t0, 1e-9):.0f} frames/s)", flush=True)

    pages = done_pages + [page]
    del done_pages, page, fleet
    cat = lambda k: torch.cat([pages[p][k][:logical(p)] for p in range(num_pages)])
    dev_labels = {k: cat(k) for k in LABEL_KEYS}
    labels = {k: v.cpu().numpy() for k, v in dev_labels.items()}
    labels.update({k: cat(k).cpu().numpy() for k in AUX_KEYS})
    wall = time.time() - t0
    cmd_counts = np.bincount(labels["command"], minlength=4)
    stats = {
        "frames": N,
        "command_distribution": {COMMAND_NAMES[i]: int(cmd_counts[i]) for i in range(4)},
        "first_chunk_s": first_chunk_s,
        "wall_time_s": wall + first_chunk_s,
        "frames_per_sec": (N - filled0) / max(wall, 1e-9),
        "env_steps": chunks * M,
        "env_steps_per_sec": (chunks - 1) * M / max(wall, 1e-9),
        "sim_hz": (N - filled0) / max(DT * chunk_steps * (chunks - 1), 1e-9),
        "keep_fraction": N / max(chunks * M, 1),
        "num_pages": num_pages,
        "page_rows": page_rows,
    }
    table = {"images": tuple(p["images"] for p in pages), **dev_labels,
             "page_rows": page_rows, "image_shape": (H, W, 3)}
    if output_dir is not None:
        _write_session_csv(output_dir, labels, stats, num_envs, weather_idx)
    if verbose:
        print(f"  resident-collect done: {N} frames in {wall:.1f}s "
              f"({stats['frames_per_sec']:.0f} frames/s, "
              f"{stats['env_steps_per_sec']:.0f} env-steps/s)", flush=True)
    return table, labels, stats


def _write_session_csv(output_dir: str, labels: dict, stats: dict, num_envs: int,
                       weather_idx: int | None):
    """measurements.csv, aux.csv and summary.txt of a resident collection:
    the session format minus the frames."""
    os.makedirs(output_dir, exist_ok=True)
    now = time.time()
    n = stats["frames"]
    with open(os.path.join(output_dir, "measurements.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([
            "frame", "image_filename", "steer", "throttle", "brake", "speed_kmh",
            "speed_normalized", "high_level_command", "command_name",
            "position_x", "position_y", "position_z", "yaw", "timestamp",
        ])
        ct, sp, cm = labels["controls"], labels["speed_kmh"], labels["command"]
        po, yw = labels["pos"], labels["yaw"]
        for k in range(n):
            w.writerow([
                k, f"resident#{k}",
                f"{ct[k, 0]:.6f}", f"{ct[k, 1]:.6f}", f"{ct[k, 2]:.6f}",
                f"{sp[k]:.3f}", f"{labels['speed'][k]:.6f}",
                int(cm[k]), COMMAND_NAMES[int(cm[k])],
                f"{po[k, 0]:.3f}", f"{po[k, 1]:.3f}", "0.000",
                f"{np.degrees(yw[k]):.3f}", f"{now:.3f}",
            ])
    with open(os.path.join(output_dir, "aux.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "obstacle_dist", "tl_state", "env", "tick"])
        for k in range(n):
            w.writerow([k, f"{labels['obstacle_dist'][k]:.3f}", int(labels["tl_state"][k]),
                        int(labels["env"][k]), int(labels["tick"][k])])
    wname = "mixed" if weather_idx is None else WEATHER_NAMES[weather_idx]
    lines = [
        "=" * 50,
        "DATA COLLECTION SUMMARY (resident)",
        "=" * 50,
        f"Frames: {n}",
        f"Weather: {wname}",
        f"Envs: {num_envs}",
        f"Wall time: {stats['wall_time_s']:.1f}s ({stats['frames_per_sec']:.0f} frames/s)",
        f"Sim rate: {stats['sim_hz']:.0f} Hz aggregate",
        "",
        "Command distribution:",
    ]
    for name, c in stats["command_distribution"].items():
        lines.append(f"  {name}: {c} ({100.0 * c / max(n, 1):.1f}%)")
    with open(os.path.join(output_dir, "summary.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
