"""A/B of the row-gather kernel on one NVIDIA GPU, at the offline-evaluation
path's shape: this tree's kernel (``csrc/gather_rows.cu``) against the
one-block-per-row design it replaced, built from that design's source in the
same run, beside ``index_select`` and a contiguous ``copy_``.

    python -m cilrs_tpu_torch.bench.gather_ab --baseline OLD_gather_rows.cu [--out FILE]

The baseline is the one-block-per-row ``gather_rows.cu``, whose launcher takes
``(page_ptrs, page_phys_rows, num_pages, page_rows, idx, b, out, row_bytes,
stream)``. The table is the full-size one of ``chip_smoke.py``: 176,256
random u8 frames of 52,800 B in 2 pages; the indices are the first 3,000 rows
of the seed-42 val split.

The kernel is first checked bit-exact against the baseline, an independent
implementation, on the path's indices and on out-of-range and page-edge ones.
Then the baseline, the kernel, one ``index_select`` and one contiguous
``copy_`` of the same bytes are timed in turns (the order, reversed, and so
on, five times), each the median of 7 rounds of 20 launches queued back to
back, and the host time a call of each gather takes to issue. Prints one JSON
object; ``--out`` writes it to a file too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from cilrs_tpu_torch.bench.timing import (card_line, copy_bound_ms, host_us_per_call,
                                          median_ms)
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.dataset import make_synthetic_dataset, stratified_split
from cilrs_tpu_torch.ops import build
from cilrs_tpu_torch.ops import gather as tg

FULL_FRAMES = 176_256
ROW_BYTES = 88 * 200 * 3
ROWS = 3_000
TURNS = 5
BASELINE_ARGTYPES = [
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p]


def build_baseline(src: str):
    """nvcc of the baseline source with the tree's flags, started beside the
    tree's own build; returns the process and the library it writes."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, f"ab_baseline_{os.getpid()}.so")
    proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def baseline_gather(lib, pages, idx, page_rows):
    """The baseline's wrapper as it was: its checks, fresh ctypes arrays and a
    device context on every call."""
    dev = pages[0].device
    row_bytes = pages[0].shape[1] * pages[0].element_size()
    if row_bytes % 16 or len(pages) > lib.gather_rows_max_pages():
        raise ValueError("baseline cannot take these pages")
    for pg in pages:
        if pg.data_ptr() % 16 or pg.shape[0] == 0:
            raise ValueError("every page must be non-empty and 16-byte aligned")
    out = torch.empty((idx.shape[0], pages[0].shape[1]), dtype=pages[0].dtype, device=dev)
    ptrs = (ctypes.c_void_p * len(pages))(*[pg.data_ptr() for pg in pages])
    rows = (ctypes.c_longlong * len(pages))(*[pg.shape[0] for pg in pages])
    with torch.cuda.device(dev):
        status = lib.gather_rows_launch(
            ptrs, rows, len(pages), page_rows, idx.data_ptr(), idx.shape[0],
            out.data_ptr(), row_bytes, torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"baseline launch failed: {status}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="the one-block-per-row gather_rows.cu")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    proc, base_path = build_baseline(args.baseline)
    build.build(["gather_rows"])
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the baseline:\n{log}")
    base_lib = ctypes.CDLL(base_path)
    base_lib.gather_rows_launch.argtypes = BASELINE_ARGTYPES
    base_lib.gather_rows_launch.restype = ctypes.c_int
    base_lib.gather_rows_max_pages.restype = ctypes.c_int

    num_pages, page_rows, _ = tg.paged_layout(FULL_FRAMES, ROW_BYTES, 0)
    g = torch.Generator(device=dev).manual_seed(42)
    pages = tuple(
        torch.randint(0, 256, (min(page_rows, FULL_FRAMES - p * page_rows), ROW_BYTES),
                      generator=g, device=dev, dtype=torch.uint8)
        for p in range(num_pages))
    cfg = load_train_config()
    lab = make_synthetic_dataset(FULL_FRAMES, seed=42, h=1, w=1)
    _, val_idx = stratified_split(lab, cfg.training.val_fraction, cfg.training.seed)
    idx = torch.from_numpy(val_idx[:ROWS].astype(np.int32)).to(dev)
    edge = torch.cat([idx[:100], torch.tensor([-1, FULL_FRAMES, page_rows - 1, page_rows,
                                              2 * page_rows + 5], dtype=torch.int32, device=dev)])
    for i in (idx, edge):
        if not torch.equal(tg.gather_rows_paged(pages, i, page_rows),
                           baseline_gather(base_lib, pages, i, page_rows)):
            raise AssertionError("the kernel differs from the baseline")

    contiguous = pages[0][:ROWS]  # the same 158.4 MB, contiguous
    dst = torch.empty_like(contiguous)
    local = idx.long() % page_rows
    fns = {"baseline": lambda: baseline_gather(base_lib, pages, idx, page_rows),
           "kernel": lambda: tg.gather_rows_paged(pages, idx, page_rows),
           "index_select": lambda: torch.index_select(pages[0], 0, local),
           "copy_": lambda: dst.copy_(contiguous)}
    order = list(fns)
    times = {name: [] for name in order}
    for t in range(TURNS):
        for name in (order if t % 2 == 0 else order[::-1]):
            times[name].append(median_ms(fns[name]))
    medians = {k: float(np.median(v)) for k, v in times.items()}
    result = {
        "card": card_line(), "device": torch.cuda.get_device_name(0),
        "rows": ROWS, "row_bytes": ROW_BYTES, "pages": num_pages,
        "bound_ms": copy_bound_ms(ROWS * ROW_BYTES), "order": order, "turns_ms": times,
        "median_ms": medians,
        "gbps": {k: 2 * ROWS * ROW_BYTES / (v * 1e-3) / 1e9 for k, v in medians.items()},
        "kernel_plan": tg.bulk_plan(ROW_BYTES, ROWS, tg._num_sms(dev.index)),
        "host_us_per_call": {name: host_us_per_call(fns[name])
                             for name in ("baseline", "kernel", "index_select")},
    }
    os.remove(base_path)
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
