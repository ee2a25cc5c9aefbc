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
On-card collection comes with the collection slice.
"""

from __future__ import annotations

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.data.dataset import DriveDataset
from cilrs_tpu_torch.ops.gather import (PAGE_BYTE_LIMIT, gather_rows_paged, padded_row_elems,
                                        paged_layout)

SHIP_CHUNK_ROWS = 16384  # bounds the host fancy-index temp (~865 MB of 88x200 frames)
LABEL_KEYS = ("speed", "command", "controls")


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
