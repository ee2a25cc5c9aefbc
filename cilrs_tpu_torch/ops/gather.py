"""Batch row-gather from a card-resident, paged frame table.

Port of ``cilrs_tpu/ops/gather.py``. The table of uint8 frames lives on the card
as a tuple of pages, each a 2-D ``[n_p, row_elems]`` tensor; global row ``g``
lives at ``pages[g // page_rows][g % page_rows]``. ``gather_rows_paged`` copies
the requested rows into a fresh ``[B, row_elems]`` tensor.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/gather_rows.cu`` (one launch for all pages) or raises; there is no
fallback. The kernel is a persistent grid of TMA bulk copies through a ring in
shared memory; its launch plan is computed here, by ``bulk_plan``, so that
the CPU tests can check it. On a CPU tensor the
wrapper runs ``gather_rows_plain``, the same routing in plain PyTorch, which is
what the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cilrs_tpu_torch.ops.build import load_library
from cilrs_tpu_torch.utils.profiling import kernel_launch

# The kernel's bulk copies move multiples of 16 bytes between 16-byte aligned
# addresses, so every row must start 16-byte aligned.
# (The TPU build padded rows to whole (sublane, 128-lane) tiles instead.)
ROW_ALIGN_BYTES = 16

# Per-page byte ceiling, kept from the TPU build so both packages page a table
# the same way (there it kept every gather operand under a 2^33-byte offset
# fault of the TPU compiler; the CUDA kernel uses 64-bit offsets throughout).
PAGE_BYTE_LIMIT = 2 ** 33


def padded_row_elems(d: int, dtype: torch.dtype) -> int:
    """Smallest row size >= d whose byte length is a multiple of 16."""
    unit = max(ROW_ALIGN_BYTES // torch.empty((), dtype=dtype).element_size(), 1)
    return d + ((-d) % unit)


def paged_layout(num_rows: int, row_bytes: int, slack_rows: int,
                 max_page_bytes: int = PAGE_BYTE_LIMIT):
    """(num_pages, page_rows, page_slots) for a table of ``num_rows`` logical
    rows where every page needs ``slack_rows`` physical slack (collection DUS
    overshoot) and must stay strictly under ``max_page_bytes``.

    Pages are balanced (equal physical size). Identical to the JAX package's.
    """
    max_slots = max_page_bytes // row_bytes  # slots * row_bytes could == limit
    if max_slots * row_bytes >= max_page_bytes:
        max_slots -= 1  # strictly under
    max_logical = max_slots - slack_rows
    if max_logical <= 0:
        raise ValueError(
            f"slack ({slack_rows} rows) leaves no room under the "
            f"{max_page_bytes}-byte page limit at {row_bytes} B/row")
    num_pages = -(-num_rows // max_logical)
    page_rows = -(-num_rows // num_pages)
    page_slots = page_rows + slack_rows
    assert page_slots * row_bytes < max_page_bytes
    return num_pages, page_rows, page_slots


def gather_rows_plain(pages, idx: torch.Tensor, page_rows: int) -> torch.Tensor:
    """The plain PyTorch version: the JAX package's routing, one gather per
    page and a select. ``pages`` are 2-D; out-of-range rows clamp within their
    page, and an index that maps to no page reads page 0, row 0."""
    idx = idx.long()
    if len(pages) == 1:
        return pages[0].index_select(0, idx.clamp(0, pages[0].shape[0] - 1))
    page = torch.div(idx, page_rows, rounding_mode="floor")
    local = idx - page * page_rows
    out = None
    for i, pg in enumerate(pages):
        sel = page == i
        g = pg.index_select(0, torch.where(sel, local, 0).clamp(0, pg.shape[0] - 1))
        out = g if out is None else torch.where(sel[:, None], g, out)
    return out


# The kernel's launch plan. The first four mirror csrc/gather_rows.cu's
# #defines (GATHER_MAX_SMEM, GATHER_BARRIER_BYTES, GATHER_MAX_STAGES,
# GATHER_STORE_DEPTH), which its launcher checks the plan against.
SMEM_MAX_BYTES = 232_448   # dynamic shared memory a block may opt in to on Hopper
BARRIER_BYTES = 128        # the stages' mbarriers, at the head of shared memory
MAX_STAGES = 16
STORE_DEPTH = 1            # bulk stores left in flight before a stage is reloaded
RING_BYTES = 212_992       # shared memory the ring of stages may take on one SM
CHUNK_BYTES_MAX = 17_600   # a third of a 52,800-B frame a stage, twelve stages


@functools.lru_cache(maxsize=64)
def bulk_plan(row_bytes: int, b: int, num_sms: int):
    """Launch plan of the gather kernel for ``b`` rows of ``row_bytes`` on a
    card of ``num_sms`` SMs: (chunk_bytes, chunks_per_row, stages, grid,
    smem_bytes).

    Each row is cut into ``chunks_per_row`` chunks of ``chunk_bytes`` (the last
    may be shorter), all multiples of 16 B as the bulk copy needs; the ring
    holds ``stages`` chunks, more than ``STORE_DEPTH`` so that a load stays
    in flight; ``grid`` persistent blocks, at most one an SM, share the
    ``b * chunks_per_row`` items round-robin: block j copies items j,
    j + grid, j + 2 grid, ..., and item k is chunk ``k % chunks_per_row`` of
    output row ``k // chunks_per_row``.
    """
    if row_bytes <= 0 or row_bytes % ROW_ALIGN_BYTES:
        raise ValueError(f"row of {row_bytes} B is not a positive multiple of {ROW_ALIGN_BYTES} B")
    fewest = -(-row_bytes // CHUNK_BYTES_MAX)  # chunks a row needs to fit a stage
    chunk_bytes = -(-row_bytes // (fewest * 16)) * 16  # an even split, rounded up to 16 B
    chunks_per_row = -(-row_bytes // chunk_bytes)
    stages = min(MAX_STAGES, RING_BYTES // chunk_bytes)
    grid = min(num_sms, b * chunks_per_row)
    return chunk_bytes, chunks_per_row, stages, grid, BARRIER_BYTES + stages * chunk_bytes


# gather_rows_launch(page_ptrs, page_phys_rows, num_pages, page_rows, idx, b,
# out, row_bytes, chunk_bytes, chunks_per_row, stages, grid, smem_bytes,
# device, stream)
LAUNCH_ARGTYPES = [
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _library():
    lib = load_library("gather_rows")
    lib.gather_rows_launch.argtypes = LAUNCH_ARGTYPES
    lib.gather_rows_launch.restype = ctypes.c_int
    lib.gather_rows_max_pages.argtypes = []
    lib.gather_rows_max_pages.restype = ctypes.c_int
    lib.gather_rows_error_string.argtypes = [ctypes.c_int]
    lib.gather_rows_error_string.restype = ctypes.c_char_p
    return lib, lib.gather_rows_max_pages()


@functools.lru_cache(maxsize=16)
def _page_table(ptrs: tuple, rows: tuple):
    """The launcher's ctypes arrays of page pointers and physical rows, reused
    while the pages' pointers and row counts are the same (keyed by value)."""
    for ptr, n in zip(ptrs, rows):
        if ptr % ROW_ALIGN_BYTES or n == 0:
            raise ValueError("every page must be non-empty and 16-byte aligned")
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(rows))(*rows)


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _gather_rows_cuda(pages, idx: torch.Tensor, page_rows: int) -> torch.Tensor:
    lib, max_pages = _library()
    dev = pages[0].device
    row_bytes = pages[0].shape[1] * pages[0].element_size()
    if row_bytes % ROW_ALIGN_BYTES:
        raise ValueError(f"row of {row_bytes} B is not a multiple of "
                         f"{ROW_ALIGN_BYTES} B; pad rows to padded_row_elems")
    if len(pages) > max_pages:
        raise ValueError(f"{len(pages)} pages; the kernel takes at most {max_pages}")
    ptrs, rows = _page_table(tuple(pg.data_ptr() for pg in pages),
                             tuple(pg.shape[0] for pg in pages))
    b = idx.shape[0]
    out = torch.empty((b, pages[0].shape[1]), dtype=pages[0].dtype, device=dev)
    chunk_bytes, chunks_per_row, stages, grid, smem_bytes = bulk_plan(
        row_bytes, b, _num_sms(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with kernel_launch("gather_rows"):
        status = lib.gather_rows_launch(
            ptrs, rows, len(pages), page_rows, idx.data_ptr(), b, out.data_ptr(), row_bytes,
            chunk_bytes, chunks_per_row, stages, grid, smem_bytes, dev.index, stream)
    if status != 0:
        raise RuntimeError("gather_rows kernel launch failed: "
                           + lib.gather_rows_error_string(status).decode())
    if b:
        gather_rows_paged.launches += 1
    return out


def gather_rows_paged(pages, idx: torch.Tensor, page_rows: int) -> torch.Tensor:
    """Gather global rows ``idx`` [B] from a paged table -> [B, row_elems].

    ``pages`` is a sequence of [n_p, ...] tensors of one dtype and row size on
    one device; non-final pages hold ``page_rows`` logical rows. CUDA tensors go
    through the kernel (one launch for every page), CPU tensors through
    ``gather_rows_plain``. The launch is on the current stream and does not
    synchronise.
    """
    pages = tuple(pg if pg.dim() == 2 else pg.reshape(pg.shape[0], -1) for pg in pages)
    if not pages:
        raise ValueError("no pages")
    dev, dtype, width = pages[0].device, pages[0].dtype, pages[0].shape[1]
    for pg in pages:
        if pg.device != dev or pg.dtype != dtype or pg.shape[1] != width:
            raise ValueError("pages differ in device, dtype or row size")
        if not pg.is_contiguous():
            raise ValueError("pages must be contiguous")
    if idx.ndim != 1 or idx.device != dev:
        raise ValueError(f"idx must be 1-D on {dev}, got {tuple(idx.shape)} on {idx.device}")
    idx = idx.to(torch.int32).contiguous()
    if dev.type == "cpu":
        return gather_rows_plain(pages, idx, page_rows)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows runs on CUDA or CPU tensors, not {dev.type}")
    return _gather_rows_cuda(pages, idx, page_rows)


gather_rows_paged.launches = 0  # kernel launches, for showing a path ran on it


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows ``idx`` [B] of one table [N, ...] -> [B, row_elems]; indices
    clamp to [0, N-1]."""
    return gather_rows_paged((table,), idx, table.shape[0])
