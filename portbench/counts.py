"""Bytes the cells' work needs, from the shapes alone, and the data sheet's
peaks of one H100 SXM (dense rates, at its 700 W limit).

A policy's FLOPs are its architecture's (``policies/<arch>.py:forward_flops``
and ``train_flops``), counted as ``torch.utils.flop_counter`` counts them: two
per multiply-add of every convolution and matrix product, nothing for norms,
activations, pools or sums (``tests/test_pb_counts.py`` holds each count to
the flop counter on the reference model).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FRAME_SHAPE = (88, 200, 3)
ROW_BYTES = 88 * 200 * 3  # 52,800: a u8 frame, already 16-byte aligned


def gather_bytes(rows: int, row_bytes: int = ROW_BYTES) -> int:
    """Bytes the row gather must move: each row read once and written once."""
    return 2 * rows * row_bytes


# Bytes each sin hash must move an element: its float32 inputs read once and
# its float32 output written once (the rain columns and the reverse steer read
# one float, the grain a point of two).
HASH_BYTES_PER_ELEMENT = {"hash01": 8, "grain_texture": 12, "reverse_steer": 8}


def hash_bytes(calls: list[tuple[str, int]]) -> int:
    """Bytes of sin-hash calls given as (entry point, elements)."""
    return sum(HASH_BYTES_PER_ELEMENT[name] * n for name, n in calls)


def least_ms(nbytes: int = 0, flops: int = 0, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time for the work: the larger of bytes at the HBM rate and
    operations at the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops) * 1e3
