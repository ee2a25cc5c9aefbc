"""The whole step's share of the card's bf16 peak: the CILRS's FLOPs of a
trained frame (``policies/cilrs.py:train_flops`` at the table's frame shape)
at the unprofiled window's rate over 989 TFLOP/s, in %."""


def read(rec):
    return rec.get("mfu_pct")
