"""The whole step's share of the card's bf16 peak: the CILRS's FLOPs
(``counts.py``) at the unprofiled window's rate over 989 TFLOP/s, in %."""


def read(rec):
    return rec.get("mfu_pct")
