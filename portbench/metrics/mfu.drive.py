"""The whole tick's share of the card's bf16 peak: the policy's forward FLOPs
a frame (``policies/<arch>.py:forward_flops`` at the configuration's widths
and camera) at the unprofiled window's rate over 989 TFLOP/s, in %."""


def read(rec):
    return rec.get("mfu_pct")
