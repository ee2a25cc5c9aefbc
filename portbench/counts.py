"""Operations and bytes the cells' work needs, from the shapes alone, and the
data sheet's peaks of one H100 SXM (dense rates, at its 700 W limit).

A FLOP count is that of ``torch.utils.flop_counter``: two per multiply-add of
every convolution and matrix product, nothing for norms, activations, pools
or sums (``tests/test_pb_counts.py`` holds the counts to the flop counter on
the reference model).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FRAME_SHAPE = (88, 200, 3)
ROW_BYTES = 88 * 200 * 3  # 52,800: a u8 frame, already 16-byte aligned


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def cilrs_layers(h: int = 88, w: int = 200, stage_sizes=(3, 4, 6, 3),
                 stage_features=(64, 128, 256, 512), num_commands: int = 4,
                 speed_dim: int = 128, branch: int = 256) -> list[tuple[str, int]]:
    """(layer, forward FLOPs of one frame) of every convolution and linear
    layer of the CILRS model, in the order the forward runs them."""
    out = []

    def conv(name, cin, cout, k, s, p, hw):
        ho, wo = _conv_out(hw[0], k, s, p), _conv_out(hw[1], k, s, p)
        out.append((name, 2 * cin * cout * k * k * ho * wo))
        return ho, wo

    hw = conv("conv1", 3, 64, 7, 2, 3, (h, w))
    hw = (_conv_out(hw[0], 3, 2, 1), _conv_out(hw[1], 3, 2, 1))  # max pool
    cin = 64
    for stage, (blocks, feats) in enumerate(zip(stage_sizes, stage_features)):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            if stride != 1 or cin != feats:
                conv(f"layer{stage + 1}.{b}.downsample", cin, feats, 1, stride, 0, hw)
            hw_in = hw
            hw = conv(f"layer{stage + 1}.{b}.conv1", cin, feats, 3, stride, 1, hw_in)
            conv(f"layer{stage + 1}.{b}.conv2", feats, feats, 3, 1, 1, hw)
            cin = feats

    def linear(name, i, o):
        out.append((name, 2 * i * o))

    visual = stage_features[-1]
    linear("speed_encoder.0", 1, speed_dim)
    linear("speed_encoder.3", speed_dim, speed_dim)
    linear("speed_predictor.0", visual, branch)
    linear("speed_predictor.3", branch, branch)
    linear("speed_predictor.5", branch, 1)
    for c in range(num_commands):  # every branch runs; the command selects after
        linear(f"control_branches.{c}.0", visual + speed_dim, branch)
        linear(f"control_branches.{c}.3", branch, branch)
        linear(f"control_branches.{c}.6", branch, 3)
    return out


def cilrs_forward_flops(**shape) -> int:
    """Forward FLOPs of one frame (2,798,183,168 at the published widths and 88x200)."""
    return sum(f for _, f in cilrs_layers(**shape))


def cilrs_train_flops(**shape) -> int:
    """Forward and backward FLOPs of one trained frame: the backward takes the
    gradient of every layer's weights and of every layer's input but the
    image's (``conv1``) and the speed's (``speed_encoder.0``), which need none
    (8,311,758,848 at the published widths)."""
    layers = dict(cilrs_layers(**shape))
    fwd = sum(layers.values())
    return 3 * fwd - layers["conv1"] - layers["speed_encoder.0"]


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
