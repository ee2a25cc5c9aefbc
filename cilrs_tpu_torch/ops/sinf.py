"""glibc's float ``sin``, bit for bit, and the simulator's sin hashes built on it.

The JAX package hashes with ``jnp.sin`` in float32: the rain streaks' phase
and on/off (``render/weather.py:_hash01``), the ground grain
(``render/raster.py:_hash2``, two cell sizes summed) and the recovery
machine's reverse steer (``agent/driver.py``). Each multiplies sin by about
4.4e4 and keeps the fraction, with arguments up to about 1e5, so one ulp of
sin moves the hash by up to its whole range. Jitted on XLA:CPU, ``jnp.sin`` in
float32 is glibc's ``sinf``, which is not correctly rounded; neither is CUDA's
``sinf``, and the two differ. So the port computes glibc's algorithm itself.

The entry points, each one kernel launch on a CUDA tensor (or a raise; there
is no fallback), its plain version on a CPU tensor, and a count of launches
(``fn.launches``):
 - ``hash_sinf(x, a, y)``: ``sinf(fl32(x * a + y))``, the bare sin;
 - ``hash01(x, a, b, scale)``: ``h = fl32(sinf(fl32(x * a + b)) * scale)``,
   ``h - floor(h)`` (the rain columns);
 - ``grain_texture(sxy)``: the two-scale ground grain of points [..., 2];
 - ``reverse_steer(rec_start)``: the recovery's reverse steer.
The plain versions are the call sites' torch expressions over
``hash_sinf``; on a CUDA tensor they run the bare kernel and the torch
epilogue, which ``chip_smoke.py`` times beside the fused kernels.

Arguments are rounded as XLA rounds them under jit, where it contracts
``x * a + y`` into a fused multiply-add: x * a is exact in float64 (both are
float32), and the float64 sum is exact too while the sum's bits span at most
53, as they do for every hash here (integer cells and constants, magnitudes
under 2^24); rounded once to float32 it is then the FMA's result
(``hash_argument``). The grain's sum of its two scales is contracted so too.

``sinf`` is ARM's optimized-routines ``sinf``, which glibc has built since
2.28 (``sysdeps/ieee754/flt-32/s_sinf.c``, ``sincosf.h``,
``sincosf_data.c``), as x86-64 builds it (no ``TOINT_INTRINSICS``): every
product and sum in float64, each rounded (no FMA), and one rounding to float32
at the end. Three ranges, chosen on the top 12 bits of |x|'s pattern:
 - |x| < 0.75 (below pi/4 in those bits): the polynomial on x; x itself below
   2^-12;
 - |x| < 120: n = round(x * 2/pi) from a 2^24-scaled product truncated to
   int32, x - n * pi/2;
 - otherwise: the product of the float's 24-bit mantissa with 96 bits of 2/pi
   in 64-bit integers, the top two bits of the fraction giving n.
Then an odd polynomial for sin (n even) or an even one for cos (n odd), with
the quadrant's sign. ``sinf_plain`` is that arithmetic in float64 and int64
torch ops, one op per product and per sum; ``csrc/hash_sinf.cu`` the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cilrs_tpu_torch.ops.build import load_library
from cilrs_tpu_torch.utils.profiling import kernel_launch

# Table 0 of glibc's __sincosf_table. Table 1 (used when the quadrant has bit
# 1 set) negates C0-C4 and keeps the rest.
HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2/pi * 2^24
HPI = float.fromhex("0x1.921fb54442d18p+0")  # pi/2
C0 = 1.0
C1 = float.fromhex("-0x1.ffffffd0c621cp-2")
S1 = float.fromhex("-0x1.555545995a603p-3")
C2 = float.fromhex("0x1.55553e1068f19p-5")
S2 = float.fromhex("0x1.1107605230bc4p-7")
C3 = float.fromhex("-0x1.6c087e89a359dp-10")
S3 = float.fromhex("-0x1.994eb3774cf24p-13")
C4 = float.fromhex("0x1.99343027bf8c3p-16")
PI63 = float.fromhex("0x1.921fb54442d18p-62")  # pi * 2^-62

# Top 12 bits (sign off) of 0.75 (glibc compares |x| with pi/4 on these bits
# only), 2^-12, 120 and infinity.
TOP12_PIO4, TOP12_TINY, TOP12_120, TOP12_INF = 0x3F4, 0x398, 0x42F, 0x7F8

# glibc's __inv_pio4: entry i is floor(2/pi * 2^(8 i + 8)) mod 2^32, 32 bits
# of 2/pi's fraction (0x0.a2f9836e4e441529fc2757d1f534ddc0db6295993c439041)
# a byte further along each entry.
INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd,
    0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43,
    0x993c4390, 0x3c439041)

_M32 = 0xFFFFFFFF

# The hashes' constants, as the JAX package writes them (render/weather.py:73,
# render/raster.py:246-252 and :402, agent/driver.py:273-274).
HASH_A, HASH_C, HASH_SCALE = 12.9898, 78.233, 43758.5453
GRAIN_CELLS = (1.7, 0.45)  # coarse, fine
GRAIN_WEIGHTS, GRAIN_BIAS = (0.6, 0.4), 0.5
STEER_A, STEER_SCALE, STEER_OFFSET, STEER_GAIN = 12.99, 43758.5, 0.5, 0.6


def sinf_plain(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf`` of a float32 tensor, in plain torch ops: every branch
    for every element, then a select. Products and sums are separate float64
    ops (nothing fuses them), integers int64 and masked to their C widths."""
    bits = x.view(torch.int32).long() & _M32
    top = (bits >> 20) & 0x7FF
    sign = bits >> 31
    xd = x.double()
    small = top < TOP12_PIO4
    fast = top < TOP12_120

    # |x| < 120: n = ((int32)(x * hpi_inv) + 2^23) >> 24, an arithmetic shift.
    xf = torch.where(fast, xd, 0.0)
    n_fast = ((xf * HPI_INV).long() + 0x800000) >> 24
    r_fast = xf - n_fast.double() * HPI

    # Larger: reduce_large. The three products fit in 63 bits (m < 2^31); the
    # 64-bit res0 = lo32(p0) << 32 | p2 >> 32, plus p1, wraps modulo 2^64 and
    # is kept as two 32-bit halves.
    table = torch.tensor(INV_PIO4, dtype=torch.int64, device=x.device)
    i = (bits >> 26) & 15
    m = ((bits & 0xFFFFFF) | 0x800000) << ((bits >> 23) & 7)
    p0, p1, p2 = m * table[i], m * table[i + 4], m * table[i + 8]
    lo = (p2 >> 32) + (p1 & _M32)
    hi = ((p0 & _M32) + (p1 >> 32) + (lo >> 32)) & _M32
    lo = lo & _M32
    n_large = ((hi + (1 << 29)) & _M32) >> 30  # (res0 + 2^61) >> 62
    hi = (hi - (n_large << 30)) & _M32  # res0 -= n << 62
    hi = hi - ((hi >> 31) << 32)  # (int64_t)res0's top half, signed
    r_large = (hi.double() * 2.0 ** 32 + lo.double()) * PI63  # one rounding to double

    n = torch.where(small, 0, torch.where(fast, n_fast, n_large))
    quadrant = torch.where(small, 0, torch.where(fast, n_fast, n_large + sign))
    r = torch.where(small, xd, torch.where(fast, r_fast, r_large))
    flip = ((quadrant & 3) == 1) | ((quadrant & 3) == 2)  # __sincosf_table's sign
    xp = torch.where(flip, -r, r)
    x2 = r * r

    # sinf_poly, in glibc's order of operations.
    x3 = xp * x2
    s1 = x2 * S3 + S2
    x7 = x3 * x2
    even = (x3 * S1 + xp) + x7 * s1
    x4 = x2 * x2
    c2 = x2 * C4 + C3
    c1 = x2 * C1 + C0
    x6 = x4 * x2
    odd = (x4 * C2 + c1) + x6 * c2
    # Table 1 negates C0-C4; every step of the cos polynomial is symmetric in
    # their sign, so its result with table 1 is the negation of table 0's.
    odd = torch.where((quadrant & 2) != 0, -odd, odd)
    out = torch.where((n & 1) != 0, odd, even).float()
    out = torch.where(top < TOP12_TINY, x, out)
    return torch.where(top < TOP12_INF, out, float("nan"))


def hash_argument(x: torch.Tensor, a: float, y: torch.Tensor | float | None) -> torch.Tensor:
    """fl32(x * a + y), rounded once as the fused multiply-add rounds it (see
    the module's docstring for when that holds); fl32(x * a) without y."""
    a32 = torch.tensor(a, dtype=torch.float32).item()
    if y is None:
        return x * a32
    yd = y.double() if isinstance(y, torch.Tensor) else torch.tensor(y, dtype=torch.float32).item()
    return (x.double() * a32 + yd).float()


def hash_sinf_plain(x: torch.Tensor, a: float,
                    y: torch.Tensor | float | None = None) -> torch.Tensor:
    """The plain version of ``hash_sinf``."""
    return sinf_plain(hash_argument(x, a, y))


def hash01_plain(x: torch.Tensor, a: float, b: float, scale: float) -> torch.Tensor:
    """The plain version of ``hash01``: the rain hash's torch expression."""
    h = hash_sinf(x, a, b) * scale
    return h - torch.floor(h)


def cell_reciprocal(cell: float) -> float:
    """The float32 reciprocal of a grain cell size: XLA's jit computes
    ``p / cell`` as ``p * (1 / cell)``, and a cell one rounding apart hashes
    to another value."""
    return float(np.float32(1.0) / np.float32(cell))


def grain_hash(p: torch.Tensor, cell: float) -> torch.Tensor:
    """The grain's value noise in [0, 1) at one cell size, of points p [..., 2]:
    a hash of the point quantized to cells (``cell_reciprocal``)."""
    q = torch.floor(p * cell_reciprocal(cell))
    v = hash_sinf(q[..., 0], HASH_A, q[..., 1] * HASH_C) * HASH_SCALE
    return v - torch.floor(v)


def grain_texture_plain(sxy: torch.Tensor) -> torch.Tensor:
    """The plain version of ``grain_texture``: 0.6 * coarse + 0.4 * fine - 0.5,
    the sum rounded once as XLA contracts it into a fused multiply-add."""
    (coarse, fine), (w_coarse, w_fine) = GRAIN_CELLS, GRAIN_WEIGHTS
    return hash_argument(grain_hash(sxy, coarse), w_coarse, w_fine * grain_hash(sxy, fine)) \
        - GRAIN_BIAS


def reverse_steer_plain(rec_start: torch.Tensor) -> torch.Tensor:
    """The plain version of ``reverse_steer``: the recovery's torch expression."""
    rseed = hash_sinf(rec_start, STEER_A) * STEER_SCALE
    return ((rseed - torch.floor(rseed)) - STEER_OFFSET) * STEER_GAIN


# hash_sinf_launch(x, x_stride, y, y_stride, y_mode, a, b, out, n, device, stream)
LAUNCH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p]
Y_NONE, Y_SCALAR, Y_TENSOR = 0, 1, 2  # the kernel's y_mode
# hash_mode_launch(mode, in, out, n, k[8], device, stream)
MODE_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
MODE_HASH01, MODE_GRAIN, MODE_STEER = 0, 1, 2  # the kernel's Mode


@functools.cache
def _library():
    lib = load_library("hash_sinf")
    lib.hash_sinf_launch.argtypes = LAUNCH_ARGTYPES
    lib.hash_sinf_launch.restype = ctypes.c_int
    lib.hash_mode_launch.argtypes = MODE_ARGTYPES
    lib.hash_mode_launch.restype = ctypes.c_int
    lib.hash_sinf_error_string.argtypes = [ctypes.c_int]
    lib.hash_sinf_error_string.restype = ctypes.c_char_p
    return lib


def _check_status(lib, status: int, name: str):
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.hash_sinf_error_string(status).decode())


def flat_stride(t: torch.Tensor) -> int | None:
    """The one stride that walks ``t``'s elements in order, or None: a
    contiguous tensor has 1, a column ``q[..., 0]`` of a contiguous [..., 2]
    tensor has 2."""
    step = None
    for size, stride in zip(reversed(t.shape), reversed(t.stride())):
        if size == 1:
            continue
        if step is None:
            step, span = stride, size * stride
        elif stride != span:
            return None
        else:
            span *= size
    return 1 if step is None else step


def _hash_sinf_cuda(x: torch.Tensor, a: float, y) -> torch.Tensor:
    lib = _library()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    sx = flat_stride(x)
    if sx is None:
        x = x.contiguous()
        sx = 1
    y_ptr, sy, b, mode = None, 0, 0.0, Y_NONE
    if isinstance(y, torch.Tensor):
        sy = flat_stride(y)
        if sy is None:
            y = y.contiguous()
            sy = 1
        y_ptr, mode = y.data_ptr(), Y_TENSOR
    elif y is not None:
        b, mode = float(y), Y_SCALAR
    dev = x.device
    with kernel_launch("hash_sinf"):
        status = lib.hash_sinf_launch(x.data_ptr(), sx, y_ptr, sy, mode, a, b, out.data_ptr(), n,
                                      dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _check_status(lib, status, "hash_sinf")
    hash_sinf.launches += 1
    return out


def _check_input(name: str, t: torch.Tensor):
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: the input must be float32, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {t.device.type}")


def hash_sinf(x: torch.Tensor, a: float, y: torch.Tensor | float | None = None) -> torch.Tensor:
    """glibc's ``sinf(fl32(x * a + y))`` of float32 ``x`` (any shape) and
    ``y`` (a float, None, or a float32 tensor of ``x``'s shape on its device)
    -> float32 of ``x``'s shape, bit for bit what jitted ``jnp.sin`` of
    ``x * a + y`` gives on XLA:CPU. CUDA tensors go through the kernel (one
    launch, on the current stream; x and y are read at a stride where one
    walks them), CPU tensors through ``hash_sinf_plain``."""
    _check_input("hash_sinf", x)
    if isinstance(y, torch.Tensor) and (
            y.dtype != torch.float32 or y.shape != x.shape or y.device != x.device):
        raise ValueError(f"y must be float32 of shape {tuple(x.shape)} on {x.device}, got "
                         f"{y.dtype} {tuple(y.shape)} on {y.device}")
    if x.device.type == "cpu":
        return hash_sinf_plain(x, a, y)
    return _hash_sinf_cuda(x, a, y)


def _mode_cuda(fn, mode: int, inp: torch.Tensor, shape, consts) -> torch.Tensor:
    """One launch of the kernel's ``mode`` over the contiguous ``inp`` into a
    new float32 tensor of ``shape``, counted on ``fn``."""
    if not inp.is_contiguous():
        raise ValueError(f"{fn.__name__} takes a contiguous tensor on the card, got strides "
                         f"{inp.stride()} for shape {tuple(inp.shape)}")
    lib = _library()
    out = torch.empty(shape, dtype=torch.float32, device=inp.device)
    n = out.numel()
    if n == 0:
        return out
    k = (ctypes.c_float * 8)(*consts, *([0.0] * (8 - len(consts))))
    dev = inp.device
    with kernel_launch(fn.__name__):
        status = lib.hash_mode_launch(mode, inp.data_ptr(), out.data_ptr(), n, k, dev.index,
                                      torch.cuda.current_stream(dev).cuda_stream)
    _check_status(lib, status, fn.__name__)
    fn.launches += 1
    return out


def hash01(x: torch.Tensor, a: float, b: float, scale: float) -> torch.Tensor:
    """``h = fl32(sinf(fl32(x * a + b)) * scale)``, ``h - floor(h)``: a hash of
    float32 ``x`` (any shape) in [0, 1), bit for bit the JAX package's
    ``sin(x * a + b) * scale`` fraction jitted on XLA:CPU. One launch on a
    CUDA tensor (contiguous), ``hash01_plain`` on a CPU tensor."""
    _check_input("hash01", x)
    if x.device.type == "cpu":
        return hash01_plain(x, a, b, scale)
    return _mode_cuda(hash01, MODE_HASH01, x, x.shape, (a, b, scale))


def grain_texture(sxy: torch.Tensor) -> torch.Tensor:
    """The ground grain of world points ``sxy`` [..., 2] (float32) -> [...]:
    ``0.6 * grain_hash(sxy, 1.7) + 0.4 * grain_hash(sxy, 0.45) - 0.5``, the
    sum contracted as XLA contracts it, bit for bit the JAX renderer's
    ``tex``. One launch on a CUDA tensor (contiguous), ``grain_texture_plain``
    on a CPU tensor."""
    _check_input("grain_texture", sxy)
    if sxy.dim() < 1 or sxy.shape[-1] != 2:
        raise ValueError(f"grain_texture takes points [..., 2], got shape {tuple(sxy.shape)}")
    if sxy.device.type == "cpu":
        return grain_texture_plain(sxy)
    return _mode_cuda(grain_texture, MODE_GRAIN, sxy, sxy.shape[:-1], _GRAIN_CONSTS)


def reverse_steer(rec_start: torch.Tensor) -> torch.Tensor:
    """The recovery's pseudo-random reverse steer in [-0.3, 0.3), stable per
    episode: a sin hash of its start time (float32, any shape), bit for bit
    the JAX driver's. A float32 sin one ulp off wraps the fraction on 3% of
    starts and reverses with the opposite steer. One launch on a CUDA tensor
    (contiguous), ``reverse_steer_plain`` on a CPU tensor."""
    _check_input("reverse_steer", rec_start)
    if rec_start.device.type == "cpu":
        return reverse_steer_plain(rec_start)
    return _mode_cuda(reverse_steer, MODE_STEER, rec_start, rec_start.shape,
                      (STEER_A, STEER_SCALE, STEER_OFFSET, STEER_GAIN))


# The grain mode's constants, in the kernel's order.
_GRAIN_CONSTS = (HASH_A, HASH_C, HASH_SCALE, *map(cell_reciprocal, GRAIN_CELLS), *GRAIN_WEIGHTS,
                 GRAIN_BIAS)
# Kernel launches, for showing a path ran on them.
hash_sinf.launches = hash01.launches = grain_texture.launches = reverse_steer.launches = 0
SIN_HASHES = (hash_sinf, hash01, grain_texture, reverse_steer)
