"""The renderer's kernels on the card (``csrc/render.cu``): one launch each,
on the current stream, outputs allocated here.

``render/raster.py:render_frame`` composes them on CUDA tensors, around the
sin hashes of ``ops/sinf.py``; on CPU tensors it runs its torch composition,
which is these kernels' plain version. Each entry point counts its launches
(``fn.launches``) and launches in a profiler operation ``kernel::<name>``
(``ops/build.py:launch``), so a profiler links its kernel to the ranges
around it:
 - ``render_prep``: the scene record of every env (camera, nearest segments,
   boxes, walkers, lights, weather) and the blur's speeds;
 - ``render_points``: the motion-stretched ground points that
   ``grain_texture`` hashes and the rain columns that ``hash01`` hashes;
 - ``render_shade``: the frame before the blur;
 - ``render_blur``: ``motion_blur``.
The library says how it lays out what it takes: ``render_layout``, the
sizes of a scene record's parts; ``render_const_field`` and
``render_dim_name``, the names (and floats) of the renderer's constants
(``render/raster.py:kernel_consts`` gives their values) and of the sizes and
switches, in the order the kernels take them. ``bind`` reads these into
``lib.layout`` when the library loads. The same source builds for the host in
the CPU tests (``tests/render_host_emulation.h``), which take CPU tensors
through these functions; on the card they take CUDA tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cilrs_tpu_torch.ops.build import Kernel, bind_launchers, launch, load_library

# PrepInputs, in the source's order: (name, dtype).
PREP_INPUTS = (
    ("veh_pos", torch.float32), ("veh_yaw", torch.float32), ("veh_speed", torch.float32),
    ("veh_alive", torch.bool), ("veh_control", torch.float32), ("veh_reverse", torch.bool),
    ("ped_pos", torch.float32), ("ped_alive", torch.bool), ("time_s", torch.float32),
    ("weather_idx", torch.int64), ("wp_xy", torch.float32), ("wp_next", torch.int64),
    ("wp_is_junction", torch.bool), ("bldg_xy", torch.float32), ("bldg_yaw", torch.float32),
    ("bldg_half", torch.float32), ("bldg_h", torch.float32), ("light_xy", torch.float32),
    ("light_yaw", torch.float32), ("light_state", torch.int64))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
_DIMS_T = ctypes.POINTER(ctypes.c_int)
ARGTYPES = {
    # render_prep_launch(in[], dims, k, records, speed_kmh, device, stream)
    "render_prep_launch": [ctypes.POINTER(_P), _DIMS_T, _F, _P, _P, _I, _P],
    # render_points_launch(records, dims, k, sxy, cols, cols_t, device, stream)
    "render_points_launch": [_P, _DIMS_T, _F, _P, _P, _P, _I, _P],
    # render_shade_launch(records, tex, phase, streak_hash, dims, k, img, device, stream)
    "render_shade_launch": [_P, _P, _P, _P, _DIMS_T, _F, _P, _I, _P],
    # render_blur_launch(img, speed_kmh, taps, E, H, W, k, out, device, stream)
    "render_blur_launch": [_P, _P, _P, _I, _I, _I, _F, _P, _I, _P],
    "render_layout": [_DIMS_T],
    "render_const_field": [_I, ctypes.POINTER(ctypes.c_char_p)],
}


@dataclasses.dataclass(frozen=True)
class Layout:
    """What the library takes, as it reports it: the constants (name,
    floats) and the dims' names in its order, the count of prep inputs, the
    floats of a scene record's parts and the most of each nearest set."""
    consts: tuple
    dims: tuple
    prep_inputs: int
    header_floats: int
    seg_floats: int
    box_floats: int
    ped_floats: int
    light_floats: int
    max_nearest: int


def read_layout(lib: ctypes.CDLL) -> Layout:
    """The library's ``Layout``, checked against its own sizes and against
    ``PREP_INPUTS``."""
    out = (ctypes.c_int * 9)()
    n = lib.render_layout(out)
    consts, name = [], ctypes.c_char_p()
    while (floats := lib.render_const_field(len(consts), ctypes.byref(name))) > 0:
        consts.append((name.value.decode(), floats))
    dims = tuple(lib.render_dim_name(i).decode() for i in range(out[1]))
    layout = Layout(tuple(consts), dims, *out[2:n])
    if sum(f for _, f in layout.consts) != out[0]:
        raise RuntimeError(f"the render library's constants {layout.consts} do not fill its "
                           f"{out[0]} floats")
    if layout.prep_inputs != len(PREP_INPUTS):
        raise RuntimeError(f"the render library takes {layout.prep_inputs} prep inputs, this "
                           f"wrapper passes {len(PREP_INPUTS)}")
    return layout


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the library's C interface on ``lib`` and reads its layout
    (``lib.layout``)."""
    bind_launchers(lib, "render", ARGTYPES)
    lib.render_dim_name.argtypes, lib.render_dim_name.restype = [ctypes.c_int], ctypes.c_char_p
    lib.layout = read_layout(lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(load_library("render"))


def pack_consts(values: dict) -> ctypes.Array:
    """The constants as the kernels take them: ``values`` {name: number or
    nested tuple of numbers} flattened in the library's order, each rounded
    to float32 as PyTorch rounds a Python number in a float32 op."""
    fields = _library().layout.consts
    if set(values) != {name for name, _ in fields}:
        raise ValueError(f"constants {sorted(values)}, the render kernels take "
                         f"{sorted(name for name, _ in fields)}")
    flat = []
    for name, size in fields:
        row = list(_flatten(values[name]))
        if len(row) != size:
            raise ValueError(f"constant {name} has {len(row)} values, the kernels take {size}")
        flat += row
    return (ctypes.c_float * len(flat))(*flat)


def _flatten(v):
    if isinstance(v, (tuple, list)):
        for x in v:
            yield from _flatten(x)
    else:
        yield float(v)


def record_floats(segments: int, boxes: int, walkers: int, lights: int) -> int:
    """Floats of an env's scene record, padded to 16 bytes."""
    lay = _library().layout
    n = (lay.header_floats + segments * lay.seg_floats + boxes * lay.box_floats
         + walkers * lay.ped_floats + lights * lay.light_floats)
    return -(-n // 4) * 4


def _float_input(name: str, t: torch.Tensor, shape: tuple, device=None) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or (device and t.device != device):
        raise ValueError(f"{name} must be float32 of shape {shape} on {device or t.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _dims_array(dims: dict) -> ctypes.Array:
    names = _library().layout.dims
    if set(dims) != set(names):
        raise ValueError(f"dims {sorted(dims)}, the render kernels take {sorted(names)}")
    return (ctypes.c_int * len(names))(*(int(dims[k]) for k in names))


_PREP, _POINTS, _SHADE, _BLUR = map(
    Kernel, ("render_prep", "render_points", "render_shade", "render_blur"))


@_PREP
def render_prep(inputs: dict, dims: dict, consts: ctypes.Array) -> tuple:
    """The scene records [E, record] and the blur's speeds in km/h [E] of the
    world and network tensors ``inputs`` (``PREP_INPUTS``, on one device)."""
    lib = _library()
    most = lib.layout.max_nearest
    if max(dims["segments"], dims["near_buildings"], dims["near_lights"]) > most:
        raise ValueError(f"render_prep selects at most {most} nearest of a kind")
    E, device = dims["envs"], inputs["veh_pos"].device
    if tuple(inputs["light_state"].shape) != (E, dims["lights"]):
        raise ValueError(f"render_prep: light_state must be [{E}, {dims['lights']}], got "
                         f"{tuple(inputs['light_state'].shape)}")
    tensors = []
    for name, dtype in PREP_INPUTS:
        t = inputs[name]
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"render_prep: {name} must be {dtype} on {device}, got {t.dtype} "
                             f"on {t.device}")
        tensors.append(t.contiguous())
    ref = tensors[0]
    records = torch.empty((E, dims["record"]), dtype=torch.float32, device=ref.device)
    speed_kmh = torch.empty(E, dtype=torch.float32, device=ref.device)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    launch(_PREP, lib, lib.render_prep_launch, ref, ptrs, _dims_array(dims), consts,
           records.data_ptr(), speed_kmh.data_ptr())
    return records, speed_kmh


@_POINTS
def render_points(records: torch.Tensor, dims: dict, consts: ctypes.Array) -> tuple:
    """The motion-stretched ground points [E, N, 2] and the rain columns,
    [H, W] and [E, H, W] with each env's time step added."""
    lib = _library()
    E, H, W = dims["envs"], dims["height"], dims["width"]
    records = _float_input("records", records, (E, dims["record"]))
    opts = dict(dtype=torch.float32, device=records.device)
    sxy = torch.empty((E, H * W, 2), **opts)
    cols, cols_t = torch.empty((H, W), **opts), torch.empty((E, H, W), **opts)
    launch(_POINTS, lib, lib.render_points_launch, records, records.data_ptr(),
           _dims_array(dims), consts, sxy.data_ptr(), cols.data_ptr(), cols_t.data_ptr())
    return sxy, cols, cols_t


@_SHADE
def render_shade(records: torch.Tensor, tex: torch.Tensor, phase: torch.Tensor,
                 streak_hash: torch.Tensor, dims: dict, consts: ctypes.Array) -> torch.Tensor:
    """The frame before the blur [E, H, W, 3] from the records, the ground
    grain [E, N] and the rain hashes [H, W] and [E, H, W]."""
    lib = _library()
    E, H, W = dims["envs"], dims["height"], dims["width"]
    records = _float_input("records", records, (E, dims["record"]))
    tex = _float_input("tex", tex, (E, H * W), records.device)
    phase = _float_input("phase", phase, (H, W), records.device)
    streak_hash = _float_input("streak_hash", streak_hash, (E, H, W), records.device)
    img = torch.empty((E, H, W, 3), dtype=torch.float32, device=records.device)
    launch(_SHADE, lib, lib.render_shade_launch, records, records.data_ptr(), tex.data_ptr(),
           phase.data_ptr(), streak_hash.data_ptr(), _dims_array(dims), consts, img.data_ptr())
    return img


@_BLUR
def render_blur(img: torch.Tensor, speed_kmh: torch.Tensor, taps: torch.Tensor,
                consts: ctypes.Array) -> torch.Tensor:
    """``motion_blur`` of ``img`` [E, H, W, 3] at ``speed_kmh`` [E], with the
    zoom samples' taps [2, 3 (H + W)] (``render/raster.py:zoom_taps``)."""
    lib = _library()
    E, H, W, _ = img.shape
    img = _float_input("img", img, (E, H, W, 3))
    speed_kmh = _float_input("speed_kmh", speed_kmh, (E,), img.device)
    taps = _float_input("taps", taps, (2, 3 * (H + W)), img.device)
    out = torch.empty_like(img)
    launch(_BLUR, lib, lib.render_blur_launch, img, img.data_ptr(), speed_kmh.data_ptr(),
           taps.data_ptr(), E, H, W, consts, out.data_ptr())
    return out


# The entry points, whose launches show that a path ran on them.
RENDER_KERNELS = (render_prep, render_points, render_shade, render_blur)
