"""The render kernels (``csrc/render.cu``) on the card against the torch
composition they replace (``render/raster.py:render_frame_plain`` with
``motion_blur_plain``), on the same CUDA inputs: the bench's town at 128
envs in mixed weathers and at one env, the mini town and Town01, the chase
camera with the ego drawn, and each of the renderer's switches; and the
profiler linking every kernel of a render to a range around it.

The kernels round every operation where the composition rounds it, so the
frames are compared bit for bit (``MAX_UNEQUAL``). Each render is one launch
of each kernel, two of ``hash01`` and one of ``grain_texture``.

Every test here is marked ``cuda`` and skips without a GPU. No JAX:

    python -m pytest --noconftest tests/test_torch_render_kernel.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from torch_render_scenes import bench_town, fleet_world, frame_gap, staged_world  # noqa: E402

from cilrs_tpu_torch.maps import network as tn  # noqa: E402
from cilrs_tpu_torch.maps import town as tt  # noqa: E402
from cilrs_tpu_torch.ops import render as kernels  # noqa: E402
from cilrs_tpu_torch.ops import sinf  # noqa: E402
from cilrs_tpu_torch.render import camera, raster  # noqa: E402

pytestmark = pytest.mark.cuda

# Share of frame values the kernels may give otherwise than the composition.
MAX_UNEQUAL = 0.0
LAUNCHES_PER_RENDER = {"render_prep": 1, "render_points": 1, "render_shade": 1, "render_blur": 1,
                       "hash_sinf": 0, "hash01": 2, "grain_texture": 1, "reverse_steer": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in (*kernels.RENDER_KERNELS, *sinf.SIN_HASHES)}


def _composition(monkeypatch, net, world, ls, spec, ego):
    """render_frame_plain on the card with the plain blur."""
    with monkeypatch.context() as m:
        m.setattr(raster, "motion_blur", raster.motion_blur_plain)
        return raster.render_frame_plain(net, world, ls, spec, ego)


# (town, world: (kind, envs), camera, ego drawn, switches on)
CASES = {
    "bench_128": ("bench", ("fleet", 128), raster.CAMERA, False, ()),
    "bench_1": ("bench", ("fleet", 1), raster.CAMERA, False, ()),
    "mini": ("mini", ("staged", 5), raster.CAMERA, False, ()),
    "town01": ("town01", ("staged", 5), raster.CAMERA, False, ()),
    "town01_fleet_32": ("town01", ("fleet", 32), raster.CAMERA, False, ()),
    "chase_ego": ("town01", ("staged", 5), camera.CHASE_CAMERA, True, ()),
    "lamps": ("mini", ("staged", 5), raster.CAMERA, False, ("_LAMPS",)),
    "night_lamps": ("bench", ("fleet", 16), raster.CAMERA, False, ("_NIGHT_LAMPS",)),
    "crosswalks": ("town01", ("staged", 5), raster.CAMERA, False, ("_CROSSWALKS",)),
    "all_switches_chase": ("mini", ("staged", 5), camera.CHASE_CAMERA, True,
                           ("_LAMPS", "_NIGHT_LAMPS", "_CROSSWALKS")),
}
TOWNS = {"mini": tt.make_mini_town, "town01": tt.make_town01, "bench": bench_town}


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_the_composition(cuda_device, monkeypatch, case):
    town, (kind, envs), spec, ego, switches = CASES[case]
    net = TOWNS[town]().to(cuda_device)
    world = (staged_world(net, envs, brake=0.8, device=cuda_device) if kind == "staged"
             else fleet_world(net, envs, device=cuda_device))
    for name in switches:
        monkeypatch.setattr(raster, name, True)
    ls = tn.light_states(net, world.time_s)
    before = _launches()
    got = raster.render_frame(net, world, ls, spec, ego)
    torch.cuda.synchronize()
    after = _launches()
    assert {k: after[k] - before[k] for k in after} == LAUNCHES_PER_RENDER
    want = _composition(monkeypatch, net, world, ls, spec, ego)
    assert got.shape == want.shape == (envs, spec.height, spec.width, 3)
    gap = frame_gap(got, want)
    assert gap["unequal"] <= MAX_UNEQUAL, gap


def test_blur_kernel_matches_the_plain_blur(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.rand((128, 88, 200, 3), generator=g, device=cuda_device)
    speed = torch.rand(128, generator=g, device=cuda_device) * 60.0
    before = kernels.render_blur.launches
    got = raster.motion_blur(x, speed)
    torch.cuda.synchronize()
    assert kernels.render_blur.launches == before + 1
    assert torch.equal(got, raster.motion_blur_plain(x, speed))


def _linked(event) -> set:
    """Names of the kernels the profiler linked to ``event`` and below it."""
    names = {k.name.split("(")[0].removeprefix("void ") for k in event.kernels}
    for child in event.cpu_children:
        names |= _linked(child)
    return names


def test_profiler_links_the_kernels_to_the_range_around_them(cuda_device):
    """Under torch.profiler a range around render_frame holds every kernel
    the render launched, the hand-written ones among them (each launches in a
    ``kernel::`` operation)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    net = bench_town().to(cuda_device)
    world = fleet_world(net, 8, device=cuda_device)
    ls = tn.light_states(net, world.time_s)
    raster.render_frame(net, world, ls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("test::render"):
            raster.render_frame(net, world, ls)
        torch.cuda.synchronize()
    device = {e.name.split("(")[0].removeprefix("void ") for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)}
    (rng,) = [e for e in prof.events() if e.name == "test::render"
              and e.device_type == torch.autograd.DeviceType.CPU]
    assert {"render_prep_kernel", "render_points_kernel", "render_shade_kernel",
            "render_blur_kernel"} <= device
    assert _linked(rng) == device
