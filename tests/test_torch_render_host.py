"""The render kernels (``csrc/render.cu``) built for the host, against the
torch composition they replace, on the CPU.

``tests/render_host_emulation.h`` compiles the CUDA source with g++ (each
block's threads as host threads, the card's intrinsics as IEEE float
operations); ``ops/render.py`` then takes CPU tensors through the same
wrapper code as on the card. The frames differ from
``render_frame_plain``'s only where the CPU's torch differs from the card's
(which the kernels copy): true division by a Python number instead of the
reciprocal's product, the order of a three-element sum, glibc's and SLEEF's
sin and cos, the remainder's formula. Measured: at most 8e-5 of the values
off by more than 1e-6, a mean difference under 2e-6; one edge pixel in
Town01's chase view moves by 0.16. The card's own tests
(``tests/test_torch_render_kernel.py``) hold the kernels to the
composition bit for bit.

Also: ``render_frame`` on CPU tensors launches nothing.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_render_scenes import bench_town, fleet_world, staged_world  # noqa: E402

from cilrs_tpu_torch.maps import network as tn  # noqa: E402
from cilrs_tpu_torch.maps import town as tt  # noqa: E402
from cilrs_tpu_torch.ops import render as kernels  # noqa: E402
from cilrs_tpu_torch.ops import sinf  # noqa: E402
from cilrs_tpu_torch.render import camera, raster  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The CPU's torch against the card's arithmetic (see the module docstring).
MAX_SHARE_BEYOND, BEYOND, MAX_MEAN = 1e-3, 1e-5, 1e-5


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the render kernels for the host")
    out = str(tmp_path_factory.mktemp("render_host") / "render_host.so")
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-x",
         "c++", "-DRENDER_HOST_EMULATION", "-include",
         os.path.join(REPO, "tests", "render_host_emulation.h"),
         os.path.join(REPO, "cilrs_tpu_torch", "csrc", "render.cu"), "-o", out],
        check=True, capture_output=True, text=True)
    return kernels.bind(ctypes.CDLL(out))


@pytest.fixture
def host_kernels(host_library, monkeypatch):
    monkeypatch.setattr(kernels, "_library", lambda: host_library)
    return host_library


def test_layout_matches_the_wrapper(host_kernels):
    """The renderer gives a value for each constant the library names, of
    its size, and no other; the library takes the wrapper's prep inputs."""
    lay = host_kernels.layout
    assert lay.prep_inputs == len(kernels.PREP_INPUTS)
    consts = raster.kernel_consts.__wrapped__(raster.CAMERA)
    assert len(consts) == sum(n for _, n in lay.consts)
    assert [name for name, _ in lay.consts][:3] == ["inv_w", "inv_h", "tan_h"]
    assert lay.dims[0] == "envs" and lay.dims[-1] == "record"
    with pytest.raises(ValueError, match="the render kernels take"):
        kernels.pack_consts({"inv_w": 1.0})


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in (*kernels.RENDER_KERNELS, *sinf.SIN_HASHES)}


def test_render_frame_on_the_cpu_launches_nothing():
    net = tt.make_mini_town()
    world = staged_world(net)
    ls = tn.light_states(net, world.time_s)
    before = _launches()
    got = raster.render_frame(net, world, ls)
    assert _launches() == before
    assert torch.equal(got, raster.render_frame_plain(net, world, ls))


# (town, world, camera, ego drawn, switches on)
CASES = {
    "mini_front": ("mini", "staged", raster.CAMERA, False, ()),
    "town01_chase_ego": ("town01", "staged", camera.CHASE_CAMERA, True, ()),
    "bench_fleet": ("bench", "fleet", raster.CAMERA, False, ()),
    "mini_lamps": ("mini", "staged", raster.CAMERA, False, ("_LAMPS",)),
    "mini_night_lamps": ("mini", "staged", raster.CAMERA, False, ("_NIGHT_LAMPS",)),
    "town01_crosswalks": ("town01", "staged", raster.CAMERA, False, ("_CROSSWALKS",)),
}
TOWNS = {"mini": tt.make_mini_town, "town01": tt.make_town01, "bench": bench_town}


@pytest.mark.parametrize("case", list(CASES))
def test_host_kernels_match_the_composition(host_kernels, monkeypatch, case):
    town, kind, spec, ego, switches = CASES[case]
    net = TOWNS[town]()
    world = staged_world(net, brake=0.8) if kind == "staged" else fleet_world(net, 6)
    for name in switches:
        monkeypatch.setattr(raster, name, True)
    ls = tn.light_states(net, world.time_s)
    before = _launches()
    got = raster.render_frame_kernels(net, world, ls, spec, ego)
    after = _launches()
    # One launch of each kernel but the blur's (motion_blur on a CPU tensor
    # is its plain version), the hashes as the composition calls them.
    assert {k: after[k] - before[k] for k in after} == {
        "render_prep": 1, "render_points": 1, "render_shade": 1, "render_blur": 0,
        "hash_sinf": 0, "hash01": 0, "grain_texture": 0, "reverse_steer": 0}
    want = raster.render_frame_plain(net, world, ls, spec, ego)
    assert got.shape == want.shape == (world.num_envs, spec.height, spec.width, 3)
    d = (got - want).abs()
    assert float((d > BEYOND).float().mean()) <= MAX_SHARE_BEYOND
    assert float(d.mean()) <= MAX_MEAN
    if switches == ("_LAMPS",):  # the switch shows: a braking NPC's taillights
        monkeypatch.setattr(raster, "_LAMPS", False)
        off = raster.render_frame_kernels(net, world, ls, spec, ego)
        assert float((off - got).abs().max()) > 0.1


def test_host_blur_matches_the_plain_blur(host_kernels):
    x = np.random.RandomState(4).uniform(0, 1, (4, 88, 200, 3)).astype(np.float32)
    x = torch.from_numpy(x)
    speed = torch.tensor([0.0, 12.0, 36.0, 50.0])
    before = kernels.render_blur.launches
    got = kernels.render_blur(x, speed, raster.zoom_taps(88, 200, x.device),
                              raster.kernel_consts(raster.CAMERA))
    assert kernels.render_blur.launches == before + 1
    np.testing.assert_allclose(got.numpy(), raster.motion_blur_plain(x, speed).numpy(),
                               atol=1e-6, rtol=0)


def test_render_prep_refuses_inputs_it_cannot_read(host_kernels):
    """A light state of another shape or a world tensor of another type is
    refused before the launch (the kernel would read past it)."""
    net = tt.make_mini_town()
    world = staged_world(net)
    ls = tn.light_states(net, world.time_s)
    before = kernels.render_prep.launches
    with pytest.raises(ValueError, match="light_state"):
        raster.render_frame_kernels(net, world, ls[:, :-1])
    with pytest.raises(ValueError, match="veh_alive"):
        raster.render_frame_kernels(net, world.replace(veh_alive=world.veh_alive.float()), ls)
    assert kernels.render_prep.launches == before
