"""Parity of cilrs_tpu_torch.data.prepare and ops.image.{resize_frame,
preprocess_frame} with the JAX package's.

Tolerances:
 - ``resize_frame`` from 600x800, 176x400, 100x300 and 50x120 to 88x200, on
   [0, 1] floats: 1e-5. ``jax.image.resize(method="bilinear")`` antialiases
   when it shrinks, with half-pixel centres; ``F.interpolate(mode=
   "bilinear", antialias=True, align_corners=False)`` computes the same
   triangle filter, its weights summed in another order (measured: under
   2e-6). Without antialias the miss is up to 0.5, which the test shows;
 - ``preprocess_frame``: 5e-5, the resize's error through ImageNet
   normalization (a division by 0.225);
 - ``process_session``: u8 frames within 1 level (the packages truncate
   floats that may differ in the last bit), PNG files the same; the copied
   CSV and summary byte-identical, the frame counts equal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from cilrs_tpu.data import prepare as jprep  # noqa: E402
from cilrs_tpu.ops import image as jimg  # noqa: E402
from cilrs_tpu_torch.data import prepare as tprep  # noqa: E402
from cilrs_tpu_torch.ops import image as timg  # noqa: E402

SOURCES = [(600, 800), (176, 400), (100, 300), (50, 120)]
RESIZE_TOL = 1e-5
PREPROCESS_TOL = 5e-5


@pytest.mark.parametrize("hw", SOURCES)
def test_resize_frame_matches_jax(hw):
    x = np.random.RandomState(hw[0]).uniform(0, 1, (3,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jimg.resize_frame(jnp.asarray(x)))
    got = timg.resize_frame(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 88, 200, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)
    # One frame without a batch dimension, and another target size.
    np.testing.assert_allclose(timg.resize_frame(torch.from_numpy(x[0]), 44, 100).numpy(),
                               np.asarray(jimg.resize_frame(jnp.asarray(x[0]), 44, 100)),
                               atol=RESIZE_TOL, rtol=0)


def test_resize_needs_its_antialias():
    """Plain bilinear sampling misses the JAX resize by far more than the
    tolerance when it shrinks 600x800 by 7x4."""
    x = np.random.RandomState(0).uniform(0, 1, (1, 600, 800, 3)).astype(np.float32)
    want = np.asarray(jimg.resize_frame(jnp.asarray(x)))
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), (88, 200),
                                            mode="bilinear", align_corners=False)
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 100 * RESIZE_TOL


@pytest.mark.parametrize("case", ["u8_600x800", "u8_88x200", "f32_176x400", "f32_no_resize"])
def test_preprocess_frame_matches_jax(case):
    rng = np.random.RandomState(1)
    hw = {"u8_600x800": (600, 800), "u8_88x200": (88, 200), "f32_176x400": (176, 400),
          "f32_no_resize": (176, 400)}[case]
    if case.startswith("u8"):
        x = rng.randint(0, 256, (2,) + hw + (3,)).astype(np.uint8)
    else:
        x = rng.uniform(-0.1, 1.1, (2,) + hw + (3,)).astype(np.float32)
    resize = case != "f32_no_resize"
    want = np.asarray(jimg.preprocess_frame(jnp.asarray(x), resize=resize))
    got = timg.preprocess_frame(torch.from_numpy(x), resize=resize).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PREPROCESS_TOL, rtol=0)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A session with one .npz shard of each source size, two PNGs and the
    session files."""
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(2)
    for k, hw in enumerate(SOURCES):
        # Smooth frames, as a camera's are, plus noise.
        base = rng.uniform(0, 255, (5, hw[0] // 10 + 1, hw[1] // 10 + 1, 3))
        up = np.repeat(np.repeat(base, 10, axis=1), 10, axis=2)[:, :hw[0], :hw[1]]
        frames = np.clip(up + rng.normal(0, 8, up.shape), 0, 255).astype(np.uint8)
        np.savez_compressed(d / f"frames_{k:04d}.npz", frames=frames)
    for name, hw in (("frame_00000000.png", (600, 800)), ("frame_00000001.png", (176, 400))):
        Image.fromarray(rng.randint(0, 256, hw + (3,)).astype(np.uint8)).save(d / name)
    (d / "measurements.csv").write_text("frame,image_filename\n0,frames_0000.npz#0\n")
    (d / "summary.txt").write_text("DATA COLLECTION SUMMARY\n")
    (d / "notes.txt").write_text("not copied\n")
    return d


def test_process_session_matches_jax(session, tmp_path):
    want = jprep.process_session(str(session), str(tmp_path / "jax"), verbose=False)
    got = tprep.process_session(str(session), str(tmp_path / "torch"), batch=3, verbose=False,
                                device="cpu")
    assert (got["frames_in"], got["frames_out"]) == (want["frames_in"], want["frames_out"]) == (22, 22)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    assert "notes.txt" not in names and len(names) == 8
    for name in names:
        a, b = tmp_path / "torch" / name, tmp_path / "jax" / name
        if name.endswith(".npz"):
            fa, fb = np.load(a)["frames"], np.load(b)["frames"]
        elif name.endswith(".png"):
            fa, fb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        else:
            assert a.read_bytes() == b.read_bytes(), name
            continue
        assert fa.shape == fb.shape and fa.shape[-3:] == (88, 200, 3) and fa.dtype == np.uint8, name
        assert np.abs(fa.astype(int) - fb.astype(int)).max() <= 1, name


def test_prepare_main_on_cpu(session, tmp_path):
    out = tprep.main([str(session), str(tmp_path / "small"), "--height", "44", "--width", "100",
                      "--device", "cpu"])
    assert out["frames_out"] == 22 and out["size_mb"] > 0
    assert np.load(tmp_path / "small" / "frames_0000.npz")["frames"].shape == (5, 44, 100, 3)
