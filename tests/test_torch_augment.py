"""Augmentation parity: cilrs_tpu_torch.ops.image against cilrs_tpu.ops.image.

jax.random and torch's generators draw different streams, so the port is held
to the JAX function through its pure apply step: the test makes every draw
from the same ``jax.random.split(key, 12)`` as ``augment_batch`` does
(cilrs_tpu/ops/image.py:95-126) and feeds them to ``apply_augment``.
Tolerances (float32 images in [0, 1]):
 - the colour conversions and the blur: atol 1e-6, a few float32 ulps of
   values of order 1 (the two frameworks may round divisions and
   multiply-adds differently);
 - the whole augmentation: atol 1e-5 on all but a tiny share of pixels. The
   hue sector is floor(6 h): a pixel whose hue lies within rounding of a
   sector boundary may fall in the neighbouring sector in one framework,
   where the two sectors' formulas give values that differ by up to the
   saturation. At most 1e-4 of the values may differ by more than 1e-5
   (measured: none did; the largest difference was 1.0e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.ops import image as jimg  # noqa: E402
from cilrs_tpu_torch.ops import image as timg  # noqa: E402

COLOUR_TOL = dict(atol=1e-6, rtol=0)
AUG_ATOL = 1e-5
AUG_MAX_SHARE = 1e-4
B, H, W = 6, 32, 64


def _images(seed, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    # Grey pixels, pure primaries and ties between channels exercise the
    # max/min branches of the hue formula.
    x[:, 0, :8] = 0.5
    x[:, 1, :4] = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    x[:, 2, :4] = np.array([[0.3, 0.3, 0.1], [0.2, 0.6, 0.6], [0.9, 0.1, 0.9], [0, 0, 0]],
                           np.float32)
    return x


def _jax_draws(key, b, h, w):
    """The draws of cilrs_tpu/ops/image.py:augment_batch, in its own order."""
    keys = jax.random.split(key, 12)
    s4, s3 = (b, 1, 1, 1), (b, 1, 1)
    u = jax.random.uniform
    d = {
        "apply_bc": u(keys[0], s4) < 0.5,
        "brightness": u(keys[1], s4, minval=-0.2, maxval=0.2),
        "contrast": u(keys[2], s4, minval=0.8, maxval=1.2),
        "apply_hsv": u(keys[3], s4) < 0.3,
        "dh": u(keys[4], s3, minval=-0.05, maxval=0.05),
        "ds": u(keys[10], s3, minval=0.85, maxval=1.15),
        "apply_blur": u(keys[5], s4) < 0.2,
        "apply_noise": u(keys[6], s4) < 0.2,
        "noise": jax.random.normal(keys[7], (b, h, w, 3)) * 0.02,
        "apply_cut": u(keys[8], s4) < 0.3,
        "cy": u(keys[9], s3, minval=0.0, maxval=1.0) * h,
        "cx": u(keys[11], s3, minval=0.0, maxval=1.0) * w,
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_rgb_hsv_round_trip_matches_jax():
    x = _images(0)
    hsv_j = np.asarray(jimg._vec_rgb_to_hsv(jnp.asarray(x)))
    hsv_t = timg._vec_rgb_to_hsv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(hsv_t, hsv_j, **COLOUR_TOL)
    # Shifted hues, wrapped by floor-mod, through the inverse.
    shifted = hsv_j.copy()
    shifted[..., 0] = (shifted[..., 0] + np.float32(0.97)) % np.float32(1.0)
    rgb_j = np.asarray(jimg._vec_hsv_to_rgb(jnp.asarray(shifted)))
    rgb_t = timg._vec_hsv_to_rgb(torch.from_numpy(shifted)).numpy()
    np.testing.assert_allclose(rgb_t, rgb_j, **COLOUR_TOL)
    # Every hue sector is exercised.
    assert set(np.unique(np.floor(shifted[..., 0] * 6).astype(int) % 6)) == set(range(6))


def test_hsv_to_rgb_wraps_sector_six():
    """h == 1.0 gives sector 6, which % 6 folds back to sector 0 in both."""
    hsv = np.array([[[[1.0, 0.5, 0.8], [0.0, 0.5, 0.8], [0.999999, 1.0, 1.0]]]], np.float32)
    np.testing.assert_allclose(timg._vec_hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
                               np.asarray(jimg._vec_hsv_to_rgb(jnp.asarray(hsv))), **COLOUR_TOL)


def test_blur3_matches_jax():
    x = _images(1)
    np.testing.assert_allclose(timg._blur3(torch.from_numpy(x)).numpy(),
                               np.asarray(jimg._blur3(jnp.asarray(x))), **COLOUR_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_augment_matches_jax_with_its_draws(seed):
    b = 16  # enough samples that every branch applies somewhere
    x = _images(10 + seed, b=b)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jimg.augment_batch(key, jnp.asarray(x)))
    draws = _jax_draws(key, b, H, W)
    for k in ("apply_bc", "apply_hsv", "apply_blur", "apply_noise", "apply_cut"):
        assert draws[k].dtype == torch.bool and draws[k].any(), k  # each branch applies
    got = timg.apply_augment(torch.from_numpy(x), draws).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    bad = np.abs(got - want) > AUG_ATOL
    assert bad.mean() <= AUG_MAX_SHARE, (bad.sum(), np.abs(got - want).max())
    # The augmentation did something: the draws are not a no-op.
    assert np.abs(want - x).max() > 0.1


def test_draw_augment_shapes_and_rates():
    """The port's draws have the JAX shapes and dtypes, lie in their ranges,
    apply at the stated rates, and depend only on the generator's seed."""
    gen = torch.Generator().manual_seed(0)
    n = 4000
    d = timg.draw_augment(gen, n, 4, 5)
    ref = _jax_draws(jax.random.PRNGKey(0), n, 4, 5)
    assert set(d) == set(ref)
    for k, v in ref.items():
        assert d[k].shape == v.shape and d[k].dtype == v.dtype, k
    for k, p in (("apply_bc", 0.5), ("apply_hsv", 0.3), ("apply_blur", 0.2),
                 ("apply_noise", 0.2), ("apply_cut", 0.3)):
        assert abs(d[k].float().mean().item() - p) < 0.04, k
    for k, lo, hi in (("brightness", -0.2, 0.2), ("contrast", 0.8, 1.2), ("dh", -0.05, 0.05),
                      ("ds", 0.85, 1.15), ("cy", 0, 4), ("cx", 0, 5)):
        assert d[k].min() >= lo and d[k].max() <= hi, k
    assert abs(d["noise"].std().item() - 0.02) < 1e-3
    again = timg.draw_augment(torch.Generator().manual_seed(0), n, 4, 5)
    assert all(torch.equal(d[k], again[k]) for k in d)
    x = torch.from_numpy(_images(5, b=8, h=4, w=5))
    a = timg.augment_batch(torch.Generator().manual_seed(3), x)
    assert torch.equal(a, timg.augment_batch(torch.Generator().manual_seed(3), x))
    assert not torch.equal(a, timg.augment_batch(torch.Generator().manual_seed(4), x))
