"""Parity of cilrs_tpu_torch.ops.sinf (glibc's float sin, for the sin hashes)
with jitted ``jnp.sin`` of the JAX package's own hash expressions: bit for
bit, no tolerance.

The sets (``cilrs_tpu_torch/bench/hash_sets.py``): the rain streaks' 200,000
integer columns, the ground grain's cells of a Town01 frame, the recovery
steer's starts 0.05-1,200 s, and 200,000 random signed values from 1e-8 to
1e6 in magnitude. On the CPU the wrapper runs the plain version; the card's
kernel is held to it in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.render import raster as jr  # noqa: E402
from cilrs_tpu.render import weather as jw  # noqa: E402
from cilrs_tpu_torch.agent import driver as td  # noqa: E402
from cilrs_tpu_torch.bench import hash_sets  # noqa: E402
from cilrs_tpu_torch.ops import sinf  # noqa: E402
from cilrs_tpu_torch.render import raster as tr  # noqa: E402
from cilrs_tpu_torch.render import weather as tw  # noqa: E402

# The JAX package's expressions: weather.py:73, raster.py:251, driver.py:273.
JAX_EXPR = {
    "rain": lambda x: jnp.sin(x * 12.9898 + 78.233),
    "grain": lambda q: jnp.sin(q[..., 0] * 12.9898 + q[..., 1] * 78.233),
    "recovery": lambda t: jnp.sin(t * 12.99),
    "random": jnp.sin,
}


def _assert_bits_equal(got: np.ndarray, want: np.ndarray):
    """Equal bit patterns, NaN for NaN (the NaN's payload aside)."""
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    differ = got[~nan].view(np.int32) != want[~nan].view(np.int32)
    assert not differ.any(), (f"{differ.sum()} of {differ.size} differ, e.g. at "
                              f"{got[~nan][differ][:4]} vs {want[~nan][differ][:4]}")


@pytest.mark.parametrize("name", hash_sets.SETS)
def test_hash_sinf_matches_jitted_jnp_sin(name):
    """The port's hash of each set equals jitted jnp.sin of JAX's expression
    bit for bit (XLA:CPU's float32 sin is glibc's sinf; the argument is the
    fused multiply-add's)."""
    args = hash_sets.argument_set(name)
    want = np.asarray(jax.jit(JAX_EXPR[name])(args))
    got = hash_sets.port_hash(name, torch.from_numpy(args)).numpy()
    _assert_bits_equal(got, want)


def test_sinf_edges_match_jitted_jnp_sin():
    """The branch edges of glibc's sinf (2^-12, the pi/4 test on the top 12
    bits at 0.75, 120), signed zeros, subnormals, large values up to the
    largest float, and non-finite values (NaN out)."""
    f32 = np.float32
    edges = [f32(2.0 ** -12), f32(0.75), f32(np.pi / 4), f32(120.0), f32(3e38),
             np.finfo(f32).max, f32(1e-40), f32(2.0 ** -126)]
    vals = [f32(0.0), f32(-0.0), f32(np.inf), f32(-np.inf), f32(np.nan)]
    with np.errstate(over="ignore"):  # past the largest float: inf
        for e in edges:
            vals += [np.nextafter(e, f32(0)), e, np.nextafter(e, f32(np.inf))]
    x = np.array(vals, dtype=f32)
    x = np.concatenate([x, -x])
    want = np.asarray(jax.jit(jnp.sin)(x))
    _assert_bits_equal(sinf.hash_sinf(torch.from_numpy(x), 1.0).numpy(), want)


def test_inv_pio4_is_two_over_pi():
    """The reduction's table: entry i is floor(2/pi * 2^(8 i + 8)) mod 2^32,
    with 2/pi from pi by Machin's formula in integers."""
    nbits, guard = 192, 64
    one = 1 << (nbits + guard)

    def arctan_inv(k):  # arctan(1/k) * 2^(nbits + guard)
        total, term, n, sign = 0, one // k, 1, 1
        while term:
            total += sign * (term // n)
            term, n, sign = term // (k * k), n + 2, -sign
        return total

    pi = 16 * arctan_inv(5) - 4 * arctan_inv(239)
    two_over_pi = (2 * one << nbits) // pi  # floor(2/pi * 2^192)
    want = tuple((two_over_pi >> (nbits - 8 * (i + 1))) & 0xFFFFFFFF for i in range(24))
    assert sinf.INV_PIO4 == want


def test_hash_sinf_argument_forms():
    """y as a tensor, a float or absent; strided columns read in place."""
    rng = np.random.default_rng(3)
    q = np.floor(rng.uniform(-3e4, 3e4, (64, 50, 2))).astype(np.float32)
    t = torch.from_numpy(q)
    want = np.asarray(jax.jit(JAX_EXPR["grain"])(q))
    _assert_bits_equal(sinf.hash_sinf(t[..., 0], 12.9898, t[..., 1] * 78.233).numpy(), want)
    want = np.asarray(jax.jit(JAX_EXPR["rain"])(q[..., 0]))
    _assert_bits_equal(sinf.hash_sinf(t[..., 0], 12.9898, 78.233).numpy(), want)
    _assert_bits_equal(sinf.hash_sinf(t[..., 0], 12.9898, torch.full((64, 50), 78.233)).numpy(),
                       want)
    assert sinf.flat_stride(t) == 1 and sinf.flat_stride(t[..., 0]) == 2
    assert sinf.flat_stride(t[:, :1, 0]) == 100 and sinf.flat_stride(t[:, :10, 0]) is None
    assert sinf.flat_stride(t[:1, :1, :1]) == 1
    with pytest.raises(ValueError):
        sinf.hash_sinf(t.double(), 1.0)
    with pytest.raises(ValueError):
        sinf.hash_sinf(t[..., 0], 1.0, t)


def test_reverse_steer_matches_jax_on_every_start():
    """``agent/driver.py:reverse_steer`` against JAX's recovery lines
    (``cilrs_tpu/agent/driver.py:273-274``) on every 0.05 s start from 0.05
    to 1,199.95 s: exact, the starts whose fraction wraps included."""
    starts = hash_sets.recovery_args()

    def jax_steer(rec_start):
        rseed = jnp.sin(rec_start * 12.99) * 43758.5
        return ((rseed - jnp.floor(rseed)) - 0.5) * 0.6

    want = np.asarray(jax.jit(jax_steer)(starts))
    got = td.reverse_steer(torch.from_numpy(starts)).numpy()
    _assert_bits_equal(got, want)
    # The set holds starts where one ulp of sin flips the steer's sign.
    assert (np.abs(want) > 0.29).sum() > 100


def test_render_hashes_match_jax():
    """The renderer's two hashes end to end, bit for bit: the rain columns
    (``weather._hash01``) and the grain (``raster._hash2``, whose p / cell XLA
    computes with the float32 reciprocal) on points of a Town01 frame's
    cells, moved inside them."""
    x = hash_sets.rain_args()
    _assert_bits_equal(tw._hash01(torch.from_numpy(x)).numpy(),
                       np.asarray(jax.jit(jw._hash01)(x)))
    q = hash_sets.grain_args()
    inside = np.random.default_rng(1).uniform(0.0, 1.0, q.shape)
    for cell in (1.7, 0.45):
        p = ((q + inside) * np.float32(cell)).astype(np.float32)
        want = np.asarray(jax.jit(lambda v: jr._hash2(v, cell))(p))
        _assert_bits_equal(tr._hash2(torch.from_numpy(p), cell).numpy(), want)


@pytest.mark.parametrize("width", [64, 200, 320])
def test_streak_phase_as_the_jax_renderer_compiles_it(width):
    """The rain streaks' column phase, computed as ``render_frame`` computes
    it (pixel columns from an iota, ``raster.py:585-587``, hashed by
    ``weather.py:86-87``) under jit. At the package's widths (200, the
    chase camera's 320) it equals the port's hash bit for bit. At the
    64-pixel width of the loop tests the columns are constants of the
    program, and its phase equals the hash with the argument rounded twice
    and sin correctly rounded instead, which the port does not reproduce:
    the share of the columns where the two differ is what those tests' rain
    bounds cover (tests/test_torch_fused.py, tests/test_torch_resident.py)."""
    def phase(t):
        u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
        v = (jnp.arange(8, dtype=jnp.float32) + 0.5) / 8
        uu, _ = jnp.meshgrid(u, v)
        return jw._hash01(jnp.floor(uu * 60.0)) + 0.0 * t

    want = np.asarray(jax.jit(phase)(jnp.float32(0.0)))[0]
    u = ((np.arange(width, dtype=np.float32) + np.float32(0.5)) / np.float32(width))
    col = np.floor(u * np.float32(60.0)).astype(np.float32)
    port = tw._hash01(torch.from_numpy(col)).numpy()
    if width > 64:
        _assert_bits_equal(port, want)
        return
    arg = col * np.float32(12.9898) + np.float32(78.233)  # two roundings
    h = np.sin(arg.astype(np.float64)).astype(np.float32) * np.float32(43758.5453)
    _assert_bits_equal((h - np.floor(h)).astype(np.float32), want)
    assert 0 < (port != want).mean() < 0.5


def _grain_points() -> np.ndarray:
    """Points of the grain set's cells, moved inside them, at both cell sizes."""
    q = hash_sets.grain_args()
    inside = np.random.default_rng(2).uniform(0.0, 1.0, q.shape)
    return np.concatenate([((q + inside) * np.float32(cell)).astype(np.float32)
                           for cell in sinf.GRAIN_CELLS])


def _jax_grain_texture(sxy):
    """The JAX renderer's grain (``cilrs_tpu/render/raster.py:402``)."""
    return 0.6 * jr._hash2(sxy, 1.7) + 0.4 * jr._hash2(sxy, 0.45) - 0.5


def _jax_reverse_steer(rec_start):
    """The JAX driver's reverse steer (``cilrs_tpu/agent/driver.py:273-274``)."""
    rseed = jnp.sin(rec_start * 12.99) * 43758.5
    return ((rseed - jnp.floor(rseed)) - 0.5) * 0.6


# Each entry point's argument set, its JAX expression and the port's call.
ENTRY_POINTS = {
    "hash01": (hash_sets.rain_args, jw._hash01,
               lambda t: sinf.hash01(t, sinf.HASH_A, sinf.HASH_C, sinf.HASH_SCALE)),
    "reverse_steer": (hash_sets.recovery_args, _jax_reverse_steer, sinf.reverse_steer),
    "grain_texture": (_grain_points, _jax_grain_texture, sinf.grain_texture),
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_matches_jax(name):
    """Each fused hash's entry point (its plain version on the CPU) against
    jitted JAX on its set, bit for bit: the rain columns (``weather.py:73``),
    the recovery starts (``driver.py:273-274``) and the grain's points
    (``raster.py:246-252``, ``:402``). XLA contracts the grain's
    ``0.6 * coarse + 0.4 * fine`` into a fused multiply-add; the port rounds
    that sum once too."""
    args, jax_fn, port_fn = ENTRY_POINTS[name]
    x = args()
    want = np.asarray(jax.jit(jax_fn)(x))
    got = port_fn(torch.from_numpy(x))
    assert sum(f.launches for f in sinf.SIN_HASHES) == 0  # the CPU runs no kernel
    _assert_bits_equal(got.numpy(), want)


def test_grain_texture_sum_is_contracted():
    """The grain's sum as jitted XLA:CPU computes it: fl32(0.6 * coarse +
    fl32(0.4 * fine)), one rounding, and not the three roundings the source
    spells; the two differ in the last bit on a share of the points, which
    the port reproduces."""
    x = _grain_points()
    t = torch.from_numpy(x)
    coarse, fine = (sinf.grain_hash(t, cell) for cell in sinf.GRAIN_CELLS)
    three_roundings = (0.6 * coarse + 0.4 * fine - 0.5).numpy()
    want = np.asarray(jax.jit(_jax_grain_texture)(x))
    assert 0.05 < (three_roundings != want).mean() < 0.5
    _assert_bits_equal(sinf.grain_texture(t).numpy(), want)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_shapes_and_argument_checks(name):
    """Shapes in and out (the grain takes points [..., 2] and gives [...]),
    empty tensors, and the refusals: a dtype other than float32, a device
    other than the CPU or CUDA, the grain's last dimension."""
    fn = ENTRY_POINTS[name][2]
    grain = name == "grain_texture"
    shape = (3, 5, 2) if grain else (3, 5)
    x = torch.from_numpy(np.random.default_rng(4).uniform(-50, 50, shape).astype(np.float32))
    out = fn(x)
    assert out.shape == (3, 5) and out.dtype == torch.float32
    assert torch.equal(fn(x[1:2]), out[1:2])
    assert fn(torch.empty((0, 2) if grain else (0,))).shape == (0,)
    with pytest.raises(ValueError, match="float32"):
        fn(x.double())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(torch.empty(shape, device="meta"))
    if grain:
        with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
            fn(torch.zeros(3, 5, 3))
