"""Row-gather parity: cilrs_tpu_torch.ops.gather against the JAX package.

On the CPU the port's wrapper runs its plain version (CPU tensors only); the
JAX gather runs its Pallas kernel in interpret mode, as tests/test_pallas.py
runs it. Every comparison is bit-exact. The CUDA kernel itself is held against
the plain version by tests/test_torch_cuda.py on a machine with a GPU, and by
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.ops import gather as jg  # noqa: E402
from cilrs_tpu_torch.ops import gather as tg  # noqa: E402


def _jax_rows(table_2d: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.asarray(jg.gather_rows(jnp.asarray(table_2d), jnp.asarray(idx, jnp.int32),
                                     interpret=True))


def _port_rows(table_2d: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return tg.gather_rows(torch.from_numpy(table_2d), torch.from_numpy(idx)).numpy()


# The four cases of tests/test_pallas.py, through both packages.
def test_gather_rows_matches_jax():
    rng = np.random.RandomState(0)
    tbl = rng.randint(0, 255, (257, 384), dtype=np.uint8)
    idx = rng.randint(0, 257, (64,)).astype(np.int32)
    out = _port_rows(tbl, idx)
    assert out.shape == (64, 384) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, _jax_rows(tbl, idx))
    np.testing.assert_array_equal(out, tbl[idx])


def test_gather_rows_float_and_repeats():
    rng = np.random.RandomState(1)
    tbl = rng.randn(100, 256).astype(np.float32)
    idx = np.array([0, 0, 99, 5, 5, 5, 42, 0], np.int32)
    out = _port_rows(tbl, idx)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, _jax_rows(tbl, idx))


def test_gather_rows_clamps_out_of_range():
    tbl = np.arange(10 * jg.LANE, dtype=np.float32).reshape(10, jg.LANE)
    idx = np.array([-3, 12, -2 ** 31, 2 ** 31 - 1], np.int32)
    out = _port_rows(tbl, idx)
    np.testing.assert_array_equal(out, _jax_rows(tbl, idx))
    np.testing.assert_array_equal(out, tbl[[0, 9, 0, 9]])


def test_pad_rows_and_train_frame_shape():
    # 88*200*3 = 52800 is already 16-byte aligned: no padding on CUDA.
    assert tg.padded_row_elems(88 * 200 * 3, torch.uint8) == 52800
    assert tg.padded_row_elems(88 * 200 * 3, torch.float32) == 52800
    assert tg.padded_row_elems(33, torch.uint8) == 48
    assert tg.padded_row_elems(33, torch.float32) == 36
    rng = np.random.RandomState(2)
    tbl = rng.randint(0, 255, (16, 88 * 200 * 3), dtype=np.uint8)
    idx = np.array([3, 1, 15], np.int32)
    out = _port_rows(tbl, idx)
    jout = _jax_rows(np.asarray(jg.pad_rows(jnp.asarray(tbl))), idx)
    np.testing.assert_array_equal(out, jout[:, :tbl.shape[1]])


def _paged_tables(rng, page_rows, num_pages, slack, last_rows, width, dtype):
    """Pages with `slack` physical rows past their logical ones, the last page
    shorter (as collect_resident's and ship_resident's layouts have)."""
    pages = []
    for p in range(num_pages):
        n = (page_rows + slack) if p < num_pages - 1 else last_rows
        if dtype == np.uint8:
            pages.append(rng.randint(0, 256, (n, width), dtype=np.uint8))
        else:
            pages.append(rng.randn(n, width).astype(dtype))
    return pages


@pytest.mark.parametrize("num_pages,last_rows,dtype", [
    (1, 54, np.uint8), (2, 40, np.uint8), (3, 154, np.uint8), (3, 20, np.float32)])
def test_gather_rows_paged_matches_jax(num_pages, last_rows, dtype):
    """Paged routing (tests/test_resident.py's page math), including indices
    that map to no page (negative, past the last page) and rows in a page's
    slack or past a short last page, which clamp."""
    rng = np.random.RandomState(num_pages)
    page_rows, width = 54, 256
    pages = _paged_tables(rng, page_rows, num_pages, 100, last_rows, width, dtype)
    n_logical = page_rows * (num_pages - 1) + min(last_rows, page_rows)
    idx = np.concatenate([
        rng.randint(0, n_logical, 24),
        [-1, -54, -55, -1000, 0, page_rows - 1, page_rows, n_logical - 1,
         n_logical, n_logical + 7, page_rows * num_pages + 3, 10 ** 6],
    ]).astype(np.int32)
    jpages = tuple(jnp.asarray(p.reshape(p.shape[0], -1, jg.LANE)) for p in pages)
    want = np.asarray(jg.gather_rows_paged(jpages, jnp.asarray(idx), page_rows, interpret=True))
    got = tg.gather_rows_paged(tuple(torch.from_numpy(p) for p in pages),
                               torch.from_numpy(idx), page_rows).numpy()
    np.testing.assert_array_equal(got, want)
    # In-range rows equal direct per-page reads.
    for k in range(24):
        g = idx[k]
        np.testing.assert_array_equal(got[k], pages[g // page_rows][g % page_rows])


@pytest.mark.parametrize("num_rows,row_bytes,slack,limit", [
    (176256, 52800, 0, jg.PAGE_BYTE_LIMIT),
    (176256, 53248, 3200, jg.PAGE_BYTE_LIMIT),
    (157000, 52800, 0, jg.PAGE_BYTE_LIMIT),
    (160, 8192, 100, 161 * 8192),
    (1, 16, 0, jg.PAGE_BYTE_LIMIT),
])
def test_paged_layout_identical(num_rows, row_bytes, slack, limit):
    assert tg.paged_layout(num_rows, row_bytes, slack, limit) == \
        jg.paged_layout(num_rows, row_bytes, slack, limit)
    assert tg.PAGE_BYTE_LIMIT == jg.PAGE_BYTE_LIMIT


def test_full_size_layout_is_two_pages():
    # The 176,256-frame table of the full-size run: 2 pages of 88,128 rows,
    # each past 2^31 bytes (the kernel's offsets are 64-bit).
    num_pages, page_rows, _ = tg.paged_layout(176256, 52800, 0)
    assert (num_pages, page_rows) == (2, 88128)
    assert page_rows * 52800 > 2 ** 31


def test_paged_layout_rejects_no_room():
    with pytest.raises(ValueError):
        tg.paged_layout(10, 1000, 10, 5000)


@pytest.mark.parametrize("case", ["dtype", "width", "idx_2d", "no_pages", "meta"])
def test_gather_wrapper_checks(case):
    a = torch.zeros((4, 32), dtype=torch.uint8)
    idx = torch.zeros(3, dtype=torch.int32)
    pages, page_rows = (a, a.clone()), 4
    if case == "dtype":
        pages = (a, a.float())
    elif case == "width":
        pages = (a, torch.zeros((4, 48), dtype=torch.uint8))
    elif case == "idx_2d":
        idx = idx[None]
    elif case == "no_pages":
        pages = ()
    elif case == "meta":
        pages, idx = (a.to("meta"),), idx.to("meta")
    with pytest.raises(ValueError):
        tg.gather_rows_paged(pages, idx, page_rows)


def test_cpu_gather_does_not_launch():
    before = tg.gather_rows_paged.launches
    tg.gather_rows(torch.zeros((4, 16), dtype=torch.uint8), torch.arange(3))
    assert tg.gather_rows_paged.launches == before


def test_kernel_source_and_build_flags():
    """The kernel source exists in the package and builds for sm_90a; nothing
    is built at import time (no nvcc here)."""
    import os

    from cilrs_tpu_torch.ops import build

    src = os.path.join(build.CSRC_DIR, "gather_rows.cu")
    text = open(src).read()
    assert 'extern "C" int gather_rows_launch' in text and "cudaGetLastError" in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path("gather_rows").startswith(build.BUILD_DIR)
