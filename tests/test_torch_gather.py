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


def _kernel_source() -> str:
    import os

    from cilrs_tpu_torch.ops import build

    with open(os.path.join(build.CSRC_DIR, "gather_rows.cu")) as f:
        return f.read()


def test_kernel_source_and_build_flags():
    """The kernel source exists in the package and builds for sm_90a; nothing
    is built at import time (no nvcc here). It moves rows with TMA bulk copies
    tracked by mbarriers."""
    from cilrs_tpu_torch.ops import build

    text = _kernel_source()
    assert 'extern "C" int gather_rows_launch' in text and "cudaGetLastError" in text
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in text
    assert "cp.async.bulk.global.shared::cta.bulk_group" in text
    assert "cp.async.bulk.wait_group.read" in text and "fence.mbarrier_init" in text
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path("gather_rows").startswith(build.BUILD_DIR)


@pytest.mark.parametrize("define,value", [
    ("GATHER_MAX_SMEM", tg.SMEM_MAX_BYTES), ("GATHER_BARRIER_BYTES", tg.BARRIER_BYTES),
    ("GATHER_MAX_STAGES", tg.MAX_STAGES), ("GATHER_STORE_DEPTH", tg.STORE_DEPTH)])
def test_plan_constants_match_kernel(define, value):
    """bulk_plan's limits are the ones the kernel's launcher checks."""
    import re

    assert int(re.search(rf"#define {define} (\d+)", _kernel_source()).group(1)) == value


def block_items(block: int, total: int, grid: int) -> range:
    """The items persistent block ``block`` of ``grid`` copies, in its order,
    as the kernel (csrc/gather_rows.cu) deals ``total`` items out:
    round-robin. Item k is chunk k % chunks_per_row of output row
    k // chunks_per_row."""
    return range(block, total, grid)


# SM counts: the H100 SXM's 132 and PCIe's 114, and small grids that leave
# blocks with uneven counts.
@pytest.mark.parametrize("num_sms", [132, 114, 16, 1])
@pytest.mark.parametrize("b", [0, 1, 131, 3000])
@pytest.mark.parametrize("row_bytes", [16, 4096, 52_800, 53_248])
def test_bulk_plan_covers_every_chunk_once(row_bytes, b, num_sms):
    """The kernel's work split, walked in Python: chunks tile each row
    exactly in multiples of 16 B, the ring fits in shared memory, the grid is
    no larger than the item count, and the blocks' items cover every
    (row, chunk) pair exactly once with counts differing by at most one."""
    chunk, per_row, stages, grid, smem = tg.bulk_plan(row_bytes, b, num_sms)
    spans = [min(chunk, row_bytes - c * chunk) for c in range(per_row)]
    assert chunk % 16 == 0 and all(s > 0 and s % 16 == 0 for s in spans)
    assert sum(spans) == row_bytes
    assert tg.STORE_DEPTH < stages <= tg.MAX_STAGES
    assert smem == tg.BARRIER_BYTES + stages * chunk <= tg.SMEM_MAX_BYTES
    assert stages * chunk <= tg.RING_BYTES
    total = b * per_row
    assert grid <= total and grid <= num_sms
    assert (grid >= 1) == (total >= 1)
    seen, sizes = [], []
    for blk in range(grid):
        items = block_items(blk, total, grid)
        # The kernel's count and its k-th item (csrc/gather_rows.cu).
        n = total // grid + (blk < total % grid)
        assert list(items) == [blk + k * grid for k in range(n)]
        sizes.append(n)
        seen += [divmod(item, per_row) for item in items]
    assert sorted(seen) == [(i, c) for i in range(b) for c in range(per_row)]
    assert len(set(seen)) == len(seen)
    if grid:
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def _cursor_walk(first, step, n, per_row, stages):
    """The kernel's Cursor (csrc/gather_rows.cu), modelled in Python: n items
    from item `first`, `step` apart, moved on by additions only."""
    step_rows, step_chunks = divmod(step, per_row)
    i, c, s, parity = first // per_row, first % per_row, 0, 0
    for _ in range(n):
        yield i, c, s, parity
        i, c = i + step_rows, c + step_chunks
        if c >= per_row:
            c, i = c - per_row, i + 1
        s += 1
        if s == stages:
            s, parity = 0, parity ^ 1


@pytest.mark.parametrize("per_row,stages,grid,total", [
    (2, 8, 132, 6000), (1, 8, 132, 3000), (7, 8, 132, 7 * 131), (4, 16, 5, 4 * 3), (3, 12, 264, 3)])
def test_kernel_cursor_matches_item_order(per_row, stages, grid, total):
    """Stepping by additions gives, for each block's k-th item, the row and
    chunk of divmod(item, chunks_per_row) and the ring stage k % stages with
    mbarrier parity (k // stages) & 1."""
    grid = min(grid, total)
    for blk in range(grid):
        items = list(block_items(blk, total, grid))
        walk = list(_cursor_walk(blk, grid, len(items), per_row, stages))
        assert walk == [(*divmod(it, per_row), k % stages, (k // stages) & 1)
                        for k, it in enumerate(items)]


def _kernel_route(g, page_rows, page_phys_rows):
    """The kernel's route() (csrc/gather_rows.cu), modelled in Python: (page,
    row) of global index g, found without a division."""
    num_pages = len(page_phys_rows)
    if num_pages == 1:
        return 0, min(max(g, 0), page_phys_rows[0] - 1)
    if not 0 <= g < num_pages * page_rows:
        return 0, 0
    p, r = 0, g
    while r >= page_rows:
        r, p = r - page_rows, p + 1
    return p, min(r, page_phys_rows[p] - 1)


@pytest.mark.parametrize("page_phys_rows", [(54,), (61, 40), (61, 61, 20), (3, 3, 3, 3)])
def test_kernel_route_matches_plain(page_phys_rows):
    """The kernel's division-free routing picks the row the plain version
    (and so the JAX package) picks, for every index near the pages."""
    page_rows = 54 if page_phys_rows[0] > 3 else 3
    pages = tuple(torch.arange(n, dtype=torch.int64)[:, None] * 100 + p
                  for p, n in enumerate(page_phys_rows))
    idx = torch.arange(-3 * page_rows, (len(pages) + 3) * page_rows, dtype=torch.int32)
    idx = torch.cat([idx, torch.tensor([-2 ** 31, 2 ** 31 - 1], dtype=torch.int32)])
    want = tg.gather_rows_plain(pages, idx, page_rows)[:, 0].tolist()
    got = [(lambda pr: pr[1] * 100 + pr[0])(_kernel_route(int(g), page_rows, page_phys_rows))
           for g in idx]
    assert got == want


def test_bulk_plan_shapes_of_the_path():
    # 3,000 frames of 52,800 B on 132 SMs: a third of a frame a stage,
    # twelve stages in 211,328 B of shared memory, one block an SM.
    assert tg.bulk_plan(52_800, 3000, 132) == (17_600, 3, 12, 132, 211_328)
    # The first rows go out in step: at the start every block is on one of
    # the first 44 output rows.
    assert {block_items(j, 9000, 132)[0] // 3 for j in range(132)} == set(range(44))
    # A chunk that does not divide the row: two of 11,744 B and an 11,728-B tail.
    chunk, per_row, *_ = tg.bulk_plan(35_216, 3000, 132)
    assert (chunk, per_row, 35_216 - (per_row - 1) * chunk) == (11_744, 3, 11_728)


@pytest.mark.parametrize("row_bytes", [0, 8, 52_804])
def test_bulk_plan_rejects_unaligned_rows(row_bytes):
    with pytest.raises(ValueError):
        tg.bulk_plan(row_bytes, 10, 132)
