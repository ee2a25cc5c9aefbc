"""cilrs_tpu_torch on an NVIDIA GPU: the CUDA kernels against their plain
versions, which run on CPU copies of the same inputs.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel has
no CPU mode). This file imports nothing of JAX, so it also runs on a machine
with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cilrs_tpu_torch.data.dataset import make_synthetic_dataset  # noqa: E402
from cilrs_tpu_torch.data.resident import ship_resident  # noqa: E402
from cilrs_tpu_torch.ops import gather as tg  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("num_pages,dtype", [(1, torch.uint8), (2, torch.uint8), (3, torch.float32)])
def test_gather_kernel_matches_plain(cuda_device, num_pages, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(num_pages)
    page_rows, width = 300, 1312
    pages = tuple(torch.randint(0, 256, (page_rows + (7 if p < num_pages - 1 else -50), width),
                                generator=g, device=cuda_device).to(dtype)
                  for p in range(num_pages))
    idx = torch.randint(-20, page_rows * num_pages + 20, (517,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    before = tg.gather_rows_paged.launches
    got = tg.gather_rows_paged(pages, idx, page_rows)
    torch.cuda.synchronize()
    assert tg.gather_rows_paged.launches == before + 1
    want = tg.gather_rows_plain(tuple(p.cpu() for p in pages), idx.cpu(), page_rows)
    assert torch.equal(got.cpu(), want)


def test_gather_kernel_rejects_unaligned_rows(cuda_device):
    table = torch.zeros((8, 45), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="16"):
        tg.gather_rows(table, torch.zeros(2, dtype=torch.int32, device=cuda_device))


def test_ship_resident_on_card_matches_cpu(cuda_device):
    ds = make_synthetic_dataset(64, seed=3, h=32, w=64)
    idx = np.random.RandomState(4).permutation(64)
    gpu = ship_resident(ds, cuda_device, max_page_bytes=20 * 32 * 64 * 3)
    cpu = ship_resident(ds, "cpu", max_page_bytes=20 * 32 * 64 * 3)
    assert len(gpu["images"]) == len(cpu["images"]) == 4
    got = tg.gather_rows_paged(gpu["images"], torch.from_numpy(idx).to(cuda_device), gpu["page_rows"])
    want = tg.gather_rows_paged(cpu["images"], torch.from_numpy(idx), cpu["page_rows"])
    assert torch.equal(got.cpu(), want)
