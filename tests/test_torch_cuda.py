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

from cilrs_tpu_torch import config as tc  # noqa: E402
from cilrs_tpu_torch.agent.driver import fleet_rollout  # noqa: E402
from cilrs_tpu_torch.agent.npc import draw_pedestrians  # noqa: E402
from cilrs_tpu_torch.bench import env_steps, hash_sets  # noqa: E402
from cilrs_tpu_torch.data.collect import make_collect_fleet  # noqa: E402
from cilrs_tpu_torch.data.dataset import make_synthetic_dataset  # noqa: E402
from cilrs_tpu_torch.data.resident import labels_dataset, ship_resident  # noqa: E402
from cilrs_tpu_torch.maps.town import make_mini_town  # noqa: E402
from cilrs_tpu_torch.ops import gather as tg  # noqa: E402
from cilrs_tpu_torch.ops import image as timg  # noqa: E402
from cilrs_tpu_torch.ops import sinf as tsinf  # noqa: E402
from cilrs_tpu_torch.train.loop import train  # noqa: E402

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


# Edge cases of the persistent grid and the ring: (rows, row width, dtype,
# pages, B, chunk bytes). A chunk size other than None is launched through the
# library directly under that plan; the others go through the wrapper.
EDGE_CASES = {
    "b0": (64, 52_800, torch.uint8, 1, 0, None),
    "b1": (64, 52_800, torch.uint8, 2, 1, None),
    "b_under_sms": (64, 52_800, torch.uint8, 2, 37, None),
    "rows_16_bytes": (500, 16, torch.uint8, 2, 3000, None),
    "uneven_chunks_52800": (400, 52_800, torch.uint8, 2, 517, 7_552),
    "uneven_tail_35216": (400, 35_216, torch.uint8, 2, 517, None),
    "f32_3_pages_4096_bytes": (300, 1024, torch.float32, 3, 3000, None),
}


def _launch_with_chunk(pages, idx, page_rows, chunk_bytes):
    """The kernel under a plan of ``chunk_bytes`` chunks, as the wrapper would
    launch it with its own plan."""
    lib, _ = tg._library()
    dev = pages[0].device
    row_bytes = pages[0].shape[1] * pages[0].element_size()
    _, _, _, grid, _ = tg.bulk_plan(row_bytes, idx.shape[0], tg._num_sms(dev.index))
    per_row = -(-row_bytes // chunk_bytes)
    stages = min(tg.MAX_STAGES, tg.RING_BYTES // chunk_bytes)
    grid = min(grid, idx.shape[0] * per_row)
    ptrs, rows = tg._page_table(tuple(p.data_ptr() for p in pages),
                                tuple(p.shape[0] for p in pages))
    out = torch.empty((idx.shape[0], pages[0].shape[1]), dtype=pages[0].dtype, device=dev)
    status = lib.gather_rows_launch(
        ptrs, rows, len(pages), page_rows, idx.data_ptr(), idx.shape[0], out.data_ptr(),
        row_bytes, chunk_bytes, per_row, stages, grid, tg.BARRIER_BYTES + stages * chunk_bytes,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    assert status == 0, lib.gather_rows_error_string(status).decode()
    return out


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_gather_kernel_edge_cases(cuda_device, case):
    rows, width, dtype, num_pages, b, chunk_bytes = EDGE_CASES[case]
    row_bytes = width * torch.empty((), dtype=dtype).element_size()
    plan_chunk, per_row, *_ = tg.bulk_plan(row_bytes, b, 132)
    if case.startswith("uneven"):  # the last chunk of each row is shorter
        assert per_row * (chunk_bytes or plan_chunk) != row_bytes
    g = torch.Generator(device=cuda_device).manual_seed(b)
    page_rows = rows // num_pages
    pages = tuple(torch.randint(0, 256, (page_rows + (3 if p < num_pages - 1 else 0), width),
                                generator=g, device=cuda_device).to(dtype)
                  for p in range(num_pages))
    idx = torch.randint(-5, rows + 5, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    before = tg.gather_rows_paged.launches
    if chunk_bytes is None:
        got = tg.gather_rows_paged(pages, idx, page_rows)
    else:
        got = _launch_with_chunk(pages, idx, page_rows, chunk_bytes)
    torch.cuda.synchronize()
    assert got.shape == (b, width) and got.dtype == dtype
    assert tg.gather_rows_paged.launches == before + (1 if b and chunk_bytes is None else 0)
    want = tg.gather_rows_plain(tuple(p.cpu() for p in pages), idx.cpu(), page_rows)
    assert torch.equal(got.cpu(), want)


def test_gather_kernel_rejects_unaligned_rows(cuda_device):
    table = torch.zeros((8, 45), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="16"):
        tg.gather_rows(table, torch.zeros(2, dtype=torch.int32, device=cuda_device))


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(got.cpu().view(torch.int32),
                                                   want.cpu().view(torch.int32))


@pytest.mark.parametrize("name", hash_sets.SETS)
def test_hash_sinf_kernel_matches_plain(cuda_device, name):
    """The kernel against the plain version on each hash set, bit for bit
    (the plain version is held to jitted jnp.sin in tests/test_torch_sinf.py);
    one launch a call."""
    t = torch.from_numpy(hash_sets.argument_set(name))
    before = tsinf.hash_sinf.launches
    got = hash_sets.port_hash(name, t.to(cuda_device))
    torch.cuda.synchronize()
    assert tsinf.hash_sinf.launches == before + 1
    assert got.device.type == "cuda" and _same_bits(got, hash_sets.port_hash(name, t))


def test_hash_sinf_kernel_on_every_exponent(cuda_device):
    """4M random bit patterns (every exponent, infinities and NaNs among
    them), strided x and y, each argument form, an empty tensor."""
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(-2 ** 31, 2 ** 31, (2 ** 22,), generator=g, dtype=torch.int64)
    x = bits.to(torch.int32).view(torch.float32)
    assert _same_bits(tsinf.hash_sinf(x.to(cuda_device), 1.0), tsinf.hash_sinf_plain(x, 1.0))
    q = torch.floor(torch.rand((32, 17_600, 2), generator=g) * 2e5 - 1e5)
    qc = q.to(cuda_device)
    for y, yc in ((None, None), (78.233, 78.233), (q[..., 1], qc[..., 1]),
                  (q[..., 1] * 78.233, qc[..., 1] * 78.233)):
        assert _same_bits(tsinf.hash_sinf(qc[..., 0], 12.9898, yc),
                          tsinf.hash_sinf_plain(q[..., 0], 12.9898, y))
    empty = tsinf.hash_sinf(torch.empty(0, 3, device=cuda_device), 1.0)
    assert empty.shape == (0, 3) and empty.device.type == "cuda"


# The fused sin hashes: the call, its plain version, the input's trailing
# shape (the grain's points are pairs) and the output's shape at a 32-env
# tick. Each entry point counts its launches on itself.
SIN_HASH_ENTRY_POINTS = {
    "hash01": (lambda x: tsinf.hash01(x, tsinf.HASH_A, tsinf.HASH_C, tsinf.HASH_SCALE),
               lambda x: tsinf.hash01_plain(x, tsinf.HASH_A, tsinf.HASH_C, tsinf.HASH_SCALE),
               (), (32, 88, 200)),
    "grain_texture": (tsinf.grain_texture, tsinf.grain_texture_plain, (2,), (32, 17_600)),
    "reverse_steer": (tsinf.reverse_steer, tsinf.reverse_steer_plain, (), (32,)),
}


def _launches(name: str) -> int:
    return getattr(tsinf, name).launches


def _sin_hash_inputs(name: str, n: int, g: torch.Generator) -> torch.Tensor:
    """n elements of the hash's input, as a tick makes them: streak columns
    plus a time offset, ground points up to 2 km away, recovery starts up to
    1,200 s; with an infinity and a NaN among them where n allows."""
    trail = SIN_HASH_ENTRY_POINTS[name][2]
    u = torch.rand((n, *trail), generator=g)
    if name == "hash01":
        x = torch.floor(u * 60.0) + torch.floor(torch.rand(n, generator=g) * 2e3)
    else:
        x = u * 4e3 - 2e3 if name == "grain_texture" else u * 1.2e3
    if n > 8:
        x[3], x[7] = float("inf"), float("nan")
    return x


@pytest.mark.parametrize("name", SIN_HASH_ENTRY_POINTS)
def test_sin_hash_kernels_match_plain(cuda_device, name):
    """Each fused hash against its plain version on the CPU, bit for bit (NaN
    as 0x7fc00000 on both): at a 32-env tick's shape, at n = 1, 3 and 1,001
    (not whole groups of four), on views whose data start 4 and 8 B past a
    16-B boundary (a scalar head; for the grain's pairs at 4 B, every point
    scalar), and empty; one launch a call, none when empty."""
    fn, plain, trail, tick = SIN_HASH_ENTRY_POINTS[name]
    g = torch.Generator().manual_seed(5)
    n_tick = int(np.prod(tick))
    cases = {"tick": _sin_hash_inputs(name, n_tick, g).reshape(*tick, *trail)}
    for n in (1, 3, 1001):
        cases[f"n={n}"] = _sin_hash_inputs(name, n, g)
    flat = _sin_hash_inputs(name, 4099, g).reshape(-1).to(cuda_device)
    width = max(1, int(np.prod(trail)))
    for skip in (1, 2):  # floats: 4 and 8 B past the allocation's alignment
        m = (flat.numel() - skip) // width
        cases[f"offset_{4 * skip}B"] = flat[skip:skip + m * width].view(m, *trail)
    for case, x in cases.items():
        xc = x.to(cuda_device)
        before = _launches(name)
        got = fn(xc)
        torch.cuda.synchronize()
        assert _launches(name) == before + 1, case
        assert got.device.type == "cuda" and _same_bits(got, plain(x.cpu())), case
    before = _launches(name)
    empty = fn(torch.empty((0, *trail), device=cuda_device))
    assert empty.shape == (0,) and empty.device.type == "cuda" and _launches(name) == before


# The headline run's shapes: 128 envs (bench.py's fleet).
BENCH_SHAPES = {"hash01": (128, 88, 200), "grain_texture": (128, 17_600), "reverse_steer": (128,)}


@pytest.mark.parametrize("name", SIN_HASH_ENTRY_POINTS)
def test_sin_hash_kernels_match_plain_at_128_envs(cuda_device, name):
    """Each fused hash at a 128-env tick's shape against its plain version on
    the CPU, bit for bit, in one launch."""
    fn, plain, trail, _ = SIN_HASH_ENTRY_POINTS[name]
    shape = BENCH_SHAPES[name]
    x = _sin_hash_inputs(name, int(np.prod(shape)), torch.Generator().manual_seed(7))
    x = x.reshape(*shape, *trail)
    before = _launches(name)
    got = fn(x.to(cuda_device))
    torch.cuda.synchronize()
    assert _launches(name) == before + 1
    assert got.shape == shape and _same_bits(got, plain(x))


@pytest.mark.parametrize("name", SIN_HASH_ENTRY_POINTS)
def test_sin_hash_kernels_refuse_strided_input(cuda_device, name):
    """A strided input on the card raises and launches nothing (the plain
    version never runs on a CUDA tensor)."""
    fn, _, trail, _ = SIN_HASH_ENTRY_POINTS[name]
    x = torch.zeros((8, 6, *trail), device=cuda_device)[:, :5]
    before = _launches(name)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x)
    assert _launches(name) == before


def test_ship_resident_on_card_matches_cpu(cuda_device):
    ds = make_synthetic_dataset(64, seed=3, h=32, w=64)
    idx = np.random.RandomState(4).permutation(64)
    gpu = ship_resident(ds, cuda_device, max_page_bytes=20 * 32 * 64 * 3)
    cpu = ship_resident(ds, "cpu", max_page_bytes=20 * 32 * 64 * 3)
    assert len(gpu["images"]) == len(cpu["images"]) == 4
    got = tg.gather_rows_paged(gpu["images"], torch.from_numpy(idx).to(cuda_device), gpu["page_rows"])
    want = tg.gather_rows_paged(cpu["images"], torch.from_numpy(idx), cpu["page_rows"])
    assert torch.equal(got.cpu(), want)


def test_train_steps_on_card_count_gather_launches(cuda_device):
    """A few train steps from a 2-page resident table on the card: every
    train group and every eval group is one kernel launch, and the losses
    are finite."""
    ds = make_synthetic_dataset(400, seed=5, h=32, w=64)
    table = ship_resident(ds, cuda_device, max_page_bytes=250 * 32 * 64 * 3)
    assert len(table["images"]) == 2
    cfg = tc.TrainConfig(model=tc.ModelConfig(stage_sizes=(1, 1, 1, 1)),
                         training=tc.TrainingConfig(batch_size=16, epochs=1))
    labels = {"speed": ds.speed_norm, "command": ds.command, "controls": ds.controls}
    before = tg.gather_rows_paged.launches
    out = train(labels_dataset(labels), cfg, device=cuda_device, steps_per_epoch=30,
                verbose=False, resident=table)
    torch.cuda.synchronize()
    # 30 steps = groups of 25 + 5; 60 val rows = 3 batches, one eval group,
    # on the EMA and on the raw iterate.
    assert tg.gather_rows_paged.launches - before == 2 + 2
    assert out["state"].step == 30 and out["state"].model.visual_encoder[0].weight.is_cuda
    assert np.all(np.isfinite(out["group_losses"])) and np.isfinite(out["best_val_loss"])


def test_augment_on_card_matches_cpu(cuda_device):
    """The augmentation on the card against the CPU on the same draws (the
    tolerance of tests/test_torch_augment.py: at most 1e-4 of the values
    beyond 1e-5)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((64, 88, 200, 3), generator=gen, device=cuda_device)
    draws = timg.draw_augment(gen, 64, 88, 200)
    assert all(v.is_cuda for v in draws.values())
    got = timg.apply_augment(x, draws).cpu()
    want = timg.apply_augment(x.cpu(), {k: v.cpu() for k, v in draws.items()})
    assert ((got - want).abs() > 1e-5).float().mean().item() <= 1e-4


def test_collect_rollout_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's collect_check at a small size: one fleet (mini town, 3
    envs in clear, rain and night) for 30 ticks on the card and on the CPU on
    the same pedestrian draws, with the tolerances the CPU tests hold the
    port to the JAX package with (tests/test_torch_agent.py)."""
    net = make_mini_town()
    draws = draw_pedestrians(torch.Generator().manual_seed(3), 30, 3, 2, "cpu")
    outs = []
    for dev in ("cpu", cuda_device):
        f = make_collect_fleet(net, 3, 4, 2, seed=3, chunk_steps=30, device=dev)
        w = torch.tensor([0, 1, 3], device=dev)
        state = f.state.replace(world=f.state.world.replace(weather_idx=w))
        _, o = fleet_rollout(state, 30, f.net, f.pool, f.wt, f.params, draws.to(dev))
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
    cpu, gpu = outs
    for k in ("command", "status", "tp_cause", "tl_state", "route_idx", "completed"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    for k, tol in (("pos", 1e-4), ("yaw", 1e-5), ("speed_kmh", 1e-4), ("control", 1e-5)):
        np.testing.assert_allclose(gpu[k], cpu[k], atol=tol, rtol=0, err_msg=k)
    d = np.abs(gpu["frame"].astype(int) - cpu["frame"].astype(int))
    assert (d > 1).mean() <= 0.005 and d.mean() <= 0.05


def test_collect_chunk_never_waits_for_the_card(cuda_device):
    """A collect chunk issues its ticks without a host sync (CUDA's sync
    checker raises on one), after a warm-up chunk has made its constants."""
    f = make_collect_fleet(make_mini_town(), 2, 4, 2, seed=1, chunk_steps=5, device=cuda_device)
    f.chunk()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = f.chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert outs["frame"].shape == (2, 5, 88, 200, 3) and outs["frame"].is_cuda


def test_bench_chunk_never_waits_for_the_card(cuda_device):
    """bench.env_steps's drive chunk (8 envs, the full-width CILRS in bf16)
    issues its ticks without a host sync (CUDA's sync checker raises on
    one), after a warm-up chunk; its sin hashes launch 4 times a tick."""
    fleet = env_steps.make_bench_fleet(8, 5, cuda_device)
    fleet.chunk()
    torch.cuda.synchronize()
    before = {name: _launches(name) for name in SIN_HASH_ENTRY_POINTS}
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = fleet.chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {name: _launches(name) - before[name] for name in before} == {
        "hash01": 10, "grain_texture": 5, "reverse_steer": 5}
    assert state.world.veh_pos.is_cuda and torch.isfinite(state.world.veh_pos).all()
    assert (state.metrics.total_frames == 10).all()


def test_fused_ring_and_sampler_on_card_match_cpu(cuda_device):
    """The fused loop's ring and sampler on the card against the CPU: the
    same chunks (one wraps the 600-slot ring of 88x200 frames) and the same
    injected draws give a bit-identical ring, bookkeeping, picks and batch,
    and weights within 1e-6; each batch's frames are one launch of the
    row-gather kernel."""
    from cilrs_tpu_torch.train import fused as tf

    rng = np.random.RandomState(0)
    bufs = {d: tf.make_buffer(600, 88, 200, device=d) for d in ("cpu", cuda_device)}
    for m in (320, 320, 150):
        chunk = (rng.randint(0, 256, (m, 88, 200, 3)).astype(np.uint8),
                 rng.uniform(0, 100, m).astype(np.float32), rng.randint(0, 4, m).astype(np.int32),
                 rng.uniform(-1, 1, (m, 3)).astype(np.float32), rng.uniform(size=m) < 0.7)
        for d, buf in bufs.items():
            tf.write_chunk(buf, *(torch.from_numpy(a).to(d) for a in chunk))
    cpu, gpu = bufs["cpu"], bufs[cuda_device]
    assert (gpu.cursor, gpu.filled) == (cpu.cursor, cpu.filled) == (190, 600)
    for f in ("images", "speed", "command", "controls", "valid", "total_written", "cmd_counts"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    for seed in range(3):
        draws = tf.draw_indices(torch.Generator().manual_seed(seed), 120, gpu.filled)
        before = tg.gather_rows_paged.launches
        got = tf.sample_batch(gpu, draws.to(cuda_device))
        torch.cuda.synchronize()
        assert tg.gather_rows_paged.launches == before + 1
        want = tf.sample_batch(cpu, draws)
        for k in want:
            if k == "weights":  # a mean over the batch, summed in another order
                assert torch.allclose(got[k].cpu(), want[k], rtol=0, atol=1e-6)
            else:
                assert torch.equal(got[k].cpu(), want[k]), k


TINY_CFG = tc.TrainConfig(model=tc.ModelConfig(dropout=0.0, image_height=32, image_width=64,
                                               stage_sizes=(1, 1, 1, 1)),
                          training=tc.TrainingConfig(batch_size=16, epochs=1, ema_eval=False))
TINY_LOOP = dict(num_envs=2, num_vehicles=3, num_pedestrians=1, buffer_frames=512, collect_ticks=10,
                 train_steps_per_chunk=2, total_train_steps=4, warmup_chunks=2, seed=0,
                 eval_every=4, verbose=False)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_world_of_one_over_nccl(cuda_device):
    """A world of 1 that the arguments describe joins over NCCL on the card;
    its collectives are exact, and the sharded fused loop in it collects the
    single path's frames on the same seed, its history within 1e-2 (cuDNN's
    backward is not deterministic)."""
    import torch.distributed as dist

    from cilrs_tpu_torch.parallel import distributed as tdist
    from cilrs_tpu_torch.parallel import mesh as tmesh
    from cilrs_tpu_torch.render.camera import CameraSpec
    from cilrs_tpu_torch.train import fused as tf

    try:
        assert tdist.initialize_distributed(f"localhost:{_free_port()}", 1, 0)
        assert dist.get_backend() == "nccl"
        mesh = tmesh.make_mesh()
        assert mesh.device.type == "cuda" and mesh.world == 1
        x = torch.arange(10.0, device=cuda_device)
        tmesh.all_reduce_mean_(mesh, [x[:3], x[3:]])
        tmesh.replicate(mesh, [x])
        assert torch.equal(x, torch.arange(10.0, device=cuda_device))
        assert torch.equal(tmesh.all_gather(mesh, {"x": x})["x"], x) and mesh.collectives == 3
        runs = [tf.fused_collect_train(make_mini_town(), TINY_CFG, cam=CameraSpec(width=64, height=32),
                                       mesh=m, device=cuda_device, **TINY_LOOP)
                for m in (mesh, None)]
        assert mesh.collectives > 3
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sharded, single = runs
    assert sharded["frames_collected"] == single["frames_collected"] > 0
    for a, b in zip(sharded["history"], single["history"], strict=True):
        assert a["frames"] == b["frames"]
        assert abs(a["val_loss"] - b["val_loss"]) <= 1e-2 * abs(b["val_loss"])


def _two_ranks_on_one_card(rank: int, port: int, out: str):
    import torch.distributed as dist

    from cilrs_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    try:
        mesh = make_mesh(2)
        ds = make_synthetic_dataset(160, seed=9, h=32, w=64)
        res = train(ds, TINY_CFG, steps_per_epoch=6, verbose=False, device=mesh.device, mesh=mesh)
        torch.save({"history": res["history"],
                    "state": {k: v.cpu() for k, v in res["state"].model.state_dict().items()}},
                   f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_ranks_on_one_card_over_gloo(cuda_device, tmp_path):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one GPU):
    six steps of the train loop's data-parallel branch against world 1 on
    the card, within 3% on the losses (tests/test_parallel.py:176-185), and
    the two ranks' weights bit-identical."""
    import torch.multiprocessing as tmp

    tmp.spawn(_two_ranks_on_one_card, args=(_free_port(), str(tmp_path)), nprocs=2)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    one = train(make_synthetic_dataset(160, seed=9, h=32, w=64), TINY_CFG, steps_per_epoch=6,
                verbose=False, device=cuda_device)["history"][0]
    for k in ("val_loss", "train_loss"):
        assert abs(got[0]["history"][0][k] - one[k]) < 0.03 * max(1.0, abs(one[k]))
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k


# ---------------------------------------------------------------------------
# The ported tools' reads on the card (tools/exp_*, graft_entry)
# ---------------------------------------------------------------------------

FRAME_ROW = 52_800  # an 88x200x3 u8 frame


def _frame_table(dev, page_rows: int, logical: tuple, slack: int = 29, seed: int = 7) -> dict:
    """A paged u8 table of full-size frames on ``dev``: ``logical`` rows a
    page, each page with ``slack`` rows after them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = tuple(torch.randint(0, 256, (n + slack, FRAME_ROW), generator=g, device=dev,
                                dtype=torch.uint8) for n in logical)
    n = sum(logical)
    rng = np.random.RandomState(seed)
    return {"images": pages, "page_rows": page_rows, "image_shape": (88, 200, 3),
            "speed": torch.from_numpy(rng.uniform(0, 0.4, n).astype(np.float32)).to(dev),
            "command": torch.from_numpy(rng.randint(0, 4, n).astype(np.int32)).to(dev),
            "controls": torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)).to(dev)}


def _on_cpu(table: dict) -> dict:
    return {k: (tuple(p.cpu() for p in v) if k == "images" else
                v.cpu() if torch.is_tensor(v) else v) for k, v in table.items()}


def test_audit_checksums_on_card_across_a_page_boundary(cuda_device):
    """exp_checksum's sums through the gather kernel over two pages (128
    rows a launch, one launch across the boundary) against plain slices on
    the CPU, exact; the read audit finds no row."""
    from cilrs_tpu_torch.tools import exp_checksum

    table = _frame_table(cuda_device, 300, (300, 250))
    pages, cpu_pages, n = table["images"], _on_cpu(table)["images"], 550
    before = tg.gather_rows_paged.launches
    s_g, h_g = exp_checksum.checksums_gather(pages, 300, n, 128)
    assert tg.gather_rows_paged.launches == before + 5
    s_d, h_d = exp_checksum.checksums_slice(cpu_pages, 300, n, 128)
    np.testing.assert_array_equal(s_g, s_d)
    np.testing.assert_array_equal(h_g, h_d)
    assert len(exp_checksum.read_audit(pages, 300, n, 128)) == 0


def test_paged_audit_sweep_on_card_matches_cpu(cuda_device):
    from cilrs_tpu_torch.tools import exp_paged_audit

    table = _frame_table(cuda_device, 300, (300, 250), seed=8)
    bad, means = exp_paged_audit.sweep(table, 550, 128)
    bad_cpu, means_cpu = exp_paged_audit.sweep(_on_cpu(table), 550, 128)
    assert bad == bad_cpu == 0
    np.testing.assert_array_equal(means, means_cpu)


def test_image_stats_on_card_match_cpu(cuda_device):
    """exp_image_stats's picks read through the kernel (one launch a cell)
    give the CPU's statistics exactly."""
    from cilrs_tpu_torch.tools import exp_image_stats

    table = _frame_table(cuda_device, 300, (300, 250), seed=9)
    labels = {"env": (np.arange(550) % 16).astype(np.int32)}
    before = tg.gather_rows_paged.launches
    got = exp_image_stats.image_stats(table, labels, 20)
    assert tg.gather_rows_paged.launches == before + 5
    assert got == exp_image_stats.image_stats(_on_cpu(table), labels, 20)


def test_cross_eval_on_card_matches_collect_predictions(cuda_device):
    """exp_cross_eval's groups (one launch, the last group padded) against
    collect_predictions_resident on the same rows and model, bf16 on the
    card: within 1e-5."""
    from cilrs_tpu_torch.evaluation.report import collect_predictions_resident
    from cilrs_tpu_torch.models.cilrs import CILRS
    from cilrs_tpu_torch.tools import exp_cross_eval

    table = _frame_table(cuda_device, 700, (700, 510), seed=10)
    model = CILRS(dropout=0.0, stage_sizes=(1, 1, 1, 1)).to(
        cuda_device, memory_format=torch.channels_last).eval()
    labels = {k: v.cpu().numpy() for k, v in table.items() if k in ("speed", "command", "controls")}
    before = tg.gather_rows_paged.launches
    preds = exp_cross_eval.score_rows(model, table, 1210)
    assert tg.gather_rows_paged.launches == before + 1 and preds.shape == (1200, 3)
    ref, _, _ = collect_predictions_resident(model, table, labels, np.arange(1200), 120,
                                             tc.TrainConfig())
    np.testing.assert_allclose(preds, ref[:, :3], rtol=0, atol=1e-5)


def test_graft_entry_on_card_matches_its_cpu_run(cuda_device):
    """graft_entry.entry() on the card (bf16 trunk, float32 heads with TF32
    off) against entry("cpu") (float32) on the same weights and inputs:
    full_size's bf16 tolerance, 5% of the largest output and a correlation
    of 0.99."""
    from cilrs_tpu_torch import graft_entry

    fn, args = graft_entry.entry(cuda_device)
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    assert all(a.device.type == "cuda" for a in args) and [a.shape for a in args] == [
        a.shape for a in cpu_args]
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(args[0].shape, generator=g) * 4 - 2, torch.rand(args[1].shape, generator=g),
         torch.randint(0, 4, args[2].shape, generator=g, dtype=torch.int32))
    for got, want in zip(fn(*(t.to(cuda_device) for t in x)), cpu_fn(*x)):
        got = got.float().cpu()
        assert (got - want).abs().max() <= 0.05 * want.abs().max()
        assert np.corrcoef(got.flatten().numpy(), want.flatten().numpy())[0, 1] >= 0.99


def test_probe_checksums_on_card_match_cpu(cuda_device):
    """The probes' uint32 checksums in int64 wrap arithmetic on the card
    against the CPU, exactly: a 25-batch group's image and label checksums,
    the weighted checksums, and each page's hash (through the kernel, one
    launch for the group)."""
    from cilrs_tpu_torch.data.resident import gather_group
    from cilrs_tpu_torch.tools import probes

    table = _frame_table(cuda_device, 300, (300, 250), seed=11)
    cpu = _on_cpu(table)
    idxs = np.random.RandomState(0).randint(0, 550, size=(25, 12))
    before = tg.gather_rows_paged.launches
    got, want = gather_group(table, idxs), gather_group(cpu, idxs)
    assert tg.gather_rows_paged.launches == before + 1
    for i in range(25):
        g, w = ({k: v[i * 12:(i + 1) * 12] for k, v in b.items()} for b in (got, want))
        assert int(probes.image_checksum(g["images"])) == int(probes.image_checksum(w["images"]))
        assert int(probes.label_checksum(g)) == int(probes.label_checksum(w))
    np.testing.assert_array_equal(probes.weighted_checksums(got["images"], 25),
                                  probes.weighted_checksums(want["images"], 25))
    for pg, pc in zip(table["images"], cpu["images"]):
        assert probes.page_hash(pg) == probes.page_hash(pc)


def test_row_means_on_card_match_cpu(cuda_device):
    """exp_table_integrity's row means over a two-page table, 128 rows a
    launch across the page boundary: the card's equal the CPU's."""
    from cilrs_tpu_torch.tools import exp_table_integrity

    table = _frame_table(cuda_device, 300, (300, 250), seed=12)
    before = tg.gather_rows_paged.launches
    got = exp_table_integrity.row_means(table, 550, 128)
    assert tg.gather_rows_paged.launches == before + 5
    np.testing.assert_array_equal(got, exp_table_integrity.row_means(_on_cpu(table), 550, 128))


def test_page2_identity_on_card(cuda_device):
    """exp_page2_identity at a small size on the card (a (1, 1, 1, 1) CILRS
    at batch 8 on full-size frames), under the deterministic settings: the
    runs A, A' (A again), B and C train the same weights bit for bit, and
    the settings are restored afterwards."""
    from cilrs_tpu_torch.tools import exp_page2_identity

    n = 600
    table = _frame_table(cuda_device, n, (n,), seed=13)
    labels = {k: v.cpu().numpy() for k, v in table.items() if k in ("speed", "command",
                                                                      "controls")}
    cfg = tc.TrainConfig(model=tc.ModelConfig(stage_sizes=(1, 1, 1, 1)),
                         training=tc.TrainingConfig(batch_size=8))
    prior = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    page = table["images"][0]
    got = exp_page2_identity.identity(page, page.clone(), table, labels, n, cfg, 1, cuda_device,
                                      runs=("A", "A'", "B", "C"))
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == prior
    assert got["groups"] == 1
    for pair in ("AA2", "AB", "BC"):
        assert got[f"params_equal_{pair}"] and got[f"losses_equal_{pair}"], (pair, got)
