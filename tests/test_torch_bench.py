"""Parity of the port's headline run, ``cilrs_tpu_torch.bench.env_steps``,
with the repo's ``bench.py``, and of ``fleet_rollout``'s ``want_frames``
with the JAX function's.

 - the fleet: ``bench.py``'s own code builds its fleet (its ``main`` runs
   until it asks for the train state, and the test reads the fleet it
   built); the port's ``make_bench_fleet`` equals it in every field but the
   JAX world's PRNG keys, exactly, and so do the route pool and the network;
 - one drive chunk (E = 5, T = 3) against JAX's ``fleet_rollout(mode="drive",
   want_frames=False)`` on the same fleet, the same weights (a (1, 1, 1, 1)
   CILRS, float32 on both sides, JAX's init from PRNGKey(0) as bench.py's
   ``create_train_state`` draws it, carried across by ``models.convert``) and JAX's pedestrian draws: tests/test_torch_drive.py's
   tolerances, integers exact, positions 1e-4 m, speeds 1e-4, yaws 1e-5, the
   metrics 1e-4; the controls and the safety controller's smoothing buffers,
   which the policy's controls feed, within 1e-3, the real CILRS's tolerance
   there (tests/test_torch_model.py: both packages round the branch heads'
   first product to bf16), and so the last steer of the metrics; their
   steering jerk, a sum of |steer change| over the 3 ticks, within 2e-3 a
   tick;
 - ``want_frames=False``: the output keys equal JAX's in collect and drive
   mode, and collect mode calls no render;
 - ``main``'s JSON line: ``bench.py``'s metric and keys but ``vs_baseline``,
   plus the device, the card and its power limit (none on the CPU);
 - two gloo ranks on localhost, E = 4, T = 2: the final fleet equals a
   world of 1's, integers exactly and floats within 1e-6 (each rank runs
   the policy at batch 2 where a world of 1 runs it at batch 4, and the
   CPU's convolutions then sum in another order: measured 3.7e-9 on the
   controls), and the unit says "per chip of 2";
 - with no GPU, the entry points raise unless they are given the CPU.
"""

import dataclasses
import importlib.util
import json
import os
import socket
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import cilrs_tpu.cli.common as j_common  # noqa: E402
import cilrs_tpu.train.state as j_state  # noqa: E402
from cilrs_tpu.agent import driver as jd  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.render.camera import CameraSpec as JCam  # noqa: E402
from cilrs_tpu_torch.agent import driver as td  # noqa: E402
from cilrs_tpu_torch.bench import env_steps  # noqa: E402
from cilrs_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from cilrs_tpu_torch.core.state import tree_map  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.render.camera import CameraSpec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(dropout=0.0, stage_sizes=(1, 1, 1, 1))
E_FLEET, E_CHUNK, T_CHUNK = 7, 5, 3
# tests/test_torch_drive.py's rollout tolerances by leaf name; the leaves
# the policy's controls feed take the real CILRS's 1e-3.
TOL = {"veh_pos": 1e-4, "stuck_anchor_pos": 1e-4, "move_anchor_pos": 1e-4, "veh_speed": 1e-4,
       "veh_yaw": 1e-5, "ped_pos": 1e-4, "ped_yaw": 1e-5, "veh_control": 1e-3,
       "steer_buf": 1e-3, "throttle_buf": 1e-3}
# The metrics within 1e-4, but those of the steer: the last within the
# controls' 1e-3, the jerk (a sum of |steer change| over the chunk's ticks)
# within two of those a tick.
RANKS_TOL = 1e-6
METRICS_TOL = {"last_steer": 1e-3, "jerk_sum": 2 * T_CHUNK * 1e-3}


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy)
    (``cilrs_tpu/maps/routing.py:155-164``); each test starts and ends with
    that cache empty."""
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


class _Built(Exception):
    """Stops bench.py's main once its fleet is built."""


def bench_py_fleet(num_envs: int) -> dict:
    """The locals of ``bench.py``'s main when it asks for the train state:
    its fleet, network, pool, weather table and vehicle params, built by
    bench.py's own code with ``BENCH_ENVS=num_envs``."""
    spec = importlib.util.spec_from_file_location("_bench_py", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    seen = {}

    def stop(*args, **kwargs):
        seen.update(sys._getframe(1).f_locals)
        raise _Built

    mp = pytest.MonkeyPatch()
    mp.setenv("BENCH_ENVS", str(num_envs))
    mp.setattr(j_common, "enable_compilation_cache", lambda *a, **k: None)
    mp.setattr(j_state, "create_train_state", stop)
    try:
        with pytest.raises(_Built):
            bench.main()
    finally:
        mp.undo()
    return seen


def tree_np(x):
    """A JAX tree as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "host"}
    return np.asarray(x)


def assert_tree_close(got, want, name="", tol=None):
    """A port dataclass of tensors against a JAX tree's numpy dict (or
    another port tree), over the port's fields: integers and booleans
    exactly, floats within ``tol[leaf]``, or ``tol`` when it is a number
    (exactly where ``tol`` is None or names no bound)."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            w = want[f.name] if isinstance(want, dict) else getattr(want, f.name)
            assert_tree_close(getattr(got, f.name), w, f"{name}.{f.name}", tol)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, name
    atol = tol if isinstance(tol, float) else (tol or {}).get(name.split(".")[-1])
    if g.dtype.kind in "biu" or atol is None:
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    else:
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def jax_draws(keys, steps: int, P: int) -> torch.Tensor:
    """The uniforms of JAX's pedestrian re-aim, tick by tick: [T, E, P]."""
    def one(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]
    return torch.tensor(np.asarray(jax.vmap(one)(keys)).transpose(1, 0, 2))


def tiny_policy(device):
    """bench.py's policy cut to a (1, 1, 1, 1) trunk, for the tests that do
    not compare the policy: random weights from the bench's seed."""
    from cilrs_tpu_torch.train.state import create_train_state

    model = create_train_state(TrainConfig(model=TINY), env_steps.SEED, device=device).model
    return td.model_policy(model.eval())


@pytest.fixture
def tiny_bench(monkeypatch):
    monkeypatch.setattr(env_steps, "bench_policy", tiny_policy)


def tiny_variables():
    """The (1, 1, 1, 1) CILRS (float32) with JAX's init from PRNGKey(0), as
    bench.py's ``create_train_state`` makes its random weights, and the
    port's CILRS with the same weights."""
    jm = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=TINY.stage_sizes, speed_skip=True)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 88, 200, 3)),
                               jnp.zeros((1,)), jnp.zeros((1,), jnp.int32)))
    model = CILRS(dropout=0.0, dtype=torch.float32, stage_sizes=TINY.stage_sizes, speed_skip=True)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    return jm, v, model.eval()


# ---------------------------------------------------------------------------
# The fleet and the chunk
# ---------------------------------------------------------------------------


def test_bench_fleet_matches_bench_py(tiny_bench):
    want = bench_py_fleet(E_FLEET)
    got = env_steps.make_bench_fleet(E_FLEET, 2, "cpu")
    jfleet = tree_np(want["fleet"])
    assert jfleet["world"].pop("rng").shape == (E_FLEET, 2)  # the JAX PRNG keys: no counterpart
    assert_tree_close(got.state, jfleet, "fleet")
    np.testing.assert_array_equal(got.state.world.weather_idx.numpy(), np.arange(E_FLEET) % 5)
    assert_tree_close(got.pool, tree_np(want["pool"]), "pool")
    for k, w in tree_np(want["net"]).items():
        np.testing.assert_array_equal(getattr(got.net, k).numpy(), w.astype(np.asarray(
            getattr(got.net, k).numpy()).dtype), err_msg=k)
    assert_tree_close(got.params, tree_np(want["params"]), "params")
    assert_tree_close(got.wt, tree_np(want["wt"]), "wt")
    assert (want["E"], want["T"], want["REPS"]) == (E_FLEET, 50, 5) == (
        E_FLEET, *env_steps.bench_shape()[1:])


@pytest.fixture(scope="module")
def chunk_pair():
    """(JAX's final fleet, the port's) after one bench chunk on the same
    fleet, weights and pedestrian draws."""
    want = bench_py_fleet(E_CHUNK)
    jm, v, model = tiny_variables()

    def chunk(st, net_, pool_, variables_):
        return jd.fleet_rollout(st, steps=T_CHUNK, net=net_, pool=pool_, wt=want["wt"],
                                params=want["params"], apply_fn=jm.apply, variables=variables_,
                                mode="drive", want_frames=False)

    jfinal, jouts = jax.jit(chunk)(want["fleet"], want["net"], want["pool"], v)
    draws = jax_draws(want["fleet"].world.rng, T_CHUNK, env_steps.NUM_PEDESTRIANS)
    mp = pytest.MonkeyPatch()
    mp.setattr(env_steps, "bench_policy", lambda dev: td.model_policy(model))
    mp.setattr(env_steps, "draw_pedestrians", lambda gen, T, E, P, dev: draws)
    try:
        fleet = env_steps.make_bench_fleet(E_CHUNK, T_CHUNK, "cpu")
        final = fleet.chunk()
    finally:
        mp.undo()
    return tree_np(jfinal), {k: np.asarray(o) for k, o in jouts.items()}, final


def test_bench_chunk_matches_jax(chunk_pair):
    want, jouts, got = chunk_pair
    metrics = want.pop("metrics")
    want["world"].pop("rng")
    for f in dataclasses.fields(got):
        if f.name != "metrics":
            assert_tree_close(getattr(got, f.name), want[f.name], f.name, TOL)
    for name, w in metrics.items():
        np.testing.assert_allclose(getattr(got.metrics, name).numpy(), w,
                                   atol=METRICS_TOL.get(name, 1e-4), rtol=1e-6, err_msg=name)
    # The chunk drove: every env moved, in its own weather.
    assert (np.asarray(metrics["total_frames"]) == T_CHUNK).all()
    assert "frame" not in jouts and jouts["control"].shape == (T_CHUNK, E_CHUNK, 3)


# ---------------------------------------------------------------------------
# want_frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["collect", "drive"])
def test_want_frames_off_keys_match_jax(mode, tiny_bench, monkeypatch):
    jm, v, model = tiny_variables()
    want = bench_py_fleet(2)
    jcam, cam = JCam(width=64, height=32), CameraSpec(width=64, height=32)
    _, jouts = jax.eval_shape(lambda st: jd.fleet_rollout(
        st, steps=1, net=want["net"], pool=want["pool"], wt=want["wt"], params=want["params"],
        apply_fn=jm.apply, variables=v, mode=mode, cam=jcam, want_frames=False), want["fleet"])
    fleet = env_steps.make_bench_fleet(2, 1, "cpu")
    pool = tree_map(lambda x: x.expand((2,) + x.shape), fleet.pool)
    draws = torch.zeros((1, 2, env_steps.NUM_PEDESTRIANS))
    kw = dict(mode=mode, cam=cam, policy=td.model_policy(model))
    if mode == "collect":  # no render at all
        monkeypatch.setattr(td, "render_frame", lambda *a, **k: pytest.fail("rendered"))
    _, outs = td.fleet_rollout(fleet.state, 1, fleet.net, pool, fleet.wt, fleet.params, draws,
                               want_frames=False, **kw)
    assert set(outs) == set(jouts) and "frame" not in outs
    monkeypatch.undo()
    _, with_frames = td.fleet_rollout(fleet.state, 1, fleet.net, pool, fleet.wt, fleet.params,
                                      draws, **kw)  # the port's default: frames on
    assert set(with_frames) == set(outs) | {"frame"}
    assert with_frames["frame"].shape == (2, 1, 32, 64, 3) and with_frames["frame"].dtype == torch.uint8
    for k in outs:
        np.testing.assert_array_equal(outs[k].numpy(), with_frames[k].numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def test_main_prints_bench_py_line(monkeypatch, capsys):
    for k, n in (("BENCH_ENVS", 2), ("BENCH_TICKS", 1), ("BENCH_REPS", 1)):
        monkeypatch.setenv(k, str(n))
    line = env_steps.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert "# first chunk:" in err
    # bench.py's keys (vs_baseline left out), the device, the card and its limit.
    assert set(line) == {"metric", "value", "unit", "device", "card", "power_limit"}
    assert line["metric"] == "env_steps_per_sec_per_chip" == env_steps.METRIC
    assert line["unit"] == "env-steps/s (render+policy+dynamics, per chip of 1)"
    assert line["device"] == "cpu" and line["card"] is None and line["power_limit"] is None
    assert line["value"] > 0


@pytest.mark.parametrize("entry", ["env_steps", "profile_step", "ablate_step",
                                   "report_resident"])
def test_entry_points_refuse_without_a_gpu(entry, tmp_path, monkeypatch):
    """With the default device and no GPU, each entry point raises before it
    runs anything (no fallback to the CPU)."""
    from cilrs_tpu_torch.tools import ablate_step, profile_step, report_resident

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.json"
    call = {"env_steps": lambda: env_steps.main([]),
            "profile_step": lambda: profile_step.main(["2"]),
            "ablate_step": lambda: ablate_step.main([]),
            "report_resident": lambda: report_resident.main(
                ["--checkpoint", str(tmp_path / "x.pth"), "--frames", "8", "--out", str(out)])}
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        call[entry]()
    assert not out.exists()


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, out_dir):
    from cilrs_tpu_torch.parallel.distributed import initialize_distributed
    from cilrs_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    assert initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        env_steps.bench_policy = tiny_policy  # this process only
        line, times, fleet = env_steps.run(4, 2, 1, "cpu", mesh=make_mesh(world, "cpu"))
        torch.save({"line": line, "times": times, "state": fleet.state},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_ranks_match_world_one(tmp_path, tiny_bench):
    tmp.spawn(_rank_main, args=(2, _free_port(), str(tmp_path)), nprocs=2)
    want_line, _, want = env_steps.run(4, 2, 1, "cpu")
    assert want_line["unit"].endswith("per chip of 1)")
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert got["line"]["unit"] == "env-steps/s (render+policy+dynamics, per chip of 2)"
        assert got["times"]["world"] == 2 and got["line"]["value"] > 0
        assert_tree_close(got["state"], want.state, "state", RANKS_TOL)
    assert (want.state.metrics.total_frames.numpy() == 4).all()  # warm-up + 1 rep of 2 ticks
