"""The port's tools around the headline run, ``cilrs_tpu_torch.tools``:
``profile_step`` and ``ablate_step`` on the CPU at E = 2, and
``report_resident`` against the JAX tool, ``tools/report_resident.py``.

 - ``profile_step``: the JAX tool's nine phases, by the same names, each
   timed (wall ms); device times not measured on the CPU;
 - ``ablate_step``: the JAX tool's five arms and its baseline, by its result
   keys; each arm's chunks see its own patch and no other, and every patch
   is restored after its arm, a failing arm's too;
 - ``report_resident`` and the JAX tool on the same weights (a (1, 1, 1, 1)
   CILRS, float32 on both sides, JAX's init from PRNGKey(0): a JAX
   checkpoint directory for the JAX tool, its ``.pth`` for the port) and the
   same tiny re-collection (the mini town, 2 envs, 3 vehicles, 1 walker,
   60 frames, seed 3; the port on JAX's pedestrian draws, keys
   ``PRNGKey(seed * 997 + e)`` as tests/test_torch_resident.py derives
   them): the same rows, their labels as tests/test_torch_resident.py holds
   them (commands exact, controls and normalized speed within 1e-6), the
   predictions within tests/test_torch_model.py's 1e-3 on the controls and
   2e-3 + 1e-3 relative on the speed (measured 2.4e-4 and 4.6e-6); the
   report's counts exact, its errors (MAE, RMSE, percentiles, per command
   and per weather) within 1e-3 and its MSEs within 2e-3 (|a^2 - b^2| <=
   |a - b| |a + b|, errors under 1), its correlations within 1e-2 (Pearson's
   r over 4-9 rows moves by the predictions' difference over their spread;
   measured 1.9e-4), and its within-threshold shares exact;
 - ``--split all`` evaluates every collected row.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cilrs_tpu.cli.common as j_common  # noqa: E402
import cilrs_tpu.config as j_config  # noqa: E402
import cilrs_tpu.evaluation.report as j_report  # noqa: E402
import cilrs_tpu.train.state as j_state  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.train import checkpoint as j_ckpt  # noqa: E402
from cilrs_tpu_torch.agent import perception  # noqa: E402
from cilrs_tpu_torch.bench import env_steps  # noqa: E402
from cilrs_tpu_torch.config import ModelConfig  # noqa: E402
from cilrs_tpu_torch.data import collect as tcol  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.render import raster  # noqa: E402
from cilrs_tpu_torch.tools import ablate_step, profile_step, report_resident  # noqa: E402
from cilrs_tpu_torch.train.checkpoint import save_checkpoint_pth  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(dropout=0.0, stage_sizes=(1, 1, 1, 1))
E, V, P, N, SEED, CHUNK = 2, 3, 1, 60, 3, 50  # CHUNK: collect_resident's default chunk
FLAGS = ["--frames", str(N), "--seed", str(SEED), "--envs", str(E), "--vehicles", str(V),
         "--walkers", str(P), "--map", "mini"]
PRED_TOL = {"controls": dict(atol=1e-3, rtol=0), "speed": dict(atol=2e-3, rtol=1e-3)}
ERR_TOL, MSE_TOL, CORR_TOL = 1e-3, 2e-3, 1e-2
# The tool's timing loops as the JAX tool runs them: 10 calls a phase, the
# chunk 20 ticks and 5 calls (read before the tests cut them).
DEFAULT_LOOPS = (profile_step.REPS, profile_step.CHUNK_TICKS, profile_step.CHUNK_REPS)


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


def _jax_tool_source(name: str) -> str:
    with open(os.path.join(REPO, "tools", name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# profile_step, ablate_step
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_bench(monkeypatch):
    """bench.py's fleet with a (1, 1, 1, 1) CILRS, and the tools' timing
    loops cut to one call."""
    from cilrs_tpu_torch.agent.driver import model_policy
    from cilrs_tpu_torch.config import TrainConfig
    from cilrs_tpu_torch.train.state import create_train_state

    monkeypatch.setattr(env_steps, "bench_policy", lambda dev: model_policy(
        create_train_state(TrainConfig(model=TINY), env_steps.SEED, device=dev).model.eval()))
    monkeypatch.setattr(profile_step, "REPS", 1)
    monkeypatch.setattr(profile_step, "CHUNK_TICKS", 2)
    monkeypatch.setattr(profile_step, "CHUNK_REPS", 1)


def test_profile_step_times_the_jax_tools_phases(tiny_bench):
    out = profile_step.profile(2, "cpu")
    src = _jax_tool_source("profile_step.py")
    names = list(out)
    assert len(names) == 9 and names[-1] == "fused chunk (2 ticks)"
    for name in names[:-1]:
        assert f'timeit("{name}"' in src, name
    assert "fused chunk (20 ticks)" in src and "reps=10" in src and "reps = 5" in src
    assert DEFAULT_LOOPS == (10, 20, 5)
    for name, r in out.items():
        assert r["wall_ms"] > 0 and r["device_ms"] is None and r["device_activities"] is None, name
    assert out[names[-1]]["env_steps_per_s"] > 0


# What each arm patches, read inside its chunks.
def _seen():
    return {"no_motion_blur": raster.motion_blur is not ORIGINAL["motion_blur"],
            "no_grain": raster.grain_texture is not ORIGINAL["grain_texture"],
            "no_buildings": raster.NUM_NEAR_BUILDINGS == 0,
            "no_predict": perception.PREDICT_HORIZONS == (0.0,),
            "k48_segments": raster.NUM_NEAR_SEGMENTS == 48}


def _patchable():
    return {"motion_blur": raster.motion_blur, "grain_texture": raster.grain_texture,
            "NUM_NEAR_BUILDINGS": raster.NUM_NEAR_BUILDINGS,
            "PREDICT_HORIZONS": perception.PREDICT_HORIZONS,
            "NUM_NEAR_SEGMENTS": raster.NUM_NEAR_SEGMENTS}


ORIGINAL = _patchable()


@pytest.fixture(autouse=True)
def _original_as_found():
    """ORIGINAL as each test finds it: tests/test_torch_switches.py reloads
    raster, which makes its functions new objects, in a process that may run
    this file later."""
    ORIGINAL.update(_patchable())


def _restored():
    now = _patchable()
    return all(now[k] is ORIGINAL[k] or now[k] == ORIGINAL[k] for k in ORIGINAL)


def test_ablate_step_runs_each_arm_with_its_patch_alone(tiny_bench, monkeypatch):
    seen = []
    chunk = env_steps.BenchFleet.chunk

    def recording_chunk(self):
        seen.append(_seen())
        return chunk(self)

    monkeypatch.setattr(env_steps.BenchFleet, "chunk", recording_chunk)
    out = ablate_step.ablate(E, 2, 1, "cpu")
    src = _jax_tool_source("ablate_step.py")
    assert list(out) == [k for k, _, _ in ablate_step.ARMS]
    for key in out:
        assert f'results["{key}"]' in src, key
    assert all(r["env_steps_per_s"] > 0 and r["ms_per_tick"] > 0 for r in out.values())
    # Two chunks an arm (warm-up + 1 timed), the baseline's unpatched.
    assert len(seen) == 2 * len(ablate_step.ARMS)
    for (key, _, _), a, b in zip(ablate_step.ARMS, seen[::2], seen[1::2]):
        assert a == b == {k: k == key for k in a}, key
    assert _restored()


@pytest.mark.parametrize("failing", ["no_grain", "no_buildings", "k48_segments"])
def test_ablate_step_restores_a_failing_arm(failing, tiny_bench, monkeypatch):
    def chunk(self):
        if _seen()[failing]:
            raise RuntimeError("arm failed")
        return self.state

    monkeypatch.setattr(env_steps.BenchFleet, "chunk", chunk)
    with pytest.raises(RuntimeError, match="arm failed"):
        ablate_step.ablate(E, 2, 1, "cpu")
    assert _restored()


# ---------------------------------------------------------------------------
# report_resident
# ---------------------------------------------------------------------------


def _session_draws(session_seed: int, steps: int) -> torch.Tensor:
    """JAX's pedestrian uniforms of one resident session's fleet: [steps, E, P]."""
    def chain(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]

    keys = jnp.stack([jax.random.PRNGKey(session_seed * 997 + e) for e in range(E)])
    return torch.tensor(np.asarray(jax.vmap(chain)(keys)).transpose(1, 0, 2))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of weights twice: a JAX checkpoint directory (orbax, best
    slot) and the port's .pth."""
    jm = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=TINY.stage_sizes, speed_skip=True)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 88, 200, 3)),
                               jnp.zeros((1,)), jnp.zeros((1,), jnp.int32)))
    root = tmp_path_factory.mktemp("ckpt")
    j_ckpt.save_checkpoint(str(root / "jax"), types.SimpleNamespace(
        step=0, params=v["params"], batch_stats=v["batch_stats"], opt_state={}),
        epoch=1, val_loss=0.0, is_best=True, latest=False)
    model = CILRS(dropout=0.0, dtype=torch.float32, stage_sizes=TINY.stage_sizes, speed_skip=True)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    save_checkpoint_pth(str(root / "policy.pth"), model, 1, 0.0)
    return jm, str(root / "jax"), str(root / "policy.pth")


def _recorded(module, name: str, calls: list):
    """``module.name`` wrapped to record its arguments and result."""
    fn = getattr(module, name)

    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, out))
        return out
    return call


@pytest.fixture(scope="module")
def reports(checkpoints, tmp_path_factory):
    """(JAX tool's report, its prediction call), the port's, on the same
    weights and collection."""
    jm, jax_ckpt, pth = checkpoints
    root = tmp_path_factory.mktemp("reports")
    jcfg = j_config.TrainConfig(model=j_config.ModelConfig(dropout=0.0,
                                                           stage_sizes=TINY.stage_sizes))
    spec = importlib.util.spec_from_file_location(
        "_report_resident", os.path.join(REPO, "tools", "report_resident.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)

    def jax_state(cfg, rng, *a, **k):  # the tool's untrained state, float32 as on the CPU
        return j_state.CILRSTrainState(step=jnp.zeros((), jnp.int32), params=None,
                                       batch_stats=None, opt_state=None, tx=None,
                                       apply_fn=jm.apply)

    jcalls, tcalls, draws, served = [], [], {}, {}

    def jax_draws(generator, steps, num_envs, num_pedestrians, device):
        assert (steps, num_envs, num_pedestrians) == (CHUNK, E, P)
        s = generator.initial_seed()
        if s not in draws:
            draws[s] = _session_draws(s, 20 * CHUNK)
        k = served[s] = served.get(s, -1) + 1
        return draws[s][k * CHUNK:(k + 1) * CHUNK]

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_common, "enable_compilation_cache", lambda *a, **k: None)
        mp.setattr(j_config, "load_train_config", lambda *a: jcfg)
        mp.setattr(j_state, "create_train_state", jax_state)
        mp.setattr(j_report, "collect_predictions_resident",
                   _recorded(j_report, "collect_predictions_resident", jcalls))
        want = jtool.main(["--checkpoint", jax_ckpt, *FLAGS, "--out", str(root / "jax.json")])
        mp.setattr(tcol, "draw_pedestrians", jax_draws)
        mp.setattr(report_resident, "collect_predictions_resident",
                   _recorded(report_resident, "collect_predictions_resident", tcalls))
        got = report_resident.main(["--checkpoint", pth, *FLAGS, "--out", str(root / "t.json"),
                                    "--device", "cpu"])
    finally:
        mp.undo()
    with open(root / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    return (want, jcalls[0]), (got, tcalls[0]), sorted(draws)


def _assert_report_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_report_close(got[k], want[k], f"{path}.{k}")
        return
    leaf = path.split(".")[-1]
    if leaf in ("num_samples", "samples") or path.split(".")[1] == "steer_accuracy":
        assert got == want, path
    elif leaf == "correlation":
        assert abs(got - want) <= CORR_TOL, (path, got, want)
    else:
        assert abs(got - want) <= (MSE_TOL if leaf == "mse" else ERR_TOL), (path, got, want)


def test_report_resident_matches_the_jax_tool(reports):
    (want, (jargs, jout)), (got, (targs, tout)), sessions = reports
    assert sessions == [SEED]  # one page, one session
    jrows, trows = np.asarray(jargs[3]), np.asarray(targs[3])
    np.testing.assert_array_equal(trows, jrows)  # the same val split of the same labels
    assert 0 < len(trows) < N and len(set(trows.tolist())) == len(trows)
    (jpred, jtrue, jcmd), (tpred, ttrue, tcmd) = jout, tout
    np.testing.assert_array_equal(tcmd, np.asarray(jcmd))
    np.testing.assert_allclose(ttrue, jtrue, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tpred[:, :3], jpred[:, :3], **PRED_TOL["controls"])
    np.testing.assert_allclose(tpred[:, 3], jpred[:, 3], **PRED_TOL["speed"])
    assert got["num_samples"] == len(trows)
    assert set(got["per_weather"]) <= {"clear", "rain", "fog", "night", "hardrain"}
    _assert_report_close(got, want)


def test_report_resident_split_all(checkpoints, tmp_path):
    _, _, pth = checkpoints
    got = report_resident.main(["--checkpoint", pth, *FLAGS, "--split", "all",
                                "--out", str(tmp_path / "r.json"), "--device", "cpu"])
    assert got["num_samples"] == N
    assert sum(c["samples"] for c in got["per_command"].values()) == N
    assert sum(w["samples"] for w in got["per_weather"].values()) == N
