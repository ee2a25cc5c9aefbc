"""Parity of cilrs_tpu_torch.evaluation.residuals with the JAX package's
residual analysis.

 - ``breakdown`` is numpy in both: equal on the same arrays;
 - ``collect_with_privileged`` on the mini town (3 envs: clear, rain, fog),
   the port on JAX's pedestrian draws (keys ``PRNGKey(seed*31+e)``, one
   split a tick): commands, light states and weathers exact, controls within
   1e-6, speeds and obstacle distances within 1e-4, frames of every
   weather as the collect tests hold a clear frame: at most 0.5% of the u8
   values off by more than 1, mean difference under 1e-3 of the range (the
   rain streaks' and the grain's sin hashes agree bit for bit,
   tests/test_torch_sinf.py; measured: 1e-5 of the values off by more than
   1, in the fog env);
 - ``predict`` from the same weights (a (1, 1, 1, 1) trunk, JAX's in
   float32 as the port runs on the CPU) on the same frames, with a batch
   that pads the tail: the tolerances of tests/test_torch_model.py, controls
   atol 1e-3 (bf16 branch heads in both), predicted speed atol 2e-3 / rtol
   1e-3;
 - ``main`` on the CPU writes the report it returns.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cilrs_tpu.config as jconfig  # noqa: E402
import cilrs_tpu.evaluation.residuals as jres  # noqa: E402
import cilrs_tpu.train.checkpoint as jckpt  # noqa: E402
import cilrs_tpu.train.state as jstate  # noqa: E402
import cilrs_tpu_torch.evaluation.residuals as tres  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.maps.town import make_mini_town as j_mini  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu_torch.data import collect as tcol  # noqa: E402
from cilrs_tpu_torch.maps.town import make_mini_town as t_mini  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.train.checkpoint import BEST_NAME, save_checkpoint_pth  # noqa: E402

E, V, P, T, SEED, N = 3, 3, 1, 10, 5, 60
TOL = {"control": 1e-6, "speed_kmh": 1e-4, "obstacle_dist": 1e-4}
EXACT = ("command", "tl_state", "weather")
FRAME_MAX_SHARE, FRAME_MAX_MEAN = 0.005, 1e-3 * 255
TINY = (1, 1, 1, 1)
J_MODEL = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=TINY, speed_skip=True)
J_CREATE_TRAIN_STATE = jstate.create_train_state


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


def _ped_draws(steps):
    """JAX's pedestrian uniforms of the residual fleet: [steps, E, P]."""
    def chain(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]

    keys = jnp.stack([jax.random.PRNGKey(SEED * 31 + e) for e in range(E)])
    return torch.tensor(np.asarray(jax.vmap(chain)(keys)).transpose(1, 0, 2))


@pytest.fixture(scope="module")
def collected():
    j_routing._graph_cache.clear()
    want = jres.collect_with_privileged(j_mini(), N, num_envs=E, num_vehicles=V,
                                        num_pedestrians=P, seed=SEED, chunk_steps=T)
    draws, served = _ped_draws(20 * T), []

    def jax_draws(generator, steps, num_envs, num_pedestrians, device):
        assert (steps, num_envs, num_pedestrians, generator.initial_seed()) == (T, E, P, SEED)
        served.append(steps)
        return draws[(len(served) - 1) * T:len(served) * T]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcol, "draw_pedestrians", jax_draws)
        got = tres.collect_with_privileged(t_mini(), N, num_envs=E, num_vehicles=V,
                                           num_pedestrians=P, seed=SEED, chunk_steps=T,
                                           device="cpu")
    return want, got


def test_collect_with_privileged_matches_jax(collected):
    want, got = collected
    assert got.keys() == want.keys()
    assert len(got["frame"]) == len(want["frame"]) == N
    assert got["frame"].shape == (N, 88, 200, 3) and got["frame"].dtype == np.uint8
    for k in EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]).astype(got[k].dtype), err_msg=k)
    for k, tol in TOL.items():
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    d = np.abs(got["frame"].astype(int) - want["frame"].astype(int))
    assert (got["weather"] == 0).any() and (got["weather"] == 1).any()  # clear and rain
    assert (d > 1).mean() <= FRAME_MAX_SHARE and d.mean() <= FRAME_MAX_MEAN


def _breakdown_inputs(n, seed):
    rng = np.random.RandomState(seed)
    data = {"control": np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(0, 1, n),
                                 rng.uniform(0, 1, n) * (rng.uniform(size=n) < 0.3)], 1),
            "speed_kmh": rng.uniform(0, 100, n), "obstacle_dist": rng.uniform(0, 50, n),
            "tl_state": rng.randint(0, 4, n), "weather": rng.randint(0, 5, n),
            "command": rng.randint(0, 4, n)}
    data["control"][: n // 5, 1] = 0.0  # a th_zero segment
    pred = data["control"] + rng.normal(0, 0.05, (n, 3))
    return data, pred, rng.uniform(0, 1, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_breakdown_matches_jax(seed):
    data, pred, pred_speed = _breakdown_inputs(500, seed)
    want = jres.breakdown(data, pred, pred_speed)
    got = tres.breakdown(data, pred, pred_speed)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert len(got["segments"]) == 17  # every segment is populated


def test_breakdown_on_collected_frames_matches_jax(collected):
    """breakdown of the same collected arrays (JAX's) and predictions, with a
    constant brake head (its correlation is nan in both)."""
    want_data, _ = collected
    rng = np.random.RandomState(3)
    pred = np.asarray(want_data["control"]) + rng.normal(0, 0.1, (N, 3))
    pred[:, 2] = 0.25
    ps = rng.uniform(0, 1, N)
    want = jres.breakdown(want_data, pred, ps)
    got = tres.breakdown(want_data, pred, ps)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert np.isnan(got["corr"]["brake"])


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """The same weights for both packages: a JAX init carried across, saved
    as the port's best slot."""
    v = J_MODEL.init(jax.random.PRNGKey(0), jnp.zeros((1, 88, 200, 3)), jnp.zeros((1,)),
                     jnp.zeros((1,), jnp.int32))
    params, stats = jax.device_get(v["params"]), jax.device_get(v["batch_stats"])
    model = CILRS(dropout=0.0, stage_sizes=TINY, speed_skip=True)
    model.load_state_dict(flax_to_state_dict(params, stats))
    d = tmp_path_factory.mktemp("ckpt")
    save_checkpoint_pth(os.path.join(d, BEST_NAME), model, 1, 0.0)
    return str(d), params, stats


def test_predict_matches_jax(collected, tiny_checkpoint, monkeypatch):
    _, got_data = collected
    ckpt, params, stats = tiny_checkpoint
    cfg = jconfig.TrainConfig(model=jconfig.ModelConfig(dropout=0.0, stage_sizes=TINY))

    def j_state(cfg_, rng, *a, **kw):
        return J_CREATE_TRAIN_STATE(cfg_, rng, *a, **kw).replace(apply_fn=J_MODEL.apply)

    monkeypatch.setattr(jconfig, "load_train_config", lambda *a: cfg)
    monkeypatch.setattr(jckpt, "restore_best_payload",
                        lambda d: {"params": params, "batch_stats": stats})
    monkeypatch.setattr(jstate, "create_train_state", j_state)
    args = (got_data["frame"], got_data["speed_kmh"], got_data["command"])
    want_c, want_s = jres.predict(ckpt, *args, batch=16)
    got_c, got_s = tres.predict(ckpt, *args, batch=16, device="cpu")
    assert got_c.shape == (N, 3) and got_s.shape == (N,)  # 60 rows: 4 batches, the last padded
    np.testing.assert_allclose(got_c, np.asarray(want_c), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_s, np.asarray(want_s).reshape(N), atol=2e-3, rtol=1e-3)
    # The padding rows do not leak: the tail equals a prediction on its own.
    alone_c, _ = tres.predict(ckpt, *(a[-3:] for a in args), batch=16, device="cpu")
    np.testing.assert_allclose(alone_c, got_c[-3:], atol=1e-5, rtol=0)


def test_residuals_main_on_cpu(tiny_checkpoint, tmp_path):
    ckpt, _, _ = tiny_checkpoint
    out = tmp_path / "residuals.json"
    rep = tres.main(["--checkpoint", ckpt, "--frames", "20", "--envs", "2", "--map", "mini",
                     "--out", str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert rep["n"] == 20 and set(rep["mae"]) == {"steer", "throttle", "brake"}
    assert all(np.isfinite(v) for v in rep["mae"].values())
