"""Parity of cilrs_tpu_torch.train.fused (the fused collect -> train loop)
and cilrs_tpu_torch.cli.fused with the JAX package's, on the mini town, a
(1, 1, 1, 1) trunk and 32x64 frames (the sizes of tests/test_fused.py).

Both packages get the same inputs: the ring tests feed the same numpy chunks
and JAX's own ``randint`` draws; the loop test starts both from the same
weights (JAX's init, carried across with ``flax_to_state_dict``; the JAX
model in float32 as the port runs on the CPU) and hands the port JAX's draws
for the pedestrians (keys ``PRNGKey(seed*997+e)`` for the train fleet and
``PRNGKey(seed*1013+e+7)`` for the val fleet) and for the sampler (the chain
``PRNGKey(seed+7)`` -> split -> split(k, steps a chunk), then ``fold_in(k,
r)`` for the redraws). Augmentation is the identity and dropout 0 in both,
as in tests/test_torch_train.py.

Tolerances:
 - ring contents and bookkeeping (cursor, fill, total written, command
   counts, validity), snapshots, the picks, the batches' commands,
   frames_collected, train_steps and every history entry's step and frames:
   exact;
 - sample weights: 1e-6 (float32 means over the batch, summed in another
   order); in the loop, the sampled normalized speeds and controls: 1e-6,
   the collect-mode rollout's tolerance (tests/test_torch_resident.py);
 - the sampled frames, as tests/test_torch_resident.py holds a table: the
   clear env's rows (env 0) with at most 0.5% of the u8 values off by more
   than 1, and all rows with at most 1% off by more than 0.05 of the range
   and a mean difference under 1e-3 of it. The rain env (env 1) needs the
   looser bound, and not for the sin hashes, which the port computes as
   XLA does (ops/sinf.py). At this 64-pixel width the JAX program takes the
   streak columns' phase, a hash of constants (the pixel columns), with the
   argument rounded twice and sin correctly rounded, where at the package's
   widths (200, 320) it takes glibc's sinf of the fused multiply-add as the
   port does (tests/test_torch_sinf.py pins both). Measured here:
   3.0% of the rain env's values off by more than 1, 0.46% of all by more
   than 0.05; with the port's phase computed as that program computes it,
   1.1e-4 and 1e-5;
 - the history: the held-out losses and their steer and throttle terms,
   rtol 1e-2; the small brake and speed terms (about 0.02), atol 5e-3; the
   last step's plain loss on its 16 frames, rtol 1e-1. The rain frames enter
   training and the held-out set. Measured: 6.2e-3 (val_throttle), 1.4e-3
   (val_brake) and 7.8e-2; with the phase computed as the JAX program at
   this width computes it, 9.8e-4, 1.3e-4 and 5.0e-3: these bounds cover
   that phase, not the step.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cilrs_tpu.train.fused as jfused  # noqa: E402
import cilrs_tpu_torch.train.fused as tfused  # noqa: E402
import cilrs_tpu_torch.train.steps as tsteps  # noqa: E402
from cilrs_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from cilrs_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from cilrs_tpu.config import TrainingConfig as JTrainingConfig  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.maps.town import make_mini_town as j_mini  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.render.camera import CameraSpec as JCam  # noqa: E402
from cilrs_tpu.train.state import create_train_state as j_create_train_state  # noqa: E402
from cilrs_tpu_torch import config as tcfg  # noqa: E402
from cilrs_tpu_torch.cli import fused as fused_cli  # noqa: E402
from cilrs_tpu_torch.data import collect as tcol  # noqa: E402
from cilrs_tpu_torch.maps.town import make_mini_town as t_mini  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.ops.gather import padded_row_elems  # noqa: E402
from cilrs_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from cilrs_tpu_torch.render.camera import CameraSpec  # noqa: E402
from cilrs_tpu_torch.train.checkpoint import load_policy  # noqa: E402
from cilrs_tpu_torch.train.state import create_train_state  # noqa: E402

H, W, B = 32, 64, 16
J_CFG = JTrainConfig(model=JModelConfig(dropout=0.0, image_height=H, image_width=W,
                                        stage_sizes=(1, 1, 1, 1)),
                     training=JTrainingConfig(batch_size=B))
T_CFG = tcfg.TrainConfig(model=tcfg.ModelConfig(dropout=0.0, image_height=H, image_width=W,
                                                stage_sizes=(1, 1, 1, 1)),
                         training=tcfg.TrainingConfig(batch_size=B))
J_MODEL = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=(1, 1, 1, 1),
                 speed_skip=J_CFG.model.speed_skip)
# tests/test_fused.py:57-63.
LOOP = dict(num_envs=2, num_vehicles=3, num_pedestrians=1, buffer_frames=512, collect_ticks=10,
            train_steps_per_chunk=2, total_train_steps=8, warmup_chunks=4, seed=0, eval_every=4,
            verbose=False)
E, P, T, S, SEED = 2, 1, 10, 2, 0
WEIGHT_TOL = 1e-6
LABEL_TOL = 1e-6
CLEAR_MAX_SHARE = 0.005
RAIN_ATOL, RAIN_MAX_SHARE, RAIN_MAX_MEAN = 0.05 * 255, 0.01, 1e-3 * 255
LOSS_TOL = dict(rtol=1e-2, atol=0)
HISTORY_TOL = {"val_brake": dict(rtol=0, atol=5e-3), "val_speed": dict(rtol=0, atol=5e-3),
               "train_loss": dict(rtol=1e-1, atol=0)}
FIELDS = ("speed", "command", "controls", "valid")


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy); each
    test starts and ends with that cache empty."""
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


# --------------------------------------------------------------------------
# The ring and the sampler
# --------------------------------------------------------------------------


def _chunk(rng, m, h=4, w=4, moving_share=0.8):
    return {"frames": rng.randint(0, 256, (m, h, w, 3)).astype(np.uint8),
            "speed_kmh": rng.uniform(0, 120, m).astype(np.float32),
            "command": rng.randint(0, 4, m).astype(np.int32),
            "controls": rng.uniform(-1, 1, (m, 3)).astype(np.float32),
            "moving": rng.uniform(size=m) < moving_share}


def _assert_same_ring(tbuf, jbuf):
    n = tbuf.capacity
    d = int(np.prod(tbuf.image_shape))
    np.testing.assert_array_equal(tbuf.images[:, :d].numpy(), np.asarray(jbuf.images).reshape(n, d))
    assert not tbuf.images[:, d:].any()
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tbuf, k).numpy(), np.asarray(getattr(jbuf, k)), err_msg=k)
    assert tbuf.cursor == int(jbuf.cursor) and tbuf.filled == int(jbuf.filled)
    assert int(tbuf.total_written) == int(jbuf.total_written)
    np.testing.assert_array_equal(tbuf.cmd_counts.numpy(), np.asarray(jbuf.cmd_counts))


def _jax_draws(key, batch, high):
    """JAX's sampler draws for ``key``: [4, batch], the first and the three
    redraws (``sample_batch``'s randint and fold_in(key, r))."""
    keys = [key] + [jax.random.fold_in(key, r) for r in range(1, 4)]
    return jnp.stack([jax.random.randint(k, (batch,), 0, high) for k in keys])


_jax_draws_jit = jax.jit(_jax_draws, static_argnums=1)


def _copy_ring(buf):
    return tfused.ReplayBuffer(**{f: (v.clone() if torch.is_tensor(v) else v)
                                  for f, v in vars(buf).items()})


@pytest.fixture(scope="module")
def rings():
    """Both packages' rings after each of the same writes to 32 slots of
    (4, 4) frames: a chunk that fills part of the ring, one that wraps it,
    one with few moving frames."""
    rng = np.random.RandomState(0)
    keys = ("frames", "speed_kmh", "command", "controls", "moving")
    jbuf = jfused.make_buffer(32, 4, 4)
    tbuf = tfused.make_buffer(32, 4, 4, device="cpu")
    jbufs, tbufs = [], []
    for c in (_chunk(rng, 20), _chunk(rng, 20), _chunk(rng, 15, moving_share=0.2)):
        jbuf = jax.jit(jfused.write_chunk)(jbuf, *(jnp.asarray(c[k]) for k in keys))
        tfused.write_chunk(tbuf, *(torch.from_numpy(c[k]) for k in keys))
        jbufs.append(jbuf)
        tbufs.append(_copy_ring(tbuf))
    return jbufs, tbufs


def test_write_chunk_matches_jax(rings):
    jbufs, tbufs = rings
    assert tbufs[0].images.shape == (32, padded_row_elems(48, torch.uint8)) == (32, 48)
    for tbuf, jbuf in zip(tbufs, jbufs, strict=True):
        _assert_same_ring(tbuf, jbuf)
    assert tbufs[1].cursor == 40 % 32 and tbufs[1].filled == 32  # the second chunk wrapped
    with pytest.raises(ValueError, match="does not fit"):
        tfused.write_chunk(_copy_ring(tbufs[0]), *(torch.from_numpy(v) for v in
                                                   _chunk(np.random.RandomState(1), 33).values()))


def test_snapshot_and_freeze_match_jax(rings):
    jbuf, tbuf = rings[0][-1], rings[1][-1]
    for size in (5, 24, 32):  # cursor 55 % 32 = 23: 24 and 32 cross the ring's end
        want = jax.jit(jfused.snapshot_val_slice, static_argnums=1)(jbuf, size)
        got = tfused.snapshot_val_slice(tbuf, size)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    jfrozen, jval = jax.jit(jfused.freeze_val_slice, static_argnums=1)(jbuf, 30)
    tfrozen, tval = tfused.freeze_val_slice(_copy_ring(tbuf), 30)
    _assert_same_ring(tfrozen, jfrozen)
    for k in jval:
        np.testing.assert_array_equal(tval[k].numpy(), np.asarray(jval[k]), err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_sample_batch_matches_jax_on_its_draws(rings, seed):
    """The same picks, labels and frames as JAX's sample_batch, weights within
    WEIGHT_TOL, on JAX's draws; the last ring has few valid slots, so some
    invalid picks survive the three redraws and weigh 0."""
    survivors = 0
    for k, (jbuf, tbuf) in enumerate(zip(*rings, strict=True)):
        key = jax.random.PRNGKey(100 * seed + k)
        want = jax.jit(jfused.sample_batch, static_argnums=2)(jbuf, key, 64)
        draws = torch.from_numpy(np.array(_jax_draws_jit(key, 64, max(tbuf.filled, 1)))).long()
        got = tfused.sample_batch(tbuf, draws)
        for name in ("images", "speed", "command", "controls"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
        np.testing.assert_allclose(got["weights"].numpy(), np.asarray(want["weights"]),
                                   atol=WEIGHT_TOL, rtol=0)
        ok = tbuf.valid[got["idx"]]
        assert torch.equal(got["weights"] == 0, ~ok)
        survivors += int((~ok).sum())
    assert survivors > 0  # a batch where invalid picks survive the redraws


def test_draw_indices_bounds():
    gen = torch.Generator().manual_seed(0)
    d = tfused.draw_indices(gen, 1000, 7)
    assert d.shape == (4, 1000) and d.dtype == torch.int64
    assert int(d.min()) == 0 and int(d.max()) == 6


# --------------------------------------------------------------------------
# The weighted train step
# --------------------------------------------------------------------------


def _jax_variables(seed=0):
    v = J_MODEL.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)), jnp.zeros((1,)),
                     jnp.zeros((1,), jnp.int32))
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def _jax_state(params, stats, **kw):
    st = j_create_train_state(J_CFG, jax.random.PRNGKey(0), **kw)
    params = jax.tree.map(jnp.asarray, params)
    return st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, stats),
                      opt_state=st.tx.init(params), apply_fn=J_MODEL.apply)


def _port_state(params, stats, **kw):
    st = create_train_state(T_CFG, 0, device="cpu", **kw)
    st.model.load_state_dict(flax_to_state_dict(params, stats))
    return st


def _identity_augment(mp):
    mp.setattr(jfused, "augment_batch", lambda key, x: x)
    mp.setattr(tsteps, "augment_batch", lambda gen, x: x)


def test_weighted_train_step_matches_jax(monkeypatch):
    """Three weighted steps from the same weights on the same batches (some
    weights 0): loss and plain loss within 1e-3, BatchNorm statistics and
    parameters as tests/test_torch_train.py holds the plain step."""
    _identity_augment(monkeypatch)
    params, stats = _jax_variables(1)
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(3):
        w = rng.uniform(0.2, 3.0, B).astype(np.float32)
        w[rng.uniform(size=B) < 0.2] = 0.0
        batches.append({"images": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
                        "speed": rng.uniform(0, 0.5, B).astype(np.float32),
                        "command": rng.randint(0, 4, B).astype(np.int32),
                        "controls": np.stack([rng.uniform(-0.3, 0.3, B), rng.uniform(0, 0.8, B),
                                              rng.uniform(0, 0.3, B)], 1).astype(np.float32),
                        "weights": w})
    kw = dict(steps_per_epoch=10, schedule="cosine", total_steps=10)
    jst = _jax_state(params, stats, **kw)
    jstep = jax.jit(jfused.weighted_train_step(J_CFG))
    tst = _port_state(params, stats, **kw)
    tstep = tfused.make_weighted_train_step(T_CFG)
    for b in batches:
        jst, jparts = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(2))
        tparts = tstep(tst, {k: torch.from_numpy(v) for k, v in b.items()}, 2)
        for k in ("loss", "plain_loss"):
            np.testing.assert_allclose(tparts[k].item(), float(jparts[k]), atol=1e-3, rtol=0, err_msg=k)
    assert tst.step == 3
    want = flax_to_state_dict(jax.device_get(jst.params), jax.device_get(jst.batch_stats))
    sd = tst.model.state_dict()
    lr = T_CFG.optimizer.learning_rate
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=5e-4, rtol=5e-3, err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            assert np.abs(sd[k].numpy() - v.numpy()).max() <= 2 * 3 * lr, k


# --------------------------------------------------------------------------
# The whole loop against the JAX loop
# --------------------------------------------------------------------------


def _ped_chain(keys, steps):
    """JAX's pedestrian uniforms of a fleet whose env keys are ``keys``:
    [steps, E, P] (one split of the world's key a tick)."""
    def chain(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]

    return torch.tensor(np.asarray(jax.vmap(chain)(jnp.stack(keys))).transpose(1, 0, 2))


def _sample_keys(seed, chunks):
    """The sampler's step keys of the JAX loop, in order."""
    key, out = jax.random.PRNGKey(seed + 7), []
    for _ in range(chunks):
        key, k = jax.random.split(key)
        out += list(jax.random.split(k, S))
    return out


@pytest.fixture(scope="module")
def loops():
    params, stats = _jax_variables(0)
    jrec, trec = [], []
    mp = pytest.MonkeyPatch()
    try:
        _identity_augment(mp)
        mp.setattr(jfused, "create_train_state",
                   lambda cfg, rng, **kw: _jax_state(params, stats, **kw))
        mp.setattr(tfused, "create_train_state",
                   lambda cfg, seed, device, **kw: _port_state(params, stats, **kw))

        j_sample = jfused.sample_batch

        def j_recorded(buf, key, batch):
            out = j_sample(buf, key, batch)
            # sample_batch's picks, recomputed from its draws to be recorded.
            draws = _jax_draws(key, batch, jnp.maximum(buf.filled, 1))
            idx = draws[0]
            for alt in draws[1:]:
                idx = jnp.where(buf.valid[idx], idx, alt)
            jax.debug.callback(lambda *a: jrec.append([np.asarray(x) for x in a]), idx,
                               out["images"], out["speed"], out["command"], out["controls"],
                               out["weights"], ordered=True)
            return out

        mp.setattr(jfused, "sample_batch", j_recorded)
        j_routing._graph_cache.clear()
        jout = jfused.fused_collect_train(j_mini(), J_CFG, cam=JCam(width=W, height=H), **LOOP)

        peds = {SEED: _ped_chain([jax.random.PRNGKey(SEED * 997 + e) for e in range(E)], 200),
                SEED + 10_000: _ped_chain([jax.random.PRNGKey(SEED * 1013 + e + 7)
                                           for e in range(E)], 200)}
        served = {}

        def jax_peds(generator, steps, num_envs, num_pedestrians, device):
            assert (steps, num_envs, num_pedestrians) == (T, E, P)
            s = generator.initial_seed()
            k = served[s] = served.get(s, -1) + 1
            return peds[s][k * T:(k + 1) * T]

        keys = _sample_keys(SEED, 4)
        drawn = []

        def jax_sample_draws(gen, batch, high):
            assert gen.initial_seed() == SEED + tfused.SAMPLE_SEED_OFFSET
            d = _jax_draws_jit(keys[len(drawn)], batch, high)
            drawn.append(high)
            return torch.from_numpy(np.array(d)).long()

        t_sample = tfused.sample_batch

        def t_recorded(buf, draws):
            out = t_sample(buf, draws)
            trec.append([out[k].numpy().copy() for k in
                         ("idx", "images", "speed", "command", "controls", "weights")])
            return out

        mp.setattr(tcol, "draw_pedestrians", jax_peds)
        mp.setattr(tfused, "draw_indices", jax_sample_draws)
        mp.setattr(tfused, "sample_batch", t_recorded)
        tout = tfused.fused_collect_train(t_mini(), T_CFG, cam=CameraSpec(width=W, height=H),
                                          device="cpu", **LOOP)
    finally:
        mp.undo()
    return jout, tout, jrec, trec, served


def test_fused_loop_bookkeeping_matches_jax(loops):
    jout, tout, jrec, trec, served = loops
    assert tout["train_steps"] == jout["train_steps"] == 8
    assert tout["frames_collected"] == jout["frames_collected"] > 20
    # 4 warm-up chunks + 3 streaming chunks (steps 0, 2, 4 < 6); the val
    # fleet: max(4, 2 * 128 // 20 + 1) = 13 chunks.
    assert served == {SEED: 6, SEED + 10_000: 12}
    assert len(tout["history"]) == len(jout["history"]) == 2
    for got, want in zip(tout["history"], jout["history"], strict=True):
        assert got.keys() == want.keys()
        assert (got["step"], got["frames"]) == (want["step"], want["frames"])
    assert isinstance(tout["state"].model, torch.nn.Module) and not tout["state"].model.training


def test_fused_loop_picks_and_batches_match_jax(loops):
    _, _, jrec, trec, _ = loops
    assert len(trec) == len(jrec) == 8
    for step, (t, j) in enumerate(zip(trec, jrec)):
        tidx, timg, *tlab, tw = t
        jidx, jimg, *jlab, jw = j
        np.testing.assert_array_equal(tidx, jidx, err_msg=f"picks, step {step}")
        tsp, tcmd, tctl = tlab
        jsp, jcmd, jctl = jlab
        np.testing.assert_array_equal(tcmd, jcmd, err_msg=f"command, step {step}")
        for name, a, b in (("speed", tsp, jsp), ("controls", tctl, jctl)):
            np.testing.assert_allclose(a, b, atol=LABEL_TOL, rtol=0, err_msg=f"{name}, step {step}")
        np.testing.assert_allclose(tw, jw, atol=WEIGHT_TOL, rtol=0, err_msg=f"weights, step {step}")
    # The sampled frames. No wrap in 7 chunks of 20 rows: slot r holds env
    # (r % 20) // 10.
    env = np.concatenate([(t[0] % (E * T)) // T for t in trec])
    d = np.concatenate([np.abs(t[1].astype(int) - j[1].astype(int)) for t, j in zip(trec, jrec)])
    assert (env == 0).any() and (env == 1).any()
    assert (d[env == 0] > 1).mean() <= CLEAR_MAX_SHARE
    assert (d > RAIN_ATOL).mean() <= RAIN_MAX_SHARE and d.mean() <= RAIN_MAX_MEAN


def test_fused_loop_history_matches_jax(loops):
    jout, tout, _, _, _ = loops
    for got, want in zip(tout["history"], jout["history"], strict=True):
        for k in want:
            if k not in ("step", "frames", "time_s"):
                assert np.isfinite(got[k])
                np.testing.assert_allclose(got[k], want[k], **HISTORY_TOL.get(k, LOSS_TOL), err_msg=k)
    assert tout["frames_per_sec_train"] > 0 and tout["wall_s"] > 0


def test_mesh_waits_for_the_parallel_slice():
    """The sharded path runs (tests/test_torch_parallel.py); a world that
    does not split the envs and the ring evenly is refused, as the JAX loop
    asserts."""
    with pytest.raises(ValueError, match="must split over 3 ranks"):
        tfused.fused_collect_train(t_mini(), T_CFG, num_envs=2, device="cpu",
                                   mesh=Mesh(None, 0, 3, torch.device("cpu")))


# --------------------------------------------------------------------------
# cli.fused
# --------------------------------------------------------------------------


def test_cli_fused_on_cpu(tmp_path, monkeypatch):
    """cli.fused at tiny sizes on the CPU: the history JSON, and a checkpoint
    directory that load_policy reads back as the deployed (EMA) weights."""
    monkeypatch.setattr(fused_cli, "load_train_config", lambda: T_CFG)
    ckpt, hist = tmp_path / "ckpt", tmp_path / "history.json"
    out = fused_cli.main(["--map", "mini", "--device", "cpu", "--steps", "4", "--envs", "2",
                          "--vehicles", "3", "--walkers", "1", "--buffer", "512",
                          "--collect-ticks", "5", "--train-per-chunk", "2",
                          "--ckpt-dir", str(ckpt), "--history-json", str(hist)])
    assert out["train_steps"] == 4 and out["frames_collected"] > 0
    with open(hist) as f:
        written = json.load(f)
    assert set(written) == {"history", "frames_collected", "train_steps", "wall_s",
                            "frames_per_sec_train"}
    assert written["history"] == json.loads(json.dumps(out["history"]))
    assert os.path.exists(ckpt / "checkpoint_best.pth")
    with open(ckpt / "best_epoch.txt") as f:
        assert f.read().split()[0] == "1"
    model = load_policy(str(ckpt), T_CFG, "cpu")
    deployed = out["state"].model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, deployed[k]), k


def test_cli_fused_refuses_to_run_on_one_of_several_gpus(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 4"):
        fused_cli.main(["--map", "mini"])
