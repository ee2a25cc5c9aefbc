"""Parity of cilrs_tpu_torch.parallel (process-group init, the mesh, the
sharded fleet) and of the port's two data-parallel paths (the sharded fused
loop, the train loop's host-batch branch) with the JAX package's multi-device
code, at the sizes of tests/test_parallel.py: the mini town, a (1, 1, 1, 1)
trunk, 32x64 frames, batch 16.

The JAX side runs here on the conftest's 8-device virtual CPU mesh with
``make_mesh(2)``; the port's side runs in two ranks spawned on localhost over
gloo, one thread each. A spawned rank does not see a monkeypatch of this
process, so the JAX draws that the port is handed (the pedestrians'
uniforms, the sampler's per-shard ``randint``) are computed here and sent to
the ranks as numpy, and each rank installs them itself. Both ranks do all
their work in one spawn (the ``ranks`` fixture) and write their results to a
file each.

Tolerances:
 - ``shard_batch`` and ``pad_fleet_to_mesh``: exact;
 - the sharded rollout (3 envs over 2 ranks, one env of padding) against
   JAX's ``make_sharded_rollout``: tests/test_torch_collect.py's, integers
   exact, controls 1e-6, speed, position and yaw 1e-3 (one unit of the last
   digit the session CSV prints), at most 0.5% of the u8 frame values off by
   more than 1;
 - the sharded fused loop against ``fused_collect_train(mesh=make_mesh(2))``
   on JAX's draws: every rank's picks, frames collected and steps exact.
   Run a second time with JAX's frames written into the port's rings (each
   collect chunk's frames replaced by the ones JAX's shard wrote), it is
   held to tests/test_torch_fused.py's history tolerances: the held-out
   losses 1e-2 relative, the brake and speed terms 5e-3, the last batch's
   plain loss 1e-1; measured at most 2.4e-3 (raw_val_steer), 1.3e-3 on
   val_steer. On its own frames, the held-out losses and their steer and
   throttle terms are held to 2e-2 relative: the same run differs from
   JAX's by 1.64e-2 on raw_val_steer and 1.03e-2 on val_steer, so what the
   second run removes, the renderers' 1-LSB differences
   (tests/test_torch_render.py), is what the wider bound covers. A rank's
   batch is 8 frames of one env, not 16 of two, which at the random init
   carries those differences further than tests/test_torch_fused.py's run;
 - the data-parallel train step at world 2 against world 1, at dropout 0
   and at dropout 0.5 (the masks are the global batch's, so the same):
   tests/test_parallel.py's bounds, the loss within 5e-3 relative and the
   parameters within 5e-4; the BatchNorm running statistics, which read the
   global batch's statistics, within 1e-5 + 1e-4 relative (reduction order);
   six steps of ``train()`` with augmentation: the val and train losses
   within 3%. At world 2 against JAX's ``make_mesh(2)`` step:
   tests/test_torch_train.py's one-step tolerances (loss parts 1e-3,
   running statistics 5e-4 + 5e-3 relative, parameters within 2 lr);
 - on every path, the two ranks' weights are bit-identical.
"""

import dataclasses
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import cilrs_tpu.train.fused as jfused  # noqa: E402
import cilrs_tpu.train.steps as jsteps  # noqa: E402
import cilrs_tpu_torch.data.collect as tcol  # noqa: E402
import cilrs_tpu_torch.train.fused as tfused  # noqa: E402
import cilrs_tpu_torch.train.steps as tsteps  # noqa: E402
from cilrs_tpu import config as jc  # noqa: E402
from cilrs_tpu.agent import driver as jd  # noqa: E402
from cilrs_tpu.agent import scenario as jsc  # noqa: E402
from cilrs_tpu.core.state import default_vehicle_params as j_params  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.maps.town import make_mini_town as j_mini  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.parallel import fleet as jfleet  # noqa: E402
from cilrs_tpu.parallel import mesh as jmesh  # noqa: E402
from cilrs_tpu.render.camera import CameraSpec as JCam  # noqa: E402
from cilrs_tpu.train.state import create_train_state as j_create_train_state  # noqa: E402
from cilrs_tpu_torch import config as tcfg  # noqa: E402
from cilrs_tpu_torch.core.convert import driver_state_from_arrays, pool_from_arrays  # noqa: E402
from cilrs_tpu_torch.core.state import default_vehicle_params as t_params  # noqa: E402
from cilrs_tpu_torch.data.dataset import make_synthetic_dataset  # noqa: E402
from cilrs_tpu_torch.maps.town import make_mini_town as t_mini  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.parallel import distributed as tdist  # noqa: E402
from cilrs_tpu_torch.parallel import fleet as tfleet  # noqa: E402
from cilrs_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from cilrs_tpu_torch.render.camera import CameraSpec  # noqa: E402
from cilrs_tpu_torch.train import loop as tloop  # noqa: E402
from cilrs_tpu_torch.train.state import create_train_state  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the conftest's 8-device virtual CPU mesh")

WORLD = 2
H, W, B = 32, 64, 16
LR = 1e-4
TINY = dict(dropout=0.0, image_height=H, image_width=W, stage_sizes=(1, 1, 1, 1))
J_CFG = jc.TrainConfig(model=jc.ModelConfig(**TINY), training=jc.TrainingConfig(batch_size=B))
T_CFG = tcfg.TrainConfig(model=tcfg.ModelConfig(**TINY), training=tcfg.TrainingConfig(batch_size=B))
T_CFG_DROPOUT = tcfg.TrainConfig(model=tcfg.ModelConfig(**{**TINY, "dropout": 0.5}),
                                 training=tcfg.TrainingConfig(batch_size=B))
# train(): one epoch of six steps, no EMA (tests/test_parallel.py:157-163).
T_LOOP_CFG = dataclasses.replace(T_CFG, training=tcfg.TrainingConfig(batch_size=B, epochs=1,
                                                                      ema_eval=False))
J_MODEL = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=(1, 1, 1, 1),
                 speed_skip=J_CFG.model.speed_skip)
CAM = dict(width=W, height=H)
# The sharded rollout: 3 envs (padded to 4), 10 ticks.
ROLL_E, ROLL_T, ROLL_P = 3, 10, 2
# The fused loop (tests/test_torch_fused.py's, with 2 envs: one a rank).
LOOP = dict(num_envs=2, num_vehicles=3, num_pedestrians=1, buffer_frames=512, collect_ticks=10,
            train_steps_per_chunk=2, total_train_steps=8, warmup_chunks=4, seed=0, eval_every=4,
            verbose=False)
LOOP_P, SEED = 1, 0
ROLL_TOL = {"control": 1e-6, "speed_kmh": 1e-3, "pos": 1e-3, "yaw": 1e-3}
FRAME_MAX_SHARE = 0.005
LOSS_TOL = dict(rtol=2e-2, atol=0)
SAME_FRAMES_LOSS_TOL = dict(rtol=1e-2, atol=0)
HISTORY_TOL = {"val_brake": dict(rtol=0, atol=5e-3), "val_speed": dict(rtol=0, atol=5e-3),
               "train_loss": dict(rtol=1e-1, atol=0)}
DP_LOSS_RTOL, DP_PARAM_ATOL = 5e-3, 5e-4
DP_STAT_TOL = dict(atol=1e-5, rtol=1e-4)
DP_VAL_RTOL = 0.03
JAX_PART_TOL = dict(atol=1e-3, rtol=0)
JAX_STAT_TOL = dict(atol=5e-4, rtol=5e-3)
DS_FRAMES, DS_SEED, DP_STEPS = 160, 9, 6


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy); each
    test starts and ends with that cache empty."""
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


def tree_np(x):
    """A JAX state as nested dicts of (writable) numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "host"}
    return np.array(x)


def _named(tree, prefix="") -> dict:
    """Leaves of nested dicts or dataclasses by dotted field path, as numpy."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _named(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _params_of(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var",
                                                           "num_batches_tracked"))}


def _stats_of(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


# --------------------------------------------------------------------------
# What a rank runs (torch only; its inputs arrive as numpy)
# --------------------------------------------------------------------------


def _rank_rollout(mesh, inp) -> dict:
    run = tfleet.make_sharded_rollout(mesh, ROLL_T, tcfg.load_weather_table(), t_params(),
                                      mode="collect", cam=CameraSpec(**CAM), want_frames=True,
                                      pool_batched=True)
    final, outs = run(driver_state_from_arrays(inp["states"]), t_mini(),
                      pool_from_arrays(inp["pools"]), torch.from_numpy(inp["draws"]))
    return {"outs": {k: v.numpy() for k, v in outs.items()},
            "time_s": final.world.time_s.numpy(), "ped_yaw": final.world.ped_yaw.numpy(),
            "total_distance": final.metrics.total_distance.numpy()}


def _rank_fused(mesh, inp, jax_frames: bool = False) -> dict:
    """The sharded fused loop on JAX's pedestrian chains (global [T, E, P]
    tensors by generator seed) and this rank's sampler draws; with
    ``jax_frames``, each collect chunk's frames are the ones JAX's shard
    wrote at that chunk."""
    served, drawn, picks, chunks = {}, [], [], []

    def jax_peds(generator, steps, num_envs, num_pedestrians, device):
        assert (steps, num_envs, num_pedestrians) == (LOOP["collect_ticks"], LOOP["num_envs"],
                                                      LOOP_P)
        s = generator.initial_seed()
        k = served[s] = served.get(s, -1) + 1
        return torch.from_numpy(inp["peds"][s][k * steps:(k + 1) * steps])

    def jax_sample_draws(gen, batch, high):
        draws, want_high = inp["draws"][mesh.rank][len(drawn)]
        assert (batch, high) == (draws.shape[1], want_high), (batch, high, want_high)
        drawn.append(high)
        return torch.from_numpy(draws).long()

    def port_state(cfg, seed, device, **kw):
        st = create_train_state(T_CFG, 0, device="cpu", **kw)
        st.model.load_state_dict(inp["state_dict"])
        return st

    t_sample = tfused.sample_batch

    def t_recorded(buf, draws):
        out = t_sample(buf, draws)
        picks.append(out["idx"].numpy().copy())
        return out

    t_collect = tfused.collect_chunk

    def with_jax_frames(fleet, buf, mesh=None):
        own = fleet.chunk

        def chunk():
            outs = own()
            frames = inp["frames"][mesh.rank][len(chunks)]
            chunks.append(1)
            outs["frame"] = torch.from_numpy(frames).reshape(outs["frame"].shape)
            return outs

        fleet.chunk = chunk
        try:
            t_collect(fleet, buf, mesh)
        finally:
            del fleet.chunk

    with pytest.MonkeyPatch.context() as mp:
        if jax_frames:
            mp.setattr(tfused, "collect_chunk", with_jax_frames)
        mp.setattr(tcol, "draw_pedestrians", jax_peds)
        mp.setattr(tfused, "sample_batch", t_recorded)
        mp.setattr(tfused, "draw_indices", jax_sample_draws)
        mp.setattr(tfused, "create_train_state", port_state)
        mp.setattr(tsteps, "augment_batch", lambda gen, x, *a: x)
        out = tfused.fused_collect_train(t_mini(), T_CFG, cam=CameraSpec(**CAM), mesh=mesh,
                                         device="cpu", **LOOP)
    return {"history": out["history"], "frames_collected": out["frames_collected"],
            "train_steps": out["train_steps"], "draws_used": len(drawn), "picks": picks,
            "jax_chunks": len(chunks),
            "state_dict": {k: v.clone() for k, v in out["state"].model.state_dict().items()}}


def _rank_dp_step(mesh, inp, cfg=T_CFG) -> dict:
    """One data-parallel train step on this rank's block of the batch
    (identity augmentation, as in the JAX comparison)."""
    st = create_train_state(cfg, 0, steps_per_epoch=DP_STEPS, device="cpu")
    st.model.load_state_dict(inp["state_dict"])
    batch = {k: torch.from_numpy(v) for k, v in tmesh.shard_batch(mesh, inp["batch"]).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps, "augment_batch", lambda gen, x, *a: x)
        parts = tsteps.make_train_step(cfg, mesh)(st, batch, 7)
    return {"parts": {k: float(v) for k, v in parts.items()},
            "state_dict": {k: v.clone() for k, v in st.model.state_dict().items()}}


def _rank_dp_train(mesh) -> dict:
    ds = make_synthetic_dataset(DS_FRAMES, seed=DS_SEED, h=H, w=W)
    out = tloop.train(ds, T_LOOP_CFG, steps_per_epoch=DP_STEPS, verbose=False, device="cpu",
                      mesh=mesh)
    return {"history": out["history"],
            "state_dict": {k: v.clone() for k, v in out["state"].model.state_dict().items()}}


def _rank_main(rank, world, port, inputs_path, out_dir):
    torch.set_num_threads(1)
    assert tdist.initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        inp = torch.load(inputs_path, weights_only=False)
        mesh = tmesh.make_mesh(world, device="cpu")
        out = {"rollout": _rank_rollout(mesh, inp["rollout"])}
        out["rollout_collectives"] = mesh.collectives
        out["fused"] = _rank_fused(mesh, inp["fused"])
        out["fused_jax_frames"] = _rank_fused(mesh, inp["fused"], jax_frames=True)
        out["dp_step"] = _rank_dp_step(mesh, inp["dp_step"])
        out["dp_step_dropout"] = _rank_dp_step(mesh, inp["dp_step"], T_CFG_DROPOUT)
        out["dp_train"] = _rank_dp_train(mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# The JAX side and the spawn
# --------------------------------------------------------------------------


def _ped_chain(keys, steps, p):
    """JAX's pedestrian uniforms of envs with keys ``keys``: [steps, E, p]."""
    def chain(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (p,))
        return jax.lax.scan(body, key, None, length=steps)[1]

    return np.ascontiguousarray(np.asarray(jax.vmap(chain)(jnp.stack(keys))).transpose(1, 0, 2))


def _jax_draws(key, batch, high):
    """sample_batch's draws for ``key``: the first and the three redraws."""
    keys = [key] + [jax.random.fold_in(key, r) for r in range(1, 4)]
    return jnp.stack([jax.random.randint(k, (batch,), 0, high) for k in keys])


def _jax_variables(seed=0):
    v = J_MODEL.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)), jnp.zeros((1,)),
                     jnp.zeros((1,), jnp.int32))
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def _jax_state(params, stats, **kw):
    st = j_create_train_state(J_CFG, jax.random.PRNGKey(0), **kw)
    params = jax.tree.map(jnp.asarray, params)
    return st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, stats),
                      opt_state=st.tx.init(params), apply_fn=J_MODEL.apply)


def _rollout_fleet(jnet):
    """3 envs as collect_session sets them up, each with its chained pool."""
    rng = np.random.RandomState(3)
    pools, states = [], []
    for e in range(ROLL_E):
        pool, meta = j_routing.chained_route_pool(jnet, rng, num_routes=2, min_dist=40.0,
                                                  max_dist=250.0, with_meta=True)
        w = jsc.spawn_world(jnet, 3, ROLL_P, rng, weather_idx=(0, 3, 0)[e], seed=e)
        s = meta["start_wps"][0]
        w = w.replace(veh_pos=w.veh_pos.at[0].set(jnet.wp_xy[s]),
                      veh_yaw=w.veh_yaw.at[0].set(jnet.wp_yaw[s]), rng=jax.random.PRNGKey(e))
        pools.append(pool)
        states.append(jd.make_driver_state(w))
    return pools, states


def _jax_rollout():
    jnet = j_mini()
    pools, states = _rollout_fleet(jnet)
    stack = lambda trees: jax.tree.map(lambda *x: jnp.stack(x), *trees)
    run = jfleet.make_sharded_rollout(jmesh.make_mesh(WORLD), ROLL_T, jc.load_weather_table(),
                                      j_params(), mode="collect", cam=JCam(**CAM),
                                      want_frames=True, pool_batched=True)
    jstate = stack(states)
    draws = _ped_chain(list(jstate.world.rng), ROLL_T, ROLL_P)
    final, outs = run(jstate, jnet, stack(pools))
    want = {"outs": {k: np.asarray(v).swapaxes(0, 1) for k, v in outs.items()},
            "time_s": np.asarray(final.world.time_s), "ped_yaw": np.asarray(final.world.ped_yaw),
            "total_distance": np.asarray(final.metrics.total_distance)}
    return want, {"states": [tree_np(s) for s in states], "pools": [tree_np(p) for p in pools],
                  "draws": draws}


def _jax_fused(params, stats):
    """JAX's sharded fused loop with each shard's picks, and the draws its
    shards make and the frames they write, chunk by chunk."""
    picks = [[] for _ in range(WORLD)]
    frames = [[] for _ in range(WORLD)]
    j_sample = jfused.sample_batch
    j_write = jfused.write_chunk

    def j_recorded_write(buf, chunk_frames, *args):
        # Every shard writes its chunks in order: the train fleet's warmup,
        # the val fleet's chunks, then one a train chunk.
        jax.debug.callback(lambda r, f: frames[int(r)].append(np.array(f)),
                           jax.lax.axis_index(jmesh.DATA_AXIS), chunk_frames)
        return j_write(buf, chunk_frames, *args)

    def j_recorded(buf, key, batch):
        out = j_sample(buf, key, batch)
        # sample_batch's picks, recomputed from its draws to be recorded (a
        # shard runs its steps in order).
        draws = _jax_draws(key, batch, jnp.maximum(buf.filled, 1))
        idx = draws[0]
        for alt in draws[1:]:
            idx = jnp.where(buf.valid[idx], idx, alt)
        jax.debug.callback(lambda r, i: picks[int(r)].append(np.asarray(i)),
                           jax.lax.axis_index(jmesh.DATA_AXIS), idx)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused, "sample_batch", j_recorded)
        mp.setattr(jfused, "write_chunk", j_recorded_write)
        mp.setattr(jfused, "augment_batch", lambda key, x: x)
        mp.setattr(jfused, "create_train_state",
                   lambda cfg, rng, **kw: _jax_state(params, stats, **kw))
        want = jfused.fused_collect_train(j_mini(), J_CFG, cam=JCam(**CAM),
                                          mesh=jmesh.make_mesh(WORLD), **LOOP)
    jax.effects_barrier()
    want["picks"] = picks
    # The shard-local ring's fill before each train chunk, and the keys of
    # train_local: split the chain once a chunk, fold in the shard, split a
    # key a step.
    m = LOOP["num_envs"] // WORLD * LOOP["collect_ticks"]
    cap = LOOP["buffer_frames"] // WORLD
    per = LOOP["train_steps_per_chunk"]
    chunks = LOOP["total_train_steps"] // per
    stream = int(LOOP["total_train_steps"] * 0.75)
    filled = min(LOOP["warmup_chunks"] * m, cap)
    key = jax.random.PRNGKey(SEED + 7)
    draws = [[] for _ in range(WORLD)]
    draw_jit = jax.jit(_jax_draws, static_argnums=1)
    for c in range(chunks):
        if c * per < stream:
            filled = min(filled + m, cap)
        key, k = jax.random.split(key)
        for r in range(WORLD):
            for sk in jax.random.split(jax.random.fold_in(k, r), per):
                draws[r].append((np.array(draw_jit(sk, B // WORLD, max(filled, 1))), filled))
    steps = 200
    peds = {SEED: _ped_chain([jax.random.PRNGKey(SEED * 997 + e) for e in range(2)], steps, 1),
            SEED + 10_000: _ped_chain([jax.random.PRNGKey(SEED * 1013 + e + 7) for e in range(2)],
                                      steps, 1)}
    return want, {"peds": peds, "draws": draws, "frames": frames,
                  "state_dict": flax_to_state_dict(params, stats)}


def _batch():
    rng = np.random.RandomState(4)
    return {"images": rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8),
            "speed": rng.uniform(0, 0.5, B).astype(np.float32),
            "command": (np.arange(B) % 4).astype(np.int32),
            "controls": np.stack([rng.uniform(-0.3, 0.3, B), rng.uniform(0, 0.8, B),
                                  rng.uniform(0, 0.3, B)], 1).astype(np.float32)}


def _jax_dp_step(params, stats, batch):
    """JAX's train step on make_mesh(2): the batch sharded, the state
    replicated (tests/test_parallel.py:141-170), identity augmentation."""
    mesh = jmesh.make_mesh(WORLD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "augment_batch", lambda key, x: x)
        st = _jax_state(params, stats, steps_per_epoch=DP_STEPS)
        st = jax.tree.map(lambda x: jmesh.replicate(mesh, x) if isinstance(x, jax.Array) else x, st)
        b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jmesh.batch_spec(mesh))
        st2, parts = jax.jit(jsteps.make_train_step(J_CFG))(st, b, jax.random.PRNGKey(7))
    return {"parts": {k: float(v) for k, v in parts.items()},
            "state_dict": flax_to_state_dict(*jax.device_get((st2.params, st2.batch_stats)))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's results, and both ranks' results on the same inputs."""
    root = tmp_path_factory.mktemp("ranks")
    params, stats = _jax_variables(0)
    want_roll, roll_in = _jax_rollout()
    want_fused, fused_in = _jax_fused(params, stats)
    batch = _batch()
    want_step = _jax_dp_step(params, stats, batch)
    inputs = {"rollout": roll_in, "fused": fused_in,
              "dp_step": {"state_dict": flax_to_state_dict(params, stats), "batch": batch}}
    torch.save(inputs, root / "inputs.pt")
    tmp.spawn(_rank_main, args=(WORLD, _free_port(), str(root / "inputs.pt"), str(root)),
              nprocs=WORLD)
    got = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"rollout": want_roll, "fused": want_fused, "dp_step": want_step}, got, inputs


# --------------------------------------------------------------------------
# distributed, mesh, fleet
# --------------------------------------------------------------------------


def test_initialize_distributed_noop_without_torchrun(monkeypatch):
    for var in tdist.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_distributed() is False
    assert not dist.is_initialized()
    assert tdist.is_coordinator() is True
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    x = torch.arange(4.0)
    tmesh.all_reduce_mean_(mesh, [x])  # no group: a no-op
    assert torch.equal(x, torch.arange(4.0)) and mesh.collectives == 0
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tmesh.make_mesh(2)


def test_initialize_distributed_joins_a_described_world_of_one(monkeypatch):
    """Explicit arguments describe a world of 1, which joins (gloo for the
    CPU device); the collectives then run through the group."""
    for var in tdist.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    try:
        assert tdist.initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                                            device="cpu") is True
        assert tdist.initialize_distributed() is True  # idempotent
        mesh = tmesh.make_mesh(device="cpu")
        assert (mesh.rank, mesh.world) == (0, 1) and mesh.group is not None
        assert dist.get_backend() == "gloo" and tdist.is_coordinator()
        x = torch.arange(6.0)
        tmesh.all_reduce_mean_(mesh, [x[:2], x[2:]])
        assert torch.equal(x, torch.arange(6.0)) and mesh.collectives == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_batch_matches_jax_shards(world):
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    jax_shards = sorted(jmesh.shard_batch(jmesh.make_mesh(world), jnp.asarray(x)).addressable_shards,
                        key=lambda s: s.index[0].start or 0)
    assert len(jax_shards) == world
    for r, shard in enumerate(jax_shards):
        mesh = tmesh.Mesh(None, r, world, torch.device("cpu"))
        got = tmesh.shard_batch(mesh, {"t": torch.from_numpy(x), "n": [x]})
        np.testing.assert_array_equal(got["t"].numpy(), np.asarray(shard.data))
        np.testing.assert_array_equal(got["n"][0], np.asarray(shard.data))
    with pytest.raises(ValueError, match="equal blocks"):
        tmesh.shard_batch(tmesh.Mesh(None, 0, 3, torch.device("cpu")), x)


@pytest.mark.parametrize("E,world", [(3, 2), (4, 2), (5, 4), (3, 1)])
def test_pad_fleet_matches_jax(E, world):
    jnet = j_mini()
    _, states = _rollout_fleet(jnet)
    states = (states * 2)[:E]
    jfl = jax.tree.map(lambda *x: jnp.stack(x), *states)
    want, want_e = jfleet.pad_fleet_to_mesh(jfl, jmesh.make_mesh(world))
    got, got_e = tfleet.pad_fleet_to_mesh(driver_state_from_arrays([tree_np(s) for s in states]),
                                          tmesh.Mesh(None, 0, world, torch.device("cpu")))
    assert got_e == want_e == E
    want, got = _named(tree_np(want)), _named(got)
    assert got.keys() <= want.keys() and len(got) > 20
    for k, g in got.items():
        np.testing.assert_array_equal(g, want[k].astype(g.dtype), err_msg=k)


def test_sharded_rollout_matches_jax(ranks):
    want, got, _ = ranks
    want = want["rollout"]
    for r in got:
        g = r["rollout"]
        assert set(g["outs"]) == set(want["outs"])
        for k, w in want["outs"].items():
            a = g["outs"][k]
            assert a.shape == w.shape, k
            if k == "frame":
                d = np.abs(a.astype(int) - w.astype(int))
                assert (d > 1).mean() <= FRAME_MAX_SHARE, k
            elif w.dtype.kind in "biu":
                np.testing.assert_array_equal(a, w.astype(a.dtype), err_msg=k)
            else:
                np.testing.assert_allclose(a, w, atol=ROLL_TOL.get(k, 1e-5), rtol=0, err_msg=k)
        np.testing.assert_array_equal(g["time_s"], want["time_s"])
        np.testing.assert_allclose(g["ped_yaw"], want["ped_yaw"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g["total_distance"], want["total_distance"], atol=1e-3, rtol=0)
    assert got[0]["rollout"]["outs"]["frame"].shape[:2] == (ROLL_E, ROLL_T)
    # Every output and final-state leaf is gathered once; the rollout itself
    # needs no collective.
    assert got[0]["rollout_collectives"] > len(want["outs"])
    for k in want["outs"]:
        np.testing.assert_array_equal(got[0]["rollout"]["outs"][k], got[1]["rollout"]["outs"][k])


# --------------------------------------------------------------------------
# The sharded fused loop
# --------------------------------------------------------------------------


def _check_fused(ranks, run: str, loss_tol: dict):
    want, got, inputs = ranks
    want = want["fused"]
    for rank, r in enumerate(got):
        g = r[run]
        assert len(g["picks"]) == len(want["picks"][rank]) == LOOP["total_train_steps"]
        for step, (a, b) in enumerate(zip(g["picks"], want["picks"][rank])):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank}, step {step}")
        assert g["train_steps"] == want["train_steps"] == LOOP["total_train_steps"]
        assert g["frames_collected"] == want["frames_collected"] > 0
        assert g["draws_used"] == len(inputs["fused"]["draws"][0])
        assert len(g["history"]) == len(want["history"]) == 2
        for h, w in zip(g["history"], want["history"], strict=True):
            assert h.keys() == w.keys()
            assert (h["step"], h["frames"]) == (w["step"], w["frames"])
            for k in w:
                if k not in ("step", "frames", "time_s"):
                    np.testing.assert_allclose(h[k], w[k], **HISTORY_TOL.get(k, loss_tol), err_msg=k)


def test_sharded_fused_loop_matches_jax(ranks):
    _check_fused(ranks, "fused", LOSS_TOL)


def test_sharded_fused_loop_on_jax_frames_matches_jax(ranks):
    """The same run with JAX's frames in the port's rings: what is left is
    the train step's own difference, inside tests/test_torch_fused.py's
    tolerances."""
    _, got, inputs = ranks
    for r in got:
        assert r["fused_jax_frames"]["jax_chunks"] == len(inputs["fused"]["frames"][0]) > 0
    _check_fused(ranks, "fused_jax_frames", SAME_FRAMES_LOSS_TOL)


def test_sharded_fused_loop_keeps_the_ranks_identical(ranks):
    _, got, _ = ranks
    a, b = (r["fused"]["state_dict"] for r in got)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    x, y = ([{k: v for k, v in h.items() if k != "time_s"} for h in r["fused"]["history"]]
            for r in got)
    assert x == y


def test_world_one_mesh_is_the_single_path():
    """A mesh of 1 without a group (the collectives no-ops) runs the
    sharded code and equals mesh=None bit for bit."""
    cfg = {**LOOP, "total_train_steps": 4, "warmup_chunks": 2}
    outs = []
    for mesh in (None, tmesh.make_mesh(device="cpu")):
        outs.append(tfused.fused_collect_train(t_mini(), T_CFG, cam=CameraSpec(**CAM),
                                               device="cpu", mesh=mesh, **cfg))
    a, b = (o["state"].model.state_dict() for o in outs)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert outs[0]["frames_collected"] == outs[1]["frames_collected"]
    strip = lambda h: [{k: v for k, v in x.items() if k != "time_s"} for x in h]
    assert strip(outs[0]["history"]) == strip(outs[1]["history"])


# --------------------------------------------------------------------------
# The train loop's data-parallel branch
# --------------------------------------------------------------------------


def _port_world_one_step(inputs, cfg=T_CFG):
    st = create_train_state(cfg, 0, steps_per_epoch=DP_STEPS, device="cpu")
    st.model.load_state_dict(inputs["dp_step"]["state_dict"])
    batch = {k: torch.from_numpy(v) for k, v in inputs["dp_step"]["batch"].items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps, "augment_batch", lambda gen, x, *a: x)
        parts = tsteps.make_train_step(cfg)(st, batch, 7)
    return {k: float(v) for k, v in parts.items()}, st.model.state_dict()


def _check_dp_step(ranks, run: str, cfg):
    _, got, inputs = ranks
    parts, sd = _port_world_one_step(inputs, cfg)
    for r in got:
        g = r[run]
        assert abs(g["parts"]["loss"] - parts["loss"]) <= DP_LOSS_RTOL * max(1.0, parts["loss"])
        for k, v in _params_of(sd).items():
            np.testing.assert_allclose(g["state_dict"][k].numpy(), v.numpy(), atol=DP_PARAM_ATOL,
                                       rtol=0, err_msg=k)
        for k, v in _stats_of(sd).items():
            np.testing.assert_allclose(g["state_dict"][k].numpy(), v.numpy(), **DP_STAT_TOL,
                                       err_msg=k)
    a, b = (r[run]["state_dict"] for r in got)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    return parts


def test_dp_step_world_two_matches_world_one(ranks):
    _check_dp_step(ranks, "dp_step", T_CFG)


def test_dp_step_with_dropout_world_two_matches_world_one(ranks):
    """At dropout 0.5 each rank applies its rows of the global batch's
    masks, so world 2 stays within the bounds of world 1; masks drawn per
    rank would differ from world 1's by far more than them."""
    parts = _check_dp_step(ranks, "dp_step_dropout", T_CFG_DROPOUT)
    no_dropout = _port_world_one_step(ranks[2])[0]["loss"]
    assert abs(parts["loss"] - no_dropout) > DP_LOSS_RTOL * max(1.0, no_dropout)


def test_dp_step_world_two_matches_jax_mesh_two(ranks):
    want, got, _ = ranks
    want = want["dp_step"]
    g = got[0]["dp_step"]
    assert set(g["parts"]) == set(want["parts"])
    for k, w in want["parts"].items():
        np.testing.assert_allclose(g["parts"][k], w, **JAX_PART_TOL, err_msg=k)
    for k, v in _stats_of(want["state_dict"]).items():
        np.testing.assert_allclose(g["state_dict"][k].numpy(), v.numpy(), **JAX_STAT_TOL, err_msg=k)
    for k, v in _params_of(want["state_dict"]).items():
        assert np.abs(g["state_dict"][k].numpy() - v.numpy()).max() <= 2 * LR, k


def test_dp_train_world_two_matches_world_one(ranks):
    """Six steps of train() with augmentation (drawn for the global batch,
    sliced per rank), world 2 against the resident world-1 path."""
    _, got, _ = ranks
    ds = make_synthetic_dataset(DS_FRAMES, seed=DS_SEED, h=H, w=W)
    one = tloop.train(ds, T_LOOP_CFG, steps_per_epoch=DP_STEPS, verbose=False, device="cpu")
    w1 = one["history"][0]
    for r in got:
        w2 = r["dp_train"]["history"][0]
        for k in ("val_loss", "train_loss"):
            assert np.isfinite(w2[k])
            assert abs(w2[k] - w1[k]) < DP_VAL_RTOL * max(1.0, abs(w1[k])), (k, w2[k], w1[k])
    a, b = (r["dp_train"]["state_dict"] for r in got)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_refuses_a_resident_table_with_a_mesh_of_two():
    ds = make_synthetic_dataset(64, seed=0, h=H, w=W)
    with pytest.raises(ValueError, match="single-device path"):
        tloop.train(ds, T_LOOP_CFG, verbose=False, device="cpu", resident={"images": None},
                    mesh=tmesh.Mesh(None, 0, 2, torch.device("cpu")))
