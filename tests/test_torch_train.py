"""Training slice parity: cilrs_tpu_torch's sampler, optimizer, train step,
training loop and trunk import against the JAX package's, on a (1, 1, 1, 1)
trunk and 32x64 frames, plus the port's own checkpoint, resume and CLI rules.

Both packages get the same weights (JAX init, perturbed with numpy noise) and
the same numpy batches; the JAX model runs in float32 as the port does on the
CPU. Augmentation is set to the identity in both packages (monkeypatched here;
tests/test_torch_augment.py holds it to JAX on JAX's own draws) and dropout
to 0, since jax.random and torch draw different streams. Tolerances:
 - sampler and weights: bit-identical (the same numpy code);
 - optimizer on identical gradients: float32 rounding, rtol 1e-5 / atol 1e-8
   of the parameters (one Adam step moves a parameter by at most lr = 1e-4;
   the two implementations round its terms in another order);
 - loss gradients: the branch heads take bf16 products in both packages
   (cilrs_tpu/models/cilrs.py:53-60), and the gradient through a bf16 cast
   is rounded to bf16 too (2^-9 relative a rounding), which reaches every
   trunk gradient through the branch input. Each gradient tensor's relative
   L2 error is under 2e-2 and the flattened gradients' cosine above 0.9999
   (measured: 7.1e-3 and 0.99999). The L1 targets sit 0.05-0.2 from the
   predictions, so no L1 sign flips between the packages;
 - BatchNorm statistics: atol 1e-5 after one step (float32 sums over a
   batch, from equal weights); atol 5e-4 and rtol 5e-3 after three, when
   the weights they were taken with differ as the next item says, which
   moves activations by a few 1e-4 of their size (measured: 2.2e-4 on
   statistics of order 0.4 that the steps moved by 0.1-0.3);
 - loss parts: atol 1e-3, the controls' tolerance of tests/test_torch_model.py
   (bf16 branch heads);
 - parameters after N Adam steps: each step moves a parameter by at most about
   lr, and a parameter whose gradient is at rounding level may move either
   way, so |difference| <= 2 N lr for every parameter; elsewhere an update
   differs by about the gradients' relative error (1e-2, above), so the
   median difference is under 1e-2 lr (measured: 1.8e-3 lr);
 - the training loop's history after 10 such steps: rtol 5e-3 (those
   parameter differences move the losses by a few 1e-3 of their size;
   measured: 2.2e-3 at most), while the losses fall by 24% between epochs.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import cilrs_tpu.train.loop as jloop  # noqa: E402
import cilrs_tpu.train.steps as jsteps  # noqa: E402
import cilrs_tpu_torch.train.loop as tloop  # noqa: E402
import cilrs_tpu_torch.train.steps as tsteps  # noqa: E402
from cilrs_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from cilrs_tpu.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from cilrs_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from cilrs_tpu.config import TrainingConfig as JTrainingConfig  # noqa: E402
from cilrs_tpu.data import dataset as jds  # noqa: E402
from cilrs_tpu.data.resident import labels_dataset as j_labels_dataset  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.models.losses import cilrs_loss as j_loss  # noqa: E402
from cilrs_tpu.models.torch_import import init_trunk_from_torchvision  # noqa: E402
from cilrs_tpu.ops.gather import LANE  # noqa: E402
from cilrs_tpu.ops.gather import padded_row_elems as j_padded_row_elems  # noqa: E402
from cilrs_tpu.ops.gather import paged_layout as j_paged_layout  # noqa: E402
from cilrs_tpu.ops.image import normalize as j_normalize  # noqa: E402
from cilrs_tpu.parallel.mesh import make_mesh  # noqa: E402
from cilrs_tpu.train.state import create_train_state as j_create_train_state  # noqa: E402
from cilrs_tpu.train.state import make_optimizer as j_make_optimizer  # noqa: E402
from cilrs_tpu_torch import config as tcfg  # noqa: E402
from cilrs_tpu_torch.data import dataset as tds  # noqa: E402
from cilrs_tpu_torch.data.resident import labels_dataset, ship_resident  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict, load_torchvision_trunk  # noqa: E402
from cilrs_tpu_torch.models.losses import cilrs_loss  # noqa: E402
from cilrs_tpu_torch.models.resnet import FlaxBatchNorm2d  # noqa: E402
from cilrs_tpu_torch.ops.image import normalize  # noqa: E402
from cilrs_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from cilrs_tpu_torch.train import state as tstate  # noqa: E402

H, W = 32, 64
TINY = dict(stage_sizes=(1, 1, 1, 1))
BATCH = 8
LR = 1e-4
J_CFG = JTrainConfig(model=JModelConfig(dropout=0.0, image_height=H, image_width=W, **TINY),
                     training=JTrainingConfig(batch_size=BATCH, epochs=2))
T_CFG = tcfg.TrainConfig(model=tcfg.ModelConfig(dropout=0.0, image_height=H, image_width=W, **TINY),
                         training=tcfg.TrainingConfig(batch_size=BATCH, epochs=2))
J_MODEL = JCILRS(dropout=0.0, dtype=jnp.float32, speed_skip=True, **TINY)
STAT_TOL = dict(atol=1e-5, rtol=0)
STEPS_STAT_TOL = dict(atol=5e-4, rtol=5e-3)
LOSS_TOL = dict(atol=1e-3, rtol=0)
LOOP_TOL = dict(rtol=5e-3, atol=0)
OPT_TOL = dict(rtol=1e-5, atol=1e-8)


def _variables(seed):
    """JAX init, then numpy noise: weights x(1 +- 10%), biases and the speed
    skip +-0.1, BN scales x(1 +- 20%), BN means +-0.1, variances [0.5, 1.5]."""
    v = J_MODEL.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)), jnp.zeros((1,)),
                     jnp.zeros((1,), jnp.int32))
    rng = np.random.RandomState(seed + 1)

    def param(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name in ("bias", "b1", "b2", "b3", "speed_skip_w"):
            return a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        return a * rng.uniform(*((0.8, 1.2) if name == "scale" else (0.9, 1.1)),
                               a.shape).astype(np.float32)

    def stat(path, a):
        lo_hi = (-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)
        return rng.uniform(*lo_hi, np.shape(a)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(param, v["params"]),
            jax.tree_util.tree_map_with_path(stat, v["batch_stats"]))


def _jax_state(params, stats, steps_per_epoch):
    st = j_create_train_state(J_CFG, jax.random.PRNGKey(0), steps_per_epoch)
    params = jax.tree.map(jnp.asarray, params)
    return st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, stats),
                      opt_state=st.tx.init(params), apply_fn=J_MODEL.apply)


def _port_state(params, stats, steps_per_epoch):
    st = tstate.create_train_state(T_CFG, 0, steps_per_epoch, device="cpu")
    st.model.load_state_dict(flax_to_state_dict(params, stats))
    return st


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [{"images": rng.randint(0, 256, (BATCH, H, W, 3), dtype=np.uint8),
             "speed": rng.uniform(0, 0.5, BATCH).astype(np.float32),
             "command": (np.arange(BATCH, dtype=np.int32) + k) % 4,
             "controls": np.stack([rng.uniform(-0.3, 0.3, BATCH), rng.uniform(0, 0.8, BATCH),
                                   rng.uniform(0, 0.3, BATCH)], 1).astype(np.float32)}
            for k in range(n)]


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _identity_augment(mp):
    mp.setattr(jsteps, "augment_batch", lambda key, x: x)
    mp.setattr(tsteps, "augment_batch", lambda gen, x: x)


def _stats_of(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


# --------------------------------------------------------------------------
# Sampler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hard_boost", [0.0, 2.0])
def test_sampler_stream_bit_identical(hard_boost):
    ds = jds.make_synthetic_dataset(500, seed=3, h=2, w=2)
    cmd = np.concatenate([ds.command[:400] % 3, ds.command[400:]])  # skewed counts
    ctl = None if hard_boost == 0.0 else ds.controls
    want = jds.command_weights(cmd, ctl, hard_boost)
    got = tds.command_weights(cmd, ctl, hard_boost)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    js = jds.WeightedBatchSampler(cmd, 16, 7, controls=ds.controls, hard_boost=hard_boost)
    ts = tds.WeightedBatchSampler(cmd, 16, 7, controls=ds.controls, hard_boost=hard_boost)
    for _ in range(2):
        for a, b in zip(js.epoch(9), ts.epoch(9), strict=True):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(js(), ts())


# --------------------------------------------------------------------------
# Optimizer: clip -> coupled L2 -> Adam -> schedule
# --------------------------------------------------------------------------


def _optimizer_run(schedule, grad_scale, steps=7, spe=2):
    """The same numpy gradients through optax and the port for ``steps``
    updates; returns the two final parameter dicts."""
    cfg = JOptimizerConfig(learning_rate=LR, lr_step_epochs=1, lr_step_gamma=0.5)
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(5, 7).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * grad_scale).astype(np.float32) for k, v in params.items()}
             for _ in range(steps)]
    tx = j_make_optimizer(cfg, spe, schedule=schedule, total_steps=steps + 3)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tcfg_opt = tcfg.OptimizerConfig(learning_rate=LR, lr_step_epochs=1, lr_step_gamma=0.5)
    opt, sched = tstate.make_optimizer(tp.values(), tcfg_opt, spe, schedule=schedule,
                                       total_steps=steps + 3)
    norms = []
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(tstate.clip_by_global_norm_(list(tp.values()), cfg.gradient_clip)))
        opt.step()
        sched.step()
    return {k: np.asarray(v) for k, v in jp.items()}, {k: v.detach().numpy() for k, v in tp.items()}, norms


@pytest.mark.parametrize("schedule", ["step", "cosine"])
@pytest.mark.parametrize("clip", ["inactive", "active"])
def test_optimizer_matches_optax(schedule, clip):
    """7 updates, 2 steps an epoch, the lr halving every epoch: the StepLR
    boundary falls between updates 1|2, 3|4 and 5|6."""
    scale = 0.01 if clip == "inactive" else 10.0
    want, got, norms = _optimizer_run(schedule, scale)
    assert all(n < 1.0 for n in norms) if clip == "inactive" else all(n > 1.0 for n in norms)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **OPT_TOL, err_msg=k)


def test_schedules_match_optax():
    cfg = tcfg.OptimizerConfig(learning_rate=LR, lr_step_epochs=3, lr_step_gamma=0.5)
    step = tstate.step_lr(cfg, steps_per_epoch=10)
    assert [step(c) for c in (0, 29, 30, 59, 60)] == pytest.approx(
        [1e-4, 1e-4, 5e-5, 5e-5, 2.5e-5], rel=1e-12)
    for total in (7, 100, 2000):
        warmup = min(max(total // 50, 10), max(total // 2, 1))
        want = optax.warmup_cosine_decay_schedule(
            init_value=LR * 0.05, peak_value=LR, warmup_steps=warmup,
            decay_steps=max(total, warmup + 1), end_value=LR * 0.01)
        got = tstate.cosine_lr(cfg, total)
        counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total, total + 50})
        # optax evaluates in float32, the port in float64: a few float32 ulps.
        np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts],
                                   rtol=5e-6, err_msg=str(total))
    # The port's LambdaLR gives update t the schedule's value at t.
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = tstate.make_optimizer([p], cfg, 10)
    lrs = []
    for _ in range(35):
        lrs.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    assert lrs == pytest.approx([step(t) for t in range(35)], rel=1e-12)


# --------------------------------------------------------------------------
# Loss gradients, BatchNorm statistics, train step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's three train steps (identity augmentation, dropout
    0) and its loss gradient at the initial weights on the first batch."""
    params, stats = _variables(0)
    batches = _batches(3, seed=1)
    # L1's gradient is the sign of (prediction - target), which flips when
    # the two lie within rounding of each other; the targets are set 0.05-0.2
    # from the initial weights' predictions, so that no sign hinges on it.
    rng = np.random.RandomState(2)
    for b in batches:
        (pred, _), _ = J_MODEL.apply(
            {"params": params, "batch_stats": stats}, j_normalize(b["images"] / np.float32(255)),
            b["speed"], b["command"], train=True, mutable=["batch_stats"])
        off = rng.uniform(0.05, 0.2, pred.shape) * rng.choice([-1, 1], pred.shape)
        b["controls"] = (np.asarray(pred) + off).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _identity_augment(mp)
        state = _jax_state(params, stats, steps_per_epoch=100)
        step = jax.jit(jsteps.make_train_step(J_CFG))
        parts, after = [], []
        for b in batches:
            state, p = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
            parts.append({k: float(v) for k, v in p.items()})
            after.append(jax.device_get((state.params, state.batch_stats)))

    def loss_fn(p, b):
        x = j_normalize(b["images"].astype(jnp.float32) / 255.0)
        (controls, ps), _ = J_MODEL.apply({"params": p, "batch_stats": stats}, x, b["speed"],
                                          b["command"], train=True, mutable=["batch_stats"])
        return j_loss(controls, ps, b["controls"], b["speed"], J_CFG.loss)[0]

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batches[0].items()}))
    return {"params": params, "stats": stats, "batches": batches, "parts": parts,
            "after": after, "grads": grads}


def test_loss_gradients_match_jax(jax_steps):
    st = _port_state(jax_steps["params"], jax_steps["stats"], 100)
    b = _tensors(jax_steps["batches"][0])
    model = st.model.train()
    controls, ps = model(normalize(b["images"].float() / 255.0), b["speed"], b["command"])
    cilrs_loss(controls, ps, b["controls"], b["speed"], T_CFG.loss)[0].backward()
    want = flax_to_state_dict(jax_steps["grads"], jax_steps["stats"])
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == {k for k in want if not k.endswith(("running_mean", "running_var",
                                                          "num_batches_tracked"))}
    flat_g, flat_w = [], []
    for k, g in got.items():
        w = want[k].numpy()
        assert np.linalg.norm(g.numpy() - w) <= 2e-2 * np.linalg.norm(w), k
        flat_g.append(g.numpy().ravel())
        flat_w.append(w.ravel())
    a, c = np.concatenate(flat_g), np.concatenate(flat_w)
    assert a @ c / (np.linalg.norm(a) * np.linalg.norm(c)) > 0.9999


def _port_steps(jax_steps, n, mp):
    _identity_augment(mp)
    st = _port_state(jax_steps["params"], jax_steps["stats"], 100)
    step = tsteps.make_train_step(T_CFG)
    parts = [step(st, _tensors(b), 1) for b in jax_steps["batches"][:n]]
    return st, parts


def test_batchnorm_running_stats_follow_flax(jax_steps, monkeypatch):
    """One train step moves the running mean and the running variance as
    Flax does: the variance with the biased batch variance. The same step
    with stock BatchNorm2d (unbiased running variance) misses by far more
    than the tolerance in the last stage, where a batch of 8 has 16 values
    a channel."""
    st, _ = _port_steps(jax_steps, 1, monkeypatch)
    want = _stats_of(flax_to_state_dict(*jax_steps["after"][0]))
    got = _stats_of(st.model.state_dict())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **STAT_TOL, err_msg=k)
    before = _stats_of(flax_to_state_dict(jax_steps["params"], jax_steps["stats"]))
    assert any(not torch.allclose(got[k], before[k]) for k in got)  # the step moved them

    stock = _port_state(jax_steps["params"], jax_steps["stats"], 100)
    for m in stock.model.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.__class__ = torch.nn.BatchNorm2d
    tsteps.make_train_step(T_CFG)(stock, _tensors(jax_steps["batches"][0]), 1)
    worst = max(float((v - want[k]).abs().max()) for k, v in _stats_of(stock.model.state_dict()).items())
    assert worst > 100 * STAT_TOL["atol"]


def test_train_step_matches_jax_for_three_steps(jax_steps, monkeypatch):
    st, parts = _port_steps(jax_steps, 3, monkeypatch)
    assert st.step == 3
    for got, want in zip(parts, jax_steps["parts"], strict=True):
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == () and not got[k].requires_grad
            np.testing.assert_allclose(got[k].item(), want[k], **LOSS_TOL, err_msg=k)
    want_sd = flax_to_state_dict(*jax_steps["after"][2])
    sd = st.model.state_dict()
    for k, v in _stats_of(want_sd).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **STEPS_STAT_TOL, err_msg=k)
    diffs = []
    for k, p in st.model.named_parameters():
        d = np.abs(p.detach().numpy() - want_sd[k].numpy())
        assert d.max() <= 2 * 3 * LR, k
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) < 1e-2 * LR


def test_train_step_draws_depend_only_on_seed_and_step():
    """Augmentation and dropout draw from (seed, step) alone: the same step
    from the same state gives the same update, another step count another
    one, and the global random state is left as it was."""
    cfg = dataclasses.replace(T_CFG, model=dataclasses.replace(T_CFG.model, dropout=0.5))
    b = _tensors(_batches(1, seed=4)[0])
    step = tsteps.make_train_step(cfg)

    def run(at_step, global_seed):
        st = tstate.create_train_state(cfg, 3, device="cpu")
        st.step = at_step
        torch.manual_seed(global_seed)  # the global stream must not matter
        return step(st, b, 5)["loss"].item(), st.model.speed_predictor[0].weight.detach().clone()

    (l1, w1), (l2, w2), (l3, _) = run(7, 0), run(7, 1), run(8, 0)
    assert l1 == l2 and torch.equal(w1, w2)
    assert l3 != l1
    st = tstate.create_train_state(cfg, 3, device="cpu")
    before = torch.get_rng_state()
    step(st, b, 5)
    assert torch.equal(torch.get_rng_state(), before)
    assert tsteps.step_seeds(5, 7) == tsteps.step_seeds(5, 7) != tsteps.step_seeds(5, 8)


# --------------------------------------------------------------------------
# The training loop against the JAX package's, on a 2-page table
# --------------------------------------------------------------------------


def _jax_table(ds, max_page_bytes):
    d = H * W * 3
    d_pad = j_padded_row_elems(d, np.uint8)
    num_pages, page_rows, _ = j_paged_layout(len(ds), d_pad, 0, max_page_bytes)
    pages = []
    for p in range(num_pages):
        rows = np.arange(p * page_rows, min((p + 1) * page_rows, len(ds)))
        blk = np.zeros((len(rows), d_pad // LANE, LANE), np.uint8)
        blk.reshape(len(rows), -1)[:, :d] = ds.images[rows].reshape(len(rows), -1)
        pages.append(jnp.asarray(blk))
    return {"images": tuple(pages), "page_rows": page_rows, "image_shape": (H, W, 3),
            "speed": jnp.asarray(ds.speed_norm), "command": jnp.asarray(ds.command),
            "controls": jnp.asarray(ds.controls)}


def _labels(ds):
    return {"speed": ds.speed_norm, "command": ds.command, "controls": ds.controls}


def test_train_loop_matches_jax_on_two_page_table(tmp_path, monkeypatch):
    """train() of both packages from the same weights over a 2-page table:
    2 epochs of 5 steps (one 5-step group each), EMA on, epoch eval on the
    EMA and the raw iterate over 3 val batches read in place by global row,
    best and latest slots. Histories agree within LOOP_TOL, the val rows
    exactly, the best epoch exactly."""
    n = 160
    ds = tds.make_synthetic_dataset(n, seed=8, h=H, w=W)
    jtable = _jax_table(jds.make_synthetic_dataset(n, seed=8, h=H, w=W), 100 * 8192)
    ttable = ship_resident(ds, "cpu", max_page_bytes=100 * H * W * 3)
    assert len(jtable["images"]) == len(ttable["images"]) == 2
    assert jtable["page_rows"] == ttable["page_rows"]
    params, stats = _variables(3)
    spe = 5
    _identity_augment(monkeypatch)
    monkeypatch.setattr(jloop, "create_train_state",
                        lambda cfg, rng, steps: _jax_state(params, stats, steps))
    monkeypatch.setattr(tloop, "create_train_state",
                        lambda cfg, seed, steps, device: _port_state(params, stats, steps))
    jout = jloop.train(j_labels_dataset(_labels(ds)), J_CFG, ckpt_dir=str(tmp_path / "j"),
                       steps_per_epoch=spe, verbose=False, mesh=make_mesh(1), resident=jtable)
    tout = tloop.train(labels_dataset(_labels(ds)), T_CFG, ckpt_dir=str(tmp_path / "t"),
                       device="cpu", steps_per_epoch=spe, verbose=False, resident=ttable)

    assert len(tout["history"]) == len(jout["history"]) == 2
    for got, want in zip(tout["history"], jout["history"], strict=True):
        assert got.keys() == want.keys()
        assert got["epoch"] == want["epoch"]
        for k in want:
            if k not in ("epoch", "time_s"):
                np.testing.assert_allclose(got[k], want[k], **LOOP_TOL, err_msg=k)
    assert jout["history"][1]["train_loss"] < 0.9 * jout["history"][0]["train_loss"]
    np.testing.assert_array_equal(tout["val_rows"], jout["val_rows"])
    assert tout["val_table"]["images"] is ttable["images"]  # read in place
    np.testing.assert_allclose(tout["best_val_loss"], jout["best_val_loss"], **LOOP_TOL)
    best = [open(tmp_path / d / "best_epoch.txt").read().split()[0] for d in ("j", "t")]
    assert best[0] == best[1]
    assert len(tout["group_losses"]) == 2 and np.all(np.isfinite(tout["group_losses"]))
    with open(tmp_path / "t" / "training_history.csv") as f:
        assert f.readline().strip().split(",") == list(jout["history"][0])
    assert tout["eval_state"].model is not tout["state"].model  # the EMA copy
    assert tout["state"].step == 2 * spe


def test_refresh_swaps_train_table(tmp_path):
    """train(refresh_fn=..., refresh_every=1): the train table is swapped
    after every epoch but the last, training goes on across swaps, and the
    returned val table is a snapshot of the first table's val rows."""
    n = 120
    ds = tds.make_synthetic_dataset(n, seed=9, h=H, w=W)
    table = ship_resident(ds, "cpu", max_page_bytes=70 * H * W * 3)
    assert len(table["images"]) == 2
    calls = []

    def refresh(i):
        calls.append(i)
        perm = np.arange(n)[::-1].copy()  # same frames, new row order
        sub = tds.DriveDataset(ds.images[perm], ds.speed_norm[perm], ds.command[perm],
                               ds.controls[perm])
        return ship_resident(sub, "cpu", max_page_bytes=70 * H * W * 3), labels_dataset(_labels(sub))

    cfg = dataclasses.replace(T_CFG, training=dataclasses.replace(T_CFG.training, epochs=3))
    out = tloop.train(labels_dataset(_labels(ds)), cfg, device="cpu", steps_per_epoch=2,
                      verbose=False, resident=table, refresh_fn=refresh, refresh_every=1)
    assert calls == [1, 2]
    assert len(out["history"]) == 3 and np.isfinite(out["best_val_loss"])
    _, val_idx = tds.stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
    vt = out["val_table"]
    assert len(vt["images"]) == 1 and vt["images"][0].shape[0] == len(val_idx)
    np.testing.assert_array_equal(vt["images"][0].numpy(), ds.images[val_idx].reshape(len(val_idx), -1))
    np.testing.assert_array_equal(vt["speed"].numpy(), ds.speed_norm[val_idx])
    np.testing.assert_array_equal(out["val_rows"], np.arange(len(val_idx)))

    def bad_refresh(i):
        t, lab = refresh(i)
        return dict(t, page_rows=t["page_rows"] + 1), lab

    with pytest.raises(ValueError, match="page_rows"):
        tloop.train(labels_dataset(_labels(ds)), cfg, device="cpu", steps_per_epoch=1,
                    verbose=False, resident=table, refresh_fn=bad_refresh, refresh_every=1)
    with pytest.raises(ValueError, match="refresh_fn"):
        tloop.train(labels_dataset(_labels(ds)), cfg, device="cpu", resident=table,
                    refresh_fn=refresh, max_train_frames=10)


# --------------------------------------------------------------------------
# Torchvision trunk import
# --------------------------------------------------------------------------

_SLOT_NAMES = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}


def _torchvision_sd(seed):
    """A random torchvision resnet34 state dict (its names, fc included)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in CILRS().visual_encoder.state_dict().items():
        slot, _, rest = k.partition(".")
        sd[f"{_SLOT_NAMES[slot]}.{rest}"] = (torch.tensor(5) if k.endswith("num_batches_tracked")
                                             else torch.from_numpy(rng.randn(*v.shape).astype(np.float32)))
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_torchvision_trunk_import_matches_jax(tmp_path):
    jm = JCILRS(dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 88, 200, 3)),
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    rng = np.random.RandomState(1)
    v = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = _torchvision_sd(2)
    p, s = init_trunk_from_torchvision(v["params"], v["batch_stats"],
                                       {k: t.numpy() for k, t in sd.items()})
    want = flax_to_state_dict(jax.device_get(p), jax.device_get(s))
    model = CILRS()
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    path = str(tmp_path / "resnet34.pth")
    torch.save(sd, path)
    load_torchvision_trunk(model, path)
    got = model.state_dict()
    for k, t in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    # The heads stay as they were.
    np.testing.assert_array_equal(got["speed_skip_w"].numpy(),
                                  v["params"]["branches"]["speed_skip_w"])
    bad = dict(sd, **{"layer2.0.conv1.weight": torch.zeros(128, 64, 3, 1)})
    with pytest.raises(ValueError, match="does not fit"):
        load_torchvision_trunk(CILRS(), bad)
    with pytest.raises(ValueError, match="lacks"):
        load_torchvision_trunk(CILRS(), {k: t for k, t in sd.items() if not k.startswith("layer4")})
    with pytest.raises(ValueError, match="does not fit"):  # a trunk of other depth
        load_torchvision_trunk(CILRS(**TINY), sd)


# --------------------------------------------------------------------------
# Checkpoints, resume and the CLI (port only)
# --------------------------------------------------------------------------


def test_checkpoint_save_resume(tmp_path):
    d = str(tmp_path / "ck")
    st = tstate.create_train_state(T_CFG, 0, device="cpu")
    tsteps.make_train_step(T_CFG)(st, _tensors(_batches(1, seed=5)[0]), 1)  # Adam state exists
    st.step = 123
    tckpt.save_checkpoint(d, st, epoch=3, val_loss=0.5, is_best=True,
                          extra={"cmd_steer_errors": {"LEFT": 0.1}})

    fresh = tstate.create_train_state(T_CFG, 7, device="cpu")
    restored, epoch, val = tckpt.restore_latest(d, fresh)
    assert epoch == 3 and val == 0.5 and restored.step == 123
    for (k, a), b in zip(st.model.state_dict().items(), restored.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    sa, sb = st.optimizer.state_dict(), restored.optimizer.state_dict()
    for i in sa["state"]:
        for k in sa["state"][i]:
            torch.testing.assert_close(sa["state"][i][k], sb["state"][i][k], rtol=0, atol=0)
    assert restored.scheduler.last_epoch == st.scheduler.last_epoch

    best = tckpt.restore_best_params(d, tstate.create_train_state(T_CFG, 9, device="cpu"))
    torch.testing.assert_close(best.model.speed_skip_w, st.model.speed_skip_w)
    payload = tckpt.restore_best_payload(d)
    assert payload["epoch"] == 3 and tckpt.payload_speed_skip(payload) and payload["speed_skip"]
    assert payload["cmd_steer_errors"] == {"LEFT": 0.1}
    assert open(os.path.join(d, "best_epoch.txt")).read().split() == ["3", "0.5"]
    # The best slot is a notebook-format policy file.
    policy = tckpt.load_policy(os.path.join(d, tckpt.BEST_NAME), T_CFG, device="cpu")
    x = torch.zeros(2, H, W, 3)
    with torch.no_grad():
        torch.testing.assert_close(policy(x, torch.zeros(2), torch.zeros(2, dtype=torch.int32)),
                                   st.model.eval()(x, torch.zeros(2), torch.zeros(2, dtype=torch.int32)))

    # The latest slot rolls: the newest 3 epochs stay.
    for e in (4, 5, 6, 7):
        tckpt.save_checkpoint(d, st, epoch=e, val_loss=0.1 * e, latest=True)
    assert sorted(os.listdir(os.path.join(d, "latest"))) == [
        f"checkpoint_epoch_{e:04d}.pth" for e in (5, 6, 7)]
    # Without a best file, the best payload falls back to best_epoch.txt's
    # epoch in the rolling slot, else to its newest.
    os.remove(os.path.join(d, tckpt.BEST_NAME))
    assert tckpt.restore_best_payload(d)["epoch"] == 7
    with open(os.path.join(d, "best_epoch.txt"), "w") as f:
        f.write("6 0.6\n")
    assert tckpt.restore_best_payload(d)["epoch"] == 6
    assert tckpt.restore_latest(str(tmp_path / "none"), fresh)[1:] == (0, float("inf"))


def test_full_train_loop_tiny_and_resume(tmp_path):
    """Ship-once path: 2 epochs, then a resume to 3 starts at epoch 3 from
    the latest slot (model, optimizer, schedule and step restored)."""
    ds = tds.make_synthetic_dataset(96, seed=0, h=H, w=W)
    cfg = dataclasses.replace(T_CFG, training=tcfg.TrainingConfig(batch_size=16, epochs=2))
    out = tloop.train(ds, cfg, ckpt_dir=str(tmp_path / "run"), device="cpu", steps_per_epoch=3,
                      verbose=False)
    assert len(out["history"]) == 2 and np.isfinite(out["best_val_loss"])
    assert out["val_table"] is None and out["state"].step == 6
    assert os.path.exists(tmp_path / "run" / "training_history.csv")
    cfg3 = dataclasses.replace(cfg, training=tcfg.TrainingConfig(batch_size=16, epochs=3))
    out2 = tloop.train(ds, cfg3, ckpt_dir=str(tmp_path / "run"), resume=True, device="cpu",
                       steps_per_epoch=3, verbose=False)
    assert [h["epoch"] for h in out2["history"]] == [3]
    assert out2["state"].step == 9
    assert out2["state"].scheduler.last_epoch == 9


def _tiny_config(tmp_path):
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        f.write('{"model": {"dropout": 0.5, "image_height": 32, "image_width": 64,'
                ' "stage_sizes": [1, 1, 1, 1]}, "training": {"batch_size": 8}}')
    return path


def test_train_cli_on_cpu(tmp_path):
    from cilrs_tpu_torch.cli import train as cli

    tds.save_session(str(tmp_path / "s"), tds.make_synthetic_dataset(120, seed=12, h=H, w=W))
    run = str(tmp_path / "run")
    args = ["--data", str(tmp_path / "s"), "--ckpt-dir", run, "--config", _tiny_config(tmp_path),
            "--device", "cpu"]
    out = cli.main(args + ["--epochs", "2"])
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    assert out["state"].model.visual_encoder[4][0].conv1.weight.shape[0] == 64  # (1,1,1,1) trunk
    for name in ("training_history.csv", "best_epoch.txt", tckpt.BEST_NAME,
                 "latest/checkpoint_epoch_0002.pth"):
        assert os.path.exists(os.path.join(run, name)), name
    out = cli.main(args + ["--epochs", "3", "--resume"])
    assert [h["epoch"] for h in out["history"]] == [3]
    cfg = tcfg.load_train_config(_tiny_config(tmp_path))
    policy = tckpt.load_policy(os.path.join(run, tckpt.BEST_NAME), cfg, device="cpu")
    assert policy.speed_skip and not policy.training


def test_train_then_report_through_the_clis(tmp_path):
    """collect -> train -> report inside the port, at the configured full
    width (ResNet-34) on small frames: the best slot goes to cli.report."""
    from cilrs_tpu_torch.cli import report as report_cli
    from cilrs_tpu_torch.cli import train as train_cli

    tds.save_session(str(tmp_path / "s"), tds.make_synthetic_dataset(60, seed=13, h=H, w=W))
    run = str(tmp_path / "run")
    train_cli.main(["--data", str(tmp_path / "s"), "--ckpt-dir", run, "--epochs", "1",
                    "--batch-size", "4", "--device", "cpu"])
    report = report_cli.main(["--data", str(tmp_path / "s"), "--checkpoint",
                              os.path.join(run, tckpt.BEST_NAME), "--out", str(tmp_path / "r.json"),
                              "--batch-size", "4", "--device", "cpu"])
    assert report["num_samples"] > 0 and np.isfinite(report["steer"]["mae"])


@pytest.mark.parametrize("entry", ["create_train_state", "train", "cli"])
def test_no_cpu_fallback(entry, tmp_path, monkeypatch):
    """Training entry points called with the default device raise when there
    is no GPU, before any work."""
    from cilrs_tpu_torch.cli import train as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = tds.make_synthetic_dataset(20, seed=0, h=4, w=4)
    tds.save_session(str(tmp_path / "s"), ds)
    call = {
        "create_train_state": lambda: tstate.create_train_state(T_CFG, 0),
        "train": lambda: tloop.train(ds, T_CFG, ckpt_dir=str(tmp_path / "run")),
        "cli": lambda: cli.main(["--data", str(tmp_path / "s"), "--ckpt-dir", str(tmp_path / "run")]),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        call()
    assert not os.path.exists(tmp_path / "run")
