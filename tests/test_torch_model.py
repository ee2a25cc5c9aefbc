"""CILRS parity: cilrs_tpu_torch.models against the JAX package's CILRS.

Both models get the same variables (JAX init, perturbed with numpy noise so
that biases, BatchNorm statistics and the speed skip are all non-trivial) and
the same numpy inputs. The JAX model runs with dtype=float32 and the port with
dtype=torch.float32, so what is compared is the algorithm, not bf16 rounding in
the trunk. Tolerances:
 - trunk feature, speed encoder and pred_speed: atol 2e-3 / rtol 1e-3, the
   precedent of tests/test_torch_import.py:121-126;
 - controls: atol 1e-3. Both packages take the branch heads' first product
   in bf16 (cilrs_tpu/models/cilrs.py:58-59): its inputs and its result are
   rounded to 8 significant bits (2^-9 relative). The two frameworks round
   that product and float32 inputs that differ in the last bits to
   neighbouring bf16 values, so hidden units of order 1 may differ by about
   2e-3 each; through the float32 second and third layers that moves the
   controls (of order 0.2 here) by a few 1e-4 (measured: 1.9e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.config import LossConfig as JLossConfig  # noqa: E402
from cilrs_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from cilrs_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from cilrs_tpu.config import TrainingConfig as JTrainingConfig  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.models.losses import cilrs_loss as j_loss  # noqa: E402
from cilrs_tpu.models.resnet import ResNet34 as JResNet34  # noqa: E402
from cilrs_tpu.models.torch_import import convert_reference_cilrs  # noqa: E402
from cilrs_tpu.train.steps import make_eval_step as j_make_eval_step  # noqa: E402
from cilrs_tpu_torch.config import LossConfig, ModelConfig, TrainConfig, TrainingConfig  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.models.losses import cilrs_loss  # noqa: E402
from cilrs_tpu_torch.models.resnet import ResNet34  # noqa: E402
from cilrs_tpu_torch.train.checkpoint import load_policy, save_checkpoint_pth  # noqa: E402
from cilrs_tpu_torch.train.steps import make_eval_step  # noqa: E402

TINY = dict(stage_sizes=(1, 1, 1, 1))
H, W = 32, 64
TRUNK_TOL = dict(atol=2e-3, rtol=1e-3)
CONTROL_TOL = dict(atol=1e-3, rtol=0)


def _perturbed_variables(model, shape, seed=0):
    """JAX init, then numpy noise on every leaf: weights x(1 +- 10%), biases
    and the speed skip +-0.1, BN means +-0.1 and variances in [0.5, 1.5]."""
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32),
                   jnp.zeros((1,), jnp.float32), jnp.zeros((1,), jnp.int32))
    rng = np.random.RandomState(seed + 1)

    def param(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name in ("bias", "b1", "b2", "b3", "speed_skip_w"):
            return a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return a * rng.uniform(0.9, 1.1, a.shape).astype(np.float32)

    def stat(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, v["batch_stats"])}


def _port_model(variables, speed_skip, stage_sizes=(1, 1, 1, 1)):
    m = CILRS(dropout=0.5, dtype=torch.float32, stage_sizes=stage_sizes, speed_skip=speed_skip)
    m.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    return m.eval()


def _inputs(seed, b=8, h=H, w=W):
    rng = np.random.RandomState(seed)
    img = rng.randn(b, h, w, 3).astype(np.float32)
    speed = rng.uniform(0, 1, b).astype(np.float32)
    cmd = np.arange(b, dtype=np.int32) % 4
    return img, speed, cmd


@pytest.mark.parametrize("speed_skip", [True, False])
def test_cilrs_forward_matches_jax(speed_skip):
    jm = JCILRS(dropout=0.5, dtype=jnp.float32, speed_skip=speed_skip, **TINY)
    v = _perturbed_variables(jm, (1, H, W, 3))
    img, speed, cmd = _inputs(1)
    jc, jp = jm.apply(v, img, speed, cmd, train=False)
    m = _port_model(v, speed_skip)
    with torch.no_grad():
        tc, tp = m(torch.from_numpy(img), torch.from_numpy(speed), torch.from_numpy(cmd))
    assert tc.dtype == torch.float32 and tc.shape == (8, 3) and tp.shape == (8,)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TRUNK_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **CONTROL_TOL)
    # The skip really contributes, and is gone without it.
    assert hasattr(m, "speed_skip_w") == speed_skip
    # Dropout modules sit where the reference has them; eval mode turns them off.
    assert isinstance(m.speed_encoder[2], torch.nn.Identity if speed_skip else torch.nn.Dropout)


def test_speed_skip_term_is_per_command_linear():
    jm = JCILRS(dropout=0.0, dtype=jnp.float32, speed_skip=True, **TINY)
    v = _perturbed_variables(jm, (1, H, W, 3), seed=3)
    m = _port_model(v, True)
    img, speed, cmd = _inputs(4)
    with torch.no_grad():
        c0, _ = m(torch.from_numpy(img), torch.zeros(8), torch.from_numpy(cmd))
        w = m.speed_skip_w.clone()
        m.speed_skip_w.zero_()
        c1, _ = m(torch.from_numpy(img), torch.from_numpy(speed), torch.from_numpy(cmd))
        m.speed_skip_w.copy_(w)
        c2, _ = m(torch.from_numpy(img), torch.from_numpy(speed), torch.from_numpy(cmd))
    skip = torch.from_numpy(speed)[:, None] * w[torch.from_numpy(cmd).long()]
    torch.testing.assert_close(c2 - c1, skip, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(c0, c2)


def test_trunk_full_frame_padding_matches_jax():
    """At 88x200 the maps go 44x100 -> 22x50 -> 11x25 -> 6x13 -> 3x7; odd
    sizes are where Flax's SAME padding of the stride-2 1x1 downsample and
    torch's padding=0 would part if they differed."""
    jm = JResNet34(dtype=jnp.float32, **TINY)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 88, 200, 3).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 88, 200, 3)))
    v = jax.tree.map(lambda a: np.asarray(a) * rng.uniform(0.9, 1.1, np.shape(a)).astype(np.float32), v)
    want = np.asarray(jm.apply(v, x))
    m = ResNet34(**TINY)
    sd = flax_to_state_dict(
        {"visual_encoder": v["params"], **_dummy_heads()},
        {"visual_encoder": v["batch_stats"]})
    m.load_state_dict({k[len("visual_encoder."):]: t for k, t in sd.items()
                       if k.startswith("visual_encoder.")})
    m.eval()
    sizes = []
    hooks = [m[i].register_forward_hook(lambda _m, _i, o: sizes.append(tuple(o.shape[2:])))
             for i in (0, 4, 5, 6, 7)]
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    for h in hooks:
        h.remove()
    assert sizes == [(44, 100), (22, 50), (11, 25), (6, 13), (3, 7)]
    np.testing.assert_allclose(got.numpy(), want, **TRUNK_TOL)


def _dummy_heads():
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    dense = lambda i, o: {"kernel": z(i, o), "bias": z(o)}  # noqa: E731
    return {"speed_fc1": dense(1, 128), "speed_fc2": dense(128, 128),
            "speed_pred_fc1": dense(512, 256), "speed_pred_fc2": dense(256, 256),
            "speed_pred_out": dense(256, 1),
            "branches": {"w1": z(640, 1024), "b1": z(1024), "w2": z(4, 256, 256),
                         "b2": z(4, 256), "w3": z(4, 256, 3), "b3": z(4, 3)}}


@pytest.mark.parametrize("speed_skip", [True, False])
def test_convert_full_size_names_round_trip(speed_skip):
    """Full ResNet-34 widths: JAX variables -> port state_dict (strict load)
    -> the JAX package's own reference-checkpoint importer -> the same arrays.
    This pins the port's names to the reference's torch names."""
    jm = JCILRS(dtype=jnp.float32, speed_skip=speed_skip)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 88, 200, 3)),
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    rng = np.random.RandomState(7)
    v = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = flax_to_state_dict(v["params"], v["batch_stats"])
    m = CILRS(speed_skip=speed_skip)
    m.load_state_dict(sd)  # strict: every name and shape agrees
    back_p, back_s = convert_reference_cilrs(
        {k: t.numpy() for k, t in m.state_dict().items()})
    want_p = dict(v["params"])
    if speed_skip:  # the reference format has no slot for the skip
        want_p["branches"] = {k: a for k, a in want_p["branches"].items() if k != "speed_skip_w"}
        np.testing.assert_array_equal(m.speed_skip_w.detach().numpy(),
                                      v["params"]["branches"]["speed_skip_w"])
    jax.tree.map(np.testing.assert_array_equal, back_p, want_p)
    jax.tree.map(np.testing.assert_array_equal, back_s, v["batch_stats"])


def test_loss_matches_jax():
    rng = np.random.RandomState(8)
    cp, ct = rng.randn(16, 3).astype(np.float32), rng.randn(16, 3).astype(np.float32)
    sp, st = rng.rand(16).astype(np.float32), rng.rand(16).astype(np.float32)
    cfg = LossConfig(steer_weight=5.0, throttle_weight=1.0, brake_weight=2.0, speed_weight=0.5)
    jcfg = JLossConfig(steer_weight=5.0, throttle_weight=1.0, brake_weight=2.0, speed_weight=0.5)
    jt, jparts = j_loss(cp, sp, ct, st, jcfg)
    tt, tparts = cilrs_loss(*(torch.from_numpy(a) for a in (cp, sp, ct, st)), cfg)
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(tparts[k].item(), float(jparts[k]), rtol=1e-6)
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)


def test_eval_step_matches_jax():
    jcfg = JTrainConfig(model=JModelConfig(dropout=0.0, image_height=H, image_width=W, **TINY),
                        training=JTrainingConfig(batch_size=8))
    cfg = TrainConfig(model=ModelConfig(dropout=0.0, image_height=H, image_width=W, **TINY),
                      training=TrainingConfig(batch_size=8))
    jm = JCILRS(dropout=0.0, dtype=jnp.float32, **TINY)
    v = _perturbed_variables(jm, (1, H, W, 3), seed=9)
    rng = np.random.RandomState(10)
    batch = {"images": rng.randint(0, 256, (8, H, W, 3), dtype=np.uint8),
             "speed": rng.uniform(0, 0.5, 8).astype(np.float32),
             "command": np.array([0, 1, 2, 3, 0, 0, 2, 1], np.int32),
             "controls": rng.uniform(-0.3, 0.8, (8, 3)).astype(np.float32)}

    class _State:  # what make_eval_step reads of a train state
        params, batch_stats, apply_fn = v["params"], v["batch_stats"], jm.apply

    want = j_make_eval_step(jcfg)(_State, {k: jnp.asarray(a) for k, a in batch.items()})
    got = make_eval_step(cfg)(_port_model(v, True), {k: torch.from_numpy(a) for k, a in batch.items()})
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["cmd_count"].numpy(), np.asarray(want["cmd_count"]))
    np.testing.assert_allclose(got["pred"][:, 3].numpy(), np.asarray(want["pred"])[:, 3], **TRUNK_TOL)
    np.testing.assert_allclose(got["pred"][:, :3].numpy(), np.asarray(want["pred"])[:, :3],
                               **CONTROL_TOL)
    for k in ("loss", "steer_l1", "throttle_l1", "brake_l1", "speed_mse", "cmd_steer_err_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **CONTROL_TOL)


@pytest.mark.parametrize("speed_skip", [True, False])
def test_checkpoint_round_trip(tmp_path, speed_skip):
    jm = JCILRS(dtype=jnp.float32, speed_skip=speed_skip, **TINY)
    v = _perturbed_variables(jm, (1, H, W, 3), seed=11)
    m = _port_model(v, speed_skip)
    path = str(tmp_path / "checkpoint_best.pth")
    save_checkpoint_pth(path, m, epoch=3, val_loss=0.25)
    blob = torch.load(path, weights_only=False)
    assert blob["epoch"] == 3 and blob["val_loss"] == 0.25
    cfg = TrainConfig(model=ModelConfig(**TINY))
    back = load_policy(path, cfg, device="cpu")
    assert back.speed_skip == speed_skip and not back.training
    assert back.dtype == torch.float32
    img, speed, cmd = _inputs(12)
    args = (torch.from_numpy(img), torch.from_numpy(speed), torch.from_numpy(cmd))
    with torch.no_grad():
        for a, b in zip(m(*args), back(*args)):  # same weights; channels_last on one side
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
