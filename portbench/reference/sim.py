"""The simulator's check: the reference follows each sampled tick of a chunk
from the program's own state, so that the bf16 policy's rounding does not
compound over ticks into a different drive.

At tick t the program recorded its state s_t, its float frame, its controls
and its state s_t+1. The reference, the frozen copy in float32 with the plain
sin hashes, renders s_t itself through the configuration's camera, runs the
architecture's reference policy (``policies/<arch>.py:reference_policy``) on
its own frame and observation, and acts on s_t with its own controls and the
same pedestrian draws. The numbers:

 - ``frame_gap``: mean |frame - reference frame| over the sampled ticks' pixels;
 - ``controls_rms``: root mean square of controls - reference controls (the
   widest gap, ``controls_max``, is reported beside it: it swings from seed to
   seed with the random weights);
 - ``act_gap``: widest |s_t+1 - reference s_t+1| over the vehicles'
   positions (m), headings (rad), speeds (m/s) and applied controls, where
   the reference acts with the program's controls, so that the bf16 policy's
   rounding does not enter it;
 - ``carry_gap``, where the architecture's policy carries state from tick
   to tick (its ``carry`` hook): widest |program carry after the tick -
   reference carry after the tick| over every leaf, where the reference
   policy starts from the program's carry before the tick (the sampled ticks
   are not consecutive, so it cannot build the carry up itself); it holds
   the program's update of the carry to the reference's;
 - ``start_mismatch``: elements of the map and the first world that differ
   from what the reference builds from the same seed, and routes of the pool
   whose length differs (the start, which the tick-by-tick check skips; the
   ticks are followed on the program's routes).

The control (``quant=True``) is the reference one precision down: its frame
and its next state rounded to bfloat16 (the simulator states float32) and
its policy in fp8 e4m3 with a per-tensor scale (the policy states bfloat16),
weights and the inputs of every convolution and linear module.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from portbench import harness
from portbench.reference.frozen.agent import driver as F_driver
from portbench.reference.frozen.agent.scenario import spawn_world
from portbench.reference.frozen.config import load_weather_table, weather_index
from portbench.reference.frozen.core.convert import pool_from_arrays, world_from_arrays
from portbench.reference.frozen.core.state import default_vehicle_params, tree_map
from portbench.reference.frozen.evaluation.scoring import compute_scores
from portbench.reference.frozen.maps.routing import chained_route_pool, trace_route
from portbench.reference.frozen.maps.town import make_town01
from portbench.reference.frozen.render.camera import CameraSpec

FROZEN = "portbench.reference.frozen."
STATE_LEAVES = ("veh_pos", "veh_yaw", "veh_speed", "veh_control")


def _frozen_classes() -> dict[str, type]:
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith(FROZEN) and mod is not None:
            for v in vars(mod).values():
                if isinstance(v, type) and dataclasses.is_dataclass(v) and v.__module__ == name:
                    out[v.__name__] = v
    return out


def to_frozen(x, classes=None):
    """A tree of the program's dataclasses as the frozen copy's classes (by
    class name, field by field); tensors are shared, not copied."""
    classes = classes or _frozen_classes()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = classes[type(x).__name__]
        return cls(**{f.name: to_frozen(getattr(x, f.name), classes)
                      for f in dataclasses.fields(x) if f.init})
    return x


def _leaves(tree, prefix=""):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            if f.compare:
                yield from _leaves(getattr(tree, f.name), f"{prefix}{f.name}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree


def mismatches(a, b) -> int:
    """Elements of two trees (or tensors) that differ, shapes included."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    if la.keys() != lb.keys():
        return 1 + len(la.keys() ^ lb.keys())
    n = 0
    for k, x in la.items():
        y = lb[k].to(x.device)
        n += x.numel() if x.shape != y.shape else int((x != y).sum())
    return n


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with a per-tensor scale (amax to 448)."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def quantize_(model: torch.nn.Module) -> None:
    """The control's policy: fp8 weights, and fp8 inputs into every
    convolution and linear module (a layer whose weight the forward passes to
    ``F.linear`` itself, as the CILRS's branch heads do, has only its weight
    rounded)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.copy_(fp8(m.weight))
                m.register_forward_pre_hook(lambda _, args: (fp8(args[0]),) + args[1:])


def camera(sim: dict) -> CameraSpec:
    """The configuration's camera: ``sim.camera``'s fields by name, the rest
    ``CameraSpec``'s defaults."""
    return CameraSpec(**sim["camera"])


def reference_policy(model_cfg: dict, sd: dict, device, quant: bool = False):
    """The configuration's architecture's reference policy
    (``policies/<arch>.py:reference_policy``) over its reference model in
    float32 and eval mode holding the run's weights (in fp8 for the
    control): a function of (frame01, obs, state, pool) to controls [E, 3],
    and where the architecture carries state, of (frame01, obs, state, pool,
    carry=) to (controls, the carry after the tick)."""
    arch = harness.architecture(model_cfg)
    model = arch.reference(model_cfg).to(device)
    model.load_state_dict(sd)
    model.eval()
    if quant:
        quantize_(model)

    def policy(frame01: torch.Tensor, obs: dict, state, pool, **carry):
        with torch.no_grad():
            return arch.reference_policy(model, frame01, obs, state, pool, **carry)

    return policy


@dataclasses.dataclass
class SimRef:
    """What the reference builds from the seed, its camera and its policy."""

    net: object
    pool: object  # [E, K, R, ...]
    world: object  # the first world
    wt: object
    params: object
    cam: CameraSpec
    policy: object  # ``reference_policy``'s function


def bench_start(sim: dict, envs: int, seed: int, policy, device) -> SimRef:
    """bench.py's fleet as the reference builds it: the 3x3-block town, a
    chained pool and one spawned world from ``RandomState(seed)``, env e in
    weather e % 5."""
    net = make_town01(blocks_x=sim["town_blocks"][0], blocks_y=sim["town_blocks"][1])
    rng = np.random.RandomState(seed)
    pool = chained_route_pool(net, rng, num_routes=sim["routes"])
    world = spawn_world(net, sim["vehicles"], sim["walkers"], rng)
    worlds = world_from_arrays([world] * envs, device)
    worlds = worlds.replace(weather_idx=torch.arange(envs, device=device) % sim["weathers"])
    pools = tree_map(lambda x: x.expand((envs,) + x.shape[1:]), pool_from_arrays([pool], device))
    return SimRef(net=net.to(device), pool=pools, world=worlds,
                  wt=load_weather_table(device=device), params=default_vehicle_params(device),
                  cam=camera(sim), policy=policy)


def drive_start(sim: dict, seed: int, policy, device) -> SimRef:
    """The 5-weather protocol's run as the reference builds it: Town01, the
    ego at spawn point ``spawn``, a one-route pool to ``destination``."""
    net = make_town01()
    rng = np.random.RandomState(seed)
    world, info = spawn_world(net, sim["vehicles"] + 1, sim["walkers"], rng,
                              ego_spawn=sim["spawn"], weather_idx=weather_index(sim["weather"]),
                              return_info=True)
    spawns = net.host.spawn_wp
    route = trace_route(net, info["ego_wp"], int(spawns[sim["destination"] % len(spawns)]))
    pool = {k: v[None] for k, v in route.items()}
    return SimRef(net=net.to(device), pool=pool_from_arrays([pool], device),
                  world=world_from_arrays([world], device), wt=load_weather_table(device=device),
                  params=default_vehicle_params(device), cam=camera(sim), policy=policy)


def route_mismatch(ref_pool, pool) -> int:
    """Routes of the program's pool whose waypoint count or length in metres
    (to 1 mm) differ from the reference's. A shortest path may break ties
    otherwise than the reference's search, so the waypoints themselves are
    not compared."""
    def metres(p):
        xy = p.xy.double()
        seg = (xy[..., 1:, :] - xy[..., :-1, :]).norm(dim=-1)
        live = torch.arange(seg.shape[-1], device=seg.device) < (p.length[..., None] - 1)
        return (seg * live).sum(-1)

    pool = to_frozen(pool)
    if pool.length.shape != ref_pool.length.shape:
        return pool.length.numel()
    length = pool.length.to(ref_pool.length.device)
    bad = (length != ref_pool.length) | ((metres(pool).to(length.device) - metres(ref_pool)).abs()
                                         > 1e-3)
    return int(bad.sum())


def start_mismatch(ref: SimRef, net, pool, world) -> int:
    """Elements of the program's map and first world that differ from the
    reference's, and routes of its pool that do (``route_mismatch``)."""
    return (mismatches(ref.net, to_frozen(net)) + route_mismatch(ref.pool, pool)
            + mismatches(ref.world, to_frozen(world)))


def carry_gap(got: dict | None, want: dict | None) -> float:
    """Widest |got - want| over the leaves of two carries (dicts of tensors);
    inf where their leaves or shapes differ or a gap is not finite."""
    if got is None or want is None:
        return 0.0 if got is want else math.inf
    if got.keys() != want.keys():
        return math.inf
    gap = 0.0
    for k, x in got.items():
        y = want[k].to(x.device)
        if x.shape != y.shape:
            return math.inf
        g = float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
        if not math.isfinite(g):
            return math.inf
        gap = max(gap, g)
    return gap


def follow(ref: SimRef, pool, ticks: list[dict], sample: list[int], loop_routes: bool,
           quant: bool = False) -> dict:
    """The tick-by-tick numbers over the ``sample`` of the recorded ``ticks``
    (each {"state", "frame", "controls", "draws", "next"} of the program,
    and its ``carry`` and ``carry_next`` where its policy carries state), on
    the program's route ``pool`` [E, K, R, ...] (its state, which
    ``route_mismatch`` checks)."""
    classes = _frozen_classes()
    pool = to_frozen(pool, classes)
    frame_sum = frame_n = sq_sum = sq_n = 0.0
    ctl_max = act_gap = c_gap = 0.0
    carried = False
    for t in sample:
        rec = ticks[t]
        s = to_frozen(rec["state"], classes)
        obs = F_driver.env_observe(s, ref.net, pool, ref.cam, mode="drive")
        frame = obs["frame"]
        if quant:
            frame = frame.to(torch.bfloat16).float()
        frame_sum += float((rec["frame"].float() - frame).abs().sum())
        frame_n += frame.numel()
        if "carry" in rec:
            carried = True
            ctl, nxt_carry = ref.policy(frame, obs, s, pool, carry=rec["carry"])
            c_gap = max(c_gap, carry_gap(rec["carry_next"], nxt_carry))
        else:
            ctl = ref.policy(frame, obs, s, pool)
        d = rec["controls"].float() - ctl
        sq_sum += float((d.double() ** 2).sum())
        sq_n += d.numel()
        ctl_max = max(ctl_max, float(d.abs().max()))
        nxt, _ = F_driver.env_act(s, obs, rec["draws"], ref.net, pool, ref.wt, ref.params,
                                  mode="drive", nn_controls=rec["controls"].float(),
                                  loop_routes=loop_routes)
        for k in STATE_LEAVES:
            got, want = getattr(rec["next"].world, k).float(), getattr(nxt.world, k).float()
            if quant:
                want = want.to(torch.bfloat16).float()
            act_gap = max(act_gap, float((got - want).abs().max()))
    out = {"frame_gap": frame_sum / max(frame_n, 1), "controls_rms": (sq_sum / max(sq_n, 1)) ** 0.5,
           "controls_max": ctl_max, "act_gap": act_gap}
    if carried:
        out["carry_gap"] = c_gap
    return out


def scores_mismatch(metrics, scores: dict) -> int:
    """Scores of the program's metrics that differ from the reference's
    scoring of the same metrics."""
    want = compute_scores(to_frozen(metrics))
    return sum(1 for k, v in want.items() if scores.get(k) != v)
