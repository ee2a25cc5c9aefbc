"""The argument sets that hold ``ops/sinf.py:hash_sinf`` to its references:
jitted ``jnp.sin`` in the CPU tests, the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Each set is a float32 array, and ``port_hash(name, t)`` takes the bare sin
(``hash_sinf``) of the argument the port's hash forms from it:
 - ``rain``: the streak columns' hash, sin(x * 12.9898 + 78.233), on the
   integers 0-199,999 (``render/weather.py:_hash01``);
 - ``grain``: the ground grain's cells [N, 2], sin(q0 * 12.9898 + q1 *
   78.233), recorded from the renderer on a Town01 frame of four envs at
   0-14 m/s, both cell sizes, the sky's non-finite cells dropped
   (``ops/sinf.py:grain_hash``);
 - ``recovery``: the reverse steer's seed, sin(t * 12.99), on recovery
   starts t = 0.05-1,199.95 s in 0.05 s ticks (``agent/driver.py``);
 - ``random``: sin(x) on signed float32 values, log-uniform in magnitude
   from 1e-8 to 1e6, from a seed.
"""

from __future__ import annotations

import numpy as np
import torch

from cilrs_tpu_torch.ops.sinf import GRAIN_CELLS, cell_reciprocal, hash_sinf

SETS = ("rain", "grain", "recovery", "random")
GRAIN_SPEEDS = (0.0, 3.0, 8.0, 14.0)  # m/s, one env each: the stretch moves the cells
GRAIN_SPAWN_STEP = 97  # env k on Town01's spawn point 97 k
RANDOM_ARGS, RANDOM_SEED = 200_000, 0


def rain_args() -> np.ndarray:
    return np.arange(200_000, dtype=np.float32)


def recovery_args() -> np.ndarray:
    return np.arange(1, 24_000, dtype=np.float32) * np.float32(0.05)


def random_args() -> np.ndarray:
    rng = np.random.default_rng(RANDOM_SEED)
    mag = np.exp(rng.uniform(np.log(1e-8), np.log(1e6), RANDOM_ARGS))
    return (mag * rng.choice([-1.0, 1.0], RANDOM_ARGS)).astype(np.float32)


def grain_args() -> np.ndarray:
    """The grain's cells of one Town01 frame, quantized as
    ``ops/sinf.py:grain_hash`` quantizes them at each cell size: the ground
    points recorded by wrapping ``raster.grain_texture`` for one render on the
    CPU."""
    from cilrs_tpu_torch.core.state import make_world
    from cilrs_tpu_torch.maps.network import light_states
    from cilrs_tpu_torch.maps.town import make_town01
    from cilrs_tpu_torch.render import raster

    net = make_town01()
    h = net.host
    E = len(GRAIN_SPEEDS)
    world = make_world(E, 1, 1)
    wp = [int(h.spawn_wp[(k * GRAIN_SPAWN_STEP) % len(h.spawn_wp)]) for k in range(E)]
    world.veh_pos[:, 0] = torch.from_numpy(np.asarray(h.wp_xy, np.float32)[wp])
    world.veh_yaw[:, 0] = torch.from_numpy(np.asarray(h.wp_yaw, np.float32)[wp])
    world.veh_speed[:, 0] = torch.tensor(GRAIN_SPEEDS)
    points = []
    texture = raster.grain_texture

    def record(sxy):
        points.append(sxy)
        return texture(sxy)

    raster.grain_texture = record
    try:
        raster.render_frame(net, world, light_states(net, world.time_s))
    finally:
        raster.grain_texture = texture
    (sxy,) = points
    q = torch.cat([torch.floor(sxy * cell_reciprocal(cell)).reshape(-1, 2)
                   for cell in GRAIN_CELLS]).numpy()
    return q[np.isfinite(q).all(axis=1)]


def argument_set(name: str) -> np.ndarray:
    return {"rain": rain_args, "grain": grain_args, "recovery": recovery_args,
            "random": random_args}[name]()


def port_hash(name: str, t: torch.Tensor) -> torch.Tensor:
    """The port's hash of set ``name`` (a tensor of ``argument_set(name)``)."""
    if name == "rain":
        return hash_sinf(t, 12.9898, 78.233)
    if name == "grain":
        return hash_sinf(t[:, 0], 12.9898, t[:, 1] * 78.233)
    if name == "recovery":
        return hash_sinf(t, 12.99)
    return hash_sinf(t, 1.0)
