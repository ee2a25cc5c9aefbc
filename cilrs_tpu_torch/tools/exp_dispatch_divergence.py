"""Run one train group on a small and a big table with the same rows and the
same init, and compare (port of ``tools/exp_dispatch_divergence.py``).

The JAX probe localised the 200k training collapse inside the compiled train
dispatch (gather [25, 120] rows, then a scan of 25 train steps with donated
state): the same program on a 150k and a 200k table, the same global rows
(< 150k) and the same initial state, compared step by step. The port runs
its eager train group, the frames through one launch of the row-gather
kernel, on both tables, and compares:

  - the weighted checksum of each step's gathered image batch (the bytes
    weighted by their position in the frame, ``arange(D) % 251 + 1``, mod
    2^32), taken before the steps consume the group;
  - each step's training loss;
  - a final params fingerprint (the sum of every parameter's |x|).

checksums diverge -> the gather reads the big table wrong in context;
checksums match, losses diverge -> post-gather numerics change with the
table; all match -> the train group is innocent. The comparisons hold only
with deterministic algorithms (``probes.deterministic``). The tool sets
``CILRS_TPU_ALLOW_BIG_TABLE=1`` unless the caller set it, for the duration
of ``main``.

    python -m cilrs_tpu_torch.tools.exp_dispatch_divergence [--small 150000 --big 200000]
"""

from __future__ import annotations

import argparse
import gc
import json

import numpy as np

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import collect_resident, unwrap_monolithic
from cilrs_tpu_torch.tools import probes
from cilrs_tpu_torch.tools.exp_checksum import allow_big_table
from cilrs_tpu_torch.train.loop import train_group
from cilrs_tpu_torch.train.state import create_train_state
from cilrs_tpu_torch.train.steps import make_train_step

STEPS_PER_EPOCH = 1062  # the JAX tool's schedule
STEP_SEED = 123


def run_phase(table: dict, idxs: np.ndarray, cfg, dev) -> dict:
    """One train group of rows ``idxs`` [K, 120] on ``table`` from the init
    of ``cfg.training.seed``: per-step checksums and losses, and the params
    fingerprint."""
    state = create_train_state(cfg, cfg.training.seed, STEPS_PER_EPOCH, device=dev)
    chk = []
    tap = lambda b: chk.append(int(probes.weighted_checksums(b["images"], 1)[0]))
    train_step = probes.tapped(make_train_step(cfg), tap)
    with probes.deterministic():
        losses = train_group(state, table, idxs, STEP_SEED, train_step).cpu()
        fp = float(sum(p.detach().abs().sum() for p in state.model.parameters()))
    return {"losses": [float(x) for x in losses], "checksums": chk,
            "params_fingerprint": fp}


def compare(a: dict, b: dict) -> dict:
    n_chk = sum(int(x != y) for x, y in zip(a["checksums"], b["checksums"]))
    dl = [abs(x - y) for x, y in zip(a["losses"], b["losses"])]
    print(f"gathered-batch checksums: {'MATCH' if n_chk == 0 else 'DIVERGE'} "
          f"({n_chk}/{len(a['checksums'])} steps differ)")
    print(f"losses: max |delta| {max(dl):.3e}  "
          f"(A[0]={a['losses'][0]:.4f}, B[0]={b['losses'][0]:.4f}, "
          f"A[-1]={a['losses'][-1]:.4f}, B[-1]={b['losses'][-1]:.4f})")
    print(f"params fingerprint: A {a['params_fingerprint']:.6e}  "
          f"B {b['params_fingerprint']:.6e}")
    return {"checksum_steps_differing": n_chk, "loss_max_delta": max(dl),
            "all_equal": (a["checksums"] == b["checksums"] and a["losses"] == b["losses"]
                          and a["params_fingerprint"] == b["params_fingerprint"])}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--small", type=int, default=150_000)
    p.add_argument("--big", type=int, default=200_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/dispatch_divergence.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    idxs = np.random.RandomState(7).randint(0, args.small, size=(25, 120)).astype(np.int32)
    cfg = load_train_config()
    net = build_map("town01")
    phases = {}
    with allow_big_table():
        for name, frames in (("A", args.small), ("B", args.big)):
            print(f"=== phase {name}: table {frames} ===", flush=True)
            table, _, _ = collect_resident(net, frames, num_envs=16, num_vehicles=12,
                                           num_pedestrians=6, weather_idx=None,
                                           seed=args.seed, device=dev)
            phases[name] = {"frames": frames,
                            **run_phase(unwrap_monolithic(table), idxs, cfg, dev)}
            del table
            gc.collect()
    out = {"small": phases["A"], "big": phases["B"], **compare(phases["A"], phases["B"])}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
