"""Does an eval group on a table past 2^33 bytes change live tensors? (port
of ``tools/exp_eval_sideeffect.py``)

The JAX probe asked whether the epoch-end eval program, gathering val rows
past the 2^33-byte offset of a 200k table, corrupted other live buffers
(the params) while its own outputs stayed plausible. The port asks it of
its eager eval group over a one-page table (the row-gather kernel's offsets
are 64-bit): the weights fingerprinted bitwise (``probes.params_fingerprint``)
before and after ``--rounds`` eval groups of (a) safe rows (< 150,000,
whatever the table's size; rows past its end clamp) and (b) rows across the
whole table (about a fifth past the 2^33-byte line at 200k), an identical
safe eval re-run after each to see whether its outputs drift; with
``--interleave-train``, a 25-step train group of a throwaway copy of the
state before each crossing eval. Then the crossing eval twice: are its
outputs deterministic? The tool sets ``CILRS_TPU_ALLOW_BIG_TABLE=1`` unless
the caller set it, for the duration of ``main``.

    python -m cilrs_tpu_torch.tools.exp_eval_sideeffect [--frames 200000 --interleave-train]
"""

from __future__ import annotations

import argparse

import numpy as np

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import collect_resident, unwrap_monolithic
from cilrs_tpu_torch.tools import probes
from cilrs_tpu_torch.tools.exp_checksum import allow_big_table
from cilrs_tpu_torch.train.loop import eval_group, train_group
from cilrs_tpu_torch.train.state import create_train_state
from cilrs_tpu_torch.train.steps import make_eval_step, make_train_step

SAFE_ROWS = 150_000  # the rows of the healthy 150k tables, whatever this table's size
STEPS_PER_EPOCH = 1062  # the JAX tool's schedule


def _host(outs) -> list[np.ndarray]:
    return [t.cpu().numpy() for t in outs]


def sideeffect(table: dict, cfg, frames: int, rounds: int, group: int, interleave_train: bool,
               dev) -> dict:
    """The probe on ``table`` (one page, ``frames`` rows) from a fresh state."""
    state = create_train_state(cfg, cfg.training.seed, STEPS_PER_EPOCH, device=dev)
    model = state.model.eval()
    eval_step, train_step = make_eval_step(cfg), make_train_step(cfg)
    rng = np.random.RandomState(3)
    safe = rng.randint(0, SAFE_ROWS, size=(group, 120)).astype(np.int32)
    # Real val composition: rows across the whole table, not crossing-only.
    cross = rng.randint(0, frames, size=(group, 120)).astype(np.int32)
    tr_idx = rng.randint(0, SAFE_ROWS, size=(25, 120)).astype(np.int32)

    with probes.deterministic():
        ref = _host(eval_group(model, table, safe, eval_step))
        fp0 = probes.params_fingerprint(model)
        print(f"params fingerprint before: {fp0}")
        print(f"safe-eval loss[0] {float(ref[0][0]):.6f}  (group={group}, "
              f"interleave_train={interleave_train})")
        drift = False
        for r in range(rounds):
            if interleave_train:
                # A throwaway copy trains, so the compared weights never move.
                st2 = probes.throwaway_copy(state, cfg, STEPS_PER_EPOCH)
                train_group(st2, table, tr_idx, r, train_step).cpu()
                del st2
            _host(eval_group(model, table, cross, eval_step))
            again = _host(eval_group(model, table, safe, eval_step))
            if not all(np.array_equal(a, b) for a, b in zip(ref, again)):
                print(f"  round {r}: SAFE EVAL OUTPUT DRIFTED after a boundary-crossing eval!")
                drift = True
                break
        fp1 = probes.params_fingerprint(model)
        a = _host(eval_group(model, table, cross, eval_step))
        b = _host(eval_group(model, table, cross, eval_step))
    det = all(np.array_equal(x, y) for x, y in zip(a, b))
    print(f"params fingerprint after {rounds} crossing evals: {fp1}")
    print("PARAMS MUTATED!" if fp1 != fp0 else "params unchanged")
    print("safe-eval outputs stable" if not drift else "safe-eval UNSTABLE")
    print(f"crossing-eval deterministic across calls: {det}")
    row_bytes = table["images"].shape[1] * table["images"].element_size()
    return {"frames": frames, "rounds": rounds, "group": group,
            "interleave_train": interleave_train,
            "fingerprint_before": fp0, "fingerprint_after": fp1,
            "params_unchanged": fp1 == fp0, "safe_eval_stable": not drift,
            "crossing_deterministic": det,
            "crossing_rows_past_2^33_bytes": float(np.mean(cross >= 2 ** 33 / row_bytes)),
            "safe_loss_first": float(ref[0][0])}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=200_000)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounds", type=int, default=30,
                   help="boundary-crossing eval groups to fire")
    p.add_argument("--group", type=int, default=25,
                   help="batches of 120 per eval group (the real epoch-end eval "
                        "gathers the FULL val split: 250)")
    p.add_argument("--interleave-train", action="store_true",
                   help="train a throwaway state copy for one 25-step group between "
                        "crossing evals (the real loop's churn)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    with allow_big_table():
        table, _, _ = collect_resident(build_map("town01"), args.frames, num_envs=args.envs,
                                       num_vehicles=12, num_pedestrians=6, weather_idx=None,
                                       seed=args.seed, device=dev)
    return sideeffect(unwrap_monolithic(table), load_train_config(), args.frames, args.rounds,
                      args.group, args.interleave_train, dev)


if __name__ == "__main__":
    main()
