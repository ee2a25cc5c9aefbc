"""Do the training loop's eval groups (or its train groups) change the PAGE
tensors? (port of ``tools/exp_eval_page_mutation.py``)

The JAX probe asked whether the loop's epoch-end eval program corrupted the
table's pages as a side effect. The port asks it of its eager groups:
factored-hash fingerprints of every page (exact, order-sensitive; the JAX
tool's uint32 hash, ``probes.page_hash``) before and after (a) the loop's
50-batch eval groups over the val split, and (b) one 25-step train group of
the loop's first epoch, each round. Any change of a page's hash pins a side
effect.

    python -m cilrs_tpu_torch.tools.exp_eval_page_mutation [--frames 176256 --rounds 6]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset
from cilrs_tpu_torch.tools import probes
from cilrs_tpu_torch.train.loop import EVAL_GROUP_BATCHES, STEPS_PER_CALL, eval_group, train_group
from cilrs_tpu_torch.train.steps import make_eval_step, make_train_step


def page_hashes(table: dict) -> list[int]:
    return [probes.page_hash(pg) for pg in table["images"]]


def mutation(table: dict, labels: dict, cfg, rounds: int, dev) -> dict:
    """``rounds`` rounds of the loop's eval groups over the val split and one
    train group on ``table``, the pages hashed before and after each."""
    setup = probes.loop_setup(labels_dataset(labels), cfg)
    state = setup.state(cfg, dev)
    eval_step, train_step = make_eval_step(cfg), make_train_step(cfg)
    val, B, draws = setup.val_idx, setup.batch, setup.draws
    vi = np.stack([val[s:s + B] for s in range(0, len(val) - B + 1, B)])  # [Kv, B]

    fp_init = page_hashes(table)
    print(f"page fingerprints init: {fp_init}", flush=True)
    log = {"init": fp_init, "rounds": []}
    mutated = False
    with probes.deterministic():
        for r in range(rounds):
            # (a) the epoch-end eval: 50-batch groups over the val split
            state.model.eval()
            for s in range(0, len(vi), EVAL_GROUP_BATCHES):
                grp = vi[s:s + EVAL_GROUP_BATCHES]
                if len(grp) < EVAL_GROUP_BATCHES:
                    break
                eval_group(state.model, table, grp, eval_step)
            fp_e = page_hashes(table)
            # (b) the train churn: one 25-step group
            k = STEPS_PER_CALL
            grp = setup.train_idx[draws[(r * k) % (len(draws) - k):][:k]]
            train_group(state, table, grp, setup.seed, train_step)
            fp_t = page_hashes(table)
            changed_e, changed_t = fp_e != fp_init, fp_t != fp_init
            mutated |= changed_e or changed_t
            log["rounds"].append({"after_eval": fp_e, "after_train": fp_t,
                                  "changed_eval": changed_e, "changed_train": changed_t})
            print(f"round {r}: after_eval {fp_e} changed={changed_e} | "
                  f"after_train {fp_t} changed={changed_t}", flush=True)
    log["mutated"] = mutated
    log["eval_groups_per_round"] = len(vi) // EVAL_GROUP_BATCHES
    return log


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--out", default="runs/eval_page_mutation.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, labels, _ = collect_resident(
        build_map("town01"), args.frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=args.seed, device=dev)
    log = mutation(table, labels, load_train_config(), args.rounds, dev)
    with open(args.out, "w") as f:
        json.dump(log, f, indent=1)
    print("\n  -> " + ("PAGE TENSORS MUTATED — an eval/train group side effect pinned"
                       if log["mutated"] else "pages stable across eval and train groups"))
    print(f"-> {args.out}")
    return log


if __name__ == "__main__":
    main()
