"""Page-2 identity test (port of ``tools/exp_page2_identity.py``): train on
IDENTICAL data addressed through page 1 and through page 2 of a table whose
two pages hold the same frames, and compare the resulting weights.

Setup: one single-page collection T of ``--frames`` rows, and a copy of its
page made as a DISTINCT allocation (a tuple holding the same tensor twice
would hide what the probe asks). The two-page table T2 = (T, copy): global
rows g and g + page_rows hold the same frame. Runs, each from the same init
through the same 25-step train groups of the loop's first epoch:

  A: on T (one page);
  B: on T2, the rows as they are (page 1);
  C: on T2, every row + page_rows (page 2).

B == A: the two-page table with page-1 addressing trains the same weights.
C == B: page-2 addressing is faithful. The port runs the groups eagerly, so
the comparisons hold only with deterministic algorithms
(``probes.deterministic``); a control run ("A'", A again) shows the floor.

    python -m cilrs_tpu_torch.tools.exp_page2_identity [--frames 88128 --groups 30]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import LABEL_KEYS, collect_resident, labels_dataset
from cilrs_tpu_torch.tools import probes
from cilrs_tpu_torch.train.loop import STEPS_PER_CALL, train_group
from cilrs_tpu_torch.train.steps import make_train_step


def tables(page: torch.Tensor, page2: torch.Tensor, table: dict, page_rows: int) -> dict:
    """The runs' tables: "A" the one page, "B"/"C" the two pages with the
    labels twice over (global rows 0 .. 2 * page_rows - 1)."""
    common = {"image_shape": tuple(table["image_shape"])}
    one = {"images": (page,), "page_rows": page_rows, **common,
           **{k: table[k][:page_rows] for k in LABEL_KEYS}}
    two = {"images": (page, page2), "page_rows": page_rows, **common,
           **{k: torch.cat([table[k][:page_rows]] * 2) for k in LABEL_KEYS}}
    return {"A": one, "A'": one, "B": two, "C": two}


def run(table: dict, groups: list, offset: int, cfg, setup: probes.LoopSetup, dev) -> tuple:
    """One training from the loop's init through ``groups`` (+ ``offset``):
    (the weights' md5, the losses)."""
    state = setup.state(cfg, dev)
    train_step = make_train_step(cfg)
    losses = [train_group(state, table, g + offset, setup.seed, train_step) for g in groups]
    return probes.model_md5(state.model), torch.cat(losses).cpu().numpy()


def identity(page: torch.Tensor, page2: torch.Tensor, table: dict, labels: dict, page_rows: int,
             cfg, n_groups: int, dev, runs=("A", "B", "C")) -> dict:
    """Runs ``runs`` of the probe over the loop's first ``n_groups`` whole
    groups on ``page`` (``page_rows`` logical rows; ``table`` its device
    labels, ``labels`` the host ones) and its distinct copy ``page2``."""
    if page2.data_ptr() == page.data_ptr():
        raise ValueError("page 2 must be a distinct allocation (a clone of page 1)")
    setup = probes.loop_setup(labels_dataset({k: v[:page_rows] for k, v in labels.items()}),
                              cfg)
    groups = [g for g in setup.groups(n_groups) if g.shape[0] == STEPS_PER_CALL]
    by_run = tables(page, page2, table, page_rows)
    out = {}
    with probes.deterministic():
        for name in runs:
            print(f"=== run {name} ===", flush=True)
            out[name] = run(by_run[name], groups, page_rows if name == "C" else 0, cfg, setup,
                            dev)
    fp = {k: v[0] for k, v in out.items()}
    loss = {k: v[1] for k, v in out.items()}
    res = {"groups": len(groups), "fingerprints": fp,
           "lossA_head": [float(x) for x in loss["A"][:5]]}
    for a, b in (("A", "A'"), ("A", "B"), ("B", "C")):
        if a in out and b in out:
            tag = (a + b).replace("'", "2")
            res[f"loss_maxdiff_{tag}"] = float(np.max(np.abs(loss[a] - loss[b])))
            res[f"params_equal_{tag}"] = fp[a] == fp[b]
            res[f"losses_equal_{tag}"] = bool(np.array_equal(loss[a], loss[b]))
    if "C" in out:
        res["lossC_head"] = [float(x) for x in loss["C"][:5]]
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=88_128)
    p.add_argument("--groups", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/page2_identity.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, labels, stats = collect_resident(
        build_map("town01"), args.frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=args.seed, device=dev)
    if stats["num_pages"] != 1:
        raise ValueError("need a single-page base table")
    (page,) = table["images"]
    # Page 2 is a real copy (a distinct allocation of the page's size).
    out = identity(page, page.clone(), table, labels, args.frames, load_train_config(),
                   args.groups, dev)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\n  A==B (1-page vs 2-page/page-1): params {out['params_equal_AB']}, "
          f"loss maxdiff {out['loss_maxdiff_AB']:.3e}")
    print(f"  B==C (page-1 vs page-2 addressing): params {out['params_equal_BC']}, "
          f"loss maxdiff {out['loss_maxdiff_BC']:.3e}")
    verdict = ("PAGE-2 TRAIN READS CORRUPT" if not out["params_equal_BC"] else
               "page-2 addressing faithful — the train gather reads every page alike")
    print(f"  -> {verdict}")
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
