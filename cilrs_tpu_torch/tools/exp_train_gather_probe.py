"""Checksum the batches INSIDE the train group against independently
gathered copies of the same rows (port of ``tools/exp_train_gather_probe.py``).

The JAX probe asked whether the compiled, donated, scanned train dispatch
consumed exactly the rows the sampler asked for. The port asks it of its
eager train group: the training loop's exact setup (split, sampler stream,
state init, 25-step groups; ``train/loop.py``), real train groups whose
frames come through one launch of the row-gather kernel, each batch's image
and label checksums taken as its step consumes it; then every checksum
recomputed one batch a launch, and the label checksums from the host
copies. Any divergence is a corrupt read; bit-equality exonerates the train
side's data path.

    python -m cilrs_tpu_torch.tools.exp_train_gather_probe [--frames 176256 --groups 50]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import collect_resident, gather_group, labels_dataset
from cilrs_tpu_torch.tools import probes
from cilrs_tpu_torch.train.loop import train_group
from cilrs_tpu_torch.train.steps import make_train_step


def probe(table: dict, labels: dict, cfg, n_groups: int, dev) -> dict:
    """The first ``n_groups`` train groups of the loop's first epoch on
    ``table`` (host ``labels`` the same rows'), checksummed inside the group
    and again one batch a launch and from the host labels."""
    ds = labels_dataset(labels)
    setup = probes.loop_setup(ds, cfg)
    state = setup.state(cfg, dev)
    ck_i, ck_l = [], []

    def tap(batch):
        ck_i.append(probes.image_checksum(batch["images"]))
        ck_l.append(probes.label_checksum(batch))

    train_step = probes.tapped(make_train_step(cfg), tap)
    groups = setup.groups(n_groups)
    losses, mism = [], []
    with probes.deterministic():
        for gi, grp in enumerate(groups):
            ck_i.clear()
            ck_l.clear()
            losses.append(train_group(state, table, grp, setup.seed, train_step).cpu().numpy())
            pi, plb = torch.stack(ck_i).cpu().numpy(), torch.stack(ck_l).cpu().numpy()
            for b in range(len(grp)):
                ref = gather_group(table, grp[b])
                r_i = int(probes.image_checksum(ref["images"]))
                r_l = int(probes.label_checksum(ref))
                h_l = probes.host_label_checksum(labels, grp[b])
                if pi[b] != r_i:
                    mism.append({"group": gi, "batch": b, "kind": "images"})
                if plb[b] != r_l:
                    mism.append({"group": gi, "batch": b, "kind": "labels-dev"})
                if plb[b] != h_l:
                    mism.append({"group": gi, "batch": b, "kind": "labels-host",
                                 "dev": int(plb[b]), "host": h_l})
            if gi % 10 == 0:
                print(f"  group {gi}/{len(groups)} loss {np.mean(losses[-1]):.4f} "
                      f"mismatches so far {len(mism)}", flush=True)

    # Sampler-stream sanity at this scale: turn fraction per group.
    cmds = ds.command
    turn_frac = [float(np.mean((cmds[g.reshape(-1)] == 1) | (cmds[g.reshape(-1)] == 2)))
                 for g in groups]
    return {
        "frames": len(ds), "page_rows": int(table["page_rows"]),
        "groups_probed": len(groups),
        "batches_probed": sum(len(g) for g in groups),
        "mismatches": mism[:200],
        "mismatch_count": len(mism),
        "first_group_losses": [float(x) for x in losses[0]],
        "last_group_losses": [float(x) for x in losses[-1]],
        "turn_fraction_per_group": turn_frac,
        "turn_fraction_mean": float(np.mean(turn_frac)),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--groups", type=int, default=50,
                   help="25-step train groups to probe (50 = 1 epoch at 150k)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/train_gather_probe.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, labels, _ = collect_resident(
        build_map("town01"), args.frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=args.seed, device=dev)
    out = probe(table, labels, load_train_config(), args.groups, dev)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    verdict = ("DIVERGED — the train group's gather corrupts batches" if out["mismatch_count"]
               else "BIT-EXACT — the train group consumes exactly the rows the sampler asked "
                    "for; data path exonerated end-to-end")
    print(f"\n  {out['mismatch_count']} checksum mismatches over "
          f"{out['batches_probed']} batches -> {verdict}")
    print(f"  turn fraction mean {out['turn_fraction_mean']:.3f}")
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
