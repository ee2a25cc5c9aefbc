"""The whole pipeline in one command: fleet collection -> training -> offline
report -> closed-loop 5-weather benchmark (port of
``cilrs_tpu/cli/pipeline.py``).

    python -m cilrs_tpu_torch.cli.pipeline --workdir runs/full --frames 150000 \\
        --epochs 15 --bench-duration 300 [--resident] [--device cpu]

Two paths, as in the JAX package. By default each weather's session is
collected to disk (``data/collect.py``), then loaded, shipped and trained on.
With ``--resident`` the fleet collects straight into the card-resident table
(``data/resident.py:collect_resident``), training and the offline report
gather from it with the row-gather kernel, and no frame crosses to the host;
that path carries the stage-1 curriculum (``--stage1-frames``, with
``--latch-probes``), ``--refresh-every`` and ``--report-frames``. Both end
with ``cli.benchmark`` on the best checkpoint and write
``pipeline_timing.json``. ``--config`` (a train.json override, as
``cli.train`` takes it) and ``--device`` are the port's additions.

Stage 1 and stage 2 collect with the same seed, so stage 2's val rows can
overlap stage 1's training frames: a fault of the JAX pipeline (ROADMAP
Queue 3), kept for parity.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config, weather_index

LATCH_TURN_ERR = 0.11  # LEFT+RIGHT val steer error under which a stream has latched


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS collect->train->eval pipeline (PyTorch/CUDA)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--frames", type=int, default=150_000, help="total across weathers")
    p.add_argument("--collect-weathers", nargs="*",
                   default=["clear", "rain", "fog", "night", "hardrain"])
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--vehicles", type=int, default=12)
    p.add_argument("--walkers", type=int, default=6)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--map", default="town01")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-collect", action="store_true")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--skip-bench", action="store_true")
    p.add_argument("--bench-duration", type=float, default=300.0)
    p.add_argument("--resident", action="store_true",
                   help="collect straight into the card-resident table and train from it "
                        "(no frame crosses to the host)")
    p.add_argument("--hard-boost", type=float, default=None,
                   help="extra sampling weight on big-steer/braking frames "
                        "(TrainingConfig.hard_frame_boost; 0 = reference parity)")
    p.add_argument("--speed-boost", type=float, default=None,
                   help="train-only multiplier on the speed-head loss weight")
    p.add_argument("--brake-boost", type=float, default=None,
                   help="train-only multiplier on the brake-head L1 weight")
    p.add_argument("--refresh-every", type=int, default=0,
                   help="resident mode: re-collect the train table every N epochs "
                        "(fresh frames, fixed val snapshot)")
    p.add_argument("--stage1-frames", type=int, default=0,
                   help="latch-then-widen curriculum: first train a full run on this "
                        "many frames, then widen to --frames initialized from its best slot")
    p.add_argument("--stage1-epochs", type=int, default=24)
    p.add_argument("--latch-probes", type=int, default=0,
                   help="stage 1: probe up to N training streams for 2 epochs each and "
                        "train with the first whose turn errors latch "
                        f"(LEFT+RIGHT val err < {LATCH_TURN_ERR})")
    p.add_argument("--init-from", default=None,
                   help="warm-start params from another run's best checkpoint")
    p.add_argument("--lr", type=float, default=None, help="peak learning-rate override")
    p.add_argument("--patience", type=int, default=None, help="early-stop patience override")
    p.add_argument("--report-frames", type=int, default=0,
                   help="resident mode: also report on this many freshly collected "
                        "held-out frames -> evaluation_report_fresh.json")
    p.add_argument("--config", default=None, help="path to a train.json override")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    t_start = time.time()
    timing = {}
    net = build_map(args.map)
    if args.resident:
        _resident_pipeline(net, args, dev, timing)
    else:
        _disk_pipeline(net, args, dev, timing)
    if not args.skip_bench:
        from cilrs_tpu_torch.cli import benchmark as bench_cli

        t0 = time.time()
        print("\n=== closed-loop 5-weather benchmark ===")
        bench_cli.main([
            "--checkpoint", os.path.join(args.workdir, "ckpt"),
            "--duration", str(args.bench_duration),
            "--map", args.map, "--seed", str(args.seed),
            "--out", os.path.join(args.workdir, "RESULTS.md"),
            "--json-out", os.path.join(args.workdir, "benchmark.json"),
            "--device", str(dev),
        ])
        timing["bench_s"] = time.time() - t0

    timing["total_s"] = time.time() - t_start
    with open(os.path.join(args.workdir, "pipeline_timing.json"), "w") as f:
        json.dump(timing, f, indent=2)
    print(f"\npipeline done in {timing['total_s']:.0f}s: {timing}")
    return timing


def _train_config(args, boosts: bool):
    """The train config with the CLI's overrides; the head boosts only where
    the JAX pipeline applies them (the resident path)."""
    cfg = load_train_config(args.config)
    over = {"epochs": args.epochs, "batch_size": args.batch_size,
            "early_stop_patience": args.patience}
    if boosts:
        over.update(hard_frame_boost=args.hard_boost, speed_loss_boost=args.speed_boost,
                    brake_loss_boost=args.brake_boost)
    tcfg = dataclasses.replace(cfg.training, **{k: v for k, v in over.items() if v is not None})
    ocfg = cfg.optimizer if args.lr is None else dataclasses.replace(cfg.optimizer,
                                                                      learning_rate=args.lr)
    return dataclasses.replace(cfg, training=tcfg, optimizer=ocfg)


def _disk_pipeline(net, args, dev, timing):
    """Sessions on disk, one a weather; train on them."""
    session_dirs = [os.path.join(args.workdir, f"session_{w}") for w in args.collect_weathers]
    if not args.skip_collect:
        from cilrs_tpu_torch.data.collect import collect_session

        per = args.frames // len(args.collect_weathers)
        t0 = time.time()
        for w, out in zip(args.collect_weathers, session_dirs):
            print(f"\n=== collect {per} frames, weather={w} ===")
            stats = collect_session(net, out, num_frames=per, num_envs=args.envs,
                                    num_vehicles=args.vehicles, num_pedestrians=args.walkers,
                                    weather_idx=weather_index(w), seed=args.seed + weather_index(w),
                                    device=dev)
            print(f"  {stats['frames']} frames at {stats['frames_per_sec']:.0f}/s")
        timing["collect_s"] = time.time() - t0

    if not args.skip_train:
        from cilrs_tpu_torch.data.dataset import load_sessions
        from cilrs_tpu_torch.train.loop import train

        t0 = time.time()
        cfg = _train_config(args, boosts=False)
        print("\n=== load dataset ===")
        ds = load_sessions([d for d in session_dirs if os.path.isdir(d)])
        print(f"  {len(ds)} frames")
        print("\n=== train ===")
        out = train(ds, cfg, ckpt_dir=os.path.join(args.workdir, "ckpt"),
                    init_from=args.init_from, device=dev)
        timing["train_s"] = time.time() - t0
        timing["best_val_loss"] = out["best_val_loss"]
        print(f"best val loss: {out['best_val_loss']:.4f} in {timing['train_s']:.0f}s")


def _resident_pipeline(net, args, dev, timing):
    """collect -> card-resident table -> train -> offline report, with no
    frame crossing to the host."""
    from cilrs_tpu_torch.data.dataset import stratified_split
    from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset
    from cilrs_tpu_torch.evaluation.report import (collect_predictions_resident, offline_report,
                                                   save_report)
    from cilrs_tpu_torch.train.checkpoint import load_policy
    from cilrs_tpu_torch.train.loop import train

    cfg = _train_config(args, boosts=True)
    fleet = dict(num_envs=args.envs, num_vehicles=args.vehicles, num_pedestrians=args.walkers,
                 weather_idx=None, device=dev)
    init_from = args.init_from
    if args.stage1_frames and not args.skip_train:
        # Latch-then-widen: turn-feature latching from a from-scratch trunk
        # is bistable; stage 1 trains a stream that latches, stage 2 widens
        # the latched model to --frames.
        print(f"\n=== stage 1: latch on {args.stage1_frames} frames ===")
        t0 = time.time()
        s1_table, s1_labels, _ = collect_resident(net, args.stage1_frames, seed=args.seed, **fleet)
        # Stage 1 runs the canonical recipe: the head boosts are stage-2 tuning.
        s1_cfg = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, epochs=args.stage1_epochs, speed_loss_boost=1.0,
            brake_loss_boost=1.0, hard_frame_boost=0.0))
        s1_ckpt = os.path.join(args.workdir, "ckpt_stage1")
        s1_seed = None  # the default stream (cfg.training.seed)
        if args.latch_probes:
            probe_cfg = dataclasses.replace(s1_cfg, training=dataclasses.replace(
                s1_cfg.training, epochs=2))
            for k in range(args.latch_probes):
                cand = cfg.training.seed if k == 0 else cfg.training.seed + 101 * k
                pres = train(labels_dataset(s1_labels), probe_cfg, resident=dict(s1_table),
                             verbose=False, stream_seed=cand, init_from=init_from, device=dev)
                h = pres["history"][-1]
                del pres  # free the probe's train state before the next one
                turn = h["steer_err_LEFT"] + h["steer_err_RIGHT"]
                latched = turn < LATCH_TURN_ERR
                print(f"  latch probe {k}: stream seed {cand} LEFT+RIGHT {turn:.3f} -> "
                      f"{'LATCHED' if latched else 'no latch'}", flush=True)
                if latched:
                    s1_seed = cand
                    break
            else:
                print("  no probe latched; proceeding with the last stream")
                s1_seed = cand
        train(labels_dataset(s1_labels), s1_cfg, ckpt_dir=s1_ckpt, resident=s1_table,
              init_from=init_from, stream_seed=s1_seed, device=dev)
        del s1_table  # free the stage-1 table before the main collect
        timing["stage1_s"] = time.time() - t0
        init_from = s1_ckpt
        print(f"stage 1 done in {timing['stage1_s']:.0f}s -> {s1_ckpt}")

    print(f"\n=== resident collect: {args.frames} frames (mixed weathers) ===")
    t0 = time.time()
    table, labels, stats = collect_resident(
        net, args.frames, seed=args.seed, output_dir=os.path.join(args.workdir, "session_resident"),
        **fleet)
    timing["collect_s"] = time.time() - t0
    timing["collect_frames_per_sec"] = stats["frames_per_sec"]
    if args.skip_train:
        return

    print("\n=== train (resident table) ===")
    ckpt_dir = os.path.join(args.workdir, "ckpt")
    t0 = time.time()
    ds = labels_dataset(labels)

    def refresh_fn(i):
        t, lab, _ = collect_resident(net, args.frames, seed=args.seed + 1009 * i, **fleet)
        return t, labels_dataset(lab)

    # Hand the table over without keeping a reference here: with
    # --refresh-every the trainer frees it before each re-collect.
    holder = [table]
    del table
    out = train(ds, cfg, ckpt_dir=ckpt_dir, resident=holder.pop(),
                refresh_fn=refresh_fn if args.refresh_every else None,
                refresh_every=args.refresh_every, init_from=init_from, device=dev)
    timing["train_s"] = time.time() - t0
    timing["best_val_loss"] = out["best_val_loss"]
    print(f"best val loss: {out['best_val_loss']:.4f} in {timing['train_s']:.0f}s")

    print("\n=== offline report (resident val split) ===")
    t0 = time.time()
    model = load_policy(ckpt_dir, cfg, dev)
    _, val_idx = stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
    # The report reads the trainer's val table: with a refresh it is an
    # independent snapshot (local rows, the val labels), else the collection
    # table itself (global rows).
    val_labels = {k: labels[k][val_idx] if args.refresh_every else labels[k]
                  for k in ("controls", "speed", "command")}
    pred, true, cmd = collect_predictions_resident(
        model, out["val_table"], val_labels, out["val_rows"], cfg.training.batch_size, cfg)
    # Mixed-weather collections put env e in weather e % 5.
    report = offline_report(pred, true, cmd, weather=labels["env"][val_idx] % 5)
    save_report(report, os.path.join(args.workdir, "evaluation_report.json"))
    timing["report_s"] = time.time() - t0
    print(f"  steer MAE {report['steer']['mae']:.4f} corr {report['steer']['correlation']:.4f} "
          f"({report['num_samples']} val samples)")
    del out

    if args.report_frames:
        # Frames from a seed no training collection used: generalization to
        # unseen scenarios, not unseen rows.
        print(f"\n=== offline report ({args.report_frames} fresh frames) ===")
        t0 = time.time()
        ftable, flabels, _ = collect_resident(net, args.report_frames, seed=args.seed + 777_777,
                                              **fleet)
        pred, true, cmd = collect_predictions_resident(
            model, ftable, flabels, np.arange(args.report_frames), cfg.training.batch_size, cfg)
        fresh = offline_report(pred, true, cmd, weather=flabels["env"] % 5)
        save_report(fresh, os.path.join(args.workdir, "evaluation_report_fresh.json"))
        timing["report_fresh_s"] = time.time() - t0
        print(f"  fresh steer MAE {fresh['steer']['mae']:.4f} "
              f"corr {fresh['steer']['correlation']:.4f} ({fresh['num_samples']} samples)")


if __name__ == "__main__":
    main()
