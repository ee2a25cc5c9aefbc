"""The 5-weather protocol's drive: ``cli/drive.py:make_drive_run`` (one env,
the ego at a pinned spawn point, a one-route pool to the destination, the
pinned-destination protocol) and ``DriveRun.chunk``, each chunk followed by
``cli.drive``'s chunk end: the host read of ``HOST_KEYS`` and
``compute_scores``. The configuration's policy architecture holds the run's
weights; the run renders the configuration's camera.

Window: chunks until ``--seconds`` have passed; ``drive_ticks_per_s`` is the
window's ticks over its wall, the chunk ends inside. Traced run: the same
window (issue times, chunk-end spans, rate), then one profiled chunk with the
tick's layers in ranges. Check: one more chunk, recorded tick by tick, which
the reference follows on a sample of its ticks, and the scores after it.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import faults, simrun, trace
from portbench.harness import sync, window
from portbench.reference import sim as ref_sim


def prepare(ctx, fp32=False):
    """Set-up: the drive run with the run's weights, the weights, and the
    start the reference checks, after the warm-up chunks."""
    from cilrs_tpu_torch.cli import drive as drive_cli
    from cilrs_tpu_torch.maps.town import make_town01

    sim, dev = ctx.config["sim"], ctx.device
    run, _ = drive_cli.make_drive_run(make_town01(), sim["spawn"], sim["destination"],
                                      sim["vehicles"], sim["walkers"], sim["weather"],
                                      seed=ctx.seed_for(1), autopilot=True, device=dev)
    run.policy, sd = simrun.program_policy(ctx, fp32)
    simrun.keep_carry(run, ctx, run.policy)
    simrun.set_camera(run, simrun.camera(sim))
    start = (run.net, run.pool, run.state.world)
    for _ in range(ctx.traffic["warmup_chunks"]):
        chunk_end(run, run.chunk())
    sync(dev)
    return run, sd, start


def chunk_end(run, outs) -> dict:
    """cli.drive's chunk end: the host read and the scores."""
    from cilrs_tpu_torch.cli.drive import HOST_KEYS
    from cilrs_tpu_torch.evaluation.scoring import compute_scores

    host = {k: outs[k][0].cpu().numpy() for k in HOST_KEYS}
    return host, compute_scores(run.state.metrics)


def run(ctx) -> dict:
    dev, tr = ctx.device, ctx.traffic
    T = tr["ticks"]
    drive, sd, start = prepare(ctx)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win = window(ctx, lambda: drive.chunk(T), lambda outs: chunk_end(drive, outs))
    n, wall = win["chunks"], win["wall_s"]
    rate = n * T / wall
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = {"issue_ms_per_unit": win["issue_s"] * 1e3 / (n * T),
           "wall_ms_per_unit": wall * 1e3 / (n * T),
           "chunk_end_ms": win["end_s"] * 1e3 / n,
           "mfu_pct": simrun.mfu_pct(ctx, rate)}
    if ctx.trace:
        rec.update(trace.profile(lambda: drive.chunk(tr["profile_ticks"]), tr["profile_ticks"],
                                 simrun.tick_ranges(drive)))
    ticks, scored = checked_chunk(drive, T)
    finite = simrun.finite_state(drive.state)
    del drive
    lim = ctx.workload["limits"]
    got = readings(ctx, sd, start, ticks, scored)
    return {"e2e": {"drive_ticks_per_s": rate}, "rec": rec, "attempted": n,
            "failed": 0 if finite else n, "memory_peak_bytes": peak,
            "checked": {k: (got[k], lim[k]) for k in lim}}


def checked_chunk(drive, ticks: int):
    """One chunk recorded tick by tick, and its chunk end's scores with the
    metrics they were read from."""
    outs = {}
    recorded, _ = simrun.record_chunk(lambda: outs.update(drive.chunk(ticks)), drive)
    _, scores = chunk_end(drive, outs)
    return recorded, (drive.state.metrics, scores)


def readings(ctx, sd, start, ticks, scored, quant=False) -> dict:
    policy = ref_sim.reference_policy(ctx.config["model"], sd, ctx.device, quant)
    ref = ref_sim.drive_start(ctx.config["sim"], ctx.seed_for(1), policy, ctx.device)
    sample = simrun.sample_ticks(len(ticks), ctx.traffic["check_ticks"], ctx.seed_for(4))
    out = ref_sim.follow(ref, start[1], ticks, sample, loop_routes=False, quant=quant)
    out["start_mismatch"] = ref_sim.start_mismatch(ref, *start)
    out["scores_mismatch"] = ref_sim.scores_mismatch(*scored)
    return out


def calibrate(ctx, control=True, fault=None, fp32=False) -> dict:
    """As ``fleet.calibrate``, on the drive run."""
    drive, sd, start = prepare(ctx, fp32)
    with faults.sim_fault(fault, drive) if fault else contextlib.nullcontext():
        ticks, scored = checked_chunk(drive, ctx.traffic["ticks"])
    del drive
    out = {"program": readings(ctx, sd, start, ticks, scored)}
    if control:
        out["control"] = readings(ctx, sd, start, ticks, scored, quant=True)
    return out
