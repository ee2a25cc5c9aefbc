"""One run of one cell of the port's benchmark.

    python -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

Makes the cell's inputs from ``--seed``, warms up the cell's own shapes, drives
the program (``cilrs_tpu_torch``) for ``--seconds`` of measured window, checks
what the window's entry produced against the plain reference, and prints one
JSON line last on stdout (``README.md`` gives its keys). With ``--trace 1`` it
also profiles a short steady part, and reports the cell's per-layer metrics in
place of its end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402

# Caches that a library may build stay inside the checkout, at fixed paths.
CACHE_DIR = os.path.join(harness.ROOT, ".portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE_DIR, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
# One process drives the card from one thread: no CPU worker pools competing
# with it for the host's cores.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

from portbench.trace import card_line  # noqa: E402  (imports torch: after the settings)


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")
    entry = cells[args.workload]
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"the cell needs {entry['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present")
    workload = harness.load_json("workloads", args.workload)
    ctx = harness.Ctx(cell=args.workload, workload=workload,
                      config=harness.load_json("configs", workload["config"]), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    out = harness.load_module("drivers", workload["driver"]).run(ctx)

    if args.trace:
        metrics = {}
        for m in harness.cell_metrics(bench, args.workload, "per_layer"):
            v = harness.load_module("metrics", m["name"]).read(out["rec"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {**out["e2e"], "setup_s": ctx.setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in harness.cell_metrics(bench, args.workload, "end_to_end")}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": card_line().rsplit(", ", 1)[-1]}
    if args.trace:
        device.update(busy_s=out["rec"]["busy_s"], window_s=out["rec"]["window_s"])
    checked = harness.check_line(out["checked"])
    found = harness.forbidden_modules()
    if found:
        fail(f"the run loaded {found}, which the port's benchmark may not load", 3)
    line = {"correct": all(c["ok"] for c in checked.values()) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": device}
    if args.trace:
        line["breakdown"] = out["rec"]["breakdown"]
    # A reading that is not a finite number is written as text, so the line stays JSON.
    line["checked"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                           "limit": c["limit"]} for k, c in checked.items()}
    for k, c in checked.items():
        print(f"checked {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'OVER'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
