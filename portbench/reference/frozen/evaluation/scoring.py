"""Scoring, grading, and the terminal evaluation report (host side; port of
``cilrs_tpu/evaluation/scoring.py``).

Formula parity with the reference, driven by the loaded scoring config:
    Safety  = 100 - 15*collisions - 10*red_light_violations - 40*off_road_frac
    Comfort = 100 - 1000*mean(|d steer|)
    Route   = completed/attempted * 100
    Overall = 0.6*Safety + 0.3*Comfort + 0.1*Route
    Grades  : A+ >=90, A >=80, B+ >=70, B >=60, else C.
The fleet's ``Metrics`` are [E]-shaped (``collisions`` [E, 3]); a score is one
env's, read from the card in one copy.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.frozen.config import ScoringConfig
from portbench.reference.frozen.evaluation.metrics import Metrics

GRADE_LABELS = {
    "A+": "A+ (Excellent)",
    "A": "A  (Very Good)",
    "B+": "B+ (Good)",
    "B": "B  (Satisfactory)",
}
GRADE_FALLBACK = "C  (Needs Improvement)"


def metrics_to_host(m: Metrics, env: int = 0) -> dict:
    """One env's metrics as host numpy (float32), through one copy: every
    field is packed into one tensor on the device first."""
    fields = [f.name for f in dataclasses.fields(m)]
    parts = [getattr(m, k)[env].reshape(-1).to(torch.float32) for k in fields]
    flat = torch.cat(parts).cpu().numpy()
    out, i = {}, 0
    for k, p in zip(fields, parts):
        out[k] = flat[i:i + p.numel()]
        i += p.numel()
    return out


def compute_scores(m: Metrics, cfg: ScoringConfig = ScoringConfig(), env: int = 0) -> dict:
    """Scores of env ``env`` of a fleet's Metrics."""
    h = metrics_to_host(m, env)
    g = lambda k: float(h[k][0])
    frames = max(g("total_frames"), 1.0)
    col = h["collisions"]
    collisions = float(col.sum())
    off_road_frac = g("off_road_frames") / frames

    safety = 100.0 - collisions * cfg.collision_penalty \
        - g("red_light_violations") * cfg.red_light_violation_penalty \
        - off_road_frac * cfg.off_road_penalty_factor
    safety = max(0.0, min(100.0, safety))

    avg_jerk = g("jerk_sum") / frames
    comfort = max(0.0, min(100.0, 100.0 - avg_jerk * cfg.comfort_jerk_factor))

    attempted = max(g("routes_attempted"), 1e-9)
    route = g("routes_completed") / attempted * 100.0

    overall = (safety * cfg.safety_weight + comfort * cfg.comfort_weight
               + route * cfg.route_completion_weight)

    grade = GRADE_FALLBACK
    for name, threshold in cfg.grades:
        if overall >= threshold:
            grade = GRADE_LABELS.get(name, name)
            break

    return {
        "safety": safety,
        "comfort": comfort,
        "route_completion": route,
        "overall": overall,
        "grade": grade,
        "collisions": collisions,
        "collisions_by_type": {
            "vehicle": float(col[0]),
            "walker": float(col[1]),
            "other": float(col[2]),
        },
        "red_light_violations": g("red_light_violations"),
        "red_light_stops": g("red_light_stops"),
        "off_road_pct": off_road_frac * 100.0,
        "avg_jerk": avg_jerk,
        "total_distance_m": g("total_distance"),
        "total_time_s": g("total_time"),
        "avg_speed_kmh": g("speed_sum") / frames,
        "max_speed_kmh": g("speed_max"),
        "total_frames": int(frames),
        "routes_attempted": g("routes_attempted"),
        "routes_completed": g("routes_completed"),
        "obstacle_brakes": g("obstacle_brakes"),
        "teleports": g("teleports"),
        "recoveries": g("recoveries"),
    }


def format_report(scores: dict) -> str:
    """Terminal report matching the reference's print_report layout."""
    s = scores
    bar = "  " + "-" * 50
    lines = [
        "=" * 60,
        "EVALUATION REPORT",
        "=" * 60,
        bar, "  DRIVING STATISTICS", bar,
        f"  Total distance:      {s['total_distance_m']:.0f} m ({s['total_distance_m']/1000:.2f} km)",
        f"  Total time:          {s['total_time_s']:.1f} s ({s['total_time_s']/60:.1f} min)",
        f"  Average speed:       {s['avg_speed_kmh']:.1f} km/h",
        f"  Max speed:           {s['max_speed_kmh']:.1f} km/h",
        f"  Total frames:        {s['total_frames']}",
        bar, "  ROUTE PERFORMANCE", bar,
        f"  Routes attempted:    {s['routes_attempted']:.0f}",
        f"  Routes completed:    {s['routes_completed']:.0f}",
        f"  Completion rate:     {s['route_completion']:.1f}%",
        bar, "  SAFETY", bar,
        f"  Total collisions:    {s['collisions']:.0f}",
    ]
    for ctype, count in sorted(s["collisions_by_type"].items(), key=lambda kv: -kv[1]):
        if count > 0:
            lines.append(f"    - {ctype}: {count:.0f}")
    lines += [
        f"  Red light violations:{s['red_light_violations']:.0f}",
        f"  Red light stops:     {s['red_light_stops']:.0f}",
        f"  Off-road:            {s['off_road_pct']:.1f}%",
        f"  Obstacle brakes:     {s['obstacle_brakes']:.0f}",
        bar, "  SCORES", bar,
        f"  Safety score:        {s['safety']:.1f} / 100",
        f"  Comfort score:       {s['comfort']:.1f} / 100",
        f"  Overall score:       {s['overall']:.1f} / 100",
        f"  Grade:               {s['grade']}",
        "  " + "=" * 50,
    ]
    return "\n".join(lines)
