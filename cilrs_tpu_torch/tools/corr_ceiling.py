"""Per-control correlation CEILING of behavior cloning on teacher data (port
of ``tools/corr_ceiling.py``).

Whether a reference's offline correlation is reachable on self-generated
data depends on how much of the label's variance is a function of the
observable state: a BC model computes pred = f(observation), so

    corr(pred, y) <= sigma_f / sigma_y = sqrt(1 - Var(eps) / Var(y))

where y = f*(state) + eps and Var(eps) is the label variance across
near-identical observable states, estimated with the matched pairs of
``tools/label_noise_floor.py`` via E[(y1 - y2)^2] = 2 Var(eps) for
independent noise. The estimate is conservative (a lower bound on the
ceiling): a label difference caused by state the matching does not key on,
but the camera sees, is charged to noise.

    python -m cilrs_tpu_torch.tools.corr_ceiling runs/r3h/session_resident [--pos-tol 0.5]
"""

from __future__ import annotations

import argparse

import numpy as np

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.tools.label_noise_floor import CONTROLS, labels_of, matched_sessions


def ceilings(labels: np.ndarray, pairs: np.ndarray) -> dict:
    """Per-control Var(y), Var(eps) and the correlation ceiling, and the
    within-0.01 steer ceiling of the Bayes predictor; printed as the JAX tool
    prints them."""
    out = {}
    print("\nper-control correlation ceilings (conservative):")
    for k, name in enumerate(CONTROLS):
        y = labels[:, k]
        var_y = y.var()
        d2 = (labels[pairs[:, 0], k] - labels[pairs[:, 1], k]) ** 2
        var_eps = d2.mean() / 2.0
        ceil = np.sqrt(max(0.0, 1.0 - var_eps / var_y))
        out[name] = {"var_y": float(var_y), "var_eps": float(var_eps), "corr_ceiling": float(ceil)}
        print(f"  {name:9s} Var(y)={var_y:.5f}  Var(eps)={var_eps:.6f}  "
              f"corr ceiling <= {ceil:.4f}")

    # Within-0.01 steer ceiling: even the Bayes predictor E[y|x] misses a
    # frame whose label noise exceeds the band; |eps| ~ |y1 - y2| / sqrt(2)
    # for independent symmetric noise, with P(|y1 - y2| <= 2t) as a sanity
    # corridor (P(|eps| <= t)^2 <= P(|y1 - y2| <= 2t)).
    t = 0.01
    d = np.abs(labels[pairs[:, 0], 0] - labels[pairs[:, 1], 0])
    frac_scaled = float((d / np.sqrt(2.0) <= t).mean())
    frac_2t = float((d <= 2 * t).mean())
    out["within_0.01_steer"] = {"p_scaled": frac_scaled, "sqrt_p_2t": float(np.sqrt(frac_2t))}
    print(f"\nwithin-{t} steer ceiling (Bayes predictor):")
    print(f"  P(|y1-y2|/sqrt2 <= {t}) = {frac_scaled:.4f}   "
          f"[sanity: sqrt P(|y1-y2|<=2t) = {np.sqrt(frac_2t):.4f}]")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("sessions", nargs="+")
    p.add_argument("--pos-tol", type=float, default=0.5)
    p.add_argument("--yaw-tol", type=float, default=2.0)
    p.add_argument("--speed-tol", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    require_cuda(args.device)

    df, pairs, out = matched_sessions(args.sessions, args.pos_tol, args.yaw_tol, args.speed_tol)
    if len(pairs) == 0:
        return out
    out["ceilings"] = ceilings(labels_of(df), pairs)
    return out


if __name__ == "__main__":
    main()
