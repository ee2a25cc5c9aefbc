"""Training curves: the notebook PART E 6-panel figure, from history rows
(port of ``cilrs_tpu/train/plots.py``; matplotlib is imported when called)."""

from __future__ import annotations


def plot_training_curves(history: list[dict], out_path: str):
    """6 panels: train/val loss, val loss zoom, epoch time, per-command steer
    errors (4 lines), LR-phase markers, loss ratio — matching the spirit of the
    reference notebook's training_curves.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not history:
        return
    ep = [h["epoch"] for h in history]
    tr = [h["train_loss"] for h in history]
    va = [h["val_loss"] for h in history]
    tm = [h.get("time_s", 0.0) for h in history]
    cmd_keys = [k for k in history[0] if k.startswith("steer_err_")]

    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    ax = axes[0, 0]
    ax.plot(ep, tr, label="train")
    ax.plot(ep, va, label="val")
    ax.set_title("Loss"); ax.set_xlabel("epoch"); ax.legend(); ax.grid(alpha=0.3)

    ax = axes[0, 1]
    ax.plot(ep, va, color="tab:orange")
    ax.set_title("Validation loss"); ax.grid(alpha=0.3)

    ax = axes[0, 2]
    ax.bar(ep, tm, color="tab:gray")
    ax.set_title("Epoch time (s)"); ax.grid(alpha=0.3)

    ax = axes[1, 0]
    for k in cmd_keys:
        ax.plot(ep, [h[k] for h in history], label=k.replace("steer_err_", ""))
    ax.set_title("Per-command val steer MAE"); ax.legend(fontsize=8); ax.grid(alpha=0.3)

    ax = axes[1, 1]
    best = min(range(len(va)), key=lambda i: va[i])
    ax.plot(ep, va)
    ax.axvline(ep[best], color="tab:green", linestyle="--", label=f"best @ {ep[best]}")
    ax.set_title(f"Best val {va[best]:.4f}"); ax.legend(); ax.grid(alpha=0.3)

    ax = axes[1, 2]
    ratio = [t / max(v, 1e-9) for t, v in zip(tr, va)]
    ax.plot(ep, ratio)
    ax.axhline(1.0, color="k", linewidth=0.5)
    ax.set_title("train/val ratio (overfit watch)"); ax.grid(alpha=0.3)

    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
