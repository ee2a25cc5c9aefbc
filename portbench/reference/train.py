"""The training check: the reference runs the program's first three train
steps again, in float32 from the run's weights, on the table's rows that the
program's sampler chose (gathered by plain indexing), with the same draws,
and the EMA's first update.

The program's step draws its augmentation from a generator seeded for the
step and its dropout masks from the global generators seeded for the step
(``np.random.SeedSequence([seed, step])``); the reference seeds the same
generators the same way and draws in the same order, so both sides see the
same masks. The numbers:

 - ``loss_gap``: |loss - reference loss| / |reference loss| of the first
   step (the later steps' losses are reported beside it: Adam's first
   updates move every weight by about the learning rate whatever the size
   of its gradient, so gradients near nought that differ in sign make the
   two runs part by round-off);
 - ``grad_gap``: of the first gradient as Adam received it (its first moment
   after one step over 1 - beta1, weight decay included), the median leaf's
   | |g| - |g_ref| | over the larger of |g_ref| and the median leaf's |g_ref|
   (the worst leaf's, ``grad_worst``, is reported beside it: small leaves
   whose gradient is a sum that cancels, BatchNorm's and the branches' last
   biases under the L1 loss, swing with rounding);
 - ``change_gap``: the same median of each leaf's change over the three
   steps, leaving out leaves whose reference gradient is under a thousandth
   of the median leaf's (Adam moves them by round-off alone);
 - ``ema_gap``: the EMA after the first group, against the reference's
   update of the program's weights after that group, the worst leaf's
   max |difference| over its max |value|;
 - ``batch_mismatch``: elements of the three batches (frames and labels)
   that differ from the table's rows as the reference indexes them.

The control (``quant=True``) trains the model in fp8 e4m3 with per-tensor
scales: the weights and inputs of every convolution and linear module, and
the gradient entering each of them from above (the gradient is passed
straight through each rounding); and computes the EMA in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.frozen.config import LossConfig
from portbench.reference.frozen.models.losses import cilrs_loss
from portbench.reference.frozen.ops.image import augment_batch, normalize
from portbench import harness
from portbench.reference.sim import fp8

STEPS = 3


def step_seeds(seed: int, step: int) -> tuple[int, int]:
    """(augmentation seed, dropout seed) of update ``step`` of a run seeded ``seed``."""
    a, d = np.random.SeedSequence([seed, step]).generate_state(2)
    return int(a), int(d)


class _Fp8(torch.autograd.Function):
    """x rounded to fp8 on the way forward, the gradient passed straight."""

    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """The identity on the way forward, the gradient rounded to fp8 back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def _quantize_training(model: torch.nn.Module) -> None:
    import torch.nn.functional as F

    q, qg = _Fp8.apply, _Fp8Grad.apply
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.forward = lambda x, m=m: qg(m._conv_forward(q(x), q(m.weight), m.bias))
        elif isinstance(m, torch.nn.Linear):
            m.forward = lambda x, m=m: qg(F.linear(q(x), q(m.weight), m.bias))


def _clip_(params, max_norm: float):
    """optax.clip_by_global_norm: scale by max/|g| only where |g| >= max."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


def steps(cfg: dict, sd: dict, batches: list[dict], seed: int, device, quant=False) -> dict:
    """The reference's first ``STEPS`` train steps from the weights ``sd``:
    the losses, the first gradient as Adam got it, the parameters after."""
    model = harness.architecture(cfg["model"]).reference(cfg["model"]).to(device)
    model.load_state_dict(sd)
    model.train()
    if quant:
        _quantize_training(model)
    opt_cfg = cfg["optimizer"]
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=opt_cfg["learning_rate"], betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=opt_cfg["weight_decay"], foreach=False)
    loss_cfg = LossConfig(**cfg["loss"])
    losses, grad1 = [], None
    for step, batch in enumerate(batches[:STEPS]):
        aug_seed, drop_seed = step_seeds(seed, step)
        gen = torch.Generator(device=device).manual_seed(aug_seed)
        x = normalize(augment_batch(gen, batch["images"].float() / 255.0))
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(drop_seed)
            controls, pred_speed = model(x, batch["speed"], batch["command"])
        total, _ = cilrs_loss(controls, pred_speed, batch["controls"], batch["speed"], loss_cfg)
        opt.zero_grad(set_to_none=True)
        total.backward()
        with torch.no_grad():
            _clip_(params, opt_cfg["gradient_clip"])
        opt.step()
        losses.append(float(total.detach()))
        if step == 0:
            grad1 = [opt.state[p]["exp_avg"] / 0.1 for p in params]
    names = [n for n, _ in model.named_parameters()]
    return {"losses": losses, "grad1": dict(zip(names, grad1)),
            "params": {n: p.detach() for n, p in model.named_parameters()}}


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's | |got| - |want| | / max(|want|, median leaf |want|)."""
    keys = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in keys]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def _worst(gaps: dict) -> tuple[str, float]:
    return max(gaps.items(), key=lambda kv: kv[1])


def gaps(cfg: dict, sd: dict, prog: dict, batches: list[dict], seed: int, device,
         quant=False) -> dict:
    """The numbers of the module docstring but ``batch_mismatch``, the
    reference training on its own ``batches``. ``prog``
    holds the program's {"batches", "losses", "grad1", "params3", "ema",
    "averaged"} (``averaged``: the program's tensors that its EMA averaged
    after the first group, in its order; ``ema``: the EMA's after its first
    update)."""
    ref = steps(cfg, sd, batches, seed, device, quant)
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    med_g = float(np.median(list(g_ref.values())))
    moving = {k for k, v in g_ref.items() if v >= 1e-3 * med_g}
    p0 = {k: sd[k].to(device) for k in ref["params"]}
    d_ref = _norms({k: ref["params"][k] - p0[k] for k in p0})
    d_prog = _norms({k: prog["params3"][k].float() - p0[k] for k in p0})
    g_gaps, d_gaps = leaf_gaps(g_prog, g_ref), leaf_gaps(d_prog, d_ref, moving)
    g_leaf, d_leaf = _worst(g_gaps), _worst(d_gaps)
    return {"loss_gap": loss_gaps[0], "grad_gap": float(np.median(list(g_gaps.values()))),
            "change_gap": float(np.median(list(d_gaps.values()))),
            "ema_gap": ema_gap(sd, prog, quant), "later_loss_gaps": loss_gaps[1:],
            "grad_worst": g_leaf[1], "grad_worst_leaf": g_leaf[0],
            "change_worst": d_leaf[1], "change_worst_leaf": d_leaf[0],
            "moving_leaves": len(moving), "leaves": len(g_ref)}


def ema_gap(sd: dict, prog: dict, quant=False) -> float:
    """The program's EMA after its first update against d * start + (1 - d) *
    the program's averaged tensors, d = min(0.999^K, 2/11)."""
    d = min(0.999 ** prog["group_steps"], 2.0 / 11.0)
    worst = 0.0
    for name, ema, avg in zip(prog["averaged_names"], prog["ema"], prog["averaged"]):
        start = sd[name].to(avg.device)
        if quant:
            want = (start.bfloat16() * d + avg.bfloat16() * (1 - d)).float()
        else:
            want = start * d + avg.float() * (1 - d)
        worst = max(worst, float((ema.float() - want).abs().max() / want.abs().max().clamp(min=1e-30)))
    return worst


def table_rows(pages: tuple, page_rows: int, labels: dict, idxs, shape) -> list[dict]:
    """The reference's batches: rows ``idxs`` [K, B] (global rows; page =
    row // page_rows) of the table and its labels, by plain indexing."""
    out = []
    for rows in idxs:
        rows = torch.as_tensor(np.asarray(rows), device=pages[0].device).long()
        page, local = rows // page_rows, rows % page_rows
        frames = torch.stack([pages[int(p)][int(r)] for p, r in zip(page.tolist(), local.tolist())])
        n = int(np.prod(shape))
        out.append({"images": frames[:, :n].reshape((len(rows),) + tuple(shape)),
                    **{k: labels[k][rows] for k in ("speed", "command", "controls")}})
    return out


def batch_mismatch(batches: list[dict], ref_batches: list[dict]) -> int:
    """Elements of the program's batches that differ from the reference's."""
    return sum(int((b[k] != r[k].to(b[k].device)).sum()) for b, r in zip(batches, ref_batches)
               for k in r)
