"""Faults planted in the program underneath a run, for showing that the check
catches them (``tests/test_pb_faults.py`` on the CPU, ``calibrate.py
--fault`` on the card): a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced. Each is a context
manager that patches the program's module attribute its caller looks up."""

from __future__ import annotations

import torch

from portbench.trace import patched


def sim_fault(name: str, owner=None):
    """A simulator fault: ``unchanged`` (the action returns its input state),
    ``half`` (the policy computes the first half of the envs, zeros for the
    rest), ``altered`` (the policy's steer moved by 0.25). ``owner`` holds
    the policy (a fleet or a drive run)."""
    from cilrs_tpu_torch.agent import driver

    if name == "unchanged":
        return patched(driver, "env_act", lambda f: lambda state, *a, **k: (state, f(state, *a, **k)[1]))
    if name == "half":
        def half(f):
            def call(img, speed, cmd):
                n = max(img.shape[0] // 2, 1)
                out = torch.zeros(img.shape[0], 3, device=img.device)
                out[:n] = f(img[:n], speed[:n], cmd[:n])
                return out
            return call
        return patched(owner, "policy", half)
    if name == "altered":
        return patched(owner, "policy", lambda f: lambda *a: f(*a) + torch.tensor(
            [0.25, 0.0, 0.0], device=a[0].device))
    raise ValueError(name)


def train_fault(name: str):
    """A training fault: ``unchanged`` (the update leaves the weights as they
    were), ``half`` (the loss over the first half of the batch),
    ``altered`` (the loss scaled by 1.1 where it is computed)."""
    from cilrs_tpu_torch.train import state as state_mod
    from cilrs_tpu_torch.train import steps

    if name == "unchanged":
        def skip(f):
            def apply(self):
                self.optimizer.zero_grad(set_to_none=True)
                self.scheduler.step()
                self.step += 1
            return apply
        return patched(state_mod.TrainState, "apply_gradients", skip)
    if name == "half":
        def half(f):
            def loss(cp, sp, ct, st, cfg):
                n = cp.shape[0] // 2
                return f(cp[:n], sp[:n], ct[:n], st[:n], cfg)
            return loss
        return patched(steps, "cilrs_loss", half)
    if name == "altered":
        def scaled(f):
            def loss(*a):
                total, parts = f(*a)
                return total * 1.1, {**parts, "loss": total * 1.1}
            return loss
        return patched(steps, "cilrs_loss", scaled)
    raise ValueError(name)
