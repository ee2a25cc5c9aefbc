"""Faults planted in the program underneath a run, for showing that the check
catches them (``tests/test_pb_faults.py`` on the CPU, ``calibrate.py
--fault`` on the card): a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced, a policy that
forgets what it carries. Each is a context manager that patches the
program's module attribute its caller looks up."""

from __future__ import annotations

import torch

from portbench.simrun import carry_reader, cloned
from portbench.trace import patched


def sim_fault(name: str, owner=None):
    """A simulator fault: ``unchanged`` (the action returns its input state),
    ``half`` (the policy computes the first half of the envs, every tensor
    argument, positional or keyword, cut along its first dimension, and
    zeros for the rest), ``altered`` (the policy's steer, the first column of
    what it returns, moved by 0.25), ``forgetful`` (the policy's carry
    cloned at its first call and copied back in place before every later
    call, so it never sees its history). ``owner`` holds the policy (a fleet
    or a drive run), whatever its architecture; the policy's own keyword
    arguments pass through."""
    from cilrs_tpu_torch.agent import driver

    if name == "unchanged":
        return patched(driver, "env_act", lambda f: lambda state, *a, **k: (state, f(state, *a, **k)[1]))
    if name == "half":
        def half(f):
            def call(*args, **kwargs):
                envs = next(a for a in (*args, *kwargs.values())
                            if isinstance(a, torch.Tensor)).shape[0]
                n = max(envs // 2, 1)

                def cut(a):
                    return a[:n] if isinstance(a, torch.Tensor) else a

                got = f(*map(cut, args), **{k: cut(v) for k, v in kwargs.items()})
                out = got.new_zeros((envs,) + got.shape[1:])
                out[:n] = got
                return out
            return call
        return patched(owner, "policy", half)
    if name == "altered":
        def altered(f):
            def call(*args, **kwargs):
                out = f(*args, **kwargs).clone()
                out[:, 0] += 0.25
                return out
            return call
        return patched(owner, "policy", altered)
    if name == "forgetful":
        carry = carry_reader(owner)
        if carry is None:
            raise ValueError("forgetful needs a policy that carries state (its architecture's "
                             "carry hook)")

        def forgetful(f):
            first = None

            def call(*args, **kwargs):
                nonlocal first
                now = carry()
                if first is None:
                    first = cloned(now)
                else:
                    for k, v in now.items():
                        v.copy_(first[k])
                return f(*args, **kwargs)
            return call
        return patched(owner, "policy", forgetful)
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
