"""``agent/driver.py:model_policy`` off the card: the CILRS forward as it is,
bit for bit, a fresh tensor each call, and no CUDA graph captured; which
calls would replay a graph on the card, and what a graph is captured for
(``models/policy_graph.py``). The card's replays are tested in
``tests/test_torch_cuda.py``."""

import types

import pytest
import torch

from cilrs_tpu_torch.agent.driver import model_policy
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.models.policy_graph import ModelPolicy, graph_key, graphable
from cilrs_tpu_torch.utils.profiling import span

TINY = (1, 1, 1, 1)
GRAD_MODES = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}


def tiny_cilrs(dtype=torch.bfloat16, seed=0) -> CILRS:
    torch.manual_seed(seed)
    return CILRS(dropout=0.0, dtype=dtype, stage_sizes=TINY).eval()


def policy_inputs(envs: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(envs, 88, 200, 3, generator=g), torch.rand(envs, generator=g),
            torch.randint(0, 4, (envs,), generator=g))


@pytest.mark.parametrize("grad_mode", sorted(GRAD_MODES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cpu_policy_is_the_eager_forward_bit_for_bit(dtype, grad_mode):
    model = tiny_cilrs(dtype)
    policy = model_policy(model)
    assert isinstance(policy, ModelPolicy) and policy.model is model
    x = policy_inputs(3)
    with GRAD_MODES[grad_mode]():
        got = policy(*x)
        want = model(*x)[0]
    assert got.shape == (3, 3) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_cpu_policy_captures_no_graph():
    policy = model_policy(tiny_cilrs())
    replays, captures = span("policy_graph").calls, span("policy_capture").calls
    with torch.inference_mode():
        for envs in (2, 3, 2):
            policy(*policy_inputs(envs, envs))
    assert policy.graphs == {}
    assert span("policy_graph").calls == replays and span("policy_capture").calls == captures


def test_cpu_policy_returns_a_fresh_tensor_each_call():
    policy = model_policy(tiny_cilrs())
    x = policy_inputs(2)
    with torch.inference_mode():
        first = policy(*x)
        kept = first.clone()
        second = policy(*x)
        first.fill_(7.0)
    assert first.untyped_storage().data_ptr() != second.untyped_storage().data_ptr()
    assert torch.equal(second, kept)


# (model in train mode, grad on, input on the card) -> would replay a graph
GRAPHABLE = {
    "eval_no_grad_card": (False, False, True, True),
    "train_no_grad_card": (True, False, True, False),
    "eval_grad_card": (False, True, True, False),
    "eval_no_grad_cpu": (False, False, False, False),
}


@pytest.mark.parametrize("case", sorted(GRAPHABLE))
def test_only_eval_calls_without_grad_on_the_card_replay(case):
    training, grad, card, want = GRAPHABLE[case]
    model = tiny_cilrs().train(training)
    # A stand-in for a card tensor: ``graphable`` reads only ``is_cuda``.
    image = types.SimpleNamespace(is_cuda=True) if card else torch.zeros(1)
    with torch.set_grad_enabled(grad):
        assert graphable(model, image) is want


@pytest.mark.parametrize("grad", [False, True], ids=["train_no_grad", "train_grad"])
def test_train_mode_calls_run_the_eager_forward(grad):
    model = tiny_cilrs(torch.float32).train()
    policy = model_policy(model)
    x = policy_inputs(4)
    with torch.set_grad_enabled(grad):
        got = policy(*x)
        want = model(*x)[0]
    assert torch.equal(got, want) and got.requires_grad is grad
    assert policy.graphs == {}


def test_graph_key_separates_fleet_sizes_and_model_dtypes():
    model = tiny_cilrs()
    key = {}
    for envs in (128, 64):
        for dtype in (torch.bfloat16, torch.float32):
            model.dtype = dtype
            key[envs, dtype] = graph_key(model, *policy_inputs(envs))
    assert len(set(key.values())) == 4
    model.dtype = torch.bfloat16
    assert graph_key(model, *policy_inputs(128, seed=1)) == key[128, torch.bfloat16]
    image, speed, cmd = policy_inputs(128)
    assert graph_key(model, image, speed, cmd.int()) != key[128, torch.bfloat16]
    assert graph_key(model, image.double(), speed, cmd) != key[128, torch.bfloat16]
