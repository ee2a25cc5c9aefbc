"""What the five train/eval-group probes share (``exp_train_gather_probe``,
``exp_page2_identity``, ``exp_eval_page_mutation``, ``exp_eval_sideeffect``,
``exp_dispatch_divergence``): the training loop's setup and group shapes, a
tap on the batches of the loop's own train group (``train/loop.py``'s
``train_group``, whose frames come through one launch of the row-gather
kernel), and the probes' integer checksums.

The JAX tools ran these groups as compiled, donated, scanned dispatches; the
port runs them eagerly, and the probes ask of it what they asked of XLA: do
the groups read exactly the rows they ask for, and leave the pages, the
weights and their own outputs bit-identical?

The checksums are the JAX tools' uint32 sums, in exact wrap arithmetic on
int64 tensors (torch has no general uint32 math): a product of two 32-bit
factors is formed from 16-bit halves of one of them, so that no int64
product overflows, and every sum is reduced mod 2^32 at the end.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from cilrs_tpu_torch.config import TrainConfig
from cilrs_tpu_torch.data.dataset import DriveDataset, WeightedBatchSampler, stratified_split
from cilrs_tpu_torch.tools.exp_checksum import WEIGHT_MOD
from cilrs_tpu_torch.train.loop import STEPS_PER_CALL, running_stats
from cilrs_tpu_torch.train.state import TrainState, create_train_state, make_optimizer

MASK32 = 0xFFFFFFFF
MIX = 2654435761  # Knuth's multiplicative hash: order-sensitive checksums
PAGE_MIX1, PAGE_MIX2 = 2654435761, 40503  # the page hash's row and byte weights
FINGERPRINT_MOD = 1 << 61
PAGE_HASH_ROWS = 1024  # rows of a page hashed at once (432 MB of int64 at 52,800 B)


# ---------------------------------------------------------------------------
# uint32 checksums
# ---------------------------------------------------------------------------


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` and ``b`` (a tensor or an int) in
    [0, 2^32): b's 16-bit halves keep every product under 2^49."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def image_checksum(images: torch.Tensor) -> torch.Tensor:
    """sum_i img[i] * (i * MIX) mod 2^32 over a batch's u8 bytes in order
    (``exp_train_gather_probe.py``'s image checksum); an int64 scalar on the
    batch's device."""
    flat = images.reshape(-1).to(torch.int64)
    k = mul32(torch.arange(flat.numel(), dtype=torch.int64, device=flat.device), MIX)
    return (flat * k).sum() & MASK32


def label_checksum(batch: dict) -> torch.Tensor:
    """sum (bits * MIX) mod 2^32 over the float32 bits of the batch's speed,
    command (as float32) and controls, as ``bitcast_convert_type`` takes them."""
    lab = torch.cat([batch["speed"].reshape(-1).float(), batch["command"].float(),
                     batch["controls"].reshape(-1).float()])
    bits = lab.view(torch.int32).to(torch.int64) & MASK32
    return mul32(bits, MIX).sum() & MASK32


def host_label_checksum(labels: dict, idx: np.ndarray) -> int:
    """The label checksum of rows ``idx`` from the host copies, in numpy's
    uint64 (the JAX tool's device-free recomputation)."""
    lab = np.concatenate([labels["speed"][idx].astype(np.float32).reshape(-1),
                          labels["command"][idx].astype(np.float32),
                          labels["controls"][idx].astype(np.float32).reshape(-1)])
    prod = (lab.view(np.uint32).astype(np.uint64) * np.uint64(MIX)) & np.uint64(MASK32)
    return int(prod.sum() & np.uint64(MASK32))


def page_hash(page: torch.Tensor) -> int:
    """sum_s h1[s] * (sum_d page[s, d] * h2[d]) mod 2^32, h1[s] = s * MIX1 + 1,
    h2[d] = d * MIX2 + 1 (``exp_eval_page_mutation.py``'s factored hash),
    over every physical row of a page, ``PAGE_HASH_ROWS`` rows at a time.
    ``d`` counts the row's bytes, so a JAX page's zero lane padding adds
    nothing: both packages' hashes of the same rows are equal."""
    rows = page.reshape(page.shape[0], -1)
    s, d = rows.shape
    dev = rows.device
    h2 = (torch.arange(d, dtype=torch.int64, device=dev) * PAGE_MIX2 + 1) & MASK32
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, s, PAGE_HASH_ROWS):
        hi = min(lo + PAGE_HASH_ROWS, s)
        row = (rows[lo:hi].to(torch.int64) * h2).sum(dim=1) & MASK32
        h1 = (mul32(torch.arange(lo, hi, dtype=torch.int64, device=dev), PAGE_MIX1) + 1) & MASK32
        acc += mul32(row, h1).sum()
    return int(acc) & MASK32


def weighted_checksums(images: torch.Tensor, k: int) -> np.ndarray:
    """[k] per-batch sums of u8 bytes weighted by ``arange(D) % 251 + 1`` (the
    frame's byte position), mod 2^32 (``exp_dispatch_divergence.py``'s)."""
    batches = images.reshape(k, -1, int(np.prod(images.shape[1:])))
    w = torch.arange(batches.shape[2], dtype=torch.int64, device=images.device) % WEIGHT_MOD + 1
    return np.array([int((b.to(torch.int64) * w).sum()) & MASK32 for b in batches],
                    dtype=np.int64)


def _fingerprinted(model: torch.nn.Module) -> list[torch.Tensor]:
    """The weights a fingerprint covers: every parameter and BatchNorm
    running statistic (the JAX tools' params and batch_stats), in order."""
    return [t.detach() for t in list(model.parameters()) + running_stats(model)]


def params_fingerprint(model: torch.nn.Module) -> int:
    """Sum of every weight's int32 view, mod 2^61 (``exp_eval_sideeffect.py``'s
    fingerprint; an order-free sum, so equal weights give the JAX tool's
    value whatever their layout)."""
    tot = 0
    for t in _fingerprinted(model):
        tot = (tot + int(t.view(torch.int32).to(torch.int64).sum())) % FINGERPRINT_MOD
    return tot


def md5_fingerprint(tensors) -> str:
    """md5 over the bytes of each tensor in turn, in row-major order
    (``exp_page2_identity.py``'s ``fingerprint``)."""
    h = hashlib.md5()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def model_md5(model: torch.nn.Module) -> str:
    return md5_fingerprint(_fingerprinted(model))


# ---------------------------------------------------------------------------
# The loop's groups
# ---------------------------------------------------------------------------


def tapped(train_step, tap):
    """``train_step`` that first calls ``tap(batch)``: handed to the loop's
    ``train_group``, it shows the tap each batch the group's gather made,
    before its step consumes it."""
    def step(state, batch, seed):
        tap(batch)
        return train_step(state, batch, seed)
    return step


@dataclass
class LoopSetup:
    """``train/loop.py``'s setup of a run: the stratified split, the batch,
    the steps an epoch, one epoch of the weighted sampler's draws (positions
    in ``train_idx``) and the train steps' seed."""
    train_idx: np.ndarray
    val_idx: np.ndarray
    batch: int
    steps_per_epoch: int
    draws: np.ndarray  # [steps_per_epoch, batch]
    seed: int

    def groups(self, n: int) -> list[np.ndarray]:
        """The first ``n`` groups of STEPS_PER_CALL batches of global rows
        (the last may be shorter)."""
        return [self.train_idx[self.draws[s:s + STEPS_PER_CALL]]
                for s in range(0, len(self.draws), STEPS_PER_CALL)][:n]

    def state(self, cfg: TrainConfig, dev) -> TrainState:
        return create_train_state(cfg, cfg.training.seed, self.steps_per_epoch, device=dev)


def loop_setup(ds: DriveDataset, cfg: TrainConfig) -> LoopSetup:
    t = cfg.training
    train_idx, val_idx = stratified_split(ds, t.val_fraction, t.seed)
    spe = max(1, len(train_idx) // t.batch_size)
    sampler = WeightedBatchSampler(ds.command[train_idx], t.batch_size, t.seed,
                                   controls=ds.controls[train_idx],
                                   hard_boost=t.hard_frame_boost)
    return LoopSetup(train_idx, val_idx, t.batch_size, spe, np.stack(list(sampler.epoch(spe))),
                     t.seed + 1)


def throwaway_copy(state: TrainState, cfg: TrainConfig, steps_per_epoch: int) -> TrainState:
    """A state with a copy of ``state``'s weights and a fresh optimizer and
    schedule: training it leaves ``state`` as it is (the JAX tool's
    ``jnp.copy`` of an untrained state)."""
    model = copy.deepcopy(state.model)
    opt, sched = make_optimizer(model.parameters(), cfg.optimizer, steps_per_epoch)
    return TrainState(model, opt, sched, state.max_grad_norm, state.step)


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms, benchmark mode off, for a probe's
    comparisons; both as they were afterwards."""
    prior = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prior
