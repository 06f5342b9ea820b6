"""Losses over the global batch (the JAX package computes every loss on the
global batch; the port's processes each hold a share of it).

`global_mean` is the mean the port's losses end in (the causal LM loss of
the decoder families, T5's `seq2seq_lm_loss`, BERT's and ResNet's). With
one process it is the plain expression. Across processes its value is the
global mean on every process, and its gradient this process's share of it
times the process count, which the strategies' gradient average
(`parallel.fsdp`) undoes: the averaged gradient is the global loss's.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist


_LOCAL = {"depth": 0}


@contextlib.contextmanager
def local_means():
    """Inside, `global_mean` is each process's own mean (its gradient this
    process's alone, with no factor for an average to undo), its value the
    mean of the processes' means: Local SGD's loss (JAX's `LocalSGD`
    differentiates each replica's own mean and reports their mean)."""
    _LOCAL["depth"] += 1
    try:
        yield
    finally:
        _LOCAL["depth"] -= 1


_GROUP = {"group": None}


@contextlib.contextmanager
def batch_group(group):
    """Inside, `global_mean` reduces over `group`, the ranks whose batch
    rows differ. None is every process. Under a "model" axis the ranks of
    one data shard see the same rows: the caller that owns the mesh (the
    prepared model's `loss`, the fused step, `Accelerator.backward`)
    enters its ("data", "fsdp") group (`parallel.mesh.data_parallel_group`)."""
    saved = _GROUP["group"]
    _GROUP["group"] = group
    try:
        yield
    finally:
        _GROUP["group"] = saved


def _data_group():
    return _GROUP["group"]


class _MeanOfMeans(torch.autograd.Function):
    """Forward: the mean of every process's value. Backward: the gradient
    as it is."""

    @staticmethod
    def forward(ctx, local):
        total = local.detach().clone()
        dist.all_reduce(total, group=_data_group())
        return total / data_parallel_world()

    @staticmethod
    def backward(ctx, grad):
        return grad


def data_parallel_world() -> int:
    """The number of processes a gradient is averaged over (1 without a
    group): the world, or its ("data", "fsdp") ranks under a "model" axis."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(_data_group())


class _GlobalSum(torch.autograd.Function):
    """Forward: the sum of every process's value (the same on each).
    Backward: the gradient times the process count, for the gradient
    average to undo."""

    @staticmethod
    def forward(ctx, share):
        ctx.world = data_parallel_world()
        total = share.detach().clone()
        dist.all_reduce(total, group=_data_group())
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.world


def global_mean(values: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's mean over the global batch: ``values.mean()``, or
    ``(values * weights).sum() / max(weights.sum(), 1)``, where the sums run
    over every process's rows. With one process it is exactly that
    expression. Across processes each computes its sum over the global
    count (one all-reduce of the count) and `_GlobalSum` adds the shares, so
    every process returns the same global value. Averaging each process's
    own mean instead would be another function whenever the processes hold
    different numbers of valid rows."""
    if data_parallel_world() > 1 and _LOCAL["depth"]:
        if weights is None:
            return _MeanOfMeans.apply(values.mean())
        return _MeanOfMeans.apply((values * weights).sum() / weights.sum().clamp_min(1.0))
    if data_parallel_world() == 1:
        if weights is None:
            return values.mean()
        return (values * weights).sum() / weights.sum().clamp_min(1.0)
    if weights is None:
        total = values.sum()
        count = torch.full((), float(values.numel()), device=values.device, dtype=total.dtype)
    else:
        total = (values * weights).sum()
        count = weights.sum().detach().clone()
    dist.all_reduce(count, group=_data_group())
    return _GlobalSum.apply(total / count.clamp_min(1.0))
