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

from typing import Optional

import torch
import torch.distributed as dist


def data_parallel_world() -> int:
    """The number of processes a gradient is averaged over (1 without a group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class _GlobalSum(torch.autograd.Function):
    """Forward: the sum of every process's value (the same on each).
    Backward: the gradient times the process count, for the gradient
    average to undo."""

    @staticmethod
    def forward(ctx, share):
        ctx.world = dist.get_world_size()
        total = share.detach().clone()
        dist.all_reduce(total)
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
    dist.all_reduce(count)
    return _GlobalSum.apply(total / count.clamp_min(1.0))
