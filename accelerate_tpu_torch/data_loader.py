"""Data loading for one process (the port of the one-process path of
`accelerate_tpu/data_loader.py`).

`SimpleDataLoader` collates map-style samples (dicts of numpy arrays, as
the JAX package's tests and examples hand it) into numpy batches through a
`BatchSampler`; `prepare_data_loader` wraps it, a `torch.utils.data.DataLoader`
or any iterable of batches in a `DataLoaderShard`, which moves every batch to
the device as tensors and marks the last batch of a pass for the
accumulation bookkeeping (`GradientState.end_of_dataloader`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .state import GradientState
from .utils.operations import send_to_device


class BatchSampler:
    """Batches of indices from an index sampler (any iterable of ints)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


def default_collate(samples):
    """Stack samples into numpy arrays, through dicts, tuples and lists."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class SimpleDataLoader:
    """Map-style dataset + batch sampler -> collated numpy batches."""

    def __init__(self, dataset, batch_sampler, collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])


class DataLoaderShard:
    """A prepared loader: yields `base`'s batches on `device` as tensors.

    One batch of lookahead sets `end_of_dataloader` while the last batch of
    a pass is out, so `Accelerator.accumulate` forces a sync there (the JAX
    package's `sync_with_dataloader` contract)."""

    def __init__(self, base, device: torch.device):
        self.base = base
        self.device = device
        self.end_of_dataloader = False
        self.gradient_state = GradientState()

    def __len__(self):
        return len(self.base)

    def __iter__(self):
        self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        try:
            it = iter(self.base)
            try:
                current = next(it)
            except StopIteration:
                return
            for upcoming in it:
                yield send_to_device(current, self.device)
                current = upcoming
            self.end_of_dataloader = True
            yield send_to_device(current, self.device)
        finally:
            self.gradient_state._remove_dataloader(self)


def prepare_data_loader(dataloader, device: torch.device) -> DataLoaderShard:
    """Wrap a `SimpleDataLoader`, a torch `DataLoader` or any iterable of
    batches for this process; batches land on `device` as tensors."""
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    return DataLoaderShard(dataloader, device)
