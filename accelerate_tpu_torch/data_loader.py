"""Data loading for one process (the port of the one-process path of
`accelerate_tpu/data_loader.py`).

`SimpleDataLoader` collates map-style samples (dicts of numpy arrays, as
the JAX package's tests and examples hand it) into numpy batches through a
`BatchSampler`; `prepare_data_loader` wraps it, a `torch.utils.data.DataLoader`
or any iterable of batches in a `DataLoaderShard`, which moves every batch to
the device as tensors and marks the last batch of a pass for the
accumulation bookkeeping (`GradientState.end_of_dataloader`).

For resuming: `SeedableRandomSampler` shuffles with
``np.random.default_rng(seed + epoch)``, the JAX package's order for the same
seed; the prepared loader counts its passes (`iteration`) and sets the
sampler's epoch from it at the start of each; `skip_first_batches` resumes
mid-pass, skipping indices before anything is loaded.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .state import GradientState
from .utils.operations import send_to_device


class SeedableRandomSampler:
    """A permutation of ``range(num_samples)`` drawn from
    ``np.random.default_rng(seed + epoch)``: the JAX package's sampler, so
    both packages visit samples in the same order. The prepared loader
    advances the epoch (`set_epoch`) at the start of each pass; alone it
    repeats one order."""

    def __init__(self, data_source=None, num_samples: Optional[int] = None, seed: int = 0, epoch: int = 0):
        self.num_samples = len(data_source) if num_samples is None else num_samples
        self.seed = seed
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def state_dict(self) -> dict:
        return {"seed": self.seed, "epoch": self.epoch}

    def load_state_dict(self, state: dict):
        self.seed = state["seed"]
        self.epoch = state["epoch"]

    def __iter__(self):
        yield from np.random.default_rng(self.seed + self.epoch).permutation(self.num_samples).tolist()


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


class SkipBatchSampler:
    """A batch sampler without its first `skip_batches` batches."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches

    def __iter__(self):
        for index, samples in enumerate(self.batch_sampler):
            if index >= self.skip_batches:
                yield samples

    def __len__(self):
        return max(0, len(self.batch_sampler) - self.skip_batches)


class _SkipBatches:
    """Any iterable of batches without its first `n`: the skip for loaders
    that have no batch sampler to skip indices in."""

    def __init__(self, base, n: int):
        self.base = base
        self.n = n

    def __len__(self):
        return max(0, len(self.base) - self.n)

    def __iter__(self):
        for index, batch in enumerate(self.base):
            if index >= self.n:
                yield batch


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
    package's `sync_with_dataloader` contract). `iteration` counts the
    passes completed; each pass starts by setting the sampler's epoch to it
    (`set_epoch`), so a seedable sampler draws a new order every pass."""

    def __init__(self, base, device: torch.device):
        self.base = base
        self.device = device
        self.end_of_dataloader = False
        self.gradient_state = GradientState()
        self.iteration = 0
        self._linked_loader = None  # the loader a `skip_first_batches` copy resumes

    def __len__(self):
        return len(self.base)

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch of the next pass (and the pass counter)."""
        self.iteration = epoch
        batch_sampler = getattr(self.base, "batch_sampler", None)
        for holder in (batch_sampler, getattr(batch_sampler, "batch_sampler", None)):
            if hasattr(getattr(holder, "sampler", None), "set_epoch"):
                holder.sampler.set_epoch(epoch)
                return

    def __iter__(self):
        self.set_epoch(self.iteration)
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
            self.iteration += 1
            if self._linked_loader is not None:
                # The resumed pass is over: the original loader's next pass
                # draws the next epoch's order, not this one's again.
                self._linked_loader.iteration = max(self._linked_loader.iteration, self.iteration)
        finally:
            self.gradient_state._remove_dataloader(self)


def skip_first_batches(dataloader, num_batches: int = 0):
    """`dataloader` without its first `num_batches` batches, to resume a pass
    (JAX's `skip_first_batches`). A `SimpleDataLoader` (prepared or not)
    skips at the index plane, through a `SkipBatchSampler`, so the skipped
    batches are never collated; other loaders skip collated batches. A
    prepared loader's copy carries its pass counter, so it replays the
    interrupted epoch's order, and when its pass ends it advances the
    original's."""
    base = dataloader.base if isinstance(dataloader, DataLoaderShard) else dataloader
    if isinstance(base, SimpleDataLoader):
        skipped = SimpleDataLoader(base.dataset, SkipBatchSampler(base.batch_sampler, num_batches), base.collate_fn)
    else:
        skipped = _SkipBatches(base, num_batches)
    if not isinstance(dataloader, DataLoaderShard):
        return skipped
    shard = DataLoaderShard(skipped, dataloader.device)
    shard.iteration = dataloader.iteration
    shard._linked_loader = dataloader
    return shard


def prepare_data_loader(dataloader, device: torch.device) -> DataLoaderShard:
    """Wrap a `SimpleDataLoader`, a torch `DataLoader` or any iterable of
    batches for this process; batches land on `device` as tensors."""
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    return DataLoaderShard(dataloader, device)
