"""Data loading (the port of `accelerate_tpu/data_loader.py`).

`SimpleDataLoader` collates map-style samples (dicts of numpy arrays, as
the JAX package's tests and examples hand it) into numpy batches through a
`BatchSampler`; `prepare_data_loader` wraps it, a `torch.utils.data.DataLoader`
or any iterable of batches in a `DataLoaderShard`, which moves every batch to
the device as tensors and marks the last batch of a pass for the
accumulation bookkeeping (`GradientState.end_of_dataloader`).

Across processes, `prepare_data_loader` splits the batch stream at the
index plane, as JAX's: `BatchSamplerShard` gives each process its batches
(every `num_processes`-th batch, or its slice of every batch with
`split_batches`), `IterableDatasetShard` its slice of every global batch
of an iterable dataset; with `even_batches` the last global batch is
topped up by cycling the epoch's first samples, and the number of real
samples in it (`remainder`) is recorded for `gather_for_metrics` to cut the
rest. A torch `DataLoader`'s `RandomSampler` becomes a
`SeedableRandomSampler`, so every process draws the same permutation.
`DataLoaderDispatcher` (one process reads, all receive) waits for
ROADMAP A item 6.

For resuming: `SeedableRandomSampler` shuffles with
``np.random.default_rng(seed + epoch)``, the JAX package's order for the same
seed; the prepared loader counts its passes (`iteration`) and sets the
sampler's epoch from it at the start of each; `skip_first_batches` resumes
mid-pass, skipping indices before anything is loaded.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Iterable, Optional

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


class BatchSamplerShard:
    """One process's share of a stream of index batches (JAX's
    `BatchSamplerShard`, with its semantics).

      - ``split_batches=False``: the inner sampler yields per-process
        batches; each group of `num_processes` consecutive batches is one
        global step, of which this process takes the `process_index`-th.
      - ``split_batches=True``: the inner sampler yields global batches of
        `batch_size`; this process takes its contiguous
        ``batch_size / num_processes`` slice of each.

    `even_batches` tops the tail up by cycling the epoch's first samples,
    so every process gets the same number of equally sized batches;
    without it the last batches may be short or missing on some processes.
    `drop_last` (read from the inner sampler) drops an incomplete step."""

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0, split_batches: bool = False,
                 even_batches: bool = True):
        if split_batches and getattr(batch_sampler, "batch_size", None) is not None:
            if batch_sampler.batch_size % num_processes != 0:
                raise ValueError(
                    f"To use `split_batches=True`, the batch size ({batch_sampler.batch_size}) "
                    f"must be a round multiple of the number of processes ({num_processes})."
                )
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        if self.split_batches:
            return len(self.batch_sampler)
        length = len(self.batch_sampler)
        if length % self.num_processes == 0:
            return length // self.num_processes
        if self.even_batches and not self.drop_last:
            return math.ceil(length / self.num_processes)
        if self.drop_last:
            return length // self.num_processes
        return length // self.num_processes + (1 if self.process_index < length % self.num_processes else 0)

    def __iter__(self):
        return self._iter_with_split() if self.split_batches else self._iter_with_no_split()

    def _iter_with_split(self):
        initial_data = []
        batch_length = None
        full_size = None
        for idx, batch in enumerate(self.batch_sampler):
            if idx == 0:
                initial_data = list(batch)
                # The slice comes from the declared batch size: a short first
                # batch must not shrink every process's share.
                full_size = self.batch_size or len(batch)
                batch_length = full_size // self.num_processes
            start = batch_length * self.process_index
            end = batch_length * (self.process_index + 1)
            if len(batch) == full_size:
                yield batch[start:end]
            elif self.drop_last:
                continue
            elif not self.even_batches:
                chunk = batch[start:end]
                if len(chunk) > 0:
                    yield chunk
            else:
                batch = list(batch)
                while len(batch) < full_size:
                    batch += initial_data[: full_size - len(batch)]
                yield batch[start:end]

    def _iter_with_no_split(self):
        initial_data = []
        group = []
        batch_size_seen = None
        for idx, batch in enumerate(self.batch_sampler):
            if idx < self.num_processes:
                initial_data += list(batch)
            if batch_size_seen is None:
                batch_size_seen = len(batch)
            group.append(list(batch))
            if len(group) == self.num_processes:
                if len(group[-1]) == batch_size_seen or not self.even_batches:
                    yield group[self.process_index]
                    group = []
                    continue
                yield from self._finish_tail(group, initial_data, batch_size_seen)
                return
        if group:
            yield from self._finish_tail(group, initial_data, batch_size_seen)

    def _finish_tail(self, group, initial_data, batch_size_seen):
        if self.drop_last:
            full = [b for b in group if len(b) == batch_size_seen]
            if len(full) == self.num_processes:
                yield full[self.process_index]
            return
        if not self.even_batches:
            if self.process_index < len(group):
                yield group[self.process_index]
            return
        cycle = itertools.cycle(initial_data)
        for b in group:
            while len(b) < batch_size_seen:
                b.append(next(cycle))
        while len(group) < self.num_processes:
            group.append([next(cycle) for _ in range(batch_size_seen)])
        yield group[self.process_index]


class IterableDatasetShard:
    """One process's share of an iterable dataset (JAX's
    `IterableDatasetShard`): of every global batch of
    ``batch_size * num_processes`` samples (`batch_size` with
    `split_batches`), this process's contiguous slice. With `even_batches`
    a short last batch is topped up by cycling the first batch's samples."""

    def __init__(self, dataset: Iterable, batch_size: int = 1, drop_last: bool = False, num_processes: int = 1,
                 process_index: int = 0, split_batches: bool = False, even_batches: bool = True):
        if split_batches and batch_size % num_processes != 0:
            raise ValueError(
                f"To use `split_batches=True`, the batch size ({batch_size}) must be a round "
                f"multiple of the number of processes ({num_processes})."
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches

    def set_epoch(self, epoch: int):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        real_batch = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        per_proc = real_batch // self.num_processes
        full_batches = n // real_batch
        tail = n % real_batch
        if self.drop_last or tail == 0:
            return full_batches * per_proc
        if self.even_batches:
            return (full_batches + 1) * per_proc
        start = self.process_index * per_proc
        end = start + per_proc
        return full_batches * per_proc + max(0, min(end, tail) - start)

    def __iter__(self):
        real_batch_size = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        process_slice_size = real_batch_size // self.num_processes
        start = self.process_index * process_slice_size
        end = start + process_slice_size
        first_batch = None
        current_batch = []
        for element in self.dataset:
            current_batch.append(element)
            if len(current_batch) == real_batch_size:
                yield from current_batch[start:end]
                if first_batch is None:
                    first_batch = current_batch.copy()
                current_batch = []
        if not self.drop_last and len(current_batch) > 0:
            if not self.even_batches:
                yield from current_batch[start:min(end, len(current_batch))]
                return
            if first_batch is None:
                first_batch = current_batch.copy()
            cycle = itertools.cycle(first_batch)
            while len(current_batch) < real_batch_size:
                current_batch.append(next(cycle))
            yield from current_batch[start:end]


class _IterableAsLoader:
    """Batches of `batch_size` collated from an (already sharded) iterable."""

    def __init__(self, dataset, batch_size: int, collate_fn: Optional[Callable] = None, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last

    def __len__(self):
        return math.ceil(len(self.dataset) / self.batch_size)

    def __iter__(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)


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
    (`set_epoch`), so a seedable sampler draws a new order every pass.
    Given the global batch size and the dataset's length, each pass records
    `remainder`, the real samples of the last global batch (-1 when it is
    full or unknown)."""

    def __init__(self, base, device: torch.device, total_batch_size: Optional[int] = None,
                 total_dataset_length: Optional[int] = None):
        self.base = base
        self.device = device
        self.total_batch_size = total_batch_size
        self.total_dataset_length = total_dataset_length
        self.remainder = -1
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
        self.remainder = -1
        if self.total_batch_size and self.total_dataset_length is not None:
            self.remainder = self.total_dataset_length % self.total_batch_size or -1
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
    shard = DataLoaderShard(skipped, dataloader.device, dataloader.total_batch_size, dataloader.total_dataset_length)
    shard.iteration = dataloader.iteration
    shard._linked_loader = dataloader
    return shard


def _rebuild_torch_loader(dataloader, batch_sampler):
    """A torch `DataLoader` over the same dataset, workers and collate, with
    another batch sampler."""
    kwargs = {
        "num_workers": dataloader.num_workers,
        "collate_fn": dataloader.collate_fn,
        "pin_memory": dataloader.pin_memory,
        "timeout": dataloader.timeout,
        "worker_init_fn": dataloader.worker_init_fn,
        "prefetch_factor": dataloader.prefetch_factor if dataloader.num_workers > 0 else None,
        "persistent_workers": dataloader.persistent_workers,
    }
    kwargs = {k: v for k, v in kwargs.items() if v is not None or k == "collate_fn"}
    return torch.utils.data.DataLoader(dataloader.dataset, batch_sampler=batch_sampler, **kwargs)


def _length(dataset) -> Optional[int]:
    try:
        return len(dataset)
    except TypeError:
        return None


def prepare_data_loader(dataloader, device: torch.device, num_processes: Optional[int] = None,
                        process_index: Optional[int] = None, split_batches: bool = False, even_batches: bool = True,
                        use_seedable_sampler: bool = True, data_seed: int = 42) -> DataLoaderShard:
    """Wrap a `SimpleDataLoader`, a torch `DataLoader` or any iterable of
    batches for this process; batches land on `device` as tensors.

    `num_processes` and `process_index` default to the `PartialState`'s.
    With more than one process a `SimpleDataLoader`'s or a map-style torch
    loader's batch sampler is sharded (`BatchSamplerShard`), an iterable
    torch dataset is sliced (`IterableDatasetShard`), and a torch loader's
    `RandomSampler` becomes a `SeedableRandomSampler(seed=data_seed)`; any
    other iterable is taken as this process's batches already. With
    `split_batches` the loader's batch size is the global one."""
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    if num_processes is None or process_index is None:
        from .state import PartialState

        state = PartialState()
        num_processes = state.num_processes if num_processes is None else num_processes
        process_index = state.process_index if process_index is None else process_index
    if num_processes == 1:
        return DataLoaderShard(dataloader, device)
    shard_kw = dict(num_processes=num_processes, process_index=process_index, split_batches=split_batches,
                    even_batches=even_batches)
    if isinstance(dataloader, torch.utils.data.DataLoader):
        dataset = dataloader.dataset
        batch_size = dataloader.batch_size if dataloader.batch_size is not None else getattr(
            dataloader.batch_sampler, "batch_size", 1)
        total_batch_size = batch_size * (1 if split_batches else num_processes)
        if isinstance(dataset, torch.utils.data.IterableDataset):
            shard = IterableDatasetShard(dataset, batch_size=batch_size, drop_last=dataloader.drop_last, **shard_kw)
            per_process = batch_size // num_processes if split_batches else batch_size
            base = _IterableAsLoader(shard, per_process, collate_fn=dataloader.collate_fn)
            return DataLoaderShard(base, device, total_batch_size, _length(dataset))
        batch_sampler = dataloader.batch_sampler
        if use_seedable_sampler and isinstance(getattr(batch_sampler, "sampler", None),
                                               torch.utils.data.RandomSampler):
            seedable = SeedableRandomSampler(num_samples=len(dataset), seed=data_seed)
            batch_sampler = BatchSampler(seedable, batch_size=batch_size, drop_last=dataloader.drop_last)
        base = _rebuild_torch_loader(dataloader, BatchSamplerShard(batch_sampler, **shard_kw))
        return DataLoaderShard(base, device, total_batch_size, len(dataset))
    if isinstance(dataloader, SimpleDataLoader):
        batch_sampler = dataloader.batch_sampler
        batch_size = getattr(batch_sampler, "batch_size", 1)
        total_batch_size = batch_size * (1 if split_batches else num_processes)
        base = SimpleDataLoader(dataloader.dataset, BatchSamplerShard(batch_sampler, **shard_kw),
                                collate_fn=dataloader.collate_fn)
        return DataLoaderShard(base, device, total_batch_size, _length(dataloader.dataset))
    return DataLoaderShard(dataloader, device)
