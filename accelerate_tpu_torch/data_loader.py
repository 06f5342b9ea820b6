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
`SeedableRandomSampler`, so every process draws the same permutation, and
at the start of each pass the loader brings the generators of the
accelerator's `rng_types` into agreement (`utils.random.synchronize_rng_states`).

`DataLoaderDispatcher` is the other way, JAX's for iterable datasets and
for ``dispatch_batches=True``: process 0 alone iterates the loader, over
the global batch; the batch's layout travels by `broadcast_object_list`
and its tensors by `torch.distributed.broadcast`, and each process keeps
its rows. A loader prepared with ``device_placement=False`` hands out
host tensors.

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

from .state import GradientState, PartialState
from .utils import operations as ops
from .utils.operations import recursively_apply, send_to_device
from .utils.random import synchronize_rng_states


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


def _set_epoch(base, epoch: int):
    """Set `epoch` on the sampler behind `base`'s batch sampler (through a
    sharding or skipping one), else on its dataset, as JAX's loaders do."""
    batch_sampler = getattr(base, "batch_sampler", None)
    for holder in (batch_sampler, getattr(batch_sampler, "batch_sampler", None)):
        if hasattr(getattr(holder, "sampler", None), "set_epoch"):
            holder.sampler.set_epoch(epoch)
            return
    dataset = getattr(base, "dataset", None)
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)


class DataLoaderShard:
    """A prepared loader: yields `base`'s batches on `device` as tensors.

    One batch of lookahead sets `end_of_dataloader` while the last batch of
    a pass is out, so `Accelerator.accumulate` forces a sync there (the JAX
    package's `sync_with_dataloader` contract). `iteration` counts the
    passes completed; each pass starts by setting the sampler's epoch to it
    (`set_epoch`), so a seedable sampler draws a new order every pass.
    Given the global batch size and the dataset's length, each pass records
    `remainder`, the real samples of the last global batch (-1 when it is
    full or unknown). Each pass starts by synchronizing the generators of
    `rng_types` (and `synchronized_generator`, the sampler) across the
    processes; with `device_placement` False the batches stay on the host."""

    def __init__(self, base, device: torch.device, total_batch_size: Optional[int] = None,
                 total_dataset_length: Optional[int] = None, device_placement: bool = True,
                 rng_types: Optional[list] = None, synchronized_generator=None):
        self.base = base
        self.device = device
        self.total_batch_size = total_batch_size
        self.total_dataset_length = total_dataset_length
        self.device_placement = device_placement
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
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
        _set_epoch(self.base, epoch)

    def _clone(self, base) -> "DataLoaderShard":
        """A loader like this one over another base."""
        return DataLoaderShard(base, self.device, self.total_batch_size, self.total_dataset_length,
                               device_placement=self.device_placement, rng_types=self.rng_types,
                               synchronized_generator=self.synchronized_generator)

    def _place(self, batch):
        return send_to_device(batch, self.device if self.device_placement else torch.device("cpu"))

    def __iter__(self):
        if self.rng_types is not None:
            synchronize_rng_states(self.rng_types, self.synchronized_generator)
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
                yield self._place(current)
                current = upcoming
            self.end_of_dataloader = True
            yield self._place(current)
            self.iteration += 1
            if self._linked_loader is not None:
                # The resumed pass is over: the original loader's next pass
                # draws the next epoch's order, not this one's again.
                self._linked_loader.iteration = max(self._linked_loader.iteration, self.iteration)
        finally:
            self.gradient_state._remove_dataloader(self)


def _as_tensors(batch):
    return recursively_apply(torch.as_tensor, batch)


def _layout(batch):
    """Each leaf's shape and dtype (a `torch.dtype`'s name), through dicts,
    lists and tuples."""
    return recursively_apply(lambda t: {"shape": tuple(t.shape), "dtype": str(t.dtype).split(".")[-1]}, batch,
                             test_type=lambda t: isinstance(t, torch.Tensor))


def _zeros(layout):
    """Zero tensors of a `_layout`."""
    if isinstance(layout, dict) and set(layout) == {"shape", "dtype"}:
        return torch.zeros(layout["shape"], dtype=getattr(torch, layout["dtype"]))
    if isinstance(layout, dict):
        return {k: _zeros(v) for k, v in layout.items()}
    if isinstance(layout, (list, tuple)):
        return type(layout)(_zeros(v) for v in layout)
    return layout


def _batch_size(batch) -> Optional[int]:
    """The first dim of the first tensor leaf."""
    if isinstance(batch, (list, tuple)):
        sizes = [_batch_size(v) for v in batch]
    elif isinstance(batch, dict):
        sizes = [_batch_size(v) for v in batch.values()]
    else:
        return batch.shape[0] if isinstance(batch, torch.Tensor) and batch.dim() > 0 else None
    return next((s for s in sizes if s is not None), None)


def pad_batch_to_size(batch, target_size: int):
    """Every leaf's dim 0 topped up to `target_size` by cycling the batch's
    own rows (JAX's `pad_batch_to_size`): shapes stay whole, and
    `gather_for_metrics` cuts the repeats through `remainder`."""

    def _pad(t):
        if t.dim() == 0 or t.shape[0] >= target_size:
            return t
        reps = -(-target_size // t.shape[0])
        return torch.cat([t] * reps, dim=0)[:target_size]

    return recursively_apply(_pad, batch, test_type=lambda t: isinstance(t, torch.Tensor))


class DataLoaderDispatcher:
    """One process reads, every process receives (JAX's
    `DataLoaderDispatcher`).

    Process 0 alone iterates `base` over the global batch: the loader's own
    batch with `split_batches` (or one process), else `num_processes`
    consecutive batches joined. The batch's layout (each leaf's shape and
    dtype, or the end of the pass) reaches the others through
    `broadcast_object_list`, then its tensors through
    `torch.distributed.broadcast`. A short last global batch is topped up
    to the full size by cycling its rows, then each process keeps its
    contiguous share (`slice_fn(batch, slice, process_index,
    num_processes)` if given) and, with `even_batches`, tops it up to
    `per_host_batch_size`. On the last batch `remainder` is the real rows
    of that global batch, for `gather_for_metrics`. The first
    `skip_batches` global batches are read and dropped."""

    def __init__(self, base, device: torch.device, split_batches: bool = False,
                 total_batch_size: Optional[int] = None, total_dataset_length: Optional[int] = None,
                 skip_batches: int = 0, slice_fn: Optional[Callable] = None,
                 per_host_batch_size: Optional[int] = None, even_batches: bool = True,
                 device_placement: bool = True, num_processes: Optional[int] = None,
                 process_index: Optional[int] = None):
        state = PartialState()
        self.base = base
        self.device = device
        self.split_batches = split_batches
        self.total_batch_size = total_batch_size
        self.total_dataset_length = total_dataset_length
        self.skip_batches = skip_batches
        self.slice_fn = slice_fn
        self.per_host_batch_size = per_host_batch_size
        self.even_batches = even_batches
        self.device_placement = device_placement
        self.num_processes = state.num_processes if num_processes is None else num_processes
        self.process_index = state.process_index if process_index is None else process_index
        self.remainder = -1
        self.end_of_dataloader = False
        self.gradient_state = GradientState()
        self.iteration = 0
        self._linked_loader = None

    @property
    def dataset(self):
        return getattr(self.base, "dataset", None)

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch of the next pass (and the pass counter), as
        `DataLoaderShard` does. (JAX's dispatcher sets only a dataset's, so
        over a seedable sampler it repeats one order every pass.)"""
        self.iteration = epoch
        _set_epoch(self.base, epoch)

    def __len__(self):
        whole = len(self.base)
        if self.split_batches or self.num_processes == 1:
            return max(0, whole - self.skip_batches)
        return max(0, -(-whole // self.num_processes) - self.skip_batches)

    def _read_global_batch(self, iterator):
        n = 1 if self.split_batches or self.num_processes == 1 else self.num_processes
        parts = []
        for _ in range(n):
            try:
                parts.append(_as_tensors(next(iterator)))
            except StopIteration:
                break
        if not parts:
            raise StopIteration
        return parts[0] if len(parts) == 1 else ops.concatenate(parts, dim=0)

    def _fetch_batch(self, iterator):
        """(more, global batch): process 0 reads, the others receive."""
        if self.num_processes == 1:
            try:
                return True, self._read_global_batch(iterator)
            except StopIteration:
                return False, None
        info, batch = [False, None], None
        if self.process_index == 0:
            try:
                batch = self._read_global_batch(iterator)
                info = [True, _layout(batch)]
            except StopIteration:
                pass
        info = ops.broadcast_object_list(info, from_process=0)
        if not info[0]:
            return False, None
        if self.process_index != 0:
            batch = _zeros(info[1])
        return True, ops.broadcast(batch, from_process=0)

    def _slice_for_process(self, batch):
        size = _batch_size(batch)
        if size is None:
            return batch
        full = self.total_batch_size or size
        if size < full:
            batch, size = pad_batch_to_size(batch, full), full
        per_process = size // self.num_processes
        start = self.process_index * per_process
        if self.slice_fn is not None:
            return self.slice_fn(batch, slice(start, start + per_process), self.process_index, self.num_processes)
        return ops.slice_tensors(batch, slice(start, start + per_process))

    def __iter__(self):
        self.set_epoch(self.iteration)
        self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        self.remainder = -1
        target = self.device if self.device_placement else torch.device("cpu")
        try:
            iterator = iter(self.base) if self.process_index == 0 or self.num_processes == 1 else None
            more, current = self._fetch_batch(iterator)
            index = 0
            while more:
                more, upcoming = self._fetch_batch(iterator)
                if index >= self.skip_batches:
                    if not more:
                        self.end_of_dataloader = True
                        observed = _batch_size(current)
                        if observed is not None and self.total_batch_size:
                            self.remainder = observed % self.total_batch_size or -1
                    local = self._slice_for_process(current) if self.num_processes > 1 else current
                    if self.even_batches and self.per_host_batch_size is not None:
                        local = pad_batch_to_size(local, self.per_host_batch_size)
                    yield send_to_device(local, target)
                current = upcoming
                index += 1
            self.iteration += 1
            if self._linked_loader is not None:
                self._linked_loader.iteration = max(self._linked_loader.iteration, self.iteration)
        finally:
            self.gradient_state._remove_dataloader(self)


def skip_first_batches(dataloader, num_batches: int = 0):
    """`dataloader` without its first `num_batches` batches, to resume a pass
    (JAX's `skip_first_batches`). A `SimpleDataLoader` (prepared or not)
    skips at the index plane, through a `SkipBatchSampler`, so the skipped
    batches are never collated; a `DataLoaderDispatcher` reads and drops
    its first global batches; other loaders skip collated batches. A
    prepared loader's copy carries its pass counter, so it replays the
    interrupted epoch's order, and when its pass ends it advances the
    original's."""
    if isinstance(dataloader, DataLoaderDispatcher):
        skipped = DataLoaderDispatcher(
            dataloader.base, dataloader.device, split_batches=dataloader.split_batches,
            total_batch_size=dataloader.total_batch_size, total_dataset_length=dataloader.total_dataset_length,
            skip_batches=dataloader.skip_batches + num_batches, slice_fn=dataloader.slice_fn,
            per_host_batch_size=dataloader.per_host_batch_size, even_batches=dataloader.even_batches,
            device_placement=dataloader.device_placement, num_processes=dataloader.num_processes,
            process_index=dataloader.process_index)
    else:
        base = dataloader.base if isinstance(dataloader, DataLoaderShard) else dataloader
        if isinstance(base, SimpleDataLoader):
            skipped = SimpleDataLoader(base.dataset, SkipBatchSampler(base.batch_sampler, num_batches),
                                       base.collate_fn)
        else:
            skipped = _SkipBatches(base, num_batches)
        if not isinstance(dataloader, DataLoaderShard):
            return skipped
        skipped = dataloader._clone(skipped)
    skipped.iteration = dataloader.iteration
    skipped._linked_loader = dataloader
    return skipped


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
                        process_index: Optional[int] = None, split_batches: bool = False, put_on_device: bool = True,
                        rng_types: Optional[list] = None, dispatch_batches: Optional[bool] = None,
                        even_batches: bool = True, slice_fn_for_dispatch: Optional[Callable] = None,
                        use_seedable_sampler: bool = True, data_seed: int = 42):
    """Wrap a `SimpleDataLoader`, a torch `DataLoader` or any iterable of
    batches for this process; batches land on `device` as tensors (on the
    host without `put_on_device`).

    `num_processes` and `process_index` default to the `PartialState`'s.
    With `dispatch_batches` (by default: an iterable torch dataset across
    processes, as JAX decides) the loader becomes a `DataLoaderDispatcher`.
    Otherwise, with more than one process, a `SimpleDataLoader`'s or a
    map-style torch loader's batch sampler is sharded (`BatchSamplerShard`),
    an iterable torch dataset is sliced (`IterableDatasetShard`), and a
    torch loader's `RandomSampler` becomes a
    `SeedableRandomSampler(seed=data_seed)`; any other iterable is taken as
    this process's batches already. With `split_batches` the loader's batch
    size is the global one. Each pass of a sharded loader first
    synchronizes the generators of `rng_types` across the processes, its
    seedable sampler among them."""
    if isinstance(dataloader, (DataLoaderShard, DataLoaderDispatcher)):
        return dataloader
    if num_processes is None or process_index is None:
        state = PartialState()
        num_processes = state.num_processes if num_processes is None else num_processes
        process_index = state.process_index if process_index is None else process_index
    is_torch = isinstance(dataloader, torch.utils.data.DataLoader)
    if is_torch:
        dataset = dataloader.dataset
        is_iterable = isinstance(dataset, torch.utils.data.IterableDataset)
        if dispatch_batches is None:
            dispatch_batches = is_iterable and num_processes > 1
        batch_size = dataloader.batch_size if dataloader.batch_size is not None else getattr(
            dataloader.batch_sampler, "batch_size", 1)
    else:
        dataset = getattr(dataloader, "dataset", None)
        batch_size = getattr(getattr(dataloader, "batch_sampler", None), "batch_size", 1)
    total_batch_size = batch_size * (1 if split_batches else num_processes)
    if dispatch_batches and (is_torch or isinstance(dataloader, SimpleDataLoader)):
        return DataLoaderDispatcher(
            dataloader, device, split_batches=split_batches, total_batch_size=total_batch_size,
            total_dataset_length=_length(dataset), slice_fn=slice_fn_for_dispatch,
            per_host_batch_size=batch_size // num_processes if split_batches else batch_size,
            even_batches=even_batches, device_placement=put_on_device, num_processes=num_processes,
            process_index=process_index)
    shard_kw = dict(device_placement=put_on_device, rng_types=rng_types)
    if num_processes == 1:
        return DataLoaderShard(dataloader, device, **shard_kw)
    sampler_kw = dict(num_processes=num_processes, process_index=process_index, split_batches=split_batches,
                      even_batches=even_batches)
    if is_torch:
        if is_iterable:
            shard = IterableDatasetShard(dataset, batch_size=batch_size, drop_last=dataloader.drop_last, **sampler_kw)
            per_process = batch_size // num_processes if split_batches else batch_size
            base = _IterableAsLoader(shard, per_process, collate_fn=dataloader.collate_fn)
            return DataLoaderShard(base, device, total_batch_size, _length(dataset), **shard_kw)
        batch_sampler = dataloader.batch_sampler
        generator = None
        if use_seedable_sampler and isinstance(getattr(batch_sampler, "sampler", None),
                                               torch.utils.data.RandomSampler):
            generator = SeedableRandomSampler(num_samples=len(dataset), seed=data_seed)
            batch_sampler = BatchSampler(generator, batch_size=batch_size, drop_last=dataloader.drop_last)
        base = _rebuild_torch_loader(dataloader, BatchSamplerShard(batch_sampler, **sampler_kw))
        return DataLoaderShard(base, device, total_batch_size, len(dataset), synchronized_generator=generator,
                               **shard_kw)
    if isinstance(dataloader, SimpleDataLoader):
        batch_sampler = dataloader.batch_sampler
        generator = getattr(batch_sampler, "sampler", None)
        if not (use_seedable_sampler and isinstance(generator, SeedableRandomSampler)):
            generator = None
        base = SimpleDataLoader(dataloader.dataset, BatchSamplerShard(batch_sampler, **sampler_kw),
                                collate_fn=dataloader.collate_fn)
        return DataLoaderShard(base, device, total_batch_size, _length(dataloader.dataset),
                               synchronized_generator=generator, **shard_kw)
    return DataLoaderShard(dataloader, device, **shard_kw)
