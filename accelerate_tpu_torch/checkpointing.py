"""Checkpoints of a training run (the synchronous, one-process part of
`accelerate_tpu/checkpointing.py`).

`save_accelerator_state` writes everything a run needs to resume (across
processes, gathered whole and written by the main process): each
model's f32 master weights, each optimizer's state and its fp16 loss
scaler, each scheduler's step count and learning rate, each seedable
sampler's epoch with its loader's pass counter, the host and device RNG
streams, and `load_accelerator_state` reads them back. Tensors go through
`torch.save` and come back through `torch.load(weights_only=True)`, onto
the device of what they restore; objects a user registers
(`save_custom_state`) are pickled, as in the JAX package.

Crash safety, as in the JAX package: every file commits through a temp
file, fsync and `os.replace` (`atomic_write`), so a kill at any byte leaves
the previous complete file or none. `CheckpointManager` does the same for
whole checkpoint directories: the artifacts land in a hidden staging
directory, `MANIFEST.json` with each file's SHA-256 is written last, one
`os.replace` publishes the directory, the `latest` pointer follows and
rotation keeps the last `keep_last_n`. `resolve("latest")` returns the
newest checkpoint whose digests verify, falling back past a torn one.

A training checkpoint is the port's own (`torch.save` files), not JAX's
`.npz` pytrees. The native pytree file, which `convert` writes and reads,
is JAX's layout exactly (`save_pytree` / `load_pytree`): a file written by
either package loads in the other.

`save_model_safetensors` writes just a model's weights for
`Accelerator.save_model`: safetensors through the port's own writer
(`utils/modeling.py`), split at a size into shards with an HF-style index,
each file committed atomically and the index last, as JAX's.

Asynchronous saves, as JAX's snapshot-then-commit: `snapshot_accelerator_state`
copies the whole state to host memory now (the blocking half: device
copies into `HostStaging`'s buffers, kept and pinned across saves, then
one wait on an event), and `write_accelerator_snapshot` writes that copy
on `AsyncCommitter`'s one background thread, which touches no CUDA tensor
and runs no collective. One commit is in flight at a time; a failed one
raises `CheckpointCommitError` at the next barrier (the next save,
`drain`), never dropped. `AdaptiveSaveInterval` is JAX's cadence controller.

The per-process sharded layout is JAX's, name for name: each process
writes its own shard of every tensor (ZeRO-2's moment shards, FSDP's
`DTensor` shards, the replicated rest whole) with its ``[[start, stop],
...]`` bounds in the whole tensor under ``host_{index:04d}/``, ends the
directory with a ``SHARD_DONE`` sentinel, and the main process waits for
every sentinel (a file barrier: the committer thread may run no
collective) before the digest manifest, which carries a ``"sharded"``
block. `load_sharded_accelerator_state` gathers each tensor whole from the
host files, checks that the shards cover it, and the current layout takes
its shard, so a checkpoint written at world 2 loads at world 2 and at 1.
The files are the port's own (`torch.save` of CPU tensors), digested by
the directory's manifest.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import hashlib
import io
import json
import logging
import os
import pickle
import shutil
import tempfile
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .utils.modeling import save_safetensors
from .utils.random import rng_states, set_rng_states

logger = logging.getLogger(__name__)

# File names: the JAX package's constants (`accelerate_tpu/utils/constants.py`).
MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
SCALER_NAME = "scaler"
SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
#: `save_model(safe_serialization=False)`'s file: JAX writes MODEL_NAME's
#: ``model.npz``; the port's is a `torch.save` of the state dict.
WEIGHTS_NAME = MODEL_NAME + ".pt"
CHECKPOINT_MANIFEST_NAME = "MANIFEST.json"
LATEST_POINTER_NAME = "latest"
_STAGING_PREFIX = ".tmp-"
#: The per-process sharded layout (JAX's names): each process writes its
#: shards into ``host_{index:04d}/`` and ends with the ``SHARD_DONE`` sentinel.
SHARD_HOST_PREFIX = "host_"
SHARD_DONE_NAME = "SHARD_DONE"
#: Version of the sampler file's envelope (the JAX package's format 2).
SAMPLER_FORMAT = 2
# A transient I/O error in the commit sequence is retried this many times,
# after 0.1, 0.2, 0.4 s.
_RETRIES = 3
_BACKOFF_SECONDS = 0.1


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed digest verification (torn write, bit rot, truncation)."""


class CheckpointCommitError(RuntimeError):
    """A checkpoint commit failed (or was aborted) after the save was
    accepted. A background commit stores its failure and the next barrier
    (the following save, `drain`, the shutdown flush) raises it: a failed
    asynchronous commit is never dropped."""


# ------------------------------------------------------------------ files
def _fsync_directory(path: str):
    """fsync a directory so that a rename in it survives power loss (best
    effort: some filesystems refuse a directory descriptor)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path, writer: Callable, mode: str = "wb"):
    """Write `path` through ``writer(fileobj)`` into a temp file in the same
    directory, flush, fsync and `os.replace` it into place: a kill at any
    byte leaves the destination absent or its previous complete version."""
    path = str(path)
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=os.path.basename(path) + ".tmp-")
    try:
        with os.fdopen(fd, mode) as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_directory(directory)


def atomic_write_json(path, obj):
    atomic_write(path, lambda f: json.dump(obj, f), mode="w")


def file_sha256(path, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            h.update(chunk)
    return h.hexdigest()


def _sha256_files(paths: List[str]) -> List[str]:
    """Each file's SHA-256, the files hashed in parallel (hashlib releases
    the GIL): a checkpoint's time to verify is its largest file's."""
    if len(paths) < 2:
        return [file_sha256(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
        return list(pool.map(file_sha256, paths))


@contextlib.contextmanager
def _without_zip_crc32():
    """`torch.save` computes each record's zip CRC32 on one core, most of a
    save's time (4x a write without it, measured on the CPU), and
    `torch.load` never checks it: a checkpoint's integrity is its SHA-256
    manifest. torch keeps the setting per thread; it is put back after."""
    get, put = (getattr(torch.serialization, name, None) for name in ("get_crc32_options", "set_crc32_options"))
    if get is None or put is None:
        yield
        return
    before = get()
    put(False)
    try:
        yield
    finally:
        put(before)


def _save_tensors(path, obj):
    with _without_zip_crc32():
        atomic_write(path, lambda f: torch.save(obj, f))


def _load_tensors(path, device=None):
    return torch.load(path, map_location=device, weights_only=True)


# ------------------------------------------------------------------ directories
def write_checkpoint_manifest(directory, step: Optional[int] = None, extra: Optional[dict] = None) -> str:
    """The commit record of a checkpoint directory: every file's SHA-256 in
    `MANIFEST.json` (the host subdirectories' too), written last, so that
    its presence says every file it names was whole on disk first. `extra`
    merges more top-level fields into it (the sharded layout's block)."""
    directory = str(directory)
    rels = []
    for root, dirs, names in os.walk(directory):
        dirs[:] = [d for d in dirs if not d.startswith(_STAGING_PREFIX)]
        for name in names:
            if name in (CHECKPOINT_MANIFEST_NAME, LATEST_POINTER_NAME) or ".tmp-" in name:
                continue
            rels.append(os.path.relpath(os.path.join(root, name), directory))
    files = dict(zip(rels, _sha256_files([os.path.join(directory, rel) for rel in rels])))
    path = os.path.join(directory, CHECKPOINT_MANIFEST_NAME)
    record = {"format": 1, "step": step, "files": files}
    record.update(extra or {})
    atomic_write_json(path, record)
    return path


def verify_checkpoint_dir(directory) -> bool:
    """True when `directory` holds a `MANIFEST.json` and every file it names
    exists with its SHA-256; a directory without one does not verify."""
    try:
        with open(os.path.join(str(directory), CHECKPOINT_MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):  # ValueError: bad JSON, and a flipped byte's bad UTF-8
        return False
    files = manifest.get("files", {})
    try:
        digests = _sha256_files([os.path.join(str(directory), rel) for rel in files])
    except OSError as exc:
        logger.warning("checkpoint %s: missing artifact (%s)", directory, exc)
        return False
    for (rel, digest), actual in zip(files.items(), digests):
        if actual != digest:
            logger.warning("checkpoint %s: digest mismatch on %s", directory, rel)
            return False
    return True


def _rmtree_missing_ok(path: str):
    try:
        shutil.rmtree(path)
    except FileNotFoundError:
        pass


class CheckpointManager:
    """Rotated, digest-verified, atomically published checkpoints under one
    base directory::

        base_dir/
          checkpoint_0/          # committed: has MANIFEST.json
          checkpoint_1/
          latest                 # names the newest committed checkpoint
          .tmp-checkpoint_2/     # a save in progress (or a killed one): ignored

    `save(step, write_fn)` stages, writes the manifest, publishes with one
    `os.replace`, moves the `latest` pointer and rotates to `keep_last_n`;
    transient I/O errors in that sequence retry with backoff. `resolve()`
    re-verifies from the directory listing and never trusts the pointer
    alone, so a stale pointer or a rotted checkpoint never misdirects a
    resume.

    Across processes, each passes `is_main` and `barrier`: every process
    writes its artifacts into the one staging directory, and the main
    process commits."""

    def __init__(self, base_dir, keep_last_n: Optional[int] = None):
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1 (got {keep_last_n})")
        self.base_dir = str(base_dir)
        self.keep_last_n = keep_last_n
        # The steps of saves still in flight: a background commit's
        # checkpoint is not on disk until its publish, and `next_step` must
        # not hand its step out again.
        self._step_lock = threading.Lock()
        self._inflight_steps: set = set()

    def checkpoints(self) -> List[Tuple[int, str]]:
        """(step, path) of every `checkpoint_N` directory, by step."""
        if not os.path.isdir(self.base_dir):
            return []
        out = []
        for name in os.listdir(self.base_dir):
            suffix = name[len("checkpoint_"):]
            if name.startswith("checkpoint_") and suffix.isdigit() and os.path.isdir(os.path.join(self.base_dir, name)):
                out.append((int(suffix), os.path.join(self.base_dir, name)))
        return sorted(out)

    def next_step(self) -> int:
        """The next unused step: past the newest checkpoint on disk and past
        every save of this manager still in flight."""
        with self._step_lock:
            ckpts = self.checkpoints()
            disk_next = ckpts[-1][0] + 1 if ckpts else 0
            inflight_next = max(self._inflight_steps) + 1 if self._inflight_steps else 0
            return max(disk_next, inflight_next)

    def latest_verified(self) -> Optional[str]:
        """The newest checkpoint whose digests verify; torn ones are passed
        over with a warning."""
        for _, path in reversed(self.checkpoints()):
            if verify_checkpoint_dir(path):
                return path
            logger.warning("checkpoint %s failed verification (torn or corrupt); falling back", path)
        return None

    def resolve(self, spec: Optional[str] = None) -> str:
        """``"latest"`` or None: the newest verified checkpoint; a path: that
        checkpoint, verified. Raises FileNotFoundError when there is none and
        CheckpointCorruptError for a named one that does not verify."""
        if spec in (None, "latest"):
            path = self.latest_verified()
            if path is None:
                raise FileNotFoundError(f"no verified checkpoint under {self.base_dir} "
                                        f"({len(self.checkpoints())} candidate(s) present)")
            return path
        spec = str(spec)
        if not os.path.isdir(spec):
            raise FileNotFoundError(f"checkpoint directory {spec} does not exist")
        if not verify_checkpoint_dir(spec):
            raise CheckpointCorruptError(f"checkpoint {spec} failed digest verification")
        return spec

    @staticmethod
    def is_manager_dir(path) -> bool:
        """A base directory (a `latest` pointer or `checkpoint_N` children and
        no manifest of its own), as opposed to one checkpoint."""
        path = str(path)
        if not os.path.isdir(path) or os.path.isfile(os.path.join(path, CHECKPOINT_MANIFEST_NAME)):
            return False
        return os.path.isfile(os.path.join(path, LATEST_POINTER_NAME)) or bool(CheckpointManager(path).checkpoints())

    def clean_staging(self):
        """Remove what a killed save left in staging (never a committed checkpoint)."""
        if os.path.isdir(self.base_dir):
            for name in os.listdir(self.base_dir):
                if name.startswith(_STAGING_PREFIX):
                    shutil.rmtree(os.path.join(self.base_dir, name), ignore_errors=True)

    @staticmethod
    def _retry(fn, what: str):
        for attempt in range(_RETRIES + 1):
            try:
                return fn()
            except OSError as exc:
                if attempt == _RETRIES:
                    raise
                delay = _BACKOFF_SECONDS * 2 ** attempt
                logger.warning("transient I/O error during %s (%s); retry %d/%d in %.2fs",
                               what, exc, attempt + 1, _RETRIES, delay)
                time.sleep(delay)

    @staticmethod
    def _check_abort(abort: Optional[threading.Event], where: str):
        """An aborted background commit stops at the next phase boundary,
        before the publish: a dying process leaves staging litter, never a
        newly visible checkpoint."""
        if abort is not None and abort.is_set():
            raise CheckpointCommitError(f"checkpoint commit aborted before {where}")

    def save(self, step: int, write_fn: Callable[[str], Any], is_main: bool = True,
             barrier: Optional[Callable[[], Any]] = None, abort: Optional[threading.Event] = None,
             manifest_extra: Optional[dict] = None) -> str:
        """Stage, write the manifest, publish, move `latest`, rotate. The
        checkpoint becomes visible only once everything in it, manifest
        included, is on disk. A committed `checkpoint_{step}` that verifies
        is never overwritten; one that does not (a resume fell back past it)
        is replaced. Two saves of one step in flight at once are refused.
        `abort` (set by `AsyncCommitter.abort_and_join`) stops the commit
        before the publish; `manifest_extra` joins the manifest."""
        barrier = barrier or (lambda: None)
        final = os.path.join(self.base_dir, f"checkpoint_{step}")
        with self._step_lock:
            if step in self._inflight_steps:
                raise ValueError(f"checkpoint step {step} already has a save in flight; overlapping saves must "
                                 "use distinct steps (next_step() hands them out)")
            self._inflight_steps.add(step)
        try:
            replace_torn = os.path.exists(final)
            if replace_torn:
                if verify_checkpoint_dir(final):
                    raise ValueError(f"Checkpoint directory {final} already exists; use a different step "
                                     "or a fresh base directory.")
                logger.warning("replacing unverifiable existing checkpoint %s", final)
            staging = os.path.join(self.base_dir, f"{_STAGING_PREFIX}checkpoint_{step}")
            if is_main:
                os.makedirs(self.base_dir, exist_ok=True)
                shutil.rmtree(staging, ignore_errors=True)
                os.makedirs(staging)
            barrier()  # the staging directory exists before any process writes into it
            self._check_abort(abort, "artifact write")
            write_fn(staging)
            barrier()  # every process's artifacts are in before the digest scan
            self._check_abort(abort, "manifest write")
            if is_main:
                self._retry(lambda: write_checkpoint_manifest(staging, step, extra=manifest_extra),
                            "manifest write")
                if replace_torn:
                    self._retry(lambda: _rmtree_missing_ok(final), f"removal of torn {final}")
                self._check_abort(abort, "publish")
                self._retry(lambda: self._publish(staging, final), "checkpoint publish")
                self._rotate(keep=final)
            barrier()
            return final
        finally:
            with self._step_lock:
                self._inflight_steps.discard(step)

    def _publish(self, staging: str, final: str):
        # Idempotent under `_retry`: once the rename (the commit point) has
        # happened, a retry only finishes the pointer.
        if os.path.isdir(staging):
            os.replace(staging, final)
        elif not os.path.isdir(final):
            raise FileNotFoundError(f"checkpoint publish lost both staging ({staging}) and {final}")
        _fsync_directory(self.base_dir)
        atomic_write(os.path.join(self.base_dir, LATEST_POINTER_NAME),
                     lambda f: f.write(os.path.basename(final)), mode="w")

    def _rotate(self, keep: str):
        if self.keep_last_n is None:
            return
        ckpts = self.checkpoints()
        excess = len(ckpts) - self.keep_last_n
        for _, path in ckpts:  # oldest first
            if excess <= 0:
                break
            if os.path.abspath(path) == os.path.abspath(keep):
                continue
            self._retry(lambda p=path: _rmtree_missing_ok(p), f"rotation of {path}")
            excess -= 1


# ------------------------------------------------------------------ training state
def _indexed(name: str, i: int, ext: str) -> str:
    return f"{name}.{ext}" if i == 0 else f"{name}_{i}.{ext}"


def _find_seedable_sampler(dataloader):
    """The `SeedableRandomSampler` behind a prepared loader, if any (through
    a `SkipBatchSampler`)."""
    from .data_loader import SeedableRandomSampler

    base = getattr(dataloader, "base", dataloader)
    batch_sampler = getattr(base, "batch_sampler", None)
    for candidate in (getattr(batch_sampler, "sampler", None),
                      getattr(getattr(batch_sampler, "batch_sampler", None), "sampler", None)):
        if isinstance(candidate, SeedableRandomSampler):
            return candidate
    return None


def _host_side_state(optimizers: list, schedulers: list, dataloaders: list) -> dict:
    """The main process's small files, by name: each optimizer's fp16 loss
    scaler, each scheduler's state, each seedable sampler's envelope."""
    state = {}
    for i, opt in enumerate(optimizers):
        if opt.scaler is not None:
            state[f"{SCALER_NAME}_{i}.json"] = opt.scaler.state_dict()
    for i, sched in enumerate(schedulers):
        state[_indexed(SCHEDULER_NAME, i, "pt")] = sched.state_dict()
    for i, dl in enumerate(dataloaders):
        sampler = _find_seedable_sampler(dl)
        if sampler is not None:
            # The loader's pass counter tells a mid-pass save (replay this
            # epoch's order, then skip) from one at a pass's end (next epoch).
            state[_indexed(SAMPLER_NAME, i, "pt")] = {
                "format": SAMPLER_FORMAT, "sampler": sampler.state_dict(),
                "loader_iteration": getattr(dl, "iteration", None)}
    return state


def collect_accelerator_state(models: list, optimizers: list, schedulers: list, dataloaders: list) -> dict:
    """Everything `write_accelerator_state` writes, by file name: each
    model's whole state dict (the f32 masters), each optimizer's whole state
    and its fp16 loss scaler, each scheduler's step count and learning rate,
    each seedable sampler's epoch with its loader's pass counter, and every
    process's RNG streams. Across processes every process must call it (the
    sharded tensors are gathered; the result matters on the main process);
    the tensors come back on the CPU there, and as the prepared objects
    hold them with one process and no group."""
    from .utils.operations import gather_object

    state = {}
    for i, model in enumerate(models):
        state[_indexed(MODEL_NAME, i, "pt")] = model.full_state_dict()
    for i, opt in enumerate(optimizers):
        state[_indexed(OPTIMIZER_NAME, i, "pt")] = opt.state_dict()
    state.update(_host_side_state(optimizers, schedulers, dataloaders))
    for index, streams in enumerate(gather_object([rng_states()])):
        state[f"{RNG_STATE_NAME}_{index}.pt"] = streams
    return state


def write_accelerator_state(output_dir, state: dict) -> str:
    """Write what `collect_accelerator_state` collected into `output_dir`,
    each file atomically: ``model.pt``, ``optimizer.pt``, ``scaler_0.json``
    (fp16), ``scheduler.pt``, ``sampler.pt`` (format 2), one
    ``random_states_<process>.pt`` per process; a second model, optimizer,
    ... gets ``model_1.pt`` and so on."""
    output_dir = Path(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    for name, obj in state.items():
        if name.endswith(".json"):
            atomic_write_json(output_dir / name, obj)
        else:
            _save_tensors(output_dir / name, obj)
    return str(output_dir)


def save_accelerator_state(output_dir, models: list, optimizers: list, schedulers: list,
                           dataloaders: list) -> str:
    """`collect_accelerator_state`, written into `output_dir` by the main
    process."""
    from .state import PartialState

    state = collect_accelerator_state(models, optimizers, schedulers, dataloaders)
    if PartialState().is_main_process:
        write_accelerator_state(output_dir, state)
    return str(output_dir)


def load_accelerator_state(input_dir, models: list, optimizers: list, schedulers: list, dataloaders: list):
    """Restore what `save_accelerator_state` wrote into the prepared objects:
    weights into each model's own parameters (their dtype and device kept),
    optimizer state onto its parameters' device or into its offload tier.
    Whatever layout wrote the checkpoint, each process takes its shard of
    every tensor under its own layout, and its own RNG streams (process 0's
    where the checkpoint has none for it)."""
    input_dir = Path(input_dir)
    for i, model in enumerate(models):
        host = getattr(model, "layout", None) is not None or getattr(model, "offload_params", False)
        device = "cpu" if host else model.device
        model.load_full_state_dict(_load_tensors(input_dir / _indexed(MODEL_NAME, i, "pt"), device))
    for i, opt in enumerate(optimizers):
        # An offloaded state goes straight to its tier, never whole onto the card.
        host = opt.layout is not None or opt.offload_opt_state
        device = "cpu" if host else next((p.device for p in opt._params()), None)
        opt.load_state_dict(_load_tensors(input_dir / _indexed(OPTIMIZER_NAME, i, "pt"), device))
    _load_host_side_state(input_dir, optimizers, schedulers, dataloaders)


def _load_host_side_state(input_dir: Path, optimizers: list, schedulers: list, dataloaders: list,
                          rng_dir: Optional[Path] = None):
    """Scalers, schedulers, sampler envelopes and this process's RNG
    streams (from `rng_dir`, a host directory of the sharded layout, or
    process 0's where there are none for it)."""
    from .state import PartialState

    for i, opt in enumerate(optimizers):
        scaler_path = input_dir / f"{SCALER_NAME}_{i}.json"
        if opt.scaler is not None and scaler_path.exists():
            with open(scaler_path) as f:
                opt.scaler.load_state_dict(json.load(f))
    for i, sched in enumerate(schedulers):
        path = input_dir / _indexed(SCHEDULER_NAME, i, "pt")
        if path.exists():
            sched.load_state_dict(_load_tensors(path))
    for i, dl in enumerate(dataloaders):
        sampler = _find_seedable_sampler(dl)
        path = input_dir / _indexed(SAMPLER_NAME, i, "pt")
        if sampler is None or not path.exists():
            continue
        payload = _load_tensors(path)
        if payload.get("format") != SAMPLER_FORMAT:
            raise ValueError(f"unsupported sampler checkpoint format {payload.get('format')!r} in {path}")
        sampler.load_state_dict(payload["sampler"])
        # A fresh loader's pass counter of 0 would make its next pass reshuffle
        # with epoch 0: realign it to the saved one.
        if payload.get("loader_iteration") is not None and hasattr(dl, "iteration"):
            dl.iteration = payload["loader_iteration"]
    index = PartialState().process_index
    rng_dir = input_dir if rng_dir is None else Path(rng_dir)
    rng_path = rng_dir / f"{RNG_STATE_NAME}_{index}.pt"
    if not rng_path.exists():
        rng_path = (input_dir if rng_dir == input_dir else input_dir / shard_host_dir(0)) / f"{RNG_STATE_NAME}_0.pt"
    if rng_path.exists():
        set_rng_states(_load_tensors(rng_path))


def save_custom_state(obj, path, index: int = 0):
    """Pickle the `state_dict()` of an object registered for checkpointing."""
    state = obj.state_dict()
    atomic_write(Path(path) / f"custom_checkpoint_{index}.pkl", lambda f: pickle.dump(state, f))


def load_custom_state(obj, path, index: int = 0):
    """The counterpart of `save_custom_state`; a checkpoint without the
    object's file raises rather than leave it at its constructed state."""
    location = Path(path) / f"custom_checkpoint_{index}.pkl"
    if not location.exists():
        raise FileNotFoundError(
            f"Checkpoint has no saved state for registered object {index} ({type(obj).__name__}) at "
            f"{location}; was it registered after the checkpoint was written?"
        )
    with open(location, "rb") as f:
        obj.load_state_dict(pickle.load(f))


# ------------------------------------------------------------------ the sharded layout
def shard_host_dir(process_index: int) -> str:
    return f"{SHARD_HOST_PREFIX}{int(process_index):04d}"


def shard_host_dirs(directory) -> List[str]:
    """The host subdirectories of a sharded checkpoint, sorted."""
    directory = str(directory)
    if not os.path.isdir(directory):
        return []
    return sorted(os.path.join(directory, name) for name in os.listdir(directory)
                  if name.startswith(SHARD_HOST_PREFIX) and name[len(SHARD_HOST_PREFIX):].isdigit()
                  and os.path.isdir(os.path.join(directory, name)))


def is_sharded_checkpoint_dir(directory) -> bool:
    return bool(shard_host_dirs(directory))


def sharded_manifest_extra(num_processes: int) -> dict:
    """The block a sharded checkpoint's MANIFEST.json carries: its hosts."""
    return {"sharded": {"num_hosts": int(num_processes),
                        "hosts": [shard_host_dir(i) for i in range(num_processes)]}}


def wait_for_path(path, timeout_s: float = 600.0, poll_s: float = 0.05, abort: Optional[threading.Event] = None):
    """Poll until `path` exists: the waiting side of a file handshake (a
    collective is not allowed on the committer thread)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(str(path)):
        if abort is not None and abort.is_set():
            raise CheckpointCommitError(f"aborted while waiting for {path}")
        if time.monotonic() >= deadline:
            raise CheckpointCommitError(f"timed out after {timeout_s:.0f}s waiting for {path}")
        time.sleep(poll_s)


def wait_for_shard_hosts(directory, num_hosts: int, timeout_s: float = 600.0, poll_s: float = 0.05,
                         abort: Optional[threading.Event] = None):
    """Block until every host's `SHARD_DONE` exists under
    ``directory/host_*/``: the main process's barrier before the digest
    scan, a file handshake so that it may run on the committer thread."""
    deadline = time.monotonic() + timeout_s
    expected = [os.path.join(str(directory), shard_host_dir(i), SHARD_DONE_NAME) for i in range(num_hosts)]
    while True:
        missing = [p for p in expected if not os.path.isfile(p)]
        if not missing:
            return
        if abort is not None and abort.is_set():
            raise CheckpointCommitError("sharded commit aborted while waiting for host shards")
        if time.monotonic() >= deadline:
            raise CheckpointCommitError(f"timed out after {timeout_s:.0f}s waiting for host shard sentinels: "
                                        f"{[os.path.relpath(p, str(directory)) for p in missing]}")
        time.sleep(poll_s)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def tensor_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor in a tree of dicts, lists and tuples,
    in order; a path joins the keys with "/"."""
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    out = []
    for key, value in items:
        out += tensor_leaves(value, f"{prefix}/{key}" if prefix else str(key))
    return out


def _fill(skeleton, tensors: dict, prefix: str = ""):
    """`skeleton` with the tensor at each path of `tensors` put back."""
    if prefix in tensors:
        return tensors[prefix]
    if isinstance(skeleton, dict):
        return {k: _fill(v, tensors, f"{prefix}/{k}" if prefix else str(k)) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_fill(v, tensors, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(skeleton))
    return skeleton


# ------------------------------------------------------------------ snapshots
class _HostBuffer:
    """A plain host tensor of the exact size, registered with CUDA
    (`cudaHostRegister`) when `pin`, unregistered before it is freed."""

    def __init__(self, shape, dtype: torch.dtype, pin: bool):
        from .utils.offload import _unregister

        self.tensor = torch.empty(tuple(shape), dtype=dtype)
        nbytes = self.tensor.numel() * self.tensor.element_size()
        self.pinned = bool(pin and nbytes)
        if self.pinned:
            rc = torch.cuda.cudart().cudaHostRegister(self.tensor.data_ptr(), nbytes, 0)
            if int(rc) != 0:
                raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed with error {int(rc)}")
            weakref.finalize(self, _unregister, self.tensor)


class HostStaging:
    """The host buffers an asynchronous save copies the state into, kept
    from one save to the next: one commit is in flight at a time, so one
    set is enough, and the first save alone pays for allocating them and,
    for tensors on the card, registering them with CUDA (torch's pinned
    allocator would round each up to a power of two). A buffer is made
    anew only when a tensor's shape or dtype changes. `setup_s` is the
    seconds spent making buffers so far, `nbytes` the bytes held."""

    def __init__(self):
        self._buffers: Dict[Any, _HostBuffer] = {}
        self.setup_s = 0.0

    @property
    def nbytes(self) -> int:
        return sum(b.tensor.numel() * b.tensor.element_size() for b in self._buffers.values())

    def take(self, key, like: torch.Tensor, pin: bool) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.tensor.shape != like.shape or buf.tensor.dtype != like.dtype or buf.pinned < (
                pin and like.numel() > 0):
            t0 = time.perf_counter()
            self._buffers.pop(key, None)
            buf = self._buffers[key] = _HostBuffer(like.shape, like.dtype, pin)
            self.setup_s += time.perf_counter() - t0
        return buf.tensor


class _HostCopy:
    """Copies tensors to host memory for a snapshot. With `staging` each
    goes into its kept buffer, from the card without blocking; `finish`
    waits, on this thread, until every copy has landed. Without it (a save
    written at once) a tensor is moved to the host and kept as it is there,
    cut to its own bytes."""

    def __init__(self, staging: Optional[HostStaging]):
        self.staging = staging
        self.devices = set()

    def __call__(self, key, tensor: torch.Tensor) -> torch.Tensor:
        tensor = tensor.detach()
        if self.staging is None:
            out = tensor.to("cpu")
            if out.untyped_storage().nbytes() != out.numel() * out.element_size():
                out = out.clone()  # a view's whole storage would be written
            return out
        out = self.staging.take(key, tensor, pin=tensor.is_cuda)
        out.copy_(tensor, non_blocking=tensor.is_cuda)
        if tensor.is_cuda:
            self.devices.add(tensor.device)
        return out

    def tree(self, prefix: str, obj):
        """A copy of a tree of dicts, lists and tuples, its tensors copied
        to the host (each keyed by its path under `prefix`, as the sharded
        snapshot keys them, so both reuse one set of buffers) and
        everything else deep-copied."""
        if torch.is_tensor(obj):
            return self(prefix, obj)
        if isinstance(obj, dict):
            return {k: self.tree(f"{prefix}/{k}", v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.tree(f"{prefix}/{i}", v) for i, v in enumerate(obj))
        return copy.deepcopy(obj)

    def finish(self):
        for device in self.devices:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            done.synchronize()


def snapshot_shards(entries, copy_fn: Callable) -> list:
    """This process's shards, copied to the host: ``entries`` are (path,
    this process's tensor, whole shape, ``[[start, stop], ...]``) and each
    result ``{"path", "global_shape", "dtype", "shards": [(bounds,
    tensor)]}`` (JAX's `snapshot_shards` entries)."""
    out = []
    for path, local, global_shape, bounds in entries:
        out.append({"path": path, "global_shape": [int(d) for d in global_shape], "dtype": local.dtype,
                    "shards": [(bounds, copy_fn(path, local))]})
    return out


def shard_payload(snapshot_entries: list, skeleton, process_index: int) -> dict:
    """One host's shard file of one tree (JAX's shard manifest, key for key,
    with the tensors in it): the paths, dtypes, whole shapes and, for each
    path, its shards with their bounds; `skeleton` is the tree without its
    tensors."""
    return {"format": 1, "kind": "shards", "process_index": int(process_index),
            "paths": [e["path"] for e in snapshot_entries],
            "dtypes": [_dtype_name(e["dtype"]) for e in snapshot_entries],
            "global_shapes": [list(e["global_shape"]) for e in snapshot_entries],
            "shards": [[{"bounds": [list(b) for b in bounds], "tensor": t} for bounds, t in e["shards"]]
                       for e in snapshot_entries],
            "skeleton": skeleton}


def save_tensor_shards(payload: dict, path):
    """Write one host's shard file atomically (JAX's `save_pytree_shards`)."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    _save_tensors(path, payload)


def load_tensors_gathered(checkpoint_dir, name: str, num_hosts: Optional[int] = None):
    """Gather on load (JAX's `load_pytree_gathered`): the whole tree `name`
    assembled on the CPU from every ``host_*/<name>`` of a sharded
    checkpoint. A host missing (of `num_hosts`, or of the manifest's
    ``"sharded"`` block), a host's file missing, or a region of a tensor
    no shard covers raises `CheckpointCorruptError`, never zeros."""
    checkpoint_dir = str(checkpoint_dir)
    host_dirs = shard_host_dirs(checkpoint_dir)
    if num_hosts is None:
        try:
            with open(os.path.join(checkpoint_dir, CHECKPOINT_MANIFEST_NAME)) as f:
                num_hosts = json.load(f).get("sharded", {}).get("num_hosts")
        except (OSError, ValueError):
            num_hosts = None
    if not host_dirs:
        raise FileNotFoundError(f"{checkpoint_dir} has no {SHARD_HOST_PREFIX}* shard dirs")
    if num_hosts is not None and [os.path.basename(d) for d in host_dirs] != [shard_host_dir(i) for i in range(num_hosts)]:
        raise CheckpointCorruptError(f"sharded checkpoint {checkpoint_dir} holds hosts "
                                     f"{[os.path.basename(d) for d in host_dirs]} of {num_hosts}")
    reference = None
    leaves: Dict[str, torch.Tensor] = {}
    covered: Dict[str, int] = {}
    seen: Dict[str, set] = {}
    for host_dir in host_dirs:
        path = os.path.join(host_dir, name)
        if not os.path.isfile(path):
            raise CheckpointCorruptError(f"sharded checkpoint {checkpoint_dir} is missing "
                                         f"{os.path.basename(host_dir)}/{name}")
        payload = _load_tensors(path)
        reference = reference or payload
        for i, leaf in enumerate(payload["paths"]):
            if leaf not in leaves:
                leaves[leaf] = torch.zeros(payload["global_shapes"][i], dtype=getattr(torch, payload["dtypes"][i]))
                covered[leaf], seen[leaf] = 0, set()
            for shard in payload["shards"][i]:
                bounds = shard["bounds"]
                leaves[leaf][tuple(slice(a, b) for a, b in bounds)] = shard["tensor"]
                key = tuple(tuple(b) for b in bounds)
                if key not in seen[leaf]:
                    seen[leaf].add(key)
                    size = 1
                    for a, b in bounds:
                        size *= b - a
                    covered[leaf] += size
    for i, leaf in enumerate(reference["paths"]):
        total = 1
        for d in reference["global_shapes"][i]:
            total *= d
        if covered.get(leaf, 0) < total:
            raise CheckpointCorruptError(f"sharded checkpoint {checkpoint_dir}: shards of {leaf!r} cover "
                                         f"{covered.get(leaf, 0)}/{total} elements; a host's shard file is missing")
    return _fill(reference["skeleton"], leaves)


def snapshot_accelerator_state(models: list, optimizers: list, schedulers: list, dataloaders: list,
                               sharded: bool = False, custom_objects: tuple = (),
                               staging: Optional[HostStaging] = None) -> dict:
    """The state as host data, the blocking half of a save whose files are
    written later (JAX's `snapshot_accelerator_state`). With `staging`
    (an asynchronous save) every tensor is copied into its kept buffer and
    this returns once the copies have landed, so training may go on
    changing the live tensors in place while another thread writes the
    copy; host objects are deep-copied.

    Unsharded (one process), the files `write_accelerator_state` writes.
    With `sharded`, this process's shards of each model and optimizer tree
    (`state_shards`: no collective), its RNG streams, and the main
    process's small files."""
    host = _HostCopy(staging)
    snapshot: Dict[str, Any] = {"sharded": bool(sharded)}
    if sharded:
        from .state import PartialState

        host_files = {}
        for i, model in enumerate(models):
            name = _indexed(MODEL_NAME, i, "pt")
            entries = model.state_shards()
            host_files[name] = (snapshot_shards(entries, lambda p, t, n=name: host(f"{n}/{p}", t)),
                                {path: None for path, *_ in entries})
        for i, opt in enumerate(optimizers):
            name = _indexed(OPTIMIZER_NAME, i, "pt")
            skeleton, entries = opt.state_shards()
            host_files[name] = (snapshot_shards(entries, lambda p, t, n=name: host(f"{n}/{p}", t)), skeleton)
        snapshot["process_index"] = PartialState().process_index
        snapshot["host_files"] = host_files
        snapshot["rng"] = rng_states()
        snapshot["files"] = host.tree("host", _host_side_state(optimizers, schedulers, dataloaders))
    else:
        state = collect_accelerator_state(models, optimizers, schedulers, dataloaders)
        snapshot["files"] = {name: host.tree(name, obj) for name, obj in state.items()}
    snapshot["custom"] = [copy.deepcopy(obj.state_dict()) for obj in custom_objects]
    host.finish()
    return snapshot


def write_accelerator_snapshot(snapshot: dict, output_dir, process_index: int = 0, num_processes: int = 1,
                               is_main: bool = True, abort: Optional[threading.Event] = None,
                               shard_barrier_timeout_s: float = 600.0) -> str:
    """Write a `snapshot_accelerator_state` snapshot into `output_dir`: the
    commit half, safe on a background thread (no live objects, no device
    tensors, no collectives). `abort` is checked before each file.

    Unsharded, the files and names `write_accelerator_state` writes, so
    `load_accelerator_state` reads them unchanged. Sharded, this process's
    shard files and RNG streams under ``host_{process_index:04d}/``, ended by
    its ``SHARD_DONE`` (``{"process_index", "files"}``); the main process
    writes the small files and waits for every host's sentinel before it
    returns (a process that is not the main one first waits for the main
    one to make `output_dir`). Registered objects are the main process's."""
    output_dir = Path(output_dir)

    def check_abort(where: str):
        if abort is not None and abort.is_set():
            raise CheckpointCommitError(f"checkpoint commit aborted before {where}")

    if is_main or num_processes == 1:
        os.makedirs(output_dir, exist_ok=True)
    else:
        # The main process clears and makes the staging directory: writing
        # before it exists would be reaped.
        wait_for_path(str(output_dir), timeout_s=shard_barrier_timeout_s, abort=abort)
    host_root = output_dir / shard_host_dir(process_index)
    host_files = []
    if snapshot["sharded"]:
        os.makedirs(host_root, exist_ok=True)
        for name, (entries, skeleton) in snapshot["host_files"].items():
            check_abort(name)
            save_tensor_shards(shard_payload(entries, skeleton, process_index), host_root / name)
            host_files.append(name)
        check_abort("the RNG streams")
        _save_tensors(host_root / f"{RNG_STATE_NAME}_{process_index}.pt", snapshot["rng"])
    if is_main:
        for name, obj in snapshot["files"].items():
            check_abort(name)
            if name.endswith(".json"):
                atomic_write_json(output_dir / name, obj)
            else:
                _save_tensors(output_dir / name, obj)
        for i, state in enumerate(snapshot["custom"]):
            atomic_write(output_dir / f"custom_checkpoint_{i}.pkl", lambda f, s=state: pickle.dump(s, f))
    if snapshot["sharded"]:
        # The host's last file: its presence says every file it names is whole.
        atomic_write_json(host_root / SHARD_DONE_NAME, {"process_index": int(process_index),
                                                        "files": sorted(host_files)})
        if is_main and num_processes > 1:
            check_abort("host shard barrier")
            wait_for_shard_hosts(str(output_dir), num_processes, timeout_s=shard_barrier_timeout_s, abort=abort)
    return str(output_dir)


def load_sharded_accelerator_state(input_dir, models: list, optimizers: list, schedulers: list, dataloaders: list):
    """Restore a sharded checkpoint (the ``host_*/`` layout): each tree
    gathered whole on the host (`load_tensors_gathered`), then each model
    and optimizer takes its shard under the current layout, whatever the
    layout and the number of processes that wrote it; this process's RNG
    streams from its host directory (host 0's where it has none)."""
    from .state import PartialState

    input_dir = Path(input_dir)
    for i, model in enumerate(models):
        model.load_full_state_dict(load_tensors_gathered(input_dir, _indexed(MODEL_NAME, i, "pt")))
    for i, opt in enumerate(optimizers):
        opt.load_state_dict(load_tensors_gathered(input_dir, _indexed(OPTIMIZER_NAME, i, "pt")))
    _load_host_side_state(input_dir, optimizers, schedulers, dataloaders,
                          rng_dir=input_dir / shard_host_dir(PartialState().process_index))


# ------------------------------------------------------------------ the committer
class AsyncCommitter:
    """One background checkpoint commit at a time (JAX's).

    ``submit(fn, label)`` first waits for the previous commit (raising its
    stored failure) and then runs ``fn(abort_event)`` on a daemon thread.
    ``wait()`` joins the commit in flight and raises its failure as
    `CheckpointCommitError` (the cause kept); ``drain()`` is its shutdown
    name. A `BaseException` that is not an `Exception` (a kill, a
    KeyboardInterrupt) means the process is dying: it is raised as itself,
    and ``poll()`` raises only that class, without blocking.
    ``abort_and_join()`` sets the abort event, which `CheckpointManager.save`
    and `write_accelerator_snapshot` check before each step, and joins
    without raising: an aborted commit never publishes."""

    def __init__(self, name: str = "ckpt-committer"):
        self.name = name
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._abort = threading.Event()
        self._label: Optional[str] = None
        self._lock = threading.Lock()

    @property
    def in_flight(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    @property
    def label(self) -> Optional[str]:
        return self._label

    def _raise_pending(self):
        error, self._error = self._error, None
        if error is None:
            return
        if isinstance(error, Exception):
            raise CheckpointCommitError(f"background checkpoint commit failed ({self._label}): {error}") from error
        raise error

    def poll(self):
        """Raise a dead commit's process-death failure now; an ordinary
        failure waits for the next `wait`."""
        if self.in_flight:
            return
        if self._error is not None and not isinstance(self._error, Exception):
            error, self._error = self._error, None
            raise error

    def wait(self, timeout: Optional[float] = None):
        """Wait for the commit in flight; raise its failure, or an earlier one."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                raise CheckpointCommitError(f"background checkpoint commit still running after {timeout}s "
                                            f"({self._label})")
            self._thread = None
        self._raise_pending()

    def drain(self, timeout: Optional[float] = None):
        self.wait(timeout)

    def abort_and_join(self, timeout: float = 30.0) -> Optional[BaseException]:
        """Abort, join, and return (not raise) what the commit died of. The
        committer is done after it: build a fresh one to save again."""
        self._abort.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            self._thread = None
        error, self._error = self._error, None
        return error

    def submit(self, fn: Callable[[threading.Event], Any], label: str = "checkpoint"):
        """Wait for the previous commit (its failure raises here), then run
        ``fn(abort_event)`` in the background."""
        with self._lock:
            self.wait()
            if self._abort.is_set():
                raise CheckpointCommitError("committer was aborted; create a fresh one")
            self._label = label

            def run():
                try:
                    fn(self._abort)
                except BaseException as exc:  # stored, raised at the next barrier
                    self._error = exc
                    logger.warning("background checkpoint commit (%s) failed: %r", label, exc)

            self._thread = threading.Thread(target=run, name=self.name, daemon=True)
            self._thread.start()


# ------------------------------------------------------------------ the save cadence
class AdaptiveSaveInterval:
    """JAX's checkpoint cadence from measured costs: how often to save,
    from a step's wall clock and a save's blocking seconds (for an
    asynchronous save the snapshot and the barrier only, what the goodput
    ledger charges), against a budget of work a crash may lose.

    Both observations are folded into exponential moving averages, and::

        budget_cap     = lost_checkpoint_s / avg_step_s            # at least this often
        overhead_floor = ceil(avg_save_s / (overhead_fraction * avg_step_s))  # at most
        interval = max(clamp(budget_cap, min_interval, max_interval), overhead_floor)

    (the overhead floor wins a conflict, capped at `max_interval`, with one
    warning). A `fixed_interval` is the every-N-steps cadence (the
    observations are still recorded). Pure arithmetic: no clock, no I/O."""

    def __init__(self, lost_checkpoint_s: float = 300.0, overhead_fraction: float = 0.05, min_interval: int = 1,
                 max_interval: int = 100_000, ema: float = 0.3, fixed_interval: Optional[int] = None):
        if lost_checkpoint_s <= 0:
            raise ValueError("lost_checkpoint_s must be > 0")
        if not 0 < overhead_fraction < 1:
            raise ValueError("overhead_fraction must be in (0, 1)")
        if min_interval < 1 or max_interval < min_interval:
            raise ValueError("need 1 <= min_interval <= max_interval")
        if not 0 < ema <= 1:
            raise ValueError("ema must be in (0, 1]")
        if fixed_interval is not None and fixed_interval < 1:
            raise ValueError("fixed_interval must be >= 1")
        self.lost_checkpoint_s = float(lost_checkpoint_s)
        self.overhead_fraction = float(overhead_fraction)
        self.min_interval = int(min_interval)
        self.max_interval = int(max_interval)
        self.ema = float(ema)
        self.fixed_interval = fixed_interval
        self.avg_step_s: Optional[float] = None
        self.avg_save_s: Optional[float] = None
        self.steps_observed = 0
        self.saves_observed = 0
        self._warned_unaffordable = False

    def _fold(self, current: Optional[float], sample: float) -> float:
        sample = max(float(sample), 0.0)
        if current is None:
            return sample
        return (1.0 - self.ema) * current + self.ema * sample

    def observe_step(self, seconds: float):
        self.avg_step_s = self._fold(self.avg_step_s, seconds)
        self.steps_observed += 1

    def observe_save(self, seconds: float):
        self.avg_save_s = self._fold(self.avg_save_s, seconds)
        self.saves_observed += 1

    @property
    def interval(self) -> Optional[int]:
        """Steps between saves under the current measurements; None until a
        step has been observed."""
        if self.fixed_interval is not None:
            return self.fixed_interval
        if self.avg_step_s is None:
            return None
        step_s = max(self.avg_step_s, 1e-9)
        budget_cap = int(self.lost_checkpoint_s / step_s)
        interval = max(self.min_interval, min(budget_cap, self.max_interval))
        if self.avg_save_s is not None and self.avg_save_s > 0:
            overhead_floor = int(-(-self.avg_save_s // (self.overhead_fraction * step_s)))
            if overhead_floor > interval:
                if not self._warned_unaffordable and overhead_floor > budget_cap:
                    self._warned_unaffordable = True
                    logger.warning(
                        "adaptive save interval: a save costs %.3fs against %.4fs steps; holding the lost-work "
                        "budget of %.1fs would spend more than %.0f%% of wall clock on checkpoints; stretching "
                        "the interval to %d steps (exposure %.1fs). Cut the save's cost (async_save, "
                        "sharded_save) or raise lost_checkpoint_s.", self.avg_save_s, step_s,
                        self.lost_checkpoint_s, self.overhead_fraction * 100, overhead_floor,
                        overhead_floor * step_s)
                interval = min(overhead_floor, self.max_interval)
        return interval

    def should_save(self, steps_since_save: int) -> bool:
        interval = self.interval
        return interval is not None and steps_since_save >= interval

    def describe(self) -> dict:
        """The controller's state (host scalars only)."""
        return {"interval": self.interval, "fixed": self.fixed_interval, "avg_step_s": self.avg_step_s,
                "avg_save_s": self.avg_save_s, "steps_observed": self.steps_observed,
                "saves_observed": self.saves_observed, "lost_checkpoint_s": self.lost_checkpoint_s,
                "overhead_fraction": self.overhead_fraction}


# ------------------------------------------------------------------ safetensors export
def parse_size(size) -> int:
    """``"5GB"`` / ``"500MB"`` / ``"2GiB"`` / an int -> bytes (JAX's rule)."""
    if isinstance(size, int):
        return size
    s = str(size).strip().upper()
    for suffix, mult in (("GIB", 2**30), ("MIB", 2**20), ("KIB", 2**10), ("GB", 10**9), ("MB", 10**6), ("KB", 10**3)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)


def flax_order(name: str) -> tuple:
    """The sort key that puts a state dict's names in the order the JAX
    package writes the same model: its params tree flattens with every
    dict's keys sorted, and the port's names are the tree's, a layer's
    index (``layers.3``) standing where the tree has ``layer_3``."""
    parts = []
    for part in name.split("."):
        if part.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    return tuple(parts)


def _model_tensors(model):
    """[(name, tensor, FSDP's shard dim or None)] of a model's state dict in
    the JAX package's order (`flax_order`)."""
    layout = getattr(model, "layout", None)
    module = model.module if hasattr(model, "layout") else model
    fsdp = layout is not None and layout.uses_fsdp
    entries = [(name, value, layout.param_dims.get(name) if fsdp else None)
               for name, value in module.state_dict().items()]
    return sorted(entries, key=lambda e: flax_order(e[0]))


def _atomic_save_safetensors(tensors, target):
    tmp = f"{target}.tmp-{os.getpid()}"
    try:
        save_safetensors(tensors, tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_directory(os.path.dirname(target) or ".")


def save_model_safetensors(model, save_directory: str, max_shard_size="5GB", is_main: bool = True) -> list:
    """Write a model's weights as safetensors (JAX's `save_model_safetensors`).

    The tensors are taken in the JAX package's order (`flax_order`) and cut
    greedily into shards of at most `max_shard_size` bytes (a tensor larger
    than that is a shard alone): one shard is ``model.safetensors``; more
    are ``model-0000i-of-0000n.safetensors`` with
    ``model.safetensors.index.json`` (``{"metadata": {"total_size"},
    "weight_map"}``), written last. Each tensor keeps its dtype and its
    name in the module's state dict. Every process calls it: under FSDP a
    sharded tensor is gathered whole, one at a time, and only the main
    process (`is_main`) writes. Returns the paths written."""
    os.makedirs(save_directory, exist_ok=True)
    budget = parse_size(max_shard_size)
    layout = getattr(model, "layout", None)
    shards, current, current_bytes, total = [], [], 0, 0
    for entry in _model_tensors(model):
        nbytes = entry[1].numel() * entry[1].element_size()
        total += nbytes
        if current and current_bytes + nbytes > budget:
            shards.append(current)
            current, current_bytes = [], 0
        current.append(entry)
        current_bytes += nbytes
    if current:
        shards.append(current)
    written, weight_map = [], {}
    for i, shard in enumerate(shards):
        fname = SAFE_WEIGHTS_NAME if len(shards) == 1 else f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        # Under FSDP each sharded tensor is gathered whole (every process
        # takes part, in the same order); the rest are this process's own.
        tensors = {name: value.detach() if dim is None else layout.gather(value, dim) for name, value, dim in shard}
        if is_main:
            _atomic_save_safetensors(tensors, os.path.join(save_directory, fname))
            written.append(os.path.join(save_directory, fname))
        weight_map.update({name: fname for name, _, _ in shard})
        del tensors
    if is_main and len(shards) > 1:
        index_path = os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME)
        atomic_write(index_path, lambda f: json.dump({"metadata": {"total_size": total}, "weight_map": weight_map},
                                                     f, indent=2), mode="w")
        written.append(index_path)
    return written


def load_model_safetensors(directory: str) -> dict:
    """The state dict `save_model_safetensors` wrote into `directory` (one
    file or the shards its index names), as CPU tensors in their dtypes."""
    from .utils.modeling import load_safetensors_state_dict

    index = os.path.join(directory, SAFE_WEIGHTS_INDEX_NAME)
    if not os.path.exists(index):
        return load_safetensors_state_dict(os.path.join(directory, SAFE_WEIGHTS_NAME))
    with open(index) as f:
        files = sorted(set(json.load(f)["weight_map"].values()))
    out = {}
    for fname in files:
        out.update(load_safetensors_state_dict(os.path.join(directory, fname)))
    return out


# ------------------------------------------------------------------ the native pytree file
# JAX's `save_pytree` / `load_pytree` layout, written and read without jax:
# ``<path>.npz`` holds the leaves as ``arr_{i}`` in the tree's flatten order
# (every dict's keys sorted), compressed, bf16 stored as its uint16 bits;
# ``<path>.manifest.json`` holds each leaf's '/'-joined path and dtype
# (``"bfloat16"`` for the bf16 view), the npz's SHA-256 and the tree's
# structure: the hex of a pickled jax `PyTreeDef`.
#
# That pickle is a plain stream in jax 0.9.0: ``PyTreeDef.__new__`` of the
# global ``jaxlib._jax.pytree.PyTreeDef``, then its state, a pair of the
# global ``jax._src.tree_util.default_registry`` and a list of nodes in
# post-order, each ``(kind, arity, node data, None, leaves, nodes)`` (a
# dict's node data is its sorted keys). The port writes that stream itself
# and reads it with an unpickler that resolves those two names only, so a
# crafted manifest names a global and raises before anything runs: the
# port never calls `pickle.loads` on a manifest.
_BF16_MARKER = "bfloat16"
_TREEDEF_CLASS = ("jaxlib._jax.pytree", "PyTreeDef")
_TREEDEF_REGISTRY = ("jax._src.tree_util", "default_registry")
#: jaxlib's `PyTreeKind` codes for the nodes the port writes and reads.
_LEAF, _NONE, _TUPLE, _LIST, _DICT = 0, 1, 2, 4, 5


def _tree_nodes(tree, prefix: str, paths: list, leaves: list, nodes: list) -> Tuple[int, int]:
    """Flatten `tree` as jax does (dict keys sorted; None a node with no
    leaf), appending leaf paths, leaves and post-order node tuples; returns
    (leaves, nodes) below and at `tree`."""
    if tree is None:
        nodes.append((_NONE, 0, None, None, 0, 1))
        return 0, 1
    if isinstance(tree, dict):
        keys = sorted(tree)
        kind, data, children = _DICT, list(keys), [(str(k), tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        kind, data = (_LIST if isinstance(tree, list) else _TUPLE), None
        children = [(str(i), v) for i, v in enumerate(tree)]
    else:
        paths.append(prefix)
        leaves.append(tree)
        nodes.append((_LEAF, 0, None, None, 1, 1))
        return 1, 1
    n_leaves, n_nodes = 0, 1
    for key, child in children:
        sub = _tree_nodes(child, f"{prefix}/{key}" if prefix else key, paths, leaves, nodes)
        n_leaves, n_nodes = n_leaves + sub[0], n_nodes + sub[1]
    nodes.append((kind, len(children), data, None, n_leaves, n_nodes))
    return n_leaves, n_nodes


def _treedef_pickle(nodes: list) -> bytes:
    """The pickle stream of jax's `PyTreeDef` for `nodes` (protocol 2)."""
    body = pickle.dumps(nodes, protocol=2)[2:-1]  # the list alone: no PROTO, no STOP
    module, name = _TREEDEF_CLASS
    reg_module, reg_name = _TREEDEF_REGISTRY
    return (b"\x80\x02c" + f"{module}\n{name}\n".encode() + b")\x81"  # GLOBAL, EMPTY_TUPLE, NEWOBJ
            + b"c" + f"{reg_module}\n{reg_name}\n".encode() + body  # the state: (registry, nodes)
            + b"\x86b.")  # TUPLE2, BUILD, STOP


class _TreeDefState:
    """What the manifest's pickle builds: its state, nothing else."""

    def __setstate__(self, state):
        self.state = state


_REGISTRY = object()


class _TreeDefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _TREEDEF_CLASS:
            return _TreeDefState
        if (module, name) == _TREEDEF_REGISTRY:
            return _REGISTRY
        raise CheckpointCorruptError(
            f"manifest treedef names the global {module}.{name}; a native pytree file may name only "
            f"{'.'.join(_TREEDEF_CLASS)} and {'.'.join(_TREEDEF_REGISTRY)}")


def _treedef_nodes(hex_stream: str) -> list:
    """The node list of a manifest's treedef, read without running code."""
    obj = _TreeDefUnpickler(io.BytesIO(bytes.fromhex(hex_stream))).load()
    state = getattr(obj, "state", None) if isinstance(obj, _TreeDefState) else None
    if not (isinstance(state, tuple) and len(state) == 2 and state[0] is _REGISTRY and isinstance(state[1], list)):
        raise CheckpointCorruptError("manifest treedef is not a jax PyTreeDef over the default registry")
    return state[1]


def _unflatten(nodes: list, leaves: list):
    stack, it = [], iter(leaves)
    for node in nodes:
        kind, arity, data = node[0], node[1], node[2]
        if kind == _LEAF:
            stack.append(next(it))
            continue
        if kind == _NONE:
            stack.append(None)
            continue
        if arity > len(stack):
            raise CheckpointCorruptError("manifest treedef is malformed (a node has more children than exist)")
        children = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        if kind == _TUPLE:
            stack.append(tuple(children))
        elif kind == _LIST:
            stack.append(list(children))
        elif kind == _DICT and isinstance(data, list) and len(data) == arity:
            stack.append(dict(zip(data, children)))
        else:
            raise CheckpointCorruptError(f"manifest treedef has a node of kind {kind} the port does not read "
                                         "(namedtuple, custom and dataclass nodes)")
    if len(stack) != 1:
        raise CheckpointCorruptError("manifest treedef is malformed (it does not close into one tree)")
    return stack[0]


def _pytree_paths(path: str) -> Tuple[str, str]:
    path = str(path)
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    return base + ".npz", base + ".manifest.json"


def _leaf_array(leaf):
    """A leaf as numpy, and its manifest dtype (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), _BF16_MARKER
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == _BF16_MARKER:  # an ml_dtypes array handed over
        return arr.view(np.uint16), _BF16_MARKER
    return arr, str(arr.dtype)


#: The payload's deflate level. JAX's `np.savez_compressed` deflates at
#: zlib's default (6); level 1 writes the same layout, which `np.load` and
#: JAX's `load_pytree` read alike, about 3x faster, and random bf16 weights
#: compress to 0.80 of their bytes at either level (0.79 at 6).
PYTREE_DEFLATE_LEVEL = 1


def _savez_deflated(f, arrays: Dict[str, np.ndarray]):
    """`np.savez_compressed`'s zip (one deflated ``<name>.npy`` member per
    array) at `PYTREE_DEFLATE_LEVEL`."""
    import zipfile

    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_DEFLATED, allowZip64=True,
                         compresslevel=PYTREE_DEFLATE_LEVEL) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as member:
                np.lib.format.write_array(member, np.asanyarray(arr), allow_pickle=False)


def save_pytree(tree, path: str):
    """Write a tree of tensors or arrays (nested dicts, lists, tuples, None)
    as JAX's native pytree file: `<path>` (.npz) and
    `<path>.manifest.json`, which JAX's `load_pytree` reads. The payload is
    committed first, then the manifest carrying its digest (JAX's order:
    the manifest never describes a payload that is not on disk)."""
    paths, leaves, nodes = [], [], []
    _tree_nodes(tree, "", paths, leaves, nodes)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"arr_{i}"], dtype = _leaf_array(leaf)
        dtypes.append(dtype)
    npz_path, manifest_path = _pytree_paths(path)
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    atomic_write(npz_path, lambda f: _savez_deflated(f, arrays))
    manifest = {"paths": paths, "dtypes": dtypes, "treedef": _treedef_pickle(nodes).hex(),
                "npz_sha256": file_sha256(npz_path)}
    atomic_write_json(manifest_path, manifest)


def load_pytree(path: str, verify: bool = True):
    """The tree `save_pytree` (the port's or JAX's) wrote, its leaves CPU
    tensors (bf16 restored from its bits). With `verify` the payload's
    SHA-256 is checked against the manifest's first: a mismatch (a torn or
    truncated npz, bit rot) raises `CheckpointCorruptError`. Manifests
    without a digest load unverified, as in JAX."""
    npz_path, manifest_path = _pytree_paths(path)
    with open(manifest_path) as f:
        manifest = json.load(f)
    expected = manifest.get("npz_sha256")
    if verify and expected is not None:
        actual = file_sha256(npz_path)
        if actual != expected:
            raise CheckpointCorruptError(
                f"{npz_path}: SHA-256 mismatch (manifest {expected[:12]}…, file {actual[:12]}…) "
                "— torn or corrupted checkpoint artifact")
    nodes = _treedef_nodes(manifest["treedef"])
    dtypes = manifest["dtypes"]

    def read(indices):
        # A zip read by two threads through one handle can see another
        # member's header ("Overlapped entries"): each thread opens its own.
        out = []
        with np.load(npz_path) as data:
            for i in indices:
                arr = data[f"arr_{i}"]
                if not arr.flags.writeable:  # a member read from the zip is a read-only buffer
                    arr = arr.copy()
                if dtypes[i] == _BF16_MARKER:
                    out.append(torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16))
                else:
                    out.append(torch.from_numpy(arr))
        return out

    # The members inflate in threads (zlib releases the GIL), every
    # `threads`-th member in each.
    threads = max(1, min(8, os.cpu_count() or 1, len(dtypes)))
    leaves = [None] * len(dtypes)
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for t, part in enumerate(pool.map(read, [range(t, len(dtypes), threads) for t in range(threads)])):
            leaves[t::threads] = part
    return _unflatten(nodes, leaves)
