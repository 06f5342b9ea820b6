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

Reading a JAX package's checkpoint is not supported: its tensors are
`.npz` pytrees, these are `torch.save` files.

`save_model_safetensors` writes just a model's weights for
`Accelerator.save_model`: safetensors through the port's own writer
(`utils/modeling.py`), split at a size into shards with an HF-style index,
each file committed atomically and the index last, as JAX's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

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
#: Version of the sampler file's envelope (the JAX package's format 2).
SAMPLER_FORMAT = 2
# A transient I/O error in the commit sequence is retried this many times,
# after 0.1, 0.2, 0.4 s.
_RETRIES = 3
_BACKOFF_SECONDS = 0.1


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed digest verification (torn write, bit rot, truncation)."""


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


def _save_tensors(path, obj):
    atomic_write(path, lambda f: torch.save(obj, f))


def _load_tensors(path, device=None):
    return torch.load(path, map_location=device, weights_only=True)


# ------------------------------------------------------------------ directories
def write_checkpoint_manifest(directory, step: Optional[int] = None) -> str:
    """The commit record of a checkpoint directory: every file's SHA-256 in
    `MANIFEST.json`, written last, so that its presence says every file it
    names was whole on disk first."""
    directory = str(directory)
    files = {}
    for root, dirs, names in os.walk(directory):
        dirs[:] = [d for d in dirs if not d.startswith(_STAGING_PREFIX)]
        for name in names:
            if name in (CHECKPOINT_MANIFEST_NAME, LATEST_POINTER_NAME) or ".tmp-" in name:
                continue
            rel = os.path.relpath(os.path.join(root, name), directory)
            files[rel] = file_sha256(os.path.join(directory, rel))
    path = os.path.join(directory, CHECKPOINT_MANIFEST_NAME)
    atomic_write_json(path, {"format": 1, "step": step, "files": files})
    return path


def verify_checkpoint_dir(directory) -> bool:
    """True when `directory` holds a `MANIFEST.json` and every file it names
    exists with its SHA-256; a directory without one does not verify."""
    try:
        with open(os.path.join(str(directory), CHECKPOINT_MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):  # ValueError: bad JSON, and a flipped byte's bad UTF-8
        return False
    for rel, digest in manifest.get("files", {}).items():
        try:
            if file_sha256(os.path.join(str(directory), rel)) != digest:
                logger.warning("checkpoint %s: digest mismatch on %s", directory, rel)
                return False
        except OSError:
            logger.warning("checkpoint %s: missing artifact %s", directory, rel)
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
    resume."""

    def __init__(self, base_dir, keep_last_n: Optional[int] = None):
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1 (got {keep_last_n})")
        self.base_dir = str(base_dir)
        self.keep_last_n = keep_last_n

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

    def save(self, step: int, write_fn: Callable[[str], Any]) -> str:
        """Stage, write the manifest, publish, move `latest`, rotate. The
        checkpoint becomes visible only once everything in it, manifest
        included, is on disk. A committed `checkpoint_{step}` that verifies
        is never overwritten; one that does not (a resume fell back past it)
        is replaced."""
        final = os.path.join(self.base_dir, f"checkpoint_{step}")
        replace_torn = os.path.exists(final)
        if replace_torn:
            if verify_checkpoint_dir(final):
                raise ValueError(f"Checkpoint directory {final} already exists; use a different step "
                                 "or a fresh base directory.")
            logger.warning("replacing unverifiable existing checkpoint %s", final)
        staging = os.path.join(self.base_dir, f"{_STAGING_PREFIX}checkpoint_{step}")
        os.makedirs(self.base_dir, exist_ok=True)
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        write_fn(staging)
        self._retry(lambda: write_checkpoint_manifest(staging, step), "manifest write")
        if replace_torn:
            self._retry(lambda: _rmtree_missing_ok(final), f"removal of torn {final}")
        self._retry(lambda: self._publish(staging, final), "checkpoint publish")
        self._rotate(keep=final)
        return final

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
    optimizer state onto its parameters' device. Whatever layout wrote the
    checkpoint, each process takes its shard of every tensor under its own
    layout, and its own RNG streams (process 0's where the checkpoint has
    none for it)."""
    from .state import PartialState

    input_dir = Path(input_dir)
    for i, model in enumerate(models):
        device = "cpu" if getattr(model, "layout", None) is not None else model.device
        model.load_full_state_dict(_load_tensors(input_dir / _indexed(MODEL_NAME, i, "pt"), device))
    for i, opt in enumerate(optimizers):
        device = "cpu" if opt.layout is not None else next((p.device for p in opt._params()), None)
        opt.load_state_dict(_load_tensors(input_dir / _indexed(OPTIMIZER_NAME, i, "pt"), device))
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
    rng_path = input_dir / f"{RNG_STATE_NAME}_{PartialState().process_index}.pt"
    if not rng_path.exists():
        rng_path = input_dir / f"{RNG_STATE_NAME}_0.pt"
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
