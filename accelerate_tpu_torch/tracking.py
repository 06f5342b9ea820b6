"""Experiment trackers: the offline part of `accelerate_tpu/tracking.py`.

A `GeneralTracker` base, the JSONL and CSV trackers, which need no other
package, and `filter_trackers`, which resolves `Accelerator(log_with=...)`.
As in the JAX package, a tracker's constructor, `store_init_configuration`
and `log` run on the main process only (`on_main_process`): across
processes only process 0 writes. The JAX package's other
integrations (TensorBoard, W&B, MLflow, Comet, Aim, ClearML, DVCLive) are
not ported yet: asking for one raises.
"""

from __future__ import annotations

import csv
import functools
import json
import os
import time
from typing import List, Optional

from .state import PartialState


def on_main_process(function):
    """Run a tracker method on the main process only (unless the tracker's
    `main_process_only` is False); elsewhere it returns None."""

    @functools.wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True) and not PartialState().is_main_process:
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


def _scalar(v):
    return float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v


class GeneralTracker:
    """Base tracker protocol. Subclass with `name`,
    `requires_logging_directory`, `store_init_configuration` and `log`."""

    main_process_only = True

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def requires_logging_directory(self) -> bool:
        raise NotImplementedError

    @property
    def tracker(self):
        return None

    def store_init_configuration(self, values: dict):
        pass

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        pass

    def finish(self):
        pass


class JSONTracker(GeneralTracker):
    """One ``{"step": .., "time": .., **values}`` object per line of
    ``{logging_dir}/{run_name}/metrics.jsonl``; the configuration in
    ``config.json`` beside it."""

    name = "json"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        self.run_name = run_name
        self.dir = os.path.join(logging_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self._config_path = os.path.join(self.dir, "config.json")

    @property
    def tracker(self):
        return getattr(self, "path", None)

    @on_main_process
    def store_init_configuration(self, values: dict):
        with open(self._config_path, "w") as f:
            json.dump(values, f, indent=2, default=str)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        record = {"step": step, "time": time.time()}
        record.update({k: _scalar(v) for k, v in values.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")


class CSVTracker(GeneralTracker):
    """``{logging_dir}/{run_name}/metrics.csv``, one row per `log`; the
    columns grow (the file is rewritten) as new metric keys appear."""

    name = "csv"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        self.run_name = run_name
        self.dir = os.path.join(logging_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._fieldnames: List[str] = []

    @property
    def tracker(self):
        return getattr(self, "path", None)

    @on_main_process
    def store_init_configuration(self, values: dict):
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(values, f, indent=2, default=str)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        row = {"step": step}
        row.update({k: _scalar(v) for k, v in values.items()})
        new_fields = [k for k in row if k not in self._fieldnames]
        if new_fields:
            self._fieldnames += new_fields
            rows = []
            if os.path.exists(self.path):
                with open(self.path) as f:
                    rows = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                writer.writeheader()
                for r in rows:
                    writer.writerow(r)
                writer.writerow(row)
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)


LOGGER_TYPE_TO_CLASS = {"json": JSONTracker, "csv": CSVTracker}


def filter_trackers(log_with, logging_dir: Optional[str] = None) -> list:
    """The trackers `log_with` selects: names (``"all"`` for every ported
    one) and `GeneralTracker` instances, as the JAX package resolves them."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    loggers = []
    for log_type in log_with:
        if isinstance(log_type, GeneralTracker):
            loggers.append(log_type)
            continue
        log_type = str(log_type)
        if log_type == "all":
            loggers += list(LOGGER_TYPE_TO_CLASS)
            continue
        if log_type not in LOGGER_TYPE_TO_CLASS:
            raise ValueError(f"Unknown tracker {log_type!r}; choose from {sorted(LOGGER_TYPE_TO_CLASS)}")
        if LOGGER_TYPE_TO_CLASS[log_type].requires_logging_directory and logging_dir is None:
            raise ValueError(f"Tracker {log_type} requires a logging_dir/project_dir")
        loggers.append(log_type)
    return loggers
