"""Experiment trackers (the port of `accelerate_tpu/tracking.py`).

A `GeneralTracker` base, the JSONL and CSV trackers, which need no other
package, TensorBoard (through `torch.utils.tensorboard`, or tensorboardX),
and W&B, MLflow, Comet, Aim, ClearML and DVCLive, each used only when its
package is installed; `filter_trackers` resolves `Accelerator(log_with=...)`
as JAX's does: ``"all"`` is every tracker whose package is there, and a
named one whose package is missing is skipped with a warning. As in the JAX
package, a tracker's constructor, `store_init_configuration`, `log` and
`finish` run on the main process only (`on_main_process`): across
processes only process 0 writes.
"""

from __future__ import annotations

import csv
import functools
import json
import os
import time
from typing import List, Optional

from .logging import get_logger
from .state import PartialState
from .utils.imports import (
    is_aim_available,
    is_clearml_available,
    is_comet_ml_available,
    is_dvclive_available,
    is_mlflow_available,
    is_tensorboard_available,
    is_wandb_available,
)

logger = get_logger(__name__)


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


class TensorBoardTracker(GeneralTracker):
    """TensorBoard: scalars, text (a `str` value) and scalar groups (a
    `dict`) under ``{logging_dir}/{run_name}``, the configuration as
    hparams, through `torch.utils.tensorboard` or else tensorboardX."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(
            {k: v for k, v in values.items() if isinstance(v, (int, float, str, bool))}, metric_dict={}
        )
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            if isinstance(v, str):
                self.writer.add_text(k, v, global_step=step)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, v, global_step=step)
            else:
                self.writer.add_scalar(k, float(v), global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


class WandBTracker(GeneralTracker):
    """Weights & Biases; needs `wandb`."""

    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        import wandb

        self.run = wandb.init(project=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.run.finish()


class MLflowTracker(GeneralTracker):
    """MLflow; needs `mlflow`."""

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        import mlflow

        self.run = mlflow.start_run(run_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for name, value in values.items():
            mlflow.log_param(name, value)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        metrics = {k: float(v) for k, v in values.items() if isinstance(v, (int, float)) or hasattr(v, "item")}
        mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class CometMLTracker(GeneralTracker):
    """Comet ML; needs `comet_ml`."""

    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        from comet_ml import Experiment

        self.run_name = run_name
        self.writer = Experiment(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.writer.set_step(step)
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.writer.log_metric(k, v, step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.log_other(k, v)
            elif isinstance(v, dict):
                self.writer.log_metrics(v, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.end()


class AimTracker(GeneralTracker):
    """Aim; needs `aim`."""

    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = ".", **kwargs):
        from aim import Run

        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.close()


class ClearMLTracker(GeneralTracker):
    """ClearML; needs `clearml`."""

    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, **kwargs):
        from clearml import Task

        self.task = Task.init(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            if isinstance(v, (int, float)):
                if step is None:
                    clearml_logger.report_single_value(name=k, value=v, **kwargs)
                else:
                    title, _, series = k.partition("/")
                    clearml_logger.report_scalar(
                        title=title, series=series or title, value=v, iteration=step, **kwargs
                    )

    @on_main_process
    def finish(self):
        self.task.close()


class DVCLiveTracker(GeneralTracker):
    """DVCLive; needs `dvclive`."""

    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, live=None, **kwargs):
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            self.live.log_metric(k, v, **kwargs)
        self.live.next_step()

    @on_main_process
    def finish(self):
        self.live.end()


LOGGER_TYPE_TO_CLASS = {
    "json": JSONTracker,
    "csv": CSVTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "mlflow": MLflowTracker,
    "comet_ml": CometMLTracker,
    "aim": AimTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
}

_AVAILABILITY = {
    "json": lambda: True,
    "csv": lambda: True,
    "tensorboard": is_tensorboard_available,
    "wandb": is_wandb_available,
    "mlflow": is_mlflow_available,
    "comet_ml": is_comet_ml_available,
    "aim": is_aim_available,
    "clearml": is_clearml_available,
    "dvclive": is_dvclive_available,
}


def filter_trackers(log_with, logging_dir: Optional[str] = None) -> list:
    """The trackers `log_with` selects: names (``"all"`` for every one whose
    package is installed) and `GeneralTracker` instances, as the JAX
    package resolves them. A named tracker whose package is missing is
    skipped with a warning; one that needs a logging directory raises
    without it."""
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
            loggers += [name for name, probe in _AVAILABILITY.items() if probe()]
            continue
        if log_type not in LOGGER_TYPE_TO_CLASS:
            raise ValueError(f"Unknown tracker {log_type!r}; choose from {sorted(LOGGER_TYPE_TO_CLASS)}")
        if not _AVAILABILITY[log_type]():
            logger.warning("Tracker %s requested but its package is not installed; skipping.", log_type)
            continue
        if LOGGER_TYPE_TO_CLASS[log_type].requires_logging_directory and logging_dir is None:
            raise ValueError(f"Tracker {log_type} requires a logging_dir/project_dir")
        loggers.append(log_type)
    return loggers
