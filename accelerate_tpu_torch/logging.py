"""Logging that knows the processes (the port of `accelerate_tpu/logging.py`).

`get_logger(__name__)` returns a `MultiProcessAdapter`, whose log methods
take ``main_process_only=`` (True by default: only process 0 writes) and
``in_order=`` (every process writes, one after another, with a barrier
between turns), so N processes do not print N copies of a line. The level
comes from ``ACCELERATE_TPU_LOG_LEVEL`` unless given, and
``ACCELERATE_TPU_DISABLE_LOGGING=true`` silences the adapter, as in JAX.
"""

from __future__ import annotations

import functools
import logging
import os


class MultiProcessAdapter(logging.LoggerAdapter):
    """A `LoggerAdapter` that logs on the main process only, unless told
    ``main_process_only=False`` (with ``in_order=True``: on every process,
    in process order)."""

    @staticmethod
    def _should_log(main_process_only):
        from .state import PartialState

        return not main_process_only or PartialState().is_main_process

    def log(self, level, msg, *args, **kwargs):
        if os.environ.get("ACCELERATE_TPU_DISABLE_LOGGING", "false").lower() == "true":
            return
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 2)

        if self.isEnabledFor(level):
            if self._should_log(main_process_only):
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, msg, *args, **kwargs)
            elif in_order:
                from .state import PartialState

                state = PartialState()
                for i in range(state.num_processes):
                    if i == state.process_index:
                        msg, kwargs = self.process(msg, kwargs)
                        self.logger.log(level, msg, *args, **kwargs)
                    state.wait_for_everyone()

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        """A warning logged once for each distinct message."""
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """A `MultiProcessAdapter` over ``logging.getLogger(name)``, at
    `log_level` or ``ACCELERATE_TPU_LOG_LEVEL`` (which also set the root
    logger's level), else as configured."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_TPU_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
