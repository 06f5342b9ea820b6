"""rich's traceback handler, installed on import when the `rich` package is
there (the port of `accelerate_tpu/utils/rich.py`); without it the import
raises."""

from .imports import is_rich_available

if is_rich_available():
    from rich.traceback import install

    install(show_locals=False)
else:
    raise ModuleNotFoundError("To use the rich extension, install rich with `pip install rich`")
