"""A tqdm that draws on the main process only (the port of
`accelerate_tpu/utils/tqdm.py`); it needs the `tqdm` package."""

from .imports import is_tqdm_available


def tqdm(*args, main_process_only: bool = True, **kwargs):
    """`tqdm.tqdm(*args, **kwargs)`, disabled on every process but each
    node's local main one unless `main_process_only` is False."""
    if not is_tqdm_available():
        raise ImportError("tqdm is required for `accelerate_tpu_torch.utils.tqdm`")
    import tqdm as _tqdm

    from ..state import PartialState

    disable = kwargs.pop("disable", False)
    if main_process_only and not disable:
        disable = PartialState().local_process_index != 0
    return _tqdm.tqdm(*args, disable=disable, **kwargs)
