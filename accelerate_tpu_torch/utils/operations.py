"""Moving batches to the device (the part of
`accelerate_tpu/utils/operations.py` one process needs)."""

from __future__ import annotations

import numpy as np
import torch


def send_to_device(batch, device):
    """`batch` with every tensor and numpy array moved to `device` as a
    tensor, through nested dicts, lists and tuples; other leaves as given."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(batch).to(device)
    if isinstance(batch, dict):
        return {k: send_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(send_to_device(v, device) for v in batch)
    return batch
