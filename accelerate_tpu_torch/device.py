"""Device resolution for the port's entry points.

The card is the default: an entry point runs on ``cuda`` unless its caller
asks for the CPU (``device="cpu"``), as the tests do. With no GPU and no
explicit CPU request it raises instead of quietly running somewhere slower.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); an explicit device is
    returned as given, after checking that a requested CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "accelerate_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def make_generator(seed: int, device: Optional[torch.device] = None) -> torch.Generator:
    """An explicit, seeded `torch.Generator` on `device` (the port never draws
    from the global RNG)."""
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int(seed))
    return gen
