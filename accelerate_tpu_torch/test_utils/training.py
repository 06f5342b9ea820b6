"""Toy training fixtures (the port of `accelerate_tpu/test_utils/training.py`):
the ``y = a x + b`` regression every launched correctness script trains.

`RegressionDataset` is JAX's, drawn from the same numpy seed, so both
packages train on the same numbers. `RegressionModel` and
`RegressionMLPModel` are `nn.Module`s with JAX's initial values (the MLP's
drawn from JAX's numpy stream in JAX's order), each carrying
`regression_loss` as its bundled loss; `regression_state_dict_from_flax`
carries a JAX bundle's params into either."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.losses import global_mean


class RegressionDataset:
    """y = a*x + b with small noise, from numpy `seed` (JAX's draws)."""

    def __init__(self, a=2, b=3, length=64, seed=0):
        rng = np.random.default_rng(seed)
        self.length = length
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (a * self.x + b + 0.1 * rng.normal(size=(length,))).astype(np.float32)

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return {"x": self.x[i : i + 1], "y": self.y[i]}


def regression_loss(batch, apply_fn):
    """The mean squared error over the global batch (``global_mean``: the
    same value on every process, as JAX's over its global arrays)."""
    pred = apply_fn(batch["x"])
    return global_mean((pred[:, 0] - batch["y"]) ** 2)


class RegressionModel(nn.Module):
    """``x * a + b`` with one-element parameters `a` and `b`, initialized at
    the given values so that every process starts alike without a seed."""

    def __init__(self, a=0.0, b=0.0):
        super().__init__()
        self.a = nn.Parameter(torch.tensor([float(a)]))
        self.b = nn.Parameter(torch.tensor([float(b)]))
        self.loss_fn = regression_loss

    def forward(self, x):
        return x * self.a + self.b


class RegressionMLPModel(nn.Module):
    """The same regression through a ReLU MLP of width `hidden`, its
    weights JAX's draws from numpy `seed` (scale 0.1, in JAX's order)."""

    def __init__(self, hidden=64, seed=0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.dense_in, self.dense_mid, self.dense_out = nn.Linear(1, hidden), nn.Linear(hidden, hidden), nn.Linear(hidden, 1)
        with torch.no_grad():
            for layer in (self.dense_in, self.dense_mid, self.dense_out):
                kernel = rng.normal(scale=0.1, size=(layer.in_features, layer.out_features)).astype(np.float32)
                bias = rng.normal(scale=0.1, size=(layer.out_features,)).astype(np.float32)
                layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
                layer.bias.copy_(torch.from_numpy(bias))
        self.loss_fn = regression_loss

    def forward(self, x):
        h = torch.relu(self.dense_in(x))
        h = torch.relu(self.dense_mid(h))
        return self.dense_out(h)


def regression_state_dict_from_flax(params) -> dict:
    """A JAX regression bundle's params as the port's state dict:
    ``{"a", "b"}`` as they are; each ``{"kernel", "bias"}`` layer as
    ``<layer>.weight`` (the kernel transposed) and ``<layer>.bias``."""
    out = {}
    for name, value in params.items():
        if isinstance(value, dict):
            out[f"{name}.weight"] = torch.from_numpy(np.asarray(value["kernel"], np.float32).T.copy())
            out[f"{name}.bias"] = torch.from_numpy(np.asarray(value["bias"], np.float32).copy())
        else:
            out[name] = torch.from_numpy(np.asarray(value, np.float32).copy())
    return out
