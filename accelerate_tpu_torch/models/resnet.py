"""ResNet (v1.5 bottleneck): the port of `accelerate_tpu/models/resnet.py`,
the model of the reference's image-classification example.

The forward takes JAX's NHWC `pixel_values` [B, H, W, C] and returns [B,
classes] logits. Inside, the convolutions are torch's NCHW ones on
channels-last tensors: the permuted input already is one, and
`create_resnet_model` stores the conv weights channels-last, so cuDNN runs
NHWC kernels and nothing is transposed.

JAX's semantics, kept:
  - `Conv` is flax's ``nn.Conv`` without bias: ``"SAME"`` padding puts the
    odd pixel of a padding after the image, so the 3x3 stride-2 conv of a
    block pads (0, 1) on an even input, not torch's symmetric 1; the stem
    pads (3, 3) explicitly; `max_pool` pads (1, 1) with -inf.
  - `BatchNorm` always normalises with the running statistics: JAX's
    `apply_fn` runs the model with ``train=False``, and the loss stops their
    gradient, so training never moves them. Under bf16 mixed precision the
    prepared model's forward casts them with the parameters, as JAX's
    `_cast_floating` casts `batch_stats`; `num_batches_tracked` is an
    integer and stays as it is.
  - The classifier is a `Dense` (flax's ``nn.Dense``), so it runs in fp8
    under ``mixed_precision="fp8"``; the convolutions stay in bf16.

JAX's `MODEL_REGISTRY` has no ResNet entry, so neither does the port's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, make_generator, resolve_device
from ..ops.losses import global_mean
from .decoder import Dense

# The std of a standard normal truncated to [-2, 2], which flax's
# lecun_normal divides out.
_TRUNCATED_STD = 0.87962566103423978


@dataclass
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    num_channels: int = 3


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``"SAME"``: ceil(size / stride) outputs, the extra pixel after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax's ``nn.Conv(use_bias=False)``: ``"SAME"`` padding computed from
    the input's size, or `padding` given as ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1, padding=None):
        super().__init__(in_channels, out_channels, kernel, stride, bias=False)
        self.explicit_padding = padding

    def forward(self, x):
        (top, bottom), (left, right) = self.explicit_padding or [
            _same_padding(n, k, s) for n, k, s in zip(x.shape[2:], self.kernel_size, self.stride)
        ]
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, None, self.stride, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, None, self.stride)


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm(use_running_average=True)`` (epsilon 1e-5): the
    running statistics, whatever `training` says."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, stride)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(features, features * 4, 1)
        self.bn3 = BatchNorm(features * 4)
        # JAX projects the residual when its shape differs from the output's.
        self.downsample = in_channels != features * 4 or stride != 1
        if self.downsample:
            self.downsample_conv = Conv(in_channels, features * 4, 1, stride)
            self.downsample_bn = BatchNorm(features * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(y + residual)


def image_classification_loss(batch, apply_fn):
    """Cross-entropy of ``apply_fn(pixel_values)`` against `labels`, in f32.
    BatchNorm reads buffers, which take no gradient (JAX stops it), so the
    optimizer never moves them."""
    logits = apply_fn(batch["pixel_values"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return global_mean(-logp.gather(-1, batch["labels"].long()[:, None])[:, 0])


class ResNet(nn.Module):
    """ResNet over NHWC `pixel_values`; modules named as the flax tree
    (``stem_conv``, ``stage{i}_block{j}.conv1``, ``classifier``)."""

    loss_fn = staticmethod(image_classification_loss)

    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.config = cfg = config
        self.stem_conv = Conv(cfg.num_channels, cfg.width, 7, 2, padding=((3, 3), (3, 3)))
        self.stem_bn = BatchNorm(cfg.width)
        self.block_names = []
        channels = cfg.width
        for i, size in enumerate(cfg.stage_sizes):
            for j in range(size):
                name = f"stage{i}_block{j}"
                features = cfg.width * 2 ** i
                self.add_module(name, BottleneckBlock(channels, features, 2 if i > 0 and j == 0 else 1))
                self.block_names.append(name)
                channels = features * 4
        self.classifier = Dense(channels, cfg.num_classes)

    def forward(self, pixel_values):
        x = pixel_values.permute(0, 3, 1, 2)  # NCHW indexing over the NHWC (channels-last) storage
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.classifier(x.mean(dim=(2, 3)))


@torch.no_grad()
def create_resnet_model(
    config: Optional[ResNetConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> ResNet:
    """A ResNet with random weights drawn from `seed` on `device` (``cuda``
    unless the caller passes ``device="cpu"``), in flax's distributions:
    conv and classifier weights lecun-normal (truncated at two standard
    deviations, variance 1 / fan_in), biases zero, BatchNorm scales one and
    biases zero over running means 0 and variances 1. Conv weights are
    stored channels-last."""
    dev = resolve_device(device)
    config = config or ResNetConfig()
    with torch.device("meta"):
        model = ResNet(config)
    model = model.to_empty(device=dev)
    gen = make_generator(seed, dev)
    for module in model.modules():
        if isinstance(module, (Conv, Dense)):
            fan_in = module.weight[0].numel()
            std = fan_in ** -0.5 / _TRUNCATED_STD
            nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.reset_parameters()
    return model.to(dtype).to(memory_format=torch.channels_last).eval()


def resnet_state_dict_from_flax(variables, config: ResNetConfig):
    """The port's `state_dict` from a JAX ResNet's variables as numpy arrays
    (``{"params": ..., "batch_stats": ...}``): conv kernels [kh, kw, in, out]
    to [out, in, kh, kw], BatchNorm ``scale``/``bias`` from `params` and
    ``mean``/``var`` from `batch_stats`, the classifier's kernel transposed."""
    params, stats = variables["params"], variables["batch_stats"]

    def t(x):
        return torch.from_numpy(np.array(x))

    sd = {}

    def walk(p, s, prefix):
        for name, node in p.items():
            key = f"{prefix}{name}."
            if name == "classifier":
                sd.update({key + "weight": t(node["kernel"]).T.contiguous(), key + "bias": t(node["bias"])})
            elif "kernel" in node:
                sd[key + "weight"] = t(node["kernel"]).permute(3, 2, 0, 1).contiguous()
            elif "scale" in node:
                sd.update({key + "weight": t(node["scale"]), key + "bias": t(node["bias"]),
                           key + "running_mean": t(s[name]["mean"]), key + "running_var": t(s[name]["var"]),
                           key + "num_batches_tracked": torch.tensor(0)})
            else:
                walk(node, s.get(name, {}), key)

    walk(params, stats, "")
    n_blocks = sum(k.startswith("stage") for k in params)
    if n_blocks != sum(config.stage_sizes):
        raise ValueError(f"variables hold {n_blocks} blocks, the config {sum(config.stage_sizes)}")
    return sd


def resnet50(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), num_classes=num_classes)


def resnet18_ish(num_classes: int = 1000) -> ResNetConfig:
    """Shallow bottleneck variant for quicker runs."""
    return ResNetConfig(stage_sizes=(2, 2, 2, 2), num_classes=num_classes)


def resnet_tiny(num_classes: int = 4) -> ResNetConfig:
    """Test-size config."""
    return ResNetConfig(stage_sizes=(1, 1), num_classes=num_classes, width=8)
