"""The port's twin of `examples/by_feature/deepspeed_with_config_support.py`:
train from a DeepSpeed-style ds_config. `DeepSpeedPlugin` is JAX's
compatibility shim: the ZeRO stage lowers to an FSDP strategy, and an
optimizer offload to "cpu" or "nvme" to the pinned host or the disk tier
(`optimizer.py`), so a ds_config written for DeepSpeed trains here with no
DeepSpeed runtime. As in JAX, the config's accumulation count is printed,
and its clipping applied. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.deepspeed_with_config_support
    python -m accelerate_tpu_torch.examples.by_feature.deepspeed_with_config_support --cpu --mixed_precision no
    python -m accelerate_tpu_torch.examples.by_feature.deepspeed_with_config_support --ds_config ds_config.json
"""

import argparse
import json

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model
from accelerate_tpu_torch.utils import DeepSpeedPlugin

DEFAULT_DS_CONFIG = {
    "train_micro_batch_size_per_gpu": 16,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "zero_optimization": {
        "stage": 2,
        "offload_optimizer": {"device": "none"},
    },
    "bf16": {"enabled": True},
}


def training_function(args):
    """Returns the last step's loss of each epoch."""
    if args.ds_config:
        with open(args.ds_config) as f:
            ds_config = json.load(f)
    else:
        ds_config = DEFAULT_DS_CONFIG
    plugin = DeepSpeedPlugin(hf_ds_config=ds_config)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, deepspeed_plugin=plugin, cpu=args.cpu)
    accelerator.print(
        f"ds_config: zero_stage={plugin.zero_stage} -> "
        f"{accelerator.state.fsdp_plugin.sharding_strategy}, "
        f"accumulation={plugin.gradient_accumulation_steps}"
    )
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    data = get_dataset(config.vocab_size - 1, n=args.train_size, seed=0)
    sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
    train_dl = SimpleDataLoader(data, BatchSampler(sampler, args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)

    losses = []
    for epoch in range(args.epochs):
        for batch in train_dl:
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                if plugin.gradient_clipping:
                    accelerator.clip_grad_norm_(max_norm=plugin.gradient_clipping)
                optimizer.step()
                optimizer.zero_grad()
        accelerator.print(f"epoch {epoch}: loss {float(loss):.4f}")
        losses.append(float(loss))
    return losses


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--ds_config", default=None, help="path to a DeepSpeed config json")
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=128)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
