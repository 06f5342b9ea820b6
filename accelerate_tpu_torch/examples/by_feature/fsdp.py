"""The port's twin of `examples/by_feature/fsdp.py`: parameters and
optimizer state sharded over the "fsdp" mesh axis (FULL_SHARD: torch's
FSDP on every encoder layer), with the card's peak memory printed each
epoch. JAX's ``--fsdp_size`` default of 8 is its 8-device CPU mesh; the
twin's default shards over every process (`ParallelismConfig(fsdp=-1)`).
The peak is `torch.cuda.max_memory_allocated` on the card and 0 on the CPU,
as JAX prints 0 where the backend reports none. The same data, model
(`bert_tiny`) and optimizer settings as the JAX script (bf16, AdamW, weight
decay 1e-4, optax's default); `--batch_size` is each process's. It runs on
the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.commands.accelerate_cli launch --num_processes 1 \\
        accelerate_tpu_torch/examples/by_feature/fsdp.py
    python -m accelerate_tpu_torch.commands.accelerate_cli launch --cpu --num_processes 2 \\
        accelerate_tpu_torch/examples/by_feature/fsdp.py --train_size 64
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model
from accelerate_tpu_torch.utils import FullyShardedDataParallelPlugin, ParallelismConfig


def peak_hbm_bytes(device) -> int:
    """The card's peak allocated bytes; 0 on the CPU, which reports none."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def training_function(args):
    """Returns each epoch's last loss."""
    mesh = ParallelismConfig(data=1, fsdp=-1) if args.fsdp_size is None else ParallelismConfig(
        data=-1, fsdp=args.fsdp_size)
    accelerator = Accelerator(
        mixed_precision="bf16",
        cpu=args.cpu,
        parallelism_config=mesh,
        fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD"),
    )
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    data = get_dataset(config.vocab_size - 1, n=args.train_size)
    sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
    train_dl = SimpleDataLoader(data, BatchSampler(sampler, args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)

    losses = []
    for epoch in range(args.epochs):
        for batch in train_dl:
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                optimizer.step()
                optimizer.zero_grad()
        accelerator.print(
            f"epoch {epoch}: loss {float(loss):.4f} peak HBM {peak_hbm_bytes(accelerator.device) / 2**20:.1f} MiB"
        )
        losses.append(float(loss))
    return losses


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--fsdp_size", type=int, default=None, help="default: every process")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=256)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
