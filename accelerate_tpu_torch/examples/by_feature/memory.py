"""The port's twin of `examples/by_feature/memory.py`:
`find_executable_batch_size` halves the batch size each time the card runs
out of memory and calls the training loop again, which starts with
`Accelerator.free_memory`, so the failed attempt's model and optimizer
state are gone before the next is built. The same data, model (`bert_tiny`)
and optimizer settings as the JAX script (AdamW, weight decay 1e-4, optax's
default). It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.memory
    python -m accelerate_tpu_torch.examples.by_feature.memory --cpu --train_size 64
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model
from accelerate_tpu_torch.utils import find_executable_batch_size


def executable_batch_size_loop(accelerator, starting_batch_size: int, build, epochs: int = 1):
    """The script's loop: from `starting_batch_size`, halving on each
    out-of-memory error, ``build(batch_size) -> (model, optimizer, loader)``
    and train `epochs` passes after `accelerator.free_memory()`. Returns
    (the batch size that trained, its last loss)."""

    @find_executable_batch_size(starting_batch_size=starting_batch_size)
    def inner_training_loop(batch_size):
        accelerator.print(f"Trying batch size: {batch_size}")
        accelerator.free_memory()  # a fresh start for each attempt
        model, optimizer, loader = accelerator.prepare(*build(batch_size))
        for epoch in range(epochs):
            for batch in loader:
                with accelerator.accumulate(model):
                    loss = accelerator.backward(model.loss, batch)
                    optimizer.step()
                    optimizer.zero_grad()
            accelerator.print(f"epoch {epoch}: loss {float(loss):.4f}")
        return batch_size, float(loss)

    return inner_training_loop()


def training_function(args):
    """Returns the batch size that trained; prints ``Trained with batch size N``."""
    accelerator = Accelerator(cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    data = get_dataset(config.vocab_size - 1, n=args.train_size)

    def build(batch_size):
        model = create_bert_model(config, device=accelerator.device)
        sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
        loader = SimpleDataLoader(data, BatchSampler(sampler, batch_size))
        optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
        return model, optimizer, loader

    used, _ = executable_batch_size_loop(accelerator, args.batch_size, build, epochs=args.epochs)
    accelerator.print(f"Trained with batch size {used}")
    return used


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=256)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
