"""The port's twin of `examples/by_feature/automatic_gradient_accumulation.py`:
`find_executable_batch_size` (halve the batch on an out-of-memory error)
with gradient accumulation, so the EFFECTIVE batch size stays the same:
each time the per-step batch halves, the accumulation count doubles. Each
attempt builds a fresh `Accelerator`, since its accumulation count depends
on the batch size tried. The same data, model (`bert_tiny`) and optimizer
settings as the JAX script (AdamW, weight decay 1e-4, optax's default); the
batch sizes are each process's. It runs on the card unless ``--cpu`` is
given.

    python -m accelerate_tpu_torch.examples.by_feature.automatic_gradient_accumulation
    python -m accelerate_tpu_torch.examples.by_feature.automatic_gradient_accumulation --cpu --train_size 64
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model
from accelerate_tpu_torch.utils.memory import find_executable_batch_size


def training_function(args):
    """Returns the final loss of the attempt that trained."""
    set_seed(args.seed)
    config = bert_tiny()
    data = get_dataset(config.vocab_size - 1, n=args.train_size, seed=0)

    @find_executable_batch_size(starting_batch_size=args.observed_batch_size)
    def inner_training_loop(batch_size):
        # A fresh accelerator for each attempt: the accumulation count
        # depends on the batch size this attempt tries.
        from accelerate_tpu_torch.state import AcceleratorState, GradientState

        AcceleratorState._reset_state()
        GradientState._reset_state()
        accumulation = max(1, args.target_batch_size // batch_size)
        accelerator = Accelerator(
            mixed_precision=args.mixed_precision, gradient_accumulation_steps=accumulation, cpu=args.cpu
        )
        accelerator.print(f"trying batch_size={batch_size} x accumulation={accumulation}")
        accelerator.free_memory()
        model = create_bert_model(config, device=accelerator.device)
        sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
        train_dl = SimpleDataLoader(data, BatchSampler(sampler, batch_size))
        optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
        model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)
        loss = None
        for _ in range(args.epochs):
            for batch in train_dl:
                with accelerator.accumulate(model):
                    loss = accelerator.backward(model.loss, batch)
                    optimizer.step()
                    optimizer.zero_grad()
        accelerator.print(
            f"done: batch_size={batch_size} accumulation={accumulation} "
            f"(effective {batch_size * accumulation}) final loss {float(loss):.4f}"
        )
        return float(loss)

    return inner_training_loop()


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--observed_batch_size", type=int, default=32, help="first batch size to try")
    parser.add_argument("--target_batch_size", type=int, default=64, help="effective batch size to preserve")
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
