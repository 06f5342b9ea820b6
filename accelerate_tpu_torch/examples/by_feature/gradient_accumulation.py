"""The port's twin of `examples/by_feature/gradient_accumulation.py`: the
nlp example with ``gradient_accumulation_steps`` N and the `accumulate()`
context, so the optimizer steps only at the accumulation boundaries. The
same data, model (`bert_tiny`) and optimizer settings as the JAX script
(AdamW, weight decay 1e-4, optax's default); `--batch_size` is each
process's. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.gradient_accumulation
    python -m accelerate_tpu_torch.examples.by_feature.gradient_accumulation --cpu --train_size 64
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


def training_function(args):
    """Returns each epoch's last loss."""
    accelerator = Accelerator(gradient_accumulation_steps=args.gradient_accumulation_steps, cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    data = get_dataset(config.vocab_size - 1, n=args.train_size)
    sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
    train_dl = SimpleDataLoader(data, BatchSampler(sampler, args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)

    losses = []
    steps = 0
    for epoch in range(args.epochs):
        for batch in train_dl:
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                optimizer.step()  # a no-op until sync_gradients
                optimizer.zero_grad()
            if accelerator.sync_gradients:
                steps += 1
        accelerator.print(
            f"epoch {epoch}: loss {float(loss):.4f} ({steps} optimizer steps, "
            f"{args.gradient_accumulation_steps}x accumulation)"
        )
        losses.append(float(loss))
    return losses


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--gradient_accumulation_steps", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=8)
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
