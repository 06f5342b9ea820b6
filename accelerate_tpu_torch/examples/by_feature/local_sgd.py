"""The port's twin of `examples/by_feature/local_sgd.py`: each
data-parallel process takes `local_sgd_steps` steps on its own gradients,
then the parameters are averaged (`LocalSGD`): one all-reduce per K steps
instead of one per step. At one process it trains as plain data parallel.
`--batch_size` is each process's (the port's loaders take the reference's
per-process batches): at 2 processes, 16 makes the JAX script's global
batch of 32. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.local_sgd --cpu
    python -m accelerate_tpu_torch.commands.accelerate_cli launch --cpu --num_processes 2 \\
        accelerate_tpu_torch/examples/by_feature/local_sgd.py --batch_size 16
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, LocalSGD, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


def training_function(args):
    """Returns the last step's loss of each epoch."""
    accelerator = Accelerator(cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    data = get_dataset(config.vocab_size - 1, n=args.train_size)
    sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
    train_dl = SimpleDataLoader(data, BatchSampler(sampler, args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)

    losses = []
    with LocalSGD(
        accelerator=accelerator, model=model, local_sgd_steps=args.local_sgd_steps, enabled=True
    ) as local_sgd:
        for epoch in range(args.epochs):
            for batch in train_dl:
                with accelerator.accumulate(model):
                    loss = accelerator.backward(model.loss, batch)
                    optimizer.step()
                    optimizer.zero_grad()
                    local_sgd.step()
            accelerator.print(f"epoch {epoch}: loss {float(loss):.4f}")
            losses.append(float(loss))
    return losses


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--local_sgd_steps", type=int, default=8)
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
