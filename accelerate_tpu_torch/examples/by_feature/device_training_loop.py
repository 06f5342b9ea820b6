"""The port's twin of `examples/by_feature/device_training_loop.py`: one
call of the fused step runs ``steps_per_call`` FULL optimizer steps
(`Accelerator.train_step(steps_per_call=K)`), so the host's per-call cost is
paid once per K steps. The loader collates K step-batches as one
``[K * b, ...]`` batch, which the step splits along dim 0. The same data,
model (`bert_tiny`) and optimizer settings as the JAX script (AdamW,
weight decay 1e-4, optax's default); `--batch_size` is each process's step
batch. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.device_training_loop
    python -m accelerate_tpu_torch.examples.by_feature.device_training_loop --cpu --train_size 64 --epochs 1
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


def training_function(args):
    """Returns the last step's loss."""
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    data = get_dataset(config.vocab_size - 1, n=args.train_size)

    # K step-batches collated as ONE [K*b, ...] batch: one copy to the
    # card and one call for K optimizer steps.
    sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
    train_dl = SimpleDataLoader(data, BatchSampler(sampler, args.batch_size * args.steps_per_call, drop_last=True))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)

    if len(train_dl) == 0:
        raise SystemExit(
            f"train_size={args.train_size} is smaller than one stacked call "
            f"(batch_size*steps_per_call = {args.batch_size * args.steps_per_call}); "
            "lower --steps_per_call/--batch_size or raise --train_size"
        )
    step_fn = accelerator.train_step(steps_per_call=args.steps_per_call)
    loss = None
    steps = 0
    for epoch in range(args.epochs):
        train_dl.set_epoch(epoch)
        for batch in train_dl:
            loss = step_fn(batch)  # K steps; the LAST step's loss
            steps += args.steps_per_call
    accelerator.print(
        f"device training loop: {steps} optimizer steps in {steps // args.steps_per_call} "
        f"dispatches (steps_per_call={args.steps_per_call}) final loss {float(loss):.4f}"
    )
    return float(loss)


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16"])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument(
        "--steps_per_call",
        type=int,
        default=4,
        help="full optimizer steps per call of the fused step (bf16 only: dynamic "
        "fp16 loss scaling needs per-step host decisions and is rejected)",
    )
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=256)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser(description=__doc__)).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser(description=__doc__)).parse_args())
