"""The port's twin of `examples/by_feature/early_stopping.py`: the
nlp_example with early stopping on the eval loss. The main process decides
and raises the trigger (`set_trigger`); every process reads it with
`check_trigger` (a sum across the processes) and they leave the epoch loop
together. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.early_stopping
    python -m accelerate_tpu_torch.examples.by_feature.early_stopping --cpu --mixed_precision no
"""

import argparse

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


class EarlyStoppingCallback:
    """Stop after `patience` evaluations without an improvement of more
    than `min_delta` on the best eval loss."""

    def __init__(self, min_delta: float = 0.0, patience: int = 2):
        self.min_delta = min_delta
        self.patience = patience
        self.best = float("inf")
        self.counter = 0

    def check(self, eval_loss: float) -> bool:
        if eval_loss < self.best - self.min_delta:
            self.best = eval_loss
            self.counter = 0
            return False
        self.counter += 1
        return self.counter >= self.patience


def training_function(args):
    """Returns {"eval_loss", "stopped_at" (the epoch, or None), "trigger_after"
    (`check_trigger()` once more after the loop: False, the flag was
    cleared)}."""
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    train_data = get_dataset(config.vocab_size - 1, n=args.train_size, seed=0)
    eval_data = get_dataset(config.vocab_size - 1, n=args.eval_size, seed=1)
    sampler = SeedableRandomSampler(num_samples=len(train_data), seed=args.seed)
    train_dl = SimpleDataLoader(train_data, BatchSampler(sampler, args.batch_size))
    eval_dl = SimpleDataLoader(eval_data, BatchSampler(range(len(eval_data)), args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(model, optimizer, train_dl, eval_dl)

    stopper = EarlyStoppingCallback(patience=args.patience)
    stopped_at = None
    for epoch in range(args.epochs):
        for batch in train_dl:
            loss = accelerator.backward(model.loss, batch)
            optimizer.step()
            optimizer.zero_grad()
        eval_losses = []
        with torch.no_grad():
            for batch in eval_dl:
                eval_losses.append(float(accelerator.gather_for_metrics(model.loss(batch))))
        eval_loss = float(np.mean(eval_losses))
        accelerator.print(f"epoch {epoch}: train loss {float(loss):.4f} eval loss {eval_loss:.4f}")
        # The main process decides; the trigger carries the decision to
        # every process, so they all break on the same epoch.
        if accelerator.is_main_process and stopper.check(eval_loss):
            accelerator.set_trigger()
        if accelerator.check_trigger():
            accelerator.print(f"early stopping at epoch {epoch} (patience {args.patience})")
            stopped_at = epoch
            break
    return {"eval_loss": eval_loss, "stopped_at": stopped_at, "trigger_after": accelerator.check_trigger()}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--patience", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=128)
    parser.add_argument("--eval_size", type=int, default=64)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    training_function(parse_args())
