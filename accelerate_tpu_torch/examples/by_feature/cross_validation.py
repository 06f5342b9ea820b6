"""The port's twin of `examples/by_feature/cross_validation.py`: k-fold
training over the MRPC-shaped data. Each fold trains a freshly prepared
model on the other folds and scores its own with `gather_for_metrics`; the
report is the folds' mean accuracy (plain index folds, as in the JAX
script). The same data, model (`bert_tiny`) and optimizer settings as the
JAX script (AdamW, weight decay 1e-4, optax's default); `--batch_size` is
each process's. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.cross_validation
    python -m accelerate_tpu_torch.examples.by_feature.cross_validation --cpu --num_folds 2 --train_size 96
"""

import argparse

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


def run_fold(accelerator, args, config, data, fold, k):
    """Train on every fold but `fold`, and return the accuracy on it."""
    n = len(data)
    fold_size = n // k
    eval_idx = set(range(fold * fold_size, (fold + 1) * fold_size))
    train_data = [data[i] for i in range(n) if i not in eval_idx]
    eval_data = [data[i] for i in sorted(eval_idx)]

    model = create_bert_model(config, device=accelerator.device)
    sampler = SeedableRandomSampler(num_samples=len(train_data), seed=args.seed + fold)
    train_dl = SimpleDataLoader(train_data, BatchSampler(sampler, args.batch_size))
    eval_dl = SimpleDataLoader(eval_data, BatchSampler(range(len(eval_data)), args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(model, optimizer, train_dl, eval_dl)
    for _ in range(args.epochs):
        for batch in train_dl:
            accelerator.backward(model.loss, batch)
            optimizer.step()
            optimizer.zero_grad()
    correct, total = 0, 0
    with torch.no_grad():
        for batch in eval_dl:
            logits = model(batch["input_ids"], None, batch["token_type_ids"])
            preds, labels = accelerator.gather_for_metrics((logits.argmax(-1), batch["labels"]))
            correct += int((preds == labels).sum())
            total += len(labels)
    accelerator.free_memory()
    return correct / total


def training_function(args):
    """Returns the folds' mean accuracy."""
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    data = get_dataset(config.vocab_size - 1, n=args.train_size, seed=0)
    accuracies = []
    for fold in range(args.num_folds):
        acc = run_fold(accelerator, args, config, data, fold, args.num_folds)
        accelerator.print(f"fold {fold}: accuracy {acc:.4f}")
        accuracies.append(acc)
    accelerator.print(f"cross-validation mean accuracy {np.mean(accuracies):.4f} over {args.num_folds} folds")
    return float(np.mean(accuracies))


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--num_folds", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=192)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
