"""The port's twin of `examples/by_feature/tracking.py`: experiment trackers
through `init_trackers`, `log` and `end_training`. The JSON and CSV
trackers need no other package; ``--log_with tensorboard`` (or wandb,
mlflow, ... when installed, or ``all``) picks others. The training loss is
summed on the device and read once an epoch. It runs on the card unless
``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.tracking --output_dir /tmp/tracking
    python -m accelerate_tpu_torch.examples.by_feature.tracking --cpu --log_with json,csv
"""

import argparse
import os
import tempfile

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


def training_function(args):
    """Returns each epoch's logged values (``train_loss``, ``accuracy``,
    ``epoch``)."""
    log_with = args.log_with.split(",") if "," in args.log_with else args.log_with
    accelerator = Accelerator(log_with=log_with, project_dir=args.output_dir, cpu=args.cpu)
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

    accelerator.init_trackers("tracking_example", config=vars(args))
    logged = []
    overall_step = 0
    for epoch in range(args.epochs):
        total_loss = 0.0
        for batch in train_dl:
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                total_loss += loss  # summed on the device: no host read each step
                optimizer.step()
                optimizer.zero_grad()
            overall_step += 1
        correct, total = 0, 0
        with torch.no_grad():
            for batch in eval_dl:
                preds = accelerator.gather_for_metrics(model(batch["input_ids"], None, batch["token_type_ids"]).argmax(-1))
                labels = accelerator.gather_for_metrics(batch["labels"])
                correct += int((preds == labels).sum())
                total += len(labels)
        values = {"train_loss": float(total_loss) / len(train_dl), "accuracy": correct / total, "epoch": epoch}
        accelerator.log(values, step=overall_step)
        logged.append(values)
        accelerator.print(f"epoch {epoch}: acc {correct / total:.3f}")
    accelerator.end_training()
    return logged


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--log_with", default="json", help="json, csv, tensorboard, wandb, mlflow, all (comma-separated)")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=256)
    parser.add_argument("--eval_size", type=int, default=64)
    parser.add_argument("--output_dir",
                        default=os.path.join(tempfile.gettempdir(), "accelerate_tpu_torch_tracking_example"))
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
