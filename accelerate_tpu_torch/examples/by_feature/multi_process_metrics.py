"""The port's twin of `examples/by_feature/multi_process_metrics.py`: eval
across processes done right. The eval loader pads the last uneven batch so
every process takes a step, and `gather_for_metrics` (not `gather`) drops
exactly those padded rows, so the metric counts each sample once. The same
data, model (`bert_tiny`) and optimizer settings as the JAX script (AdamW,
weight decay 1e-4, optax's default); `--batch_size` is each process's. It
runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.multi_process_metrics
    python -m accelerate_tpu_torch.examples.by_feature.multi_process_metrics --cpu --eval_size 35
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


def training_function(args):
    """Returns the last epoch's accuracy over exactly ``--eval_size`` samples."""
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    train_data = get_dataset(config.vocab_size - 1, n=args.train_size, seed=0)
    eval_data = get_dataset(config.vocab_size - 1, n=args.eval_size, seed=1)
    if args.eval_size % args.batch_size == 0:
        raise SystemExit(
            f"--eval_size {args.eval_size} is a multiple of --batch_size {args.batch_size}: "
            "pick an uneven size so the padded-final-batch truncation this example "
            "demonstrates actually happens."
        )
    sampler = SeedableRandomSampler(num_samples=len(train_data), seed=args.seed)
    train_dl = SimpleDataLoader(train_data, BatchSampler(sampler, args.batch_size))
    eval_dl = SimpleDataLoader(eval_data, BatchSampler(range(len(eval_data)), args.batch_size, drop_last=False))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(model, optimizer, train_dl, eval_dl)

    for epoch in range(args.epochs):
        for batch in train_dl:
            loss = accelerator.backward(model.loss, batch)
            optimizer.step()
            optimizer.zero_grad()

        all_preds, all_labels = [], []
        with torch.no_grad():
            for batch in eval_dl:
                logits = model(batch["input_ids"], None, batch["token_type_ids"])
                # One call gathers the (pred, label) pair and drops the padding.
                preds, labels = accelerator.gather_for_metrics((logits.argmax(-1), batch["labels"]))
                all_preds.append(preds)
                all_labels.append(labels)
        all_preds = torch.cat(all_preds)
        all_labels = torch.cat(all_labels)
        if all_preds.shape[0] != len(eval_data):
            raise AssertionError(f"metric sample count {all_preds.shape[0]} != dataset size {len(eval_data)}")
        accuracy = float((all_preds == all_labels).float().mean())
        accelerator.print(
            f"epoch {epoch}: loss {float(loss):.4f} accuracy {accuracy:.4f} "
            f"({all_preds.shape[0]} samples, exact count)"
        )
    return accuracy


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=128)
    parser.add_argument("--eval_size", type=int, default=67, help="keep this NOT a multiple of batch_size")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
