"""The port's twin of `examples/by_feature/schedule_free.py`: schedule-free
AdamW (`utils.schedule_free.schedule_free_adamw`, the port of optax's
``optax.contrib.schedule_free_adamw``), so there is no learning-rate
schedule to set, but evaluation runs at the AVERAGED parameters
(`schedule_free_eval_params`), the one wrinkle this example shows. The same
data and model (`bert_tiny`) as the JAX script; `--batch_size` is each
process's. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.schedule_free
    python -m accelerate_tpu_torch.examples.by_feature.schedule_free --cpu --train_size 64 --epochs 1
"""

import argparse

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model
from accelerate_tpu_torch.utils.schedule_free import eval_params_in, schedule_free_adamw, schedule_free_eval_params


def training_function(args):
    """Returns the last epoch's accuracy at the averaged parameters."""
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    train_data = get_dataset(config.vocab_size - 1, n=args.train_size, seed=0)
    eval_data = get_dataset(config.vocab_size - 1, n=args.eval_size, seed=1)
    sampler = SeedableRandomSampler(num_samples=len(train_data), seed=args.seed)
    train_dl = SimpleDataLoader(train_data, BatchSampler(sampler, args.batch_size))
    eval_dl = SimpleDataLoader(eval_data, BatchSampler(range(len(eval_data)), args.batch_size))

    optimizer = schedule_free_adamw(model.parameters(), learning_rate=args.lr, warmup_steps=args.warmup_steps)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(model, optimizer, train_dl, eval_dl)

    for epoch in range(args.epochs):
        for batch in train_dl:
            loss = accelerator.backward(model.loss, batch)
            optimizer.step()
            optimizer.zero_grad()

        # Schedule-free: the parameters trained are the gradient points;
        # metrics belong to the averaged ("x") sequence the optimizer keeps.
        eval_params = schedule_free_eval_params(optimizer, model)
        correct, total = 0, 0
        with torch.no_grad(), eval_params_in(model, eval_params):
            for batch in eval_dl:
                logits = model(batch["input_ids"], None, batch["token_type_ids"])
                preds, labels = accelerator.gather_for_metrics((logits.argmax(-1), batch["labels"]))
                correct += int((preds == labels).sum())
                total += len(labels)
        accelerator.print(
            f"epoch {epoch}: loss {float(loss):.4f} accuracy {correct / total:.4f} (schedule-free eval params)"
        )
    return correct / total


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--warmup_steps", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=128)
    parser.add_argument("--eval_size", type=int, default=64)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
