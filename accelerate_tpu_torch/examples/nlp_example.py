"""The port's twin of `examples/nlp_example.py`: BERT sequence classification
on MRPC-shaped synthetic data through the Accelerate surface.

    accelerator = Accelerator(mixed_precision="bf16", log_with="json", project_dir=...)
    model, optimizer, train_dl, eval_dl, scheduler = accelerator.prepare(...)
    loss = accelerator.backward(model.loss, batch); optimizer.step(); ...

The same data, schedule, optimizer settings and metrics as the JAX example:
a linear learning-rate decay to 0 over the run (optax's `linear_schedule`),
AdamW with weight decay 1e-4 (optax's default; torch's is 1e-2), clipping at
1.0, and per epoch the last step's loss and the eval accuracy, printed and
logged to ``{output_dir}/nlp_example/metrics.jsonl``. It runs on the card
unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.nlp_example                 # bert_tiny on the card
    python -m accelerate_tpu_torch.examples.nlp_example --full          # BERT-base
    python -m accelerate_tpu_torch.examples.nlp_example --cpu --mixed_precision no
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.models import bert_tiny, create_bert_model

MAX_LEN = 128
WEIGHT_DECAY = 1e-4  # optax.adamw's default


def get_dataset(tokenizer_vocab: int, n: int = 512, seed: int = 0):
    """MRPC-shaped data: pairs of token sequences and a binary paraphrase
    label; a paraphrase's second half is a shuffle of its first, a negative's
    is drawn afresh. The JAX example's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    data = []
    for _ in range(n):
        label = int(rng.integers(0, 2))
        s1 = rng.integers(5, tokenizer_vocab, size=MAX_LEN // 2)
        if label == 1:
            s2 = rng.permutation(s1)
        else:
            s2 = rng.integers(5, tokenizer_vocab, size=MAX_LEN // 2)
        input_ids = np.concatenate([s1, s2]).astype(np.int32)
        token_type_ids = np.concatenate(
            [np.zeros(MAX_LEN // 2, np.int32), np.ones(MAX_LEN // 2, np.int32)]
        )
        data.append({"input_ids": input_ids, "token_type_ids": token_type_ids, "labels": np.int64(label)})
    return data


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """``step -> lr`` from `init_value` to `end_value` over `transition_steps`,
    then flat: optax's `linear_schedule`."""

    def schedule(step: int) -> float:
        frac = min(max(step, 0), transition_steps) / transition_steps
        return init_value + (end_value - init_value) * frac

    return schedule


def training_function(args):
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu, log_with="json",
                              project_dir=args.output_dir)
    set_seed(args.seed)

    config = bert_tiny() if args.tiny else None
    model = create_bert_model(config, device=accelerator.device)
    vocab = (config.vocab_size if config else 30522) - 1

    train_data = get_dataset(vocab, n=args.train_size, seed=0)
    eval_data = get_dataset(vocab, n=args.eval_size, seed=1)

    sampler = SeedableRandomSampler(num_samples=len(train_data), seed=args.seed)
    train_dl = SimpleDataLoader(train_data, BatchSampler(sampler, args.batch_size))
    eval_dl = SimpleDataLoader(eval_data, BatchSampler(range(len(eval_data)), args.batch_size))

    schedule = linear_schedule(args.lr, 0.0, transition_steps=args.epochs * len(train_dl))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)

    model, optimizer, train_dl, eval_dl, scheduler = accelerator.prepare(
        model, optimizer, train_dl, eval_dl, schedule
    )
    accelerator.init_trackers("nlp_example", config=vars(args))

    for epoch in range(args.epochs):
        for step, batch in enumerate(train_dl):
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                accelerator.clip_grad_norm_(max_norm=1.0)
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()

        correct, total = 0, 0
        with torch.no_grad():
            for batch in eval_dl:
                preds = model(batch["input_ids"], None, batch["token_type_ids"]).argmax(-1)
                gathered_preds = accelerator.gather_for_metrics(preds)
                gathered_labels = accelerator.gather_for_metrics(batch["labels"])
                correct += int((gathered_preds == gathered_labels).sum())
                total += len(gathered_labels)
        accuracy = correct / total
        accelerator.print(f"epoch {epoch}: loss {float(loss):.4f} accuracy {accuracy:.4f}")
        accelerator.log({"loss": float(loss), "accuracy": accuracy}, step=epoch)

    accelerator.end_training()
    return accuracy


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=512)
    parser.add_argument("--eval_size", type=int, default=128)
    parser.add_argument("--output_dir",
                        default=os.path.join(tempfile.gettempdir(), "accelerate_tpu_torch_nlp_example"))
    parser.add_argument("--tiny", action="store_true", default=True, help="Use the test-size BERT config")
    parser.add_argument("--full", dest="tiny", action="store_false", help="Use BERT-base")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    parser.add_argument("--performance_lower_bound", type=float, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    accuracy = training_function(args)
    if args.performance_lower_bound is not None and accuracy < args.performance_lower_bound:
        raise SystemExit(f"accuracy {accuracy:.4f} below bound {args.performance_lower_bound}")


if __name__ == "__main__":
    main()
