"""The port's twin of `examples/complete_nlp_example.py`: every production
knob of the nlp example in one script. Checkpoints every N optimizer steps
or once an epoch (``--checkpointing_steps N|epoch``), a resume from a path
or the newest checkpoint (``--resume_from_checkpoint latest``) that lands on
the exact batch, JSON tracking behind ``--with_tracking``, a linear
learning-rate decay stepped with the optimizer, and gathered eval metrics.
The same data, schedule, optimizer settings and printed lines as the JAX
script; `--batch_size` is each process's. It runs on the card unless
``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.complete_nlp_example --checkpointing_steps epoch
    python -m accelerate_tpu_torch.examples.complete_nlp_example --checkpointing_steps 50 \\
        --resume_from_checkpoint latest --with_tracking
"""

import argparse
import os
import tempfile

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset, linear_schedule
from accelerate_tpu_torch.models import bert_tiny, create_bert_model
from accelerate_tpu_torch.utils import ProjectConfiguration


class StepCounter:
    """A batch counter (one increment per loader batch, inside
    `accumulate()`), checkpointed with the model and optimizer through
    `register_for_checkpointing`, so a resume lands on the exact batch
    whatever the checkpoint granularity (`save_iteration` counts only
    `save_state` calls). It counts batches, not optimizer steps: the resume
    arithmetic (``overall_step // len(train_dl)`` epochs, then
    ``overall_step % len(train_dl)`` batches to skip) holds only at batch
    granularity."""

    def __init__(self):
        self.overall_step = 0

    def state_dict(self):
        return {"overall_step": self.overall_step}

    def load_state_dict(self, state):
        self.overall_step = int(state["overall_step"])


def training_function(args):
    """Returns the last epoch's eval accuracy (None when the checkpoint is
    already past ``--epochs``); each epoch's mean train loss is appended to
    ``args.history`` when the caller set it to a list."""
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision,
        cpu=args.cpu,
        log_with="json" if args.with_tracking else None,
        project_dir=args.output_dir,
        project_config=ProjectConfiguration(automatic_checkpoint_naming=True, total_limit=3),
    )
    set_seed(args.seed)

    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    vocab = config.vocab_size - 1

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
    if args.with_tracking:
        accelerator.init_trackers("complete_nlp_example", config=vars(args))

    # Checkpoint granularity: every N optimizer steps, or once an epoch.
    checkpointing_steps = args.checkpointing_steps
    if checkpointing_steps is not None and checkpointing_steps != "epoch":
        checkpointing_steps = int(checkpointing_steps)

    counter = StepCounter()
    accelerator.register_for_checkpointing(counter)

    start_epoch = 0
    resume_step = 0
    if args.resume_from_checkpoint:
        # 'latest' -> load_state() with no path: the newest checkpoint by
        # number (a listing would put checkpoint_10 before checkpoint_9).
        path = None if args.resume_from_checkpoint == "latest" else args.resume_from_checkpoint
        accelerator.load_state(path)
        start_epoch = counter.overall_step // len(train_dl)
        resume_step = counter.overall_step % len(train_dl)
        accelerator.print(
            f"resumed from {path or 'latest checkpoint'}: epoch {start_epoch}, step {resume_step}"
        )

    if start_epoch >= args.epochs:
        accelerator.print(
            f"nothing to train: checkpoint is at epoch {start_epoch} of {args.epochs} — "
            "raise --epochs to continue"
        )
        return None

    accuracy = 0.0
    for epoch in range(start_epoch, args.epochs):
        # Pin the shuffle epoch: exact wherever in the epoch the checkpoint
        # landed (the skipping loader inherits it).
        train_dl.set_epoch(epoch)
        dl = train_dl
        if epoch == start_epoch and resume_step:
            dl = accelerator.skip_first_batches(train_dl, resume_step)
        total_loss = 0.0
        n_batches = 0
        for batch in dl:
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                accelerator.clip_grad_norm_(max_norm=1.0)
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()
            total_loss += loss  # summed on the device, read once an epoch
            n_batches += 1
            counter.overall_step += 1
            if isinstance(checkpointing_steps, int) and counter.overall_step % checkpointing_steps == 0:
                accelerator.save_state()
        if checkpointing_steps == "epoch":
            accelerator.save_state()

        correct, total = 0, 0
        with torch.no_grad():
            for batch in eval_dl:
                preds = accelerator.gather_for_metrics(
                    model(batch["input_ids"], None, batch["token_type_ids"]).argmax(-1))
                labels = accelerator.gather_for_metrics(batch["labels"])
                correct += int((preds == labels).sum())
                total += len(labels)
        accuracy = correct / total
        train_loss = float(total_loss) / max(n_batches, 1)
        if isinstance(getattr(args, "history", None), list):
            args.history.append(train_loss)
        accelerator.print(f"epoch {epoch}: loss {train_loss:.4f} accuracy {accuracy:.4f}")
        if args.with_tracking:
            accelerator.log(
                {"train_loss": train_loss, "accuracy": accuracy, "step": counter.overall_step},
                step=epoch,
            )

    if args.with_tracking:
        accelerator.end_training()
    return accuracy


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=512)
    parser.add_argument("--eval_size", type=int, default=128)
    parser.add_argument("--output_dir",
                        default=os.path.join(tempfile.gettempdir(), "accelerate_tpu_torch_complete_nlp"))
    parser.add_argument(
        "--checkpointing_steps",
        default=None,
        help="checkpoint every N optimizer steps, or 'epoch' for once per epoch",
    )
    parser.add_argument("--resume_from_checkpoint", default=None, help="path or 'latest'")
    parser.add_argument("--with_tracking", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    parser.add_argument("--performance_lower_bound", type=float, default=None)
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    accuracy = training_function(args)
    if args.performance_lower_bound is not None and accuracy is not None and accuracy < args.performance_lower_bound:
        raise SystemExit(f"accuracy {accuracy:.4f} below bound {args.performance_lower_bound}")
    return accuracy


if __name__ == "__main__":
    main()
