"""The port's twin of `examples/by_feature/checkpointing.py`: the nlp
example with `save_state` every epoch and a resume (`load_state`) that
lands on the exact batch through `skip_first_batches`, its position carried
by the complete example's `StepCounter` in the checkpoint. The same data,
model (`bert_tiny`) and optimizer settings as the JAX script (AdamW, weight
decay 1e-4, optax's default); `--batch_size` is each process's. It runs on
the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.by_feature.checkpointing --output_dir /tmp/ckpt
    python -m accelerate_tpu_torch.examples.by_feature.checkpointing --output_dir /tmp/ckpt \\
        --epochs 3 --resume_from_checkpoint latest
"""

import argparse
import os
import tempfile

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.complete_nlp_example import StepCounter
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model
from accelerate_tpu_torch.utils import ProjectConfiguration


def training_function(args):
    """Returns each trained epoch's last loss."""
    accelerator = Accelerator(
        cpu=args.cpu,
        project_dir=args.output_dir,
        project_config=ProjectConfiguration(automatic_checkpoint_naming=True, total_limit=3),
    )
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    data = get_dataset(config.vocab_size - 1, n=args.train_size)
    sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
    train_dl = SimpleDataLoader(data, BatchSampler(sampler, args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)

    # The batch counter rides the checkpoint (save_iteration counts only
    # save_state calls: with a save an epoch it is the epoch count, not the
    # batch position).
    counter = StepCounter()
    accelerator.register_for_checkpointing(counter)

    start_epoch = 0
    resume_step = 0
    if args.resume_from_checkpoint:
        # 'latest' -> load_state() with no path: the newest by number.
        path = None if args.resume_from_checkpoint == "latest" else args.resume_from_checkpoint
        accelerator.load_state(path)
        start_epoch = counter.overall_step // len(train_dl)
        resume_step = counter.overall_step % len(train_dl)
        accelerator.print(
            f"resumed from {path or 'latest checkpoint'}: epoch {start_epoch}, step {resume_step}"
        )

    losses = []
    for epoch in range(start_epoch, args.epochs):
        # Pin the shuffle epoch (the skipping loader inherits it).
        train_dl.set_epoch(epoch)
        dl = train_dl
        if epoch == start_epoch and resume_step:
            dl = accelerator.skip_first_batches(train_dl, resume_step)
        for batch in dl:
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                optimizer.step()
                optimizer.zero_grad()
            counter.overall_step += 1
        accelerator.save_state()
        accelerator.print(f"epoch {epoch}: loss {float(loss):.4f} (state saved)")
        losses.append(float(loss))
    return losses


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=256)
    parser.add_argument("--output_dir",
                        default=os.path.join(tempfile.gettempdir(), "accelerate_tpu_torch_ckpt_example"))
    parser.add_argument("--resume_from_checkpoint", default=None)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
