"""The port's twin of `examples/by_feature/profiler.py`:
`accelerator.profile()` wraps training steps in a `torch.profiler` trace
(CPU and CUDA activity, a Chrome trace for Perfetto), and
`save_memory_profile` dumps the CUDA allocator's snapshot (the card's
counterpart of JAX's pprof; on the CPU there is no allocator to dump, and
the twin skips it). The same data, model (`bert_tiny`) and optimizer
settings as the JAX script (AdamW, weight decay 1e-4, optax's default);
`--batch_size` is each process's. It runs on the card unless ``--cpu`` is
given.

    python -m accelerate_tpu_torch.examples.by_feature.profiler --output_dir /tmp/profile
    python -m accelerate_tpu_torch.examples.by_feature.profiler --cpu --train_size 64
"""

import argparse
import os
import tempfile

import torch

from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.examples.nlp_example import WEIGHT_DECAY, get_dataset
from accelerate_tpu_torch.models import bert_tiny, create_bert_model


def training_function(args):
    """Returns the directory the trace was written under."""
    accelerator = Accelerator(project_dir=args.output_dir, cpu=args.cpu)
    set_seed(args.seed)
    config = bert_tiny()
    model = create_bert_model(config, device=accelerator.device)
    data = get_dataset(config.vocab_size - 1, n=args.train_size)
    sampler = SeedableRandomSampler(num_samples=len(data), seed=args.seed)
    train_dl = SimpleDataLoader(data, BatchSampler(sampler, args.batch_size))
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=WEIGHT_DECAY)
    model, optimizer, train_dl = accelerator.prepare(model, optimizer, train_dl)

    # Warm up (build the kernels) outside the trace, so that it shows
    # steady-state steps.
    for batch in train_dl:
        accelerator.backward(model.loss, batch)
        optimizer.step()
        optimizer.zero_grad()
        break

    trace_dir = os.path.join(args.output_dir, "profile")
    with accelerator.profile(log_dir=trace_dir):
        for step, batch in enumerate(train_dl):
            loss = accelerator.backward(model.loss, batch)
            optimizer.step()
            optimizer.zero_grad()
            if step + 1 >= args.profile_steps:
                break
    if accelerator.device.type == "cuda":
        accelerator.save_memory_profile(os.path.join(args.output_dir, "memory.pickle"))
    accelerator.print(f"trace written to {trace_dir} (loss {float(loss):.4f})")
    return trace_dir


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--profile_steps", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=256)
    parser.add_argument("--output_dir",
                        default=os.path.join(tempfile.gettempdir(), "accelerate_tpu_torch_profile_example"))
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    training_function(add_arguments(argparse.ArgumentParser()).parse_args())
