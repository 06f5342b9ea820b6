"""``accelerate-tpu-torch env``: print the environment for a bug report (the
port of `accelerate_tpu/commands/env.py`), with the port's facts: the torch
and CUDA versions, each card's name, the power limit where ``nvidia-smi``
runs, then the ``ACCELERATE_TPU_*`` variables and the config file as JAX
prints them. It reads the card's name through torch and starts no work on
it."""

from __future__ import annotations

import os
import platform
import shutil
import subprocess


def register_subcommand(subparsers):
    parser = subparsers.add_parser("env", help="Print environment information")
    parser.add_argument("--config_file", default=None, help="Config file to inspect")
    parser.set_defaults(func=env_command)
    return parser


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or "not available"."""
    if shutil.which("nvidia-smi") is None:
        return "not available (no nvidia-smi)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({e})"
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip()) or "not available"


def env_command(args):
    import torch

    import accelerate_tpu_torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        "`accelerate_tpu_torch` version": accelerate_tpu_torch.__version__,
        "Platform": platform.platform(),
        "Python version": platform.python_version(),
        "PyTorch version": torch.__version__,
        "CUDA version (torch)": torch.version.cuda or "none (a CPU build)",
        "CUDA available": torch.cuda.is_available(),
        "Card count": cards,
        "Card names": ", ".join(torch.cuda.get_device_name(i) for i in range(cards)) or "none",
        "Card name, power limit (nvidia-smi)": power_limit(),
        "NCCL available": torch.distributed.is_available() and torch.distributed.is_nccl_available(),
    }
    accelerate_env = {k: v for k, v in os.environ.items() if k.startswith("ACCELERATE_TPU_")}
    print("\nCopy-and-paste the text below in your GitHub issue\n")
    print("\n".join([f"- {prop}: {val}" for prop, val in info.items()]))
    if accelerate_env:
        print("- Environment config:")
        print("\n".join([f"  - {k}={v}" for k, v in sorted(accelerate_env.items())]))
    config_file = args.config_file or default_config_file()
    if os.path.isfile(config_file):
        with open(config_file) as f:
            print(f"- Config file ({config_file}):\n" + "".join(f"  {line}" for line in f))
    return info


def default_config_file() -> str:
    """``$ACCELERATE_TPU_CONFIG_HOME/default_config.yaml``, by default under
    ``~/.cache/accelerate_tpu`` (JAX's path: one file serves both)."""
    cache_dir = os.environ.get(
        "ACCELERATE_TPU_CONFIG_HOME", os.path.join(os.path.expanduser("~"), ".cache", "accelerate_tpu")
    )
    return os.path.join(cache_dir, "default_config.yaml")
