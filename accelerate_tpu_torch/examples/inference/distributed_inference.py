"""The port's twin of `examples/inference/distributed_inference.py`: each
process generates for its slice of the prompt list
(`split_between_processes`), and the completions are joined again with
`gather_object`. It runs the KV-cached `Generator` on a llama-tiny model
(a stand-in for a Hub checkpoint: ``--checkpoint`` points at a local HF
Llama directory, loaded through `load_hf_checkpoint_in_model`). It runs on
the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.inference.distributed_inference
    python -m accelerate_tpu_torch.commands.accelerate_cli launch --cpu --num_processes 2 \\
        accelerate_tpu_torch/examples/inference/distributed_inference.py --num_prompts 4
"""

import argparse
import json
import os

import numpy as np
import torch

from accelerate_tpu_torch.generation import GenerationConfig, Generator
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model, llama_tiny
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.utils.operations import gather_object

HF_CONFIG_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings", "rope_theta")


def main(args):
    """Returns every process's completions, in prompt order."""
    state = PartialState(cpu=args.cpu)
    if args.checkpoint:
        from accelerate_tpu_torch.utils.hf_loading import load_hf_checkpoint_in_model

        with open(os.path.join(args.checkpoint, "config.json")) as f:
            hf_cfg = json.load(f)
        cfg = LlamaConfig(**{k: hf_cfg[k] for k in HF_CONFIG_KEYS if k in hf_cfg})
        model = create_llama_model(cfg, device=state.device)
        load_hf_checkpoint_in_model(model, args.checkpoint, "llama", cfg)
    else:
        cfg = llama_tiny()
        model = create_llama_model(cfg, device=state.device)
    rng = np.random.default_rng(0)
    # Stand-in prompts: token arrays (a tokenizer would produce these).
    prompts = [
        rng.integers(2, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)
        for _ in range(args.num_prompts)
    ]

    gen = Generator(model, max_new_tokens=args.max_new_tokens, max_length=args.prompt_len + args.max_new_tokens,
                    device=state.device)
    with state.split_between_processes(prompts) as my_prompts:
        completions = []
        for prompt in my_prompts:
            ids = torch.as_tensor(prompt[None, :], dtype=torch.long, device=state.device)
            out = gen(ids, GenerationConfig(max_new_tokens=args.max_new_tokens))
            completions.append(out[0, -args.max_new_tokens:].tolist())
    all_completions = gather_object(completions)
    state.print(
        f"{len(prompts)} prompts -> {len(all_completions)} completions across "
        f"{state.num_processes} process(es); first: {all_completions[0][:8]}..."
    )
    if len(all_completions) != len(prompts):
        raise AssertionError(f"{len(all_completions)} completions for {len(prompts)} prompts")
    return all_completions


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--checkpoint", default=None, help="local HF llama checkpoint dir")
    parser.add_argument("--num_prompts", type=int, default=8)
    parser.add_argument("--prompt_len", type=int, default=32)
    parser.add_argument("--max_new_tokens", type=int, default=16)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    main(add_arguments(argparse.ArgumentParser()).parse_args())
