"""The port's twin of `examples/inference/quantized_inference.py`: quantize
a model's weights to int8, int4 or nf4 (`utils.quantization`, JAX's
`load_and_quantize_model`), report the footprint saved, and generate
through the same KV-cached decode loop as the dense model. The card holds
the codes and scales; each forward dequantizes them to the compute dtype
(f32 here, as in the JAX script). It runs on the card unless ``--cpu`` is
given.

    python -m accelerate_tpu_torch.examples.inference.quantized_inference --bits 8
    python -m accelerate_tpu_torch.examples.inference.quantized_inference --cpu --bits 4 --quant_type int4
"""

import argparse

import numpy as np
import torch

from accelerate_tpu_torch.device import resolve_device
from accelerate_tpu_torch.generation import GenerationConfig, Generator
from accelerate_tpu_torch.models.llama import create_llama_model, llama_tiny
from accelerate_tpu_torch.utils.quantization import QuantizationConfig, load_and_quantize_model, quantized_nbytes


def main(args):
    """Returns the generated ids, [num_prompts, prompt_len + new tokens]."""
    device = resolve_device("cpu" if args.cpu else None)
    cfg = llama_tiny()
    model = create_llama_model(cfg, device=device)
    dense_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    qconfig = (
        QuantizationConfig(load_in_8bit=True, compute_dtype=torch.float32)
        if args.bits == 8
        else QuantizationConfig(load_in_4bit=True, quant_type=args.quant_type, compute_dtype=torch.float32)
    )
    qmodel = load_and_quantize_model(model, qconfig)
    q_bytes = quantized_nbytes(qmodel.qparams)
    print(f"weights: {dense_bytes / 1e6:.1f} MB dense -> {q_bytes / 1e6:.1f} MB quantized ({args.bits}-bit)")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size, (args.num_prompts, args.prompt_len)).astype(np.int32)
    gen = Generator(qmodel, max_new_tokens=args.max_new_tokens, max_length=args.prompt_len + args.max_new_tokens,
                    device=device)
    out = gen(torch.as_tensor(prompts, dtype=torch.long, device=device),
              GenerationConfig(max_new_tokens=args.max_new_tokens))
    print(f"generated {out.shape[0]} completions of {out.shape[1] - args.prompt_len} tokens at the quantized footprint")
    return out


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The script's flags, on `parser`."""
    parser.add_argument("--bits", type=int, default=8, choices=[4, 8])
    parser.add_argument("--quant_type", default="nf4", choices=["int4", "nf4"])
    parser.add_argument("--num_prompts", type=int, default=4)
    parser.add_argument("--prompt_len", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser


def parse_args(argv=None):
    return add_arguments(argparse.ArgumentParser()).parse_args(argv)


if __name__ == "__main__":
    main(add_arguments(argparse.ArgumentParser()).parse_args())
