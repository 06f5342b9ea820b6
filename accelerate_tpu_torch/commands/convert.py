"""``accelerate-tpu-torch convert`` and ``merge`` (the port of
`accelerate_tpu/commands/convert.py`), with JAX's arguments, choices and
printed line.

- convert: HF torch layout (safetensors, a sharded index, or .bin) <-> the
  native pytree file (`checkpointing.save_pytree`: npz plus a structure
  manifest, JAX's layout), through the interchange maps
  (`utils/hf_loading.py`) and the flax view of the family's parameters
  (`models.state_dict_to_flax`). A file converted by either package loads
  in the other. `to_hf` writes HF-layout safetensors.
- merge: registered, as in JAX's parser. It reads orbax's sharded layout,
  which waits for ROADMAP A's order step 6 (one decision on that layout),
  and raises until then.
"""

import os

#: The interchange families (`utils/hf_loading.py`'s `_FROM_HF` keys): a
#: static copy, so that ``--help`` imports nothing heavy.
MODEL_TYPES = ["llama", "mixtral", "gptj", "gpt_neox", "opt", "t5"]


def register_subcommand(subparsers):
    parser = subparsers.add_parser("convert", help="Convert between HF torch and native checkpoint layouts")
    parser.add_argument("input", help="Input checkpoint (file or HF sharded dir)")
    parser.add_argument("output", help="Output path (native: .npz + manifest; to_hf: .safetensors)")
    parser.add_argument("--model_type", required=True, choices=MODEL_TYPES, help="Interchange family")
    parser.add_argument(
        "--model",
        required=True,
        help="In-tree config name (e.g. llama-1b, gptj-6b, t5-tiny) the layout is validated against",
    )
    parser.add_argument(
        "--direction",
        default="from_hf",
        choices=["from_hf", "to_hf"],
        help="from_hf: HF torch layout -> native pytree; to_hf: native -> HF layout",
    )
    parser.set_defaults(func=convert_command)

    merge = subparsers.add_parser("merge", help="Consolidate a sharded native checkpoint into one file")
    merge.add_argument("input_dir", help="Directory written by sharded save (manifest + shards)")
    merge.add_argument("output", help="Output path (native .npz + manifest)")
    merge.set_defaults(func=merge_command)
    return parser


def convert_command(args):
    from ..checkpointing import load_pytree, save_pytree
    from ..models import get_model_family, state_dict_from_flax, state_dict_to_flax
    from ..utils.hf_loading import convert_hf_state_dict, load_hf_state_dict, save_hf_checkpoint

    family, config = get_model_family(args.model)
    if family != args.model_type:
        raise ValueError(f"--model {args.model} is a {family!r} config, not {args.model_type!r}")
    if args.direction == "from_hf":
        state = convert_hf_state_dict(load_hf_state_dict(args.input), args.model_type, config)
        save_pytree(state_dict_to_flax(state, config), args.output)
        written = args.output if args.output.endswith(".npz") else args.output + ".npz"
    else:
        state = state_dict_from_flax(load_pytree(args.input), config)
        save_hf_checkpoint(state, args.model_type, config, args.output)
        written = args.output
    print(f"Wrote {written} ({os.path.getsize(written) / 1e6:.1f} MB, {args.direction}, {args.model_type})")


def merge_command(args):
    raise NotImplementedError(
        "merge reads orbax's sharded layout (JAX's save_sharded), which waits for ROADMAP A's order step 6: "
        "one decision on that layout, with A1's save_model and A5's synchronous sharded save")
