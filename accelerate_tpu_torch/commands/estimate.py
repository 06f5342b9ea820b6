"""``accelerate-tpu-torch estimate-memory``: what a model takes to load and
to train, per dtype (the port of `accelerate_tpu/commands/estimate.py`).

An in-tree name (``opt-30b``, ``llama_1b``) is built empty on the meta
device (`big_modeling.init_empty_weights`) and counted by the planner's
size accounting (`utils.modeling`): every parameter, and the largest
placement block. JAX counts an in-tree name from a closed form over its
config instead, which misses learned positions, biases and experts
(ROADMAP C); `estimate_parameters_from_hf_config` keeps that form for a
``config.json`` or a directory holding one. JAX builds a Hub id's model
(or a directory's) with `transformers` on the meta device; the port does
not use `transformers` (the card's machine has none), so it refuses a Hub
id and says so.
"""

from __future__ import annotations

import json
import os

from ..utils.other import convert_bytes

DTYPE_BYTES = {"float32": 4, "bf16": 2, "bfloat16": 2, "float16": 2, "int8": 1, "int4": 0.5}


def register_subcommand(subparsers):
    parser = subparsers.add_parser("estimate-memory", help="Estimate model memory usage")
    parser.add_argument("model_name", nargs="+",
                        help="in-tree model name(s), or a config.json or a directory holding one")
    parser.add_argument("--dtypes", nargs="+", default=["float32", "bf16", "int8", "int4"])
    parser.add_argument("--trust_remote_code", action="store_true",
                        help="JAX's flag, accepted; the port builds no Hub model")
    parser.set_defaults(func=estimate_command)
    return parser


def in_tree_sizes(name: str) -> tuple:
    """(parameters, the largest block's parameters) of a registered model,
    counted on its meta-device build, or None for an unknown name."""
    from ..big_modeling import init_empty_weights
    from ..models import MODEL_REGISTRY
    from ..utils.dataclasses import CustomDtype
    from ..utils.modeling import calculate_maximum_sizes, compute_module_sizes

    key = name.lower().replace("_", "-")
    if key not in MODEL_REGISTRY:
        return None
    model = init_empty_weights(MODEL_REGISTRY[key]())
    # At one byte an element, the byte accounting counts elements.
    counts = compute_module_sizes(model, dtype=CustomDtype.INT8)
    _, (_, largest_name) = calculate_maximum_sizes(model)
    return counts[""], counts[largest_name]


def estimate_parameters_from_hf_config(cfg: dict) -> tuple:
    """(parameters, largest layer's parameters) in closed form from a
    ``config.json``: JAX's formula."""
    vocab = cfg.get("vocab_size", 32000)
    hidden = cfg.get("hidden_size", cfg.get("n_embd", cfg.get("d_model", 768)))
    layers = cfg.get("num_hidden_layers", cfg.get("n_layer", cfg.get("num_layers", 12)))
    inter = cfg.get("intermediate_size", cfg.get("n_inner") or cfg.get("d_ff") or 4 * hidden)
    heads = cfg.get("num_attention_heads", cfg.get("n_head") or cfg.get("num_heads") or hidden // 64)
    kv_heads = cfg.get("num_key_value_heads", heads)
    head_dim = cfg.get("head_dim", cfg.get("d_kv") or hidden // heads)
    attn = hidden * heads * head_dim + 2 * hidden * kv_heads * head_dim + heads * head_dim * hidden
    gated = (
        "llama" in str(cfg.get("model_type", "")).lower()
        or cfg.get("hidden_act", "") in ("silu", "swiglu")
        or "gated" in str(cfg.get("feed_forward_proj", ""))
    )
    mlp = (3 if gated else 2) * hidden * inter
    per_layer = attn + mlp + 2 * hidden
    embed = vocab * hidden
    if cfg.get("is_encoder_decoder"):
        enc_layers = cfg.get("num_encoder_layers") or cfg.get("num_layers") or layers // 2
        dec_layers = cfg.get("num_decoder_layers", enc_layers)
        enc_per_layer = attn + mlp + 2 * hidden
        dec_per_layer = 2 * attn + mlp + 3 * hidden
        total = embed + enc_layers * enc_per_layer + dec_layers * dec_per_layer + 2 * hidden
        per_layer = max(enc_per_layer, dec_per_layer)
    else:
        total = embed + layers * per_layer + hidden
    if not cfg.get("tie_word_embeddings", True):
        total += vocab * hidden
    return total, max(per_layer, embed)


def gather_data(args, model_name=None):
    """(parameters, [{dtype, largest_layer, total_size, training_size}])
    for one model; training is 4x the weights (weights, gradients and
    Adam's two moments, as JAX and the reference count)."""
    name = model_name if model_name is not None else (
        args.model_name[0] if isinstance(args.model_name, (list, tuple)) else args.model_name)
    sizes = in_tree_sizes(name)
    if sizes is None:
        path = os.path.join(name, "config.json") if os.path.isdir(name) else name
        if not os.path.isfile(path):
            raise RuntimeError(
                f"`{name}` is neither an in-tree model nor a config.json (or a directory holding one); building a "
                "Hugging Face Hub model needs `transformers`, which the port does not use")
        with open(path) as f:
            sizes = estimate_parameters_from_hf_config(json.load(f))
    total, largest = sizes
    rows = []
    for dtype in args.dtypes:
        bytes_per = DTYPE_BYTES[dtype]
        rows.append({"dtype": dtype, "largest_layer": largest * bytes_per, "total_size": total * bytes_per,
                     "training_size": total * bytes_per * 4})
    return total, rows


def estimate_command(args):
    """Print one table per model; returns {model name: rows}."""
    names = args.model_name if isinstance(args.model_name, (list, tuple)) else [args.model_name]
    out = {}
    for name in names:
        total, rows = gather_data(args, name)
        print(f"Memory usage for loading `{name}` ({total / 1e9:.2f}B params):")
        header = f"| {'dtype':8} | {'Largest Layer':>14} | {'Total Size':>12} | {'Training (Adam)':>16} |"
        print(header)
        print("|" + "-" * (len(header) - 2) + "|")
        for row in rows:
            print(f"| {row['dtype']:8} | {convert_bytes(row['largest_layer']):>14} "
                  f"| {convert_bytes(row['total_size']):>12} | {convert_bytes(row['training_size']):>16} |")
        out[name] = rows
    return out
