"""``estimate-memory`` in the port (`accelerate_tpu_torch.commands.estimate`)
held to the JAX package (about 35 s: JAX traces each model's shapes).

For every model both registries name, the port's table is what JAX's own
size accounting gives on JAX's `init_empty_weights` tree: the total and
the largest block, at each dtype, with the training column at 4x. JAX's
command counts an in-tree name from a closed form over its config
instead, which misses learned positions, biases and experts (ROADMAP C);
the test pins that difference, so a change on either side shows. A
``config.json``, or a directory holding one, takes JAX's closed form; the
port does not use `transformers` (JAX builds a directory's or a Hub id's
model with it), so a Hub id is refused with a reason.
"""

import importlib
import json

import pytest

import jax.numpy as jnp

from accelerate_tpu.big_modeling import init_empty_weights as jax_init_empty_weights
from accelerate_tpu.commands import estimate as jest
from accelerate_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from accelerate_tpu.utils import modeling as jmod
from accelerate_tpu_torch.commands import estimate as pest
from accelerate_tpu_torch.commands.accelerate_cli import get_command_parser
from accelerate_tpu_torch.models import MODEL_REGISTRY

DTYPES = ["float32", "bf16", "int8", "int4"]
NAMED = sorted(set(MODEL_REGISTRY) & set(JAX_REGISTRY))


class _Args:
    def __init__(self, model_name, dtypes=DTYPES):
        self.model_name = model_name
        self.dtypes = list(dtypes)
        self.trust_remote_code = False


def _jax_sizes(name):
    from accelerate_tpu.models import get_model_family
    from accelerate_tpu.utils.dataclasses import CustomDtype

    family, config = get_model_family(name)
    module = {
        "llama": "LlamaForCausalLM", "bert": "BertForSequenceClassification", "gptj": "GPTJForCausalLM",
        "gpt_neox": "GPTNeoXForCausalLM", "opt": "OPTForCausalLM", "t5": "T5ForConditionalGeneration",
        "mixtral": "MixtralForCausalLM",
    }[family]
    cls = getattr(importlib.import_module(f"accelerate_tpu.models.{family}"), module)
    sample = [jnp.zeros((1, 8), jnp.int32)] * (2 if family == "t5" else 1)
    tree = jax_init_empty_weights(cls(config), *sample)
    counts = jmod.compute_module_sizes(tree, dtype=CustomDtype.INT8)
    _, (_, largest_name) = jmod.calculate_maximum_sizes(tree)
    return counts[""], counts[largest_name]


@pytest.mark.parametrize("name", NAMED)
def test_named_table_equals_jax_size_accounting(name):
    total, largest = _jax_sizes(name)
    got_total, rows = pest.gather_data(_Args(name))
    assert got_total == total
    per = pest.DTYPE_BYTES
    assert rows == [{"dtype": d, "largest_layer": largest * per[d], "total_size": total * per[d],
                     "training_size": total * per[d] * 4} for d in DTYPES]
    assert pest.in_tree_sizes(name.replace("-", "_")) == (total, largest)


def test_jax_closed_form_misses_parameters_of_in_tree_models():
    """ROADMAP C: JAX's `estimate-memory` counts an in-tree name in closed
    form. For OPT-30B it leaves out the learned positions and the biases;
    for Mixtral it counts one expert's MLP; the port counts the model."""
    jax_total, _ = jest.gather_data(_Args("opt-30b"))
    port_total, _ = pest.gather_data(_Args("opt-30b"))
    assert (jax_total, port_total) == (29_956_054_016, 29_974_540_288)
    assert pest.gather_data(_Args("mixtral-8x7b"))[0] > 6 * jest.gather_data(_Args("mixtral-8x7b"))[0]
    assert pest.gather_data(_Args("llama-1b"))[0] == jest.gather_data(_Args("llama-1b"))[0] == 1_498_482_688


def test_raw_config_json_takes_jax_closed_form(tmp_path):
    cfg = {"model_type": "llama", "vocab_size": 1024, "hidden_size": 128, "num_hidden_layers": 2,
           "intermediate_size": 256, "num_attention_heads": 4, "hidden_act": "silu", "tie_word_embeddings": True}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    assert pest.estimate_parameters_from_hf_config(cfg) == jest.estimate_parameters_from_hf_config(cfg)
    assert pest.gather_data(_Args(str(path)))[0] == jest.estimate_parameters_from_hf_config(cfg)[0]
    t5 = {"model_type": "t5", "vocab_size": 32128, "d_model": 2048, "d_kv": 64, "d_ff": 5120, "num_layers": 24,
          "num_decoder_layers": 24, "num_heads": 32, "is_encoder_decoder": True, "feed_forward_proj": "gated-gelu",
          "tie_word_embeddings": False}
    assert pest.estimate_parameters_from_hf_config(t5) == jest.estimate_parameters_from_hf_config(t5)


def test_config_directory_takes_the_closed_form_and_a_hub_id_is_refused(tmp_path):
    cfg = {"model_type": "gpt_neox", "vocab_size": 1000, "hidden_size": 64, "num_hidden_layers": 3,
           "intermediate_size": 256, "num_attention_heads": 4, "tie_word_embeddings": False}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    total, rows = pest.gather_data(_Args(str(tmp_path)))
    assert (total, rows[0]["largest_layer"] // 4) == jest.estimate_parameters_from_hf_config(cfg)
    with pytest.raises(RuntimeError, match="needs `transformers`"):
        pest.gather_data(_Args("some-org/some-model"))


def test_dispatcher_runs_estimate_memory_for_several_models(capsys):
    args = get_command_parser().parse_args(["estimate-memory", "opt_30b", "llama-1b", "--dtypes", "bf16", "int4"])
    out = args.func(args)
    printed = capsys.readouterr().out
    assert "`opt_30b` (29.97B params)" in printed and "`llama-1b` (1.50B params)" in printed
    assert out["opt_30b"][0]["total_size"] == 29_974_540_288 * 2 and out["llama-1b"][1]["dtype"] == "int4"
