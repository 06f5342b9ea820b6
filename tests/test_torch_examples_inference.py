"""The port's twins of `examples/inference/distributed_inference.py` and
`quantized_inference.py`, each held to the JAX script on the CPU in
process, from JAX's initial llama-tiny weights carried across: the printed
lines equal, and the generated tokens exactly (greedy, f32 on both
sides), and from a local HF checkpoint. About 20 s.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_cv_example import _load, _reset, reset_state  # noqa: E402,F401  (reset_state: a fixture)

from accelerate_tpu.models import llama as jax_llama  # noqa: E402
from accelerate_tpu_torch.examples.inference import distributed_inference as twin_dist  # noqa: E402
from accelerate_tpu_torch.examples.inference import quantized_inference as twin_quant  # noqa: E402
from accelerate_tpu_torch.models import llama as port_llama  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def llama_params():
    model = jax_llama.create_llama_model(jax_llama.llama_tiny(), seq_len=24)
    return jax.tree_util.tree_map(np.asarray, model.params)


def _llama_from_jax(params):
    def create(config=None, seed=0, dtype=torch.float32, device=None):
        model = port_llama.create_llama_model(config, device=device)
        model.load_state_dict(port_llama.llama_state_dict_from_flax(params, config))
        return model

    return create


def test_distributed_inference_twin_generates_the_jax_scripts_tokens(monkeypatch, capsys, llama_params):
    """`tests/test_examples.py`'s run (4 prompts of 16, 8 new tokens) at
    one process: the same line, whose first completion's tokens it prints."""
    module = _load("inference/distributed_inference.py", "jax_distributed_inference")
    module.main(argparse.Namespace(checkpoint=None, num_prompts=4, prompt_len=16, max_new_tokens=8))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_dist, "create_llama_model", _llama_from_jax(llama_params))
    _reset()
    completions = twin_dist.main(twin_dist.parse_args(
        ["--cpu", "--num_prompts", "4", "--prompt_len", "16", "--max_new_tokens", "8"]))
    got = capsys.readouterr().out
    assert got == expect and "completions across 1 process(es)" in got
    assert len(completions) == 4 and all(len(c) == 8 for c in completions)


@pytest.mark.parametrize("argv", [["--bits", "8"], ["--bits", "4", "--quant_type", "nf4"],
                                  ["--bits", "4", "--quant_type", "int4"]], ids=["int8", "nf4", "int4"])
def test_quantized_inference_twin_matches_the_jax_script(monkeypatch, capsys, llama_params, argv):
    """The footprint line and the generated tokens of JAX's script, at each
    kind of code (f32 compute on both sides)."""
    module = _load("inference/quantized_inference.py", "jax_quantized_inference")
    generated = []

    class Recording(module.Generator):
        def __call__(self, *args, **kwargs):
            out = super().__call__(*args, **kwargs)
            generated.append(np.asarray(out))
            return out

    monkeypatch.setattr(module, "Generator", Recording)
    args = twin_quant.parse_args(argv)
    module.main(argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "cpu"}))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_quant, "create_llama_model", _llama_from_jax(llama_params))
    out = twin_quant.main(twin_quant.parse_args(["--cpu", *argv]))
    got = capsys.readouterr().out
    assert got == expect and "at the quantized footprint" in got
    np.testing.assert_array_equal(out.numpy(), generated[0])


def test_distributed_inference_twin_loads_a_local_hf_checkpoint(tmp_path, monkeypatch, capsys, llama_params):
    """``--checkpoint DIR`` (an HF ``config.json`` and safetensors file)
    goes through `load_hf_checkpoint_in_model`: the twin's random draw is
    replaced by the checkpoint's weights, JAX's here, so its completions are
    the carried model's."""
    import json

    from accelerate_tpu_torch.utils.hf_loading import save_hf_checkpoint

    cfg = port_llama.llama_tiny()
    model = _llama_from_jax(llama_params)(cfg, device="cpu")
    save_hf_checkpoint(model, "llama", cfg, str(tmp_path / "model.safetensors"))
    keys = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "max_position_embeddings", "rope_theta")
    (tmp_path / "config.json").write_text(json.dumps({k: getattr(cfg, k) for k in keys}))
    argv = ["--cpu", "--num_prompts", "4", "--prompt_len", "16", "--max_new_tokens", "8"]
    loaded = twin_dist.main(twin_dist.parse_args([*argv, "--checkpoint", str(tmp_path)]))
    monkeypatch.setattr(twin_dist, "create_llama_model", _llama_from_jax(llama_params))
    _reset()
    carried = twin_dist.main(twin_dist.parse_args(argv))
    capsys.readouterr()
    assert loaded == carried
