"""The port's HF checkpoint interchange (`accelerate_tpu_torch.utils.hf_loading`,
with the safetensors reader and writer of `accelerate_tpu_torch.utils.modeling`)
held against the `safetensors` package, the JAX package's
`accelerate_tpu.utils.hf_loading` and `transformers`' own models.

  - The port's safetensors files read back through the package bit for bit,
    and the package's through the port, in F32, F16, BF16, I8 and I64; a
    file the JAX package wrote from bf16 params (real BF16, and the older
    U16 form it records in metadata) loads as bf16 with the same bits.
  - Per family (Llama, Mixtral, GPT-J, GPT-NeoX, OPT, T5 v1.1 and v1.0), on the state
    dict of a random `transformers` model built in memory from a config
    (nothing downloads): the port's `convert_hf_state_dict` equals, tensor
    for tensor and bit for bit, the family's ``*_state_dict_from_flax``
    applied to JAX's `convert_hf_state_dict` of the same dict; the port's
    `export_hf_state_dict` equals JAX's key for key on those weights.
  - f32 logits of the loaded port model match the `transformers` forward
    within rtol/atol 2e-4, JAX's own limit for the same check
    (`tests/test_hf_loading.py`, `test_gpt_neox_opt.py`, `test_gptj.py`),
    at JAX's configs. HF's Mixtral is dropless, so its case sets the port's
    capacity factor to E / top_k, where no choice is dropped.
  - Round trips through one safetensors file, a torch ``.bin`` and sharded
    safetensors and ``.bin`` indexes give the same state bit for bit.
  - A tied head distinct from the embedding is refused; a tied view equal
    to it is accepted; a bf16 model keeps its dtype through the load.

About 20 s on one CPU thread.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from accelerate_tpu.utils import hf_loading as jax_hf
from accelerate_tpu_torch.models import gpt_neox, gptj, llama, mixtral, opt, t5
from accelerate_tpu_torch.utils import hf_loading as port_hf
from accelerate_tpu_torch.utils.modeling import load_safetensors_state_dict, save_safetensors

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ safetensors
DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int64]


def _tensors(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        make = lambda *shape: (torch.randn(shape, generator=gen) * 3).to(dtype)  # noqa: E731
    else:
        info = torch.iinfo(dtype)
        make = lambda *shape: torch.randint(max(info.min, -2**40), min(info.max, 2**40), shape,  # noqa: E731
                                            generator=gen, dtype=torch.int64).to(dtype)
    return {"a.weight": make(5, 7), "b": make(3), "c.scalar": make(), "d.empty": make(0, 4), "e": make(2, 3, 4)}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).replace("torch.", ""))
def test_safetensors_round_trips_through_the_package_both_ways(tmp_path, dtype):
    tensors = _tensors(dtype)
    mine, theirs = str(tmp_path / "mine.safetensors"), str(tmp_path / "theirs.safetensors")
    save_safetensors(tensors, mine, metadata={"format": "pt"})
    safetensors_torch.save_file(tensors, theirs, metadata={"format": "pt"})
    from safetensors import safe_open

    with safe_open(mine, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    for path in (mine, theirs):
        for loaded in (safetensors_torch.load_file(path), load_safetensors_state_dict(path)):
            assert sorted(loaded) == sorted(tensors)
            for name, t in tensors.items():
                assert loaded[name].dtype == dtype and loaded[name].shape == t.shape
                assert torch.equal(loaded[name], t), (path, name)


def test_safetensors_reader_keeps_the_file_dtype_and_maps_the_file(tmp_path):
    """No f32 copy: bf16 comes back as bf16, and the tensors are views of
    one mapping of the file (writing to one never reaches the file)."""
    path = str(tmp_path / "m.safetensors")
    save_safetensors({"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4), "x": torch.ones(2)}, path)
    loaded = load_safetensors_state_dict(path)
    assert loaded["w"].dtype == torch.bfloat16
    assert loaded["w"].untyped_storage().data_ptr() == loaded["x"].untyped_storage().data_ptr()
    loaded["w"].zero_()
    assert torch.equal(load_safetensors_state_dict(path)["w"], torch.arange(12, dtype=torch.bfloat16).reshape(3, 4))


def _jax_llama():
    from accelerate_tpu.models.llama import LlamaConfig, create_llama_model

    cfg = LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0)
    return cfg, create_llama_model(cfg, seq_len=16)


def test_jax_written_bf16_file_loads_as_bf16_with_equal_bits(tmp_path):
    import ml_dtypes
    from safetensors.numpy import save_file

    cfg, model = _jax_llama()
    params = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16), model.params)
    flat = jax_hf.export_hf_state_dict(params, "llama", cfg)
    path = str(tmp_path / "model.safetensors")
    jax_hf.save_hf_checkpoint(params, "llama", cfg, path)
    # The older writer's form: U16 views listed under `bfloat16_as_uint16`.
    old = str(tmp_path / "old.safetensors")
    save_file({k: v.view(np.uint16) for k, v in flat.items()}, old,
              metadata={"bfloat16_as_uint16": ",".join(flat)})
    for p in (path, old):
        loaded = port_hf.load_hf_state_dict(p)
        assert sorted(loaded) == sorted(flat)
        for name, v in flat.items():
            assert loaded[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(loaded[name].view(torch.int16).numpy(), v.view(np.int16))


# ----------------------------------------------------------------------- families
def _port_config(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _llama_case():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attn_implementation="eager",
    )
    jcfg, _ = _jax_llama()
    return (transformers.LlamaForCausalLM, hf_cfg, jcfg, _port_config(llama.LlamaConfig, jcfg),
            llama.create_llama_model, llama.llama_state_dict_from_flax, 128)


def _mixtral_case():
    from accelerate_tpu.models.mixtral import mixtral_tiny

    hf_cfg = transformers.MixtralConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False, router_jitter_noise=0.0,
        attn_implementation="eager",
    )
    tiny = mixtral_tiny()
    # HF routes without a capacity: at E / top_k slots per even share none is dropped.
    jcfg = dataclasses.replace(tiny, capacity_factor=tiny.num_local_experts / tiny.num_experts_per_tok)
    return (transformers.MixtralForCausalLM, hf_cfg, jcfg, _port_config(mixtral.MixtralConfig, jcfg),
            mixtral.create_mixtral_model, mixtral.mixtral_state_dict_from_flax, 512)


def _gptj_case():
    from accelerate_tpu.models.gptj import gptj_tiny

    hf_cfg = transformers.GPTJConfig(
        vocab_size=512, n_embd=128, n_inner=256, n_layer=2, n_head=4, rotary_dim=16, n_positions=256,
        layer_norm_epsilon=1e-5, attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0, tie_word_embeddings=False,
    )
    jcfg = gptj_tiny()
    return (transformers.GPTJForCausalLM, hf_cfg, jcfg, _port_config(gptj.GPTJConfig, jcfg),
            gptj.create_gptj_model, gptj.gptj_state_dict_from_flax, 512)


def _gpt_neox_case():
    from accelerate_tpu.models.gpt_neox import gpt_neox_tiny

    hf_cfg = transformers.GPTNeoXConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
        rotary_pct=0.25, max_position_embeddings=256, use_parallel_residual=True, layer_norm_eps=1e-5,
        hidden_dropout=0.0, attention_dropout=0.0, tie_word_embeddings=False,
    )
    jcfg = gpt_neox_tiny()
    return (transformers.GPTNeoXForCausalLM, hf_cfg, jcfg, _port_config(gpt_neox.GPTNeoXConfig, jcfg),
            gpt_neox.create_gpt_neox_model, gpt_neox.gpt_neox_state_dict_from_flax, 512)


def _opt_case():
    from accelerate_tpu.models.opt import opt_tiny

    hf_cfg = transformers.OPTConfig(
        vocab_size=512, hidden_size=128, ffn_dim=256, num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=256, do_layer_norm_before=True, dropout=0.0, attention_dropout=0.0,
        activation_function="relu", word_embed_proj_dim=128, tie_word_embeddings=True,
    )
    jcfg = opt_tiny()
    return (transformers.OPTForCausalLM, hf_cfg, jcfg, _port_config(opt.OPTConfig, jcfg),
            opt.create_opt_model, opt.opt_state_dict_from_flax, 512)


def _t5_case(v1_0):
    from accelerate_tpu.models.t5 import t5_tiny, t5_tiny_v1_0

    hf_cfg = transformers.T5Config(
        vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_decoder_layers=2, num_heads=4,
        relative_attention_num_buckets=32, relative_attention_max_distance=128, dropout_rate=0.0,
        layer_norm_epsilon=1e-6, feed_forward_proj="relu" if v1_0 else "gated-gelu", tie_word_embeddings=v1_0,
    )
    jcfg = t5_tiny_v1_0() if v1_0 else t5_tiny()
    return (transformers.T5ForConditionalGeneration, hf_cfg, jcfg, _port_config(t5.T5Config, jcfg),
            t5.create_t5_model, t5.t5_state_dict_from_flax, 512)


CASES = {
    "llama": _llama_case,
    "mixtral": _mixtral_case,
    "gptj": _gptj_case,
    "gpt_neox": _gpt_neox_case,
    "opt": _opt_case,
    "t5": lambda: _t5_case(False),
    "t5_v1_0": lambda: _t5_case(True),
}


def _hf_model(case, seed=0):
    cls, hf_cfg = case[:2]
    torch.manual_seed(seed)
    return cls(hf_cfg).eval()


@pytest.fixture(scope="module", params=sorted(CASES))
def family(request):
    name = request.param
    case = CASES[name]()
    hf_model = _hf_model(case)
    flat = {k: v.detach().clone() for k, v in hf_model.state_dict().items()}
    return name, name.split("_v1")[0], case, hf_model, flat


def test_conversion_equals_jax_exactly(family):
    """The port's HF -> state_dict equals JAX's HF -> flax tree carried
    across with the family's ``*_state_dict_from_flax``, bit for bit."""
    _, model_type, (_, _, jcfg, cfg, _, carry, _), _, flat = family
    jax_tree = jax_hf.convert_hf_state_dict({k: v.numpy() for k, v in flat.items()}, model_type, jcfg)
    expect = carry(jax.tree_util.tree_map(np.asarray, jax_tree), cfg)
    got = port_hf.convert_hf_state_dict(flat, model_type, cfg)
    assert sorted(got) == sorted(expect)
    for name, t in expect.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def test_export_equals_jax_key_for_key(family):
    _, model_type, (_, _, jcfg, cfg, create, _, _), _, flat = family
    jax_tree = jax_hf.convert_hf_state_dict({k: v.numpy() for k, v in flat.items()}, model_type, jcfg)
    expect = jax_hf.export_hf_state_dict(jax_tree, model_type, jcfg)
    model = create(cfg, device="cpu")
    model.load_state_dict(port_hf.convert_hf_state_dict(flat, model_type, cfg))
    got = port_hf.export_hf_state_dict(model, model_type, cfg)
    assert sorted(got) == sorted(expect)
    for name, v in expect.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), v, err_msg=name)


def _inputs(name, vocab):
    rng = np.random.default_rng(3)
    if name.startswith("t5"):
        return (torch.from_numpy(rng.integers(1, vocab, (2, 12))), torch.from_numpy(rng.integers(1, vocab, (2, 6))))
    return (torch.from_numpy(rng.integers(1, vocab, (2, 16))),)


def test_logits_match_transformers(family):
    """The loaded port model's f32 logits against the `transformers`
    forward on the same ids (T5 is held so in `test_torch_t5.py` too)."""
    name, model_type, (_, _, _, cfg, create, _, vocab), hf_model, flat = family
    model = create(cfg, seed=7, device="cpu")
    model.load_state_dict(port_hf.convert_hf_state_dict(flat, model_type, cfg))
    args = _inputs(name, vocab)
    with torch.no_grad():
        if name.startswith("t5"):
            ref = hf_model(input_ids=args[0], decoder_input_ids=args[1]).logits
        else:
            ref = hf_model(args[0]).logits
        got = model(*args)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def _write_sharded(state, directory, kind):
    keys = sorted(state)
    half = len(keys) // 2
    shards = {f"model-0000{i + 1}.{kind}": part for i, part in enumerate((keys[:half], keys[half:]))}
    for shard, part in shards.items():
        tensors = {k: state[k].contiguous() for k in part}
        if kind == "safetensors":
            save_safetensors(tensors, os.path.join(directory, shard))
        else:
            torch.save(tensors, os.path.join(directory, shard))
    index = "model.safetensors.index.json" if kind == "safetensors" else "pytorch_model.bin.index.json"
    with open(os.path.join(directory, index), "w") as f:
        json.dump({"weight_map": {k: shard for shard, part in shards.items() for k in part}}, f)


@pytest.mark.parametrize("layout", ["safetensors", "bin", "sharded_safetensors", "sharded_bin"])
def test_round_trips_keep_the_weights_bit_for_bit(family, tmp_path, layout):
    """save -> load into a model from another seed: the same state, bit for bit."""
    _, model_type, (_, _, _, cfg, create, _, _), _, flat = family
    model = create(cfg, device="cpu")
    model.load_state_dict(port_hf.convert_hf_state_dict(flat, model_type, cfg))
    if layout == "safetensors":
        path = str(tmp_path / "model.safetensors")
        port_hf.save_hf_checkpoint(model, model_type, cfg, path)
    else:
        exported = {k: v.clone() for k, v in port_hf.export_hf_state_dict(model, model_type, cfg).items()}
        path = str(tmp_path)
        if layout == "bin":
            torch.save(exported, tmp_path / "pytorch_model.bin")
        else:
            _write_sharded(exported, path, layout.split("_")[1])
    fresh = create(cfg, seed=11, device="cpu")
    port_hf.load_hf_checkpoint_in_model(fresh, path, model_type)
    want = model.state_dict()
    for name, t in fresh.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_bf16_model_keeps_its_dtype_through_the_load(tmp_path):
    case = _llama_case()
    cfg, create = case[3], case[4]
    flat = {k: v.detach() for k, v in _hf_model(case).state_dict().items()}
    path = str(tmp_path / "model.safetensors")
    save_safetensors(flat, path)
    model = create(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    port_hf.load_hf_checkpoint_in_model(model, path, "llama")
    for name, t in model.state_dict().items():
        assert t.dtype == torch.bfloat16, name
    assert torch.equal(model.layers[0].attention.wq.weight, flat["model.layers.0.self_attn.q_proj.weight"].bfloat16())
    port_hf.save_hf_checkpoint(model, "llama", cfg, path)
    assert all(v.dtype == torch.bfloat16 for v in load_safetensors_state_dict(path).values())


TIED = {
    "llama": (lambda: dataclasses.replace(_llama_case()[3], tie_word_embeddings=True), "model.embed_tokens.weight"),
    "opt": (lambda: _opt_case()[3], "model.decoder.embed_tokens.weight"),
    "t5": (lambda: _t5_case(True)[3], "shared.weight"),
}


@pytest.mark.parametrize("model_type", sorted(TIED))
def test_tied_head_distinct_from_the_embedding_is_refused(model_type):
    """JAX drops such a head without a word (ROADMAP C); the port refuses it
    and accepts a head that is absent or equal to the embedding."""
    make_cfg, embedding = TIED[model_type]
    cfg = make_cfg()
    case = {"llama": _llama_case, "opt": _opt_case, "t5": lambda: _t5_case(True)}[model_type]()
    flat = {k: v.detach().clone() for k, v in _hf_model(case).state_dict().items()}
    flat.pop("lm_head.weight", None)
    port_hf.convert_hf_state_dict(flat, model_type, cfg)  # absent: the head is the embedding
    flat["lm_head.weight"] = flat[embedding].clone()
    port_hf.convert_hf_state_dict(flat, model_type, cfg)  # equal: a tied view
    flat["lm_head.weight"][0, 0] += 1.0
    with pytest.raises(ValueError, match="distinct"):
        port_hf.convert_hf_state_dict(flat, model_type, cfg)


def test_unsupported_model_type_is_named():
    """A type neither package maps (BERT has no HF mapping in either) is
    refused by name, as JAX's is."""
    cfg = _llama_case()[3]
    with pytest.raises(ValueError, match="Unsupported model_type 'bert'"):
        jax_hf.convert_hf_state_dict({}, "bert", cfg)
    with pytest.raises(ValueError, match="Unsupported model_type 'bert'"):
        port_hf.convert_hf_state_dict({}, "bert", cfg)
    with pytest.raises(ValueError, match="Unsupported model_type 'bert'"):
        port_hf.export_hf_state_dict({}, "bert", cfg)
