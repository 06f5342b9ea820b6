"""The port's big-model inference (`accelerate_tpu_torch.big_modeling`,
`utils/modeling.py`'s size accounting and planner, the families'
`LayeredApply`) held to the JAX package on the same weights, at tiny sizes
on the CPU (about 40 s on two threads).

- The size accounting and the device maps: the port reads a module
  through its flax view, so its block names are JAX's paths and a map is
  compared to JAX's as a dict, item by item and in order, for several
  budgets, with `no_split_prefixes`, in bf16, and with a tied tensor.
- Streamed logits: each family's tiny model dispatched over host RAM,
  disk and a mixed map gives, bit for bit, the port's own resident
  logits (the stream runs the model's modules on the same tensors), and
  JAX's streamed logits on the carried weights within the tolerance the
  two packages' f32 logits hold everywhere in the port's tests, atol 1e-4
  (`tests/test_torch_llama.py`, `test_torch_families.py`,
  `test_torch_t5.py`: the same f32 operations summed in another order;
  JAX's `test_big_modeling` holds its stream to its own plain forward at
  1e-5, which the port's stream meets exactly).
- `generate` gives JAX's `DispatchedModel.generate` tokens exactly:
  greedy, a right-padded batch, per-row EOS, the left-padded refusal.
- `load_checkpoint_and_dispatch` reads the port's `save_model` output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.models import gpt_neox as jax_neox
from accelerate_tpu.models import gptj as jax_gptj
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.models import opt as jax_opt
from accelerate_tpu.models import t5 as jax_t5
from accelerate_tpu.utils import modeling as jmod
from accelerate_tpu_torch import big_modeling as bm
from accelerate_tpu_torch.models import (
    MODULE_BY_CONFIG,
    gpt_neox,
    gptj,
    layered_for_family,
    layered_for_model,
    llama,
    opt,
    t5,
)
from accelerate_tpu_torch.utils import modeling as pmod

ATOL = 1e-4

#: family -> (JAX create, JAX tiny config, JAX LayeredApply, port config, port carry, port LayeredApply)
FAMILIES = {
    "llama": (jax_llama.create_llama_model, jax_llama.llama_tiny, jax_llama.LlamaLayeredApply, llama.LlamaConfig,
              llama.llama_state_dict_from_flax, llama.LlamaLayeredApply),
    "opt": (jax_opt.create_opt_model, jax_opt.opt_tiny, jax_opt.OPTLayeredApply, opt.OPTConfig,
            opt.opt_state_dict_from_flax, opt.OPTLayeredApply),
    "gpt_neox": (jax_neox.create_gpt_neox_model, jax_neox.gpt_neox_tiny, jax_neox.GPTNeoXLayeredApply,
                 gpt_neox.GPTNeoXConfig, gpt_neox.gpt_neox_state_dict_from_flax, gpt_neox.GPTNeoXLayeredApply),
    "gptj": (jax_gptj.create_gptj_model, jax_gptj.gptj_tiny, jax_gptj.GPTJLayeredApply, gptj.GPTJConfig,
             gptj.gptj_state_dict_from_flax, gptj.GPTJLayeredApply),
    "t5": (jax_t5.create_t5_model, jax_t5.t5_tiny, jax_t5.T5LayeredApply, t5.T5Config, t5.t5_state_dict_from_flax,
           t5.T5LayeredApply),
}


@pytest.fixture(autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def perturbed(params, seed=0):
    """Every bias and norm scale moved by normal noise (std 0.1): JAX inits
    them at 0 and 1, which would hide one the stream dropped."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if path[-1].key in ("bias", "scale"):
            return (x + rng.normal(0.0, 0.1, x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


def port_config(family, jcfg):
    cls = FAMILIES[family][3]
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls) if hasattr(jcfg, f.name)})


def make_pair(family, **overrides):
    """(JAX Model bundle, port config, a function making a fresh port model
    on the same weights)."""
    jax_create, jax_tiny, _, _, carry, _ = FAMILIES[family]
    jcfg = dataclasses.replace(jax_tiny(), **overrides)
    jmodel = jax_create(jcfg, seq_len=16)
    params = perturbed(jmodel.params)
    jmodel = dataclasses.replace(jmodel, params=jax.tree_util.tree_map(jnp.asarray, params))
    cfg = port_config(family, jcfg)
    state = carry(params, cfg)

    def fresh():
        model = MODULE_BY_CONFIG[type(cfg)](cfg)
        model.load_state_dict(state)
        return model.eval()

    return jmodel, jcfg, cfg, fresh


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return (request.param, *make_pair(request.param))


def _ids(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)


def _inputs(name):
    ids = _ids(0, 2, 16)
    return (ids, _ids(1, 2, 8)) if name == "t5" else (ids,)


def _mixed_map(blocks):
    return {b: [0, "cpu", "disk"][i % 3] for i, b in enumerate(blocks)}


# ------------------------------------------------------------------ size accounting
def test_init_empty_weights_has_jax_eval_shape_tree(family):
    """The meta model's flax view: JAX's `init_empty_weights` tree, path for
    path, shape and dtype, with no storage."""
    name, jmodel, jcfg, cfg, _ = family
    sample = [jnp.zeros((1, 16), jnp.int32)] + ([jnp.zeros((1, 8), jnp.int32)] if name == "t5" else [])
    jshapes = jmod.named_parameter_shapes(jbm.init_empty_weights(jmodel.module, *sample))
    empty = bm.init_empty_weights(cfg)
    assert all(p.is_meta for p in empty.parameters())
    pshapes = pmod.named_parameter_shapes(empty)
    assert list(pshapes) == list(jshapes)
    assert [(s, str(d).replace("torch.", "")) for s, d in pshapes.values()] == \
        [(tuple(s), str(d)) for s, d in jshapes.values()]


def test_sizes_blocks_and_maxima_equal_jax(family):
    name, jmodel, _, _, fresh = family
    model = fresh()
    assert pmod.compute_module_sizes(model) == jmod.compute_module_sizes(jmodel.params)
    assert pmod.compute_module_sizes(model, dtype=torch.bfloat16) == jmod.compute_module_sizes(
        jmodel.params, dtype=jnp.dtype(jnp.bfloat16))
    assert pmod.group_into_blocks(model) == jmod.group_into_blocks(jmodel.params)
    assert pmod.calculate_maximum_sizes(model) == jmod.calculate_maximum_sizes(jmodel.params)
    budgets = {0: 300_000, 1: 10**9, "cpu": 10**9, "disk": float("inf")}
    assert pmod.get_balanced_memory(model, budgets) == jmod.get_balanced_memory(jmodel.params, budgets)
    assert pmod.get_balanced_memory(model, budgets, low_zero=True) == jmod.get_balanced_memory(
        jmodel.params, budgets, low_zero=True)


def _budgets(sizes):
    layer, embed = sizes["params/layer_0"] if "params/layer_0" in sizes else sizes["params/enc_blocks_0"], 0
    embed = max(v for k, v in sizes.items() if k.count("/") == 1)
    return [
        {0: float("inf"), "cpu": float("inf"), "disk": float("inf")},
        {0: embed + 2 * layer + 1024, "cpu": layer + 1024, "disk": float("inf")},
        {0: 3 * embed, "cpu": 2 * layer},
        {0: "1KB", "cpu": "300KB"},
        {0: 0, "cpu": 0, "disk": 0},
    ]


def test_device_maps_equal_jax(family):
    """For several budgets, in f32 and bf16, and with a no-split prefix
    below a layer: the same blocks on the same tiers in the same order."""
    name, jmodel, _, _, fresh = family
    model = fresh()
    first = next(b for b in jmod.group_into_blocks(jmodel.params) if "_0" in b)
    nsp = [first + "/" + sorted({p.split("/")[2] for p in jmod.group_into_blocks(jmodel.params)[first]})[0]]
    for budget in _budgets(jmod.compute_module_sizes(jmodel.params)):
        for dtype, jdtype in ((None, None), (torch.bfloat16, jnp.dtype(jnp.bfloat16))):
            for split in (None, nsp):
                got = pmod.infer_auto_device_map(model, budget, no_split_prefixes=split, dtype=dtype)
                want = jmod.infer_auto_device_map(jmodel.params, budget, no_split_prefixes=split, dtype=jdtype)
                assert list(got.items()) == list(want.items()), (budget, dtype, split)
                assert pmod.clean_device_map(got) == jmod.clean_device_map(want)


def test_tied_tensor_lands_with_its_first_block():
    """A parameter two modules share (NeoX's head tied to its embedding)
    is one tied group on both sides: its second block goes where the first
    went, whatever the budget says."""
    jmodel, _, _, fresh = make_pair("gpt_neox")
    model = fresh()
    model.embed_out.weight = model.embed_in.weight
    params = jax.tree_util.tree_map(lambda x: x, jmodel.params)
    params["params"]["embed_out"]["kernel"] = params["params"]["embed_in"]["embedding"]
    assert pmod.find_tied_parameters(model) == jmod.find_tied_parameters(params) == [
        ["params/embed_in/embedding", "params/embed_out/kernel"]]
    sizes = jmod.compute_module_sizes(params)
    budget = {0: sizes["params/embed_in"] + sizes["params/layer_0"] + 1, "cpu": 10**9}
    got, want = pmod.infer_auto_device_map(model, budget), jmod.infer_auto_device_map(params, budget)
    assert list(got.items()) == list(want.items())
    assert got["params/embed_out"] == got["params/embed_in"] == 0
    # Untied, the head would not fit beside the embedding.
    assert pmod.infer_auto_device_map(fresh(), budget)["params/embed_out"] == "cpu"


def test_memory_strings_dtypes_and_probe():
    assert pmod.parse_memory_string("1KB") == jmod.parse_memory_string("1KB") == 1000
    assert pmod.parse_memory_string("1KiB") == 1024
    assert pmod.parse_memory_string("2.5GB") == jmod.parse_memory_string("2.5GB") == 2_500_000_000
    from accelerate_tpu.utils.dataclasses import CustomDtype as JaxCustomDtype
    from accelerate_tpu_torch.utils.dataclasses import CustomDtype

    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        assert pmod.dtype_byte_size(dtype) == jmod.dtype_byte_size(jnp.dtype(jdtype))
    assert pmod.dtype_byte_size(CustomDtype.INT4) == jmod.dtype_byte_size(JaxCustomDtype.INT4) == 0.5
    probed = pmod.get_max_memory()
    assert list(probed) == [0, "cpu", "disk"] and probed["disk"] == float("inf") and 0 < probed[0] < probed["cpu"]


# ------------------------------------------------------------------ the stream
def _jax_dispatch(jmodel, layered_cls, jcfg, mode, tmp_path):
    layered = layered_cls(jcfg)
    if mode == "cpu":
        return jbm.cpu_offload(jmodel, layered)
    if mode == "disk":
        return jbm.disk_offload(jmodel, str(tmp_path / "jax"), layered)
    return jbm.dispatch_model(jmodel, _mixed_map(jmod.group_into_blocks(jmodel.params)),
                              offload_folder=str(tmp_path / "jax"), layered=layered)


def _port_dispatch(model, layered, mode, tmp_path):
    if mode == "cpu":
        return bm.cpu_offload(model, layered, device="cpu")
    if mode == "disk":
        return bm.disk_offload(model, str(tmp_path / "port"), layered, device="cpu")
    return bm.dispatch_model(model, _mixed_map(pmod.group_into_blocks(model)), offload_folder=str(tmp_path / "port"),
                             layered=layered, device="cpu")


@pytest.mark.parametrize("mode", ["cpu", "disk", "mixed"])
def test_streamed_logits_equal_resident_and_jax(family, mode, tmp_path):
    name, jmodel, jcfg, cfg, fresh = family
    inputs = _inputs(name)
    torch_inputs = [torch.as_tensor(x).long() for x in inputs]
    with torch.no_grad():
        resident = fresh()(*torch_inputs)
    layered = FAMILIES[name][5](cfg)
    dm = _port_dispatch(fresh(), layered, mode, tmp_path)
    got = dm(*torch_inputs)
    assert torch.equal(got, resident)
    assert all(p.is_meta for p in dm.module.parameters()) == (mode != "mixed")
    assert dm.resident_fraction == _jax_dispatch(jmodel, FAMILIES[name][2], jcfg, mode, tmp_path).resident_fraction
    expect = np.asarray(_jax_dispatch(jmodel, FAMILIES[name][2], jcfg, mode, tmp_path / "again")(*inputs))
    np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pattern", [("disk", 0, "cpu", "cpu", 0, 0, "disk"), ("cpu",) * 7, (0, 0, 0, 0, 0, 0, "disk")])
def test_stream_looks_ahead_over_resident_layers(pattern, tmp_path):
    """Seven layers, the moved ones apart and together: each moved layer's
    copy is issued two moved layers ahead, its disk read three, through
    the slots in turn; the logits stay the resident ones bit for bit and
    JAX's stream's within atol 1e-4."""
    jmodel, jcfg, cfg, fresh = make_pair("llama", num_hidden_layers=7)
    device_map = {"params/embed_tokens": 0, "params/final_norm": 0, "params/lm_head": "cpu",
                  **{f"params/layer_{i}": tier for i, tier in enumerate(pattern)}}
    ids = _ids(12, 2, 16)
    dm = bm.dispatch_model(fresh(), device_map, offload_folder=str(tmp_path / "port"),
                           layered=llama.LlamaLayeredApply(cfg), device="cpu")
    got = dm(torch.as_tensor(ids).long())
    assert torch.equal(got, fresh()(torch.as_tensor(ids).long()))
    assert torch.equal(dm(torch.as_tensor(ids).long()), got)  # the slots reused by a second call
    jdm = jbm.dispatch_model(jmodel, device_map, offload_folder=str(tmp_path / "jax"),
                             layered=jax_llama.LlamaLayeredApply(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdm(ids)), atol=ATOL, rtol=0)


def test_layered_split_join_and_lookup(family):
    """`split` then `join` gives every tensor back under its name; OPT's
    tail holds the prelude's embedding itself; the registry builds the
    decoder families' decomposition by family and by module."""
    name, _, _, cfg, fresh = family
    model = fresh()
    params = dict(model.named_parameters())
    layered = FAMILIES[name][5](cfg)
    prelude, layers, tail = layered.split(params)
    assert len(layers) == (cfg.num_layers + cfg.num_decoder_layers if name == "t5" else cfg.num_hidden_layers)
    assert {k: id(v) for k, v in layered.join(prelude, layers, tail).items()} == {k: id(v) for k, v in params.items()}
    if name == "opt":
        assert tail["embed_tokens.weight"] is prelude["embed_tokens.weight"]
    if name == "t5":
        with pytest.raises(ValueError, match="No LayeredApply"):
            layered_for_model(model)
        with pytest.raises(NotImplementedError, match="tie_word_embeddings"):
            t5.T5LayeredApply(dataclasses.replace(cfg, tie_word_embeddings=True))
    else:
        assert type(layered_for_model(model)) is type(layered)
        assert type(layered_for_family(name, cfg)) is type(layered)


def test_tied_llama_streams_the_embedding_once(tmp_path):
    """A tied Llama's tail reads the prelude's embedding; streamed logits
    equal the resident and JAX's."""
    jmodel, jcfg, cfg, fresh = make_pair("llama", tie_word_embeddings=True)
    ids = _ids(3, 2, 8)
    dm = bm.dispatch_model(fresh(), {"params/embed_tokens": "disk", "params/final_norm": "cpu",
                                     "params/layer_0": 0, "params/layer_1": "disk"},
                           offload_folder=str(tmp_path), layered=llama.LlamaLayeredApply(cfg), device="cpu")
    got = dm(torch.as_tensor(ids).long())
    assert torch.equal(got, fresh()(torch.as_tensor(ids).long()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.apply_fn(jmodel.params, ids)), atol=ATOL, rtol=0)


def test_all_resident_is_the_plain_forward_and_needs_no_layered():
    jmodel, _, cfg, fresh = make_pair("llama")
    ids = _ids(4, 2, 16)
    dm = bm.dispatch_model(fresh(), {"": 0}, device="cpu")
    assert dm.resident_fraction == 1.0 and dm.hf_device_map == {"": 0}
    np.testing.assert_allclose(dm(torch.as_tensor(ids).long()).numpy(),
                               np.asarray(jmodel.apply_fn(jmodel.params, ids)), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="concrete device_map"):
        bm.dispatch_model(fresh(), "auto", device="cpu")


def test_without_layered_the_offloaded_model_materializes(tmp_path):
    _, _, _, fresh = make_pair("opt")
    ids = torch.as_tensor(_ids(5, 1, 16)).long()
    want = fresh()(ids)
    dm = bm.disk_offload(fresh(), str(tmp_path), device="cpu")
    assert torch.equal(dm(ids), want)
    state = dm.materialize_params()
    assert all(torch.equal(state[k], v) for k, v in fresh().state_dict().items())


def test_compute_dtype_casts_floating_tensors_on_every_tier(tmp_path):
    _, _, _, fresh = make_pair("llama")
    ids = torch.as_tensor(_ids(6, 1, 16)).long()
    model = fresh().to(torch.bfloat16)
    with torch.no_grad():
        want = model(ids)
    blocks = pmod.group_into_blocks(fresh())
    dm = bm.dispatch_model(fresh(), _mixed_map(blocks), offload_folder=str(tmp_path),
                           layered=llama.LlamaLayeredApply(llama.LlamaConfig(**vars(fresh().config))),
                           dtype=torch.bfloat16, device="cpu")
    assert {t.dtype for t in dm.materialize_params().values()} == {torch.bfloat16}
    assert torch.equal(dm(ids), want)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    _, _, _, fresh = make_pair("llama")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bm.cpu_offload(fresh())


# ------------------------------------------------------------------ generate
@pytest.fixture(scope="module")
def llama_pair():
    jmodel, jcfg, cfg, fresh = make_pair("llama")
    jdm = jbm.cpu_offload(jmodel, jax_llama.LlamaLayeredApply(jcfg))
    pdm = bm.cpu_offload(fresh(), llama.LlamaLayeredApply(cfg), device="cpu")
    return jdm, pdm


def test_generate_tokens_equal_jax(llama_pair):
    jdm, pdm = llama_pair
    prompt = _ids(7, 2, 5)
    want = np.asarray(jdm.generate(prompt, max_new_tokens=6))
    got = pdm.generate(prompt, max_new_tokens=6)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pdm.generate(prompt, max_new_tokens=0).numpy(), prompt)


def test_generate_right_padded_batch_equals_jax(llama_pair):
    jdm, pdm = llama_pair
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, n in enumerate((7, 4, 1)):
        batch[row, :n] = _ids(10 + row, 1, n)[0]
        mask[row, :n] = 1
    want = np.asarray(jdm.generate(batch, max_new_tokens=3, attention_mask=mask))
    got = pdm.generate(batch, max_new_tokens=3, attention_mask=mask)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_per_row_equals_jax(llama_pair):
    jdm, pdm = llama_pair
    prompt = _ids(8, 2, 5)
    first = np.asarray(jdm.generate(prompt, max_new_tokens=2))[:, 5:]
    for eos in (int(first[0, 0]), int(first[1, 1])):
        want = np.asarray(jdm.generate(prompt, max_new_tokens=6, eos_token_id=eos))
        np.testing.assert_array_equal(pdm.generate(prompt, max_new_tokens=6, eos_token_id=eos).numpy(), want)


def test_generate_refuses_a_left_padded_mask(llama_pair):
    _, pdm = llama_pair
    with pytest.raises(ValueError, match="right-padded"):
        pdm.generate(np.ones((1, 6), np.int32), max_new_tokens=2,
                     attention_mask=np.array([[0, 0, 1, 1, 1, 1]], np.int32))


# ------------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("device_map", ["auto", "sequential"])
def test_load_checkpoint_and_dispatch_reads_the_ports_save_model(device_map, tmp_path):
    """`save_model`'s shards, loaded onto an empty model and dispatched over
    the card's stand-in, host RAM and disk: the resident logits bit for
    bit, JAX's within atol 1e-4."""
    from accelerate_tpu_torch.checkpointing import save_model_safetensors

    jmodel, _, cfg, fresh = make_pair("llama")
    ids = _ids(9, 2, 16)
    model = fresh()
    save_model_safetensors(model, str(tmp_path / "ckpt"), max_shard_size="100KB")
    sizes = pmod.compute_module_sizes(model)
    largest = pmod.calculate_maximum_sizes(model)[1][0]
    budget = {0: sizes["params/embed_tokens"] + sizes["params/final_norm"] + largest, "cpu": sizes["params/layer_0"]}
    dm = bm.load_checkpoint_and_dispatch(bm.init_empty_weights(cfg), checkpoint=str(tmp_path / "ckpt"),
                                         device_map=device_map, max_memory=budget,
                                         offload_folder=str(tmp_path / "offload"),
                                         layered=llama.LlamaLayeredApply(cfg), device="cpu")
    assert set(dm.hf_device_map.values()) == {0, "cpu", "disk"}
    want = jmod.infer_auto_device_map(jmodel.params, budget)
    assert list(dm.hf_device_map.items()) == list(jmod.clean_device_map(want).items())
    got = dm(torch.as_tensor(ids).long())
    assert torch.equal(got, model(torch.as_tensor(ids).long()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.apply_fn(jmodel.params, ids)), atol=ATOL, rtol=0)
