"""The port's placement table (`accelerate_tpu_torch.parallel.sharding`)
held to the JAX package's `derive_param_shardings` and
`derive_opt_state_shardings` on each dense family's tiny config.

JAX places the flax params tree on its 8-device CPU mesh, ("data" 4,
"fsdp" 2); the port derives a torch dim per parameter for an "fsdp" axis
of 2, mapped back to the flax dim through the parameter's flax view. Every
flax path JAX places must be one the port names, and the two must agree on
every one: which dim shards over "fsdp", or none. The derivation is pure
given the mesh sizes, so nothing is spawned.
"""

import numpy as np
import optax
import pytest

from accelerate_tpu.models import create_named_model as jax_create_named_model
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh
from accelerate_tpu.parallel.sharding import derive_opt_state_shardings as jax_derive_opt_state_shardings
from accelerate_tpu.parallel.sharding import derive_param_shardings as jax_derive_param_shardings
from accelerate_tpu.parallel.sharding import tree_paths_and_leaves as jax_tree_paths_and_leaves
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxFSDPPlugin
from accelerate_tpu.utils.dataclasses import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu_torch.models import create_named_model
from accelerate_tpu_torch.parallel import sharding
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

FAMILIES = ["llama-tiny", "gpt-neox-tiny", "gptj-tiny", "opt-tiny", "bert-tiny", "t5-tiny"]

#: name -> plugin keyword arguments (one setting of each wrap knob and strategy).
PLUGINS = {
    "default": dict(),
    "min_num_params": dict(min_num_params=1000),
    "transformer_based_wrap": dict(auto_wrap_policy="TRANSFORMER_BASED_WRAP",
                                   transformer_cls_names_to_wrap=["layer_", "blocks_"]),
    "no_wrap": dict(auto_wrap_policy="NO_WRAP"),
    "shard_grad_op": dict(sharding_strategy="SHARD_GRAD_OP", min_num_params=1000),
    "hybrid_shard": dict(sharding_strategy="HYBRID_SHARD", auto_wrap_policy="NO_WRAP"),
    "no_shard": dict(sharding_strategy="NO_SHARD", auto_wrap_policy="NO_WRAP"),
}

MESH_SIZES = {"data": 4, "fsdp": 2}


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_build_mesh(JaxParallelismConfig(data=4, fsdp=2))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, JAX params tree, port module) for one family."""
    name = request.param
    return name, jax_create_named_model(name).params, create_named_model(name, device="cpu")


def _jax_specs(shardings) -> dict:
    flat, _ = jax_tree_paths_and_leaves(shardings)
    return {path: tuple(s.spec) for path, s in flat}


def _flax_dim(view, torch_dim):
    return None if torch_dim is None else view.torch_dims.index(torch_dim)


def _jax_dim(spec):
    return next((i for i, entry in enumerate(spec) if entry == "fsdp"), None)


def _check(views, placements, jax_specs, prefix=""):
    names = {prefix + v.path for v in views}
    assert names <= set(jax_specs), sorted(names - set(jax_specs))[:8]
    mismatched = {}
    for view in views:
        ours = _flax_dim(view, placements[view.name])
        theirs = _jax_dim(jax_specs[prefix + view.path])
        if ours != theirs:
            mismatched[view.path] = (ours, theirs)
    assert not mismatched, mismatched
    return sum(placements[v.name] is not None for v in views)


@pytest.mark.parametrize("setting", list(PLUGINS))
def test_param_placements_match_jax(family, jax_mesh, setting):
    name, params, module = family
    jax_plugin = JaxFSDPPlugin(**PLUGINS[setting])
    plugin = FullyShardedDataParallelPlugin(**PLUGINS[setting])
    views = sharding.flax_view(module)
    jax_specs = _jax_specs(jax_derive_param_shardings(params, jax_mesh, fsdp_plugin=jax_plugin))
    assert {v.path for v in views} == set(jax_specs)
    placements = sharding.derive_param_placements(module, MESH_SIZES, plugin)
    sharded = _check(views, placements, jax_specs)
    if setting in ("no_wrap", "hybrid_shard"):
        assert sharded > 0
    if setting in ("shard_grad_op", "no_shard"):
        assert sharded == 0


@pytest.mark.parametrize("setting", ["default", "min_num_params", "shard_grad_op", "no_shard"])
def test_opt_state_placements_match_jax(family, jax_mesh, setting):
    """The AdamW moments' placement: under SHARD_GRAD_OP the parameters stay
    replicated and the moments shard, as JAX's ZeRO-2."""
    name, params, module = family
    jax_plugin = JaxFSDPPlugin(**PLUGINS[setting])
    plugin = FullyShardedDataParallelPlugin(**PLUGINS[setting])
    opt_state = optax.adamw(1e-3).init(params)
    jax_specs = _jax_specs(jax_derive_opt_state_shardings(opt_state, jax_mesh, fsdp_plugin=jax_plugin))
    views = sharding.flax_view(module)
    placements = sharding.derive_opt_state_placements(module, MESH_SIZES, plugin)
    for moment in ("mu", "nu"):
        sharded = _check(views, placements, jax_specs, prefix=f"0/{moment}/")
    if setting == "shard_grad_op":
        assert sharded > 0
        assert not any(sharding.derive_param_placements(module, MESH_SIZES, plugin).values())
    if setting == "no_shard":
        assert sharded == 0


def test_shard_single_names_the_dim_the_table_would_use():
    """Over a one-member "fsdp" axis JAX's table is all replicated; with
    `shard_single` the port names the dim each parameter would shard on
    (a shard over one member is the whole tensor), which at "fsdp" 2 is
    the dim JAX shards."""
    module = create_named_model("llama-tiny", device="cpu")
    plugin = FullyShardedDataParallelPlugin(auto_wrap_policy="NO_WRAP")
    assert not any(sharding.derive_param_placements(module, {"fsdp": 1}, plugin).values())
    single = sharding.derive_param_placements(module, {"fsdp": 1}, plugin, shard_single=True)
    double = sharding.derive_param_placements(module, {"fsdp": 2}, plugin)
    assert single == double


def test_tree_paths_and_leaves_match_jax():
    tree = {"params": {"layer_0": {"w": np.zeros(2), "b": [np.ones(1), np.ones(3)]}}, "step": np.zeros(())}
    ours = [(p, np.shape(x)) for p, x in sharding.tree_paths_and_leaves(tree)]
    theirs = [(p, np.shape(x)) for p, x in jax_tree_paths_and_leaves(tree)[0]]
    assert sorted(ours) == sorted(theirs)


def test_data_spec_splits_the_batch_over_both_data_axes():
    from accelerate_tpu.parallel.sharding import data_spec as jax_data_spec

    assert sharding.data_spec(MESH_SIZES) == tuple(jax_data_spec(jax_build_mesh(JaxParallelismConfig(data=4, fsdp=2))))
