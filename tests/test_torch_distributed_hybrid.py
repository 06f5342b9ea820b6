"""HYBRID_SHARD at world 4 over gloo on the CPU: llama_tiny sharded over
"fsdp" 2 and replicated over "data" 2 (torch's FSDP on a 2-D mesh), and its
ZeRO-2 form HYBRID_SHARD_ZERO2, held to JAX's `train_step` on the global
batch. One `debug_launcher` run of four processes
(`tests/_torch_dist_workers.py:world4`); tolerances as in
`tests/test_torch_distributed.py`.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402
import test_torch_distributed as world2_tests  # noqa: E402

from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.models import llama  # noqa: E402

WORLD = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(1)
    jmodel, params, poisoned, cfg = world2_tests._llama_inputs(rng)
    train = {"input_ids": world2_tests._ids(rng, 3 * world2_tests.GLOBAL_BATCH)}
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    inputs = {"llama_cfg": cfg, "sd": llama.llama_state_dict_from_flax(params, cfg),
              "global_batch": world2_tests.GLOBAL_BATCH, "rows": {"train": [{"input_ids": r} for r in train["input_ids"]]}}
    torch.save(inputs, in_dir / "inputs.pt")
    debug_launcher(workers.world4, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    n = world2_tests.GLOBAL_BATCH
    return dict(results=[torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)],
                jmodel=jmodel, params=params, poisoned=poisoned, cfg=cfg, sd=inputs["sd"],
                batches={"train": [{"input_ids": train["input_ids"][i * n:(i + 1) * n]} for i in range(3)]})


@pytest.mark.parametrize("strategy", ["HYBRID_SHARD", "HYBRID_SHARD_ZERO2"])
def test_hybrid_shard_matches_jax(world4, strategy):
    key = ("train", strategy)
    jlosses, _, _, jweights = world2_tests._jax_train(world4, "train")
    results = world4["results"]
    np.testing.assert_allclose(results[0][key]["losses"], jlosses, **world2_tests.LOSS)
    world2_tests._assert_adam_weights(results[0][key]["weights"], jweights)
    world2_tests._assert_adam_weights(results[0][key]["weights"], world2_tests._port_train(world4, "train")[1])
    world2_tests._assert_ranks_agree(results, key)


def test_hybrid_layout_shards_over_fsdp_and_replicates_over_data(world4):
    """Each parameter the table shards is a DTensor on the (data, fsdp) mesh,
    replicated over "data" and sharded over "fsdp" (its local shard half the
    whole) under HYBRID_SHARD; under HYBRID_SHARD_ZERO2 the parameters stay
    whole and their moments are halved."""
    for result in world4["results"]:
        full = result["train", "HYBRID_SHARD"]["layout"]
        sharded = {n: v for n, v in full["params"].items() if v[0]}
        assert sharded
        for name, (_, placement, local) in sharded.items():
            assert placement.startswith("(Replicate(), Shard(dim="), (name, placement)
        zero2 = result["train", "HYBRID_SHARD_ZERO2"]["layout"]
        assert not any(v[0] for v in zero2["params"].values())
        halved = [n for n, shape in zero2["moments"].items() if shape != zero2["params"][n][2]]
        assert sorted(halved) == sorted(sharded)
