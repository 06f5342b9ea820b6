"""Sharded checkpoints across processes: world 2 over gloo on the CPU. About
15 s: one `debug_launcher` spawn of 2 processes running every scenario of
`tests/_torch_dist_workers.py:checkpoint_sharded2` in turn, then the loads
at world 1 in this process.

The model (`_torch_dist_workers.odd_mlp`) has a weight [5, 14] whose dim 0
2 does not divide: JAX's placement table shards it on its dim 1 (the flax
kernel's dim 0), and leaves its bias of 5 and the head [3, 5] whole, so the
bounds each process writes must follow the dim the table chose.

  - SHARD_GRAD_OP (ZeRO-2: the moments' shard views) and FULL_SHARD
    (torch's `fully_shard`: the parameters' and moments' `DTensor` shards),
    each saved sharded synchronously and asynchronously after 2 steps:
    a fresh accelerator of the same strategy loads it at world 2, and its
    next 2 losses are the uninterrupted run's within rtol 1e-5.
  - Each process wrote its own shard of each sharded tensor, its bounds
    in the whole tensor, the two halves covering it; the rest whole.
  - Each checkpoint loads at world 1 into a bare `Accelerator`: its weights
    and moments equal the gathered ones bit for bit.
  - A host's file deleted: `CheckpointCorruptError`.
  - An async save without `sharded` at world 2 raises JAX's ValueError.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.checkpointing import (  # noqa: E402
    CheckpointCorruptError,
    load_tensors_gathered,
    shard_host_dir,
    tensor_leaves,
)
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.state import AcceleratorState, GradientState  # noqa: E402

WORLD = 2
RUNS = [(s, m) for s in ("SHARD_GRAD_OP", "FULL_SHARD") for m in ("sync", "async")]
IDS = [f"{s}-{m}" for s, m in RUNS]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sharded2(tmp_path_factory):
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    debug_launcher(workers.checkpoint_sharded2, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(results=results, out_dir=out_dir)


def _bare_load(path):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    accelerator = port.Accelerator(cpu=True)
    model = workers.odd_mlp(seed=2)
    pmodel, popt = accelerator.prepare(model, workers._adamw(model.module))
    try:
        accelerator.load_state(str(path))
        return pmodel.module.state_dict(), popt.state_dict()
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_resumes_at_world_2_with_the_uncut_losses(sharded2, run):
    for rank in sharded2["results"]:
        got = rank[run]
        assert np.all(np.isfinite(got["losses"] + got["uncut"]))
        np.testing.assert_allclose(got["resumed"], got["uncut"], rtol=1e-5, atol=0)
    a, b = (r[run] for r in sharded2["results"])
    assert a["losses"] == b["losses"] and a["uncut"] == b["uncut"]  # the global batch's loss on both


SHAPES = {"layers.0.weight": (14, 12), "layers.0.bias": (14,), "layers.1.weight": (5, 14), "layers.1.bias": (5,),
          "head.weight": (3, 5), "head.bias": (3,)}  # in the optimizer's order


def _bounds(shape, dim, rank):
    """Process `rank`'s bounds of a tensor sharded on `dim` over 2 (or whole)."""
    bounds = [[0, d] for d in shape]
    if dim is not None:
        half = shape[dim] // 2
        bounds[dim] = [rank * half, (rank + 1) * half]
    return [bounds]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_each_process_wrote_its_shard_with_its_bounds(sharded2, run):
    """FULL_SHARD shards the weights and their moments, SHARD_GRAD_OP the
    moments only, each on the table's dim (the [5, 14] weight on its dim
    1), each process its half; the rest whole on both."""
    strategy, _ = run
    dims = sharded2["results"][0][run]["dims"]
    assert dims == {"layers.0.weight": 0, "layers.0.bias": 0, "layers.1.weight": 1, "layers.1.bias": None,
                    "head.weight": None, "head.bias": None}
    for rank, result in enumerate(sharded2["results"]):
        bounds = result[run]["bounds"]
        for name, shape in SHAPES.items():
            model_dim = dims[name] if strategy == "FULL_SHARD" else None
            assert bounds["model.pt"][name] == _bounds(shape, model_dim, rank), name
        for index, (name, shape) in enumerate(SHAPES.items()):
            for key in ("exp_avg", "exp_avg_sq"):
                assert bounds["optimizer.pt"][f"state/{index}/{key}"] == _bounds(shape, dims[name], rank), name
            assert bounds["optimizer.pt"][f"state/{index}/step"] == [[]]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_loads_at_world_1_into_a_bare_accelerator(sharded2, run):
    path = sharded2["out_dir"] / f"{run[0]}_{run[1]}"
    assert sorted(os.listdir(path / shard_host_dir(0))) == ["SHARD_DONE", "model.pt", "optimizer.pt",
                                                            "random_states_0.pt"]
    weights, moments = _bare_load(path)
    want = sharded2["results"][0][run]
    assert sorted(weights) == sorted(want["gathered"])
    assert all(torch.equal(weights[k], v) for k, v in want["gathered"].items())
    got, expect = dict(tensor_leaves(moments["state"])), dict(tensor_leaves(want["moments"]["state"]))
    assert sorted(got) == sorted(expect) and all(torch.equal(got[k], v) for k, v in expect.items())


def test_a_deleted_host_file_raises(sharded2, tmp_path):
    path = tmp_path / "ckpt"
    shutil.copytree(sharded2["out_dir"] / "FULL_SHARD_sync", path)
    os.unlink(path / shard_host_dir(1) / "model.pt")
    with pytest.raises(CheckpointCorruptError):
        _bare_load(path)  # the digest manifest names the file
    with pytest.raises(CheckpointCorruptError, match="missing host_0001/model.pt"):
        load_tensors_gathered(path, "model.pt")
    shutil.rmtree(path / shard_host_dir(1))
    with pytest.raises(CheckpointCorruptError, match="of 2"):
        load_tensors_gathered(path, "model.pt")


def test_async_without_sharded_across_processes_raises_jaxs_error(sharded2):
    for rank in sharded2["results"]:
        assert rank["refused"] == (
            "async_save with num_processes > 1 requires sharded=True: the background committer cannot run "
            "collective barriers, so cross-host commits coordinate through the per-host shard sentinels")
    assert not os.path.exists(sharded2["out_dir"] / "refused")
