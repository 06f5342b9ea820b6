"""The offload tiers across processes: world 2 over gloo on the CPU, each
strategy under each tier, held to the port's resident run of the same
strategy and to JAX's `train_step` on the global batch. About 25 s: one
`debug_launcher` spawn of 2 processes running every scenario of
`tests/_torch_dist_workers.py:offload2` in turn (one parameter a group,
``ACCELERATE_TPU_OFFLOAD_CHUNK_MB=0``), then JAX once in this process.

  - NO_SHARD, SHARD_GRAD_OP (the ZeRO-2 shard views) and FULL_SHARD
    (torch's `fully_shard`, the state `DTensor`s) under the pinned host
    tier and the disk tier: losses, gathered masters and gathered moments
    equal the resident run of the same strategy bit for bit (each group's
    update is torch's own foreach AdamW over the local shards).
  - Against JAX's `train_step` (AdamW with decay 1e-4, clip 1.0) on the
    global batch: losses within rtol 1e-5, masters as
    `tests/test_torch_distributed.py` holds them.
  - The masters' tier (`cpu_offload`) under NO_SHARD as above; under the
    sharded strategies it is refused, naming ROADMAP A item 4.
  - FULL_SHARD with the disk tier through `save_state`/`load_state`: the
    resumed losses equal the uncut run's.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402
from test_torch_distributed import (  # noqa: E402
    GLOBAL_BATCH,
    _assert_adam_weights,
    _ids,
    _jax_train,
    _llama_inputs,
    _share,
)

from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.models import llama  # noqa: E402

WORLD = 2
LOSS = dict(rtol=1e-5, atol=0)
STRATEGIES = ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def offload2(tmp_path_factory):
    rng = np.random.default_rng(0)
    jmodel, params, poisoned, cfg = _llama_inputs(rng)
    train = {"input_ids": _ids(rng, 3 * GLOBAL_BATCH)}
    ckpt = {"input_ids": _ids(rng, 4 * GLOBAL_BATCH)}
    steps = lambda b, n: [{k: v[i * n:(i + 1) * n] for k, v in b.items()} for i in range(len(b["input_ids"]) // n)]  # noqa: E731
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    sd = llama.llama_state_dict_from_flax(params, cfg)
    inputs = {
        "llama_cfg": cfg,
        "sd": sd,
        "global_batch": GLOBAL_BATCH,
        "rows": {"train": [{"input_ids": r} for r in train["input_ids"]]},
        "local_batches": {"checkpoint": [[_share(s, r) for s in steps(ckpt, GLOBAL_BATCH)] for r in range(WORLD)]},
    }
    torch.save(inputs, in_dir / "inputs.pt")
    debug_launcher(workers.offload2, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(results=results, jmodel=jmodel, params=params, poisoned=poisoned, cfg=cfg,
                batches={"train": steps(train, GLOBAL_BATCH)})


def _moments_equal(got, want):
    assert set(got["state"]) == set(want["state"])
    for i, entry in want["state"].items():
        assert set(got["state"][i]) == set(entry)
        for key, value in entry.items():
            assert torch.equal(torch.as_tensor(got["state"][i][key]), torch.as_tensor(value)), (i, key)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("tier", ["optimizer_state", "disk"])
def test_tier_equals_the_resident_strategy_bit_for_bit(offload2, strategy, tier):
    """Losses on both processes, gathered masters and moments: the resident
    run's of the same strategy, bit for bit."""
    for rank, result in enumerate(offload2["results"]):
        got, want = result["train", strategy, tier], result["train", strategy, "resident"]
        assert [float.hex(x) for x in got["losses"]] == [float.hex(x) for x in want["losses"]]
        assert got["world_weights_digest"] == want["world_weights_digest"]
        if rank == 0:
            assert all(torch.equal(got["weights"][k], want["weights"][k]) for k in want["weights"])
            _moments_equal(got["moments"], want["moments"])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("tier", ["resident", "optimizer_state", "disk"])
def test_tier_tracks_jax_on_the_global_batch(offload2, strategy, tier):
    """JAX's fused `train_step` over the global batches: losses within rtol
    1e-5, the gathered masters within Adam's tolerance."""
    jlosses, _, _, jweights = _jax_train(offload2, "train")
    got = offload2["results"][0]["train", strategy, tier]
    np.testing.assert_allclose(got["losses"], jlosses, **LOSS)
    _assert_adam_weights(got["weights"], jweights)


def test_masters_tier_under_no_shard_and_refused_when_sharded(offload2):
    """`cpu_offload` (the masters and the state in host memory) under
    NO_SHARD: the resident run bit for bit; under SHARD_GRAD_OP and
    FULL_SHARD across processes it raises, naming the ROADMAP bullet."""
    for result in offload2["results"]:
        got, want = result["train", "NO_SHARD", "cpu_offload"], result["train", "NO_SHARD", "resident"]
        assert [float.hex(x) for x in got["losses"]] == [float.hex(x) for x in want["losses"]]
        assert got["world_weights_digest"] == want["world_weights_digest"]
        for strategy in ("SHARD_GRAD_OP", "FULL_SHARD"):
            refused = result["train", strategy, "cpu_offload"]
            assert isinstance(refused, str) and "ROADMAP A item 4, offload tiers" in refused
            assert "parameter tier" in refused
    jlosses = _jax_train(offload2, "train")[0]
    np.testing.assert_allclose(offload2["results"][0]["train", "NO_SHARD", "cpu_offload"]["losses"], jlosses, **LOSS)


def test_disk_tier_checkpoint_resumes_under_full_shard(offload2):
    for result in offload2["results"]:
        ckpt = result["checkpoint"]
        assert ckpt["resumed"] == ckpt["uncut"] and all(np.isfinite(ckpt["losses"] + ckpt["uncut"]))
    assert offload2["results"][0]["checkpoint"] == offload2["results"][1]["checkpoint"]
