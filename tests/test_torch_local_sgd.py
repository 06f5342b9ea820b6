"""`LocalSGD` at world 2 over gloo, held to JAX's `LocalSGD` over a data
axis of 2 (`tests/test_local_sgd.py`, case for case). About 15 s: one
`debug_launcher` spawn of 2 processes running every scenario of
`tests/_torch_dist_workers.py:local_sgd2`, then JAX in this process on a
mesh of 2 of its 8 CPU devices (`AcceleratorState.set_mesh`).

The model is JAX's one-weight regression (y = 2x + 3), its initial
weights carried across, SGD at lr 0.05 over the same rows; the port's loss
is JAX's mean over the global batch (`ops.losses.global_mean`), which
inside `LocalSGD` is each process's own mean (the value the mean of the
means, as JAX's vmapped loss reports it).

Tolerances: losses and weights against JAX rtol 2e-5, atol 1e-6 (JAX's own
for K=1 against synced data parallel: the average of the parameters and the
step on the averaged gradient round apart). A replica's weights between
two averages equal JAX's replica row of the same index within 1e-6; the
two processes' weights at an averaging step are equal bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import optax

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402
from test_training import make_regression_data, make_regression_model  # noqa: E402

from accelerate_tpu import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu import LocalSGD as JaxLocalSGD  # noqa: E402
from accelerate_tpu import SimpleDataLoader as JaxLoader  # noqa: E402
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState  # noqa: E402
from accelerate_tpu.state import GradientState as JaxGradientState  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDPPlugin  # noqa: E402
from accelerate_tpu.utils import ParallelismConfig as JaxParallelismConfig  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402

WORLD = 2
LR = 0.05
CLOSE = dict(rtol=2e-5, atol=1e-6)
#: (rows, global batch) of each scenario: JAX's `_run` and its exit case.
DATA = {"k1": (make_regression_data(64, seed=7), 16), "exit": (make_regression_data(32, seed=2), 8)}


def _reset_jax():
    for state in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        state._reset_state()


@pytest.fixture(scope="module")
def local_sgd2(tmp_path_factory):
    jmodel = make_regression_model(seed=0)
    dense = jmodel.params["params"]["linear"]
    inputs = {
        "regression": {"kernel": np.asarray(dense["kernel"]), "bias": np.asarray(dense["bias"])},
        "local_sgd_rows": {k: rows for k, (rows, _) in DATA.items()},
        "local_sgd_batch": {k: batch for k, (_, batch) in DATA.items()},
        "local_sgd_lr": LR,
    }
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    torch.save(inputs, in_dir / "inputs.pt")
    debug_launcher(workers.local_sgd2, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_run(local_sgd_steps=None, key="k1", after=0, plugin=None):
    """JAX's `_run` over a data axis of 2: (losses, the replica rows of the
    kernel and bias after every step, the final weights)."""
    _reset_jax()
    accelerator = JaxAccelerator(fsdp_plugin=plugin)
    accelerator.state.set_mesh(jax_build_mesh(JaxParallelismConfig(data=WORLD), devices=jax.devices()[:WORLD]))
    rows, batch = DATA[key]
    pmodel, popt, pdl = accelerator.prepare(make_regression_model(seed=0), optax.sgd(LR),
                                            JaxLoader(rows, JaxBatchSampler(range(len(rows)), batch)))
    losses, rows_after = [], []

    def weights():
        dense = pmodel.params["params"]["linear"]
        kernel, bias = np.asarray(dense["kernel"]), np.asarray(dense["bias"])
        if kernel.ndim == 3:  # the replica axis inside LocalSGD
            return np.stack([np.concatenate([kernel[r].ravel(), bias[r].ravel()]) for r in range(WORLD)])
        return np.stack([np.concatenate([kernel.ravel(), bias.ravel()])] * WORLD)

    def one(b):
        losses.append(float(accelerator.backward(pmodel.loss, b)))
        popt.step()
        popt.zero_grad()

    if local_sgd_steps is None:
        for b in pdl:
            one(b)
            rows_after.append(weights())
    else:
        with JaxLocalSGD(accelerator=accelerator, model=pmodel, local_sgd_steps=local_sgd_steps) as local_sgd:
            assert local_sgd.enabled and local_sgd.dp == WORLD
            for b in pdl:
                one(b)
                local_sgd.step()
                rows_after.append(weights())
    for _ in range(after):
        for b in pdl:
            one(b)
    final = weights()[0]
    _reset_jax()
    return losses, rows_after, final


def test_local_sgd_k1_matches_synced_dp(local_sgd2):
    """K=1 (average after every local step) equals plain data parallel, as
    in JAX; both equal JAX's runs."""
    dp, k1 = local_sgd2[0]["dp"], local_sgd2[0]["k1"]
    assert k1["enabled"]
    np.testing.assert_allclose(k1["losses"], dp["losses"], **CLOSE)
    np.testing.assert_allclose(k1["final"], dp["final"], **CLOSE)
    jdp, jk1 = _jax_run(None), _jax_run(1)
    np.testing.assert_allclose(dp["losses"], jdp[0], **CLOSE)
    np.testing.assert_allclose(k1["losses"], jk1[0], **CLOSE)
    np.testing.assert_allclose(k1["final"], jk1[2], **CLOSE)


def test_local_sgd_replicas_diverge_then_converge(local_sgd2):
    """K=2: after the first local step the processes' weights part, each
    equal to JAX's replica row of its index; at the second they are
    averaged, bit for bit equal across the processes and equal to JAX's."""
    jlosses, jrows, jfinal = _jax_run(2)
    for rank, result in enumerate(local_sgd2):
        got = result["k2"]
        np.testing.assert_allclose(got["losses"], jlosses, **CLOSE)
        for step, weights in enumerate(got["weights"]):
            np.testing.assert_allclose(weights, jrows[step][rank], rtol=1e-6, atol=1e-7)
    first = [r["k2"]["weights"][0] for r in local_sgd2]
    assert not np.allclose(first[0], first[1])
    for step in (1, 3):
        assert np.array_equal(local_sgd2[0]["k2"]["weights"][step], local_sgd2[1]["k2"]["weights"][step])
    np.testing.assert_allclose(local_sgd2[0]["k2"]["final"], jfinal, **CLOSE)


def test_local_sgd_exit_averages_and_trains_on(local_sgd2):
    """The exit averages (K=2 over 4 steps ends on a boundary, JAX's exit
    case), then the model trains synced again: JAX's losses and weights."""
    jlosses, _, jfinal = _jax_run(2, key="exit", after=1)
    for result in local_sgd2:
        got = result["exit"]
        assert np.isfinite(got["losses"]).all()
        np.testing.assert_allclose(got["losses"], jlosses, **CLOSE)
        np.testing.assert_allclose(got["final"], jfinal, **CLOSE)
    assert np.array_equal(local_sgd2[0]["exit"]["final"], local_sgd2[1]["exit"]["final"])


def test_local_sgd_disabled_is_synced_data_parallel(local_sgd2):
    """``enabled=False`` only counts steps: the synced run bit for bit."""
    got, dp = local_sgd2[0]["disabled"], local_sgd2[0]["dp"]
    assert got["enabled"] is False
    assert [float.hex(x) for x in got["losses"]] == [float.hex(x) for x in dp["losses"]]
    assert np.array_equal(got["final"], dp["final"])


def test_local_sgd_rejects_model_sharding(local_sgd2):
    """An "fsdp" axis above 1 is refused with JAX's message."""
    for result in local_sgd2:
        assert result["fsdp_refused"] == (
            "LocalSGD supports pure data parallelism only (mesh axis 'fsdp' has size 2)")


def test_local_sgd_refuses_the_disk_tier_as_jax(local_sgd2, tmp_path):
    """The disk tier is refused at `__enter__`, with JAX's own message."""
    with pytest.raises(NotImplementedError) as jax_error:
        _jax_run(2, plugin=JaxFSDPPlugin(sharding_strategy="NO_SHARD", offload_optimizer_device="disk",
                                         offload_dir=str(tmp_path / "jax_disk")))
    _reset_jax()
    for result in local_sgd2:
        assert result["disk"]["refused"] == str(jax_error.value)


def test_local_sgd_collapses_the_pinned_tier(local_sgd2):
    """The pinned tier trains inside LocalSGD bit for bit as the resident
    state does; on exit it is collapsed onto the device with JAX's warning,
    and training goes on bit for bit."""
    warning = ("LocalSGD collapse disables optimizer-state host offload; "
               "state stays in device memory from here on.")
    for result in local_sgd2:
        pinned, resident = result["pinned"], result["pinned_resident"]
        assert pinned["offload_after"] is None and resident["offload_after"] is None
        assert [float.hex(x) for x in pinned["losses"]] == [float.hex(x) for x in resident["losses"]]
        assert np.array_equal(pinned["final"], resident["final"])
        assert result["warnings"].count(warning) == 1
