"""The `Accelerator` surface across processes: world 2 over gloo on the CPU,
one `debug_launcher` spawn for the file (`tests/_torch_dist_workers.py:surface2`
runs every scenario in turn), each test below checking one scenario against
the JAX package run here as one process. About 25 s, most of it the spawn.

  - The scheduler across processes: JAX's `AcceleratedScheduler` advances
    `num_processes` steps per optimizer step without `split_batches`, one
    with it, and one per call without `step_scheduler_with_optimizer`; its
    count is held with `AcceleratorState().num_processes` patched to 2 (JAX
    runs as one process here). Exact: the count is an integer and the
    learning rate the schedule's value at it.
  - `clip_grad_value_` at world 2 (data parallel, NO_SHARD, SHARD_GRAD_OP,
    FULL_SHARD: each process clamps its own shards, no collective) against
    the port's one process on the same global batches: losses within rtol
    1e-5, weights within rtol 1e-4, atol 1e-6 on all but one element in
    10^4 and every element within 2 * lr * steps
    (`tests/test_torch_distributed.py`'s rule: Adam's normalised step parts
    any two f32 runs where a gradient is within rounding of zero).
  - The trigger, the synchronized generators, `local_main_process_first`
    and the logger's output: exact.
  - `DataLoaderDispatcher`: the ranks' slices of each global batch,
    concatenated, equal JAX's dispatcher's batches at one process, value
    for value; `gather_for_metrics` returns JAX's rows, the ragged tail's
    repeats cut.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402

from accelerate_tpu import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu import SimpleDataLoader as JaxLoader  # noqa: E402
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler  # noqa: E402
from accelerate_tpu.scheduler import AcceleratedScheduler as JaxScheduler  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState  # noqa: E402
from accelerate_tpu.state import GradientState as JaxGradientState  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu.utils import DataLoaderConfiguration as JaxDataLoaderConfiguration  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402

WORLD = 2


def _reset_jax():
    for state in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        state._reset_state()


@pytest.fixture(autouse=True)
def reset_jax():
    _reset_jax()
    yield
    _reset_jax()


@pytest.fixture(scope="module")
def surface2(tmp_path_factory):
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    debug_launcher(workers.surface2, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(results=results, out_dir=out_dir)


# ------------------------------------------------------------------ the scheduler
class _Stepped:
    """An optimizer that stepped: what JAX's scheduler reads of one."""

    step_was_skipped = False

    def set_learning_rate(self, lr):
        self.lr = lr


def _jax_counts(monkeypatch, split_batches=False, step_with_optimizer=True):
    """JAX's scheduler driven through the worker's loop, at world 2."""
    JaxAccelerator()
    monkeypatch.setitem(JaxPartialState._shared_state, "num_processes", WORLD)
    gs = JaxGradientState()
    sched = JaxScheduler(workers.schedule, [_Stepped()], step_with_optimizer=step_with_optimizer,
                         split_batches=split_batches)
    accumulation = 1 if step_with_optimizer else 2
    seen = []
    for i in range(workers.SCHEDULER_STEPS * accumulation):
        gs._set_sync_gradients((i + 1) % accumulation == 0)
        sched.step()
        if gs.sync_gradients:
            seen.append((sched.step_count, sched.get_last_lr()[0]))
    return seen


@pytest.mark.parametrize("case,kwargs,expect", [
    ("default", {}, [(2, 1 / 3), (4, 1 / 5), (6, 1 / 7)]),
    ("split", dict(split_batches=True), [(1, 1 / 2), (2, 1 / 3), (3, 1 / 4)]),
    ("per_call", dict(step_with_optimizer=False), [(2, 1 / 3), (4, 1 / 5), (6, 1 / 7)]),
])
def test_scheduler_steps_across_processes_as_jax(surface2, monkeypatch, case, kwargs, expect):
    """3 optimizer steps of ``1 / (1 + step)`` at world 2: step count 6 and
    lr 1/7 without `split_batches`, 3 and 0.25 with it, one step per call
    without `step_scheduler_with_optimizer`, on both processes, as JAX's rule
    counts; the optimizer takes the learning rate the scheduler reports."""
    jax_seen = _jax_counts(monkeypatch, **kwargs)
    assert jax_seen == expect
    for rank in range(WORLD):
        seen = surface2["results"][rank]["scheduler"][case]
        assert [(count, lr) for count, lr, _ in seen] == jax_seen
        assert all(lr == opt_lr for _, lr, opt_lr in seen)


# ------------------------------------------------------------------ clip_grad_value_
@pytest.fixture(scope="module")
def one_process_clip():
    """The same loop as `_torch_dist_workers.clip_value_run`, one process."""
    import accelerate_tpu_torch as port
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    AcceleratorState._reset_state()
    GradientState._reset_state()
    try:
        acc = port.Accelerator(cpu=True)
        model = llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu")
        pmodel, opt, loader = acc.prepare(model, workers._adamw(model), port.SimpleDataLoader(
            workers.clip_rows(), port.BatchSampler(range(workers.CLIP_ROWS["n"]), workers.CLIP_ROWS["global_batch"])))
        losses = []
        for batch in loader:
            with acc.accumulate(pmodel):
                losses.append(acc.backward(pmodel.loss, batch).item())
                acc.clip_grad_value_(clip_value=2e-3)
                opt.step()
                opt.zero_grad()
        return {"losses": losses, "weights": {k: v.detach().clone() for k, v in pmodel.module.state_dict().items()}}
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("strategy", ["none", "NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD"])
def test_clip_grad_value_across_processes_matches_one_process(surface2, one_process_clip, strategy):
    runs = [r["clip"][strategy] for r in surface2["results"]]
    assert runs[0]["losses"] == runs[1]["losses"]
    np.testing.assert_allclose(runs[0]["losses"], one_process_clip["losses"], rtol=1e-5)
    steps = len(runs[0]["losses"])
    for name, expect in one_process_clip["weights"].items():
        got, expect = runs[0]["weights"][name].numpy(), expect.numpy()
        off = ~np.isclose(got, expect, rtol=1e-4, atol=1e-6)
        assert off.sum() <= max(1, got.size // 10_000), (name, int(off.sum()))
        assert np.abs(got - expect).max() <= 2 * workers.LR * steps, name


def test_save_model_across_processes_writes_what_the_model_holds(surface2):
    """At world 2 the main process writes `save_model`'s shards: data
    parallel, and FULL_SHARD gathered a tensor at a time
    (FULL_STATE_DICT); they read back equal to the whole state dict.
    FULL_SHARD's default SHARDED_STATE_DICT raises, naming ROADMAP A item 1
    and orbax's layout, which JAX writes it in."""
    r0, r1 = (r["save_model"] for r in surface2["results"])
    for tag in ("None-None", "FULL_SHARD-FULL_STATE_DICT"):
        assert r0[tag]["equal"] and r1[tag]["equal"]
        assert len(r0[tag]["files"]) > 2 and "model.safetensors.index.json" in r0[tag]["files"]
    assert r0["None-None"]["files"] == r0["FULL_SHARD-FULL_STATE_DICT"]["files"]
    for run in (r0, r1):
        assert "ROADMAP A item 1" in run["FULL_SHARD-SHARDED_STATE_DICT"]
        assert "orbax" in run["FULL_SHARD-SHARDED_STATE_DICT"]


def test_save_and_load_pre_hooks_run_on_every_process(surface2):
    for run in (r["save_model"] for r in surface2["results"]):
        assert run["hooks"] == [("save", True, None, True), ("load", True, True)]


def test_autocast_under_fsdp_is_set_at_construction_only(surface2):
    for run in (r["save_model"] for r in surface2["results"]):
        assert "FSDP" in run["toggle"]
        assert run["f32_forward"] is True


# ------------------------------------------------------------------ trigger, generators, ordering, logger
def test_a_trigger_set_on_one_rank_fires_on_both_once(surface2):
    assert [r["trigger"] for r in surface2["results"]] == [[False, True, False]] * WORLD


def test_synchronize_rng_states_gives_every_rank_rank_zeros_draws(surface2):
    """Before, each rank draws from its own seeds; after
    `synchronize_rng_states(["python", "numpy", "torch", "generator"])`
    (and a `torch.Generator` as the generator), every rank draws rank 0's
    numbers and holds its sampler state; a loader prepared with
    ``rng_types=["generator"]`` over samplers seeded by rank shards rank 0's
    permutation."""
    r0, r1 = (r["rng"] for r in surface2["results"])
    assert all(r0["unsynced"][k] != r1["unsynced"][k] for k in r0["unsynced"])
    assert r0["synced"] == r1["synced"]
    assert r0["synced"] == r0["unsynced"]
    assert r0["synced"]["sampler"] == {"seed": 500, "epoch": 0}
    order = np.random.default_rng(500).permutation(16).tolist()
    assert r0["loader"] + r1["loader"] != [] and sorted(sum(r0["loader"] + r1["loader"], [])) == list(range(16))
    assert [b for pair in zip(r0["loader"], r1["loader"]) for b in pair] == [order[i:i + 4] for i in range(0, 16, 4)]


def test_local_main_process_first_runs_the_local_main_first(surface2):
    with open(surface2["out_dir"] / "order.txt") as f:
        assert f.read().split("\n")[:4] == ["enter 0", "leave 0", "enter 1", "leave 1"]
    assert [r["ordering"] for r in surface2["results"]] == [["local main"], ["last"]]


def test_logger_writes_main_only_and_every_process_lines(surface2):
    logs = []
    for rank in range(WORLD):
        with open(surface2["out_dir"] / f"log{rank}.txt") as f:
            logs.append(f.read().splitlines())
    assert logs == [["main only", "every process 0"], ["every process 1"]]


# ------------------------------------------------------------------ the dispatcher
ROWS = [{"x": np.arange(3, dtype=np.float32) + 10 * i, "y": np.int64(i)} for i in range(27)]


def _jax_dispatched(skip=0):
    """JAX's dispatcher at one process over the global batch of 8."""
    acc = JaxAccelerator(dataloader_config=JaxDataLoaderConfiguration(dispatch_batches=True))
    loader = acc.prepare(JaxLoader(ROWS, JaxBatchSampler(range(27), 8)))
    if skip:
        loader = acc.skip_first_batches(loader, skip)
    batches, gathered = [], []
    for batch in loader:
        batches.append({k: np.asarray(v) for k, v in batch.items()})
        gathered.append(np.asarray(acc.gather_for_metrics(np.asarray(batch["y"]))))
    return batches, gathered


@pytest.mark.parametrize("case", ["plain", "split", "skip"])
def test_dispatcher_slices_equal_jax_global_batches(surface2, case):
    """Process 0 reads, each rank keeps its half of every global batch of 8
    (two loader batches of 4 joined, or one of 8 with `split_batches`): the
    halves joined are JAX's batches, the tail of 3 topped up by cycling its
    rows as JAX's is; `gather_for_metrics` gives JAX's rows, 27 in all;
    `skip_first_batches(loader, 2)` starts at the third."""
    jax_batches, jax_gathered = _jax_dispatched(skip=2 if case == "skip" else 0)
    runs = [r["dispatch"][case] for r in surface2["results"]]
    assert runs[0]["len"] == runs[1]["len"] == len(jax_batches) == (2 if case == "skip" else 4)
    for i, expect in enumerate(jax_batches):
        for key in ("x", "y"):
            np.testing.assert_array_equal(np.concatenate([run["batches"][i][key] for run in runs]), expect[key])
        for run in runs:
            np.testing.assert_array_equal(run["gathered"][i], jax_gathered[i])
    assert sum(len(g) for g in runs[0]["gathered"]) == sum(len(g) for g in jax_gathered)
    assert sum(len(g) for g in jax_gathered) == (27 - 16 if case == "skip" else 27)


def test_an_iterable_dataset_is_dispatched_by_default(surface2):
    """20 samples, batch 4 a process: process 0 reads two loader batches a
    global batch of 8 and each rank keeps its half; the tail of 4 is topped
    up to 8 by cycling its own rows, as JAX's dispatcher pads."""
    r0, r1 = (r["iterable"] for r in surface2["results"])
    assert r0["dispatcher"] and r1["dispatcher"]
    assert r0["batches"] == [[0, 1, 2, 3], [8, 9, 10, 11], [16, 17, 18, 19]]
    assert r1["batches"] == [[4, 5, 6, 7], [12, 13, 14, 15], [16, 17, 18, 19]]


def test_dispatcher_without_even_batches_still_gathers_jax_count(surface2):
    """JAX's dispatcher tops the last global batch up whatever
    `even_batches` says (it pads before it slices): so does the port's."""
    runs = [r["dispatch"]["uneven"] for r in surface2["results"]]
    plain = [r["dispatch"]["plain"] for r in surface2["results"]]
    for run, base in zip(runs, plain):
        assert [b["y"].tolist() for b in run["batches"]] == [b["y"].tolist() for b in base["batches"]]
    assert sum(len(g) for g in runs[0]["gathered"]) == 27
