"""The end-to-end script (the port of
`accelerate_tpu/test_utils/scripts/test_script.py`), behind
``accelerate-tpu-torch test``: process control, the synchronized generators,
loader preparation (sharded and dispatched), the seedable sampler,
`split_between_processes`, training against a plain torch loop loss for
loss (and its split-batch, bf16 and accumulation variants), resume with
`skip_first_batches`, `gather_for_metrics`, triggers, `sync_module_states`,
the singletons and the sharded seedable sampler: JAX's 15 checks over the
port's API. It runs at one process (on the card, or under
``ACCELERATE_TPU_USE_CPU=1``) or across processes under `debug_launcher`.

The port's batches are each process's share (JAX's are global arrays), so
the checks that look at a whole batch `gather` it first."""

import numpy as np
import torch


def _reset():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()


def _global(t) -> np.ndarray:
    """Every process's rows of `t`, as numpy."""
    from accelerate_tpu_torch.utils import operations as ops

    return ops.gather(t).cpu().numpy()


def init_state_check():
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    state.print(f"State: {state!r}")
    assert state.num_processes >= 1
    assert state.device.type in ("cuda", "cpu")
    return state


def process_execution_check(state):
    ran = {}

    @state.on_main_process
    def mark():
        ran["main"] = state.process_index

    mark()
    if state.is_main_process:
        assert ran["main"] == 0
    else:
        assert "main" not in ran
    with state.main_process_first():
        pass
    state.wait_for_everyone()


def split_between_processes_check(state):
    items = list(range(17))
    with state.split_between_processes(items) as mine:
        base, extra = divmod(17, state.num_processes)
        expected_len = base + (1 if state.process_index < extra else 0)
        assert len(mine) == expected_len, (len(mine), expected_len)
    with state.split_between_processes(items, apply_padding=True) as mine:
        base, extra = divmod(17, state.num_processes)
        assert len(mine) == base + (1 if extra else 0)
    with state.split_between_processes({"a": np.arange(8), "b": np.arange(8) * 2}) as mine:
        assert len(mine["a"]) == len(mine["b"])
    nested = {"outer": {"x": np.arange(16).reshape(16, 1), "y": list(range(16))}}
    with state.split_between_processes(nested) as mine:
        assert mine["outer"]["x"].shape[0] == len(mine["outer"]["y"])
    with state.split_between_processes(torch.arange(10), apply_padding=True) as mine:
        base, extra = divmod(10, state.num_processes)
        assert mine.shape[0] == base + (1 if extra else 0)


def rng_sync_check(state):
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.random import synchronize_rng_states

    np.random.seed(1000 + state.process_index)  # deliberately apart
    synchronize_rng_states(["numpy"])
    draw = np.random.rand(3)
    gathered = ops.gather_object([draw.tolist()])
    for other in gathered:
        assert np.allclose(other, gathered[0]), "numpy RNG not synchronized across processes"
    state.wait_for_everyone()


def _samples(n):
    return [{"x": np.float32([i])} for i in range(n)]


def dl_preparation_check(state):
    from accelerate_tpu_torch.data_loader import BatchSampler, SimpleDataLoader, prepare_data_loader

    n, bs = 64, 8
    dl = SimpleDataLoader(_samples(n), BatchSampler(range(n), bs))
    prepared = prepare_data_loader(dl, state.device, use_seedable_sampler=False)
    seen = []
    for batch in prepared:
        seen.extend(_global(batch["x"])[:, 0].tolist())
    assert sorted(int(v) for v in seen) == list(range(n)), "prepared loader lost/duplicated samples"
    # split_batches: the global batch is the loader's batch size.
    prepared = prepare_data_loader(dl, state.device, split_batches=True, use_seedable_sampler=False)
    for batch in prepared:
        assert _global(batch["x"]).shape[0] == bs
        break
    state.wait_for_everyone()


def central_dl_preparation_check(state):
    from accelerate_tpu_torch.data_loader import BatchSampler, SimpleDataLoader, prepare_data_loader

    n, bs = 32, 4
    dl = SimpleDataLoader(_samples(n), BatchSampler(range(n), bs))
    prepared = prepare_data_loader(dl, state.device, dispatch_batches=True, use_seedable_sampler=False)
    seen = []
    for batch in prepared:
        seen.extend(_global(batch["x"])[:, 0].tolist())
    assert sorted(int(v) for v in seen) == list(range(n)), "dispatch loader lost/duplicated samples"
    state.wait_for_everyone()


def seedable_sampler_check(state):
    from accelerate_tpu_torch.data_loader import (
        BatchSampler,
        SeedableRandomSampler,
        SimpleDataLoader,
        prepare_data_loader,
    )

    n, bs = 32, 4

    def epoch_order(seed):
        sampler = SeedableRandomSampler(num_samples=n, seed=seed)
        dl = SimpleDataLoader(_samples(n), BatchSampler(sampler, bs))
        prepared = prepare_data_loader(dl, state.device, use_seedable_sampler=True, data_seed=seed)
        order = []
        for batch in prepared:
            order.extend(_global(batch["x"])[:, 0].astype(int).tolist())
        return order

    assert epoch_order(42) == epoch_order(42), "seedable sampler not deterministic"
    assert epoch_order(42) != epoch_order(7), "seedable sampler ignores the seed"
    state.wait_for_everyone()


def _regression_data():
    from accelerate_tpu_torch.test_utils.training import RegressionDataset

    dataset = RegressionDataset(length=64, seed=5)
    return [dataset[i] for i in range(len(dataset))]


def _baseline(data, batch_size, epochs=1):
    """A plain torch SGD loop on the host, batch by batch in order."""
    from accelerate_tpu_torch.test_utils.training import RegressionModel

    model = RegressionModel()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    losses = []
    for _ in range(epochs):
        for start in range(0, 64, batch_size):
            x = torch.from_numpy(np.stack([data[i]["x"] for i in range(start, start + batch_size)]))
            y = torch.from_numpy(np.stack([data[i]["y"] for i in range(start, start + batch_size)]))
            loss = ((model(x)[:, 0] - y) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
    return losses


def _framework(data, batch_size, epochs=1, **acc_kwargs):
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import BatchSampler, SimpleDataLoader
    from accelerate_tpu_torch.test_utils.training import RegressionModel

    _reset()
    acc_kwargs.setdefault("split_batches", True)
    accelerator = Accelerator(**acc_kwargs)
    model = RegressionModel()
    dl = SimpleDataLoader(data, BatchSampler(range(64), batch_size))
    pmodel, popt, pdl = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1), dl)
    losses = []
    for _ in range(epochs):
        for batch in pdl:
            with accelerator.accumulate(pmodel):
                losses.append(accelerator.backward(pmodel.loss, batch))
                popt.step()
                popt.zero_grad()
    return [float(loss) for loss in losses]  # read once, after the loop


def training_check(state):
    """Training across this script's processes (the global batch split
    among them) equals a plain one-process loop, loss for loss."""
    data = _regression_data()
    baseline = _baseline(data, 16, epochs=3)
    losses = _framework(data, 16, epochs=3)
    assert len(losses) == len(baseline)
    np.testing.assert_allclose(np.array(losses), np.array(baseline), rtol=1e-4, atol=1e-5)
    state.print("training_check: distributed == single-device, loss-for-loss ✓")
    _reset()


def training_variants_check(state):
    """split_batches, bf16 and accumulation, each against the plain loop."""
    data = _regression_data()
    np.testing.assert_allclose(_framework(data, 16, split_batches=True), _baseline(data, 16), rtol=1e-4, atol=1e-5)
    # bf16: the same convergence at reduced precision (loose tolerance).
    np.testing.assert_allclose(_framework(data, 16, mixed_precision="bf16"), _baseline(data, 16), rtol=0.1, atol=0.05)
    # Two micro-batches of 8 at the same weights average to the batch of 16's loss.
    accum = np.asarray(_framework(data, 8, gradient_accumulation_steps=2))
    np.testing.assert_allclose((accum[0::2] + accum[1::2]) / 2, _baseline(data, 16), rtol=1e-3, atol=1e-4)
    _reset()
    state.print("training_variants: split_batches / bf16 / accumulation ✓")


def resume_check(state):
    """`skip_first_batches` resumes mid-epoch on the same batches."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import BatchSampler, SimpleDataLoader

    n, bs = 32, 4
    accelerator = Accelerator()
    pdl = accelerator.prepare_data_loader(SimpleDataLoader(_samples(n), BatchSampler(range(n), bs)))
    full = [_global(b["x"])[:, 0].tolist() for b in pdl]
    resumed = [_global(b["x"])[:, 0].tolist() for b in accelerator.skip_first_batches(pdl, 3)]
    assert resumed == full[3:], (resumed, full[3:])
    _reset()
    state.print("resume (skip_first_batches) ✓")


def gather_for_metrics_check(state):
    """An uneven tail: the repeated pad samples are dropped; objects too."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import BatchSampler, SimpleDataLoader

    n = 19
    accelerator = Accelerator()
    pdl = accelerator.prepare_data_loader(SimpleDataLoader(_samples(n), BatchSampler(range(n), 8, drop_last=False)))
    seen = np.concatenate([accelerator.gather_for_metrics(batch["x"]).cpu().numpy()[:, 0] for batch in pdl])
    assert seen.shape[0] == n, (seen.shape, n)
    assert sorted(int(v) for v in seen) == list(range(n))
    objs = accelerator.gather_for_metrics([f"rank{state.process_index}"], use_gather_object=True)
    assert objs == [f"rank{i}" for i in range(state.num_processes)], objs
    _reset()
    state.print("gather_for_metrics: remainder truncation + object plane ✓")


def reinstantiated_state_check(state):
    """The singletons: `PartialState` built again is the same state, and an
    `AcceleratorState` over it shares it."""
    from accelerate_tpu_torch.state import AcceleratorState, PartialState

    again = PartialState()
    assert again.process_index == state.process_index
    assert again.num_processes == state.num_processes
    acc_state = AcceleratorState()
    assert acc_state.process_index == state.process_index
    state.wait_for_everyone()


def seedable_sampler_in_shard_check(state):
    """A seedable shuffle under `BatchSamplerShard`: one permutation on
    every process, and the processes' batches cover the dataset."""
    from accelerate_tpu_torch.data_loader import BatchSampler, BatchSamplerShard, SeedableRandomSampler
    from accelerate_tpu_torch.utils import operations as ops

    n = 24
    sampler = SeedableRandomSampler(num_samples=n, seed=7)
    sampler.set_epoch(3)
    shard = BatchSamplerShard(BatchSampler(sampler, batch_size=4), num_processes=state.num_processes,
                              process_index=state.process_index)
    local = [i for batch in shard for i in batch]
    all_indices = ops.gather_object(local)
    assert set(all_indices) == set(range(n)), "sharded seedable sampler must cover the dataset"
    assert len(all_indices) >= n
    sampler2 = SeedableRandomSampler(num_samples=n, seed=7)
    sampler2.set_epoch(3)
    walks = ops.gather_object([list(sampler2)])
    assert all(w == walks[0] for w in walks), "seedable permutation differs across processes"
    state.wait_for_everyone()


def sync_module_states_check(state):
    """`sync_module_states`: weights that differ per process come out of
    `prepare` equal (process 0's) when on, and stay apart when off. The
    plugin runs NO_SHARD: under a sharded strategy each process keeps only
    its shard, so "apart" could not be seen."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.test_utils.training import RegressionModel
    from accelerate_tpu_torch.utils import FullyShardedDataParallelPlugin
    from accelerate_tpu_torch.utils.operations import gather_object

    if state.num_processes == 1:
        return
    for sync, expect_equal in ((True, True), (False, False)):
        _reset()
        accelerator = Accelerator(fsdp_plugin=FullyShardedDataParallelPlugin(
            sharding_strategy="NO_SHARD", sync_module_states=sync))
        prepared = accelerator.prepare(RegressionModel(a=float(state.process_index), b=1.0))
        values = gather_object([float(next(iter(prepared.parameters())).detach().reshape(-1)[0])])
        equal = all(v == values[0] for v in values)
        assert equal == expect_equal, f"sync_module_states={sync}: expected equal={expect_equal}, got {values}"
    state.print("sync_module_states_check: rank-0 weights win when on, stay local when off ✓")
    _reset()


def trigger_check(state):
    from accelerate_tpu_torch import Accelerator

    accelerator = Accelerator()
    assert not accelerator.check_trigger()
    if state.process_index == state.num_processes - 1:
        accelerator.set_trigger()
    assert accelerator.check_trigger(), "trigger set on one process must be visible everywhere"
    assert not accelerator.check_trigger(), "trigger must reset after firing"
    _reset()


def main():
    state = init_state_check()
    state.print("**Process control**")
    process_execution_check(state)
    split_between_processes_check(state)
    state.print("**RNG sync**")
    rng_sync_check(state)
    state.print("**DataLoader preparation**")
    dl_preparation_check(state)
    central_dl_preparation_check(state)
    seedable_sampler_check(state)
    state.print("**Training check**")
    training_check(state)
    training_variants_check(state)
    state.print("**Resume / metrics**")
    resume_check(state)
    gather_for_metrics_check(state)
    state.print("**Trigger**")
    trigger_check(state)
    state.print("**FSDP sync_module_states**")
    sync_module_states_check(state)
    state.print("**State reinstantiation / sharded sampler**")
    reinstantiated_state_check(state)
    seedable_sampler_in_shard_check(state)
    state.print("All checks passed.")


if __name__ == "__main__":
    main()
