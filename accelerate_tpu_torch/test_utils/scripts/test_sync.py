"""Gradient accumulation and sync semantics (the port of
`accelerate_tpu/test_utils/scripts/test_sync.py`): accumulated micro-batches
train as one big batch; `sync_gradients` turns True exactly at the
accumulation boundaries and at the end of the loader; at a boundary the
accumulated gradients are the sum of the micro-batches' gradients of the
global loss, and the weights move only there; `no_sync` keeps gradients
without a step; the scheduler steps only with the optimizer.

Every check runs with ``split_batches=True``, so its global batch, step
count and losses do not depend on how many processes run it."""

import numpy as np
import torch


def _fresh_accelerator(**kwargs):
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    kwargs.setdefault("split_batches", True)
    return Accelerator(**kwargs)


def _loader(length, seed, batch_size):
    from accelerate_tpu_torch.data_loader import BatchSampler, SimpleDataLoader
    from accelerate_tpu_torch.test_utils.training import RegressionDataset

    dataset = RegressionDataset(length=length, seed=seed)
    data = [dataset[i] for i in range(len(dataset))]
    return SimpleDataLoader(data, BatchSampler(range(length), batch_size))


def _params(pmodel):
    return [p.detach().cpu().numpy().copy() for p in pmodel.parameters()]


def accumulation_equivalence_check():
    from accelerate_tpu_torch.test_utils.training import RegressionModel
    from accelerate_tpu_torch.utils import GradientAccumulationPlugin

    def run(accum, batch_size):
        accelerator = _fresh_accelerator(
            gradient_accumulation_plugin=GradientAccumulationPlugin(num_steps=accum, sync_with_dataloader=False))
        model = RegressionModel()
        pmodel, popt, pdl = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.05),
                                                _loader(64, 11, batch_size))
        for batch in pdl:
            with accelerator.accumulate(pmodel):
                accelerator.backward(pmodel.loss, batch)
                popt.step()
                popt.zero_grad()
        return _params(pmodel)

    for a, b in zip(run(accum=4, batch_size=8), run(accum=1, batch_size=32)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    print("accumulation_equivalence ✓")


def _flags(accumulation, length, batch_size):
    from accelerate_tpu_torch.test_utils.training import RegressionModel

    accelerator = _fresh_accelerator(gradient_accumulation_steps=accumulation)
    model = RegressionModel()
    pmodel, popt, pdl = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                            _loader(length, 3, batch_size))
    flags = []
    for batch in pdl:
        with accelerator.accumulate(pmodel):
            accelerator.backward(pmodel.loss, batch)
            flags.append(accelerator.sync_gradients)
            popt.step()
            popt.zero_grad()
    return flags


def sync_flag_check():
    flags = _flags(2, 32, 8)
    assert flags == [False, True, False, True], flags
    print("sync_flag ✓")


def end_of_dataloader_check():
    flags = _flags(4, 24, 8)  # 3 batches < accumulation 4
    assert flags[-1] is True, "end of dataloader must force a sync step"
    print("end_of_dataloader ✓")


def grad_equality_at_boundaries_check():
    """At a boundary the averaged gradients equal the sum of each
    micro-batch's gradient of the global loss over 2 (computed here on the
    gathered global batch at the current weights), and the weights move
    only at boundaries."""
    from accelerate_tpu_torch.test_utils.training import RegressionModel
    from accelerate_tpu_torch.utils import operations as ops

    accelerator = _fresh_accelerator(gradient_accumulation_steps=2)
    model = RegressionModel()
    pmodel, popt, pdl = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                            _loader(32, 13, 8))

    def manual_grad(batch):
        x, y = ops.gather(batch["x"]).cpu(), ops.gather(batch["y"]).cpu()
        params = [p.detach().cpu().clone().requires_grad_(True) for p in pmodel.parameters()]
        a, b = params
        loss = ((x * a + b)[:, 0] - y).pow(2).mean()
        return [g / 2.0 for g in torch.autograd.grad(loss, params)]

    before, expected = _params(pmodel), None
    for i, batch in enumerate(list(pdl)):
        with accelerator.accumulate(pmodel):
            g = manual_grad(batch)
            expected = g if expected is None else [e + x for e, x in zip(expected, g)]
            accelerator.backward(pmodel.loss, batch)
            if accelerator.sync_gradients:
                popt.reduce_gradients()
                for got, want in zip(popt._grads(), expected):
                    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-6)
                expected = None
            popt.step()
            popt.zero_grad()
        now = _params(pmodel)
        moved = any(not np.allclose(a, b) for a, b in zip(before, now))
        boundary = i % 2 == 1
        assert moved == boundary, f"params {'moved' if moved else 'frozen'} at step {i} (boundary={boundary})"
        before = now
    print("grad_equality_at_boundaries ✓")


def no_sync_check():
    """`no_sync`: gradients accumulate without a step; the next step outside
    applies them."""
    from accelerate_tpu_torch.test_utils.training import RegressionModel

    accelerator = _fresh_accelerator()
    model = RegressionModel()
    pmodel, popt, pdl = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1), _loader(16, 2, 8))
    batches = list(pdl)
    before = _params(pmodel)
    with accelerator.no_sync(pmodel):
        accelerator.backward(pmodel.loss, batches[0])
        popt.step()
        popt.zero_grad()
    for a, b in zip(before, _params(pmodel)):
        np.testing.assert_array_equal(a, b)
    assert popt._grads(), "no_sync must keep the accumulated grads"
    accelerator.backward(pmodel.loss, batches[1])
    popt.step()
    popt.zero_grad()
    assert any(not np.allclose(a, b) for a, b in zip(before, _params(pmodel))), \
        "step after no_sync must apply the accumulated update"
    print("no_sync ✓")


def scheduler_step_check():
    """The scheduler advances only when the optimizer really stepped."""
    from accelerate_tpu_torch.test_utils.training import RegressionModel

    accelerator = _fresh_accelerator(gradient_accumulation_steps=2)
    model = RegressionModel()

    def schedule(step):  # optax.linear_schedule(0.1, 0.0, transition_steps=10)
        return 0.1 * (1.0 - min(step, 10) / 10)

    pmodel, popt, psched, pdl = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1), schedule,
                                                    _loader(32, 4, 8))
    counts = []
    for batch in pdl:
        with accelerator.accumulate(pmodel):
            accelerator.backward(pmodel.loss, batch)
            popt.step()
            psched.step()
            popt.zero_grad()
            counts.append(psched.step_count)
    # 4 batches, accumulation 2: the schedule advances on steps 2 and 4 only.
    assert counts == [0, 1, 1, 2], counts
    print("scheduler_step ✓")


def main():
    accumulation_equivalence_check()
    sync_flag_check()
    end_of_dataloader_check()
    grad_equality_at_boundaries_check()
    no_sync_check()
    scheduler_step_check()
    print("All sync checks passed.")


if __name__ == "__main__":
    main()
