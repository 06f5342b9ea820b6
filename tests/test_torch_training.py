"""The port's training path (`Accelerator.prepare` -> `train_step` and the
eager `backward`/`step` surface) held against the JAX package's on
`llama_tiny`, with the flax weights carried across by
`llama_state_dict_from_flax` and the same numpy token batches.

AdamW is set explicitly on both sides (lr, betas, eps, weight decay 1e-4:
optax's default decay is 1e-4, torch's 1e-2). JAX's `Accelerator` shards each
batch over the 8 virtual CPU devices of `tests/conftest.py`, so every global
batch is a multiple of 8.

Tolerances:
  - f32 losses, port against JAX: atol 1e-4 on losses of 4-7. Both run the
    same f32 operations; the GEMMs sum in another order (measured 1e-5 after
    8 steps), and Adam's normalised update carries those differences into
    the weights.
  - bf16 mixed precision, port against JAX: atol 1e-2. XLA fuses elementwise
    chains and rounds to bf16 at other places than PyTorch's per-op kernels
    (measured 1.2e-3 after 8 steps).
  - Port against port (fused against eager, accumulation against one large
    batch, K steps per call against K calls): rtol 2e-5, atol 1e-6, the JAX
    package's own tolerances for the same comparisons
    (`tests/test_train_step.py`); the arithmetic is the same up to the order
    of a few sums. Accumulated against one large batch the weights get
    atol 1e-5: there the gradient sums themselves run in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import optax

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.models import llama as port_llama
from accelerate_tpu_torch.state import AcceleratorState, GradientState


LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 1e-4
SEQ = 16
F32_VS_JAX = dict(atol=1e-4, rtol=0)
BF16_VS_JAX = dict(atol=1e-2, rtol=0)
PORT_VS_PORT = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch's CPU kernels on one thread. With a second OpenMP thread,
    `torch.exp` was seen to come back about 1e-4 off in a few fresh processes
    out of many on a shared CPU host, more than the comparisons here allow;
    on one thread it never did."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _reset_jax():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()


def _data(n, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (n, SEQ)).astype(np.int32)
    rows = [{"input_ids": ids[i]} for i in range(n)]
    if labels:
        for row in rows:
            lab = row["input_ids"].copy()
            lab[rng.random(SEQ) < 0.3] = -100
            row["labels"] = lab
    return rows


@pytest.fixture(scope="module")
def weights():
    """(JAX llama_tiny bundle, numpy params, port config), one init per module."""
    jcfg = jax_llama.llama_tiny()
    jmodel = jax_llama.create_llama_model(jcfg, seq_len=SEQ)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    cfg = port_llama.LlamaConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(port_llama.LlamaConfig)}
    )
    return jmodel, params, cfg


def _port_model(weights):
    _, params, cfg = weights
    model = port_llama.create_llama_model(cfg, device="cpu")
    model.load_state_dict(port_llama.llama_state_dict_from_flax(params, cfg))
    return model


def _adamw(model, lr=LR):
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=BETAS, eps=EPS, weight_decay=WD)


def _jax_losses(weights, data, batch, mixed_precision="no", max_grad_norm=1.0):
    _reset_jax()
    jmodel = dataclasses.replace(weights[0])
    accelerator = JaxAccelerator(mixed_precision=mixed_precision)
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    pmodel, _, loader = accelerator.prepare(jmodel, tx, JaxLoader(data, JaxBatchSampler(range(len(data)), batch)))
    step_fn = accelerator.train_step(max_grad_norm=max_grad_norm)
    return [float(step_fn(b)) for _ in range(2) for b in loader]


def _port_fused(weights, data, batch, mixed_precision="no", max_grad_norm=1.0, accumulation_steps=None,
                steps_per_call=1, epochs=2):
    model = _port_model(weights)
    accelerator = port.Accelerator(mixed_precision=mixed_precision, cpu=True)
    loader = port.SimpleDataLoader(data, port.BatchSampler(range(len(data)), batch))
    pmodel, _, loader = accelerator.prepare(model, _adamw(model), loader)
    step_fn = accelerator.train_step(max_grad_norm=max_grad_norm, accumulation_steps=accumulation_steps,
                                     steps_per_call=steps_per_call)
    losses = [float(step_fn(b)) for _ in range(epochs) for b in loader]
    return losses, pmodel


@pytest.mark.parametrize("mixed_precision,tol", [("no", F32_VS_JAX), ("bf16", BF16_VS_JAX), ("fp16", BF16_VS_JAX)],
                         ids=["f32", "bf16", "fp16"])
def test_train_step_losses_track_jax(weights, mixed_precision, tol):
    """Eight fused steps (two passes over four batches of 8) with clipping at
    1.0: the per-step losses of the port follow JAX's (fp16 with the default
    loss scaling on both sides)."""
    data = _data(32)
    expect = _jax_losses(weights, data, 8, mixed_precision)
    got, pmodel = _port_fused(weights, data, 8, mixed_precision)
    np.testing.assert_allclose(got, expect, **tol)
    assert got[-1] < got[0]
    # Master weights stay f32 under bf16 compute.
    assert all(p.dtype == torch.float32 for p in pmodel.parameters())


def test_labels_below_zero_are_ignored_like_jax(weights):
    """`causal_lm_loss` shifts, and drops positions labelled < 0, as JAX's
    does, on the same logits; the fused step trains on such batches too."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, SEQ, 512)).astype(np.float32)
    batch = {k: np.stack([r[k] for r in _data(2, labels=True)]) for k in ("input_ids", "labels")}
    expect = jax_llama.causal_lm_loss(None, batch, lambda p, ids, mask: logits)
    got = port_llama.causal_lm_loss({k: torch.as_tensor(v) for k, v in batch.items()},
                                    lambda ids, mask: torch.as_tensor(logits))
    np.testing.assert_allclose(float(got), float(expect), rtol=1e-6)
    all_ignored = {"input_ids": torch.as_tensor(batch["input_ids"]), "labels": torch.full((2, SEQ), -100)}
    assert float(port_llama.causal_lm_loss(all_ignored, lambda ids, mask: torch.as_tensor(logits))) == 0.0
    losses, _ = _port_fused(weights, _data(16, labels=True), 8, epochs=1)
    assert all(np.isfinite(losses))


def test_clip_grad_norm_matches_jax(weights):
    """Eager `backward` then `clip_grad_norm_`: the same pre-clip global norm
    as JAX's and the same clipped gradient."""
    data = _data(8, seed=3)
    _reset_jax()
    accelerator = JaxAccelerator()
    pm, popt, loader = accelerator.prepare(dataclasses.replace(weights[0]), optax.sgd(0.1),
                                           JaxLoader(data, JaxBatchSampler(range(8), 8)))
    batch = next(iter(loader))
    accelerator.backward(pm.loss, batch)
    jax_norm = float(accelerator.clip_grad_norm_(max_norm=0.5))
    jax_grad = np.asarray(popt.grads["params"]["lm_head"]["kernel"]).T

    model = _port_model(weights)
    accelerator = port.Accelerator(cpu=True)
    pm, popt, loader = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                           port.SimpleDataLoader(data, port.BatchSampler(range(8), 8)))
    accelerator.backward(pm.loss, next(iter(loader)))
    norm = float(accelerator.clip_grad_norm_(max_norm=0.5))
    assert jax_norm > 0.5  # the clip is active
    np.testing.assert_allclose(norm, jax_norm, rtol=1e-5)
    np.testing.assert_allclose(model.lm_head.weight.grad.numpy(), jax_grad, atol=1e-6, rtol=1e-4)


def _eager(weights, data, batch, accum=1, max_norm=None):
    model = _port_model(weights)
    accelerator = port.Accelerator(
        cpu=True, gradient_accumulation_plugin=port.GradientAccumulationPlugin(
            num_steps=accum, sync_with_dataloader=False))
    loader = port.SimpleDataLoader(data, port.BatchSampler(range(len(data)), batch))
    pmodel, popt, loader = accelerator.prepare(model, _adamw(model), loader)
    losses = []
    for _ in range(2):
        for b in loader:
            with accelerator.accumulate(pmodel):
                loss = accelerator.backward(pmodel.loss, b)
                if max_norm is not None:
                    accelerator.clip_grad_norm_(max_norm=max_norm)
                popt.step()
                popt.zero_grad()
            losses.append(float(loss))
    return losses, pmodel


def _assert_params_close(a, b, **tol):
    for (name, x), y in zip(a.module.named_parameters(), b.parameters()):
        torch.testing.assert_close(x, y, **(tol or PORT_VS_PORT), msg=lambda m: f"{name}: {m}")


def test_fused_matches_eager_trajectory(weights):
    """`train_step` against `backward` + `clip_grad_norm_` + `step` +
    `zero_grad` on the same batches: the same losses and weights."""
    data = _data(32, seed=5)
    eager_losses, eager_model = _eager(weights, data, 8, max_norm=0.5)
    fused_losses, fused_model = _port_fused(weights, data, 8, max_grad_norm=0.5)
    np.testing.assert_allclose(fused_losses, eager_losses, **PORT_VS_PORT)
    _assert_params_close(fused_model, eager_model)


def test_accumulation_matches_one_large_batch(weights):
    """Two microbatches of 8 accumulated (fused over a stacked 16, and eager
    under `accumulate` with two steps) give the weights of one batch of 16."""
    data = _data(32, seed=6)
    _, big = _port_fused(weights, data, 16, max_grad_norm=None)
    fused_losses, fused = _port_fused(weights, data, 16, max_grad_norm=None, accumulation_steps=2)
    _, eager = _eager(weights, data, 8, accum=2)
    assert len(fused_losses) == 4
    # The sums run in another order; Adam's g / sqrt(v) turns that rounding in
    # a near-zero gradient into a visible update: atol 1e-5 is 1% of one step.
    _assert_params_close(fused, big, rtol=1e-4, atol=1e-5)
    _assert_params_close(eager, big, rtol=1e-4, atol=1e-5)


def test_steps_per_call_matches_single_steps(weights):
    """K = 2 steps per call lands on the weights of 2 separate calls, and
    returns the last step's loss."""
    data = _data(32, seed=7)
    single_losses, single = _port_fused(weights, data, 8)
    loop_losses, loop = _port_fused(weights, data, 16, steps_per_call=2)
    _assert_params_close(loop, single)
    np.testing.assert_allclose(loop_losses, single_losses[1::2], **PORT_VS_PORT)
    with pytest.raises(ValueError, match="steps_per_call"):
        _port_fused(weights, data[:8], 8, steps_per_call=3)


def test_scheduler_lr_override_matches_jax(weights):
    """A linear decay prepared beside the optimizer drives the fused step's
    learning rate, step by step, as JAX's `inject_hyperparams` override
    does: the same losses and the same final learning rate."""
    data = _data(32, seed=8)
    _reset_jax()
    accelerator = JaxAccelerator()
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=LR, b1=BETAS[0], b2=BETAS[1], eps=EPS,
                                               weight_decay=WD)
    pm, popt, loader, sched = accelerator.prepare(
        dataclasses.replace(weights[0]), tx, JaxLoader(data, JaxBatchSampler(range(32), 8)),
        optax.linear_schedule(LR, 0.0, 8))
    step_fn = accelerator.train_step()
    expect = []
    for b in loader:
        expect.append(float(step_fn(b)))
        sched.step()

    model = _port_model(weights)
    accelerator = port.Accelerator(cpu=True)
    pm, opt, loader, sched = accelerator.prepare(
        model, _adamw(model, lr=1.0), port.SimpleDataLoader(data, port.BatchSampler(range(32), 8)),
        lambda step: LR * max(0.0, 1.0 - step / 8))
    assert opt.learning_rate == LR  # the schedule's first value replaced the optimizer's
    step_fn = accelerator.train_step()
    got = []
    for b in loader:
        got.append(float(step_fn(b)))
        sched.step()
    np.testing.assert_allclose(got, expect, **F32_VS_JAX)
    assert sched.step_count == 4
    np.testing.assert_allclose(opt.learning_rate, popt.learning_rate, rtol=1e-6)


def test_sync_boundary_and_data_loader(weights):
    """Tensors on the accelerator's device; the last batch of a pass forces a
    sync; `step` skips between syncs; a fused call marks the sync boundary."""
    model = _port_model(weights)
    accelerator = port.Accelerator(cpu=True, gradient_accumulation_steps=3)
    data = _data(16, seed=9)
    pmodel, popt, loader = accelerator.prepare(model, _adamw(model),
                                               port.SimpleDataLoader(data, port.BatchSampler(range(16), 4)))
    syncs = []
    for b in loader:
        assert isinstance(b["input_ids"], torch.Tensor) and b["input_ids"].shape == (4, SEQ)
        with accelerator.accumulate(pmodel):
            accelerator.backward(pmodel.loss, b)
            popt.step()
            popt.zero_grad()
        syncs.append(accelerator.sync_gradients)
    assert syncs == [False, False, True, True]  # every 3rd, and the end of the pass
    with accelerator.accumulate(pmodel):  # the first of the next three: no step
        accelerator.backward(pmodel.loss, b)
        popt.step()
        assert popt.step_was_skipped and not accelerator.sync_gradients
    step_fn = accelerator.train_step(accumulation_steps=1)
    accelerator.gradient_state._set_sync_gradients(False)
    step_fn(b)
    assert accelerator.sync_gradients


@pytest.mark.parametrize("mixed_precision,dtype", [("bf16", torch.bfloat16), ("fp16", torch.float16)],
                         ids=["bf16", "fp16"])
def test_mixed_precision_contract(weights, mixed_precision, dtype):
    """bf16 and fp16: the forward runs on copies in the compute dtype cast
    inside the autograd graph, logits come back f32, and the gradients land
    on the f32 masters; the module's own parameters are never cast. fp8
    runs on bf16 copies too, under the default recipe."""
    model = _port_model(weights)
    accelerator = port.Accelerator(mixed_precision=mixed_precision, cpu=True)
    pmodel = accelerator.prepare(model)
    ids = torch.as_tensor(_data(2)[0]["input_ids"])[None]
    logits = pmodel(ids)
    assert logits.dtype == torch.float32
    expect = model.to(dtype)(ids).float()
    model.float()
    torch.testing.assert_close(logits, expect, rtol=0, atol=0)
    pmodel.loss({"input_ids": ids}).backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
    AcceleratorState._reset_state()
    fp8 = port.Accelerator(mixed_precision="fp8", cpu=True)
    prepared = fp8.prepare(_port_model(weights))
    assert fp8.state.compute_dtype == torch.bfloat16 and prepared.compute_dtype == torch.bfloat16
    assert prepared.fp8_recipe == port.FP8RecipeKwargs()
