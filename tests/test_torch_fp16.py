"""fp16 mixed precision in the port: dynamic loss scaling (`GradScaler`),
the eager and fused fp16 steps, and K3-K5 on fp16 inputs, each held against
the JAX package on the same numpy inputs.

The regression tests are the ports of the JAX package's own fp16 tests
(`tests/test_training.py::test_fp16_scaler_skips_on_overflow`,
`tests/test_train_step.py::test_fused_fp16_clipping_matches_eager` and
`::test_fused_fp16_skips_on_overflow`) on a one-weight linear model whose
weights are carried across; both sides take every step or skip it alike.

Tolerances:
  - The scaler's scale and growth tracker: equal, step by step (the same
    host arithmetic on powers of two).
  - Regression weights, fused against eager and port against JAX: rtol
    2e-3, atol 1e-4, the JAX package's own tolerance for fused against eager
    fp16 clipping; both round the forward to fp16.
  - `llama_tiny` fp16 losses, port against JAX: atol 1e-2, the bf16
    tolerance of `test_torch_training.py` (fp16 keeps 3 more mantissa bits
    than bf16, so its rounding differences are smaller); the skip pattern
    and the final scale are equal.
  - Plain K3-K5 on fp16 inputs against JAX's Pallas kernels in interpret
    mode: atol 1e-3, rtol 1e-3. Both widen the fp16 inputs and sum in fp32,
    then round each output to fp16 (a relative 2^-11).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import flax.linen as nn

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.ops import flash_attention as jax_flash
from accelerate_tpu.optimizer import GradScaler as JaxGradScaler
from accelerate_tpu.utils import GradScalerKwargs as JaxGradScalerKwargs
from accelerate_tpu_torch.ops import flash_attention as port_flash
from accelerate_tpu_torch.optimizer import GradScaler
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import GradScalerKwargs

from test_torch_training import BETAS, EPS, LR, WD, _adamw, _data, _port_model, _reset_jax, weights  # noqa: F401

REGRESSION = dict(rtol=2e-3, atol=1e-4)
FP16_VS_JAX = dict(atol=1e-2, rtol=0)
KERNEL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch CPU thread, as in the other parity files: a second OpenMP
    thread was seen to move `torch.exp` by about 1e-4 now and then."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    _reset_port()
    yield
    _reset_port()


# ------------------------------------------------------------------ the scaler
@pytest.mark.parametrize("kwargs", [dict(), dict(init_scale=8.0, growth_interval=3, backoff_factor=0.25)],
                         ids=["defaults", "interval-3"])
def test_grad_scaler_follows_jax_over_a_flag_sequence(kwargs):
    """Scale and growth tracker after each update equal JAX's, over a fixed
    sequence of overflow flags that backs off, grows and backs off again;
    `state_dict` has JAX's keys and restores the same state."""
    flags = [True, True, False, False, False, False, True, False, False, False, False, False, False, True]
    ours, theirs = GradScaler(GradScalerKwargs(**kwargs)), JaxGradScaler(JaxGradScalerKwargs(**kwargs))
    assert ours.state_dict() == theirs.state_dict()
    for flag in flags:
        ours.update(flag)
        theirs.update(flag)
        assert ours.state_dict() == theirs.state_dict()
    restored = GradScaler(GradScalerKwargs(**kwargs))
    restored.load_state_dict(ours.state_dict())
    assert restored.state_dict() == ours.state_dict() and set(ours.state_dict()) == {"scale", "growth_tracker"}
    disabled = GradScaler(GradScalerKwargs(enabled=False))
    disabled.update(True)
    assert disabled.scale == 65536.0


# ------------------------------------------------------------------ regression model
class _JaxRegression(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(1, name="linear")(x)


def _jax_regression_loss(params, batch, apply_fn):
    pred = apply_fn(params, batch["x"])
    return jnp.mean((pred[:, 0] - batch["y"]) ** 2)


class _Regression(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = torch.nn.Linear(1, 1)

    def forward(self, x):
        return self.linear(x)


def _regression_loss(batch, apply_fn):
    pred = apply_fn(batch["x"])
    return ((pred[:, 0] - batch["y"]) ** 2).mean()


def _jax_regression():
    module = _JaxRegression()
    params = module.init(jax.random.key(0), jnp.zeros((1, 1)))
    return JaxModel.from_flax(module, params, loss_fn=_jax_regression_loss)


def _port_regression(jmodel):
    """The port's model with JAX's initial weights."""
    model = _Regression()
    dense = jmodel.params["params"]["linear"]
    with torch.no_grad():
        model.linear.weight.copy_(torch.as_tensor(np.array(dense["kernel"]).T))
        model.linear.bias.copy_(torch.as_tensor(np.array(dense["bias"])))
    return port.Model(model, loss_fn=_regression_loss)


def _regression_data(n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, 1)).astype(np.float32)
    ys = (2 * xs[:, 0] + 3 + 0.01 * rng.normal(size=n)).astype(np.float32)
    return [{"x": xs[i], "y": ys[i]} for i in range(n)]


def _weights(pmodel):
    lin = pmodel.module.linear
    return np.concatenate([lin.weight.detach().numpy().ravel(), lin.bias.detach().numpy().ravel()])


def _jax_weights(pmodel):
    dense = pmodel.params["params"]["linear"]
    return np.concatenate([np.asarray(dense["kernel"]).ravel(), np.asarray(dense["bias"]).ravel()])


@pytest.mark.parametrize("bad", [np.inf, np.nan], ids=["inf", "nan"])
def test_eager_fp16_skips_a_non_finite_step_like_jax(bad):
    """`backward` of a loss that is inf (NaN) times the weights, then `step`:
    skipped, the scale halves, the weights and SGD's momentum are unchanged;
    JAX's eager path does the same on the same weights. Then a batch whose
    gradients overflow fp16 at the halved scale (skipped again) and one
    whose gradients fit (applied): both sides skip alike and land on the
    same weights."""
    _reset_jax()
    jmodel = _jax_regression()
    accelerator = JaxAccelerator(mixed_precision="fp16")
    jpm, jopt = accelerator.prepare(jmodel, optax.sgd(0.1, momentum=0.9))
    accelerator.backward(lambda p, b: jnp.sum(p["params"]["linear"]["kernel"]) * bad, {"x": np.ones((8, 1), np.float32)})
    jopt.step()
    jax_flags, jax_scales = [jopt.step_was_skipped], [accelerator.scaler.scale]
    # 8 rows of weight gradient 2 (w - 5) / 8 * 32768 overflow fp16; at x = 0.1, y = 0 they fit.
    batches = [{"x": np.ones((8, 1), np.float32), "y": np.full(8, 5.0, np.float32)},
               {"x": np.full((8, 1), 0.1, np.float32), "y": np.zeros(8, np.float32)}]
    for batch in batches:
        jopt.zero_grad()
        accelerator.backward(jpm.loss, batch)
        jopt.step()
        jax_flags.append(jopt.step_was_skipped)
        jax_scales.append(accelerator.scaler.scale)

    pmodel = _port_regression(jmodel)
    accelerator = port.Accelerator(mixed_precision="fp16", cpu=True)
    sgd = torch.optim.SGD(pmodel.module.parameters(), lr=0.1, momentum=0.9)
    pm, popt = accelerator.prepare(pmodel, sgd)
    before = _weights(pm)
    assert accelerator.scaler is popt.scaler and accelerator.scaler.scale == 65536.0
    accelerator.backward(lambda b: pm.module.linear.weight.sum() * float(bad), None)
    popt.step()
    flags, scales = [popt.step_was_skipped], [accelerator.scaler.scale]
    np.testing.assert_array_equal(_weights(pm), before)
    assert not sgd.state  # the momentum buffer was never written
    for batch in batches:
        popt.zero_grad()
        accelerator.backward(pm.loss, {k: torch.as_tensor(v) for k, v in batch.items()})
        popt.step()
        flags.append(popt.step_was_skipped)
        scales.append(accelerator.scaler.scale)
    assert flags == jax_flags
    assert flags == [True, True, False]
    assert scales == jax_scales
    assert scales == [32768.0, 16384.0, 16384.0]
    assert not np.array_equal(_weights(pm), before)
    np.testing.assert_allclose(_weights(pm), _jax_weights(jpm), **REGRESSION)


def _run_regression(fused, jax_side, max_norm=0.5, epochs=2, data_seed=11):
    data = _regression_data(64, data_seed)
    if jax_side:
        _reset_jax()
        accelerator = JaxAccelerator(mixed_precision="fp16")
        pm, popt, dl = accelerator.prepare(_jax_regression(), optax.sgd(0.05),
                                           JaxLoader(data, JaxBatchSampler(range(64), 16)))
    else:
        _reset_port()
        accelerator = port.Accelerator(mixed_precision="fp16", cpu=True)
        pmodel = _port_regression(_jax_regression())
        pm, popt, dl = accelerator.prepare(pmodel, torch.optim.SGD(pmodel.module.parameters(), lr=0.05),
                                           port.SimpleDataLoader(data, port.BatchSampler(range(64), 16)))
    if fused:
        step_fn = accelerator.train_step(max_grad_norm=max_norm)
        for _ in range(epochs):
            for batch in dl:
                step_fn(batch)
    else:
        for _ in range(epochs):
            for batch in dl:
                with accelerator.accumulate(pm):
                    accelerator.backward(pm.loss, batch)
                    accelerator.clip_grad_norm_(max_norm=max_norm)
                    popt.step()
                    popt.zero_grad()
    return (_jax_weights(pm) if jax_side else _weights(pm)), accelerator.scaler.state_dict()


def test_fused_fp16_clipping_matches_eager_and_jax():
    """fp16 with clipping at 0.5: the fused and the eager paths both clip the
    unscaled gradients and land on the same weights, and on JAX's fused
    fp16 weights; the scaler ends where JAX's does."""
    fused, fused_scaler = _run_regression(fused=True, jax_side=False)
    eager, eager_scaler = _run_regression(fused=False, jax_side=False)
    jax_fused, jax_scaler = _run_regression(fused=True, jax_side=True)
    np.testing.assert_allclose(fused, eager, **REGRESSION)
    np.testing.assert_allclose(fused, jax_fused, **REGRESSION)
    # Gradients of 16 rows overflow fp16 at the first scales: the scaler
    # backs off until they fit, alike on every path.
    assert fused_scaler == eager_scaler
    assert fused_scaler == jax_scaler
    assert fused_scaler["scale"] < 65536.0 and fused_scaler["growth_tracker"] > 0
    # Clipping bit: with max_norm 0.5 the weights moved less than without it.
    unclipped, _ = _run_regression(fused=True, jax_side=False, max_norm=None)
    initial = _weights(_port_regression(_jax_regression()))
    assert np.abs(fused - initial).sum() < np.abs(unclipped - initial).sum()


@pytest.mark.parametrize("bad", [np.inf, np.nan], ids=["inf", "nan"])
def test_fused_fp16_skips_on_overflow_like_jax(bad):
    """A batch of inf (NaN) inputs through the fused step with clipping: the
    step is skipped, the scale backs off, the weights are unchanged (the
    clip's inf * 0 is NaN, and the check still sees it); a good batch is
    then skipped while its gradients overflow fp16 and applied once the
    scale has backed off far enough. The skip flags and scales equal
    JAX's."""
    data = _regression_data(16, 8)
    bad_batch = {"x": np.full((8, 1), bad, np.float32), "y": np.zeros(8, np.float32)}
    runs = {}
    for side in ("jax", "port"):
        if side == "jax":
            _reset_jax()
            accelerator = JaxAccelerator(mixed_precision="fp16")
            pm, popt, dl = accelerator.prepare(_jax_regression(), optax.sgd(0.05),
                                               JaxLoader(data, JaxBatchSampler(range(16), 8)))
            weights_of = _jax_weights
        else:
            _reset_port()
            accelerator = port.Accelerator(mixed_precision="fp16", cpu=True)
            pmodel = _port_regression(_jax_regression())
            pm, popt, dl = accelerator.prepare(pmodel, torch.optim.SGD(pmodel.module.parameters(), lr=0.05),
                                               port.SimpleDataLoader(data, port.BatchSampler(range(16), 8)))
            bad_batch = {k: torch.as_tensor(v) for k, v in bad_batch.items()}
            weights_of = _weights
        step_fn = accelerator.train_step(max_grad_norm=1.0)
        before = weights_of(pm)
        step_fn(bad_batch)
        flags, scales = [popt.step_was_skipped], [popt.scaler.scale]
        np.testing.assert_array_equal(weights_of(pm), before)
        good = next(iter(dl))
        for _ in range(3):
            step_fn(good)
            flags.append(popt.step_was_skipped)
            scales.append(popt.scaler.scale)
        runs[side] = (flags, scales, weights_of(pm))
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][0][0] and not runs["port"][0][-1]  # the bad batch skipped, a good one applied
    assert runs["port"][1] == runs["jax"][1]
    np.testing.assert_allclose(runs["port"][2], runs["jax"][2], **REGRESSION)


def test_steps_per_call_refuses_an_enabled_scaler():
    """K steps per call read the scale once: with fp16's scaler enabled it
    raises, as JAX does; with the scaler disabled it runs."""
    pmodel = _port_regression(_jax_regression())
    accelerator = port.Accelerator(mixed_precision="fp16", cpu=True)
    accelerator.prepare(pmodel, torch.optim.SGD(pmodel.module.parameters(), lr=0.05))
    with pytest.raises(ValueError, match="steps_per_call > 1 cannot honor dynamic fp16 loss scaling"):
        accelerator.train_step(steps_per_call=2)
    _reset_port()
    pmodel = _port_regression(_jax_regression())
    accelerator = port.Accelerator(mixed_precision="fp16", cpu=True,
                                   kwargs_handlers=[GradScalerKwargs(enabled=False)])
    pm, _ = accelerator.prepare(pmodel, torch.optim.SGD(pmodel.module.parameters(), lr=0.05))
    batch = {k: torch.as_tensor(np.stack([r[k] for r in _regression_data(4, 0)])) for k in ("x", "y")}
    assert np.isfinite(float(accelerator.train_step(steps_per_call=2)(batch)))


# ------------------------------------------------------------------ llama_tiny
def test_llama_tiny_fp16_steps_track_jax(weights):  # noqa: F811
    """Eight fused fp16 steps of `llama_tiny` from the same weights, with an
    initial scale of 2^24 that overflows fp16 in the first steps and a
    growth interval of 3: the per-step losses follow JAX's, the steps that
    were skipped are the same and the final scale is equal."""
    data = _data(32)
    kwargs = dict(init_scale=2.0 ** 24, growth_interval=3)
    _reset_jax()
    accelerator = JaxAccelerator(mixed_precision="fp16", kwargs_handlers=[JaxGradScalerKwargs(**kwargs)])
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    _, jopt, loader = accelerator.prepare(dataclasses.replace(weights[0]), tx,
                                          JaxLoader(data, JaxBatchSampler(range(32), 8)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    expect, expect_skips = [], []
    for _ in range(2):
        for b in loader:
            expect.append(float(step_fn(b)))
            expect_skips.append(jopt.step_was_skipped)

    model = _port_model(weights)
    accelerator = port.Accelerator(mixed_precision="fp16", cpu=True, kwargs_handlers=[GradScalerKwargs(**kwargs)])
    pm, popt, loader = accelerator.prepare(model, _adamw(model), port.SimpleDataLoader(data, port.BatchSampler(range(32), 8)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    got, skips = [], []
    for _ in range(2):
        for b in loader:
            got.append(float(step_fn(b)))
            skips.append(popt.step_was_skipped)
    assert skips == expect_skips
    assert any(skips) and not all(skips)
    assert popt.scaler.state_dict() == jopt.scaler.state_dict()
    np.testing.assert_allclose(got, expect, **FP16_VS_JAX)
    assert all(p.dtype == torch.float32 for p in pm.parameters())


# ------------------------------------------------------------------ K3-K5 in fp16
@pytest.mark.parametrize(
    "bh,s,sk,d,causal",
    [(4, 128, 128, 32, True), (2, 64, 192, 64, True), (3, 128, 128, 64, False)],
    ids=["causal", "causal-cross", "full"],
)
def test_plain_kernels_in_fp16_match_pallas_interpret(bh, s, sk, d, causal):
    """Block level on fp16 inputs: plain K3 against `_fwd_call` (o in fp16,
    lse in fp32), plain K4/K5 against `_bwd_call` from the same o and lse
    (dq, dk, dv in fp16)."""
    rng = np.random.default_rng(s + d)
    q, k, v, do = (rng.normal(size=shape).astype(np.float16)
                   for shape in ((bh, s, d), (bh, sk, d), (bh, sk, d), (bh, s, d)))
    scale = 1.0 / np.sqrt(d)
    o, lse = jax_flash._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, 64, 64, True)
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    po, plse = port_flash.flash_fwd(t(q), t(k), t(v), causal=causal, scale=scale)
    assert o.dtype == jnp.float16 and po.dtype == torch.float16 and plse.dtype == torch.float32
    np.testing.assert_allclose(po.float().numpy(), np.asarray(o, np.float32), **KERNEL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[..., 0], **KERNEL)
    grads = jax_flash._bwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(do), scale,
                                causal, 64, 64, True)
    port_grads = port_flash.flash_bwd(t(q), t(k), t(v), t(o), t(np.asarray(lse)[..., 0]), t(do),
                                      causal=causal, scale=scale)
    for name, ref, got in zip(("dq", "dk", "dv"), grads, port_grads):
        assert ref.dtype == jnp.float16 and got.dtype == torch.float16, name
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **KERNEL, err_msg=name)
