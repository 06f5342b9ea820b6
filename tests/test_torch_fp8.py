"""The port's fp8 mixed precision (`accelerate_tpu_torch/ops/fp8.py`,
`FP8RecipeKwargs`, ``Accelerator(mixed_precision="fp8")``) held against the
JAX package's `accelerate_tpu/ops/fp8.py` on the same numpy inputs: one case
for each of `tests/test_fp8.py`'s, then the hazards of the port.

On the CPU both sides take the product on the fp8 values in f32 (XLA's CPU
lowering widens both operands; the port's plain version does the same) and
scale it after, so:
  - quantized values and scales: equal bit for bit;
  - f32 products and their gradients: rtol 1e-5 (the f32 sums run in
    another order);
  - the delayed recipe's rolled histories: equal;
  - llama_tiny fp8 training through `train_step`, port against JAX: atol
    1e-2 on losses of about 6, the bf16 tolerance of
    `tests/test_torch_training.py` (XLA rounds its fused bf16 chains at
    other places than PyTorch's per-op kernels, which can move an fp8
    rounding); AdamW's weight decay set on both sides (optax 1e-4, torch
    1e-2 by default);
  - the same under activation checkpointing, port against port: rtol 1e-6.
"""

import dataclasses
import logging
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.models import create_named_model as jax_create_named_model
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils import FP8RecipeKwargs as JaxFP8RecipeKwargs
from accelerate_tpu_torch.models import MODEL_REGISTRY, create_named_model
from accelerate_tpu_torch.models import llama as port_llama
from accelerate_tpu_torch.models.resnet import create_resnet_model, resnet_tiny
from accelerate_tpu_torch.ops import fp8 as pfp8
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import FP8RecipeKwargs

F32 = dict(rtol=1e-5, atol=1e-6)
LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 1e-4
SEQ = 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    pfp8.reset_product_counts()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


def _t(x, **kw):
    return torch.tensor(np.asarray(x), **kw)


def _rand(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _port_grads(fn, *arrays):
    xs = [_t(a, requires_grad=True) for a in arrays]
    out = fn(*xs)
    grads = torch.autograd.grad(out.square().sum(), xs)
    return out, grads


# ---------------------------------------------------------------- dynamic scaling
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_fp8_round_trip(fmt, dtype):
    """Values and scale equal JAX's bit for bit (and round-trip within e4m3's
    two decimal digits, JAX's own check)."""
    x = _rand(0, 32, 16) * 3.0
    jx = jnp.asarray(x, dtype=dtype)
    jq, js = jfp8.quantize_fp8(jx, jfp8.E4M3 if fmt == "e4m3" else jfp8.E5M2)
    q, s = pfp8.quantize_fp8(_t(x).to(getattr(torch, dtype)), pfp8.E4M3 if fmt == "e4m3" else pfp8.E5M2)
    assert q.dtype == (torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2)
    np.testing.assert_array_equal(q.float().numpy(), np.asarray(jq.astype(jnp.float32)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    recon = q.float() * s
    rel = (recon - _t(jx.astype(jnp.float32))).abs().mean() / _t(jx.astype(jnp.float32)).abs().mean()
    assert rel < (0.05 if fmt == "e4m3" else 0.1), rel


def test_fp8_matmul_close_to_fp32():
    x, w = _rand(1, 8, 64), _rand(2, 64, 32, scale=0.05)
    out = pfp8.fp8_matmul(_t(x), _t(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(jfp8.fp8_matmul(jnp.asarray(x), jnp.asarray(w))), **F32)
    ref = x @ w
    assert np.abs(out.numpy() - ref).mean() / np.abs(ref).mean() < 0.06
    assert pfp8.PRODUCTS == {"fwd": 1, "dx": 0, "dw": 0}


@pytest.mark.parametrize("hybrid", [True, False], ids=["hybrid", "e4m3"])
def test_fp8_matmul_grads_flow(hybrid):
    """Forward, dx and dw equal JAX's custom VJP: the cotangent in e5m2
    under HYBRID, e4m3 otherwise; x with two leading dims."""
    x, w = _rand(3, 2, 4, 16), _rand(4, 16, 8, scale=0.1)
    jout = jfp8.fp8_matmul(jnp.asarray(x), jnp.asarray(w), hybrid)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jnp.square(jfp8.fp8_matmul(a, b, hybrid))), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    out, (dx, dw) = _port_grads(lambda a, b: pfp8.fp8_matmul(a, b, hybrid), x, w)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **F32)
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), **F32)
    np.testing.assert_allclose(_np(dw), np.asarray(jdw), **F32)
    g_ref = 2 * np.einsum("bsk,bsn->kn", x, np.einsum("bsk,kn->bsn", x, w))
    assert np.abs(_np(dw) - g_ref).mean() / np.abs(g_ref).mean() < 0.1
    assert pfp8.PRODUCTS == {"fwd": 1, "dx": 1, "dw": 1}


def test_fp8_matmul_of_an_inf_is_nan():
    """An inf in x makes the scale inf: JAX's output is NaN throughout (inf /
    inf, then 0 x inf), and so is the port's, not a number saturated at
    448 by torch's cast."""
    x, w = _rand(5, 4, 16), _rand(6, 16, 8)
    x[1, 3] = np.inf
    jout = np.asarray(jfp8.fp8_matmul(jnp.asarray(x), jnp.asarray(w)))
    out = pfp8.fp8_matmul(_t(x), _t(w)).numpy()
    assert np.isnan(jout).all()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(jout))


def _jax_dense_net(features, x, seed=0):
    import flax.linen as nn

    class Net(nn.Module):
        @nn.compact
        def __call__(self, h):
            for i, f in enumerate(features):
                h = nn.Dense(f, name=f"d{i}")(h)
                if i < len(features) - 1:
                    h = nn.relu(h)
            return h

    net = Net()
    return net, net.init(jax.random.key(seed), jnp.asarray(x))


def _port_dense_net(variables, features, n_in, layer=torch.nn.Linear):
    mods = []
    for i, f in enumerate(features):
        lin = layer(n_in, f)
        node = variables["params"][f"d{i}"]
        with torch.no_grad():
            lin.weight.copy_(_t(node["kernel"]).T)
            lin.bias.copy_(_t(node["bias"]))
        mods += [lin, torch.nn.ReLU()]
        n_in = f
    return torch.nn.Sequential(*mods[:-1])


def _moved_biases(variables, features):
    """flax inits biases at 0, which would hide a dropped bias: move them."""
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    for i in range(len(features)):
        params[f"d{i}"]["bias"] = params[f"d{i}"]["bias"] + 0.01 * (i + 1)
    return {**variables, "params": params}


@pytest.mark.parametrize("layer", ["linear", "dense"])
def test_fp8_autocast_intercepts_dense(layer):
    """Every linear layer inside the autocast runs fp8 (torch's `nn.Linear`
    and the models' `Dense` alike), bias added after: JAX's interceptor's
    output, which differs from the plain product and stays close to it."""
    from accelerate_tpu_torch.models.decoder import Dense

    x = _rand(3, 4, 16)
    jnet, variables = _jax_dense_net([8], x)
    variables = _moved_biases(variables, [8])
    net = _port_dense_net(variables, [8], 16, Dense if layer == "dense" else torch.nn.Linear)
    with jfp8.fp8_autocast():
        jout = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    ref = net(_t(x)).detach().numpy()
    with pfp8.fp8_autocast():
        out = net(_t(x)).detach().numpy()
    np.testing.assert_allclose(out, jout, **F32)
    assert not np.allclose(out, ref, atol=0)
    assert np.abs(out - ref).mean() / np.abs(ref).mean() < 0.1
    assert pfp8.PRODUCTS["fwd"] == 1
    np.testing.assert_array_equal(net(_t(x)).detach().numpy(), ref)  # the autocast has left


def test_fp8_dense_module():
    """`Fp8Linear` always runs fp8 (JAX's `Fp8Dense`), outside any autocast."""
    x = _rand(4, 4, 16)
    layer = jfp8.Fp8Dense(8)
    params = layer.init(jax.random.key(0), jnp.asarray(x))
    jout = np.asarray(jax.jit(layer.apply)(params, jnp.asarray(x)))
    lin = pfp8.Fp8Linear(16, 8)
    with torch.no_grad():
        lin.weight.copy_(_t(params["params"]["kernel"]).T)
        lin.bias.zero_()
    out = lin(_t(x)).detach().numpy()
    assert out.shape == (4, 8) and np.isfinite(out).all()
    np.testing.assert_allclose(out, jout, **F32)


def test_fp8_training_through_accelerator():
    """BERT-tiny through ``Accelerator(mixed_precision="fp8",
    kwargs_handlers=[FP8RecipeKwargs()])``, `prepare` and `backward`: the
    prepared model carries the recipe, the losses are finite, and every
    linear layer's product ran in fp8, forward and backward."""
    from accelerate_tpu_torch.models.bert import bert_tiny, create_bert_model

    accelerator = port.Accelerator(mixed_precision="fp8", cpu=True, kwargs_handlers=[FP8RecipeKwargs()])
    model = create_bert_model(bert_tiny(), device="cpu")
    n_linear = sum(isinstance(m, torch.nn.Linear) for m in model.modules())
    rng = np.random.default_rng(0)
    data = [{"input_ids": rng.integers(1, 500, size=(16,)).astype(np.int64), "labels": np.int64(rng.integers(0, 2))}
            for _ in range(16)]
    loader = port.SimpleDataLoader(data, port.BatchSampler(range(16), 8))
    pmodel, opt, loader = accelerator.prepare(model, torch.optim.Adam(model.parameters(), 1e-3), loader)
    assert isinstance(pmodel.fp8_recipe, FP8RecipeKwargs) and pmodel.compute_dtype == torch.bfloat16
    losses = []
    for batch in loader:
        loss = accelerator.backward(pmodel.loss, batch)
        opt.step()
        opt.zero_grad()
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert pfp8.PRODUCTS == {"fwd": 2 * n_linear, "dx": 2 * n_linear, "dw": 2 * n_linear}


# ---------------------------------------------------------------- delayed scaling
def _port_meta(jmeta, requires_grad=False):
    return {k: _t(v, requires_grad=requires_grad) for k, v in jmeta.items()}


def _jax_delayed_step(x, w, meta):
    def loss(x_, w_, meta_):
        return jnp.sum(jfp8.fp8_matmul_delayed(x_, w_, meta_))

    return jax.grad(loss, argnums=(0, 2))(jnp.asarray(x), jnp.asarray(w), meta)[1]


def _port_delayed_step(x, w, meta, square=False, **kw):
    meta = {k: v.detach().clone().requires_grad_() for k, v in meta.items()}
    xs, ws = _t(x, requires_grad=True), _t(w, requires_grad=True)
    out = pfp8.fp8_matmul_delayed(xs, ws, meta, **kw)
    grads = torch.autograd.grad(out.square().sum() if square else out.sum(), [xs, ws, *meta.values()])
    return dict(zip(meta, grads[2:])), grads[:2]


def test_delayed_cold_start_uses_unit_scale():
    """Zeroed histories behave like scale 1.0, as JAX's do."""
    x, w = _rand(0, 8, 32), _rand(1, 32, 16, scale=0.1)
    jout = np.asarray(jfp8.fp8_matmul_delayed(jnp.asarray(x), jnp.asarray(w), jfp8.init_fp8_meta(4)))
    out = pfp8.fp8_matmul_delayed(_t(x), _t(w), pfp8.init_fp8_meta(4)).numpy()
    np.testing.assert_allclose(out, jout, **F32)
    ref = x @ w
    assert np.isfinite(out).all() and np.abs(out - ref).mean() / np.abs(ref).mean() < 0.25


def test_delayed_meta_cotangent_is_the_rolled_history():
    """The histories' gradient IS the updated meta, JAX's exactly: shifted
    one slot, this step's amaxes (x, w from the forward, g from the
    backward) appended; dx and dw as JAX's."""
    x, w = _rand(1, 4, 8, scale=3.0), _rand(2, 8, 4, scale=0.5)
    jmeta = {k: v.at[-1].set(0.125) for k, v in jfp8.init_fp8_meta(3).items()}

    def loss(x_, w_, meta_):
        return jnp.sum(jfp8.fp8_matmul_delayed(x_, w_, meta_) ** 2)

    jdx, jdw, jnew = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jmeta)
    new, (dx, dw) = _port_delayed_step(x, w, _port_meta(jmeta), square=True)
    for k in jnew:
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))
        assert new[k][-2] == pytest.approx(0.125)
    assert new["x_amax_history"][-1] == pytest.approx(float(np.abs(x).max()), rel=1e-6)
    assert float(new["g_amax_history"][-1]) > 0.0
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), **F32)
    np.testing.assert_allclose(_np(dw), np.asarray(jdw), **F32)


def test_delayed_warm_history_matches_dynamic():
    """After the window has seen the live amaxes, delayed equals dynamic."""
    x, w = _rand(2, 16, 64), _rand(3, 64, 32, scale=0.2)
    jmeta, meta = jfp8.init_fp8_meta(4), pfp8.init_fp8_meta(4)
    for _ in range(3):
        jmeta = _jax_delayed_step(x, w, jmeta)
        meta, _ = _port_delayed_step(x, w, meta)
    for k in jmeta:
        np.testing.assert_array_equal(meta[k].numpy(), np.asarray(jmeta[k]))
    warm = pfp8.fp8_matmul_delayed(_t(x), _t(w), meta).detach().numpy()
    np.testing.assert_allclose(warm, np.asarray(jfp8.fp8_matmul_delayed(jnp.asarray(x), jnp.asarray(w), jmeta)), **F32)
    np.testing.assert_allclose(warm, pfp8.fp8_matmul(_t(x), _t(w)).numpy(), rtol=1e-5, atol=1e-5)


def test_delayed_scale_uses_window_max_and_saturates():
    """A shrinking input keeps the window max; one beyond the stale scale is
    clipped to 448 x scale before the cast (JAX: finite, not NaN), as JAX's."""
    w = np.eye(4, dtype=np.float32)
    jmeta = _jax_delayed_step(np.full((1, 4), 100.0, np.float32), w, jfp8.init_fp8_meta(4))
    meta, _ = _port_delayed_step(np.full((1, 4), 100.0, np.float32), w, pfp8.init_fp8_meta(4))
    assert float(meta["x_amax_history"][-1]) == pytest.approx(100.0)
    for value in (1.0, 1e6):
        xin = np.full((1, 4), value, np.float32)
        jout = np.asarray(jfp8.fp8_matmul_delayed(jnp.asarray(xin), jnp.asarray(w), jmeta))
        out = pfp8.fp8_matmul_delayed(_t(xin), _t(w), meta).detach().numpy()
        np.testing.assert_allclose(out, jout, **F32)
        assert np.isfinite(out).all()
    small = pfp8.fp8_matmul_delayed(_t(np.full((1, 4), 1.0, np.float32)), _t(w), meta).detach().numpy()
    assert small.max() == pytest.approx(1.0, rel=0.2)


def test_autocast_delayed_owns_module_histories():
    """Under ``scaling="delayed"`` each linear layer keeps its forward
    histories (``module.fp8_meta``), rolled inside ``fp8_autocast(recipe,
    update_meta=True)`` (JAX's ``mutable=["fp8_meta"]``) and read as they are
    outside it: JAX's outputs and histories."""
    x = _rand(3, 4, 12, scale=2.0)
    jnet, variables = _jax_dense_net([16, 8], x)
    variables = _moved_biases(variables, [16, 8])
    net = _port_dense_net(variables, [16, 8], 12)
    jrecipe = JaxFP8RecipeKwargs(scaling="delayed", amax_history_len=4)
    recipe = FP8RecipeKwargs(scaling="delayed", amax_history_len=4)
    with jfp8.fp8_autocast(jrecipe):
        jout1, mut = jnet.apply(variables, jnp.asarray(x), mutable=["fp8_meta"])
        jout2 = jnet.apply({**variables, **mut}, jnp.asarray(x))
    with pfp8.fp8_autocast(recipe, update_meta=True):
        out1 = net(_t(x)).detach().numpy()
    with pfp8.fp8_autocast(recipe):
        out2 = net(_t(x)).detach().numpy()
    for i, lin in enumerate([net[0], net[2]]):
        for k in ("x_amax_history", "w_amax_history"):
            assert lin.fp8_meta[k].shape == (4,)
            np.testing.assert_allclose(lin.fp8_meta[k].numpy(), np.asarray(mut["fp8_meta"][f"d{i}"][k]), rtol=1e-6)
    assert all(float(lin.fp8_meta["x_amax_history"].max()) > 0 for lin in (net[0], net[2]))
    np.testing.assert_allclose(out1, np.asarray(jout1), **F32)
    np.testing.assert_allclose(out2, np.asarray(jout2), **F32)
    assert not np.allclose(out1, out2)


def test_dynamic_vs_delayed_accuracy_measured():
    """On magnitudes that decay 10x, dynamic scaling quantizes at least as
    tightly as a warm delayed window; each error equals JAX's."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 32)).astype(np.float32) * 0.2
    jmeta, meta = jfp8.init_fp8_meta(8), pfp8.init_fp8_meta(8)
    dyn, dele, jdyn, jdele = [], [], [], []

    def qerr(out, ref):
        return float(np.abs(_np(out) - ref).mean() / (np.abs(ref).mean() + 1e-9))

    for step in range(10):
        x = rng.normal(size=(16, 64)).astype(np.float32) * 10.0 * (0.1 ** (step / 9))
        ref = x @ w
        dyn.append(qerr(pfp8.fp8_matmul(_t(x), _t(w)), ref))
        dele.append(qerr(pfp8.fp8_matmul_delayed(_t(x), _t(w), meta), ref))
        jdyn.append(qerr(jfp8.fp8_matmul(jnp.asarray(x), jnp.asarray(w)), ref))
        jdele.append(qerr(jfp8.fp8_matmul_delayed(jnp.asarray(x), jnp.asarray(w), jmeta), ref))
        jmeta = _jax_delayed_step(x, w, jmeta)
        meta, _ = _port_delayed_step(x, w, meta)
    np.testing.assert_allclose(dyn, jdyn, rtol=1e-4)
    np.testing.assert_allclose(dele, jdele, rtol=1e-4)
    assert np.mean(dyn) <= np.mean(dele) * 1.05, (np.mean(dyn), np.mean(dele))


def test_delayed_through_prepared_model_warns_frozen_histories(caplog):
    """The prepared model never rolls histories: a delayed recipe trains on
    the cold scale, and `prepare` says so, as JAX's does."""
    from accelerate_tpu_torch.models.bert import bert_tiny, create_bert_model

    accelerator = port.Accelerator(mixed_precision="fp8", cpu=True,
                                   kwargs_handlers=[FP8RecipeKwargs(scaling="delayed")])
    with caplog.at_level(logging.WARNING, logger="accelerate_tpu_torch.modeling"):
        accelerator.prepare(create_bert_model(bert_tiny(), device="cpu"))
    assert any("frozen" in r.getMessage() for r in caplog.records), caplog.records


def test_delayed_most_recent_algo_tracks_last_step():
    """``most_recent`` follows the last amax, ``max`` the window's, as JAX's."""
    w = np.eye(4, dtype=np.float32)
    jmeta, meta = jfp8.init_fp8_meta(4), pfp8.init_fp8_meta(4)
    for value in (100.0, 1.0):
        x = np.full((1, 4), value, np.float32)
        jmeta = _jax_delayed_step(x, w, jmeta)
        meta, _ = _port_delayed_step(x, w, meta)
    for algo, expect in (("max", 100.0 / 448.0), ("most_recent", 1.0 / 448.0)):
        s = float(pfp8._history_scale(meta["x_amax_history"], 448.0, algo))
        assert s == float(jfp8._history_scale(jmeta["x_amax_history"], 448.0, algo))
        assert s == pytest.approx(expect, rel=1e-5)
    one = np.full((1, 4), 1.0, np.float32)
    errs = {}
    for algo in ("most_recent", "max"):
        out = pfp8.fp8_matmul_delayed(_t(one), _t(w), meta, True, algo).detach().numpy()
        np.testing.assert_allclose(out, np.asarray(jfp8.fp8_matmul_delayed(jnp.asarray(one), jnp.asarray(w), jmeta,
                                                                             True, algo)), **F32)
        errs[algo] = abs(float(out[0, 0]) - 1.0)
    assert errs["most_recent"] <= errs["max"]


# ---------------------------------------------------------------- the port's path
def _reset_jax():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()


@pytest.fixture(scope="module")
def llama():
    """(JAX llama_tiny bundle, numpy params, port config)."""
    jcfg = jax_llama.llama_tiny()
    jmodel = jax_llama.create_llama_model(jcfg, seq_len=SEQ)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    cfg = port_llama.LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(port_llama.LlamaConfig)})
    return jmodel, params, cfg


def _data(n, seed=0):
    ids = np.random.default_rng(seed).integers(0, 512, (n, SEQ)).astype(np.int32)
    return [{"input_ids": ids[i]} for i in range(n)]


def _port_llama(llama):
    model = port_llama.create_llama_model(llama[2], device="cpu")
    model.load_state_dict(port_llama.llama_state_dict_from_flax(llama[1], llama[2]))
    return model


def test_llama_fp8_train_step_matches_jax(llama):
    """llama_tiny in fp8 through `train_step`, 3 steps of 8 rows: JAX's
    losses; each step 7 products a layer and the head's, forward, dx, dw."""
    data = _data(8)
    _reset_jax()
    accelerator = JaxAccelerator(mixed_precision="fp8")
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    pmodel, _, loader = accelerator.prepare(dataclasses.replace(llama[0]), tx,
                                            JaxLoader(data, JaxBatchSampler(range(8), 8)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    batch = next(iter(loader))
    jlosses = [float(step_fn(batch)) for _ in range(3)]

    model = _port_llama(llama)
    acc = port.Accelerator(mixed_precision="fp8", cpu=True)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    _, _, ploader = acc.prepare(model, opt, port.SimpleDataLoader(data, port.BatchSampler(range(8), 8)))
    step = acc.train_step(max_grad_norm=1.0)
    pbatch = next(iter(ploader))
    losses = [float(step(pbatch)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, atol=1e-2, rtol=0)
    assert losses[-1] < losses[0]
    n = 7 * llama[2].num_hidden_layers + 1
    assert pfp8.PRODUCTS == {"fwd": 3 * n, "dx": 3 * n, "dw": 3 * n}


def _eager_fp8_losses(llama, policy, steps=3):
    """Eager fp8 steps with the backward run from a second thread, as the
    autograd engine runs it on the card: (losses, products)."""
    AcceleratorState._reset_state()
    GradientState._reset_state()
    pfp8.reset_product_counts()
    model = _port_llama(llama)
    acc = port.Accelerator(mixed_precision="fp8", cpu=True,
                           compilation_config=port.CompilationConfig(remat_policy=policy))
    pmodel, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS,
                                                       weight_decay=WD))
    batch = {"input_ids": torch.as_tensor(np.stack([r["input_ids"] for r in _data(8)]))}
    losses, errors = [], []
    for _ in range(steps):
        loss = pmodel.loss(batch)

        def backward():
            try:
                loss.backward()
            except BaseException as err:  # surfaced below
                errors.append(err)

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
        if errors:
            raise errors[0]
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    return losses, dict(pfp8.PRODUCTS)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_fp8_under_remat_recomputes_in_fp8_on_another_thread(llama, policy):
    """Under a remat policy the backward, run from another thread, recomputes
    each layer's products in fp8 (the recipe captured at the forward): the
    losses equal those without remat, and each layer's forward products run
    twice."""
    plain, plain_counts = _eager_fp8_losses(llama, None)
    remat, counts = _eager_fp8_losses(llama, policy)
    np.testing.assert_allclose(remat, plain, rtol=1e-6)
    layers = 7 * llama[2].num_hidden_layers
    assert plain_counts == {"fwd": 3 * (layers + 1), "dx": 3 * (layers + 1), "dw": 3 * (layers + 1)}
    assert counts == {"fwd": 3 * (2 * layers + 1), "dx": 3 * (layers + 1), "dw": 3 * (layers + 1)}


def test_delayed_histories_recompute_as_the_forward_read_them(llama):
    """Delayed scaling under a remat scope with ``update_meta=True``: the
    forward rolls each layer's histories, and the recompute in the backward
    reads them as the forward did, not rolled; the gradients equal those
    without remat, and each history rolls once a step."""
    from accelerate_tpu_torch.ops.remat import remat_scope

    recipe = FP8RecipeKwargs(scaling="delayed", amax_history_len=4)
    batch = {"input_ids": torch.as_tensor(np.stack([r["input_ids"] for r in _data(2)])).long()}
    grads, metas = {}, {}
    for policy in (None, "full"):
        model = _port_llama(llama)
        for _ in range(2):  # the second step reads the histories the first rolled
            with remat_scope(policy), pfp8.fp8_autocast(recipe, update_meta=True):
                loss = model.loss_fn(batch, model)
            loss.backward()
        grads[policy] = [p.grad for p in model.parameters()]
        metas[policy] = model.layers[0].attention.wq.fp8_meta["x_amax_history"]
    assert int((metas[None] > 0).sum()) == 2
    torch.testing.assert_close(metas["full"], metas[None], rtol=0, atol=0)
    for got, want in zip(grads["full"], grads[None]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _family_batch(name, vocab, rng):
    ids = rng.integers(1, min(vocab, 500), (2, SEQ)).astype(np.int32)
    if name.startswith("bert"):
        return {"input_ids": ids, "labels": np.array([0, 1], np.int32)}
    if name.startswith("t5"):
        return {"input_ids": ids, "decoder_input_ids": ids[:, : SEQ // 2], "labels": ids[:, : SEQ // 2]}
    return {"input_ids": ids}


TINY = sorted(name for name in MODEL_REGISTRY if "tiny" in name)


@pytest.mark.parametrize("name", TINY)
def test_every_family_runs_jaxs_number_of_fp8_products(name, monkeypatch):
    """For every family of the port's registry at its tiny config, one
    forward under the autocast runs as many fp8 products as JAX's
    interceptor takes over (Mixtral: the router's too, not the experts')."""
    jcalls = []
    inner = jfp8.fp8_dense_apply

    def counted(module, x):
        jcalls.append(module.name)
        return inner(module, x)

    monkeypatch.setattr(jfp8, "fp8_dense_apply", counted)
    jmodel = jax_create_named_model(name, seq_len=SEQ)
    model = create_named_model(name, device="cpu")
    batch = _family_batch(name, model.config.vocab_size, np.random.default_rng(0))
    with jfp8.fp8_autocast():
        jmodel.loss_fn(jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()}, jmodel.apply_fn)
    with torch.no_grad(), pfp8.fp8_autocast():
        model.loss_fn({k: torch.as_tensor(v).long() for k, v in batch.items()}, model)
    assert len(jcalls) > 0
    assert pfp8.PRODUCTS["fwd"] == len(jcalls), sorted(jcalls)


def test_resnet_runs_its_classifier_in_fp8():
    """ResNet's one Dense (the classifier) is its one fp8 product; the convs
    stay in the compute dtype."""
    model = create_resnet_model(resnet_tiny(), device="cpu")
    with torch.no_grad(), pfp8.fp8_autocast():
        out = model(torch.zeros(2, 16, 16, 3))
    assert out.shape == (2, 4) and pfp8.PRODUCTS["fwd"] == 1


def test_fp8_recipe_kwargs_checks_as_jaxs():
    """Fields, defaults and checks of JAX's `FP8RecipeKwargs`."""
    assert dataclasses.asdict(FP8RecipeKwargs()) == dataclasses.asdict(JaxFP8RecipeKwargs())
    assert FP8RecipeKwargs(fp8_format="e4m3", scaling="DELAYED").fp8_format == "E4M3"
    for bad in (dict(fp8_format="E5M2"), dict(scaling="static"), dict(amax_compute_algo="mean")):
        with pytest.raises(ValueError):
            FP8RecipeKwargs(**bad)
        with pytest.raises(ValueError):
            JaxFP8RecipeKwargs(**bad)
    recipe = pfp8.Fp8Recipe.of(FP8RecipeKwargs(fp8_format="E4M3", scaling="delayed", amax_history_len=8))
    assert (recipe.hybrid, recipe.scaling, recipe.history_len, recipe.amax_algo) == (False, "delayed", 8,
                                                                                     "most_recent")
