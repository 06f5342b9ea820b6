"""The port's ResNet (`accelerate_tpu_torch/models/resnet.py`) against the JAX
package's (`accelerate_tpu/models/resnet.py`): the three cases of
`tests/test_resnet.py` on the port, then its logits and training losses
against JAX's on carried-across weights.

Every BatchNorm's statistics, scale and bias are moved by seeded noise
before the carry (flax inits them at 0 and 1, which would hide a swapped
mean and variance). resnet_tiny's second stage opens with a stride-2 block
on an even input, whose 3x3 conv flax pads (0, 1): a symmetric padding
moves every logit. Tolerances: f32 logits atol 1e-4 (both sides run f32
convolutions, summed in other orders); the losses of 3 Adam steps atol
1e-4 on losses of about 1.4.
"""

import dataclasses

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
from accelerate_tpu.models import resnet as jax_resnet
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.models.resnet import (
    BatchNorm,
    create_resnet_model,
    resnet50,
    resnet_state_dict_from_flax,
    resnet_tiny,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState

SIZE = 16


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
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _images(n, seed=0):
    """The JAX test's task: each label lights one quadrant."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, size=n)
    images = rng.normal(size=(n, SIZE, SIZE, 3)).astype(np.float32) * 0.1
    half = SIZE // 2
    for i, k in enumerate(labels):
        r, c = divmod(int(k), 2)
        images[i, r * half:(r + 1) * half, c * half:(c + 1) * half] += 2.0
    return images, labels.astype(np.int64)


def _rows(images, labels):
    return [{"pixel_values": images[i], "labels": labels[i]} for i in range(len(labels))]


def test_forward_shapes():
    model = create_resnet_model(resnet_tiny(), device="cpu")
    assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 4)
    assert model(torch.zeros(2, 15, 15, 3)).shape == (2, 4)  # odd sizes pad as flax's SAME does


def test_resnet50_param_count():
    n = sum(p.numel() for p in create_resnet_model(resnet50(), device="cpu").parameters())
    assert 25.0e6 < n < 26.0e6, n  # torchvision resnet50 = 25.56M


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_training_learns_and_preserves_batch_stats(mixed_precision):
    """6 epochs of Adam through `prepare` and `backward` fit the quadrant
    task; every BatchNorm buffer, bf16 forward included, is unchanged bit
    for bit."""
    images, labels = _images(64)
    accelerator = port.Accelerator(mixed_precision=mixed_precision, cpu=True)
    model = create_resnet_model(resnet_tiny(), device="cpu")
    loader = port.SimpleDataLoader(_rows(images, labels), port.BatchSampler(range(64), 16))
    pmodel, opt, loader = accelerator.prepare(model, torch.optim.Adam(model.parameters(), 2e-3), loader)
    before = {k: v.clone() for k, v in model.named_buffers()}
    losses = []
    for _ in range(6):
        for batch in loader:
            loss = accelerator.backward(pmodel.loss, batch)
            opt.step()
            opt.zero_grad()
            losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    after = dict(model.named_buffers())
    assert before.keys() == after.keys() and len(before) == 9 * 3  # 9 BatchNorms: stem, 2 x (3 + downsample)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k


def _jax_model():
    """JAX's resnet_tiny with every BatchNorm's variables moved by noise."""
    jmodel = jax_resnet.create_resnet_model(jax_resnet.resnet_tiny(), image_size=SIZE)
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.params)

    def move(tree):
        for name, node in tree.items():
            if isinstance(node, dict) and ("scale" in node or "mean" in node):
                for k, v in node.items():
                    noise = rng.normal(size=v.shape).astype(np.float32) * 0.1
                    node[k] = np.abs(1.0 + noise) if k == "var" else v + noise
            elif isinstance(node, dict):
                move(node)

    move(variables["params"])
    move(variables["batch_stats"])
    return dataclasses.replace(jmodel, params=jax.tree_util.tree_map(jnp.asarray, variables)), variables


def _port_model(variables, config=None):
    config = config or resnet_tiny()
    model = create_resnet_model(config, device="cpu")
    model.load_state_dict(resnet_state_dict_from_flax(variables, config))
    return model


def test_f32_logits_match_jax():
    jmodel, variables = _jax_model()
    images, _ = _images(4, seed=1)
    jlogits = np.asarray(jmodel.apply_fn(jmodel.params, jnp.asarray(images)))
    model = _port_model(variables)
    assert all(isinstance(m, BatchNorm) for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
    with torch.no_grad():
        logits = model(torch.as_tensor(images)).numpy()
    np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=0)


def test_adam_losses_match_jax():
    """3 Adam steps through `train_step` on one batch of 16: JAX's losses."""
    jmodel, variables = _jax_model()
    images, labels = _images(16, seed=2)
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    jacc = JaxAccelerator()
    _, _, jloader = jacc.prepare(jmodel, optax.adam(2e-3), JaxLoader(_rows(images, labels),
                                                                     JaxBatchSampler(range(16), 16)))
    jstep = jacc.train_step()
    jbatch = next(iter(jloader))
    jlosses = [float(jstep(jbatch)) for _ in range(3)]

    model = _port_model(variables)
    acc = port.Accelerator(cpu=True)
    _, _, loader = acc.prepare(model, torch.optim.Adam(model.parameters(), 2e-3),
                               port.SimpleDataLoader(_rows(images, labels), port.BatchSampler(range(16), 16)))
    step = acc.train_step()
    batch = next(iter(loader))
    losses = [float(step(batch)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=0)
    assert losses[-1] < losses[0]
