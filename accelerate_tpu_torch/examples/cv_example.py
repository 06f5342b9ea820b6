"""The port's twin of `examples/cv_example.py`: image classification with a
small convnet on class-conditional synthetic images, through the same
Accelerate surface as `nlp_example`.

The same model, data, order and optimizer as the JAX example: `SmallConvNet`
is three 3x3 stride-2 convolutions with flax's ``"SAME"`` padding (the odd
pixel after the image) and ReLU, a global mean pool and a dense layer;
class k brightens quadrant k of 32x32 noise; the training set is visited in
one fixed permutation of ``default_rng(seed)``; Adam at lr 2e-3. JAX's
example feeds the columnar native loader; the twin a `SimpleDataLoader` over
the same indices, which gives the same batches. Per epoch it prints the last
step's loss and the eval accuracy, and it fails below 0.5 accuracy, as
JAX's script does. It runs on the card unless ``--cpu`` is given.

    python -m accelerate_tpu_torch.examples.cv_example                 # bf16 on the card
    python -m accelerate_tpu_torch.examples.cv_example --cpu --mixed_precision no
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader, set_seed
from accelerate_tpu_torch.device import make_generator, resolve_device
from accelerate_tpu_torch.models.resnet import _same_padding

IMAGE_SIZE = 32
NUM_CLASSES = 4
FEATURES = (16, 32, 64)


class SameConv(nn.Conv2d):
    """flax's ``nn.Conv`` (with its bias) at ``"SAME"`` padding, on NCHW."""

    def forward(self, x):
        (top, bottom), (left, right) = [_same_padding(n, k, s) for n, k, s in
                                        zip(x.shape[2:], self.kernel_size, self.stride)]
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, self.bias, self.stride)


class SmallConvNet(nn.Module):
    """JAX's `SmallConvNet`: images [B, H, W, C] in, logits [B, classes] out."""

    def __init__(self, num_classes: int = NUM_CLASSES, in_channels: int = 3):
        super().__init__()
        channels = (in_channels, *FEATURES)
        self.convs = nn.ModuleList(SameConv(c_in, c_out, 3, stride=2) for c_in, c_out in zip(channels, FEATURES))
        self.dense = nn.Linear(FEATURES[-1], num_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.dense(x.mean(dim=(2, 3)))

    @staticmethod
    def loss_fn(batch, apply_fn):
        return classification_loss(batch, apply_fn)


def classification_loss(batch, apply_fn):
    """The mean cross entropy of the logits against ``batch["labels"]``,
    from an f32 log-softmax."""
    logp = torch.log_softmax(apply_fn(batch["pixel_values"]).float(), dim=-1)
    return -logp.gather(-1, batch["labels"].long()[:, None])[:, 0].mean()


def smallconvnet_state_dict_from_flax(params) -> dict:
    """The twin's `state_dict` from the JAX model's params tree (numpy
    arrays): ``Conv_i`` kernels [kh, kw, in, out] become [out, in, kh, kw],
    the ``Dense_0`` kernel [in, out] becomes [out, in]."""
    tree = params["params"] if "params" in params else params
    sd = {}
    for i in range(len(FEATURES)):
        conv = tree[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = torch.from_numpy(np.array(conv["kernel"])).permute(3, 2, 0, 1).contiguous()
        sd[f"convs.{i}.bias"] = torch.from_numpy(np.array(conv["bias"]))
    sd["dense.weight"] = torch.from_numpy(np.array(tree["Dense_0"]["kernel"])).T.contiguous()
    sd["dense.bias"] = torch.from_numpy(np.array(tree["Dense_0"]["bias"]))
    return sd


def create_model(seed: int = 42, device=None) -> SmallConvNet:
    """`SmallConvNet` with random weights from `seed` in flax's
    distributions: kernels lecun-normal (a normal truncated at two standard
    deviations, variance 1 / fan_in), biases zero."""
    dev = resolve_device(device)
    model = SmallConvNet().to(dev)
    gen = make_generator(seed, dev)
    with torch.no_grad():
        for module in (*model.convs, model.dense):
            std = (1.0 / module.weight[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            module.bias.zero_()
    return model


class ArrayDataset:
    """Rows of equal-length numpy columns: ``dataset[i]`` is a dict of the
    columns' i-th entries (the layout of JAX's `native.ArrayDataset`)."""

    def __init__(self, columns: dict):
        self.columns = columns

    def __len__(self):
        return len(next(iter(self.columns.values())))

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.columns.items()}


def get_dataset(n: int = 512, seed: int = 0) -> ArrayDataset:
    """Class-conditional blobs: class k brightens quadrant k. JAX's
    generator, draw for draw."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, size=n)
    images = rng.normal(size=(n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32) * 0.3
    half = IMAGE_SIZE // 2
    for i, k in enumerate(labels):
        r, c = divmod(int(k), 2)
        images[i, r * half:(r + 1) * half, c * half:(c + 1) * half] += 1.5
    return ArrayDataset({"pixel_values": images, "labels": labels.astype(np.int64)})


def get_dataloaders(args):
    """The training loader over JAX's permutation of the training set, and
    the eval loader in order."""
    train_ds = get_dataset(args.train_size, seed=0)
    eval_ds = get_dataset(args.eval_size, seed=1)
    perm = np.random.default_rng(args.seed).permutation(len(train_ds))
    train_dl = SimpleDataLoader(train_ds, BatchSampler(perm.tolist(), args.batch_size))
    eval_dl = SimpleDataLoader(eval_ds, BatchSampler(range(len(eval_ds)), args.batch_size))
    return train_dl, eval_dl


def training_function(args):
    """Train and evaluate; returns the last epoch's accuracy. Each epoch's
    line is ``epoch {i}: loss {loss:.4f} accuracy {accuracy:.4f}``."""
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    set_seed(args.seed)
    model = create_model(args.seed, device=accelerator.device)
    train_dl, eval_dl = get_dataloaders(args)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    model, optimizer, train_dl, eval_dl = accelerator.prepare(model, optimizer, train_dl, eval_dl)

    history = []
    for epoch in range(args.epochs):
        for batch in train_dl:
            with accelerator.accumulate(model):
                loss = accelerator.backward(model.loss, batch)
                optimizer.step()
                optimizer.zero_grad()
        correct, total = 0, 0
        with torch.no_grad():
            for batch in eval_dl:
                preds = accelerator.gather_for_metrics(model(batch["pixel_values"]).argmax(-1))
                labels = accelerator.gather_for_metrics(batch["labels"])
                correct += int((preds == labels).sum())
                total += len(labels)
        history.append({"epoch": epoch, "loss": float(loss), "accuracy": correct / total})
        accelerator.print(f"epoch {epoch}: loss {float(loss):.4f} accuracy {correct / total:.4f}")
    args.history = history
    return correct / total


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16", "fp16"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_size", type=int, default=512)
    parser.add_argument("--eval_size", type=int, default=128)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (the plain PyTorch path)")
    return parser.parse_args(argv)


def main(argv=None):
    accuracy = training_function(parse_args(argv))
    assert accuracy > 0.5, f"cv_example failed to learn (accuracy {accuracy})"
    return accuracy


if __name__ == "__main__":
    main()
