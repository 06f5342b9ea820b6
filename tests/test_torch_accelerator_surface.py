"""The rest of the one-process `Accelerator` surface in the port, held to the
JAX package on the same numpy inputs: `clip_grad_value_`, `autocast`,
`save_model`, `find_executable_batch_size` with `free_memory`, the save and
load pre-hooks, the kwargs handlers (`InitProcessGroupKwargs` reaching the
process group), `join_uneven_inputs`, `device_placement`,
`DataLoaderConfiguration`, `get_logger`, the trackers (TensorBoard read back
with tensorboard's `EventAccumulator`, the six that need absent packages)
and tqdm. About 25 s on one torch thread.

Tolerances:
  - `clip_grad_value_` then AdamW steps on `llama_tiny` (f32, decay 1e-4 on
    both sides): weights within rtol 1e-5, atol 1e-6 (both clamp the same
    f32 gradients; the GEMMs sum in another order) on all but at most one
    element in 10^3 of each tensor, and every element within 2 * lr *
    steps: Adam's normalised step turns a gradient within f32 rounding of
    zero into a step of up to lr in either direction, so any two f32 runs
    part there. The test runs the same steps without the clamp on both
    sides too: the clamped runs may part at no more than twice as many
    elements as the unclamped ones do, so the clamp adds no divergence of
    its own.
  - fp16 with a loss scale, on the one-weight regression model of
    `test_torch_fp16.py`: the skip flags and the scale equal, weights at
    that file's rtol 2e-3, atol 1e-4.
  - Logits with `autocast` off: the port's f32 logits against JAX's within
    atol 1e-5, and equal, bit for bit, to a model prepared with
    ``mixed_precision="no"``; with it on, against JAX's bf16 logits at
    atol 5e-2 (bf16 rounds at other places in XLA's fused program).
  - `save_model`: the shard of every tensor, the index's `total_size` and
    each tensor's values exactly JAX's; the port's round trip bit for bit.
  - Everything else is exact: batch sizes, messages, call arguments.
"""

import dataclasses
import inspect
import json
import logging
import os
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(__file__))

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu import SimpleDataLoader as JaxLoader  # noqa: E402
from accelerate_tpu import logging as jax_logging  # noqa: E402
from accelerate_tpu import tracking as jax_tracking  # noqa: E402
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu.utils import dataclasses as jax_dc  # noqa: E402
from accelerate_tpu.utils import memory as jax_memory  # noqa: E402
from accelerate_tpu.utils import tqdm as jax_tqdm  # noqa: E402
from accelerate_tpu_torch import checkpointing, tracking  # noqa: E402
from accelerate_tpu_torch import logging as port_logging  # noqa: E402
from accelerate_tpu_torch.models import llama as port_llama  # noqa: E402
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.utils import dataclasses as port_dc  # noqa: E402
from accelerate_tpu_torch.utils import memory as port_memory  # noqa: E402
from accelerate_tpu_torch.utils import tqdm as port_tqdm  # noqa: E402

from test_torch_fp16 import (  # noqa: E402
    REGRESSION,
    _jax_regression,
    _jax_weights,
    _port_regression,
    _regression_data,
    _weights,
)
from test_torch_training import BETAS, EPS, LR, WD, _adamw, _data, _port_model, _reset_jax, weights  # noqa: E402,F401

CLIP_VS_JAX = dict(rtol=1e-5, atol=1e-6)
F32_LOGITS = dict(atol=1e-5, rtol=0)
BF16_LOGITS = dict(atol=5e-2, rtol=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread, as in the other parity files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_state():
    _reset_port()
    _reset_jax()
    yield
    _reset_port()
    _reset_jax()


def _jax_adamw():
    return optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)


def _as_port(params, cfg):
    return port_llama.llama_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg)


# ------------------------------------------------------------------ clip_grad_value_
def _clip_run(side, weights, data, clip_value):
    """Three AdamW steps of `llama_tiny` with `clip_grad_value_` on every
    sync step; the final weights as the port's state dict."""
    _, _, cfg = weights
    if side == "jax":
        _reset_jax()
        acc = JaxAccelerator()
        pm, opt, dl = acc.prepare(dataclasses.replace(weights[0]), _jax_adamw(),
                                  JaxLoader(data, JaxBatchSampler(range(len(data)), 8)))
    else:
        _reset_port()
        acc = port.Accelerator(cpu=True)
        model = _port_model(weights)
        pm, opt, dl = acc.prepare(model, _adamw(model), port.SimpleDataLoader(data, port.BatchSampler(range(len(data)), 8)))
    for batch in dl:
        with acc.accumulate(pm):
            acc.backward(pm.loss, batch)
            if clip_value is not None:
                acc.clip_grad_value_(clip_value=clip_value)
            opt.step()
            opt.zero_grad()
    if side == "jax":
        return {k: v.numpy() for k, v in _as_port(pm.params, cfg).items()}
    return {k: v.detach().numpy() for k, v in pm.module.state_dict().items()}


def test_clip_grad_value_then_steps_match_jax(weights):  # noqa: F811
    """Gradients clamped to +-2e-3 (most of `llama_tiny`'s entries are
    larger) before each of 3 AdamW steps: the port's weights are JAX's; the
    clamp changed them (against the unclipped run), and parts the two sides
    at no more places than Adam alone does."""
    data = _data(24, seed=3)
    got = _clip_run("port", weights, data, 2e-3)
    expect = _clip_run("jax", weights, data, 2e-3)
    unclipped = _clip_run("port", weights, data, None)
    jax_unclipped = _clip_run("jax", weights, data, None)
    steps = len(data) // 8
    parted = {"clipped": 0, "unclipped": 0}
    for name in got:
        off = ~np.isclose(got[name], expect[name], **CLIP_VS_JAX)
        assert off.sum() <= max(1, got[name].size // 1_000), (name, int(off.sum()))
        assert np.abs(got[name] - expect[name]).max() <= 2 * LR * steps, name
        parted["clipped"] += int(off.sum())
        parted["unclipped"] += int((~np.isclose(unclipped[name], jax_unclipped[name], **CLIP_VS_JAX)).sum())
    assert parted["clipped"] <= 2 * parted["unclipped"] + 1, parted
    assert any(not np.allclose(got[n], unclipped[n], rtol=1e-4) for n in got)


@pytest.mark.parametrize("bad", [None, np.inf, np.nan], ids=["finite", "inf", "nan"])
def test_clip_grad_value_unscales_under_fp16_like_jax(bad):
    """fp16 at the initial scale 65536: `clip_grad_value_` unscales before it
    clamps (clamping the scaled gradients would leave nothing). An inf
    gradient clamps to a finite one, so, as in JAX, the step is taken; a NaN
    stays and skips it."""
    data = _regression_data(32, 5)
    batches = [data[i:i + 8] for i in range(0, 32, 8)]

    def stack(rows, torch_side):
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        return {k: torch.as_tensor(v) for k, v in out.items()} if torch_side else out

    runs = {}
    for side in ("jax", "port"):
        jmodel = _jax_regression()
        if side == "jax":
            _reset_jax()
            acc = JaxAccelerator(mixed_precision="fp16")
            pm, opt = acc.prepare(jmodel, optax.sgd(0.05))
        else:
            _reset_port()
            acc = port.Accelerator(mixed_precision="fp16", cpu=True)
            pmodel = _port_regression(jmodel)
            pm, opt = acc.prepare(pmodel, torch.optim.SGD(pmodel.module.parameters(), lr=0.05))
        flags, scales = [], []
        for i, rows in enumerate(batches):
            batch = stack(rows, side == "port")
            if i == 1 and bad is not None:
                if side == "jax":
                    acc.backward(lambda p, b: jnp.sum(p["params"]["linear"]["kernel"]) * bad, batch)
                else:
                    acc.backward(lambda b: pm.module.linear.weight.sum() * float(bad), batch)
            else:
                acc.backward(pm.loss, batch)
            acc.clip_grad_value_(clip_value=0.5)
            opt.step()
            opt.zero_grad()
            flags.append(opt.step_was_skipped)
            scales.append(acc.scaler.scale)
        runs[side] = (flags, scales, _jax_weights(pm) if side == "jax" else _weights(pm))
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][0][1] == (bad is not None and np.isnan(bad))
    np.testing.assert_allclose(runs["port"][2], runs["jax"][2], **REGRESSION)


def test_clip_grad_value_is_a_no_op_while_accumulating(weights):  # noqa: F811
    model = _port_model(weights)
    acc = port.Accelerator(cpu=True, gradient_accumulation_steps=2)
    pm, opt = acc.prepare(model, _adamw(model))
    batch = {"input_ids": torch.as_tensor(np.stack([r["input_ids"] for r in _data(2)]))}
    with acc.accumulate(pm):
        acc.backward(pm.loss, batch)
        before = [p.grad.clone() for p in pm.parameters()]
        assert acc.clip_grad_value_(clip_value=1e-6) is None
    assert all(torch.equal(a, p.grad) for a, p in zip(before, pm.parameters()))


# ------------------------------------------------------------------ autocast
def test_autocast_toggles_the_compute_dtype_like_jax(weights):  # noqa: F811
    """bf16 models: logits with autocast on against JAX's bf16 logits; inside
    ``autocast(AutocastKwargs(enabled=False))`` the f32 logits, against
    JAX's and bit for bit a ``mixed_precision="no"`` model's; the policy
    is restored on exit, on both sides. An Accelerator built with
    ``kwargs_handlers=[AutocastKwargs(enabled=False)]`` starts with it off."""
    ids = np.stack([r["input_ids"] for r in _data(8, seed=4)])
    acc = JaxAccelerator(mixed_precision="bf16")
    jpm = acc.prepare(dataclasses.replace(weights[0]))
    jax_on = np.asarray(jpm(ids), np.float32)
    with acc.autocast(jax_dc.AutocastKwargs(enabled=False)):
        assert not jpm.autocast_enabled
        jax_off = np.asarray(jpm(ids), np.float32)
    assert jpm.autocast_enabled

    model = _port_model(weights)
    accelerator = port.Accelerator(mixed_precision="bf16", cpu=True)
    pm = accelerator.prepare(model)
    tokens = torch.as_tensor(ids)
    with torch.no_grad():
        on = pm(tokens)
        with accelerator.autocast(port.AutocastKwargs(enabled=False)):
            assert not pm.autocast_enabled
            off = pm(tokens)
        assert pm.autocast_enabled
        _reset_port()
        plain = port.Accelerator(mixed_precision="no", cpu=True).prepare(model)(tokens)
    np.testing.assert_allclose(on.numpy(), jax_on, **BF16_LOGITS)
    np.testing.assert_allclose(off.numpy(), jax_off, **F32_LOGITS)
    assert off.dtype == torch.float32 and torch.equal(off, plain)
    assert not torch.equal(on, off)

    _reset_port()
    acc_off = port.Accelerator(mixed_precision="bf16", cpu=True, kwargs_handlers=[port.AutocastKwargs(enabled=False)])
    with torch.no_grad():
        assert torch.equal(acc_off.prepare(model)(tokens), plain)


# ------------------------------------------------------------------ save_model
def _port_name(jax_path: str) -> str:
    """A JAX `save_model` tensor name ('params/layer_0/attention/wq/kernel')
    as the port's ('layers.0.attention.wq.weight')."""
    parts = jax_path.split("/")[1:]
    out = []
    for part in parts[:-1]:
        out += ["layers", part.split("_")[1]] if part.startswith("layer_") else [part]
    return ".".join(out + ["bias" if parts[-1] == "bias" else "weight"])


def _read_export(directory, port_side):
    """(weight map or {name: "model.safetensors"}, tensors, total_size)."""
    index = os.path.join(directory, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            meta = json.load(f)
        weight_map, total = meta["weight_map"], meta["metadata"]["total_size"]
    else:
        weight_map, total = None, None
    if port_side:
        tensors = checkpointing.load_model_safetensors(directory)
    else:
        from safetensors.numpy import load_file

        files = set(weight_map.values()) if weight_map else {"model.safetensors"}
        tensors = {}
        for name in files:
            tensors.update(load_file(os.path.join(directory, name)))
    if weight_map is None:
        weight_map = {name: "model.safetensors" for name in tensors}
    return weight_map, tensors, total


@pytest.mark.parametrize("max_shard_size", ["300KB", "1MB", "5GB"])
def test_save_model_writes_jax_shards(tmp_path, weights, max_shard_size):  # noqa: F811
    """`save_model` at the same `max_shard_size` on both sides: the same
    files, every tensor in the same shard (names mapped), equal values (a
    kernel transposed), the same `total_size`; the port's files read back
    bit for bit and a fresh model loaded from them gives the same logits."""
    acc = JaxAccelerator()
    jpm = acc.prepare(dataclasses.replace(weights[0]))
    acc.save_model(jpm, str(tmp_path / "jax"), max_shard_size=max_shard_size)
    model = _port_model(weights)
    accelerator = port.Accelerator(cpu=True)
    pm = accelerator.prepare(model)
    accelerator.save_model(pm, str(tmp_path / "port"), max_shard_size=max_shard_size)

    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    jmap, jtensors, jtotal = _read_export(str(tmp_path / "jax"), port_side=False)
    pmap, ptensors, ptotal = _read_export(str(tmp_path / "port"), port_side=True)
    assert ptotal == jtotal
    assert {_port_name(k): v for k, v in jmap.items()} == pmap
    for jname, value in jtensors.items():
        got = ptensors[_port_name(jname)].numpy()
        np.testing.assert_array_equal(got, value.T if jname.endswith("kernel") else value, err_msg=jname)
    state = pm.module.state_dict()
    assert ptensors.keys() == state.keys() and all(torch.equal(ptensors[k], state[k]) for k in state)
    fresh = port_llama.create_llama_model(weights[2], seed=1, device="cpu")
    fresh.load_state_dict(ptensors)
    ids = torch.as_tensor(np.stack([r["input_ids"] for r in _data(2)]))
    with torch.no_grad():
        assert torch.equal(fresh(ids), pm.module(ids))


def test_save_model_takes_the_reference_positional_order(tmp_path, weights):  # noqa: F811
    """A non-bool third argument is a shard size, as JAX reads it; a fourth
    False then writes the non-safetensors file (JAX's ``model.npz``, the
    port's ``model.pt``, a `torch.save` of the state dict)."""
    acc = JaxAccelerator()
    jpm = acc.prepare(dataclasses.replace(weights[0]))
    accelerator = port.Accelerator(cpu=True)
    pm = accelerator.prepare(_port_model(weights))
    for side, a, m in (("jax", acc, jpm), ("port", accelerator, pm)):
        a.save_model(m, str(tmp_path / side / "sharded"), "300KB")
        a.save_model(m, str(tmp_path / side / "plain"), "300KB", False)
    assert sorted(os.listdir(tmp_path / "port" / "sharded")) == sorted(os.listdir(tmp_path / "jax" / "sharded"))
    assert len(os.listdir(tmp_path / "port" / "sharded")) > 2
    assert os.listdir(tmp_path / "jax" / "plain") and "model.npz" in os.listdir(tmp_path / "jax" / "plain")
    assert os.listdir(tmp_path / "port" / "plain") == ["model.pt"]
    loaded = torch.load(tmp_path / "port" / "plain" / "model.pt", weights_only=True)
    assert all(torch.equal(loaded[k], v) for k, v in pm.module.state_dict().items())


# ------------------------------------------------------------------ memory
def _search(module, limit):
    """The batch sizes `find_executable_batch_size` tries from 128 with a
    function that runs out of memory above `limit`, and what it returns."""
    tried = []

    @module.find_executable_batch_size(starting_batch_size=128)
    def train(batch_size, tag):
        tried.append(batch_size)
        if batch_size > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return tag, batch_size

    return train("run"), tried


def test_find_executable_batch_size_matches_jax():
    """The same sequence of sizes and result as JAX's for a function that
    raises a real `torch.cuda.OutOfMemoryError` above 20; the same
    `TypeError` when the batch size is passed by hand, and the same error
    when no size fits."""
    assert _search(port_memory, 20) == _search(jax_memory, 20) == (("run", 16), [128, 64, 32, 16])
    errors = []
    for module in (port_memory, jax_memory):
        @module.find_executable_batch_size(starting_batch_size=8)
        def train(batch_size, tag):
            return batch_size

        with pytest.raises(TypeError) as by_hand:
            train(8, "x")
        with pytest.raises(RuntimeError) as zero:
            _search(module, 0)
        errors.append((str(by_hand.value), str(zero.value)))
    assert errors[0] == errors[1]
    assert errors[0][1] == "No executable batch size found, reached zero."


def test_is_oom_exception_reads_cuda_and_allocator_errors():
    assert port_memory.is_oom_exception(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB"))
    assert port_memory.is_oom_exception(RuntimeError("CUDA error: out of memory"))
    assert port_memory.is_oom_exception(RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"))
    assert not port_memory.is_oom_exception(RuntimeError("shape mismatch"))
    assert not port_memory.is_oom_exception(ValueError("out of memory"))
    assert port_memory.release_memory(torch.zeros(3), [1]) == [None, None]


def test_free_memory_and_clear_forget_what_was_prepared(weights):  # noqa: F811
    """`free_memory(*objects)` returns as many Nones, empties every prepared
    list and the step count, as JAX's; `clear` is the same call."""
    data = _data(8)
    acc = JaxAccelerator(gradient_accumulation_steps=2)
    jpm, jopt, jdl = acc.prepare(dataclasses.replace(weights[0]), _jax_adamw(), JaxLoader(data, JaxBatchSampler(range(8), 8)))
    with acc.accumulate(jpm):
        pass
    model = _port_model(weights)
    accelerator = port.Accelerator(cpu=True, gradient_accumulation_steps=2)
    pm, opt, dl, sched = accelerator.prepare(model, _adamw(model), port.SimpleDataLoader(data, port.BatchSampler(range(8), 8)),
                                             lambda step: LR)
    with accelerator.accumulate(pm):
        pass
    assert accelerator.step == acc.step == 1
    for a, objects in ((acc, (jpm, jopt, jdl)), (accelerator, (pm, opt, dl, sched))):
        assert a.free_memory(*objects) == [None] * len(objects)
        assert (a._models, a._optimizers, a._schedulers, a._dataloaders, a.step) == ([], [], [], [], 0)
    assert accelerator.clear(pm) == acc.clear(jpm) == [None]


# ------------------------------------------------------------------ hooks
def test_save_and_load_pre_hooks_get_jax_arguments(tmp_path, weights):  # noqa: F811
    """Two save hooks and two load hooks, registered on both sides: each is
    called once per `save_state`/`load_state`, in registration order, with
    JAX's arguments (``(models, None, output_dir)``, ``(models, input_dir)``),
    before anything is written or restored."""
    calls = {}
    for side in ("jax", "port"):
        log = calls[side] = []
        if side == "jax":
            _reset_jax()
            acc = JaxAccelerator()
            pm = acc.prepare(dataclasses.replace(weights[0]))
        else:
            _reset_port()
            acc = port.Accelerator(cpu=True)
            pm = acc.prepare(_port_model(weights))
        out = str(tmp_path / side)
        for tag in ("a", "b"):
            acc.register_save_state_pre_hook(
                lambda models, w, d, tag=tag: log.append(("save", tag, models == [pm], w, d == out, len(os.listdir(d)))))
            acc.register_load_state_pre_hook(
                lambda models, d, tag=tag: log.append(("load", tag, models == [pm], os.path.samefile(d, out))))
        acc.save_state(out)
        acc.load_state(out)
    assert calls["port"] == calls["jax"]
    assert calls["port"] == [("save", "a", True, None, True, 0), ("save", "b", True, None, True, 0),
                             ("load", "a", True, True), ("load", "b", True, True)]


# ------------------------------------------------------------------ kwargs handlers
HANDLERS = [
    ("AutocastKwargs", dict(enabled=False)),
    ("GradScalerKwargs", dict(init_scale=1024.0, growth_interval=10)),
    ("InitProcessGroupKwargs", dict(timeout=timedelta(minutes=5))),
    ("InitProcessGroupKwargs", dict(backend="nccl", init_method="tcp://127.0.0.1:29500")),
    ("DistributedDataParallelKwargs", dict(bucket_cap_mb=50, find_unused_parameters=True, static_graph=True)),
    ("FP8RecipeKwargs", dict(fp8_format="E4M3", amax_history_len=16)),
]


@pytest.mark.parametrize("name,kwargs", HANDLERS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(HANDLERS)])
def test_kwargs_handlers_to_kwargs_match_jax(name, kwargs):
    """`to_kwargs` gives the fields that differ from the defaults, as JAX's
    handler of the same name does; a default handler gives none; the fields
    and their defaults are JAX's (the process group's backend aside: JAX's
    default names XLA's, the port's None takes NCCL or gloo)."""
    mine, theirs = getattr(port_dc, name), getattr(jax_dc, name)
    assert issubclass(mine, port_dc.KwargsHandler)
    assert mine(**kwargs).to_kwargs() == theirs(**kwargs).to_kwargs() == kwargs
    assert mine().to_kwargs() == theirs().to_kwargs() == {}
    defaults = {f.name: f.default for f in dataclasses.fields(mine)}
    expect = {f.name: f.default for f in dataclasses.fields(theirs)}
    if name == "InitProcessGroupKwargs":
        assert (defaults.pop("backend"), expect.pop("backend")) == (None, "xla")
    assert defaults == expect


def test_accelerator_sorts_the_handlers_as_jax_does():
    handlers = [port.AutocastKwargs(enabled=False), port.InitProcessGroupKwargs(timeout=timedelta(seconds=42)),
                port.DistributedDataParallelKwargs(), port.GradScalerKwargs(init_scale=8.0)]
    acc = port.Accelerator(cpu=True, mixed_precision="fp16", kwargs_handlers=handlers)
    assert (acc.autocast_handler, acc.init_handler, acc.ddp_handler, acc.scaler_handler) == tuple(handlers)
    assert acc.fp8_recipe_handler is None and acc.scaler.scale == 8.0


def test_init_process_group_kwargs_reach_the_process_group(monkeypatch):
    """A one-process gloo group built through the launcher's variables: the
    handler's timeout reaches `torch.distributed.init_process_group`, and
    the group's collectives run with it."""
    import torch.distributed as dist

    from accelerate_tpu_torch.launchers import free_port

    seen = {}
    real = dist.init_process_group

    def record(*args, **kwargs):
        seen.update(kwargs, backend=args[0] if args else kwargs.get("backend"))
        return real(*args, **kwargs)

    monkeypatch.setattr(dist, "init_process_group", record)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    PartialState._reset_state()
    try:
        acc = port.Accelerator(cpu=True, kwargs_handlers=[port.InitProcessGroupKwargs(timeout=timedelta(seconds=77))])
        assert acc.use_distributed and dist.is_initialized()
        assert (seen["backend"], seen["timeout"], seen["init_method"]) == ("gloo", timedelta(seconds=77), "env://")
        assert acc.reduce(torch.ones(2), reduction="sum").tolist() == [1.0, 1.0]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        PartialState._reset_state()


def test_join_uneven_inputs_warns_as_jax_does(caplog):
    records = []
    for acc in (JaxAccelerator(), port.Accelerator(cpu=True)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            with acc.join_uneven_inputs([None], even_batches=True):
                pass
            with acc.join_uneven_inputs([None]):
                pass
        records.append([r.getMessage() for r in caplog.records])
    assert records[0] == records[1] == [
        "join_uneven_inputs(even_batches=...) is advisory here; padding is handled by the loader"]


# ------------------------------------------------------------------ loaders
def test_device_placement_false_keeps_batches_on_the_host():
    """A loader prepared with ``device_placement=False`` (the accelerator's,
    or `prepare`'s per argument) yields host tensors of JAX's host arrays;
    one with it on goes to the accelerator's device (here a stand-in, the
    meta device, so the move shows on the CPU)."""
    data = [{"x": np.arange(4, dtype=np.float32) + i, "y": np.int64(i)} for i in range(16)]
    jacc = JaxAccelerator(device_placement=False)
    jax_batches = [b for b in jacc.prepare(JaxLoader(data, JaxBatchSampler(range(16), 8)))]
    acc = port.Accelerator(cpu=True, device_placement=False)
    acc.state.device = torch.device("meta")
    host = list(acc.prepare(port.SimpleDataLoader(data, port.BatchSampler(range(16), 8))))
    placed, kept = acc.prepare(port.SimpleDataLoader(data, port.BatchSampler(range(16), 8)),
                               port.SimpleDataLoader(data, port.BatchSampler(range(16), 8)),
                               device_placement=[True, False])
    assert all(isinstance(b["x"], np.ndarray) for b in jax_batches)
    for got, expect in zip(host, jax_batches):
        assert got["x"].device.type == "cpu"
        np.testing.assert_array_equal(got["x"].numpy(), expect["x"])
        np.testing.assert_array_equal(got["y"].numpy(), expect["y"])
    assert next(iter(placed))["x"].device.type == "meta"
    assert next(iter(kept))["x"].device.type == "cpu"


def test_dataloader_configuration_and_rng_types_match_jax():
    assert dataclasses.asdict(port.DataLoaderConfiguration()) == dataclasses.asdict(jax_dc.DataLoaderConfiguration())
    assert [t.value for t in port_dc.RNGType] == [("torch" if t.value == "jax" else t.value) for t in jax_dc.RNGType]
    acc, jacc = port.Accelerator(cpu=True), JaxAccelerator()
    assert acc.rng_types == jacc.rng_types == ["python", "numpy"]
    assert dataclasses.asdict(acc.dataloader_config) == dataclasses.asdict(jacc.dataloader_config)
    assert acc.step_scheduler_with_optimizer is jacc.step_scheduler_with_optimizer is True
    assert acc.device_placement is jacc.device_placement is True


@pytest.mark.parametrize("step_with_optimizer", [True, False])
def test_one_process_scheduler_steps_as_jax_does(step_with_optimizer):
    """Two micro-steps a sync over 4 calls: with `step_scheduler_with_optimizer`
    the schedule advances at each sync (2 steps), without it at each call
    (4), as JAX's `AcceleratedScheduler` counts."""
    from accelerate_tpu.scheduler import AcceleratedScheduler as JaxScheduler
    from accelerate_tpu.state import GradientState as JaxGradientState

    counts = []
    for side in ("jax", "port"):
        if side == "jax":
            gs, sched = JaxGradientState(), JaxScheduler(lambda s: 1.0 / (1 + s), [],
                                                        step_with_optimizer=step_with_optimizer)
        else:
            gs = GradientState()
            sched = port.Accelerator(cpu=True, step_scheduler_with_optimizer=step_with_optimizer).prepare_scheduler(
                lambda s: 1.0 / (1 + s))
        for i in range(4):
            gs._set_sync_gradients(i % 2 == 1)
            sched.step()
        counts.append((sched.step_count, sched.get_last_lr()))
    assert counts[0] == counts[1] == ((2, [1 / 3]) if step_with_optimizer else (4, [0.2]))


# ------------------------------------------------------------------ logging, trackers, tqdm
@pytest.fixture
def restore_logging():
    root = logging.getLogger().level
    yield
    logging.getLogger().setLevel(root)


def test_get_logger_takes_its_level_from_the_environment(monkeypatch, caplog, restore_logging):
    monkeypatch.setenv("ACCELERATE_TPU_LOG_LEVEL", "debug")
    mine, theirs = port_logging.get_logger("surface.mine"), jax_logging.get_logger("surface.theirs")
    assert isinstance(mine, port.logging.MultiProcessAdapter)
    assert mine.logger.level == theirs.logger.level == logging.DEBUG
    assert port_logging.get_logger("surface.other", "error").logger.level == logging.ERROR
    mine.logger.setLevel(logging.DEBUG)
    with caplog.at_level(logging.DEBUG):
        mine.debug("shown once", main_process_only=True)
        mine.warning_once("only once")
        mine.warning_once("only once")
        monkeypatch.setenv("ACCELERATE_TPU_DISABLE_LOGGING", "true")
        mine.error("silenced")
    assert [r.getMessage() for r in caplog.records if r.name == "surface.mine"] == ["shown once", "only once"]


def _events(directory):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    found = {}
    for root, _, files in os.walk(directory):
        for name in files:
            if name.startswith("events.out.tfevents"):
                acc = EventAccumulator(root, size_guidance={"scalars": 0, "tensors": 0})
                acc.Reload()
                rel = os.path.relpath(root, directory)
                rel = "." if rel == "." else "hparams"  # add_hparams writes under a time-stamped subdirectory
                scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}
                tensors = {tag: [(e.step, e.tensor_proto.string_val) for e in acc.Tensors(tag)]
                           for tag in acc.Tags()["tensors"]}
                found.setdefault(rel, {}).update(scalars=scalars, tensors=tensors)
    return found


def test_tensorboard_tracker_writes_jax_events(tmp_path):
    """The same configuration and `log` calls (a scalar, a numpy scalar, a
    tensor, text, a group of scalars) through `Accelerator(log_with=
    "tensorboard")`: the scalars and text read back from the event files
    equal JAX's."""
    calls = [({"loss": 0.75, "lr": np.float32(5e-4)}, 0), ({"loss": torch.tensor(0.5)}, 1),
             ({"note": "halfway"}, 1), ({"pair": {"a": 1.0, "b": 2.0}}, 2)]
    for side, make in (("jax", lambda d: JaxAccelerator(log_with="tensorboard", project_dir=d)),
                       ("port", lambda d: port.Accelerator(cpu=True, log_with="tensorboard", project_dir=d))):
        acc = make(str(tmp_path / side))
        acc.init_trackers("run", config={"lr": 5e-4, "tiny": True, "name": "x"})
        for values, step in calls:
            acc.log({k: (float(v) if side == "jax" and isinstance(v, torch.Tensor) else v) for k, v in values.items()},
                    step=step)
        assert acc.get_tracker("tensorboard").name == "tensorboard"
        acc.end_training()
    mine, theirs = _events(tmp_path / "port" / "run"), _events(tmp_path / "jax" / "run")
    assert mine == theirs
    assert mine["."]["scalars"]["loss"] == [(0, 0.75), (1, 0.5)]
    assert mine["."]["tensors"]["note/text_summary"] == [(1, [b"halfway"])]


ABSENT = ("wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive")


def test_absent_trackers_are_skipped_and_all_resolves_as_jax(tmp_path, caplog):
    """None of the six trackers' packages is installed here: each named one
    is skipped with JAX's warning, and ``"all"`` is what JAX's gives (JSON,
    CSV and TensorBoard)."""
    import importlib.util

    assert not any(importlib.util.find_spec(name) for name in ABSENT)
    for name in ABSENT:
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert tracking.filter_trackers(name, str(tmp_path)) == jax_tracking.filter_trackers(name, str(tmp_path)) == []
        messages = [r.getMessage() for r in caplog.records]
        assert messages == [f"Tracker {name} requested but its package is not installed; skipping."] * 2
        assert tracking.LOGGER_TYPE_TO_CLASS[name].__name__ == jax_tracking.LOGGER_TYPE_TO_CLASS[name].__name__
    assert tracking.filter_trackers("all", str(tmp_path)) == jax_tracking.filter_trackers("all", str(tmp_path))
    assert tracking.filter_trackers("all", str(tmp_path)) == ["json", "csv", "tensorboard"]


@pytest.mark.parametrize("local_index,main_only,disable,expect",
                         [(0, True, False, False), (1, True, False, True), (1, False, False, False), (0, True, True, True)])
def test_tqdm_disables_as_jax_does(local_index, main_only, disable, expect):
    """tqdm draws on each node's local main process only, unless told
    otherwise; an explicit ``disable`` stays."""
    got = []
    for module, state in ((port_tqdm, PartialState), (jax_tqdm, JaxPartialState)):
        state()
        saved = state._shared_state["local_process_index"]
        state._shared_state["local_process_index"] = local_index
        try:
            bar = module.tqdm(range(3), main_process_only=main_only, disable=disable)
            got.append(bar.disable)
            bar.close()
        finally:
            state._shared_state["local_process_index"] = saved
    assert got == [expect, expect]


def test_rich_installs_its_traceback_handler():
    hook = sys.excepthook
    try:
        import accelerate_tpu_torch.utils.rich  # noqa: F401

        assert sys.excepthook is not hook
    finally:
        sys.excepthook = hook


# ------------------------------------------------------------------ the surface as a whole
SURFACE = {
    "__init__": ["device_placement", "split_batches", "mixed_precision", "gradient_accumulation_steps", "cpu",
                 "dataloader_config", "log_with", "project_dir", "project_config", "gradient_accumulation_plugin",
                 "parallelism_config", "fsdp_plugin", "compilation_config", "rng_types", "kwargs_handlers",
                 "step_scheduler_with_optimizer", "analyze", "tracer", "sharded_save"],
    "prepare": None, "prepare_model": None, "prepare_optimizer": None, "prepare_data_loader": None,
    "prepare_scheduler": None, "autocast": None, "clip_grad_value_": None, "clip_grad_norm_": None,
    "save_model": None, "free_memory": None, "clear": None, "set_trigger": None, "check_trigger": None,
    "join_uneven_inputs": None, "register_save_state_pre_hook": None, "register_load_state_pre_hook": None,
    "local_main_process_first": None, "on_local_main_process": None, "unwrap_model": None,
}


@pytest.mark.parametrize("member", sorted(SURFACE))
def test_members_take_jax_arguments(member):
    """Each member the slice adds takes JAX's arguments, in JAX's order (the
    constructor: those of JAX's that the port has, in JAX's order)."""
    mine = list(inspect.signature(getattr(port.Accelerator, member)).parameters)
    theirs = list(inspect.signature(getattr(JaxAccelerator, member)).parameters)
    if SURFACE[member] is None:
        assert mine == theirs
    else:
        assert mine[1:] == SURFACE[member] == [p for p in theirs[1:] if p in SURFACE[member]]
