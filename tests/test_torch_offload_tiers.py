"""The training half of the offload tiers, held on the CPU to the port's
resident run and to the JAX package's own tiers (`tests/test_offload_tiers.py`,
case for case). About 30 s on two torch threads, most of it JAX's four
`train_step` programs.

The port's tiers (`optimizer.py`'s `PinnedOptState` and `DiskOptState`, the
masters' tier of `modeling.PreparedModel`) run the optimizer's own step
over each group of parameters, so against the resident run they are bit
for bit: losses, masters and moments. Against JAX, on `llama_tiny` weights
carried across and the same numpy batches, with AdamW's weight decay set on
both sides: losses within rtol 1e-5 (f32; the GEMMs sum in another order),
and the masters as `tests/test_torch_distributed.py` holds them after Adam
steps (rtol 1e-4, atol 1e-6 on all but one element in 10^4, every element
within 2 x lr x steps: Adam's normalised update parts two f32 runs where a
gradient is within rounding of zero).

``ACCELERATE_TPU_OFFLOAD_CHUNK_MB=0`` puts every parameter in a group of
its own (21 groups for llama_tiny), so the chunked loop, the read-ahead of
the disk tier and its writer thread all run.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import optax

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.models import gptj as jax_gptj
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.optimizer import AcceleratedOptimizer as JaxOptimizer
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDPPlugin
from accelerate_tpu_torch.models import gptj as port_gptj
from accelerate_tpu_torch.models import llama as port_llama
from accelerate_tpu_torch.native import NativeOffloadStore
from accelerate_tpu_torch.optimizer import DiskOptState, PinnedOptState, offload_groups
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin, FullyShardedDataParallelPlugin

LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 1e-4
SEQ, BATCH, STEPS = 16, 8, 3
LOSS_VS_JAX = dict(rtol=1e-5, atol=0)
WEIGHTS_VS_JAX = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _reset_jax():
    for state in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        state._reset_state()


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


FAMILIES = {"llama": (jax_llama, port_llama, "llama_tiny", "create_llama_model", port_llama.llama_state_dict_from_flax),
            "gptj": (jax_gptj, port_gptj, "gptj_tiny", "create_gptj_model", port_gptj.gptj_state_dict_from_flax)}


@pytest.fixture(scope="module")
def weights():
    """Per family: (JAX bundle, numpy params, port config, port state dict)."""
    out = {}
    for family, (jmod, pmod, tiny, create, convert) in FAMILIES.items():
        jcfg = getattr(jmod, tiny)()
        jmodel = getattr(jmod, create)(jcfg, seq_len=SEQ)
        params = _np(jmodel.params)
        cfg_cls = type(getattr(pmod, tiny)())
        cfg = cfg_cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg_cls)})
        out[family] = (jmodel, params, cfg, convert(params, cfg))
    return out


def _batches(n=STEPS, seed=0, vocab=512):
    ids = np.random.default_rng(seed).integers(0, vocab, (n, BATCH, SEQ)).astype(np.int32)
    return [{"input_ids": b} for b in ids]


def _port_model(weights, family="llama"):
    _, _, cfg, sd = weights[family]
    _, pmod, _, create, _ = FAMILIES[family]
    model = getattr(pmod, create)(cfg, device="cpu")
    model.load_state_dict(sd)
    return model


TIERS = {
    "resident": lambda d: {},
    "optimizer_state": lambda d: {"fsdp_plugin": FullyShardedDataParallelPlugin(offload_optimizer_state=True)},
    "cpu_offload": lambda d: {"fsdp_plugin": FullyShardedDataParallelPlugin(cpu_offload=True)},
    "disk": lambda d: {"fsdp_plugin": FullyShardedDataParallelPlugin(offload_optimizer_device="disk",
                                                                     offload_dir=str(d / "optstate"))},
    "deepspeed_nvme": lambda d: {"deepspeed_plugin": DeepSpeedPlugin(
        hf_ds_config={"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "nvme"}}})},
}


def _port_run(weights, tier, tmp_path, fused=True, family="llama", mixed_precision="no", batches=None,
              keep=None):
    """`STEPS` AdamW steps (clip 1.0 in the fused path) under `tier`:
    (losses, masters, optimizer state dict), cloned."""
    _reset_port()
    accelerator = port.Accelerator(cpu=True, mixed_precision=mixed_precision, **TIERS[tier](tmp_path))
    model = _port_model(weights, family)
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD, foreach=False)
    pmodel, popt = accelerator.prepare(model, optimizer)
    losses = []
    step_fn = accelerator.train_step(max_grad_norm=1.0) if fused else None
    for batch in batches or _batches():
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if fused:
            losses.append(float(step_fn(batch)))
        else:
            losses.append(float(accelerator.backward(pmodel.loss, batch)))
            popt.step()
            popt.zero_grad()
    masters = {k: v.clone() for k, v in pmodel.full_state_dict().items()}
    state = popt.state_dict()
    state = {i: {k: torch.as_tensor(v).clone() for k, v in e.items()} for i, e in state["state"].items()}
    if keep is not None:
        keep.update(accelerator=accelerator, pmodel=pmodel, popt=popt)
    return losses, masters, state


def _assert_bit_for_bit(got, want):
    losses, masters, state = got
    assert [float.hex(x) for x in losses] == [float.hex(x) for x in want[0]]
    assert set(masters) == set(want[1]) and all(torch.equal(masters[k], want[1][k]) for k in masters)
    assert set(state) == set(want[2])
    for i in state:
        assert set(state[i]) == set(want[2][i])
        assert all(torch.equal(state[i][k], want[2][i][k]) for k in state[i]), i


@pytest.fixture(scope="module")
def resident(weights, tmp_path_factory):
    """The port's resident runs each tier is held to, by (family, fused)."""
    tmp = tmp_path_factory.mktemp("resident")
    return {(family, fused): _port_run(weights, "resident", tmp, fused=fused, family=family)
            for family in FAMILIES for fused in (True, False)}


# ------------------------------------------------------------------ every tier against the resident run
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("tier", ["optimizer_state", "cpu_offload", "disk", "deepspeed_nvme"])
def test_tier_equals_the_resident_run_bit_for_bit(weights, resident, tmp_path, monkeypatch, tier, fused, family):
    """One parameter a group: the losses, the masters after the last update
    and every moment equal the resident run's bit for bit, and the state
    lives in its tier (arena views, or the blob with nothing in memory)."""
    monkeypatch.setenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", "0")
    keep = {}
    got = _port_run(weights, tier, tmp_path, fused=fused, family=family, keep=keep)
    _assert_bit_for_bit(got, resident[family, fused])
    popt, pmodel = keep["popt"], keep["pmodel"]
    assert popt.offload_opt_state and len(popt.offload.groups) == len(popt.offload.params) > 1
    if tier in ("optimizer_state", "cpu_offload"):
        assert isinstance(popt.offload, PinnedOptState)
        arena = popt.offload.arena.buffer
        lo, hi = arena.data_ptr(), arena.data_ptr() + arena.numel()
        for p in popt.offload.params:
            for key in ("exp_avg", "exp_avg_sq"):
                assert lo <= popt.optimizer.state[p][key].data_ptr() < hi
    else:
        assert isinstance(popt.offload, DiskOptState)
        assert os.path.exists(os.path.join(popt.offload.directory, "weights.bin"))
        assert all(set(popt.optimizer.state[p]) == {"step"} for p in popt.offload.params)
    assert pmodel.offload_params == (tier == "cpu_offload")
    if tier == "cpu_offload":
        arena = pmodel._param_arena.buffer
        lo, hi = arena.data_ptr(), arena.data_ptr() + arena.numel()
        assert all(lo <= p.data_ptr() < hi for p in pmodel.parameters())


# ------------------------------------------------------------------ against JAX's tiers
def _jax_plugin(tier, tmp_path):
    if tier == "resident":
        return JaxFSDPPlugin(sharding_strategy="NO_SHARD")
    if tier == "optimizer_state":
        return JaxFSDPPlugin(sharding_strategy="NO_SHARD", offload_optimizer_state=True)
    if tier == "cpu_offload":
        return JaxFSDPPlugin(sharding_strategy="FULL_SHARD", cpu_offload=True, min_num_params=0)
    return JaxFSDPPlugin(sharding_strategy="NO_SHARD", offload_optimizer_device="disk",
                         offload_dir=str(tmp_path / "jax_optstate"))


def _jax_run(weights, tier, tmp_path):
    _reset_jax()
    jmodel, params, cfg, _ = weights["llama"]
    accelerator = JaxAccelerator(fsdp_plugin=_jax_plugin(tier, tmp_path))
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    data = [{"input_ids": r} for b in _batches() for r in b["input_ids"]]
    pmodel, popt, loader = accelerator.prepare(dataclasses.replace(jmodel), tx,
                                               JaxLoader(data, JaxBatchSampler(range(len(data)), BATCH)))
    assert popt.offload_opt_state == (tier != "resident")
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    losses = [float(step_fn(b)) for b in loader]
    masters = port_llama.llama_state_dict_from_flax(_np(pmodel.params), cfg)
    _reset_jax()
    return losses, masters


def _assert_adam_weights(got, want):
    assert set(got) == set(want)
    outside, total = {}, 0
    for name in want:
        g, w = got[name].numpy(), want[name].numpy()
        diff = np.abs(g - w)
        assert diff.max() <= 2 * LR * STEPS, (name, diff.max())
        n = int((diff > WEIGHTS_VS_JAX["atol"] + WEIGHTS_VS_JAX["rtol"] * np.abs(w)).sum())
        if n:
            outside[name] = (n, float(diff.max()))
        total += w.size
    assert sum(n for n, _ in outside.values()) <= max(1, total // 10**4), outside


@pytest.mark.parametrize("tier", ["resident", "optimizer_state", "cpu_offload", "disk"])
def test_tier_tracks_jaxs_same_tier(weights, tmp_path, tier):
    """llama_tiny in f32, 3 fused AdamW steps with clip 1.0 under the tier:
    JAX's losses and masters under its own tier (its host tier runs the
    same chunked code on the CPU, in its one memory space)."""
    jlosses, jmasters = _jax_run(weights, tier, tmp_path)
    losses, masters, _ = _port_run(weights, tier, tmp_path)
    np.testing.assert_allclose(losses, jlosses, **LOSS_VS_JAX)
    _assert_adam_weights(masters, jmasters)


# ------------------------------------------------------------------ JAX's cases
def test_offloaded_forward_works(weights):
    """A forward without gradients under `cpu_offload`: the output's shape,
    and the masters back in host memory after it."""
    accelerator = port.Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(cpu_offload=True))
    model = _port_model(weights)
    pmodel = accelerator.prepare(model)
    with torch.no_grad():
        out = pmodel(torch.ones(2, SEQ, dtype=torch.long))
    assert tuple(out.shape) == (2, SEQ, 512)
    assert pmodel.offload_params and not pmodel._params_on_device


def test_deepspeed_offload_config_lowers_to_host_tier(weights):
    """A ZeRO-Offload ds_config lowers to the pinned host tier (the state),
    not the masters'."""
    ds = DeepSpeedPlugin(hf_ds_config={"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}})
    fsdp = ds.to_fsdp_plugin()
    assert fsdp.offload_optimizer_state and not fsdp.offload_params
    accelerator = port.Accelerator(cpu=True, fsdp_plugin=fsdp)
    model = _port_model(weights)
    pmodel, popt = accelerator.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.01))
    assert isinstance(popt.offload, PinnedOptState)
    assert not pmodel.offload_params


def test_offloaded_load_state_dict_does_not_alias(weights):
    """Loading a snapshot into a model whose masters are offloaded copies
    it into the arena: training on leaves the caller's tensors as they
    were."""
    accelerator = port.Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(cpu_offload=True))
    model = _port_model(weights)
    pmodel, popt = accelerator.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.05))
    snapshot = {k: v.clone() for k, v in pmodel.full_state_dict().items()}
    kept = {k: v.clone() for k, v in snapshot.items()}
    pmodel.load_full_state_dict(snapshot)
    assert not any(snapshot[k].data_ptr() == p.data_ptr() for k, p in pmodel.module.named_parameters())
    step_fn = accelerator.train_step()
    for batch in _batches(2):
        step_fn({k: torch.as_tensor(v) for k, v in batch.items()})
    assert all(torch.equal(snapshot[k], kept[k]) for k in kept)
    assert not all(torch.equal(pmodel.full_state_dict()[k], kept[k]) for k in kept)


@pytest.mark.parametrize("tier", ["optimizer_state", "disk"])
def test_checkpoint_roundtrip_with_offload(weights, tmp_path, monkeypatch, tier):
    """`save_state` after a step, two more steps, `load_state`: the state is
    back bit for bit in its tier, and training continues as the run that
    was not cut (JAX's `test_checkpoint_roundtrip_with_offload` and
    `test_disk_tier_checkpoint_roundtrip`; the disk tier through the "nvme"
    alias)."""
    monkeypatch.setenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", "0")
    plugin = (FullyShardedDataParallelPlugin(sharding_strategy="SHARD_GRAD_OP", offload_optimizer_state=True)
              if tier == "optimizer_state" else
              FullyShardedDataParallelPlugin(offload_optimizer_device="nvme", offload_dir=str(tmp_path / "optstate")))
    accelerator = port.Accelerator(cpu=True, fsdp_plugin=plugin)
    model = _port_model(weights)
    pmodel, popt = accelerator.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.05, foreach=False))
    step_fn = accelerator.train_step()
    batches = [{k: torch.as_tensor(v) for k, v in b.items()} for b in _batches(4, seed=22)]
    step_fn(batches[0])
    want = {i: {k: torch.as_tensor(v).clone() for k, v in e.items()} for i, e in popt.state_dict()["state"].items()}
    accelerator.save_state(str(tmp_path / "ckpt"))
    uncut = [float(step_fn(b)) for b in batches[1:3]]
    accelerator.load_state(str(tmp_path / "ckpt"))
    got = popt.state_dict()["state"]
    assert all(torch.equal(torch.as_tensor(got[i][k]), want[i][k]) for i in want for k in want[i])
    assert popt.offload.tier == {"optimizer_state": "pinned_host", "disk": "disk"}[tier]
    assert [float(step_fn(b)) for b in batches[1:3]] == uncut


def test_chunked_update_with_scheduler_lr(weights, monkeypatch):
    """A scheduler's learning rate reaches every group's update: SGD under
    a linear schedule, one parameter a group, equals the resident run."""
    monkeypatch.setenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", "0")

    def run(offload):
        _reset_port()
        plugin = FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD", offload_optimizer_state=offload)
        accelerator = port.Accelerator(cpu=True, fsdp_plugin=plugin)
        model = _port_model(weights)
        optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        pmodel, popt, sched = accelerator.prepare(model, optimizer, lambda step: 0.1 * max(0.0, 1 - step / 8))
        lrs = []
        for batch in _batches(4, seed=4):
            accelerator.backward(pmodel.loss, {k: torch.as_tensor(v) for k, v in batch.items()})
            popt.step()
            sched.step()
            popt.zero_grad()
            lrs.append(popt.learning_rate)
        return {k: v.clone() for k, v in pmodel.full_state_dict().items()}, lrs, popt

    off, lrs_off, popt = run(True)
    assert popt.offload_opt_state and list(popt.offload.keys) == ["momentum_buffer"]
    base, lrs = run(False)[:2]
    assert lrs_off == lrs and len(set(lrs)) > 1
    assert all(torch.equal(off[k], base[k]) for k in base)


def test_disk_tier_bf16_llama_in_the_blob(weights, tmp_path, monkeypatch):
    """bf16 mixed precision over the disk tier, one parameter a group
    (JAX's llama case on its virtual mesh): finite, falling losses, and
    both moments of every parameter in the blob."""
    monkeypatch.setenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", "0")
    keep = {}
    losses, masters, _ = _port_run(weights, "disk", tmp_path, mixed_precision="bf16",
                                   batches=_batches(2) * 3, keep=keep)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    blob = tmp_path / "optstate" / "weights.bin"
    param_bytes = sum(v.numel() * v.element_size() for v in masters.values())
    assert blob.stat().st_size >= 2 * param_bytes
    assert len(keep["popt"].offload.groups) > 1


def test_disk_tier_poisoned_after_failed_step(weights, tmp_path, monkeypatch):
    """A write-back that fails after another group's landed poisons the
    state: the step raises the failure, a retry raises "inconsistent", and
    `load_state_dict` of a snapshot clears it."""
    monkeypatch.setenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", "0")
    plugin = FullyShardedDataParallelPlugin(offload_optimizer_device="disk", offload_dir=str(tmp_path / "optstate"))
    accelerator = port.Accelerator(cpu=True, fsdp_plugin=plugin)
    model = _port_model(weights)
    pmodel, popt = accelerator.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.05))
    batch = {k: torch.as_tensor(v) for k, v in _batches(1, seed=23)[0].items()}
    accelerator.backward(pmodel.loss, batch)
    popt.step()
    popt.zero_grad()
    snapshot = popt.state_dict()
    tier = popt.offload
    calls = {"n": 0}
    write_group = tier._write_group

    def failing(k, done):
        calls["n"] += 1
        if calls["n"] == 2:
            raise IOError("disk full")
        return write_group(k, done)

    tier._write_group = failing
    accelerator.backward(pmodel.loss, batch)
    with pytest.raises(IOError, match="disk full"):
        popt.step()
    tier._write_group = write_group
    assert tier.poisoned
    assert all(p.grad is None for p in pmodel.parameters())  # the step's gradients were dropped, as in JAX
    accelerator.backward(pmodel.loss, batch)
    with pytest.raises(RuntimeError, match="inconsistent"):
        popt.step()
    popt.load_state_dict(snapshot)
    assert not tier.poisoned
    popt.step()  # recovers


def test_disk_tier_reinit_does_not_grow_blob(weights, tmp_path):
    """A second optimizer over the same `offload_dir` starts a fresh blob."""
    sizes = []
    for _ in range(2):
        _port_run(weights, "disk", tmp_path, batches=_batches(1))
        sizes.append((tmp_path / "optstate" / "weights.bin").stat().st_size)
    assert sizes[1] == sizes[0]


def test_deepspeed_nvme_config_lowers_to_disk_tier():
    plugin = DeepSpeedPlugin(zero_stage=2, offload_optimizer_device="nvme").to_fsdp_plugin()
    assert plugin.offload_optimizer_device == "disk" and plugin.offload_to_disk


# ------------------------------------------------------------------ fp16, steps_per_call, the store
@pytest.mark.parametrize("tier", ["optimizer_state", "cpu_offload", "disk"])
def test_fp16_inf_step_leaves_every_tier_untouched(weights, tmp_path, monkeypatch, tier):
    """fp16 with loss scaling: a step whose gradients overflow (an embedding
    row of 7e4, past fp16's range) is skipped before any group is touched:
    masters and moments bit for bit as before it, the scale backed off."""
    monkeypatch.setenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", "0")
    accelerator = port.Accelerator(cpu=True, mixed_precision="fp16", **TIERS[tier](tmp_path))
    model = _port_model(weights)
    pmodel, popt = accelerator.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    batches = _batches(2, seed=5)
    step_fn({k: torch.as_tensor(v) for k, v in batches[0].items()})
    assert not popt.step_was_skipped
    before_w = {k: v.clone() for k, v in pmodel.full_state_dict().items()}
    before_s = {i: {k: torch.as_tensor(v).clone() for k, v in e.items()}
                for i, e in popt.state_dict()["state"].items()}
    scale = popt.scaler.scale
    poisoned = dict(batches[1])
    poisoned["input_ids"] = poisoned["input_ids"].copy()
    poisoned["input_ids"][0, 3] = 7
    with torch.no_grad():
        model.embed_tokens.weight[7] = 7e4  # above fp16's 65504 (in host memory under cpu_offload)
    before_w["embed_tokens.weight"][7] = 7e4
    step_fn({k: torch.as_tensor(v) for k, v in poisoned.items()})
    assert popt.step_was_skipped and popt.scaler.scale == scale * 0.5
    after_s = popt.state_dict()["state"]
    assert all(torch.equal(v, before_w[k]) for k, v in pmodel.full_state_dict().items())
    assert all(torch.equal(torch.as_tensor(after_s[i][k]), before_s[i][k]) for i in before_s for k in before_s[i])


@pytest.mark.parametrize("tier", ["optimizer_state", "disk"])
def test_steps_per_call_refused_with_offloaded_state(weights, tmp_path, tier):
    """JAX's error, at construction and per call (the tier turned on after
    the step was built)."""
    accelerator = port.Accelerator(cpu=True, **TIERS[tier](tmp_path))
    model = _port_model(weights)
    pmodel, popt = accelerator.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR))
    with pytest.raises(ValueError, match="incompatible with offloaded optimizer"):
        accelerator.train_step(steps_per_call=2)
    offload, popt.offload = popt.offload, None
    step_fn = accelerator.train_step(steps_per_call=2)
    popt.offload = offload
    batch = {"input_ids": torch.as_tensor(np.concatenate([b["input_ids"] for b in _batches(2)]))}
    with pytest.raises(ValueError, match="toggled on after train_step was built"):
        step_fn(batch)


def test_store_write_overwrites_in_place(tmp_path):
    """`write` of a tensor of the same bytes rewrites it where it is (the
    blob does not grow) and later reads see it; other bytes append; a
    reserved entry reads zeros until written; `in` names the entries."""
    store = NativeOffloadStore(str(tmp_path / "store"))
    store.save({"a": torch.arange(6, dtype=torch.float32)})
    size = os.path.getsize(store.blob_path)
    store.write("a", torch.full((6,), 2.5))
    assert os.path.getsize(store.blob_path) == size
    assert torch.equal(store.read("a"), torch.full((6,), 2.5))
    store.write("a", torch.ones(2, 3, dtype=torch.float32))  # same bytes, another shape
    assert tuple(store.read("a").shape) == (2, 3) and os.path.getsize(store.blob_path) == size
    store.write("b", torch.ones(3, dtype=torch.bfloat16))
    assert os.path.getsize(store.blob_path) > size and "b" in store and "c" not in store
    store.reserve([("c", (4,), torch.float32)])
    assert torch.equal(store.read("c"), torch.zeros(4))
    store.write("c", torch.arange(4, dtype=torch.float32))
    assert torch.equal(store.read("c"), torch.arange(4, dtype=torch.float32))
    reopened = NativeOffloadStore(str(tmp_path / "store"))
    assert torch.equal(reopened.read("c"), torch.arange(4, dtype=torch.float32)) and "b" in reopened
    store.close()
    reopened.close()


@pytest.mark.parametrize("budget_mb", [None, "0", "1"])
def test_offload_groups_are_jaxs(monkeypatch, budget_mb):
    """The same byte budget (256 MB, or ``ACCELERATE_TPU_OFFLOAD_CHUNK_MB``)
    cuts the same sizes into JAX's groups."""
    if budget_mb is None:
        monkeypatch.delenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", raising=False)
    else:
        monkeypatch.setenv("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", budget_mb)
    shapes = [(512, 128), (128,), (64, 1024), (1024, 1024), (300_000,), (8,), (200, 300), (70_000_000,), (3,)]
    tree = {f"p{i:02d}": np.zeros(s, np.float32) if np.prod(s) < 10**6 else jax.ShapeDtypeStruct(s, np.float32)
            for i, s in enumerate(shapes)}
    jax_groups = JaxOptimizer._offload_groups(None, tree)
    port_groups = offload_groups([int(np.prod(s)) * 4 for s in shapes])
    assert [[int(p.strip("[]'p")) for p in g] for g in jax_groups] == port_groups
