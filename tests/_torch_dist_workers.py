"""Worker functions for the port's multi-process tests
(`tests/test_torch_distributed.py`, `tests/test_torch_distributed_hybrid.py`,
`tests/test_torch_surface_distributed.py`, `tests/test_torch_scripts.py`,
`tests/test_torch_offload_distributed.py`, `tests/test_torch_local_sgd.py`,
`tests/test_torch_checkpoint_sharded.py`, `tests/test_torch_fp8_distributed.py`).

Each runs in a process `accelerate_tpu_torch.launchers.debug_launcher`
spawns (gloo on the CPU, one torch thread), reads the inputs the test wrote
(``inputs.pt``: weights, configs, per-process batches), runs every scenario
of its file in turn, and writes what it saw into ``rank<i>.pt``. It imports
torch and the port only: the JAX references run in the test's own process.
Every scenario runs on every process in the same order (each is one
program across the processes).
"""

import copy
import os
import time

import numpy as np
import torch

LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 1e-4


def _reset():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()


def _accelerator(strategy=None, mixed_precision="no", mesh=None, **kwargs):
    """A fresh `Accelerator` on the CPU: `strategy` None is plain data
    parallel; FULL_SHARD and SHARD_GRAD_OP shard over every process
    ("fsdp" = the world), unless `mesh` gives (data, fsdp)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig

    _reset()
    world = int(os.environ["WORLD_SIZE"])
    plugin_kw = {k: kwargs.pop(k) for k in ("sync_module_states", "min_num_params", "reduce_dtype", "activation_checkpointing",
                                            "offload_optimizer_state", "cpu_offload", "offload_optimizer_device",
                                            "offload_dir") if k in kwargs}
    plugin_kw.setdefault("min_num_params", 1000)
    plugin = None if strategy is None else FullyShardedDataParallelPlugin(sharding_strategy=strategy, **plugin_kw)
    if mesh is None:
        mesh = (1, world) if strategy in ("FULL_SHARD", "SHARD_GRAD_OP") else (world, 1)
    return Accelerator(cpu=True, mixed_precision=mixed_precision, fsdp_plugin=plugin,
                       parallelism_config=ParallelismConfig(data=mesh[0], fsdp=mesh[1]), **kwargs)


def _llama(cfg, state_dict=None, seed=0):
    from accelerate_tpu_torch.models import llama

    model = llama.create_llama_model(cfg, seed=seed, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _adamw(model):
    """AdamW with its multi-tensor update, the implementation torch picks
    on the card (on the CPU it picks the per-tensor loop)."""
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD, foreach=True)


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _layout_report(pmodel, popt):
    """How each parameter and its first moment sit on this process."""
    from torch.distributed.tensor import DTensor

    params = {}
    for name, p in pmodel.module.named_parameters():
        params[name] = (isinstance(p, DTensor), str(p.placements) if isinstance(p, DTensor) else None,
                        tuple((p.to_local() if isinstance(p, DTensor) else p).shape))
    moments = {}
    names = [pmodel.layout.name_of(p) for g in popt.optimizer.param_groups for p in g["params"]]
    for name, p in zip(names, [p for g in popt.optimizer.param_groups for p in g["params"]]):
        state = popt.optimizer.state.get(p, {})
        if "exp_avg" in state:
            m = state["exp_avg"]
            moments[name] = tuple((m.to_local() if isinstance(m, DTensor) else m).shape)
    return {"params": params, "moments": moments}


def train(inputs, strategy, key="train", mixed_precision="no", accumulation=1, mesh=None, loader=True, **kw):
    """3 fused AdamW steps of llama_tiny (clip 1.0): through the prepared
    loader over the global batches (`split_batches`), or on the batches the
    test cut for this process."""
    from accelerate_tpu_torch import BatchSampler, SimpleDataLoader

    rank = int(os.environ["RANK"])
    acc = _accelerator(strategy, mixed_precision=mixed_precision, mesh=mesh, split_batches=True, **kw)
    model = _llama(inputs["llama_cfg"], inputs["poisoned_sd" if key == "fp16" else "sd"])
    pmodel, popt = acc.prepare(model, _adamw(model))
    step = acc.train_step(max_grad_norm=1.0, accumulation_steps=accumulation)
    if loader:
        rows = inputs["rows"][key]
        batches = acc.prepare_data_loader(SimpleDataLoader(rows, BatchSampler(range(len(rows)), inputs["global_batch"])))
    else:
        batches = [_tensors(b) for b in inputs["local_batches"][key][rank]]
    losses, skipped, scales = [], [], []
    for batch in batches:
        losses.append(step(batch).item())
        skipped.append(popt.step_was_skipped)
        scales.append(popt.scaler.scale if popt.scaler is not None else None)
    report = _layout_report(pmodel, popt)
    weights = pmodel.full_state_dict()
    moments = popt.state_dict()
    return {"losses": losses, "skipped": skipped, "scales": scales, "layout": report,
            "weights": weights if rank == 0 else None, "moments": moments if rank == 0 else None,
            "world_weights_digest": float(sum(v.double().sum() for v in weights.values()))}


def sync_module_states(inputs):
    """Processes seeded apart hold process 0's weights after `prepare`."""
    rank = int(os.environ["RANK"])
    acc = _accelerator("FULL_SHARD")
    pmodel = acc.prepare(_llama(inputs["llama_cfg"], seed=rank))
    return pmodel.full_state_dict()


def loss_grads(inputs, family):
    """One backward of `family`'s bundled loss on this process's rows
    (data parallel), the gradients averaged across the processes."""
    from accelerate_tpu_torch.models import bert, llama, resnet, t5

    rank = int(os.environ["RANK"])
    acc = _accelerator(None)
    build = {"llama": llama.create_llama_model, "t5": t5.create_t5_model, "bert": bert.create_bert_model,
             "resnet": resnet.create_resnet_model}[family]
    model = build(inputs["loss_cfgs"][family], device="cpu")
    model.load_state_dict(inputs["loss_sds"][family])
    pmodel, popt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.0))
    loss = acc.backward(pmodel.loss, _tensors(inputs["loss_batches"][family][rank]))
    popt.reduce_gradients()
    grads = {n: p.grad.clone() for n, p in pmodel.module.named_parameters() if p.grad is not None}
    return {"loss": loss.item(), "grads": grads if rank == 0 else None}


def gather_27():
    """`gather_for_metrics` over a 27-sample evaluation set in batches of 8
    (JAX's `tests/test_launchers.py` case): the padded tail is cut."""
    from accelerate_tpu_torch import BatchSampler, SimpleDataLoader

    acc = _accelerator(None)
    rows = [{"y": np.float32(i)} for i in range(27)]
    loader = acc.prepare_data_loader(SimpleDataLoader(rows, BatchSampler(range(27), 8)))
    seen, local = [], []
    for batch in loader:
        local.append(batch["y"].tolist())
        seen.append(acc.gather_for_metrics(batch["y"]))
        objects = acc.gather_for_metrics(batch["y"].tolist(), use_gather_object=True)
    return {"gathered": torch.cat(seen).tolist(), "local": local, "objects_last": objects,
            "remainder": loader.remainder}


def split():
    """`split_between_processes` as JAX's `_split_worker` drives it."""
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    nested = {"outer": {"x": np.arange(16).reshape(16, 1), "y": list(range(16))}}
    with state.split_between_processes(nested) as mine:
        out = [int(mine["outer"]["x"].shape[0]), len(mine["outer"]["y"]), mine["outer"]["y"]]
    with state.split_between_processes(np.arange(10), apply_padding=True) as arr:
        out.append(int(arr.shape[0]))
    with state.split_between_processes(torch.arange(9), apply_padding=True) as t:
        out.append(t.tolist())
    try:
        with state.split_between_processes({"a": list(range(8)), "sub": {"b": list(range(3))}}):
            pass
        out.append("no-error")
    except ValueError:
        out.append("raised")
    return out


def collectives():
    """The collectives of `utils.operations` and the process surface."""
    from accelerate_tpu_torch.utils import operations as ops

    rank = int(os.environ["RANK"])
    acc = _accelerator(None)
    t = torch.full((2, 3), float(rank))
    uneven = torch.ones(rank + 1, 2) * rank
    out = {
        "gather": ops.gather({"t": t, "n": np.full((1,), rank)}),
        "gather_object": ops.gather_object([f"r{rank}"]),
        "broadcast": ops.broadcast(t + 10, from_process=1),
        "broadcast_object_list": ops.broadcast_object_list([f"r{rank}", rank], from_process=0),
        "reduce_sum": acc.reduce(t + 1, reduction="sum"),
        "reduce_mean": ops.reduce(t + 1, reduction="mean", scale=2.0),
        "pad": acc.pad_across_processes(uneven, dim=0, pad_index=-1),
        "pad_first": ops.pad_across_processes(uneven, dim=0, pad_index=-1, pad_first=True),
        "process": (acc.num_processes, acc.process_index, acc.local_process_index, acc.is_main_process,
                    acc.is_local_main_process, acc.is_last_process, str(acc.distributed_type)),
        "on_main": acc.on_main_process(lambda: "main")(),
        "on_process_1": acc.on_process(lambda: "one", process_index=1)(),
        "seed": __import__("accelerate_tpu_torch").set_seed(5, device_specific=True),
    }
    order = []
    with acc.main_process_first():
        order.append(rank)
    acc.wait_for_everyone()
    return out


def trackers(out_dir):
    """A JSON tracker under a shared directory: only process 0 writes."""
    rank = int(os.environ["RANK"])
    acc = _accelerator(None, log_with="json", project_dir=os.path.join(out_dir, "trackers"))
    acc.init_trackers("run", config={"rank": rank})
    acc.log({"loss": 1.0 + rank}, step=0)
    acc.print(f"printed by {rank}")
    acc.end_training()
    return True


def checkpoint(inputs, out_dir):
    """FULL_SHARD: 3 steps, `save_state`, 3 more (the uncut run); a fresh
    FULL_SHARD `Accelerator` loads the checkpoint and takes the same 3; a
    third loads the one-process checkpoint the test wrote."""
    rank = int(os.environ["RANK"])
    batches = [_tensors(b) for b in inputs["local_batches"]["checkpoint"][rank]]
    path = os.path.join(out_dir, "ckpt_w2")

    def fresh():
        acc = _accelerator("FULL_SHARD")
        model = _llama(inputs["llama_cfg"], inputs["sd"])
        pmodel, popt = acc.prepare(model, _adamw(model))
        return acc, pmodel, popt, acc.train_step(max_grad_norm=1.0)

    acc, pmodel, popt, step = fresh()
    uncut = [step(b).item() for b in batches[:3]]
    acc.save_state(path)
    at_save = pmodel.full_state_dict()
    uncut += [step(b).item() for b in batches[3:]]
    acc, pmodel, popt, step = fresh()
    acc.load_state(path)
    resumed = [step(b).item() for b in batches[3:]]
    acc, pmodel, popt, step = fresh()
    acc.load_state(inputs["ckpt_w1"])
    w1_weights, w1_moments = pmodel.full_state_dict(), popt.state_dict()
    return {"path": path, "uncut": uncut, "resumed": resumed, "at_save": at_save if rank == 0 else None,
            "w1_weights": w1_weights if rank == 0 else None, "w1_moments": w1_moments if rank == 0 else None}


def refusals(inputs):
    """Mixtral across processes raises, naming what it waits for; an fp8
    `Accelerator` builds ("no-error")."""
    from accelerate_tpu_torch.models import mixtral

    out = {}
    try:
        _accelerator(None, mixed_precision="fp8")
        out["fp8"] = "no-error"
    except NotImplementedError as e:
        out["fp8"] = str(e)
    acc = _accelerator(None)
    try:
        acc.prepare(mixtral.create_mixtral_model(mixtral.mixtral_tiny(), device="cpu"))
        out["mixtral"] = "no-error"
    except NotImplementedError as e:
        out["mixtral"] = str(e)
    return out


def world2(in_dir, out_dir):
    """Every scenario of `tests/test_torch_distributed.py`, in order."""
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    out = {}
    for strategy in ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD"):
        out["train", strategy] = train(inputs, strategy)
    out["train", "none"] = train(inputs, None)
    out["accumulate"] = train(inputs, "FULL_SHARD", key="accumulate", accumulation=2, loader=False)
    out["accumulate", "SHARD_GRAD_OP"] = train(inputs, "SHARD_GRAD_OP", key="accumulate", accumulation=2,
                                               loader=False, reduce_dtype="float32")
    out["fp16"] = train(inputs, "FULL_SHARD", key="fp16", mixed_precision="fp16")
    out["remat"] = train(inputs, "FULL_SHARD", activation_checkpointing=True)
    out["sync"] = sync_module_states(inputs)
    out["losses"] = {family: loss_grads(inputs, family) for family in inputs["loss_cfgs"]}
    out["gather"] = gather_27()
    out["split"] = split()
    out["collectives"] = collectives()
    out["trackers"] = trackers(out_dir)
    out["checkpoint"] = checkpoint(inputs, out_dir)
    out["refusals"] = refusals(inputs)
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


def world4(in_dir, out_dir):
    """HYBRID_SHARD over (data 2, fsdp 2), and its ZeRO-2 form."""
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    out = {}
    for strategy in ("HYBRID_SHARD", "HYBRID_SHARD_ZERO2"):
        out["train", strategy] = train(inputs, strategy, mesh=(2, 2))
    # The optimizer's state in pinned host memory and in the disk store, a
    # group a parameter, under HYBRID_SHARD's 2-D FSDP mesh.
    os.environ["ACCELERATE_TPU_OFFLOAD_CHUNK_MB"] = "0"
    out["train", "HYBRID_SHARD", "optimizer_state"] = train(inputs, "HYBRID_SHARD", mesh=(2, 2),
                                                            offload_optimizer_state=True)
    out["train", "HYBRID_SHARD", "disk"] = train(
        inputs, "HYBRID_SHARD", mesh=(2, 2), offload_optimizer_device="disk",
        offload_dir=os.path.join(out_dir, f"disk{os.environ['RANK']}"))
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


# ------------------------------------------------------------------ the Accelerator's surface
SCHEDULER_STEPS = 3


def schedule(step):
    return 1.0 / (1 + step)


def scheduler_run(split_batches=False, step_with_optimizer=True):
    """`SCHEDULER_STEPS` optimizer steps of a one-weight model under
    ``1 / (1 + step)``; without `step_with_optimizer` two micro-steps a sync,
    with a scheduler step after each. Returns (step_count, lr) after each
    optimizer step."""
    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader

    _reset()
    accumulation = 1 if step_with_optimizer else 2
    acc = Accelerator(cpu=True, split_batches=split_batches, step_scheduler_with_optimizer=step_with_optimizer,
                      gradient_accumulation_steps=accumulation)
    model = torch.nn.Linear(1, 1)
    rows = [{"x": np.float32([i])} for i in range(4 * SCHEDULER_STEPS * accumulation)]
    loader = SimpleDataLoader(rows, BatchSampler(range(len(rows)), 4 if split_batches else 2))
    pmodel, opt, loader, sched = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=1.0), loader, schedule)
    seen = []
    for batch in loader:
        with acc.accumulate(pmodel):
            acc.backward(lambda b: pmodel(b["x"]).sum(), batch)
            opt.step()
            sched.step()
            opt.zero_grad()
        if acc.sync_gradients:
            seen.append((sched.step_count, sched.get_last_lr()[0], opt.learning_rate))
    return seen


def trigger():
    """Rank 1 alone raises the trigger: every rank sees it once."""
    from accelerate_tpu_torch import Accelerator

    _reset()
    acc = Accelerator(cpu=True)
    before = acc.check_trigger()
    if acc.process_index == 1:
        acc.set_trigger()
    return [before, acc.check_trigger(), acc.check_trigger()]


def rng_states(generator, gen2):
    import random

    return {"python": random.random(), "numpy": float(np.random.rand()), "torch": float(torch.rand(1)),
            "sampler": generator.state_dict(), "generator": float(torch.rand(1, generator=gen2))}


def rng_sync():
    """Each rank seeds its generators by its rank; after
    `synchronize_rng_states` every rank draws rank 0's numbers. Then a
    loader prepared with ``rng_types=["generator"]`` over a sampler seeded
    by rank: its first pass shares rank 0's permutation."""
    import random

    from accelerate_tpu_torch import Accelerator, BatchSampler, SeedableRandomSampler, SimpleDataLoader
    from accelerate_tpu_torch.utils.random import synchronize_rng_states

    _reset()
    rank = int(os.environ["RANK"])
    acc = Accelerator(cpu=True)

    def seed_all():
        random.seed(100 + rank)
        np.random.seed(200 + rank)
        torch.manual_seed(300 + rank)
        gen2 = torch.Generator()
        gen2.manual_seed(400 + rank)
        return SeedableRandomSampler(num_samples=16, seed=500 + rank, epoch=rank), gen2

    sampler, gen2 = seed_all()
    unsynced = rng_states(sampler, gen2)
    sampler, gen2 = seed_all()
    synchronize_rng_states(["python", "numpy", "torch", "generator"], sampler)
    synchronize_rng_states(["generator"], gen2)
    synced = rng_states(sampler, gen2)
    rows = [{"i": np.int64(i)} for i in range(16)]
    _reset()
    acc = Accelerator(cpu=True, rng_types=["generator"])
    loader = acc.prepare(SimpleDataLoader(rows, BatchSampler(SeedableRandomSampler(num_samples=16, seed=500 + rank), 4)))
    batches = [b["i"].tolist() for b in loader]
    return {"unsynced": unsynced, "synced": synced, "loader": batches}


def dispatch(split_batches, even_batches=True, skip=0):
    """A `DataLoaderDispatcher` (``dispatch_batches=True``) over 27 samples,
    batch 4 a process (8 global with `split_batches`): each rank's batches,
    their `gather_for_metrics`, and the remainder seen."""
    from accelerate_tpu_torch import Accelerator, BatchSampler, DataLoaderConfiguration, SimpleDataLoader
    from accelerate_tpu_torch.data_loader import DataLoaderDispatcher

    _reset()
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
        dispatch_batches=True, split_batches=split_batches, even_batches=even_batches))
    rows = [{"x": np.arange(3, dtype=np.float32) + 10 * i, "y": np.int64(i)} for i in range(27)]
    loader = acc.prepare(SimpleDataLoader(rows, BatchSampler(range(27), 8 if split_batches else 4)))
    assert isinstance(loader, DataLoaderDispatcher)
    if skip:
        loader = acc.skip_first_batches(loader, skip)
    out = {"len": len(loader), "batches": [], "gathered": []}
    for batch in loader:
        out["batches"].append({k: v.numpy() for k, v in batch.items()})
        out["gathered"].append(acc.gather_for_metrics(batch["y"]).numpy())
    return out


class _Counting(torch.utils.data.IterableDataset):
    def __iter__(self):
        return iter(torch.arange(20).tolist())


def iterable_dispatch():
    """A torch loader over an iterable dataset is dispatched by default
    across processes, as JAX decides: each rank's batches."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import DataLoaderDispatcher

    _reset()
    acc = Accelerator(cpu=True)
    loader = acc.prepare(torch.utils.data.DataLoader(_Counting(), batch_size=4))
    return {"dispatcher": isinstance(loader, DataLoaderDispatcher), "batches": [b.tolist() for b in loader]}


def ordering(out_dir):
    """`local_main_process_first`: the local main process runs the body,
    slowly, before the other enters; each writes on entering and leaving."""
    import time

    from accelerate_tpu_torch import Accelerator

    _reset()
    acc = Accelerator(cpu=True)
    path = os.path.join(out_dir, "order.txt")
    with acc.local_main_process_first():
        with open(path, "a") as f:
            f.write(f"enter {acc.process_index}\n")
        if acc.is_local_main_process:
            time.sleep(0.5)
        with open(path, "a") as f:
            f.write(f"leave {acc.process_index}\n")
    acc.wait_for_everyone()
    calls = []
    acc.on_local_main_process(lambda: calls.append("local main"))()
    acc.state._partial.on_last_process(lambda: calls.append("last"))()
    return calls


def logger_output(out_dir):
    """`get_logger`'s adapter: a line for the main process only, then one
    with ``main_process_only=False, in_order=True`` (every process logs it),
    each process writing its own file."""
    import logging

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.logging import get_logger

    _reset()
    acc = Accelerator(cpu=True)
    logger = get_logger("surface.dist", log_level="INFO")
    handler = logging.FileHandler(os.path.join(out_dir, f"log{acc.process_index}.txt"))
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.logger.addHandler(handler)
    try:
        logger.info("main only")
        logger.info("every process %d", acc.process_index, main_process_only=False, in_order=True)
    finally:
        logger.logger.removeHandler(handler)
        handler.close()
    acc.wait_for_everyone()
    return True


CLIP_ROWS = dict(n=24, seq=16, seed=7, global_batch=8)


def clip_rows():
    c = CLIP_ROWS
    ids = np.random.default_rng(c["seed"]).integers(0, 512, (c["n"], c["seq"])).astype(np.int64)
    return [{"input_ids": ids[i]} for i in range(c["n"])]


def clip_value_run(strategy, clip_value=2e-3):
    """3 eager AdamW steps of `llama_tiny` (seed 0) with `clip_grad_value_`
    before each, over the global batches of `clip_rows` (`split_batches`):
    the losses and, on rank 0, the whole weights."""
    from accelerate_tpu_torch import BatchSampler, SimpleDataLoader
    from accelerate_tpu_torch.models import llama

    acc = _accelerator(strategy, split_batches=True)
    model = llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu")
    pmodel, opt, loader = acc.prepare(model, _adamw(model), SimpleDataLoader(
        clip_rows(), BatchSampler(range(CLIP_ROWS["n"]), CLIP_ROWS["global_batch"])))
    losses = []
    for batch in loader:
        with acc.accumulate(pmodel):
            losses.append(acc.backward(pmodel.loss, batch).item())
            acc.clip_grad_value_(clip_value=clip_value)
            opt.step()
            opt.zero_grad()
    weights = pmodel.full_state_dict()
    return {"losses": losses, "weights": weights if acc.is_main_process else None}


def save_model_run(out_dir):
    """`save_model` of `llama_tiny` at world 2: data parallel and FULL_SHARD
    with FULL_STATE_DICT write (rank 0) what the model holds whole, in
    shards; FULL_SHARD's default SHARDED_STATE_DICT raises. Then the
    autocast policy under FULL_SHARD: `autocast()` cannot toggle it, an
    `AutocastKwargs(enabled=False)` handler runs its forward in f32."""
    from accelerate_tpu_torch import AutocastKwargs, checkpointing
    from accelerate_tpu_torch.models import llama

    out = {}
    for strategy, state_dict_type in ((None, None), ("FULL_SHARD", "FULL_STATE_DICT"),
                                      ("FULL_SHARD", "SHARDED_STATE_DICT")):
        tag = f"{strategy}-{state_dict_type}"
        acc = _accelerator(strategy)
        if state_dict_type is not None:
            acc.state.fsdp_plugin.state_dict_type = state_dict_type
        pmodel = acc.prepare(llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu"))
        directory = os.path.join(out_dir, "save_model", tag)
        try:
            acc.save_model(pmodel, directory, max_shard_size="300KB")
        except NotImplementedError as e:
            out[tag] = str(e)
            continue
        whole = pmodel.full_state_dict()
        written = checkpointing.load_model_safetensors(directory) if acc.is_main_process else whole
        out[tag] = {"files": sorted(os.listdir(directory)) if acc.is_main_process else None,
                    "equal": all(torch.equal(written[k], v) for k, v in whole.items()) and written.keys() == whole.keys()}
    acc = _accelerator(None)
    pmodel = acc.prepare(llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu"))
    calls, path = [], os.path.join(out_dir, "hooked_state")
    acc.register_save_state_pre_hook(lambda models, w, d: calls.append(("save", models == [pmodel], w, d == path)))
    acc.register_load_state_pre_hook(lambda models, d: calls.append(("load", models == [pmodel], os.path.samefile(d, path))))
    acc.save_state(path)
    acc.load_state(path)
    out["hooks"] = calls
    acc = _accelerator("FULL_SHARD", mixed_precision="bf16")
    pmodel = acc.prepare(llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu"))
    try:
        with acc.autocast(AutocastKwargs(enabled=False)):
            pass
        out["toggle"] = "no-error"
    except NotImplementedError as e:
        out["toggle"] = str(e)
    acc = _accelerator("FULL_SHARD", mixed_precision="bf16", kwargs_handlers=[AutocastKwargs(enabled=False)])
    pmodel = acc.prepare(llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu"))
    ids = torch.as_tensor(clip_rows()[0]["input_ids"])[None]
    with torch.no_grad():
        logits = pmodel(ids)
    plain = llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu")
    with torch.no_grad():
        out["f32_forward"] = bool(torch.allclose(logits, plain(ids), rtol=1e-5, atol=1e-5))
    return out


def surface2(in_dir, out_dir):
    """Every scenario of `tests/test_torch_surface_distributed.py`, in order."""
    out = {
        "clip": {strategy or "none": clip_value_run(strategy)
                 for strategy in (None, "NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD")},
        "save_model": save_model_run(out_dir),
        "scheduler": {"default": scheduler_run(), "split": scheduler_run(split_batches=True),
                      "per_call": scheduler_run(step_with_optimizer=False)},
        "trigger": trigger(),
        "rng": rng_sync(),
        "dispatch": {"plain": dispatch(False), "split": dispatch(True), "uneven": dispatch(False, even_batches=False),
                     "skip": dispatch(False, skip=2)},
        "iterable": iterable_dispatch(),
        "ordering": ordering(out_dir),
        "logger": logger_output(out_dir),
    }
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


def scripts2(out_dir):
    """The bundled `test_ops` and `test_sync` scripts (`tests/test_torch_scripts.py`),
    each check's line kept in ``rank<i>.txt``."""
    import contextlib
    import io

    from accelerate_tpu_torch.test_utils.scripts import test_ops, test_sync

    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        test_ops.main()
        test_sync.main()
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.txt"), "w") as f:
        f.write(lines.getvalue())


# ------------------------------------------------------------------ the offload tiers and LocalSGD
OFFLOAD_TIERS = {"resident": {}, "optimizer_state": {"offload_optimizer_state": True},
                 "disk": {"offload_optimizer_device": "disk"}, "cpu_offload": {"cpu_offload": True}}


def offload_checkpoint(inputs, out_dir):
    """FULL_SHARD with the disk tier: save after 2 of 4 steps, go on, load,
    and take steps 3 and 4 again."""
    rank = int(os.environ["RANK"])
    acc = _accelerator("FULL_SHARD", offload_optimizer_device="disk",
                       offload_dir=os.path.join(out_dir, f"ckpt_disk{rank}"))
    model = _llama(inputs["llama_cfg"], inputs["sd"])
    pmodel, popt = acc.prepare(model, _adamw(model))
    step = acc.train_step(max_grad_norm=1.0)
    batches = [_tensors(b) for b in inputs["local_batches"]["checkpoint"][rank]]
    losses = [step(b).item() for b in batches[:2]]
    path = os.path.join(out_dir, "offload_ckpt")
    acc.save_state(path)
    uncut = [step(b).item() for b in batches[2:]]
    acc.load_state(path)
    resumed = [step(b).item() for b in batches[2:]]
    return {"losses": losses, "uncut": uncut, "resumed": resumed}


def offload2(in_dir, out_dir):
    """Every strategy under each offload tier, 3 fused AdamW steps over the
    prepared loader; the masters' tier under the sharded strategies is
    refused."""
    os.environ["ACCELERATE_TPU_OFFLOAD_CHUNK_MB"] = "0"  # a group a parameter
    rank = int(os.environ["RANK"])
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    out = {}
    for strategy in ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD"):
        for tier, kw in OFFLOAD_TIERS.items():
            if tier == "disk":
                kw = dict(kw, offload_dir=os.path.join(out_dir, f"disk_{strategy}_{rank}"))
            try:
                out["train", strategy, tier] = train(inputs, strategy, **kw)
            except NotImplementedError as e:
                out["train", strategy, tier] = str(e)
    out["checkpoint"] = offload_checkpoint(inputs, out_dir)
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _regression(weights):
    """The one-weight regression model of `tests/test_torch_local_sgd.py`,
    its loss JAX's mean over the global batch (`ops.losses.global_mean`)."""
    from accelerate_tpu_torch import Model
    from accelerate_tpu_torch.ops.losses import global_mean

    module = torch.nn.Linear(1, 1)
    with torch.no_grad():
        module.weight.copy_(torch.as_tensor(weights["kernel"]).T)
        module.bias.copy_(torch.as_tensor(weights["bias"]))

    def loss_fn(batch, apply_fn):
        return global_mean((apply_fn(batch["x"])[:, 0] - batch["y"]) ** 2)

    return Model(module, loss_fn=loss_fn)


def local_sgd_train(inputs, local_sgd_steps=None, key="k1", enabled=True, tier=None, after=0):
    """JAX's `_run` at world 2: eager `backward`/`step`/`zero_grad` over
    the prepared loader (each process its half of the global batch of
    16), inside `LocalSGD` unless `local_sgd_steps` is None; losses and the
    weights after every step (each process's own, to see them part and
    meet), then `after` more steps past the block."""
    from accelerate_tpu_torch import BatchSampler, LocalSGD, SimpleDataLoader

    rows, batch = inputs["local_sgd_rows"][key], inputs["local_sgd_batch"][key]
    kw = {} if tier is None else OFFLOAD_TIERS[tier]
    if tier == "disk":
        kw = dict(kw, offload_dir=os.path.join(inputs["out_dir"], f"lsgd_disk{os.environ['RANK']}"))
    acc = _accelerator("NO_SHARD" if tier else None, mesh=(int(os.environ["WORLD_SIZE"]), 1), split_batches=True,
                       **kw)
    model = _regression(inputs["regression"])
    optimizer = (torch.optim.SGD(model.module.parameters(), lr=inputs["local_sgd_lr"]) if tier is None else
                 torch.optim.AdamW(model.module.parameters(), lr=inputs["local_sgd_lr"], foreach=True))
    pmodel, popt = acc.prepare(model, optimizer)
    loader = acc.prepare_data_loader(SimpleDataLoader(rows, BatchSampler(range(len(rows)), batch)))
    losses, weights, out = [], [], {}

    def weights_now():
        lin = pmodel.module
        return np.concatenate([lin.weight.detach().numpy().ravel(), lin.bias.detach().numpy().ravel()])

    def one(b):
        losses.append(acc.backward(pmodel.loss, b).item())
        popt.step()
        popt.zero_grad()

    if local_sgd_steps is None:
        for b in loader:
            one(b)
            weights.append(weights_now())
    else:
        try:
            with LocalSGD(accelerator=acc, model=pmodel, local_sgd_steps=local_sgd_steps, enabled=enabled) as lsgd:
                out["enabled"] = lsgd.enabled
                for b in loader:
                    one(b)
                    lsgd.step()
                    weights.append(weights_now())
        except NotImplementedError as e:
            return {"refused": str(e)}
    out["offload_after"] = None if popt.offload is None else popt.offload.tier
    for _ in range(after):
        for b in loader:
            one(b)
    out.update(losses=losses, weights=weights, final=weights_now())
    return out


def local_sgd_refusal():
    """LocalSGD over a mesh whose "fsdp" axis is 2."""
    from accelerate_tpu_torch import LocalSGD

    acc = _accelerator("SHARD_GRAD_OP", mesh=(1, int(os.environ["WORLD_SIZE"])))
    model = torch.nn.Linear(4, 4)
    pmodel = acc.prepare(model)
    try:
        LocalSGD(accelerator=acc, model=pmodel, local_sgd_steps=2)
        return "no-error"
    except NotImplementedError as e:
        return str(e)


def local_sgd2(in_dir, out_dir):
    """Every scenario of `tests/test_torch_local_sgd.py`, in order."""
    import logging

    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    inputs["out_dir"] = out_dir
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger("accelerate_tpu_torch.local_sgd").addHandler(Keep())
    out = {
        "dp": local_sgd_train(inputs, None),
        "k1": local_sgd_train(inputs, 1),
        "k2": local_sgd_train(inputs, 2),
        "disabled": local_sgd_train(inputs, 1, enabled=False),
        "exit": local_sgd_train(inputs, 2, key="exit", after=1),
        "fsdp_refused": local_sgd_refusal(),
        "pinned": local_sgd_train(inputs, 2, tier="optimizer_state", after=1),
        "pinned_resident": local_sgd_train(inputs, 2, tier="resident", after=1),
        "disk": local_sgd_train(inputs, 2, tier="disk"),
    }
    out["warnings"] = records
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


def local_sgd_example(in_dir, out_dir):
    """The `by_feature/local_sgd.py` twin at 2 processes, JAX's initial
    BERT weights carried in: each epoch's printed loss."""
    from accelerate_tpu_torch.examples.by_feature import local_sgd as twin
    from accelerate_tpu_torch.models import bert

    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)

    def create(config, device=None, **kwargs):
        model = bert.create_bert_model(config, device=device)
        model.load_state_dict(bert.bert_state_dict_from_flax(inputs["bert_params"], config))
        return model

    twin.create_bert_model = create
    _reset()
    losses = twin.training_function(twin.parse_args(inputs["argv"]))
    _reset()
    torch.save(losses, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


# ------------------------------------------------------------------ sharded checkpoints
ODD_STEPS, ODD_GLOBAL_BATCH = 4, 8


def odd_mlp(seed):
    """A small MLP one of whose weights, [5, 14], has a dim 0 that 2 does
    not divide (FSDP shards it on dim 1, and leaves its bias of 5 and the
    head [3, 5] whole); its loss JAX's mean over the global batch."""
    from accelerate_tpu_torch import Model
    from accelerate_tpu_torch.ops.losses import global_mean

    torch.manual_seed(seed)
    module = torch.nn.Module()
    module.layers = torch.nn.ModuleList([torch.nn.Linear(12, 14), torch.nn.Linear(14, 5)])
    module.head = torch.nn.Linear(5, 3)

    def apply(x):
        h = torch.tanh(module.layers[0](x))
        return module.head(torch.tanh(module.layers[1](h)))

    module.forward = apply

    def loss_fn(batch, apply_fn):
        return global_mean(((apply_fn(batch["x"]) - batch["y"]) ** 2).mean(-1))

    return Model(module, loss_fn=loss_fn)


def odd_batches(rank, world):
    """`ODD_STEPS` global batches of `ODD_GLOBAL_BATCH` rows (numpy seed 0),
    this process's contiguous share of each."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ODD_STEPS, ODD_GLOBAL_BATCH, 12)).astype(np.float32)
    y = rng.normal(size=(ODD_STEPS, ODD_GLOBAL_BATCH, 3)).astype(np.float32)
    n = ODD_GLOBAL_BATCH // world
    return [{"x": torch.as_tensor(x[i, rank * n:(rank + 1) * n]), "y": torch.as_tensor(y[i, rank * n:(rank + 1) * n])}
            for i in range(ODD_STEPS)]


def sharded_checkpoint_run(out_dir, strategy, mode):
    """2 fused AdamW steps, a sharded save (synchronous or async) into a
    directory, 2 more steps; then a fresh accelerator of the same strategy
    (weights from another seed) loads it and takes those 2 steps again."""
    from accelerate_tpu_torch.checkpointing import shard_host_dir

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    batches = odd_batches(rank, world)

    def prepared(seed):
        acc = _accelerator(strategy, min_num_params=1)
        model = odd_mlp(seed)
        pmodel, popt = acc.prepare(model, _adamw(model.module))
        return acc, pmodel, popt, acc.train_step(max_grad_norm=1.0)

    acc, pmodel, popt, step = prepared(0)
    losses = [step(b).item() for b in batches[:2]]
    path = os.path.join(out_dir, f"{strategy}_{mode}")
    t0 = time.perf_counter()
    acc.save_state(path, async_save=mode == "async", sharded=True)
    blocking_s = time.perf_counter() - t0
    acc.drain_checkpoints()
    acc.wait_for_everyone()  # the main process's manifest is in before anyone reads
    # A copy: the whole state keeps the live step counts, which the next steps advance.
    gathered, moments = pmodel.full_state_dict(), copy.deepcopy(popt.state_dict())
    uncut = [step(b).item() for b in batches[2:]]
    acc, pmodel, popt, step = prepared(1)
    acc.load_state(path)
    resumed = [step(b).item() for b in batches[2:]]
    host = os.path.join(path, shard_host_dir(rank))
    bounds = {}
    for name in ("model.pt", "optimizer.pt"):
        payload = torch.load(os.path.join(host, name), weights_only=True)
        bounds[name] = {p: [s["bounds"] for s in shards] for p, shards in zip(payload["paths"], payload["shards"])}
    dims = dict(pmodel.layout.param_dims if pmodel.layout.uses_fsdp else pmodel.layout.opt_dims)
    return {"losses": losses, "uncut": uncut, "resumed": resumed, "bounds": bounds, "dims": dims,
            "blocking_s": blocking_s, "gathered": gathered if rank == 0 else None,
            "moments": moments if rank == 0 else None}


def checkpoint_sharded2(in_dir, out_dir):
    """SHARD_GRAD_OP and FULL_SHARD, each saved sharded synchronously and
    asynchronously; and an async save without `sharded` refused."""
    rank = int(os.environ["RANK"])
    out = {}
    for strategy in ("SHARD_GRAD_OP", "FULL_SHARD"):
        for mode in ("sync", "async"):
            out[strategy, mode] = sharded_checkpoint_run(out_dir, strategy, mode)
    acc = _accelerator("FULL_SHARD", min_num_params=1)
    model = odd_mlp(0)
    acc.prepare(model, _adamw(model.module))
    try:
        acc.save_state(os.path.join(out_dir, "refused"), async_save=True, sharded=False)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ------------------------------------------------------------------ fp8 across processes
FP8_STEPS = 3


def fp8_steps(acc, model, batches):
    """`FP8_STEPS` fused fp8 AdamW steps (clip 1.0) of `model` under `acc`
    on `batches`: per step the loss, every scale `quantize_fp8` took, in
    call order, as (format, scale) (e4m3: a forward's x and w; e5m2: a
    backward's g), the fp8 product counts and the amax all-reduces."""
    from accelerate_tpu_torch.ops import fp8

    pmodel, popt = acc.prepare(model, _adamw(model))
    step = acc.train_step(max_grad_norm=1.0)
    real = fp8.quantize_fp8
    scales = []

    def recording(x, dtype=fp8.E4M3, group=None):
        q, s = real(x, dtype, group)
        scales[-1].append((str(dtype).split("_")[-1], s.item()))
        return q, s

    fp8.quantize_fp8 = recording
    out = {"losses": [], "scales": [], "products": [], "reduces": []}
    try:
        for batch in batches:
            fp8.reset_product_counts()
            scales.append([])
            out["losses"].append(step(_tensors(batch)).item())
            out["products"].append(dict(fp8.PRODUCTS))
            out["reduces"].append(dict(fp8.AMAX_REDUCES))
    finally:
        fp8.quantize_fp8 = real
    out["scales"] = scales
    return out


def fp8_train(inputs, strategy, remat=None):
    """llama_tiny's fp8 `train_step` under `strategy` on this process's
    share of each global batch."""
    from accelerate_tpu_torch.utils.dataclasses import CompilationConfig

    rank = int(os.environ["RANK"])
    acc = _accelerator(strategy, mixed_precision="fp8", compilation_config=CompilationConfig(remat_policy=remat))
    model = _llama(inputs["llama_cfg"], inputs["sd"])
    return fp8_steps(acc, model, inputs["local_batches"][rank])


def fp8_delayed(inputs):
    """The delayed recipe across the processes: llama_tiny's histories
    rolled by two forwards under ``fp8_autocast(recipe, update_meta=True)``,
    and one explicit `fp8_matmul_delayed` product's rolled x, w and g
    histories, each process on its share of the rows."""
    import torch.distributed as dist

    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.utils import FP8RecipeKwargs

    rank = int(os.environ["RANK"])
    recipe = FP8RecipeKwargs(scaling="delayed", amax_history_len=4)
    model = _llama(inputs["llama_cfg"], inputs["sd"])
    for batch in inputs["local_batches"][rank][:2]:
        with fp8.fp8_autocast(recipe, update_meta=True, group=dist.group.WORLD):
            loss = model.loss_fn(_tensors(batch), model)
        loss.backward()
    histories = {name: {k: v.clone() for k, v in m.fp8_meta.items()}
                 for name, m in model.named_modules() if hasattr(m, "fp8_meta")}
    x, w = (torch.as_tensor(a) for a in inputs["delayed_xw"])
    n = x.shape[0] // int(os.environ["WORLD_SIZE"])
    x = x[rank * n:(rank + 1) * n].requires_grad_()
    meta = {k: v.requires_grad_() for k, v in fp8.init_fp8_meta(4).items()}
    out = fp8.fp8_matmul_delayed(x, w, meta, group=dist.group.WORLD)
    rolled = torch.autograd.grad(torch.sum(out ** 2), list(meta.values()))
    return {"histories": histories, "rolled": dict(zip(meta, rolled))}


def fp8_world2(in_dir, out_dir):
    """Every scenario of `tests/test_torch_fp8_distributed.py`, in order."""
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    out = {}
    for remat in (None, "full"):
        for strategy in ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD"):
            out[strategy, remat] = fp8_train(inputs, strategy, remat)
    out["delayed"] = fp8_delayed(inputs)
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


# ------------------------------------------------------------------ tensor parallel
TP_VARIANTS = {
    "paged": {"page_size": 4},
    "contiguous": {"paged": False},
    "paged-spec": {"page_size": 4, "speculative": True, "draft_tokens": 3},
    "contiguous-spec": {"paged": False, "speculative": True, "draft_tokens": 3},
    "int8kv": {"page_size": 4, "kv_cache_dtype": "int8"},
    "int8kv-spec": {"page_size": 4, "kv_cache_dtype": "int8", "speculative": True, "draft_tokens": 3},
    "int8w": {"page_size": 4, "weight_dtype": "int8"},
}


def tp_requests(n=4, max_new=8, first_id=0, **kw):
    """JAX's `tests/test_tensor_parallel.py` requests."""
    from accelerate_tpu_torch.serving import Request

    return [Request(first_id + i, list(range(3 + i, 10 + i)) + [2, 5, 2, 5], max_new_tokens=max_new, **kw)
            for i in range(n)]


#: The families of `tests/test_torch_tp_families.py`: {key: (module of
#: `accelerate_tpu_torch.models`, its factory)}.
TP_FAMILIES = {"gptj": ("gptj", "create_gptj_model"), "opt": ("opt", "create_opt_model"),
               "t5": ("t5", "create_t5_model"), "t5_v1_0": ("t5", "create_t5_model"),
               "bert": ("bert", "create_bert_model")}


def tp_model(inputs, family):
    import importlib

    from accelerate_tpu_torch.models import gpt_neox, llama

    if family in TP_FAMILIES:
        module, factory = TP_FAMILIES[family]
        make = getattr(importlib.import_module(f"accelerate_tpu_torch.models.{module}"), factory)
    else:
        make = {"llama": llama.create_llama_model, "tied": llama.create_llama_model,
                "gpt_neox": gpt_neox.create_gpt_neox_model}[family]
    model = make(inputs["cfgs"][family], device="cpu")
    model.load_state_dict(inputs["sds"][family])
    return model


def tp_engine_runs(inputs, tp):
    """Every variant of JAX's matrix (and int8 weights) for both families
    through `ContinuousBatcher(tp=tp)`: tokens, collectives and bytes."""
    from accelerate_tpu_torch.parallel import tensor
    from accelerate_tpu_torch.serving import ContinuousBatcher

    out = {}
    for family in ("llama", "gpt_neox"):
        model = tp_model(inputs, family)
        for name, variant in TP_VARIANTS.items():
            tensor.reset_collectives()
            engine = ContinuousBatcher(model, num_slots=2, chunk_size=4, tp=tp, device="cpu", **variant)
            tokens = engine.run(tp_requests())
            out[family, name] = {
                "tokens": {rid: [int(t) for t in ts] for rid, ts in tokens.items()},
                "collectives": dict(tensor.COLLECTIVES),
                "bytes": (engine.per_device_weight_nbytes, engine.per_device_kv_cache_nbytes),
                "report": engine.tp_sharding_report(),
            }
    return out


#: Rules lists that force each placement form of `parallel.tensor.shard_module`
#: on Llama (`tests/test_torch_tensor_parallel.py`, `tests/test_torch_tp_training.py`):
#: the head and the MLP's up projection column-parallel loners (gathered); the
#: head and attention's output row-parallel loners (their inputs split); a head
#: alone split, every chain whole (the engine's attention over its rank's heads).
TP_FORMS = {
    "loner_column": [(r"lm_head/kernel", (None, "model")), (r"w_up/kernel", (None, "model"))],
    "loner_row": [(r"lm_head/kernel", ("model", None)), (r"wo/kernel", ("model", None))],
    "replicated_chain": [(r"lm_head/kernel", (None, "model"))],
}


def _engine_run(model, tp, **kw):
    """One `ContinuousBatcher` run of `tp_requests`: tokens, collectives, rules."""
    from accelerate_tpu_torch.parallel import tensor
    from accelerate_tpu_torch.serving import ContinuousBatcher

    tensor.reset_collectives()
    engine = ContinuousBatcher(model, num_slots=2, chunk_size=4, page_size=4, tp=tp, device="cpu", **kw)
    tokens = engine.run(tp_requests())
    plan = engine.sharding_plan
    return {"tokens": {rid: [int(t) for t in ts] for rid, ts in tokens.items()},
            "collectives": dict(tensor.COLLECTIVES), "rules": list(engine._tp_rules),
            "measured_s": None if plan is None else plan.measured_step_s,
            "candidates": None if engine.sharding_candidates is None else
            [(list(p.rules), seconds) for p, seconds in engine.sharding_candidates],
            "bytes": (engine.per_device_weight_nbytes, engine.per_device_kv_cache_nbytes),
            "predicted": None if plan is None else (plan.cost.per_chip_param_bytes, plan.cost.per_chip_kv_bytes)}


def tp_planned_runs(inputs, tp):
    """`sharding_rules="auto"` engines (both families; Llama also refined
    over the top 2 plans and tied to its embedding), and each forced form
    on Llama, at `tp`."""
    out = {}
    for family in ("llama", "gpt_neox"):
        if family in inputs["cfgs"]:
            out["auto", family] = _engine_run(tp_model(inputs, family), tp, sharding_rules="auto")
    if "llama" in inputs["cfgs"]:
        model = tp_model(inputs, "llama")
        out["refine", "llama"] = _engine_run(model, tp, sharding_rules="auto", sharding_refine_top_k=2)
        for name, rules in TP_FORMS.items():
            out[name, "llama"] = _engine_run(model, tp, sharding_rules=rules)
        out["auto", "tied"] = _engine_run(tp_model(inputs, "tied"), tp, sharding_rules="auto")
    return out


def tp_deadlines(inputs):
    """Rank 1 sleeps past every request's deadline after the first step,
    rank 0 does not: the engine's one clock-based decision must still be
    the same on both (a request expires on every rank or none)."""
    import torch.distributed as dist

    from accelerate_tpu_torch.parallel import tensor
    from accelerate_tpu_torch.serving import ContinuousBatcher

    engine = ContinuousBatcher(tp_model(inputs, "llama"), num_slots=2, chunk_size=2, page_size=4, tp=2,
                               device="cpu")
    tensor.reset_collectives()
    for r in tp_requests(max_new=32, first_id=100, deadline_s=0.4):
        engine.submit(r)
    engine.step()
    if dist.get_rank() == 1:
        time.sleep(0.6)
    while engine.pending:
        engine.step()
    return {"finish": {rid: (r.finish_reason, list(r.tokens)) for rid, r in engine.results.items()},
            "collectives": dict(tensor.COLLECTIVES)}


def tp_serving2(in_dir, out_dir):
    """Every scenario of `tests/test_torch_tensor_parallel.py`, in order."""
    from accelerate_tpu_torch.state import PartialState

    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    PartialState(cpu=True)
    out = {"tp2": tp_engine_runs(inputs, 2), "deadlines": tp_deadlines(inputs), "planned": tp_planned_runs(inputs, 2)}
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


def tp_train(inputs, family, remat=None, parallelism=None, batches=None, save_dir=None, load_dir=None,
             after_save=None, sharding_rules=None):
    """`train_step` (clip 1.0, AdamW) of `family`'s tiny model over a
    "model" axis: each rank takes its data shard of every global batch
    (the "model" ranks of one shard the same rows); the pre-clip norms and,
    on rank 0, the gathered weights. `load_dir` resumes before the steps;
    `save_dir` saves after them, then `after_save` more batches run.
    `sharding_rules` (a list or ``"auto"``) replaces the family's table; the
    report then carries the resolved tables and this rank's moment bytes
    and data-sharded moments."""
    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator, CompilationConfig
    from accelerate_tpu_torch.parallel.mesh import mesh_sizes

    _reset()
    acc = Accelerator(cpu=True, parallelism_config=parallelism,
                      compilation_config=CompilationConfig(remat_policy=remat))
    model = tp_model(inputs, family)
    if sharding_rules is not None:
        model.sharding_rules = sharding_rules
    full_numel = sum(p.numel() for p in model.parameters())
    moved = []
    move = model.to

    def recording_to(*args, **kwargs):  # what `prepare` hands to the device
        moved.append(sum(p.numel() for p in model.parameters()))
        return move(*args, **kwargs)

    model.to = recording_to
    pmodel, popt = acc.prepare(model, _adamw(model))
    del model.to
    norms = []
    clip = popt.clip_grad_norm_
    popt.clip_grad_norm_ = lambda max_norm: norms.append(float(clip(max_norm))) or norms[-1]
    step = acc.train_step(max_grad_norm=1.0)
    sizes = mesh_sizes(acc.mesh)
    dp = sizes["data"] * sizes["fsdp"]
    index = dist.get_rank() // sizes["model"]

    def mine(batch):
        n = len(batch["input_ids"]) // dp
        return {k: torch.as_tensor(v[index * n:(index + 1) * n]) for k, v in batch.items()}

    if load_dir is not None:
        acc.load_state(load_dir)
    losses = [float(step(mine(b))) for b in (batches if batches is not None else inputs["batches"])]
    out = {"losses": losses, "norms": norms, "mesh": sizes, "moved_numel": moved, "full_numel": full_numel,
           "rank_numel": sum(p.numel() for p in pmodel.module.parameters())}
    if sharding_rules is not None:
        state = popt.optimizer.state
        out.update(rules=list(pmodel.sharding_rules or []), opt_rules=list(pmodel.opt_sharding_rules or []),
                   moment_bytes=sum(t.numel() * t.element_size() for entry in state.values() for t in entry.values()
                                    if torch.is_tensor(t) and t.dim() > 0),
                   param_bytes=sum(p.numel() * p.element_size() for p in pmodel.module.parameters()),
                   data_sharded={n: d for n, d in pmodel.layout.opt_dims.items() if d is not None}
                   if pmodel.layout.zero_axis == "data" else {})
    if save_dir is not None:
        acc.save_state(save_dir)
        out["after_save"] = [float(step(mine(b))) for b in after_save]
    weights = pmodel.full_state_dict()
    out["weights"] = weights if dist.get_rank() == 0 else None
    out["weights_digest"] = float(sum(v.double().sum() for v in weights.values()))
    _reset()
    return out


def tp_refusals(inputs):
    """The refusals over a "model" axis at world 2: FSDP's sharding
    strategies, fp8 and Mixtral (no tensor-parallel forward before expert
    sharding)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import mixtral
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig

    out = {}
    cases = {
        "full_shard": (dict(fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD")), "llama"),
        "shard_grad_op": (dict(fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="SHARD_GRAD_OP")), "llama"),
        "fp8": (dict(mixed_precision="fp8"), "llama"),
        "mixtral": ({}, "mixtral"),
    }
    for name, (kwargs, family) in cases.items():
        _reset()
        acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(model=2), **kwargs)
        model = (mixtral.create_mixtral_model(mixtral.mixtral_tiny(), device="cpu") if family == "mixtral"
                 else tp_model(inputs, family))
        try:
            acc.prepare(model, _adamw(model))
            out[name] = "no-error"
        except NotImplementedError as exc:
            out[name] = str(exc)
    _reset()
    return out


def tp_train2(in_dir, out_dir):
    """Every world-2 scenario of `tests/test_torch_tp_training.py`, in a
    world launched by ``accelerate-tpu-torch launch --mesh_model 2``: the
    "model" size comes from the launcher's variable."""
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    out = {}
    for family in ("llama", "gpt_neox"):
        for remat in (None, "full"):
            out[family, remat] = tp_train(inputs, family, remat)
    head, tail = inputs["batches"][:2], inputs["batches"][2:]
    out["save"] = tp_train(inputs, "llama", batches=head, save_dir=os.path.join(out_dir, "ckpt_model2"),
                           after_save=tail)
    out["load"] = tp_train(inputs, "llama", batches=tail, load_dir=inputs["ckpt_model1"])
    out["refusals"] = tp_refusals(inputs)
    out["means_after"] = mean_scopes()
    for family in ("llama", "gpt_neox"):
        out["auto", family] = tp_train(inputs, family, sharding_rules="auto")
    for name in ("loner_column", "loner_row"):
        out[name] = tp_train(inputs, "llama", sharding_rules=TP_FORMS[name])
    out["gather"] = gather_scopes(inputs)
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


def gather_scopes(inputs, parallelism=None, save_dir=None):
    """The `Accelerator`'s `gather`, `gather_for_metrics`, `reduce` and
    `pad_across_processes` of each rank's data shard of the first global
    batch over a "model" axis: the rows of each data shard once, as JAX's
    one controller holds them (the "model" ranks of a shard hold the same
    rows). What needs every process keeps every process there: the
    module-level `ops.gather` (and with `group=` the data ranks), a trigger
    that rank 0 alone raises, and the RNG streams a save writes, one file
    per process (`save_dir`; each rank's Python stream seeded by its rank,
    and its state returned)."""
    import random

    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.parallel.mesh import data_parallel_group, mesh_sizes
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    _reset()
    acc = Accelerator(cpu=True, parallelism_config=parallelism or ParallelismConfig(model=2))
    sizes = mesh_sizes(acc.mesh)
    dp = sizes["data"] * sizes["fsdp"]
    index = dist.get_rank() // sizes["model"]
    rows = torch.as_tensor(inputs["batches"][0]["input_ids"])
    n = len(rows) // dp
    mine = rows[index * n:(index + 1) * n]
    out = {"mine": mine, "gather": acc.gather(mine), "metrics": acc.gather_for_metrics(mine),
           "objects": acc.gather_for_metrics([int(index)], use_gather_object=True),
           "ops_gather": ops.gather(mine), "ops_gather_data": ops.gather(mine, group=data_parallel_group(acc.mesh)),
           "reduce": float(acc.reduce(torch.tensor([1.0]), "sum")),
           "padded": tuple(acc.pad_across_processes(mine).shape)}
    # After the gathers, which built the mesh (as `prepare` does).
    if dist.get_rank() == 0:
        acc.set_trigger()
    out["trigger"] = [acc.check_trigger(), acc.check_trigger()]
    if save_dir is not None:
        random.seed(1000 + dist.get_rank())
        out["python_rng"] = random.getstate()
        acc.save_state(save_dir)
    _reset()
    return out


def mean_scopes():
    """`global_mean` of each rank's index after the model=2 runs: outside
    any scope over every process, inside the "data" group of a model=2
    mesh over that group alone (each rank its own data shard here)."""
    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.ops.losses import batch_group, global_mean
    from accelerate_tpu_torch.parallel.mesh import data_parallel_group
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    value = torch.tensor([float(dist.get_rank())])
    out = {"outside": float(global_mean(value))}
    _reset()
    mesh = Accelerator(cpu=True, parallelism_config=ParallelismConfig(model=2)).mesh
    with batch_group(data_parallel_group(mesh)):
        out["model2_data_group"] = float(global_mean(value))
    out["after_scope"] = float(global_mean(value))
    _reset()
    return out


def tp_train4(in_dir, out_dir):
    """data 2 x model 2 at world 4; then "model" with "fsdp" refused."""
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    from accelerate_tpu_torch.state import PartialState

    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    out = {}
    for family in ("llama", "gpt_neox"):
        out[family] = tp_train(inputs, family, parallelism=ParallelismConfig(data=2, model=2))
    head, tail = inputs["batches"][:2], inputs["batches"][2:]
    # Llama saves after two steps (the whole tree, at data 2 x model 2) and
    # takes the third; the test loads it at one process.
    out["auto", "llama"] = tp_train(inputs, "llama", parallelism=ParallelismConfig(data=2, model=2),
                                    sharding_rules="auto", batches=head,
                                    save_dir=os.path.join(out_dir, "ckpt_auto"), after_save=tail)
    out["auto", "gpt_neox"] = tp_train(inputs, "gpt_neox", parallelism=ParallelismConfig(data=2, model=2),
                                       sharding_rules="auto")
    out["gather"] = gather_scopes(inputs, ParallelismConfig(data=2, model=2),
                                  save_dir=os.path.join(out_dir, "ckpt_rng"))
    # GPT-NeoX served at tp=4 (by its table and planned); the world is the engine's group.
    _reset()
    PartialState(cpu=True)
    out["serve4"] = {"hand": _engine_run(tp_model(inputs, "gpt_neox"), 4),
                     "auto": _engine_run(tp_model(inputs, "gpt_neox"), 4, sharding_rules="auto")}
    _reset()
    try:
        from accelerate_tpu_torch import Accelerator

        Accelerator(cpu=True, parallelism_config=ParallelismConfig(fsdp=2, model=2)).mesh
        out["model_with_fsdp"] = "no-error"
    except NotImplementedError as exc:
        out["model_with_fsdp"] = str(exc)
    _reset()
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


# ------------------------------------------------------------------ tensor parallel, the other families
def tp_family_logits(inputs, family):
    """`family`'s logits on the first rows of its first batch, split over
    the default group (every process one "model" rank) by its table: the
    tied heads of OPT and T5 v1.0 through the split embedding."""
    from accelerate_tpu_torch.parallel.tensor import TPGroup, tensor_parallel_copy

    model = tp_model(inputs, family)
    split = tensor_parallel_copy(model, model.sharding_rules, TPGroup())
    batch = {k: torch.as_tensor(v[:2]) for k, v in inputs["batches"][family][0].items()}
    with torch.no_grad():
        if "decoder_input_ids" in batch:
            return split(batch["input_ids"], batch["decoder_input_ids"])
        return split(batch["input_ids"])


def tp_bert_layout(inputs):
    """BERT split at model=2 by `prepare`, before any step: this rank's
    layer-0 `qkv` weight and bias, and the whole tree gathered back."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    _reset()
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(model=2))
    model = tp_model(inputs, "bert")
    pmodel = acc.prepare(model)
    qkv = pmodel.module.bert.layers[0].attention.qkv
    out = {"weight": qkv.weight.detach().clone(), "bias": qkv.bias.detach().clone(),
           "whole": pmodel.full_state_dict(), "dims": dict(pmodel.layout.tp_dims)}
    _reset()
    return out


def tp_indivisible_refusal(inputs, parallelism):
    """`prepare` of BERT at a vocab `parallelism`'s "model" size does not
    divide: the error's text."""
    import dataclasses

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import bert

    _reset()
    acc = Accelerator(cpu=True, parallelism_config=parallelism)
    model = bert.create_bert_model(dataclasses.replace(inputs["cfgs"]["bert"], vocab_size=inputs["odd_vocab"]),
                                   device="cpu")
    try:
        acc.prepare(model, _adamw(model))
        return "no-error"
    except ValueError as exc:
        return str(exc)
    finally:
        _reset()


def tp_families2(in_dir, out_dir):
    """Every world-2 scenario of `tests/test_torch_tp_families.py`, in a
    world launched by ``accelerate-tpu-torch launch --mesh_model 2``: each
    family by its table and under the planner, BERT saved at model=2 and
    loaded from model=1, T5 with its attention whole, the tied heads'
    logits and BERT's split `qkv`."""
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    out = {}
    for family in TP_FAMILIES:
        batches = inputs["batches"][family]
        out[family] = tp_train(inputs, family, batches=batches)
        out["auto", family] = tp_train(inputs, family, batches=batches, sharding_rules="auto")
    head, tail = inputs["batches"]["bert"][:2], inputs["batches"]["bert"][2:]
    out["save"] = tp_train(inputs, "bert", batches=head, save_dir=os.path.join(out_dir, "ckpt_model2"),
                           after_save=tail)
    out["load"] = tp_train(inputs, "bert", batches=tail, load_dir=inputs["ckpt_model1"])
    out["whole_attention", "t5"] = tp_train(inputs, "t5", batches=inputs["batches"]["t5"],
                                            sharding_rules=inputs["whole_attention"])
    out["logits"] = {family: tp_family_logits(inputs, family) for family in ("opt", "t5_v1_0")}
    out["bert_layout"] = tp_bert_layout(inputs)
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))


def tp_families4(in_dir, out_dir):
    """data 2 x model 2 at world 4: each family by its table and under the
    planner (its ZeRO moments over "data"); then BERT's vocab at model=4."""
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    mesh = ParallelismConfig(data=2, model=2)
    out = {}
    for family in TP_FAMILIES:
        batches = inputs["batches"][family]
        out[family] = tp_train(inputs, family, parallelism=mesh, batches=batches)
        out["auto", family] = tp_train(inputs, family, parallelism=mesh, batches=batches, sharding_rules="auto")
    out["indivisible"] = tp_indivisible_refusal(inputs, ParallelismConfig(model=4))
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))
