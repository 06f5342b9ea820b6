"""Worker functions for the port's multi-process tests
(`tests/test_torch_distributed.py`, `tests/test_torch_distributed_hybrid.py`,
`tests/test_torch_surface_distributed.py`).

Each runs in a process `accelerate_tpu_torch.launchers.debug_launcher`
spawns (gloo on the CPU, one torch thread), reads the inputs the test wrote
(``inputs.pt``: weights, configs, per-process batches), runs every scenario
of its file in turn, and writes what it saw into ``rank<i>.pt``. It imports
torch and the port only: the JAX references run in the test's own process.
Every scenario runs on every process in the same order (each is one
program across the processes).
"""

import os

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
    plugin_kw = {k: kwargs.pop(k) for k in ("sync_module_states", "min_num_params", "reduce_dtype", "activation_checkpointing")
                 if k in kwargs}
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
    """Mixtral and fp8 across processes raise, naming what they wait for."""
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
