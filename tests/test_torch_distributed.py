"""The port's multi-process training path at world 2, over gloo on the
CPU, held to the JAX package on the global batch.

One `debug_launcher` run per file: a module-scoped fixture writes the
inputs (carried-across weights, the global batches and each process's share
of them), spawns two processes that run every scenario of
`tests/_torch_dist_workers.py:world2` in turn, and reads back what each
process saw; each test below then checks one scenario. JAX runs here, in
this process, on its 8-device CPU mesh, on the global batch.

Tolerances:
  - f32 losses, port at world 2 against JAX's `train_step` on the global
    batch: rtol 1e-5 (the same f32 operations; the sums over the global
    batch run in another order, split across two processes).
  - Gathered weights after 3 AdamW steps, against JAX's and against the
    port's own one-process run on the same global batches: rtol 1e-4,
    atol 1e-6 on all but at most one element in 10^4, and every element
    within 2 * lr * steps. Adam's normalised update turns a gradient within
    f32 rounding of zero into a step of up to the learning rate in either
    direction, so any two f32 implementations part there: the one-process
    port differs from JAX on 2 of 82,176 elements without accumulation (up
    to 1.6e-5, `layers.1.attention.wq.weight`), and the world-2 run from
    the one-process run on 1 (2.1e-6). A wrong shard or a stale one would
    move thousands.
  - The processes agree bit for bit on every loss (one all-reduce gives
    every process the same global value) and on the gathered weights.
  - Losses with unequal valid counts, port against `jax.value_and_grad` of
    the family's loss on the global batch: rtol 1e-5 for the loss; each
    gradient tensor at rtol 1e-4 plus an atol of 1e-5 of its largest
    magnitude (the f32 sums' rounding scales with the terms summed; the
    one-process port differs from JAX by up to 9e-6 on T5's embedding
    gradient, whose largest entry is 1.27).
  - fp16: the skip pattern and the scale exactly JAX's; losses at the
    tolerance of the port's one-process fp16 tests against JAX (atol 1e-2).
  - A checkpoint resumed at world 2: losses within rtol 1e-6 of the run
    that was not cut (they are equal here); loaded at world 1: weights
    bit for bit.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models import bert as jax_bert  # noqa: E402
from accelerate_tpu.models import llama as jax_llama  # noqa: E402
from accelerate_tpu.models import resnet as jax_resnet  # noqa: E402
from accelerate_tpu.models import t5 as jax_t5  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState  # noqa: E402
from accelerate_tpu.state import GradientState as JaxGradientState  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.models import bert, llama, resnet, t5  # noqa: E402
from accelerate_tpu_torch.parallel import sharding  # noqa: E402
from accelerate_tpu_torch.state import AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin  # noqa: E402

WORLD = 2
SEQ = 16
GLOBAL_BATCH = 8
POISON = 7  # the token whose embedding row overflows fp16
LOSS = dict(rtol=1e-5, atol=0)
WEIGHTS = dict(rtol=1e-4, atol=1e-6)
STEPS = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _reset_jax():
    for state in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        state._reset_state()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _ids(rng, n, lo=8):
    return rng.integers(lo, 512, (n, SEQ)).astype(np.int32)


def _share(batch, rank, world=WORLD):
    """Process `rank`'s contiguous share of a global batch (JAX's data axis)."""
    n = len(next(iter(batch.values()))) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _microbatch_shares(batch, k, world=WORLD):
    """Each process's batch for `accumulation_steps=k`: its share of every
    microbatch, stacked, so that microbatch j across the processes is JAX's
    microbatch j (rows j*b to (j+1)*b of the global batch)."""
    micro = [{key: v[j * len(v) // k:(j + 1) * len(v) // k] for key, v in batch.items()} for j in range(k)]
    return [{key: np.concatenate([_share(m, r, world)[key] for m in micro]) for key in batch} for r in range(world)]


# ------------------------------------------------------------------ inputs
def _llama_inputs(rng):
    jcfg = jax_llama.llama_tiny()
    jmodel = jax_llama.create_llama_model(jcfg, seq_len=SEQ)
    params = _np(jmodel.params)
    cfg = _port_cfg(llama.LlamaConfig, jcfg)
    poisoned = jax.tree_util.tree_map(np.copy, params)
    poisoned["params"]["embed_tokens"]["embedding"][POISON] = 7e4  # above fp16's 65504
    return jmodel, params, poisoned, cfg


def _loss_inputs(rng, jmodel):
    """Per family: (JAX bundle, port config, port state dict, global batch
    whose two halves hold unequal numbers of valid rows or tokens); the
    Llama bundle is `jmodel`."""
    out = {}
    jcfg = jax_llama.llama_tiny()
    ids = _ids(rng, 8)
    labels = ids.astype(np.int64).copy()
    mask = np.ones_like(ids)
    lengths = [SEQ, SEQ, SEQ - 1, SEQ - 3, 3, 4, 2, 6]  # process 0: 60 tokens, process 1: 15
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
        labels[i, n:] = -100
    cfg = _port_cfg(llama.LlamaConfig, jcfg)
    out["llama"] = (jmodel, cfg, llama.llama_state_dict_from_flax(_np(jmodel.params), cfg),
                    {"input_ids": ids, "attention_mask": mask, "labels": labels})
    jcfg = jax_t5.t5_tiny()
    jmodel = jax_t5.create_t5_model(jcfg, seq_len=16)
    cfg = _port_cfg(t5.T5Config, jcfg)
    dec = rng.integers(0, 512, (8, 6)).astype(np.int64)
    dec[4:, 1:] = -100  # process 1's rows keep one target each
    out["t5"] = (jmodel, cfg, t5.t5_state_dict_from_flax(_np(jmodel.params), cfg),
                 {"input_ids": rng.integers(1, 512, (8, 12)).astype(np.int32),
                  "decoder_input_ids": rng.integers(1, 512, (8, 6)).astype(np.int32), "labels": dec})
    jcfg = jax_bert.bert_tiny()
    jmodel = jax_bert.create_bert_model(jcfg, seq_len=SEQ)
    cfg = bert.BertConfig(**dataclasses.asdict(jcfg))
    out["bert"] = (jmodel, cfg, bert.bert_state_dict_from_flax(_np(jmodel.params), cfg),
                   {"input_ids": rng.integers(0, 1024, (8, SEQ)).astype(np.int32),
                    "labels": rng.integers(0, 2, 8).astype(np.int64)})
    jcfg = jax_resnet.resnet_tiny()
    jmodel = jax_resnet.create_resnet_model(jcfg, image_size=16)
    out["resnet"] = (jmodel, jcfg, resnet.resnet_state_dict_from_flax(_np(jmodel.params), jcfg),
                     {"pixel_values": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                      "labels": rng.integers(0, jcfg.num_classes, 8).astype(np.int64)})
    return out


#: Rows of each process in the loss batches: unequal, so that the mean of
#: the processes' means is not the global mean.
LOSS_SPLIT = {"llama": (4, 4), "t5": (4, 4), "bert": (3, 5), "resnet": (5, 3)}


def _loss_shares(batch, family):
    first, _ = LOSS_SPLIT[family]
    return [{k: v[:first] for k, v in batch.items()}, {k: v[first:] for k, v in batch.items()}]


def _world1_checkpoint(params_sd, cfg, batches, path):
    """A one-process run: 2 fused steps, then `save_state(path)`; returns
    the weights and moments it saved."""
    _reset_port()
    acc = port.Accelerator(cpu=True)
    model = workers._llama(cfg, params_sd)
    pmodel, popt = acc.prepare(model, workers._adamw(model))
    step = acc.train_step(max_grad_norm=1.0)
    for batch in batches:
        step({k: torch.as_tensor(v) for k, v in batch.items()})
    acc.save_state(path)
    saved = ({k: v.clone() for k, v in pmodel.full_state_dict().items()}, popt.state_dict())
    _reset_port()
    return saved


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    rng = np.random.default_rng(0)
    jmodel, params, poisoned, cfg = _llama_inputs(rng)
    train = {"input_ids": _ids(rng, 3 * GLOBAL_BATCH)}
    fp16 = {"input_ids": _ids(rng, 3 * GLOBAL_BATCH)}
    fp16["input_ids"][GLOBAL_BATCH + 6, 3] = POISON  # step 2, process 1's share only
    accumulate = {"input_ids": _ids(rng, 3 * 2 * GLOBAL_BATCH)}
    ckpt = {"input_ids": _ids(rng, 6 * GLOBAL_BATCH)}
    loss_inputs = _loss_inputs(rng, jmodel)
    steps = lambda b, n: [{k: v[i * n:(i + 1) * n] for k, v in b.items()} for i in range(len(b["input_ids"]) // n)]  # noqa: E731
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    sd = llama.llama_state_dict_from_flax(params, cfg)
    w1_saved = _world1_checkpoint(sd, cfg, steps(train, GLOBAL_BATCH)[:2], str(in_dir / "ckpt_w1"))
    inputs = {
        "llama_cfg": cfg,
        "sd": sd,
        "poisoned_sd": llama.llama_state_dict_from_flax(poisoned, cfg),
        "global_batch": GLOBAL_BATCH,
        "rows": {key: [{"input_ids": r} for r in b["input_ids"]]
                 for key, b in (("train", train), ("fp16", fp16))},
        "local_batches": {
            "accumulate": [[m[r] for m in [_microbatch_shares(s, 2) for s in steps(accumulate, 2 * GLOBAL_BATCH)]]
                           for r in range(WORLD)],
            "checkpoint": [[_share(s, r) for s in steps(ckpt, GLOBAL_BATCH)] for r in range(WORLD)],
        },
        "loss_cfgs": {f: v[1] for f, v in loss_inputs.items()},
        "loss_sds": {f: v[2] for f, v in loss_inputs.items()},
        "loss_batches": {f: _loss_shares(v[3], f) for f, v in loss_inputs.items()},
        "ckpt_w1": str(in_dir / "ckpt_w1"),
    }
    torch.save(inputs, in_dir / "inputs.pt")
    debug_launcher(workers.world2, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(results=results, jmodel=jmodel, params=params, poisoned=poisoned, cfg=cfg, out_dir=out_dir,
                batches={"train": steps(train, GLOBAL_BATCH), "fp16": steps(fp16, GLOBAL_BATCH),
                         "accumulate": steps(accumulate, 2 * GLOBAL_BATCH), "checkpoint": steps(ckpt, GLOBAL_BATCH)},
                loss_inputs=loss_inputs, w1_saved=w1_saved, sd=sd)


# ------------------------------------------------------------------ JAX references
def _jax_train(world2, key, mixed_precision="no", accumulation=1):
    """JAX's fused `train_step` (clip 1.0, AdamW with decay 1e-4) over the
    global batches: (losses, skip flags, scales, port-layout weights),
    computed once per fixture."""
    cache = world2.setdefault("cache", {})
    if (key, mixed_precision, accumulation) in cache:
        return cache[key, mixed_precision, accumulation]
    _reset_jax()
    params = world2["poisoned"] if key == "fp16" else world2["params"]
    jmodel = dataclasses.replace(world2["jmodel"], params=jax.tree_util.tree_map(jnp.asarray, params))
    acc = JaxAccelerator(mixed_precision=mixed_precision)
    tx = optax.adamw(workers.LR, b1=workers.BETAS[0], b2=workers.BETAS[1], eps=workers.EPS, weight_decay=workers.WD)
    pmodel, popt = acc.prepare(jmodel, tx)
    step = acc.train_step(max_grad_norm=1.0, accumulation_steps=accumulation)
    losses, skipped, scales = [], [], []
    for batch in world2["batches"][key]:
        losses.append(float(step({k: jnp.asarray(v) for k, v in batch.items()})))
        skipped.append(bool(popt.step_was_skipped))
        scales.append(acc.scaler.scale if acc.scaler is not None else None)
    weights = llama.llama_state_dict_from_flax(_np(pmodel.params), world2["cfg"])
    _reset_jax()
    cache[key, mixed_precision, accumulation] = (losses, skipped, scales, weights)
    return cache[key, mixed_precision, accumulation]


def _port_train(world2, key, accumulation=1):
    """The port in this one process, no plugin, over the same global batches."""
    cache = world2.setdefault("cache", {})
    if ("port", key, accumulation) in cache:
        return cache["port", key, accumulation]
    _reset_port()
    acc = port.Accelerator(cpu=True)
    model = workers._llama(world2["cfg"], world2["sd"])
    pmodel, _ = acc.prepare(model, workers._adamw(model))
    step = acc.train_step(max_grad_norm=1.0, accumulation_steps=accumulation)
    losses = [float(step({k: torch.as_tensor(v) for k, v in b.items()})) for b in world2["batches"][key]]
    weights = {k: v.clone() for k, v in pmodel.module.state_dict().items()}
    _reset_port()
    cache["port", key, accumulation] = (losses, weights)
    return cache["port", key, accumulation]


def _assert_adam_weights(got, want):
    """`WEIGHTS` on all but one element in 10^4, and every element within
    the most Adam's normalised steps can part two runs."""
    assert set(got) == set(want)
    outside, total = {}, 0
    for name in want:
        g, w = got[name].numpy(), want[name].numpy()
        diff = np.abs(g - w)
        assert diff.max() <= 2 * workers.LR * STEPS, (name, diff.max())
        n = int((diff > WEIGHTS["atol"] + WEIGHTS["rtol"] * np.abs(w)).sum())
        if n:
            outside[name] = (n, float(diff.max()))
        total += w.size
    assert sum(n for n, _ in outside.values()) <= max(1, total // 10**4), outside


def _assert_ranks_agree(results, key):
    losses = [r[key]["losses"] for r in results]
    assert [[float.hex(x) for x in l] for l in losses[1:]] == [[float.hex(x) for x in losses[0]]] * (len(losses) - 1)
    assert len({r[key]["world_weights_digest"] for r in results}) == 1


# ------------------------------------------------------------------ training
STRATEGIES = [("train", "NO_SHARD"), ("train", "SHARD_GRAD_OP"), ("train", "FULL_SHARD"), ("train", "none"),
              "remat"]


@pytest.mark.parametrize("key", STRATEGIES, ids=lambda k: k if isinstance(k, str) else k[1])
def test_training_matches_jax_on_the_global_batch(world2, key):
    """llama_tiny in f32, 3 fused AdamW steps with clip 1.0, each process
    fed its share of every global batch by the prepared loader: JAX's
    losses and weights; both processes return the same loss bits."""
    jlosses, _, _, jweights = _jax_train(world2, "train")
    results = world2["results"]
    np.testing.assert_allclose(results[0][key]["losses"], jlosses, **LOSS)
    _assert_adam_weights(results[0][key]["weights"], jweights)
    _assert_adam_weights(results[0][key]["weights"], _port_train(world2, "train")[1])
    _assert_ranks_agree(results, key)


@pytest.mark.parametrize("key", ["accumulate", ("accumulate", "SHARD_GRAD_OP")], ids=["FULL_SHARD", "SHARD_GRAD_OP"])
def test_accumulation_matches_jax(world2, key):
    """`accumulation_steps=2`: the inner microbatch reduces nothing, the
    step's gradients are JAX's scan over the two global microbatches (under
    SHARD_GRAD_OP summed in the plugin's `reduce_dtype`)."""
    jlosses, _, _, jweights = _jax_train(world2, "accumulate", accumulation=2)
    results = world2["results"]
    np.testing.assert_allclose(results[0][key]["losses"], jlosses, **LOSS)
    _assert_adam_weights(results[0][key]["weights"], jweights)
    _assert_adam_weights(results[0][key]["weights"], _port_train(world2, "accumulate", 2)[1])
    _assert_ranks_agree(results, key)


def test_fp16_overflow_on_one_process_skips_on_both_like_jax(world2):
    """fp16 under FULL_SHARD: step 2's batch overflows on process 1 only
    (its share holds a token whose embedding exceeds fp16's range). The
    non-finite check is reduced over the processes, so both skip it, as
    JAX's step on the global batch does; the scale backs off alike."""
    jlosses, jskipped, jscales, jweights = _jax_train(world2, "fp16", mixed_precision="fp16")
    assert jskipped == [False, True, False]
    for result in world2["results"]:
        assert result["fp16"]["skipped"] == jskipped
        assert result["fp16"]["scales"] == jscales
    losses = world2["results"][0]["fp16"]["losses"]
    assert not np.isfinite(losses[1]) and not np.isfinite(jlosses[1])
    np.testing.assert_allclose([losses[0], losses[2]], [jlosses[0], jlosses[2]], atol=1e-2, rtol=0)
    _assert_ranks_agree(world2["results"], "fp16")


def test_prepare_applies_the_placement_table(world2):
    """FULL_SHARD: each parameter the table shards is a DTensor sharded on
    the table's dim, its local shard half the whole; the rest stay whole.
    SHARD_GRAD_OP: every parameter whole, the moments of the table's
    parameters halved on their dim. NO_SHARD: nothing halved."""
    model = port.create_named_model("llama-tiny", device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    plugin = FullyShardedDataParallelPlugin(min_num_params=1000)
    table = sharding.derive_param_placements(model, {"fsdp": WORLD}, plugin)
    assert any(d is not None for d in table.values()) and any(d is None for d in table.values())

    def halved(name, dim):
        shape = list(shapes[name])
        if dim is not None:
            shape[dim] //= WORLD
        return tuple(shape)

    for result in world2["results"]:
        full = result["train", "FULL_SHARD"]["layout"]
        for name, dim in table.items():
            is_dt, placement, local = full["params"][name]
            assert is_dt == (dim is not None), name
            assert local == halved(name, dim), name
            if dim is not None:
                assert f"Shard(dim={dim})" in placement
            assert full["moments"][name] == halved(name, dim)
        zero2 = result["train", "SHARD_GRAD_OP"]["layout"]
        for name, dim in table.items():
            assert zero2["params"][name] == (False, None, shapes[name])
            assert zero2["moments"][name] == halved(name, dim)
        plain = result["train", "NO_SHARD"]["layout"]
        assert all(plain["moments"][n] == shapes[n] for n in shapes)


def test_sync_module_states_broadcasts_process_0s_weights(world2):
    """Processes that built the model from different seeds hold process
    0's weights after `prepare` (FSDP's `sync_module_states`, JAX's
    default)."""
    rank0, rank1 = (r["sync"] for r in world2["results"])
    seed0 = workers._llama(world2["cfg"], seed=0).state_dict()
    seed1 = workers._llama(world2["cfg"], seed=1).state_dict()
    assert any(not torch.equal(seed0[n], seed1[n]) for n in seed0)
    for name in seed0:
        assert torch.equal(rank0[name], seed0[name]) and torch.equal(rank1[name], seed0[name]), name


# ------------------------------------------------------------------ losses over the global batch
def _jax_loss_and_grads(family, world2):
    jmodel, cfg, sd, batch = world2["loss_inputs"][family]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b, jmodel.apply_fn)))(jmodel.params, jbatch)
    convert = {"llama": llama.llama_state_dict_from_flax, "t5": t5.t5_state_dict_from_flax,
               "bert": bert.bert_state_dict_from_flax, "resnet": resnet.resnet_state_dict_from_flax}[family]
    return float(loss), convert(_np(grads), cfg)


def _port_local_mean(family, world2, rows):
    """The family's loss on `rows` alone, in one process."""
    _reset_port()
    _, cfg, sd, _ = world2["loss_inputs"][family]
    build = {"llama": llama.create_llama_model, "t5": t5.create_t5_model, "bert": bert.create_bert_model,
             "resnet": resnet.create_resnet_model}[family]
    model = build(cfg, device="cpu")
    model.load_state_dict(sd)
    acc = port.Accelerator(cpu=True)
    pmodel = acc.prepare(model)
    with torch.no_grad():
        value = float(pmodel.loss({k: torch.as_tensor(v) for k, v in rows.items()}))
    _reset_port()
    return value


@pytest.mark.parametrize("family", ["llama", "t5", "bert", "resnet"])
def test_losses_with_unequal_counts_match_jax(world2, family):
    """Each ported loss at world 2, the processes holding unequal numbers of
    valid tokens (decoder, T5) or rows (BERT, ResNet): JAX's value and
    gradients on the global batch, the same value on both processes."""
    jloss, jgrads = _jax_loss_and_grads(family, world2)
    results = [r["losses"][family] for r in world2["results"]]
    assert float.hex(results[0]["loss"]) == float.hex(results[1]["loss"])
    np.testing.assert_allclose(results[0]["loss"], jloss, **LOSS)
    grads = results[0]["grads"]
    assert grads
    for name, grad in grads.items():
        want = jgrads[name].numpy()
        np.testing.assert_allclose(grad.numpy(), want, err_msg=name, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("family", ["llama", "bert"])
def test_the_mean_of_the_processes_means_is_another_function(world2, family):
    """The case the global mean exists for: with unequal counts the mean of
    the two processes' own means misses JAX's loss by far more than the
    tolerance, which the port's value meets."""
    jloss, _ = _jax_loss_and_grads(family, world2)
    shares = world2["results"][0]["losses"][family]
    batch = world2["loss_inputs"][family][3]
    means = [_port_local_mean(family, world2, rows) for rows in _loss_shares(batch, family)]
    assert abs(np.mean(means) - jloss) > 100 * LOSS["rtol"] * abs(jloss)
    np.testing.assert_allclose(shares["loss"], jloss, **LOSS)


# ------------------------------------------------------------------ the process surface
def test_gather_for_metrics_returns_exactly_the_eval_set(world2):
    """27 samples in batches of 8 at world 2 (JAX's `test_launchers` case):
    the last global batch is topped up to 16 with repeats, and
    `gather_for_metrics` cuts them, for tensors and for objects."""
    for result in world2["results"]:
        got = result["gather"]
        assert len(got["gathered"]) == 27 and sorted(got["gathered"]) == list(range(27))
        assert got["remainder"] == 27 % 16
        assert len(got["objects_last"]) == 27 % 16
    assert sum(len(b) for b in world2["results"][0]["gather"]["local"]) == 16


def test_split_between_processes_nests_and_pads_like_jax(world2):
    a, b = (r["split"] for r in world2["results"])
    assert a[0] + b[0] == 16 and a[0] == a[1] and b[0] == b[1]
    assert a[2] + b[2] == list(range(16))
    assert a[3] == b[3] == 5
    assert a[4] == [0, 1, 2, 3, 4] and b[4] == [5, 6, 7, 8, 8]
    assert a[5] == b[5] == "raised"


def test_collectives_and_process_surface(world2):
    a, b = (r["collectives"] for r in world2["results"])
    for out, rank in ((a, 0), (b, 1)):
        assert out["gather"]["t"].tolist() == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
        assert out["gather"]["n"].tolist() == [0, 1]
        assert out["gather_object"] == ["r0", "r1"]
        assert out["broadcast"].tolist() == [[11.0] * 3] * 2
        assert out["broadcast_object_list"] == ["r0", 0]
        assert out["reduce_sum"].tolist() == [[3.0] * 3] * 2
        assert out["reduce_mean"].tolist() == [[3.0] * 3] * 2
        assert out["pad"].shape == (2, 2) and out["pad_first"].shape == (2, 2)
        assert out["process"] == (2, rank, rank, rank == 0, rank == 0, rank == 1, "MULTI_HOST")
        assert out["on_main"] == ("main" if rank == 0 else None)
        assert out["on_process_1"] == ("one" if rank == 1 else None)
        assert out["seed"] == 5 + rank
    assert a["pad"].tolist() == [[0.0, 0.0], [-1.0, -1.0]]
    assert a["pad_first"].tolist() == [[-1.0, -1.0], [0.0, 0.0]]


def test_trackers_write_on_the_main_process_only(world2):
    lines = (world2["out_dir"] / "trackers" / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and '"loss": 1.0' in lines[0]
    assert '"rank": 0' in (world2["out_dir"] / "trackers" / "run" / "config.json").read_text()


# ------------------------------------------------------------------ checkpoints
def test_full_shard_checkpoint_resumes_at_world_2(world2):
    for result in world2["results"]:
        ckpt = result["checkpoint"]
        np.testing.assert_allclose(ckpt["resumed"], ckpt["uncut"][3:], rtol=1e-6, atol=0)


def test_full_shard_checkpoint_loads_at_world_1(world2):
    """The checkpoint FULL_SHARD wrote at world 2 loads into a one-process
    `Accelerator` with no plugin: its weights are the gathered ones bit for
    bit, and its next step's loss is the world-2 run's."""
    ckpt = world2["results"][0]["checkpoint"]
    _reset_port()
    acc = port.Accelerator(cpu=True)
    model = workers._llama(world2["cfg"], world2["sd"])
    pmodel, popt = acc.prepare(model, workers._adamw(model))
    acc.load_state(ckpt["path"])
    for name, value in ckpt["at_save"].items():
        assert torch.equal(pmodel.module.state_dict()[name], value), name
    step = acc.train_step(max_grad_norm=1.0)
    batch = world2["batches"]["checkpoint"][3]
    loss = float(step({k: torch.as_tensor(v) for k, v in batch.items()}))
    np.testing.assert_allclose(loss, ckpt["uncut"][3], rtol=1e-5, atol=0)
    _reset_port()


def test_world_1_checkpoint_loads_under_full_shard_at_world_2(world2):
    """The other way round: a one-process checkpoint, loaded under
    FULL_SHARD at world 2 and gathered again, is bit for bit what was
    saved, moments included."""
    weights, moments = world2["w1_saved"]
    ckpt = world2["results"][0]["checkpoint"]
    for name, value in weights.items():
        assert torch.equal(ckpt["w1_weights"][name], value), name
    assert set(ckpt["w1_moments"]["state"]) == set(moments["state"])
    for index, entry in moments["state"].items():
        for key, value in entry.items():
            assert torch.equal(torch.as_tensor(ckpt["w1_moments"]["state"][index][key]), torch.as_tensor(value))


# ------------------------------------------------------------------ refusals and seams
def test_mixtral_and_fp8_refuse_more_than_one_process(world2):
    refused = world2["results"][0]["refusals"]
    assert "expert sharding" in refused["mixtral"]
    assert "global amax" in refused["fp8"]


def test_offload_and_waiting_axes_raise():
    from accelerate_tpu_torch.parallel.mesh import resolve_mesh_sizes
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    for kwargs in (dict(cpu_offload=True), dict(offload_params=True), dict(offload_optimizer_state=True),
                   dict(offload_optimizer_device="nvme")):
        with pytest.raises(NotImplementedError, match="offload"):
            FullyShardedDataParallelPlugin(**kwargs)
    for axis in ("model", "seq", "expert", "stage", "pipeline"):
        with pytest.raises(NotImplementedError, match="ROADMAP A item 3"):
            resolve_mesh_sizes(ParallelismConfig(data=1, **{axis: 2}), 2)
    assert resolve_mesh_sizes(ParallelismConfig(data=1, fsdp=-1), 4) == {"data": 1, "fsdp": 4}
    with pytest.raises(NotImplementedError, match="sharded"):
        port.Accelerator(cpu=True, sharded_save=True)


def test_importing_the_port_creates_no_process_group():
    import subprocess

    code = ("import torch.distributed as dist, accelerate_tpu_torch, accelerate_tpu_torch.launchers, "
            "accelerate_tpu_torch.parallel.fsdp; print(dist.is_initialized())")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=os.path.dirname(os.path.dirname(__file__)), timeout=120)
    assert out.stdout.strip() == "False", out.stderr


def test_env_protocol_round_trips():
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    env = {"ACCELERATE_TPU_FSDP_SHARDING_STRATEGY": "SHARD_GRAD_OP", "ACCELERATE_TPU_FSDP_MIN_NUM_PARAMS": "123",
           "ACCELERATE_TPU_FSDP_AUTO_WRAP_POLICY": "TRANSFORMER_BASED_WRAP",
           "ACCELERATE_TPU_FSDP_TRANSFORMER_CLS_TO_WRAP": "layer_, blocks_",
           "ACCELERATE_TPU_FSDP_PARAM_DTYPE": "bfloat16", "ACCELERATE_TPU_FSDP_SYNC_MODULE_STATES": "false",
           "ACCELERATE_TPU_FSDP_ACTIVATION_CHECKPOINTING": "1", "ACCELERATE_TPU_MESH_DATA": "2",
           "ACCELERATE_TPU_MESH_FSDP": "-1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        plugin = FullyShardedDataParallelPlugin()
        mesh = ParallelismConfig.from_env()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert (plugin.sharding_strategy, plugin.min_num_params, plugin.auto_wrap_policy) == (
        "SHARD_GRAD_OP", 123, "TRANSFORMER_BASED_WRAP")
    assert plugin.transformer_cls_names_to_wrap == ["layer_", "blocks_"]
    assert (plugin.param_dtype, plugin.sync_module_states, plugin.activation_checkpointing) == ("bfloat16", False, True)
    assert mesh.resolve(8)["data"] == 2 and mesh.resolve(8)["fsdp"] == 4
    assert not plugin.shards_params and plugin.shards_opt_state
