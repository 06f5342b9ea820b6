"""fp8 across processes: ``Accelerator(mixed_precision="fp8")`` at world 2,
over gloo on the CPU, under NO_SHARD, SHARD_GRAD_OP and FULL_SHARD, with
and without ``remat_policy="full"``, held to the port at world 1 and to the
JAX package on the global batch. About 25 s: one `debug_launcher` spawn of
2 processes running `tests/_torch_dist_workers.py:fp8_world2`, then the
world-1 and JAX references here; 15 s more for one ``accelerate-tpu-torch
launch --cpu --num_processes 2 --mixed_precision fp8`` of a script.

JAX scales each fp8 product by the amax over the global batch (GSPMD
reduces ``jnp.max(jnp.abs(x))`` over the batch-sharded array); the port
all-reduces (max) each process's amax. The two processes' rows differ in
magnitude (process 1's tokens have embedding rows twice as large), so a
process's own amax would give another scale: the test shows that it does.
Each run takes 3 steps on one global batch of 8 rows, as
`tests/test_torch_fp8.py`'s one-process case does.

Tolerances:
  - scales: every rank's equal each other's at every step, bit for bit;
    and equal the port's at world 1 on the global batch, bit for bit, at
    the first step, where both run on the same weights. A backward's g
    scale is the world size times world 1's (exact at world 2): each
    process carries the global loss's cotangent times the process count,
    which the gradient average divides out (`ops.losses.global_mean`), so
    the fp8 values are the same.
  - losses: the ranks bit for bit (one all-reduce gives both the global
    value); against JAX's fp8 `train_step` atol 1e-2, the tolerance of
    `tests/test_torch_fp8.py` (XLA rounds its fused bf16 chains at other
    places than PyTorch's per-op kernels). Against the port at world 1 on
    the global batch: rtol 1e-5 at the first step (the same fp8 values,
    the f32 sums of the loss in another order), rtol 2e-3 after it. Each
    process rounds its own share of a weight's gradient to bf16 (the fp8
    product's output dtype) before the gradient average, where one
    process rounds the whole sum once; one bf16 rounding in a weight then
    moves a later amax by a bf16 unit, which moves every fp8 value of that
    product (world 2 against world 1 here: up to 6.4e-4 relative at the
    third step; the port at world 1 against JAX differs by up to 8.8e-3).
  - the amax all-reduces: exactly one for each forward product's x and
    one for each backward's g, so per step the forward products plus the
    dw products (a recompute's forward products reduce again).
  - the delayed recipe: every rolled history equal to world 1's, bit for
    bit (the forwards see the same weights; a max is the same in any order).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

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
from accelerate_tpu.models import llama as jax_llama  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState  # noqa: E402
from accelerate_tpu.state import GradientState as JaxGradientState  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.models import llama  # noqa: E402
from accelerate_tpu_torch.ops import fp8  # noqa: E402
from accelerate_tpu_torch.state import AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch.utils import FP8RecipeKwargs  # noqa: E402

WORLD = 2
SEQ = 16
GLOBAL_BATCH = 8
LOUD = 2.0  # process 1's embedding rows are this much larger
STRATEGIES = ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD")
REMAT = (None, "full")


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


def _share(batch, rank):
    n = len(batch["input_ids"]) // WORLD
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _world1(inputs, batches, remat=None):
    """The port at one process, no group, on `batches`."""
    _reset_port()
    acc = port.Accelerator(mixed_precision="fp8", cpu=True,
                           compilation_config=port.CompilationConfig(remat_policy=remat))
    model = llama.create_llama_model(inputs["llama_cfg"], device="cpu")
    model.load_state_dict(inputs["sd"])
    try:
        return workers.fp8_steps(acc, model, batches)
    finally:
        _reset_port()


def _jax_losses(jmodel, params, batches):
    _reset_jax()
    jmodel = dataclasses.replace(jmodel, params=jax.tree_util.tree_map(jnp.asarray, params))
    acc = JaxAccelerator(mixed_precision="fp8")
    tx = optax.adamw(workers.LR, b1=workers.BETAS[0], b2=workers.BETAS[1], eps=workers.EPS, weight_decay=workers.WD)
    acc.prepare(jmodel, tx)
    step = acc.train_step(max_grad_norm=1.0)
    losses = [float(step({k: jnp.asarray(v) for k, v in b.items()})) for b in batches]
    _reset_jax()
    return losses


def _delayed_world1(inputs, batches):
    recipe = FP8RecipeKwargs(scaling="delayed", amax_history_len=4)
    model = llama.create_llama_model(inputs["llama_cfg"], device="cpu")
    model.load_state_dict(inputs["sd"])
    for batch in batches[:2]:
        with fp8.fp8_autocast(recipe, update_meta=True):
            loss = model.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()}, model)
        loss.backward()
    histories = {name: dict(m.fp8_meta) for name, m in model.named_modules() if hasattr(m, "fp8_meta")}
    x, w = (torch.as_tensor(a) for a in inputs["delayed_xw"])
    x.requires_grad_()
    meta = {k: v.requires_grad_() for k, v in fp8.init_fp8_meta(4).items()}
    rolled = torch.autograd.grad(torch.sum(fp8.fp8_matmul_delayed(x, w, meta) ** 2), list(meta.values()))
    return {"histories": histories, "rolled": dict(zip(meta, rolled))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    jcfg = jax_llama.llama_tiny()
    jmodel = jax_llama.create_llama_model(jcfg, seq_len=SEQ)
    params = jax.tree_util.tree_map(np.array, jmodel.params)
    params["params"]["embed_tokens"]["embedding"][256:] *= LOUD
    cfg = llama.LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(llama.LlamaConfig)})
    half = GLOBAL_BATCH // 2
    batch = {"input_ids": np.concatenate([rng.integers(8, 256, (half, SEQ)),
                                          rng.integers(256, 512, (half, SEQ))]).astype(np.int32)}
    batches = [batch] * workers.FP8_STEPS
    x = rng.normal(size=(GLOBAL_BATCH, 32)).astype(np.float32)
    x[half:] *= 10.0
    inputs = {
        "llama_cfg": cfg,
        "sd": llama.llama_state_dict_from_flax(params, cfg),
        "local_batches": [[_share(b, r) for b in batches] for r in range(WORLD)],
        "delayed_xw": (x, rng.normal(size=(32, 16)).astype(np.float32)),
    }
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    torch.save(inputs, in_dir / "inputs.pt")
    debug_launcher(workers.fp8_world2, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(
        results=results,
        world1={remat: _world1(inputs, batches, remat) for remat in REMAT},
        process0_alone=_world1(inputs, [_share(b, 0) for b in batches]),
        jax=_jax_losses(jmodel, params, batches),
        delayed=_delayed_world1(inputs, batches),
        cfg=cfg,
    )


def _global_scales(step_scales):
    """A world-2 step's scales in world 1's terms: each g scale over the
    process count (exact: a power of two)."""
    return [(fmt, s / WORLD if fmt == "e5m2" else s) for fmt, s in step_scales]


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scales_are_the_global_batchs_on_every_rank(world, strategy, remat):
    runs = [r[strategy, remat] for r in world["results"]]
    reference = world["world1"][remat]
    assert runs[0]["scales"] == runs[1]["scales"]
    scales = [_global_scales(step) for step in runs[0]["scales"]]
    assert [[fmt for fmt, _ in step] for step in scales] == [[fmt for fmt, _ in step] for step in reference["scales"]]
    assert scales[0] == reference["scales"][0]
    # Process 0's rows alone would give other scales: the data tells them apart.
    assert world["process0_alone"]["scales"][0][0] != reference["scales"][0][0]


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_losses_match_world_1_and_jax(world, strategy, remat):
    runs = [r[strategy, remat] for r in world["results"]]
    assert runs[0]["losses"] == runs[1]["losses"]
    losses = runs[0]["losses"]
    world1 = world["world1"][None]["losses"]
    np.testing.assert_allclose(losses[0], world1[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(losses, world1, rtol=2e-3, atol=0)
    np.testing.assert_allclose(losses, world["jax"], rtol=0, atol=1e-2)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_amax_all_reduce_per_activation_and_gradient(world, strategy, remat):
    """Per step: the forward products' x amaxes (a recompute's again) and
    the backward's g amaxes, one all-reduce each; none at one process."""
    layers = 7 * world["cfg"].num_hidden_layers
    forward = (2 if remat else 1) * layers + 1
    for rank in world["results"]:
        run = rank[strategy, remat]
        for products, reduces in zip(run["products"], run["reduces"]):
            assert products == {"fwd": forward, "dx": layers + 1, "dw": layers + 1}
            assert reduces == {"all_reduce": products["fwd"] + products["dw"]}
    assert all(r == {"all_reduce": 0} for r in world["world1"][remat]["reduces"])


def test_delayed_histories_roll_the_global_amaxes(world):
    expect = world["delayed"]
    for rank in world["results"]:
        got = rank["delayed"]
        assert set(got["histories"]) == set(expect["histories"]) and len(expect["histories"]) == 15
        for name, meta in expect["histories"].items():
            for key, value in meta.items():
                assert torch.equal(got["histories"][name][key], value), (name, key)
        for key, value in expect["rolled"].items():
            assert torch.equal(got["rolled"][key], value), key
            assert int((value > 0).sum()) == 1


LAUNCHED = textwrap.dedent('''
    import json, os, sys
    import torch
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import fp8

    acc = Accelerator(split_batches=True)
    model = llama.create_llama_model(llama.llama_tiny(), seed=0, device="cpu")
    pmodel, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4))
    step = acc.train_step(max_grad_norm=1.0)
    rows = torch.arange(acc.process_index * 64, acc.process_index * 64 + 64).reshape(4, 16) % 512
    fp8.reset_product_counts()
    loss = step({"input_ids": rows}).item()
    with open(os.path.join(sys.argv[1], f"rank{acc.process_index}.json"), "w") as f:
        json.dump(dict(mixed_precision=acc.mixed_precision, world=acc.num_processes, loss=loss,
                       products=dict(fp8.PRODUCTS), reduces=dict(fp8.AMAX_REDUCES)), f)
''')


def test_launch_takes_fp8_with_two_processes(tmp_path):
    """``launch --cpu --num_processes 2 --mixed_precision fp8``, which JAX's
    launcher takes, runs an fp8 step on both processes: the global loss
    equal on both, one amax all-reduce per product's input and gradient."""
    from accelerate_tpu_torch.test_utils import testing

    script = tmp_path / "fp8_step.py"
    script.write_text(LAUNCHED)
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch", "--cpu",
           "--num_processes", "2", "--mixed_precision", "fp8", str(script), str(tmp_path)]
    result = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=testing.cpu_env())
    assert result.returncode == 0, result.stderr[-4000:]
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(WORLD)]
    products = 7 * 2 + 1
    for report in reports:
        assert report["mixed_precision"] == "fp8" and report["world"] == WORLD
        assert report["products"] == {"fwd": products, "dx": products, "dw": products}
        assert report["reduces"] == {"all_reduce": 2 * products}
    assert reports[0]["loss"] == reports[1]["loss"] and np.isfinite(reports[0]["loss"])
