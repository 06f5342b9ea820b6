"""Training over the mesh's "model" axis (tensor parallel), held to JAX's
`train_step` under the same `ParallelismConfig` on its 8-device CPU mesh,
under the family's tables and the planner's (`sharding_rules="auto"`, its
ZeRO moments over "data" at data 2 x model 2), with `gather_for_metrics`
over "model" and GPT-NeoX served at tp=4 at world 4.
About 85 s: two spawned worlds, one per world size: world 2 launched by
``accelerate-tpu-torch launch --cpu --num_processes 2 --mesh_model 2``
(the "model" size reaches the workers through the launcher's variable) and
world 4 at data 2 x model 2 by `debug_launcher`, each running its
scenarios of `tests/_torch_dist_workers.py` in turn; then JAX's runs, the
port at one process and the placement tables here, without a spawn.

Tolerances, those of the data-parallel tests (`tests/test_torch_distributed.py`):
  - f32 losses against JAX's `train_step` on the global batch: rtol 1e-5
    (a row-parallel output is a sum of two partial products, added in
    another order than one process adds them); the ranks bit for bit;
  - gathered weights after 3 AdamW steps against JAX's: rtol 1e-4, atol
    1e-6, on all but one element in 10^4, every element within
    2 * lr * steps (Adam's normalised step parts any two f32 runs where a
    gradient is within rounding of zero; GPT-NeoX's key biases, whose
    gradient is zero in exact arithmetic, only within that bound);
  - the pre-clip global norm, which sums each split parameter's squares
    over "model" and counts a replicated one once: rtol 1e-5 against the
    port at one process;
  - a checkpoint saved at model=2 loads at model=1, and one saved at
    model=1 loads at model=2, with the next losses within rtol 1e-5 of the
    run that saved it;
  - `prepare` hands the device only the rank's split, and the losses'
    global mean runs over the data ranks only inside the caller's
    `batch_group`: exact;
  - under the planner at data 2 x model 2, JAX's own test's bounds: losses
    within 2e-4 of the replicated run (the port at one process) and 1e-5
    of JAX's auto run on a data 2 x model 2 mesh of its devices; the
    plan's per-rank bytes within 1% of the live parameters and moments;
    the moments under 0.26 of the replicated run's (a quarter, plus the
    norms' moments, which the planner's 1024-element ZeRO floor leaves
    whole; JAX's test asks for a quarter at data 4 x model 2).
"""

import dataclasses
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
from accelerate_tpu.models import MODEL_REGISTRY as JAX_REGISTRY  # noqa: E402
from accelerate_tpu.models import get_model_family as jax_family  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.parallel.sharding import spec_for_param as jax_spec_for_param  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState  # noqa: E402
from accelerate_tpu.state import GradientState as JaxGradientState  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu.utils import CompilationConfig as JaxCompilationConfig  # noqa: E402
from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDPPlugin  # noqa: E402
from accelerate_tpu.utils import ParallelismConfig as JaxParallelismConfig  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.models import MODEL_REGISTRY, create_named_model, gpt_neox, llama  # noqa: E402
from accelerate_tpu_torch.parallel import sharding  # noqa: E402
from accelerate_tpu_torch.state import AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16
GLOBAL_BATCH = 8
STEPS = 3
LOSS = dict(rtol=1e-5, atol=0)
WEIGHTS = dict(rtol=1e-4, atol=1e-6)
FAMILIES = ("llama", "gpt_neox")


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


def _jax_models():
    from accelerate_tpu.models import gpt_neox as jax_neox
    from accelerate_tpu.models import llama as jax_llama

    return {"llama": jax_llama.create_llama_model(jax_llama.llama_tiny(), seq_len=SEQ),
            "gpt_neox": jax_neox.create_gpt_neox_model(jax_neox.gpt_neox_tiny(), seq_len=SEQ)}


def _carry(family, jmodel, params=None):
    params = _np(jmodel.params if params is None else params)
    if family == "llama":
        cfg = _port_cfg(llama.LlamaConfig, jmodel.module.config)
        return cfg, llama.llama_state_dict_from_flax(params, cfg)
    cfg = _port_cfg(gpt_neox.GPTNeoXConfig, jmodel.module.config)
    return cfg, gpt_neox.gpt_neox_state_dict_from_flax(params, cfg)


def _port_one_process(inputs, family, batches, save_dir=None, load_dir=None):
    """The port at one process, no group: losses, pre-clip norms, weights."""
    _reset_port()
    acc = port.Accelerator(cpu=True)
    model = workers.tp_model(inputs, family)
    pmodel, popt = acc.prepare(model, workers._adamw(model))
    norms, clip = [], popt.clip_grad_norm_
    popt.clip_grad_norm_ = lambda max_norm: norms.append(float(clip(max_norm))) or norms[-1]
    step = acc.train_step(max_grad_norm=1.0)
    if load_dir is not None:
        acc.load_state(load_dir)
    losses = [float(step({k: torch.as_tensor(v) for k, v in b.items()})) for b in batches]
    if save_dir is not None:
        acc.save_state(save_dir)
    weights = {k: v.clone() for k, v in pmodel.module.state_dict().items()}
    _reset_port()
    return {"losses": losses, "norms": norms, "weights": weights}


def _jax_train(family, jmodel, batches, remat=None, rules=None, mesh=None):
    """JAX's fused `train_step` under ParallelismConfig(model=2) (data 4 on
    its 8 CPU devices), or on `mesh` ({axis: size} over the first devices),
    clip 1.0, AdamW with decay 1e-4; `rules` (a list or "auto") replaces
    the bundle's table on a copy."""
    _reset_jax()
    acc = JaxAccelerator(parallelism_config=JaxParallelismConfig(model=2) if mesh is None else None,
                         compilation_config=JaxCompilationConfig(remat_policy=remat))
    if mesh is not None:
        n = int(np.prod(list(mesh.values())))
        acc.state.set_mesh(jax_build_mesh(JaxParallelismConfig(**mesh), devices=jax.devices()[:n]))
    if rules is not None:
        jmodel = dataclasses.replace(jmodel, sharding_rules=rules)
    tx = optax.adamw(workers.LR, b1=workers.BETAS[0], b2=workers.BETAS[1], eps=workers.EPS, weight_decay=workers.WD)
    pmodel, _ = acc.prepare(jmodel, tx)
    step = acc.train_step(max_grad_norm=1.0)
    losses = [float(step({k: jnp.asarray(v) for k, v in b.items()})) for b in batches]
    weights = _carry(family, jmodel, pmodel.params)[1]
    _reset_jax()
    return losses, weights


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    rng = np.random.default_rng(0)
    jmodels = _jax_models()
    inputs = {"cfgs": {}, "sds": {}}
    for family, jm in jmodels.items():
        inputs["cfgs"][family], inputs["sds"][family] = _carry(family, jm)
    inputs["batches"] = [{"input_ids": rng.integers(0, 512, (GLOBAL_BATCH, SEQ)).astype(np.int64)}
                         for _ in range(STEPS)]
    in_dir, out_dir, out4 = (tmp_path_factory.mktemp(n) for n in ("in", "out", "out4"))
    # The checkpoint the world loads at model=2: saved here, at one process.
    inputs["ckpt_model1"] = str(in_dir / "ckpt_model1")
    saved = _port_one_process(inputs, "llama", inputs["batches"][:2], save_dir=inputs["ckpt_model1"])
    resumed_here = _port_one_process(inputs, "llama", inputs["batches"][2:], load_dir=inputs["ckpt_model1"])
    torch.save(inputs, in_dir / "inputs.pt")
    script = in_dir / "tp_worker.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        import _torch_dist_workers as workers
        workers.tp_train2(sys.argv[1], sys.argv[2])
    """))
    env = dict(os.environ, PYTHONPATH=REPO)
    for key in ("ACCELERATE_TPU_MESH_MODEL", "ACCELERATE_TPU_MIXED_PRECISION"):
        env.pop(key, None)
    launched = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch", "--cpu", "--num_processes",
         "2", "--mesh_model", "2", str(script), str(in_dir), str(out_dir)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert launched.returncode == 0, launched.stdout[-3000:] + launched.stderr[-6000:]
    debug_launcher(workers.tp_train4, args=(str(in_dir), str(out4)), num_processes=4, timeout=600)
    w2 = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    w4 = [torch.load(out4 / f"rank{r}.pt", weights_only=False) for r in range(4)]
    # A world-2 checkpoint, loaded here at model=1.
    loaded_here = _port_one_process(inputs, "llama", inputs["batches"][2:], load_dir=str(out_dir / "ckpt_model2"))
    jax_runs = {family: _jax_train(family, jm, inputs["batches"]) for family, jm in jmodels.items()}
    for family, jm in jmodels.items():
        jax_runs["auto2d", family] = _jax_train(family, jm, inputs["batches"], rules="auto",
                                                mesh={"data": 2, "model": 2})
    for name in ("loner_column", "loner_row"):
        jax_runs[name] = _jax_train("llama", jmodels["llama"], inputs["batches"], rules=workers.TP_FORMS[name])
    one = {family: _port_one_process(inputs, family, inputs["batches"]) for family in FAMILIES}
    # The planned world-4 checkpoint (data 2 x model 2, moments split over "data"), loaded here at one process.
    loaded_auto = _port_one_process(inputs, "llama", inputs["batches"][2:], load_dir=str(out4 / "ckpt_auto"))
    jax_serve4 = {}
    from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
    from accelerate_tpu.serving import Request as JaxRequest

    for mode in ("rules", "auto"):
        engine = JaxBatcher(jmodels["gpt_neox"], num_slots=2, chunk_size=4, page_size=4, tp=4, sharding_rules=mode)
        reqs = [JaxRequest(r.request_id, list(r.input_ids), max_new_tokens=r.max_new_tokens) for r in workers.tp_requests()]
        jax_serve4[mode] = {rid: [int(t) for t in ts] for rid, ts in engine.run(reqs).items()}
        if mode == "auto":
            jax_serve4["rules_auto"] = engine.sharding_plan.rules
    return dict(inputs=inputs, w2=w2, w4=w4, jax=jax_runs, one=one, saved=saved, resumed_here=resumed_here,
                loaded_here=loaded_here, loaded_auto=loaded_auto, jax_serve4=jax_serve4, rng_dir=out4 / "ckpt_rng")


#: GPT-NeoX's key biases: a key bias adds the same q·b to every score of a
#: row, which the softmax cancels, so its gradient is zero in exact
#: arithmetic and rounding noise in f32; Adam's normalised step turns that
#: noise into steps of up to the learning rate, which part any two
#: implementations (JAX's and the port's at one process alike). They are
#: held to the 2 * lr * steps bound only.
ZERO_GRADIENT = ("attention.wk.bias",)


def _assert_adam_weights(got, want):
    assert set(got) == set(want)
    outside, total = {}, 0
    for name in want:
        g, w = got[name].numpy(), want[name].numpy()
        diff = np.abs(g - w)
        assert diff.max() <= 2 * workers.LR * STEPS, (name, diff.max())
        if name.endswith(ZERO_GRADIENT):
            continue
        n = int((diff > WEIGHTS["atol"] + WEIGHTS["rtol"] * np.abs(w)).sum())
        if n:
            outside[name] = (n, float(diff.max()))
        total += w.size
    assert sum(n for n, _ in outside.values()) <= max(1, total // 10**4), outside


def _runs(worlds, world, family, remat):
    return [r[family, remat] for r in worlds["w2"]] if world == 2 else [r[family] for r in worlds["w4"]]


@pytest.mark.parametrize("world,remat", ((2, None), (2, "full"), (4, None)), ids=("w2", "w2-remat", "w4"))
@pytest.mark.parametrize("family", FAMILIES)
def test_losses_hold_jax_train_step(worlds, world, family, remat):
    """model=2 at world 2 (launched), with and without `remat_policy="full"`,
    and data 2 x model 2 at world 4, clipped at 1.0: losses within rtol
    1e-5 of JAX's and bit for bit across the ranks; the mesh is the one
    asked for."""
    runs = _runs(worlds, world, family, remat)
    assert runs[0]["mesh"] == ({"data": 1, "fsdp": 1, "model": 2} if world == 2 else {"data": 2, "fsdp": 1, "model": 2})
    assert all([float.hex(x) for x in r["losses"]] == [float.hex(x) for x in runs[0]["losses"]] for r in runs)
    np.testing.assert_allclose(runs[0]["losses"], worlds["jax"][family][0], **LOSS)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("family", FAMILIES)
def test_gathered_weights_hold_jax(worlds, world, family):
    """The weights gathered whole after 3 steps: JAX's, as the data-parallel
    tests hold them, and the same on every rank."""
    runs = _runs(worlds, world, family, None)
    _assert_adam_weights(runs[0]["weights"], worlds["jax"][family][1])
    assert len({r["weights_digest"] for r in runs}) == 1


@pytest.mark.parametrize("family", FAMILIES)
def test_clip_norm_sums_splits_and_counts_replicas_once(worlds, family):
    """The pre-clip global norm at model=2 (and data 2 x model 2) equals
    the one-process norm: each split parameter's squares summed over
    "model", a replicated one (a norm's scale) counted once."""
    want = worlds["one"][family]["norms"]
    for runs in (_runs(worlds, 2, family, None), _runs(worlds, 4, family, None)):
        assert all(r["norms"] == runs[0]["norms"] for r in runs)
        np.testing.assert_allclose(runs[0]["norms"], want, rtol=1e-5)
    np.testing.assert_allclose(_runs(worlds, 2, family, "full")[0]["norms"], want, rtol=1e-5)


def test_checkpoint_at_model2_loads_at_model1_and_back(worlds):
    """`save_state` (the whole tree) at model=2 loads at model=1 with the
    same next losses; one saved at model=1 loads at model=2 the same way."""
    saved2 = worlds["w2"][0]["save"]
    np.testing.assert_allclose(worlds["loaded_here"]["losses"], saved2["after_save"], **LOSS)
    loaded2 = [r["load"] for r in worlds["w2"]]
    assert loaded2[0]["losses"] == loaded2[1]["losses"]
    np.testing.assert_allclose(loaded2[0]["losses"], worlds["resumed_here"]["losses"], **LOSS)
    np.testing.assert_allclose(worlds["saved"]["losses"] + worlds["resumed_here"]["losses"],
                               worlds["one"]["llama"]["losses"], **LOSS)


def test_refusals_name_their_bullets(worlds):
    refused = worlds["w2"][0]["refusals"]
    for case in ("full_shard", "shard_grad_op"):
        assert "tensor parallel with \"fsdp\"" in refused[case], refused[case]
    assert "fp8 with tensor parallel" in refused["fp8"]
    assert "expert sharding" in refused["mixtral"], refused["mixtral"]
    assert "tensor parallel with \"fsdp\"" in worlds["w4"][0]["model_with_fsdp"]


@pytest.mark.parametrize("family", FAMILIES)
def test_prepare_moves_only_the_split(worlds, family):
    """Over "model", `prepare` splits a model where it lies and hands only
    this rank's split to the device: a model larger than one card comes in
    on the host."""
    for run in (r[family, None] for r in worlds["w2"]):
        assert run["moved_numel"] == [run["rank_numel"]], run["moved_numel"]
        assert run["rank_numel"] < 0.6 * run["full_numel"]


def test_global_mean_group_is_the_callers_scope(worlds):
    """After the model=2 runs, `global_mean` outside a scope means over
    every process; inside `batch_group` of a model=2 mesh's data group,
    over that group (one rank each here), and the scope leaves nothing
    behind."""
    for rank, r in enumerate(worlds["w2"]):
        assert r["means_after"] == {"outside": 0.5, "model2_data_group": float(rank), "after_scope": 0.5}


def test_gloo_card_takes_local_rank_and_shares_only_on_request(monkeypatch):
    """A gloo rank on the card takes cuda:LOCAL_RANK as under NCCL; ranks
    past the card count share a card only with `share_device`."""
    from accelerate_tpu_torch import state

    monkeypatch.setattr(state.torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(state.torch.cuda, "set_device", lambda device: None)
    monkeypatch.setattr(state, "resolve_device", lambda device: torch.device(device))
    assert state.gloo_card(1) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="share_device=True"):
        state.gloo_card(2)
    assert state.gloo_card(3, share_device=True) == torch.device("cuda", 1)
    monkeypatch.setattr(state.torch.cuda, "device_count", lambda: 1)
    assert state.gloo_card(1, share_device=True) == torch.device("cuda", 0)


# ------------------------------------------------------------------ the placement table, no spawn
MESHES = (dict(data=8), dict(data=2, fsdp=2, model=2), dict(data=4, model=2))
PLUGINS = {"none": None, "full_shard": dict(sharding_strategy="FULL_SHARD", min_num_params=1000),
           "shard_grad_op": dict(sharding_strategy="SHARD_GRAD_OP", min_num_params=1000)}
TINY = sorted(name for name in MODEL_REGISTRY if "tiny" in name)


def _jax_rules(name):
    import importlib

    family = jax_family(name)[0]
    module = importlib.import_module(f"accelerate_tpu.models.{family}")
    return next(v for k, v in vars(module).items() if k.endswith("_SHARDING_RULES") and k != "EXPERT_SHARDING_RULES")


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=["data8", "d2f2m2", "d4m2"])
@pytest.mark.parametrize("plugin", sorted(PLUGINS))
def test_spec_for_param_with_rules_is_jaxs(mesh, plugin):
    """`spec_for_param` with the family's rules equals JAX's for every leaf
    of every family's tiny config, on `tests/test_state.py`'s meshes, and
    each family's table is JAX's."""
    jax_mesh = jax_build_mesh(JaxParallelismConfig(**MESHES[mesh]))
    sizes = dict(jax_mesh.shape)
    for name in TINY:
        model = create_named_model(name, device="cpu") if name in JAX_REGISTRY else None
        if model is None:
            continue
        rules = getattr(model, "sharding_rules")
        assert rules == _jax_rules(name), name
        kw = PLUGINS[plugin]
        ours_plugin = None if kw is None else FullyShardedDataParallelPlugin(**kw)
        jax_plugin = None if kw is None else JaxFSDPPlugin(**kw)
        for view in sharding.flax_view(model):
            want = tuple(jax_spec_for_param(view.path, view.flax_shape, jax_mesh, jax_plugin, rules))
            got = sharding.spec_for_param(view.path, view.flax_shape, sizes, ours_plugin, rules=rules)
            assert got == want, (name, view.path, got, want)


def test_auto_rules_are_refused_naming_the_planner():
    """The sentinel reaching `spec_for_param` unresolved raises JAX's error;
    `prepare` at one process plans it (no axis above 1: every leaf whole)
    and the bundle's "rules" sentinel is JAX's error there."""
    with pytest.raises(ValueError, match="unresolved"):
        sharding.spec_for_param("params/x/kernel", (4, 4), {"model": 2}, rules="auto")
    from accelerate_tpu_torch.modeling import Model

    _reset_port()
    acc = port.Accelerator(cpu=True)
    model = llama.create_llama_model(llama.llama_tiny(), device="cpu")
    pmodel = acc.prepare(Model(model, loss_fn=model.loss_fn, sharding_rules="auto"))
    assert pmodel.sharding_rules == [] and pmodel.opt_sharding_rules is None
    with pytest.raises(ValueError, match="serving-engine sentinel"):
        acc.prepare(Model(model, loss_fn=model.loss_fn, sharding_rules="rules"))
    _reset_port()


# ------------------------------------------------------------------ the planner's layouts in the worlds
@pytest.mark.parametrize("family", FAMILIES)
def test_auto_at_model2_trains_jaxs_losses_with_jaxs_rules(worlds, family):
    """`prepare` under ``sharding_rules="auto"`` at model=2 (world 2): the
    ranks resolve the planner's table for this mesh (JAX's plan, as
    `tests/test_torch_planner.py` holds it; the embedding split on its
    hidden dim), emit no opt table (no "data" axis), and train JAX's losses
    on the same mesh within rtol 1e-5 (a layout changes no math), bit for
    bit across the ranks."""
    from accelerate_tpu_torch.parallel.planner import Workload, default_chip, plan_sharding

    runs = [r["auto", family] for r in worlds["w2"]]
    assert all(r["losses"] == runs[0]["losses"] for r in runs) and runs[0]["opt_rules"] == []
    plan = plan_sharding(workers.tp_model(worlds["inputs"], family), {"data": 1, "fsdp": 1, "model": 2},
                         axes=("model",), chip=default_chip("cpu"),
                         workload=Workload(batch=8, seq=512, opt_bytes_per_param=8.0))
    assert [tuple(r) for r in runs[0]["rules"]] == [tuple(r) for r in plan.rules]
    assert any(spec == (None, "model") for p, spec in runs[0]["rules"] if "embed" in p)
    np.testing.assert_allclose(runs[0]["losses"], worlds["jax"][family][0], **LOSS)


@pytest.mark.parametrize("form", ("loner_column", "loner_row"))
def test_each_forced_form_trains_jaxs_losses(worlds, form):
    """Loner column layers (outputs gathered) and loner row layers (inputs
    split) in training: JAX's losses under the same rules list, rtol 1e-5."""
    runs = [r[form] for r in worlds["w2"]]
    assert runs[0]["losses"] == runs[1]["losses"]
    np.testing.assert_allclose(runs[0]["losses"], worlds["jax"][form][0], **LOSS)


@pytest.mark.parametrize("family", FAMILIES)
def test_auto_2d_trains_at_parity_with_zero_sharded_state(worlds, family):
    """JAX's `test_prepare_auto_2d_trains_at_parity_with_zero_sharded_state`
    at data 2 x model 2 (world 4): losses within JAX's 2e-4 of the
    replicated run (the port at one process) and within 1e-5 of JAX's auto
    run on the same mesh; the moments split over "data" (the plan's opt
    table), a quarter of the replicated moments plus the norms' (below the
    planner's ZeRO floor); the plan's per-rank bytes within 1% of the live
    parameters and moments."""
    from accelerate_tpu_torch.parallel.planner import Workload, default_chip, plan_sharding

    runs = [r["auto", family] for r in worlds["w4"]]
    losses = runs[0]["losses"] + runs[0].get("after_save", [])
    assert all(r["losses"] + r.get("after_save", []) == losses for r in runs)
    np.testing.assert_allclose(losses, worlds["one"][family]["losses"], rtol=2e-4, atol=0)
    np.testing.assert_allclose(losses, worlds["jax"]["auto2d", family][0], **LOSS)
    assert runs[0]["opt_rules"] and all(r["data_sharded"] for r in runs)
    model = workers.tp_model(worlds["inputs"], family)
    replicated = sum(p.numel() * 8 for p in model.parameters())
    plan = plan_sharding(model, {"data": 2, "fsdp": 1, "model": 2}, axes=("data", "model"), chip=default_chip("cpu"),
                         workload=Workload(batch=8, seq=512, opt_bytes_per_param=8.0))
    assert [tuple(r) for r in runs[0]["opt_rules"]] == [tuple(r) for r in plan.opt_rules]
    for run in runs:
        assert run["moment_bytes"] < 0.26 * replicated, (run["moment_bytes"], replicated)
        assert abs(run["moment_bytes"] - plan.cost.per_chip_opt_bytes) <= 0.01 * run["moment_bytes"]
        assert abs(run["param_bytes"] - plan.cost.per_chip_param_bytes) <= 0.01 * run["param_bytes"]


def test_a_planned_2d_checkpoint_loads_at_one_process(worlds):
    """`save_state` at data 2 x model 2 under the planner (moments split
    over "data" and "model") writes the whole tree: loaded at one process,
    the next losses are the world's, rtol 1e-5."""
    after = worlds["w4"][0]["auto", "llama"]["after_save"]
    np.testing.assert_allclose(worlds["loaded_auto"]["losses"], after, **LOSS)


def test_gpt_neox_served_at_tp4_in_world4(worlds):
    """JAX's `test_tp4_parity_across_families` and the planner at tp=4:
    GPT-NeoX (4 KV heads) by its table and planned, at world 4, equal JAX's
    engines' tokens; the four ranks hold the same rules and issue the same
    collectives."""
    runs = [r["serve4"] for r in worlds["w4"]]
    for mode, key in (("hand", "rules"), ("auto", "auto")):
        assert all(r[mode]["tokens"] == runs[0][mode]["tokens"] for r in runs)
        assert all(r[mode]["collectives"] == runs[0][mode]["collectives"] for r in runs)
        assert runs[0][mode]["tokens"] == worlds["jax_serve4"][key], mode
    assert all(r["auto"]["rules"] == [tuple(x) for x in worlds["jax_serve4"]["rules_auto"]] for r in runs)


@pytest.mark.parametrize("world", (2, 4))
def test_gather_for_metrics_returns_each_row_once(worlds, world):
    """Over a "model" axis the `Accelerator`'s `gather`, `gather_for_metrics`
    (tensors and objects), `reduce` and `pad_across_processes` run over the
    data ranks, as does `ops.gather` given their group: each data shard's
    rows come back once, in data order, as JAX's one controller holds the
    global batch (gathering over every process returned each row once per
    "model" rank)."""
    runs = [r["gather"] for r in (worlds["w2"] if world == 2 else worlds["w4"])]
    data = 1 if world == 2 else 2
    rows = torch.as_tensor(worlds["inputs"]["batches"][0]["input_ids"])
    for run in runs:
        for key in ("gather", "metrics", "ops_gather_data"):
            assert torch.equal(run[key], rows), key
        assert run["objects"] == list(range(data)) and run["reduce"] == float(data)
        assert run["padded"] == tuple(run["mine"].shape)


@pytest.mark.parametrize("world", (2, 4))
def test_process_collectives_keep_every_process_over_model(worlds, world):
    """What needs every process keeps it over a "model" axis: the
    module-level `ops.gather` without a group returns every process's rows
    in process order; a trigger that rank 0 alone raises is seen once by
    every rank (over the data ranks alone, rank 1 at model=2 would never see
    it and hang at its next collective); at data 2 x model 2 a save writes
    each process's own RNG streams into ``random_states_<process>.pt``."""
    import random

    runs = [r["gather"] for r in (worlds["w2"] if world == 2 else worlds["w4"])]
    for run in runs:
        assert torch.equal(run["ops_gather"], torch.cat([r["mine"] for r in runs]))
        assert run["trigger"] == [True, False]
    if world == 4:
        for index, run in enumerate(runs):
            saved = torch.load(worlds["rng_dir"] / f"random_states_{index}.pt", weights_only=False)
            stream = random.Random()
            stream.setstate(saved["python"])
            want = random.Random()
            want.setstate(run["python_rng"])
            assert stream.random() == want.random() == random.Random(1000 + index).random(), index
