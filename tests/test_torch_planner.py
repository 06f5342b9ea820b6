"""The cost-model planner (`accelerate_tpu_torch/parallel/planner.py`,
`commands/plan.py`), its placement forms and the ZeRO table, held to JAX's
`accelerate_tpu/parallel/planner.py` in process, without a spawn. About
50 s on one thread, most of it JAX's `eval_shape` of the registry's
full-width models and JAX's `plan` command.

What is held:
  - plan parity: `plan_sharding`, `plan_serving_sharding`,
    `plan_train_sharding` and `score_rules` give JAX's plan on the same
    shapes, dtypes and chip: the same rules and opt rules, every leaf's
    spec, opt spec and role, costs within 1e-12 relative, `describe()`
    character for character and `to_json()` equal; over Llama and GPT-NeoX
    tiny at tp 2 and 4 and the meshes data 1, 2 and 4 x model 2, and over
    every registry family's full-width config (a `meta` model against JAX's
    `eval_shape`) on "tpu-v4", "cpu-smoke" and the H100's constants;
  - JAX's pure tests (`tests/test_planner.py`, `tests/test_planner_2d.py`)
    on the port: candidate legality, `emit_rules`, the sentinel seam, the
    cost model's monotonicity and pricing, ZeRO moments where parameters
    replicate, no opt rules when serving, the small chip, `refine_plans`;
  - `search_train_meshes` ranks JAX's meshes at pipeline=1;
  - `accelerate-tpu-torch plan` prints what `accelerate-tpu plan` prints,
    text and ``--json``; a pipeline axis is refused;
  - each placement form of `parallel.tensor.shard_module` splits a tensor
    as JAX's `NamedSharding` index map of its spec does, ("model", "data")
    nested as JAX nests it, and `derive_opt_state_placements` with the
    plan's opt rules is JAX's `derive_opt_state_shardings`, leaf by leaf.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from accelerate_tpu.commands.accelerate_cli import get_command_parser as jax_parser
from accelerate_tpu.models import CREATE_BY_FAMILY as JAX_CREATE
from accelerate_tpu.models import get_model_family as jax_family
from accelerate_tpu.parallel import planner as jp
from accelerate_tpu.parallel.sharding import derive_opt_state_shardings as jax_opt_shardings
from accelerate_tpu.parallel.sharding import tree_paths_and_leaves as jax_paths
from accelerate_tpu_torch.commands.accelerate_cli import get_command_parser as port_parser
from accelerate_tpu_torch.models import MODEL_REGISTRY, MODULE_BY_CONFIG
from accelerate_tpu_torch.parallel import planner as tp
from accelerate_tpu_torch.parallel import sharding, tensor

H100 = jp.ChipSpec(**dataclasses.asdict(tp.CHIPS["h100-sxm"]))
CHIPS = {"tpu-v4": (jp.CHIPS["tpu-v4"], tp.CHIPS["tpu-v4"]), "cpu-smoke": (jp.CHIPS["cpu-smoke"], tp.CHIPS["cpu-smoke"]),
         "h100-sxm": (H100, tp.CHIPS["h100-sxm"])}
MESHES = ({"model": 2}, {"data": 2, "model": 2}, {"data": 4, "model": 2})
FULL = ("llama-1b", "llama-3-8b", "gpt-neox-20b", "gptj-6b", "opt-30b", "mixtral-8x7b", "bert-base", "t5-small",
        "t0pp-11b")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


_SHAPES = {}


def shapes(name):
    """(JAX's f32 shape tree, the port's `meta` module in f32) of a registry name."""
    if name not in _SHAPES:
        family, config = jax_family(name)
        tree = jax.eval_shape(lambda: JAX_CREATE[family](config, seq_len=8).params)
        port_config = MODEL_REGISTRY[name]()
        with torch.device("meta"):
            module = MODULE_BY_CONFIG[type(port_config)](port_config)
        _SHAPES[name] = (tree, module)
    return _SHAPES[name]


def assert_same_plan(ours, theirs):
    assert ours.rules == theirs.rules
    assert ours.opt_rules == theirs.opt_rules
    assert [(l.path, l.shape, l.spec, l.opt_spec, l.role) for l in ours.leaves] == \
        [(l.path, l.shape, l.spec, l.opt_spec, l.role) for l in theirs.leaves]
    for field in dataclasses.fields(theirs.cost):
        a, b = getattr(ours.cost, field.name), getattr(theirs.cost, field.name)
        assert a == pytest.approx(b, rel=1e-12, abs=0), field.name
    assert ours.cost.total == pytest.approx(theirs.cost.total, rel=1e-12, abs=0)
    assert ours.describe() == theirs.describe()
    assert ours.to_json() == theirs.to_json()


def _serving_kw(config):
    length = config.max_position_embeddings
    pages = -(-length // 16)
    return dict(num_slots=8, padded_length=pages * 16, paged=True, page_size=16, num_pages=8 * pages + 1)


# ------------------------------------------------------------------ plan parity
@pytest.mark.parametrize("name", ("llama-tiny", "gpt-neox-tiny"))
@pytest.mark.parametrize("chip", sorted(CHIPS))
def test_tiny_plans_are_jaxs(name, chip):
    """Serving at tp 2 and 4 (with the pool, at every KV dtype, and with
    int8 weights), the bare search, training on each mesh, and the hand
    table's price: JAX's plan, leaf for leaf and to the last bit."""
    tree, module = shapes(name)
    jchip, pchip = CHIPS[chip]
    config = module.config
    for tp_size in (2, 4):
        mesh = {"model": tp_size}
        for kv in ("bf16", "int8", "fp8_e4m3"):
            kw = dict(_serving_kw(config), kv_cache_dtype=kv)
            assert_same_plan(tp.plan_serving_sharding(module, mesh, config, chip=pchip, **kw),
                             jp.plan_serving_sharding(tree, mesh, config, chip=jchip, **kw))
        kw = dict(_serving_kw(config), weight_dtype="int8")
        ours = tp.plan_serving_sharding(module, mesh, config, chip=pchip, top_k=3, **kw)
        theirs = jp.plan_serving_sharding(tree, mesh, config, chip=jchip, top_k=3, **kw)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_same_plan(a, b)
        assert_same_plan(tp.plan_sharding(module, mesh, chip=pchip), jp.plan_sharding(tree, mesh, chip=jchip))
        rules = list(type(module).sharding_rules)
        workload = jp.Workload(batch=8, seq=1)
        assert_same_plan(tp.score_rules(module, mesh, rules, chip=pchip, workload=tp.Workload(batch=8, seq=1)),
                         jp.score_rules(tree, mesh, rules, chip=jchip, workload=workload))
    for mesh in MESHES:
        ours = tp.plan_train_sharding(module, mesh, batch=8, seq=64, chip=pchip)
        theirs = jp.plan_train_sharding(tree, mesh, batch=8, seq=64, chip=jchip)
        assert_same_plan(ours, theirs)
        rules = list(type(module).sharding_rules)
        assert_same_plan(tp.score_rules(module, mesh, rules, chip=pchip, workload=ours.workload),
                         jp.score_rules(tree, mesh, rules, chip=jchip, workload=theirs.workload))


@pytest.mark.parametrize("name", FULL)
def test_registry_plans_are_jaxs(name):
    """Every registry family at its published widths, from a `meta` model
    (JAX's `eval_shape`), on each chip: serving at tp 2 and 4 and training
    on data 2 x model 2."""
    tree, module = shapes(name)
    for chip, (jchip, pchip) in CHIPS.items():
        for tp_size in (2, 4):
            assert_same_plan(tp.plan_sharding(module, {"model": tp_size}, chip=pchip),
                             jp.plan_sharding(tree, {"model": tp_size}, chip=jchip))
        assert_same_plan(tp.plan_train_sharding(module, {"data": 2, "model": 2}, batch=8, seq=512, chip=pchip),
                         jp.plan_train_sharding(tree, {"data": 2, "model": 2}, batch=8, seq=512, chip=jchip))


def test_embedding_split_turns_on_close_costs():
    """JAX's serving choices (the `plan` command's pool) the port must
    reproduce: Llama-1B's embedding splits on its hidden dim at tp=2 on
    "tpu-v4" (the hand table splits the vocab); on "cpu-smoke" GPT-NeoX-20B
    keeps the vocab split at tp=2 and takes the hidden split at tp=4."""
    def embedding(name, n, chip):
        tree, module = shapes(name)
        kw = dict(_serving_kw(module.config), chip=chip)
        plan = tp.plan_serving_sharding(module, {"model": n}, module.config, **kw)
        assert_same_plan(plan, jp.plan_serving_sharding(tree, {"model": n}, module.config, **kw))
        return next(l.spec for l in plan.leaves if l.path.endswith("embedding"))

    assert embedding("llama-1b", 2, "tpu-v4") == (None, "model")
    assert embedding("gpt-neox-20b", 2, "cpu-smoke") == ("model", None)
    assert embedding("gpt-neox-20b", 4, "cpu-smoke") == (None, "model")


def test_leaves_are_priced_at_their_own_dtype():
    """A bf16 module prices at two bytes a parameter, as JAX prices a bf16
    tree; the int8 pricing is JAX's."""
    tree, module = shapes("llama-tiny")
    tree16 = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape, jax.numpy.bfloat16), tree)
    with torch.device("meta"):
        module16 = type(module)(module.config).to(torch.bfloat16)
    assert_same_plan(tp.plan_sharding(module16, {"model": 2}, chip="tpu-v4"),
                     jp.plan_sharding(tree16, {"model": 2}, chip="tpu-v4"))
    p16 = tp.plan_sharding(module16, {"model": 2}, chip="tpu-v4")
    p32 = tp.plan_sharding(module, {"model": 2}, chip="tpu-v4")
    assert p16.cost.per_chip_param_bytes * 2 == p32.cost.per_chip_param_bytes


def test_default_chip_follows_the_device():
    assert tp.default_chip("cpu") is tp.CHIPS["cpu-smoke"]
    assert tp.default_chip(torch.device("cuda", 0)) is tp.CHIPS["h100-sxm"]
    assert {k: v for k, v in tp.CHIPS.items() if k != "h100-sxm"} == {
        k: tp.ChipSpec(**dataclasses.asdict(v)) for k, v in jp.CHIPS.items()}


def test_search_train_meshes_ranks_jaxs_meshes():
    """The ("data", "model") product at pipeline=1: the same meshes in the
    same order, each with JAX's plan."""
    tree, module = shapes("llama-tiny")
    theirs = jp.search_train_meshes(tree, jax.devices()[:8], batch=8, seq=64, chip="tpu-v4")
    ours = tp.search_train_meshes(module, 8, batch=8, seq=64, chip="tpu-v4")
    assert [axes for axes, _ in ours] == [axes for axes, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert_same_plan(a, b)
    with pytest.raises(NotImplementedError, match="pipelines"):
        tp.search_train_meshes(module, 8, batch=8, seq=64, layered_split=((), (), ()))
    with pytest.raises(NotImplementedError, match="pipelines"):
        tp.plan_train_sharding(module, {"data": 2, "pipeline": 2}, batch=8, seq=64)


# ------------------------------------------------------------------ JAX's pure tests
def wide_net(hidden=256, vocab=4096, inter=1024, layers=2, big_bias=False):
    """JAX's `wide_net` (`tests/test_planner.py`, `tests/test_planner_2d.py`)."""
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    params = {"embed_tokens": {"embedding": z(vocab, hidden)}}
    for i in range(layers):
        layer = {"attention": {"wq": {"kernel": z(hidden, hidden)}, "wo": {"kernel": z(hidden, hidden)}},
                 "mlp": {"w_up": {"kernel": z(hidden, inter)}, "w_down": {"kernel": z(inter, hidden)}},
                 "norm": {"scale": z(hidden)}}
        if big_bias:
            layer["big_bias"] = {"bias": z(vocab)}
        else:
            layer["attention"].update(wk={"kernel": z(hidden, hidden)}, wv={"kernel": z(hidden, hidden)})
        params[f"layer_{i}"] = layer
    params["lm_head"] = {"kernel": z(hidden, vocab)}
    return {"params": params}


def test_candidate_specs_divisibility_property():
    rng = np.random.default_rng(0)
    dims = [1, 2, 3, 4, 6, 8, 12, 16, 31, 64, 96]
    for _ in range(200):
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(rng.choice(dims)) for _ in range(ndim))
        cands = tp.candidate_specs("params/x/kernel", shape, {"model": 4}, axes=("model",))
        assert cands == jp.candidate_specs("params/x/kernel", shape, {"model": 4}, axes=("model",))
        assert () in cands
        for spec in cands:
            sharding._check_tp_divisible("params/x/kernel", shape, spec, {"model": 4})
        if ndim == 1:
            assert cands == [()]


def test_emit_rules_suffix_grouping_and_conflicts():
    import re

    assignment = {
        "params/layer_0/attention/wq/kernel": (None, "model"),
        "params/layer_1/attention/wq/kernel": (None, "model"),
        "params/layer_0/norm/scale": (),
        "params/a/odd/kernel": ("model",),
        "params/b/odd/kernel": (),
    }
    rules = tp.emit_rules(assignment)
    assert rules == jp.emit_rules(assignment)
    patterns = [p for p, _ in rules]
    assert "(^|/)wq/kernel(/|$)" in patterns and patterns[0].startswith("^params/a/odd/kernel")
    assert re.search("(^|/)wq/kernel(/|$)", "params/layer_0/attention/wq/kernel/q")
    assert tp.emit_rules(assignment, path_anchor="(^|/)") == jp.emit_rules(assignment, path_anchor="(^|/)")


def test_resolve_sharding_rules_seam():
    params = wide_net(hidden=32, vocab=64, inter=64, layers=1)
    rules, plan = tp.resolve_sharding_rules("auto", params, {"model": 2})
    assert plan is not None and rules == plan.rules and rules
    assert rules == jp.resolve_sharding_rules("auto", params, {"model": 2})[0]
    explicit = [("wq/kernel", (None, "model"))]
    assert tp.resolve_sharding_rules(explicit, params, {"model": 2}) == (explicit, None)
    assert tp.resolve_sharding_rules(None, params, {"model": 2}) == (None, None)
    assert tp.resolve_sharding_rules("rules", params, {"model": 2}) == (None, None)
    with pytest.raises(ValueError, match="auto"):
        tp.resolve_sharding_rules("magic", params, {"model": 2})
    with pytest.raises(ValueError, match="unresolved"):
        sharding.spec_for_param("params/x/kernel", (4, 4), {"model": 2}, rules="auto")


def test_cost_model_bytes_and_mesh_monotonicity():
    params = wide_net()
    total = sum(leaf.size * leaf.dtype.itemsize for _, leaf in sharding.tree_paths_and_leaves(params))
    costs = []
    for n in (1, 2, 4, 8):
        plan = tp.plan_sharding(params, {"model": n}, workload=tp.Workload(batch=4, seq=1))
        assert total / n * (1 - 1e-9) <= plan.cost.per_chip_param_bytes <= total * (1 + 1e-9)
        costs.append(plan.cost.total)
    assert all(b <= a * (1 + 1e-9) for a, b in zip(costs, costs[1:])), costs


def test_cost_model_prices_optimizer_state_and_kv_pool():
    params = wide_net(hidden=64, vocab=256, inter=128, layers=1)
    lean = tp.plan_sharding(params, {"model": 2}, workload=tp.Workload(batch=2))
    heavy = tp.plan_sharding(params, {"model": 2},
                             workload=tp.Workload(batch=2, kv_pool_bytes=1 << 20, opt_bytes_per_param=8.0))
    assert heavy.cost.per_chip_kv_bytes == (1 << 20) / 2
    assert heavy.cost.per_chip_opt_bytes > 0 == lean.cost.per_chip_opt_bytes
    assert heavy.cost.per_chip_total_bytes > lean.cost.per_chip_total_bytes


def test_zero_moments_shard_where_params_replicate():
    """JAX's ZeRO account: the big replicated bias keeps a replicated spec
    and gets a "data" moment (role zero-opt), model-sharded kernels nest
    "data" in their sharded dim, the small norms stay whole, and the opt
    rules anchor ``(^|/)``."""
    params = wide_net(big_bias=True)
    plan = tp.plan_train_sharding(params, {"data": 4, "model": 2}, batch=8, seq=128)
    assert_same_plan(plan, jp.plan_train_sharding(params, {"data": 4, "model": 2}, batch=8, seq=128))
    by_path = {l.path: l for l in plan.leaves}
    bias = by_path["params/layer_0/big_bias/bias"]
    assert (bias.spec, bias.opt_spec, bias.role) == ((), ("data",), "zero-opt")
    assert by_path["params/layer_0/norm/scale"].opt_spec == ()
    assert any(l.opt_spec and ("model", "data") in l.opt_spec for l in plan.leaves)
    replicated = sum(l.elems * 8.0 for l in tp._harvest_leaves(params))
    assert plan.cost.per_chip_opt_bytes < replicated / 4
    assert plan.opt_rules and all(p.startswith("(^|/)") for p, _ in plan.opt_rules)


def test_serving_plans_emit_no_opt_rules():
    assert not tp.Workload().is_training
    plan = tp.plan_sharding(wide_net(), {"model": 2}, axes=("model",))
    assert plan.opt_rules == [] and plan.cost.per_chip_opt_bytes == 0.0
    assert all(l.opt_spec == l.spec for l in plan.leaves)


def test_small_chip_forces_sharded_plan():
    params = wide_net(big_bias=True)
    chip = dataclasses.replace(tp.default_chip("cpu"), hbm_bytes=12e6)
    plan = tp.plan_train_sharding(params, {"data": 4, "model": 2}, batch=8, seq=128, chip=chip)
    assert plan.cost.hbm_overflow_bytes == 0.0
    assert any("model" in str(l.spec) for l in plan.leaves)
    replicated = tp.score_rules(params, {"data": 4, "model": 2}, [], chip=chip, workload=plan.workload)
    assert replicated.cost.hbm_overflow_bytes > 0.0 and plan.cost.total < replicated.cost.total
    jchip = dataclasses.replace(jp.default_chip(), hbm_bytes=12e6)
    assert_same_plan(plan, jp.plan_train_sharding(params, {"data": 4, "model": 2}, batch=8, seq=128, chip=jchip))


def test_refine_picks_measured_best_mechanics():
    params = wide_net(hidden=64, vocab=256, inter=128, layers=1)
    plans = tp.plan_sharding(params, {"model": 2}, workload=tp.Workload(batch=2), top_k=3)
    assert len(plans) >= 2
    modeled = sorted(range(len(plans)), key=lambda i: plans[i].cost.total)
    times = {id(plans[i]): float(len(plans) - rank) for rank, i in enumerate(modeled)}
    best, measured = tp.refine_plans(plans, lambda p: times[id(p)])
    assert len(measured) == len(plans) and best is plans[modeled[-1]]
    assert best.measured_step_s == min(t for _, t in measured)
    with pytest.raises(ValueError):
        tp.refine_plans([], lambda p: 0.0)


def test_measure_steps_time_real_placements_at_one_process():
    """`measure_forward_step` and `measure_train_step` on the CPU at one
    process (no group): positive seconds, and the caller's module
    untouched."""
    from accelerate_tpu_torch.models import llama

    model = llama.create_llama_model(llama.llama_tiny(), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    plan = tp.plan_sharding(model, {"model": 1})
    assert tp.measure_forward_step(model, None, plan.rules, repeats=2, device="cpu") > 0
    assert tp.measure_train_step(model, None, plan.rules, repeats=2, seq=8, device="cpu") > 0
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


# ------------------------------------------------------------------ the command
def _run(parser, argv, capsys):
    args = parser().parse_args(argv)
    args.func(args)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", (
    ["plan", "llama-tiny", "--tp", "2", "--chip", "tpu-v4"],
    ["plan", "gpt-neox-tiny", "--tp", "4", "--chip", "cpu-smoke", "--kv-cache-dtype", "int8", "--weight-dtype", "int8"],
    ["plan", "llama-tiny", "--mesh", "data=4,model=2", "--chip", "tpu-v4"],
    ["plan", "llama-1b", "--tp", "2", "--chip", "tpu-v4"],
    ["plan", "gpt-neox-20b", "--mesh", "data=2,model=4", "--chip", "tpu-v5e", "--batch", "16"],
), ids=("llama-tiny", "neox-tiny-int8", "mesh", "llama-1b", "neox-20b-mesh"))
def test_plan_command_prints_jaxs_text_and_json(argv, capsys):
    assert _run(port_parser, argv, capsys) == _run(jax_parser, argv, capsys)
    ours = json.loads(_run(port_parser, argv + ["--json"], capsys))
    theirs = json.loads(_run(jax_parser, argv + ["--json"], capsys))
    assert ours == theirs
    assert ours["plan"]["rules"] and "auto_beats_hand" in ours


def test_plan_command_refusals(capsys):
    with pytest.raises(NotImplementedError, match="pipelines"):
        _run(port_parser, ["plan", "llama-tiny", "--mesh", "data=2,model=2,pipeline=2", "--chip", "tpu-v4"], capsys)
    with pytest.raises(SystemExit, match="needs 4 devices"):
        _run(port_parser, ["plan", "llama-tiny", "--mesh", "data=2,model=2", "--live", "--cpu"], capsys)
    with pytest.raises(SystemExit, match="needs 2 devices"):
        _run(port_parser, ["plan", "llama-tiny", "--tp", "2", "--refine-top-k", "2", "--cpu"], capsys)


def test_plan_command_refines_and_lives_at_one_process(capsys):
    """``--refine-top-k`` and ``--live`` where the mesh is the one process."""
    out = json.loads(_run(port_parser, ["plan", "llama-tiny", "--tp", "1", "--refine-top-k", "1", "--cpu",
                                        "--json", "--chip", "cpu-smoke"], capsys))
    assert len(out["refine_measurements_s"]) == 1 and out["plan"]["measured_step_s"] > 0
    out = json.loads(_run(port_parser, ["plan", "llama-tiny", "--mesh", "data=1,model=1", "--live", "--cpu",
                                        "--json", "--chip", "cpu-smoke", "--seq-len", "8"], capsys))
    assert out["live"]["params"]["error_pct"] == 0.0 and out["live"]["grads"]["error_pct"] == 0.0
    assert out["live"]["opt_state"]["error_pct"] <= 1.0


# ------------------------------------------------------------------ placement forms
class _Rank:
    """The two attributes `shard_module` reads of a "model" group."""

    def __init__(self, rank, size):
        self.rank, self.size, self.group = rank, size, None

    def __deepcopy__(self, memo):
        return self


def _index_map(shape, spec, axes=("model",), sizes=(2,)):
    """JAX's per-device slices of `spec` on a mesh of `axes`, keyed by each
    device's coordinates."""
    devices = np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    mesh = Mesh(devices, axes)
    index = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(tuple(shape))
    coords = {d: c for c, d in np.ndenumerate(devices)}
    return {coords[d]: idx for d, idx in index.items()}


FORMS = {
    "vocab embedding": ([(r"embed_tokens/embedding", ("model", None))], "embed_tokens.weight", "params/embed_tokens/embedding"),
    "hidden embedding": ([(r"embed_tokens/embedding", (None, "model"))], "embed_tokens.weight", "params/embed_tokens/embedding"),
    "loner column": ([(r"lm_head/kernel", (None, "model"))], "lm_head.weight", "params/lm_head/kernel"),
    "loner row": ([(r"lm_head/kernel", ("model", None))], "lm_head.weight", "params/lm_head/kernel"),
    "chain column": ([(r"(wq|wk|wv)/kernel", (None, "model")), (r"wo/kernel", ("model", None))],
                     "layers.0.attention.wk.weight", "params/layer_0/attention/wk/kernel"),
    "chain row": ([(r"(wq|wk|wv)/kernel", (None, "model")), (r"wo/kernel", ("model", None))],
                  "layers.0.attention.wo.weight", "params/layer_0/attention/wo/kernel"),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_placement_forms_split_as_jaxs_index_map(form):
    """Each rank's split tensor (read back in flax layout) is JAX's slice of
    the whole flax leaf for that device; the layer is the form's class."""
    from accelerate_tpu_torch.models import llama

    rules, name, path = FORMS[form]
    model = llama.create_llama_model(llama.llama_tiny(), device="cpu")
    view = next(v for v in sharding.flax_view(model) if v.path == path)
    whole = dict(model.named_parameters())[name].detach().permute(*view.torch_dims)
    spec = next(s for p, s in rules if __import__("re").search(p, path))
    index = _index_map(whole.shape, spec)
    layers = []
    for rank in range(2):
        copy = tensor.tensor_parallel_copy(model, rules, _Rank(rank, 2))
        part = dict(copy.named_parameters())[name].detach().permute(*view.torch_dims)
        assert torch.equal(part, whole[index[(rank,)]]), (form, rank)
        layers.append(type(copy.get_submodule(name.rpartition(".")[0])).__name__)
    want = {"vocab embedding": "VocabParallelEmbedding", "hidden embedding": "HiddenParallelEmbedding",
            "loner column": "ColumnParallelLinear", "loner row": "RowParallelLinear",
            "chain column": "ColumnParallelLinear", "chain row": "RowParallelLinear"}[form]
    assert layers == [want, want]
    layer = copy.get_submodule(name.rpartition(".")[0])
    if form.startswith("loner"):
        assert getattr(layer, "gather_output", False) or getattr(layer, "split_input", False)
    elif form.startswith("chain"):
        assert not getattr(layer, "gather_output", False) and not getattr(layer, "split_input", False)


def test_a_replicated_chain_attends_over_its_heads_and_other_mixes_raise():
    """A table that leaves an attention block whole gives it a `HeadSplit`
    (the engine's pools hold a rank's heads); a block mixing column layers,
    a row layer and whole ones raises, naming it."""
    from accelerate_tpu_torch.models import llama

    model = llama.create_llama_model(llama.llama_tiny(), device="cpu")
    copy = tensor.tensor_parallel_copy(model, [(r"lm_head/kernel", (None, "model"))], _Rank(0, 2))
    assert all(isinstance(layer.attention.tp_heads, tensor.HeadSplit) for layer in copy.layers)
    assert not hasattr(tensor.tensor_parallel_copy(model, list(type(model).sharding_rules), _Rank(0, 2)).layers[0]
                       .attention, "tp_heads")
    with pytest.raises(NotImplementedError, match="layers.0.attention"):
        tensor.tensor_parallel_copy(model, [(r"wq/kernel", (None, "model")), (r"wo/kernel", ("model", None))],
                                    _Rank(0, 2))
    with pytest.raises(NotImplementedError, match="neither vocab- nor hidden-parallel"):
        tensor.tensor_parallel_copy(model, [(r"embed_tokens/embedding", ("model", "model"))], _Rank(0, 2))


def test_model_data_nests_as_jaxs():
    """A moment sharded over ("model", "data") on one dim: the data-th chunk
    of the rank's model chunk is JAX's slice for device (data, model) of a
    ("data", "model") mesh."""
    whole = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    index = _index_map(whole.shape, (("model", "data"), None), axes=("data", "model"), sizes=(2, 2))
    for (d, m), idx in index.items():
        local = whole.chunk(2, dim=0)[m].chunk(2, dim=0)[d]
        assert torch.equal(local, whole[idx]), (d, m)


@pytest.mark.parametrize("name", ("llama-tiny", "gpt-neox-tiny"))
def test_opt_placements_with_opt_rules_are_jaxs(name):
    """`derive_opt_state_placements(opt_rules=plan.opt_rules)` against JAX's
    `derive_opt_state_shardings` over optax adam's state on the same plan,
    on a data 2 x model 2 mesh: the dim each moment shards over "data".
    Without the table the moments follow the plugin as before."""
    tree, _ = shapes(name)
    port_config = MODEL_REGISTRY[name]()
    module = MODULE_BY_CONFIG[type(port_config)](port_config)
    mesh_sizes = {"data": 2, "fsdp": 1, "model": 2}
    plan = jp.plan_train_sharding(tree, {"data": 2, "model": 2}, batch=8, seq=512)
    assert plan.opt_rules
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    state = jax.eval_shape(optax.adam(1e-3).init, tree)
    theirs = jax_opt_shardings(state, mesh, None, plan.rules, opt_rules=plan.opt_rules)
    specs = {}
    for path, leaf in jax_paths(theirs)[0]:
        if "/mu/" in path:
            specs[path.split("/mu/", 1)[1]] = tuple(leaf.spec)
    ours = sharding.derive_opt_state_placements(module, mesh_sizes, opt_rules=plan.opt_rules)
    for view in sharding.flax_view(module):
        spec = specs[view.path]
        data = [i for i, entry in enumerate(spec) if entry is not None and "data" in
                ((entry,) if isinstance(entry, str) else tuple(entry))]
        assert ours[view.name] == (view.torch_dims[data[0]] if data else None), (view.path, spec)
    assert any(d is not None for d in ours.values())
    assert sharding.derive_opt_state_placements(module, mesh_sizes) == \
        sharding.derive_param_placements(module, mesh_sizes, None, shard_single=False)
