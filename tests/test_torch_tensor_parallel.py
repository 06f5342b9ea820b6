"""Tensor-parallel serving: `ContinuousBatcher(tp=2)` at world 2 over gloo
on the CPU, held to JAX's mesh-spanning engine (`tests/test_tensor_parallel.py`)
and its planned engine (`tests/test_planner.py`) on the same weights and
requests. About 80 s: one `debug_launcher` spawn of 2 processes running
`tests/_torch_dist_workers.py:tp_serving2` (every variant of the matrix for
both families, the deadline case, then the planned engines), then JAX's
engines here, on the 8-device CPU mesh, and the port's tp=1 engine here.

What is held:
  - token parity, JAX's matrix: Llama and GPT-NeoX x {paged, contiguous,
    paged-spec, contiguous-spec, int8kv, int8kv-spec}, plus int8 weights:
    the port at tp=2 equals JAX's tp=2 and tp=1 tokens and the port's tp=1,
    token for token, on JAX's weights carried across (f32);
  - both ranks stream the same tokens and issue the same collectives (the
    engine's lockstep contract), also when one rank's clock passes a
    request's deadline and the other's does not;
  - the placement audit (JAX's `tp_sharding_report`): every rule-matched
    kernel and embedding leaf and every KV pool leaf split over "model",
    the norms and scalars whole, a quantized kernel's `q` like the kernel
    and its `scale` by the rule's output dim (column-parallel split,
    row-parallel whole), path for path as JAX's; a rank's weight and pool
    bytes at most 1/1.6 of tp=1's;
  - ``sharding_rules="auto"`` (JAX's `test_auto_engine_token_parity_and_discipline`
    and `test_engine_refine_kwarg_measures_and_holds_parity`): Llama,
    GPT-NeoX and a tied-head Llama at tp=2 give JAX's auto engine's rules
    and tokens, which equal the hand table's; a refined engine keeps one
    measured plan on both ranks; a rules list forcing loner column layers,
    loner row layers or a replicated attention chain gives JAX's tokens
    under the same list; GPT-NeoX at tp=4 in world 4 is
    `tests/test_torch_tp_training.py`'s;
  - JAX's validation errors.

JAX's tests that wait, with their ROADMAP items: the engine's `params`
setter and its resharding (`test_tp_swap_weights_reshards_at_setter`, A6's
admin surface), the router over tensor-parallel engines
(`test_router_over_tp_engines_smoke`, A6), the Pallas-kernel variant
(`test_tp_parity_pallas_kernels`: the port's K1/K2 run only on the card,
where phase 21 of `chip_smoke.py` holds them at a rank's heads), the
compiled-once pin (`test_tp_decode_compiled_once_and_zero_recompiles`: eager
torch compiles nothing) and the blast-radius rebuild (the port's pools are
each rank's own heads from construction on).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402

from accelerate_tpu.models.gpt_neox import GPTNeoXConfig as JaxNeoXConfig  # noqa: E402
from accelerate_tpu.models.gpt_neox import create_gpt_neox_model as jax_neox  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import create_llama_model as jax_llama  # noqa: E402
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.models import gpt_neox, llama  # noqa: E402
from accelerate_tpu_torch.serving import ContinuousBatcher  # noqa: E402

WORLD = 2
FAMILIES = ("llama", "gpt_neox")
MATRIX = ("paged", "contiguous", "paged-spec", "contiguous-spec", "int8kv", "int8kv-spec")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _jax_models():
    """JAX's test models (`tests/test_tensor_parallel.py`'s tiny_llama and
    tiny_neox), and tiny_llama with its head tied to the embedding."""
    llama_cfg = JaxLlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                               rope_theta=10000.0)
    jl = jax_llama(llama_cfg, seq_len=32)
    jn = jax_neox(JaxNeoXConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                                num_attention_heads=4, max_position_embeddings=64), seq_len=32)
    jt = jax_llama(dataclasses.replace(llama_cfg, tie_word_embeddings=True), seq_len=32)
    return {"llama": jl, "gpt_neox": jn, "tied": jt}


def _jax_run(model, tp, variant):
    engine = JaxBatcher(model, num_slots=2, chunk_size=4, tp=tp, **variant)
    reqs = [JaxRequest(r.request_id, list(r.input_ids), max_new_tokens=r.max_new_tokens) for r in workers.tp_requests()]
    out = engine.run(reqs)
    return engine, {rid: [int(t) for t in ts] for rid, ts in out.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jmodels = _jax_models()
    inputs = {"cfgs": {}, "sds": {}}
    for family, jm in jmodels.items():
        params = jax.tree_util.tree_map(np.array, jm.params)
        if family in ("llama", "tied"):
            cfg = _port_cfg(llama.LlamaConfig, jm.module.config)
            inputs["sds"][family] = llama.llama_state_dict_from_flax(params, cfg)
        else:
            cfg = _port_cfg(gpt_neox.GPTNeoXConfig, jm.module.config)
            inputs["sds"][family] = gpt_neox.gpt_neox_state_dict_from_flax(params, cfg)
        inputs["cfgs"][family] = cfg
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    torch.save(inputs, in_dir / "inputs.pt")
    debug_launcher(workers.tp_serving2, args=(str(in_dir), str(out_dir)), num_processes=WORLD, timeout=600)
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    jax_runs = {}
    for family in FAMILIES:
        jm = jmodels[family]
        for name, variant in workers.TP_VARIANTS.items():
            for tp in (1, 2):
                engine, tokens = _jax_run(jm, tp, variant)
                jax_runs[family, name, tp] = {"tokens": tokens, "report": engine.tp_sharding_report()}
    port_tp1 = {key: value for key, value in workers.tp_engine_runs(inputs, 1).items()}
    planned = {}
    for family, jm in jmodels.items():
        engine, tokens = _jax_run(jm, 2, {"page_size": 4, "sharding_rules": "auto"})
        planned["auto", family] = {"tokens": tokens, "rules": engine.sharding_plan.rules}
    for name, rules in workers.TP_FORMS.items():
        planned[name, "llama"] = {"tokens": _jax_run(jmodels["llama"], 2, {"page_size": 4, "sharding_rules": rules})[1]}
    planned["hand", "tied"] = {"tokens": _jax_run(jmodels["tied"], 1, {"page_size": 4})[1]}
    return dict(inputs=inputs, ranks=ranks, jax=jax_runs, port_tp1=port_tp1, jax_planned=planned)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("variant", MATRIX + ("int8w",))
def test_tp_token_parity_with_jax(world, family, variant):
    """tp=2 on two processes equals JAX's tp=2 and tp=1 and the port's tp=1,
    token for token, and both ranks stream the same tokens."""
    ours = [r["tp2"][family, variant]["tokens"] for r in world["ranks"]]
    assert ours[0] == ours[1]
    assert ours[0] == world["jax"][family, variant, 2]["tokens"], (family, variant)
    assert ours[0] == world["jax"][family, variant, 1]["tokens"], (family, variant)
    assert ours[0] == world["port_tp1"][family, variant]["tokens"], (family, variant)


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_issue_the_same_collectives(world, family):
    """The lockstep contract: the same requests give each rank the same
    sequence of collectives (counted by kind), in every variant; at tp=1
    there are none. A forward all-reduces once for the embedding and twice
    a layer (attention's and the MLP's row-parallel outputs) and gathers the
    head's logits once."""
    for name in workers.TP_VARIANTS:
        counts = [r["tp2"][family, name]["collectives"] for r in world["ranks"]]
        assert counts[0] == counts[1], (family, name, counts)
        assert counts[0]["all_gather"] > 0
        assert counts[0]["all_reduce"] == counts[0]["all_gather"] * (1 + 2 * 2), counts
        assert world["port_tp1"][family, name]["collectives"] == {"all_reduce": 0, "all_gather": 0}


def test_a_deadline_expires_on_every_rank_or_none(world):
    """Rank 1's clock passes the deadlines, rank 0's does not: both finish
    every request `timeout` with the same partial tokens, and issue the
    same collectives (the flags' all-reduce included)."""
    runs = [r["deadlines"] for r in world["ranks"]]
    assert runs[0] == runs[1]
    assert all(reason == "timeout" for reason, _ in runs[0]["finish"].values())
    assert all(len(tokens) < 32 for _, tokens in runs[0]["finish"].values())


def _has_model(spec: str) -> bool:
    return "model" in spec


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("variant", ("paged", "int8w", "int8kv"))
def test_placement_audit_matches_jax(world, family, variant):
    """Every weight leaf path JAX's tp=2 engine reports, the port reports,
    split over "model" exactly where JAX's is (a quantized kernel's `q`
    like the kernel, its `scale` column-parallel split and row-parallel
    whole; the norms whole); every K/V pool and scale leaf split, the rest
    whole."""
    ours = world["ranks"][0]["tp2"][family, variant]["report"]
    theirs = world["jax"][family, variant, 2]["report"]
    assert set(ours["params"]) == set(theirs["params"])
    for path, spec in theirs["params"].items():
        assert _has_model(ours["params"][path]) == _has_model(spec), (path, ours["params"][path], spec)
    assert any(_has_model(s) for s in ours["params"].values())
    assert all(not _has_model(s) for p, s in ours["params"].items() if "norm" in p)
    for path, spec in ours["cache"].items():
        leaf = path.rsplit("/", 1)[-1]
        assert _has_model(spec) == (leaf in ("cached_key", "cached_value", "key_scale", "value_scale")), path
    if variant == "int8w":
        col = [p for p in ours["params"] if p.endswith("wq/kernel/scale")]
        row = [p for p in ours["params"] if p.endswith(("wo/kernel/scale", "w_down/kernel/scale",
                                                         "dense_4h_to_h/kernel/scale"))]
        assert col and row
        assert all(_has_model(ours["params"][p]) for p in col)
        assert not any(_has_model(ours["params"][p]) for p in row)
        assert all(_has_model(ours["params"][p]) for p in ours["params"] if p.endswith("kernel/q"))


@pytest.mark.parametrize("family", FAMILIES)
def test_a_rank_holds_at_most_1_over_1_6_of_tp1_bytes(world, family):
    """JAX's footprint audit: tp=1's weight + pool bytes over a tp=2 rank's
    is at least 1.6 (the split tensors halve; norms and row-parallel biases
    are whole)."""
    for variant in ("paged", "int8w", "int8kv"):
        one = sum(world["port_tp1"][family, variant]["bytes"])
        for rank in world["ranks"]:
            assert one / sum(rank["tp2"][family, variant]["bytes"]) >= 1.6, (family, variant)


def test_validation_errors_are_jaxs():
    """JAX's `test_tp_validation_errors` on the port, and the planner's
    sentinel at one process (tp=2 still needs its group; tp=1 plans
    nothing, as in JAX)."""
    model = llama.create_llama_model(llama.llama_tiny(), device="cpu")
    with pytest.raises(ValueError, match="KV head"):
        ContinuousBatcher(model, num_slots=2, tp=4, page_size=4, device="cpu")  # 2 KV heads % 4
    with pytest.raises(ValueError):
        ContinuousBatcher(model, num_slots=2, tp=0, page_size=4, device="cpu")
    bare = llama.create_llama_model(llama.llama_tiny(), device="cpu")
    bare.sharding_rules = None
    with pytest.raises(ValueError, match="sharding_rules"):
        ContinuousBatcher(bare, num_slots=2, tp=2, page_size=4, device="cpu")
    with pytest.raises(ValueError, match="needs exactly 2 devices"):  # the planner needs the group too
        ContinuousBatcher(model, num_slots=2, tp=2, page_size=4, sharding_rules="auto", device="cpu")
    with pytest.raises(ValueError, match="sharding_rules must be"):
        ContinuousBatcher(model, num_slots=2, tp=2, page_size=4, sharding_rules="magic", device="cpu")
    with pytest.raises(ValueError, match="needs exactly 2 devices"):  # one process, no group
        ContinuousBatcher(model, num_slots=2, tp=2, page_size=4, device="cpu")
    one = ContinuousBatcher(model, num_slots=2, page_size=4, sharding_rules="auto", device="cpu")
    assert one.sharding_plan is None  # JAX's: tp=1 plans nothing


def test_serving_tp_mesh_blocks_and_wraps(caplog):
    """JAX's rank blocks: group g takes ranks [g*tp, (g+1)*tp), wrapping
    with a warning past the world; a tp the devices do not give raises."""
    from accelerate_tpu_torch.parallel.sharding import serving_tp_mesh

    assert serving_tp_mesh(1) == [0]
    with caplog.at_level("WARNING"):
        assert serving_tp_mesh(1, group=3) == [0]
    assert "wraps" in caplog.text
    assert serving_tp_mesh(2, devices=[3, 1]) == [3, 1]
    with pytest.raises(ValueError, match="needs exactly 2 devices"):
        serving_tp_mesh(2)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        serving_tp_mesh(0)


def test_a_host_model_is_copied_to_the_engine_device_untouched():
    """The engine's copy of a host model (`serving._on_device`; here onto
    the meta device, which needs no card): every tensor moved, a parameter
    still a parameter, the caller's model where it was."""
    from accelerate_tpu_torch.serving import _on_device

    model = llama.create_llama_model(llama.llama_tiny(), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    copy = _on_device(model, torch.device("meta"))
    assert all(t.device.type == "meta" for t in [*copy.parameters(), *copy.buffers()])
    assert [n for n, _ in copy.named_parameters()] == [n for n, _ in model.named_parameters()]
    assert all(t.device.type == "cpu" for t in [*model.parameters(), *model.buffers()])
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert _on_device(model, torch.device("cpu")) is model


# ------------------------------------------------------------------ the planned engine
@pytest.mark.parametrize("family", ("llama", "gpt_neox", "tied"))
def test_auto_engine_matches_jaxs_auto_and_hand_engines(world, family):
    """JAX's `test_auto_engine_token_parity_and_discipline` at tp=2 (and
    Llama with its head tied to a hidden-split embedding): the planned
    engine's tokens equal JAX's auto engine's, JAX's hand-table engine's
    and the port's tp=1's; its rules are JAX's plan; both ranks hold the
    same rules, issue the same collectives, and hold what the plan
    predicts of weights and pool."""
    runs = [r["planned"]["auto", family] for r in world["ranks"]]
    theirs = world["jax_planned"]["auto", family]
    assert runs[0]["tokens"] == runs[1]["tokens"] == theirs["tokens"]
    if family == "tied":
        assert runs[0]["tokens"] == world["jax_planned"]["hand", "tied"]["tokens"]
    else:
        assert runs[0]["tokens"] == world["jax"][family, "paged", 2]["tokens"]
        assert runs[0]["tokens"] == world["port_tp1"][family, "paged"]["tokens"]
    assert runs[0]["rules"] == runs[1]["rules"] == [tuple(r) for r in theirs["rules"]]
    assert any(spec == (None, "model") for p, spec in runs[0]["rules"] if "embed" in p)  # the hidden split
    assert runs[0]["collectives"] == runs[1]["collectives"]
    for run in runs:
        assert abs(sum(run["bytes"]) - sum(run["predicted"])) <= 0.10 * sum(run["bytes"])


def test_refined_engine_measures_and_holds_parity(world):
    """JAX's `test_engine_refine_kwarg_measures_and_holds_parity`: with
    `sharding_refine_top_k=2` the plan carries its measured seconds (the
    slower rank's, so both ranks keep the same plan) and the tokens equal
    tp=1's. The engine keeps each candidate as measured, the same on both
    ranks; the kept plan is the fastest of them. Unrefined engines keep
    none."""
    runs = [r["planned"]["refine", "llama"] for r in world["ranks"]]
    assert runs[0]["measured_s"] > 0 and runs[0]["measured_s"] == runs[1]["measured_s"]
    candidates = runs[0]["candidates"]
    assert len(candidates) == 2 and candidates == runs[1]["candidates"]
    assert runs[0]["measured_s"] == min(seconds for _, seconds in candidates)
    assert runs[0]["rules"] in [rules for rules, _ in candidates]
    assert world["ranks"][0]["planned"]["auto", "llama"]["candidates"] is None
    assert runs[0]["rules"] == runs[1]["rules"]
    assert runs[0]["tokens"] == runs[1]["tokens"] == world["jax"]["llama", "paged", 1]["tokens"]
    assert runs[0]["collectives"] == runs[1]["collectives"]


@pytest.mark.parametrize("form", sorted(workers.TP_FORMS))
def test_each_forced_form_serves_jaxs_tokens(world, form):
    """A rules list that forces loner column layers, loner row layers or a
    replicated attention chain (its heads attended per rank): the engine's
    tokens equal JAX's engine's under the same list, on both ranks."""
    runs = [r["planned"][form, "llama"] for r in world["ranks"]]
    assert runs[0]["tokens"] == runs[1]["tokens"] == world["jax_planned"][form, "llama"]["tokens"]
    assert runs[0]["collectives"] == runs[1]["collectives"] and runs[0]["collectives"]["all_gather"] > 0
