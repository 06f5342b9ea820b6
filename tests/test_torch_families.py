"""The port's GPT-NeoX, GPT-J and OPT (`accelerate_tpu_torch.models.gpt_neox`,
`gptj`, `opt`) held against the JAX families on the same weights: each
test runs once per family, on its tiny config, with the flax params carried
across by the family's ``*_state_dict_from_flax``.

JAX initialises every bias at 0 and every LayerNorm scale at 1, which
would hide a bias or a norm parameter the port dropped or misplaced, so
the carried tree has each of them moved by seeded normal noise (std 0.1)
on both sides.

Tolerances, as for Llama (`tests/test_torch_llama.py`): f32 logits atol
1e-4 (the same f32 operations, GEMMs summed in another order; LayerNorm's
variance taken as flax's E[x^2] - E[x]^2 against torch's mean square
deviation); losses of `train_step` atol 1e-4; greedy tokens exactly equal.
Port against port (a remat policy against none): rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu import generation as jax_generation
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.models import gpt_neox as jax_neox
from accelerate_tpu.models import gptj as jax_gptj
from accelerate_tpu.models import opt as jax_opt
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.generation import GenerationConfig, Generator, generate
from accelerate_tpu_torch.models import gpt_neox, gptj, opt
from accelerate_tpu_torch.models.llama import causal_lm_loss
from accelerate_tpu_torch.ops.remat import remat_scope
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.state import AcceleratorState, GradientState

ATOL = 1e-4
LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 1e-4
SEQ = 16

#: family -> (JAX create, JAX tiny config, port config type, port create, carry function)
FAMILIES = {
    "gpt_neox": (jax_neox.create_gpt_neox_model, jax_neox.gpt_neox_tiny, gpt_neox.GPTNeoXConfig,
                 gpt_neox.create_gpt_neox_model, gpt_neox.gpt_neox_state_dict_from_flax),
    "gptj": (jax_gptj.create_gptj_model, jax_gptj.gptj_tiny, gptj.GPTJConfig, gptj.create_gptj_model,
             gptj.gptj_state_dict_from_flax),
    "opt": (jax_opt.create_opt_model, jax_opt.opt_tiny, opt.OPTConfig, opt.create_opt_model,
            opt.opt_state_dict_from_flax),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Parity on one torch thread (a second OpenMP thread can move `torch.exp`
    by an ulp under load, `tests/test_torch_llama.py`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


def perturbed(params, seed=0):
    """`params` with every bias and LayerNorm scale moved by normal noise
    (std 0.1), as numpy arrays."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if path[-1].key in ("bias", "scale"):
            return (x + rng.normal(0.0, 0.1, x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


def port_config(family, jcfg):
    cls = FAMILIES[family][2]
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def make_pair(family, **overrides):
    """(JAX Model bundle, numpy params, port model) on the same weights."""
    jax_create, jax_tiny, _, create, carry = FAMILIES[family]
    jcfg = dataclasses.replace(jax_tiny(), **overrides)
    jmodel = jax_create(jcfg, seq_len=SEQ)
    params = perturbed(jmodel.params)
    jmodel = dataclasses.replace(jmodel, params=jax.tree_util.tree_map(jnp.asarray, params))
    cfg = port_config(family, jcfg)
    model = create(cfg, device="cpu")
    model.load_state_dict(carry(params, cfg))
    return jmodel, params, model


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    jmodel, params, model = make_pair(request.param)
    return request.param, jmodel, params, model


def _ids(seed, b, s, lo=0, vocab=512):
    return np.random.default_rng(seed).integers(lo, vocab, (b, s)).astype(np.int32)


def test_logits_match_jax_f32_plain_and_padded(pair):
    """Full-forward f32 logits, unmasked and with a right- and a left-padded
    row ([B, S] mask, 1 = a real token), within atol 1e-4 of JAX's."""
    _, jmodel, _, model = pair
    ids = _ids(0, 2, 12)
    mask = np.ones((2, 12), np.int32)
    mask[0, 9:] = 0
    mask[1, :4] = 0
    for m in (None, mask):
        expect = np.asarray(jmodel.apply_fn(jmodel.params, ids, m))
        got = model(torch.as_tensor(ids).long(), None if m is None else torch.as_tensor(m)).detach().numpy()
        assert got.shape == (2, 12, 512)
        np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


def _stacked(params, n):
    """The per-layer tree as a ``scan_layers=True`` tree: ``blocks/block``
    with every leaf stacked over the layers."""
    inner = dict(params["params"])
    layers = [inner.pop(f"layer_{i}") for i in range(n)]
    inner["blocks"] = {"block": jax.tree_util.tree_map(lambda *xs: np.stack(xs), *layers)}
    return {"params": inner}


def test_carry_takes_per_layer_and_scanned_trees(pair):
    """The carry function gives the same state dict from the per-layer tree
    and from its stacked twin, and a real ``scan_layers=True`` JAX model's
    logits through the port; it refuses a tree of another depth."""
    family, _, params, model = pair
    carry = FAMILIES[family][4]
    sd = carry(params, model.config)
    assert sorted(sd) == sorted(model.state_dict())
    for name, t in carry(_stacked(params, model.config.num_hidden_layers), model.config).items():
        assert torch.equal(t, sd[name]), name
    jscan, _, scanned = make_pair(family, scan_layers=True)
    ids = _ids(1, 2, 10)
    np.testing.assert_allclose(scanned(torch.as_tensor(ids).long()).detach().numpy(),
                               np.asarray(jscan.apply_fn(jscan.params, ids)), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="layers"):
        carry(params, dataclasses.replace(model.config, num_hidden_layers=3))


def test_opt_keeps_block_and_model_final_norms_apart():
    _, params, model = make_pair("opt")
    sd = opt.opt_state_dict_from_flax(params, model.config)
    inner = params["params"]
    np.testing.assert_array_equal(sd["final_norm.weight"].numpy(), inner["final_norm"]["scale"])
    np.testing.assert_array_equal(sd["layers.1.final_norm.bias"].numpy(), inner["layer_1"]["final_norm"]["bias"])
    assert not np.array_equal(inner["final_norm"]["scale"], inner["layer_1"]["final_norm"]["scale"])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)], ids=["f32", "bf16"])
def test_partial_rotaries_match_jax(dtype, tol):
    """NeoX's half-split and GPT-J's interleaved partial rotary, f32 and bf16
    in and out, against the JAX functions on the same inputs."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 24)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj, xt = jnp.asarray(x, jdtype), torch.as_tensor(x).to(dtype)
    cases = [
        (jax_neox.neox_partial_rotary(xj, pos, 8, 10000.0), gpt_neox.neox_partial_rotary(xt, torch.as_tensor(pos), 8, 10000.0)),
        (jax_gptj.partial_rotary(xj, pos, 8), gptj.partial_rotary(xt, torch.as_tensor(pos), 8)),
    ]
    for expect, got in cases:
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(expect.astype(jnp.float32)), atol=tol, rtol=tol)
        np.testing.assert_array_equal(got[..., 8:].float().numpy(), x[..., 8:] if dtype == torch.float32
                                      else xt[..., 8:].float().numpy())


def _data(n, seed=0):
    ids = _ids(seed, n, SEQ)
    return [{"input_ids": ids[i]} for i in range(n)]


def test_loss_and_adamw_steps_match_jax(pair):
    """`causal_lm_loss` and the fused `train_step` with AdamW (decay set on
    both sides): the first step's loss is the initial loss, each later one
    follows an AdamW update; f32 losses within atol 1e-4 of JAX's."""
    _, jmodel, _, model = pair
    data = _data(16)
    for state in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        state._reset_state()
    accelerator = JaxAccelerator()
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    _, _, loader = accelerator.prepare(dataclasses.replace(jmodel), tx,
                                       JaxLoader(data, JaxBatchSampler(range(len(data)), 8)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    expect = [float(step_fn(b)) for b in loader]

    with torch.no_grad():
        batch = {"input_ids": torch.as_tensor(np.stack([d["input_ids"] for d in data[:8]])).long()}
        first = float(causal_lm_loss(batch, model))
    np.testing.assert_allclose(first, expect[0], atol=ATOL, rtol=0)
    accelerator = port.Accelerator(cpu=True)
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        _, _, ploader = accelerator.prepare(model, optimizer,
                                            port.SimpleDataLoader(data, port.BatchSampler(range(len(data)), 8)))
        step = accelerator.train_step(max_grad_norm=1.0)
        got = [float(step(b)) for b in ploader]
    finally:
        model.load_state_dict(state)  # the module-scoped fixture's weights, as they were
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
    assert got[1] != got[0]


def test_remat_policy_keeps_loss_and_gradients(pair):
    """Under `remat_scope("full")` the loss and every gradient equal those
    without remat."""
    _, _, _, model = pair
    batch = {"input_ids": torch.as_tensor(_ids(5, 2, SEQ)).long()}
    results = []
    for policy in (None, "full"):
        model.zero_grad(set_to_none=True)
        with remat_scope(policy):
            loss = causal_lm_loss(batch, model)
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    (loss0, grads0), (loss1, grads1) = results
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for name, g in grads0.items():
        torch.testing.assert_close(grads1[name], g, rtol=1e-6, atol=1e-7, msg=name)


def test_greedy_and_left_padded_generate_match_jax(pair):
    """Greedy `generate` on a batch, and a left-padded ragged batch through
    the `Generator` (positions from the mask's cumsum; OPT's learned
    positions at cumsum - 1 + 2), equal JAX's tokens."""
    _, jmodel, _, model = pair
    ids = _ids(6, 3, 9, lo=1)
    got = generate(model, ids, max_new_tokens=11, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_generation.generate(jmodel, ids, max_new_tokens=11)))
    rng = np.random.default_rng(7)
    ids = np.zeros((3, 9), np.int32)
    mask = np.zeros((3, 9), np.int32)
    for row, n in enumerate((4, 9, 6)):
        ids[row, 9 - n:] = rng.integers(1, 512, (n,))
        mask[row, 9 - n:] = 1
    jgen = jax_generation.Generator(jmodel)
    expect = np.asarray(jgen(jnp.asarray(ids), jax_generation.GenerationConfig(max_new_tokens=10),
                             attention_mask=mask))
    got = Generator(model, device="cpu")(ids, GenerationConfig(max_new_tokens=10), attention_mask=mask).numpy()
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("family", ["gptj", "opt"])
def test_engine_refuses_families_without_a_slot_cache(family):
    """GPT-J and OPT have no slot cache in the JAX package: its engine
    refuses them ("doesn't support slot-batched serving"), and so does the
    port's, while `generate` takes them."""
    _, _, model = make_pair(family)
    with pytest.raises(ValueError, match="doesn't support slot-batched serving"):
        ContinuousBatcher(model, num_slots=2, max_length=32, device="cpu")
    assert generate(model, _ids(8, 1, 4, lo=1), max_new_tokens=2, device="cpu").shape == (1, 6)


def test_registry_creates_each_family_on_the_cpu():
    """The six registry names of the JAX package; a tiny model is made the
    same from a seed twice, in the dtype asked for."""
    from accelerate_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from accelerate_tpu_torch.models import MODEL_REGISTRY, create_named_model

    for name in ("gpt-neox-20b", "gpt-neox-tiny", "gptj-6b", "gptj-tiny", "opt-30b", "opt-tiny"):
        assert name in MODEL_REGISTRY and name in JAX_REGISTRY
    for name in ("gpt-neox-tiny", "gptj-tiny", "opt-tiny"):
        a = create_named_model(name, seed=3, dtype=torch.bfloat16, device="cpu")
        b = create_named_model(name, seed=3, dtype=torch.bfloat16, device="cpu")
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert x.dtype == torch.bfloat16 and torch.equal(x, y), (name, key)
