"""The port's Mixtral (`accelerate_tpu_torch.models.mixtral`) held against the
JAX package's on the same weights: `mixtral_tiny` (4 experts, top 2), the
flax params carried across by `mixtral_state_dict_from_flax`.

Tolerances, as for the other families (`tests/test_torch_families.py`): f32
logits atol 1e-4; the router losses and the loss's three terms rtol 1e-5;
3 `train_step` steps with AdamW (decay 1e-4 on both sides: optax's default
is 1e-4, torch's 1e-2) rtol 1e-4; greedy tokens exactly equal. Port
against port (a remat policy against none): rtol 1e-6.

Routing takes each token's top 2 experts, so a comparison whose router
probabilities sat within float noise of a tie could route a token
differently on the two sides. Each parity test asserts first, in JAX, that
the smallest gap between a token's 2nd and 3rd router probability, over
every token and layer of its inputs, exceeds 1e-4; for generation, over
every forward JAX's `Generator` runs (`generation_router_gap` replays its
decode-cache programs). A failure there names its cause: the seed, not the
port.

About 60 s on one CPU thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu import generation as jax_generation
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.models import mixtral as jax_mixtral
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.generation import GenerationConfig, Generator, generate
from accelerate_tpu_torch.models import mixtral
from accelerate_tpu_torch.ops.remat import remat_scope
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.state import AcceleratorState, GradientState

ATOL = 1e-4
LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 1e-4
SEQ = 16
GAP = 1e-4
VOCAB = 512
#: The training test's data seed. Its three batches' smallest router gaps,
#: each on the weights its step starts from, are 4.1e-4, 2.1e-4 and 1.5e-4.
TRAIN_SEED = 9


@pytest.fixture(autouse=True)
def one_torch_thread():
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


def port_config(jcfg):
    return mixtral.MixtralConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(mixtral.MixtralConfig)})


def make_pair(**overrides):
    """(JAX Model bundle, numpy params, port model) on the same weights."""
    jcfg = dataclasses.replace(jax_mixtral.mixtral_tiny(), **overrides)
    jmodel = jax_mixtral.create_mixtral_model(jcfg, seq_len=SEQ)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    cfg = port_config(jcfg)
    model = mixtral.create_mixtral_model(cfg, device="cpu")
    model.load_state_dict(mixtral.mixtral_state_dict_from_flax(params, cfg))
    return jmodel, params, model


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _routed(module, variables, *args):
    """``module.apply(variables, *args)`` with every router's logits captured:
    (output, the cache collection or None, [router logits, ...])."""
    out, state = module.apply(
        variables, *args, mutable=["cache", "intermediates"],
        capture_intermediates=lambda m, _: isinstance(m, fnn.Dense) and m.name == "router",
    )
    return out, state.get("cache"), jax.tree_util.tree_leaves(state["intermediates"])


def _min_gap(router_logits, k):
    gaps = []
    for logits in router_logits:
        probs = np.sort(np.asarray(jax.nn.softmax(logits.astype(jnp.float32), axis=-1)), axis=-1)[..., ::-1]
        gaps.append(float((probs[..., k - 1] - probs[..., k]).min()))
    return min(gaps)


def router_gap(jmodel, ids, mask=None, params=None):
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over every token and layer of JAX's forward on `ids`."""
    cfg = jmodel.module.config
    _, _, logits = _routed(jmodel.module, params or jmodel.params, jnp.asarray(ids, jnp.int32),
                           None if mask is None else jnp.asarray(mask))
    assert len(logits) == cfg.num_hidden_layers
    return _min_gap(logits, cfg.num_experts_per_tok)


def generation_router_gap(jmodel, ids, tokens, mask=None, draft_tokens=0, draft_ngram=2):
    """`router_gap` over the forwards JAX's `Generator` runs for a call that
    returned `tokens` ([B, prompt + n]): its decode-cache module replayed,
    the prefill, then each step on JAX's emitted token (greedy and penalised
    calls), or each speculative verify block with its n-gram drafts. Each
    forward routes with its own capacity, so the full forward of `tokens`
    would route other hidden states."""
    from accelerate_tpu.generation import _rewind_cache_index
    from accelerate_tpu.speculative import greedy_accept_length, propose_ngram_drafts

    cfg = jmodel.module.config
    module = type(jmodel.module)(dataclasses.replace(cfg, decode_cache_length=cfg.max_position_embeddings))
    b, p = ids.shape
    n = tokens.shape[1] - p
    if mask is None:
        positions, next_pos = np.broadcast_to(np.arange(p), (b, p)), np.full((b,), p)
    else:
        positions, next_pos = np.clip(np.cumsum(mask, axis=-1) - 1, 0, None), mask.sum(-1)
    args = (jnp.asarray(ids, jnp.int32), None if mask is None else jnp.asarray(mask, jnp.int32),
            jnp.asarray(positions, jnp.int32))
    _, cache, routed = _routed(module, jmodel.params, *args)

    def forward(block, pos):
        nonlocal cache
        logits, cache, logged = _routed(module, {**jmodel.params, "cache": cache}, jnp.asarray(block, jnp.int32),
                                        None, jnp.asarray(pos, jnp.int32))
        routed.extend(logged)
        return np.asarray(logits)

    if not draft_tokens:
        for i in range(1, n):
            forward(tokens[:, p + i - 1, None], (next_pos + i - 1)[:, None])
        return _min_gap(routed, cfg.num_experts_per_tok)
    history = np.zeros((b, cfg.max_position_embeddings + draft_tokens), np.int32)
    history[:, :p + 1] = tokens[:, :p + 1]
    token, i, js = tokens[:, p], 1, np.arange(draft_tokens + 1)
    while i < n:
        drafts, valid = propose_ngram_drafts(jnp.asarray(history), p + i, draft_tokens, draft_ngram)
        drafts = np.asarray(drafts)
        greedy = forward(np.concatenate([token[:, None], drafts], axis=1), (next_pos + i - 1)[:, None] + js).argmax(-1)
        accept = np.asarray(greedy_accept_length(jnp.asarray(drafts), jnp.asarray(greedy[:, :draft_tokens]), valid))
        a_min = min(int(accept.min()), n - i - 1)
        history[:, p + i:p + i + a_min + 1] = greedy[:, :a_min + 1]
        token = greedy[:, a_min]
        cache = _rewind_cache_index(cache, draft_tokens - a_min)
        i += a_min + 1
    np.testing.assert_array_equal(history[:, :p + n], tokens)  # the replay emitted JAX's tokens
    return _min_gap(routed, cfg.num_experts_per_tok)


def _ids(seed, b, s, lo=0):
    return np.random.default_rng(seed).integers(lo, VOCAB, (b, s)).astype(np.int32)


def _left_padded(seed, lengths, width):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for row, n in enumerate(lengths):
        ids[row, width - n:] = rng.integers(1, VOCAB, (n,))
        mask[row, width - n:] = 1
    return ids, mask


def test_logits_and_aux_match_jax_f32_plain_and_padded(pair):
    """Full-forward f32 logits within atol 1e-4 of JAX's and the
    layer-averaged router losses (`return_aux`) within rtol 1e-5, unmasked
    and on a left-padded batch, whose pads take capacity slots as JAX's do."""
    jmodel, _, model = pair
    ids = _ids(0, 2, 12)
    padded, mask = _left_padded(1, (12, 5), 12)
    for x, m in ((ids, None), (padded, mask)):
        assert router_gap(jmodel, x, m) > GAP
        expect, expect_aux = jmodel.apply_fn(jmodel.params, x, m, return_aux=True)
        with torch.no_grad():
            got, got_aux = model(torch.as_tensor(x).long(), None if m is None else torch.as_tensor(m), return_aux=True)
        assert got.shape == (2, 12, VOCAB)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL, rtol=0)
        assert sorted(got_aux) == sorted(expect_aux)
        for name, value in expect_aux.items():
            np.testing.assert_allclose(float(got_aux[name]), float(value), rtol=1e-5, err_msg=name)
        with torch.no_grad():
            assert torch.equal(model(torch.as_tensor(x).long(), None if m is None else torch.as_tensor(m)), got)


def test_moe_loss_terms_match_jax(pair):
    """`make_moe_causal_lm_loss`'s total and its three terms (ce,
    load_balance_loss, router_z_loss) against JAX's, with labels < 0
    ignored."""
    jmodel, _, model = pair
    ids = _ids(2, 2, SEQ)
    labels = ids.copy()
    labels[0, :5] = -100
    assert router_gap(jmodel, ids) > GAP
    jloss = jax_mixtral.make_moe_causal_lm_loss(jmodel.module.config)
    for batch in ({"input_ids": ids}, {"input_ids": ids, "labels": labels}):
        expect, expect_aux = jloss(jmodel.params, batch, jmodel.apply_fn)
        with torch.no_grad():
            got, got_aux = model.loss_fn({k: torch.as_tensor(v).long() for k, v in batch.items()}, model)
        np.testing.assert_allclose(float(got), float(expect), rtol=1e-5)
        assert sorted(got_aux) == ["ce", "load_balance_loss", "router_z_loss"] == sorted(expect_aux)
        for name, value in expect_aux.items():
            np.testing.assert_allclose(float(got_aux[name]), float(value), rtol=1e-5, err_msg=name)


def test_remat_full_keeps_loss_aux_and_gradients(pair):
    """Under `remat_scope("full")` each layer's ``(hidden, aux)`` tuple goes
    through `torch.utils.checkpoint`: the loss, its aux and every gradient
    equal those without remat."""
    _, _, model = pair
    batch = {"input_ids": torch.as_tensor(_ids(5, 2, SEQ)).long()}
    results = []
    for policy in (None, "full"):
        model.zero_grad(set_to_none=True)
        with remat_scope(policy):
            loss, aux = model.loss_fn(batch, model)
        loss.backward()
        results.append((loss.detach(), {k: v.detach() for k, v in aux.items()},
                        {n: p.grad.clone() for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    (loss0, aux0, grads0), (loss1, aux1, grads1) = results
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for name, value in aux0.items():
        torch.testing.assert_close(aux1[name], value, rtol=1e-6, atol=0)
    for name, g in grads0.items():
        torch.testing.assert_close(grads1[name], g, rtol=1e-6, atol=1e-7, msg=name)


def test_adamw_steps_through_the_accelerator_match_jax():
    """3 fused `train_step` steps through the port's `Accelerator` (torch
    AdamW) against JAX's `Accelerator.train_step` with `optax.adamw` (the
    same decay): the losses and each step's aux within rtol 1e-4, and the
    experts' weights moved (`tests/test_expert.py`'s training check). The
    data comes from `TRAIN_SEED`, whose batches keep every router gap above
    1e-4 at each step (see its note)."""
    jmodel, _, model = make_pair()
    ids = _ids(TRAIN_SEED, 24, SEQ, lo=1)
    data = [{"input_ids": ids[i]} for i in range(24)]
    for state in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        state._reset_state()
    accelerator = JaxAccelerator()
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    jprepared, _, loader = accelerator.prepare(dataclasses.replace(jmodel), tx,
                                               JaxLoader(data, JaxBatchSampler(range(len(data)), 8)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    expect = []
    for b in loader:  # each step's routing, on the weights that step starts from
        assert router_gap(jmodel, np.asarray(b["input_ids"]), params=jprepared.params) > GAP
        expect.append(step_fn(b))

    before = model.layers[0].moe.experts.w_gate.detach().clone()
    accelerator = port.Accelerator(cpu=True)
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    _, _, ploader = accelerator.prepare(model, optimizer,
                                        port.SimpleDataLoader(data, port.BatchSampler(range(len(data)), 8)))
    step = accelerator.train_step(max_grad_norm=1.0)
    got = [step(b) for b in ploader]
    assert len(got) == len(expect) == 3
    np.testing.assert_allclose([float(loss) for loss, _ in got], [float(loss) for loss, _ in expect], rtol=1e-4)
    for (_, aux), (_, jaux) in zip(got, expect):
        assert sorted(aux) == sorted(jaux) == ["ce", "load_balance_loss", "router_z_loss"]
        for name, value in jaux.items():
            np.testing.assert_allclose(float(aux[name]), float(value), rtol=1e-4, err_msg=name)
    assert float(got[1][0]) != float(got[0][0])
    assert not torch.allclose(model.layers[0].moe.experts.w_gate, before), "the experts did not train"


@pytest.mark.parametrize("kw", [{}, {"draft_tokens": 2}, {"repetition_penalty": 1.3}],
                         ids=["greedy", "draft2", "penalty"])
def test_generate_matches_jax_at_the_default_capacity(pair, kw):
    """`generate` at capacity 1.25, where the prefill (T = B * prompt),
    each decode step (T = B) and each verify block (T = B * 3) route with
    their own capacity and drop what JAX's programs drop: greedy, n-gram
    speculative with 2 drafts, and under a repetition penalty, the tokens
    equal JAX's."""
    jmodel, _, model = pair
    ids = _ids(6, 3, 9, lo=1)
    expect = np.asarray(jax_generation.generate(jmodel, ids, max_new_tokens=11, **kw))
    assert generation_router_gap(jmodel, ids, expect, draft_tokens=kw.get("draft_tokens", 0)) > GAP
    got = generate(model, ids, max_new_tokens=11, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, expect)


def test_left_padded_generate_matches_jax(pair):
    """A left-padded ragged batch through the `Generator`: the pads take
    capacity slots at the prefill and the tokens equal JAX's."""
    jmodel, _, model = pair
    ids, mask = _left_padded(7, (4, 9, 6), 9)
    jgen = jax_generation.Generator(jmodel)
    expect = np.asarray(jgen(jnp.asarray(ids), jax_generation.GenerationConfig(max_new_tokens=10),
                             attention_mask=mask))
    assert generation_router_gap(jmodel, ids, expect, mask) > GAP
    got = Generator(model, device="cpu")(ids, GenerationConfig(max_new_tokens=10), attention_mask=mask).numpy()
    np.testing.assert_array_equal(got, expect)


def test_cached_greedy_matches_full_context_when_dropless():
    """The port of `tests/test_expert.py`'s cached-decode check: at capacity
    8.0 no choice is dropped in either mode, so cached greedy decoding
    equals the argmax of the growing full-context forward; a sampled call
    gives tokens of the right shape and range."""
    _, _, model = make_pair(capacity_factor=8.0)
    prompt = _ids(3, 2, 6, lo=1)
    out = generate(model, prompt, max_new_tokens=5, device="cpu").numpy()
    ids = prompt.astype(np.int64)
    with torch.no_grad():
        for _ in range(5):
            logits = model(torch.as_tensor(ids))
            ids = np.concatenate([ids, logits[:, -1].argmax(-1).numpy()[:, None]], axis=1)
    np.testing.assert_array_equal(out, ids)
    sampled = Generator(model, device="cpu")(prompt, GenerationConfig(max_new_tokens=4, do_sample=True, top_k=20))
    assert sampled.shape == (2, 10) and int(sampled.min()) >= 0 and int(sampled.max()) < VOCAB


def test_carry_refuses_another_depth(pair):
    """The carry gives every parameter of the model, the experts' [E, in,
    out] weights as they are, and refuses a tree of another depth."""
    _, params, model = pair
    sd = mixtral.mixtral_state_dict_from_flax(params, model.config)
    assert sorted(sd) == sorted(model.state_dict())
    experts = params["params"]["layer_1"]["moe"]["experts"]
    np.testing.assert_array_equal(sd["layers.1.moe.experts.w_down"].numpy(), experts["w_down/kernel"])
    np.testing.assert_array_equal(sd["layers.0.moe.router.weight"].numpy(),
                                  params["params"]["layer_0"]["moe"]["router"]["kernel"].T)
    with pytest.raises(ValueError, match="layers"):
        mixtral.mixtral_state_dict_from_flax(params, dataclasses.replace(model.config, num_hidden_layers=3))


def test_registry_and_random_init():
    """`mixtral-8x7b` and `mixtral-tiny` as in JAX's registry; a tiny model
    made the same from a seed twice, its experts filled (normal, std
    1/sqrt(in)), not left as `to_empty`'s memory; the engine refuses it
    (no slot cache, as in JAX), `generate` takes it."""
    from accelerate_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from accelerate_tpu_torch.models import MODEL_REGISTRY, create_named_model

    for name in ("mixtral-8x7b", "mixtral-tiny"):
        assert name in MODEL_REGISTRY and name in JAX_REGISTRY
    full = MODEL_REGISTRY["mixtral-8x7b"]()
    assert full.head_dim == 128 and full.num_local_experts == 8 and full.capacity_factor == 1.25
    a = create_named_model("mixtral-tiny", seed=3, dtype=torch.bfloat16, device="cpu")
    b = create_named_model("mixtral-tiny", seed=3, dtype=torch.bfloat16, device="cpu")
    for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), key
    w = create_named_model("mixtral-tiny", seed=4, device="cpu").layers[0].moe.experts
    for weight in (w.w_gate, w.w_up, w.w_down):
        assert torch.isfinite(weight).all()
        assert abs(float(weight.detach().std()) * weight.shape[1] ** 0.5 - 1.0) < 0.05
    with pytest.raises(ValueError, match="doesn't support slot-batched serving"):
        ContinuousBatcher(a.float(), num_slots=2, max_length=32, device="cpu")
    assert generate(a.float(), _ids(8, 1, 4, lo=1), max_new_tokens=2, device="cpu").shape == (1, 6)
