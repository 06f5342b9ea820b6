"""The port's T5 (`accelerate_tpu_torch.models.t5`), its attention bias and
`Seq2SeqGenerator`, held against the JAX package on the same weights
(carried across by `t5_state_dict_from_flax`) and against `transformers`.

Tolerances: f32 logits atol 1e-4 against JAX (the same f32 operations,
matmuls summed in another order), rtol/atol 2e-4 against `transformers`
(JAX's own limit for that check, `tests/test_t5.py`); the relative-position
buckets exactly equal JAX's over every relative position in [-4096, 4096];
losses of two AdamW steps atol 1e-4; greedy tokens exactly equal. Port
against port (a remat policy against none): rtol 1e-6.

About 25 s on one CPU thread.
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
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.generation import Seq2SeqGenerator as JaxSeq2SeqGenerator
from accelerate_tpu.models import t5 as jax_t5
from accelerate_tpu.ops import attention as jax_attention
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.generation import GenerationConfig, Seq2SeqGenerator
from accelerate_tpu_torch.models import t5
from accelerate_tpu_torch.ops import attention as port_attention
from accelerate_tpu_torch.ops.remat import remat_scope
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.state import AcceleratorState, GradientState

ATOL = 1e-4
LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 1e-4


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


def _port_config(jcfg):
    return t5.T5Config(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(t5.T5Config)})


def make_pair(jcfg):
    """(JAX Model bundle, port model) on the same weights."""
    jmodel = jax_t5.create_t5_model(jcfg, seq_len=16)
    cfg = _port_config(jcfg)
    model = t5.create_t5_model(cfg, device="cpu")
    model.load_state_dict(t5.t5_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jmodel.params), cfg))
    return jmodel, model


GENERATIONS = {"v1_1": jax_t5.t5_tiny, "v1_0": jax_t5.t5_tiny_v1_0}


@pytest.fixture(scope="module", params=sorted(GENERATIONS))
def pair(request):
    return (request.param, *make_pair(GENERATIONS[request.param]()))


def _ids(seed, b, s, lo=1, vocab=512):
    return np.random.default_rng(seed).integers(lo, vocab, (b, s)).astype(np.int32)


def _tensor(x):
    return None if x is None else torch.as_tensor(np.asarray(x)).long()


# ------------------------------------------------------------------- attention
def test_dot_product_attention_bias_and_mask_match_jax():
    """The additive bias ([1|B, H, Sq, Skv], added after scaling, before the
    causal mask and the mask) against JAX's plain path, f32, with and
    without causal, grouped-query heads, a [B, 1, Sq, Skv] mask."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    mask = rng.random((2, 1, 6, 9)) > 0.3
    mask[..., -1] = True
    for bias in (rng.normal(size=(1, 4, 6, 9)).astype(np.float32), rng.normal(size=(2, 4, 6, 9)).astype(np.float32)):
        for causal in (False, True):
            for m in (None, mask):
                expect = jax_attention.dot_product_attention(q, k, v, m, bias=bias, causal=causal, scale=1.0,
                                                             implementation="xla")
                got = port_attention.dot_product_attention(
                    *(torch.from_numpy(x) for x in (q, k, v)), None if m is None else torch.from_numpy(m),
                    bias=torch.from_numpy(bias), causal=causal, scale=1.0)
                np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5, rtol=0)
                assert port_attention.LAST_DISPATCH == "xla"


def test_flash_refuses_a_bias():
    x = torch.randn(1, 128, 2, 32)
    bias = torch.zeros(1, 2, 128, 128)
    with pytest.raises(ValueError, match="cannot honor a bias argument"):
        port_attention.dot_product_attention(x, x, x, bias=bias, implementation="flash")
    # The gate never opens for a biased call, whatever the shape.
    assert not port_attention.use_flash(None, True, 1024, 2048, False, True)
    assert port_attention.use_flash(None, False, 1024, 2048, False, True)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_equal_jax_exactly(bidirectional):
    """Every relative position in [-4096, 4096] at T5's 32 buckets and
    distance 128: the f32 log at a bucket's edge must round as JAX's does."""
    rel = np.arange(-4096, 4097, dtype=np.int32)
    expect = np.asarray(jax_t5.relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128))
    got = t5.relative_position_bucket(torch.from_numpy(rel), bidirectional, 32, 128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    # Every bucket is used, but for the upper half's first (a later key is never at distance 0).
    assert len(np.unique(expect)) == (31 if bidirectional else 32)


# ------------------------------------------------------------------ the model
def test_logits_match_jax_f32_plain_and_masked(pair):
    """Teacher-forced f32 logits, without and with an encoder attention
    mask (a padded tail and a padded head), within atol 1e-4 of JAX's, for
    v1.1 and v1.0 (tied head, scaled by d_model ** -0.5, and relu FFN)."""
    gen, jmodel, model = pair
    ids, dec = _ids(0, 2, 12), _ids(1, 2, 6)
    mask = np.ones((2, 12), np.int32)
    mask[0, 9:] = 0
    mask[1, :3] = 0
    for m in (None, mask):
        expect = np.asarray(jmodel.apply_fn(jmodel.params, ids, dec, m))
        got = model(_tensor(ids), _tensor(dec), _tensor(m)).detach().numpy()
        assert got.shape == (2, 6, 512)
        np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
    assert (model.lm_head is None) == (gen == "v1_0")


def test_carry_refuses_a_tied_config_with_a_distinct_head():
    jmodel = jax_t5.create_t5_model(jax_t5.t5_tiny(), seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    with pytest.raises(ValueError, match="refusing to drop it"):
        t5.t5_state_dict_from_flax(params, _port_config(jax_t5.t5_tiny_v1_0()))


def _batch(seed, b=4, enc=12, dec=6):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 512, (b, dec)).astype(np.int64)
    labels[0, -2:] = -100  # ignored
    return {"input_ids": rng.integers(1, 512, (b, enc)).astype(np.int32),
            "decoder_input_ids": rng.integers(1, 512, (b, dec)).astype(np.int32), "labels": labels}


def test_loss_and_adamw_steps_match_jax(pair):
    """`seq2seq_lm_loss` (labels < 0 ignored) and two fused AdamW steps
    (decay set on both sides): f32 losses within atol 1e-4 of JAX's."""
    _, jmodel, model = pair
    data = [{k: v[i] for k, v in _batch(s).items()} for s in (2, 3) for i in range(4)]
    for state in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        state._reset_state()
    accelerator = JaxAccelerator()
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    _, _, loader = accelerator.prepare(dataclasses.replace(jmodel), tx,
                                       JaxLoader(data, JaxBatchSampler(range(len(data)), 4)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    expect = [float(step_fn(b)) for b in loader]
    batch0 = {k: torch.as_tensor(v) for k, v in _batch(2).items()}
    with torch.no_grad():
        np.testing.assert_allclose(float(t5.seq2seq_lm_loss(batch0, model)), expect[0], atol=ATOL, rtol=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        accelerator = port.Accelerator(cpu=True)
        optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
        _, _, ploader = accelerator.prepare(model, optimizer,
                                            port.SimpleDataLoader(data, port.BatchSampler(range(len(data)), 4)))
        step = accelerator.train_step(max_grad_norm=1.0)
        got = [float(step(b)) for b in ploader]
    finally:
        model.load_state_dict(state)
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
    assert got[1] != got[0]


def test_remat_full_keeps_the_loss_and_gradients(pair):
    _, _, model = pair
    batch = {k: torch.as_tensor(v) for k, v in _batch(4).items()}
    results = []
    for policy in (None, "full"):
        model.zero_grad(set_to_none=True)
        with remat_scope(policy):
            loss = t5.seq2seq_lm_loss(batch, model)
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    (loss0, grads0), (loss1, grads1) = results
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for name, g in grads0.items():
        torch.testing.assert_close(grads1[name], g, rtol=1e-6, atol=1e-7, msg=name)


# ------------------------------------------------------------------ generation
def _full_context_greedy(model, prompt, n, mask=None):
    """Argmax over the uncached teacher-forced forward, grown a token at a
    time from the start token 0 (JAX's `tests/test_t5.py` reference)."""
    dec = torch.zeros((prompt.shape[0], 1), dtype=torch.long)
    with torch.no_grad():
        for _ in range(n):
            nxt = model(_tensor(prompt), dec, _tensor(mask))[:, -1].argmax(-1)
            dec = torch.cat([dec, nxt[:, None]], dim=1)
    return dec[:, 1:].numpy()


def test_seq2seq_generator_matches_jax_and_the_uncached_loop(pair):
    """Greedy tokens equal JAX's `Seq2SeqGenerator` on the same weights and
    prompts, without and with an attention mask (a padded tail), and the
    uncached full-context loop's: the cache writes, the decoder's bias
    positions under the cache and the cross-attention K/V projected once."""
    _, jmodel, model = pair
    prompt = _ids(5, 2, 10)
    mask = np.ones((2, 10), np.int32)
    mask[0, 7:] = 0
    jgen = JaxSeq2SeqGenerator(jmodel, max_new_tokens=8)
    gen = Seq2SeqGenerator(model, max_new_tokens=8, device="cpu")
    for m in (None, mask):
        kw = {} if m is None else {"attention_mask": m}
        expect = np.asarray(jgen(prompt, max_new_tokens=8, **kw))
        got = gen(prompt, max_new_tokens=8, **kw).numpy()
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(got, _full_context_greedy(model, prompt, 8, m))
    assert not np.array_equal(gen(prompt, attention_mask=mask).numpy(), gen(prompt).numpy())


def test_seq2seq_eos_and_penalty_match_jax():
    """EOS with the pad fill and the cut after every row has finished, and a
    repetition penalty seeded with the start token only, against JAX's."""
    jmodel, model = make_pair(jax_t5.t5_tiny())
    prompt = _ids(9, 3, 10)
    jgen = JaxSeq2SeqGenerator(jmodel, max_new_tokens=12)
    gen = Seq2SeqGenerator(model, max_new_tokens=12, device="cpu")
    first = gen(prompt, max_new_tokens=12).numpy()
    eos = int(first[1, 3])
    for kw in (dict(eos_token_id=eos, pad_token_id=7), dict(repetition_penalty=1.7)):
        expect = np.asarray(jgen(prompt, JaxGenerationConfig(max_new_tokens=12, **kw)))
        got = gen(prompt, GenerationConfig(max_new_tokens=12, **kw)).numpy()
        np.testing.assert_array_equal(got, expect)


def test_seq2seq_budget_and_drafts():
    """Over the budget raises; a bare call fills the budget; draft_tokens is
    refused with JAX's words; sampling draws from the generator given."""
    _, model = make_pair(jax_t5.t5_tiny())
    prompt = np.ones((1, 6), np.int32)
    gen = Seq2SeqGenerator(model, max_new_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="cache was sized for 4"):
        gen(prompt, GenerationConfig(max_new_tokens=8))
    assert gen(prompt).shape == (1, 4)
    with pytest.raises(ValueError, match="causal-LM only"):
        gen(prompt, draft_tokens=2)
    draws = [gen(prompt, do_sample=True, rng=torch.Generator().manual_seed(s)).numpy() for s in (1, 1, 2)]
    np.testing.assert_array_equal(draws[0], draws[1])
    with pytest.raises(ValueError, match="encoder-decoder"):
        Seq2SeqGenerator(port.create_named_model("llama-tiny", device="cpu"), device="cpu")


def test_engine_refuses_t5():
    _, model = make_pair(jax_t5.t5_tiny())
    with pytest.raises(ValueError, match="doesn't support slot-batched serving"):
        ContinuousBatcher(model, num_slots=2, max_length=32, device="cpu")


# ---------------------------------------------------------------- transformers
@pytest.mark.parametrize("v1_0", [False, True], ids=["v1_1", "v1_0"])
def test_logits_match_transformers(v1_0):
    """f32 logits of an HF T5 state dict loaded into the port against the
    `transformers` forward (JAX's configs and limit, `tests/test_t5.py`):
    v1.1 gated-gelu untied, v1.0 relu with the tied head, whose `.bin`-style
    state dict keeps the tied `lm_head.weight` view."""
    transformers = pytest.importorskip("transformers")
    from accelerate_tpu_torch.utils.hf_loading import convert_hf_state_dict

    hf_cfg = transformers.T5Config(
        vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_decoder_layers=2, num_heads=4,
        relative_attention_num_buckets=32, relative_attention_max_distance=128, dropout_rate=0.0,
        layer_norm_epsilon=1e-6, feed_forward_proj="relu" if v1_0 else "gated-gelu", tie_word_embeddings=v1_0,
    )
    torch.manual_seed(0)
    hf_model = transformers.T5ForConditionalGeneration(hf_cfg).eval()
    cfg = _port_config(jax_t5.t5_tiny_v1_0() if v1_0 else jax_t5.t5_tiny())
    model = t5.create_t5_model(cfg, device="cpu")
    model.load_state_dict(convert_hf_state_dict(hf_model.state_dict(), "t5", cfg))
    rng = np.random.default_rng(3)
    ids, dec = torch.from_numpy(rng.integers(1, 512, (2, 12))), torch.from_numpy(rng.integers(1, 512, (2, 6)))
    with torch.no_grad():
        ref = hf_model(input_ids=ids, decoder_input_ids=dec).logits
        got = model(ids, dec)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)


def test_generation_mismatch_is_one_clear_error():
    from accelerate_tpu_torch.utils.hf_loading import convert_hf_state_dict, export_hf_state_dict

    v10, v11 = _port_config(jax_t5.t5_tiny_v1_0()), _port_config(jax_t5.t5_tiny())
    v10_flat = export_hf_state_dict(t5.create_t5_model(v10, device="cpu"), "t5", v10)
    v11_flat = export_hf_state_dict(t5.create_t5_model(v11, device="cpu"), "t5", v11)
    assert "lm_head.weight" not in v10_flat and "encoder.block.0.layer.1.DenseReluDense.wi.weight" in v10_flat
    with pytest.raises(ValueError, match="generation mismatch"):
        convert_hf_state_dict(v10_flat, "t5", v11)
    with pytest.raises(ValueError, match="generation mismatch"):
        convert_hf_state_dict(v11_flat, "t5", v10)
    with pytest.raises(ValueError, match="tie_word_embeddings=True"):
        convert_hf_state_dict(v10_flat, "t5", dataclasses.replace(v10, tie_word_embeddings=False))
    with pytest.raises(ValueError, match="feed_forward_proj must be"):
        t5.T5Config(feed_forward_proj="gated-relu")


def test_registry_entries():
    from accelerate_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from accelerate_tpu_torch.models import CREATE_BY_FAMILY, MODEL_REGISTRY, create_named_model

    for name in ("t0pp-11b", "t5-tiny", "t5-small", "t5-tiny-v1-0"):
        assert name in MODEL_REGISTRY and name in JAX_REGISTRY
        jcfg = JAX_REGISTRY[name][1]()
        assert MODEL_REGISTRY[name]() == _port_config(jcfg), name
    assert CREATE_BY_FAMILY[t5.T5Config] is t5.create_t5_model
    a = create_named_model("t5-tiny", seed=3, dtype=torch.bfloat16, device="cpu")
    b = create_named_model("t5-tiny", seed=3, dtype=torch.bfloat16, device="cpu")
    for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), key
    cfg = MODEL_REGISTRY["t0pp-11b"]()
    assert (cfg.d_model, cfg.num_layers, cfg.num_heads, cfg.d_ff) == (4096, 24, 64, 10240)
