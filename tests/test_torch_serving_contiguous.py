"""The serving engine's contiguous layout (``paged=False``) and its
per-request repetition penalty (``use_repetition_penalty``,
`Request.repetition_penalty`), held against the JAX engine on the same
weights: greedy tokens must be IDENTICAL, request by request, over a mixed
wave with slot reuse, plain and speculative, and with penalties in both
layouts. The refusals use the JAX engine's words.
"""

import logging

import numpy as np
import pytest
import torch

import jax

from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig, create_llama_model as jax_create
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher, Request as JaxRequest
from accelerate_tpu_torch.generation import GenerationConfig, Generator
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model, llama_state_dict_from_flax
from accelerate_tpu_torch.serving import ContinuousBatcher, Request

VOCAB = 128
_CFG = dict(
    vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
    rope_theta=10000.0,
)
COMMON = dict(num_slots=2, max_length=48, chunk_size=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """(JAX Model bundle, port model) on the same random weights."""
    jmodel = jax_create(JaxLlamaConfig(**_CFG), seq_len=32)
    cfg = LlamaConfig(**_CFG)
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(
        llama_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jmodel.params), cfg)
    )
    return jmodel, model


def _wave(seed, n=6, penalties=None):
    rng = np.random.default_rng(seed)
    return [
        (i, rng.integers(1, VOCAB, (int(rng.integers(3, 14)),)).astype(np.int32), int(rng.integers(2, 11)),
         1.0 if penalties is None else penalties[i % len(penalties)])
        for i in range(n)
    ]


def _run_jax(jmodel, wave, **kw):
    engine = JaxBatcher(jmodel, max_queue=len(wave) + 2, **COMMON, **kw)
    out = engine.run([JaxRequest(i, p, max_new_tokens=n, repetition_penalty=r) for i, p, n, r in wave])
    return engine, {rid: list(map(int, t)) for rid, t in out.items()}


def _run_port(model, wave, **kw):
    engine = ContinuousBatcher(model, max_queue=len(wave) + 2, device="cpu", **COMMON, **kw)
    out = engine.run([Request(i, p, max_new_tokens=n, repetition_penalty=r) for i, p, n, r in wave])
    return engine, {rid: list(map(int, t)) for rid, t in out.items()}


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "speculative"])
def test_contiguous_greedy_matches_jax_and_paged_engine(models, speculative):
    """Mixed prompts and budgets through two slots, so slots are reused
    over a previous occupant's stale rows: the contiguous engine gives the
    JAX contiguous engine's tokens and the port's paged engine's."""
    jmodel, model = models
    wave = _wave(1)
    spec = dict(speculative=True, draft_tokens=3) if speculative else {}
    _, expect = _run_jax(jmodel, wave, paged=False, **spec)
    engine, got = _run_port(model, wave, paged=False, **spec)
    assert got == expect
    assert engine.attention_impl == "gather" and "pages_total" not in engine.stats
    assert engine.stats["finish_reasons"]["length"] == len(wave)
    _, paged = _run_port(model, wave, page_size=8, **spec)
    assert paged == got


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_repetition_penalty_per_request_matches_jax(models, paged):
    """Per-request penalties (1.0 among them) in one engine: the tokens equal
    the JAX engine's, and each request's equal the port's `Generator` with
    that penalty on the prompt alone."""
    jmodel, model = models
    wave = _wave(2, penalties=(1.7, 1.0, 1.3, 0.8))
    _, expect = _run_jax(jmodel, wave, paged=paged, use_repetition_penalty=True)
    engine, got = _run_port(model, wave, paged=paged, use_repetition_penalty=True)
    assert got == expect
    gen = Generator(model, max_length=COMMON["max_length"], device="cpu")
    for i, p, n, r in wave:
        alone = gen(p[None], GenerationConfig(max_new_tokens=n, repetition_penalty=r))
        assert alone[0, p.size:].tolist() == got[i]
    _, plain = _run_port(model, wave, paged=paged)
    assert plain != got  # the penalties changed something


def test_penalty_engine_runs_without_prefix_cache(models, caplog):
    _, model = models
    with caplog.at_level(logging.INFO, logger="accelerate_tpu_torch.serving"):
        engine = ContinuousBatcher(model, use_repetition_penalty=True, device="cpu", **COMMON)
    assert not engine.use_prefix_cache and engine.stats["prefix_cache"]["enabled"] is False
    assert "prefix cache disabled: use_repetition_penalty needs whole-prompt" in caplog.text
    assert ContinuousBatcher(model, device="cpu", **COMMON).use_prefix_cache


def test_refusals_use_jax_words(models):
    _, model = models
    with pytest.raises(ValueError, match="does not compose with use_repetition_penalty"):
        ContinuousBatcher(model, speculative=True, use_repetition_penalty=True, device="cpu", **COMMON)
    with pytest.raises(ValueError, match="requires the paged KV cache"):
        ContinuousBatcher(model, paged=False, attention_impl="paged_kernel", device="cpu", **COMMON)
    for kv in ("int8", "fp8_e4m3"):
        with pytest.raises(ValueError, match="a quantized KV cache requires the paged layout"):
            ContinuousBatcher(model, paged=False, kv_cache_dtype=kv, device="cpu", **COMMON)
    assert ContinuousBatcher(model, device="cpu", **COMMON).attention_impl == "paged_kernel"
    assert ContinuousBatcher(model, paged=False, device="cpu", **COMMON).attention_impl == "gather"


def test_contiguous_kv_cache_nbytes_matches_jax(models):
    jmodel, model = models
    jengine = JaxBatcher(jmodel, paged=False, **COMMON)
    engine = ContinuousBatcher(model, paged=False, device="cpu", **COMMON)
    assert engine.kv_cache_nbytes == jengine.kv_cache_nbytes
    cfg = model.config
    assert engine.kv_cache_nbytes == (
        2 * cfg.num_hidden_layers * COMMON["num_slots"] * COMMON["max_length"]
        * cfg.num_key_value_heads * cfg.head_dim * 4
    )


def test_failed_chunk_clears_presence_and_engine_recovers(models, monkeypatch):
    """A chunk that raises errors its in-flight requests and rebuilds the
    cache and the presence rows; the next request's tokens are as on a
    fresh engine."""
    _, model = models
    wave = _wave(3, n=2, penalties=(1.5,))
    engine = ContinuousBatcher(model, paged=False, use_repetition_penalty=True, device="cpu", **COMMON)
    step = engine.programs.step
    calls = []

    def failing_step(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return step(*args)

    monkeypatch.setattr(engine.programs, "step", failing_step)
    for i, p, n, r in wave:
        engine.submit(Request(i, p, max_new_tokens=n + 4, repetition_penalty=r))
    engine.step()
    assert {r.finish_reason for r in engine.results.values()} == {"error"}
    assert not engine._presence.any()
    i, p, n, r = _wave(4, n=1, penalties=(1.5,))[0]
    got = engine.run([Request(10, p, max_new_tokens=n, repetition_penalty=r)])[10].tolist()
    _, fresh = _run_port(model, [(10, p, n, r)], paged=False, use_repetition_penalty=True)
    assert got == fresh[10]
