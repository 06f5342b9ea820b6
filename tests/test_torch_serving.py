"""The port's serving engine (`accelerate_tpu_torch.serving.ContinuousBatcher`)
held against the JAX engine on the same weights: greedy tokens must be
IDENTICAL, request by request, across page sizes, prompt/budget mixes, a
wave of prefix-cache hits, speculative decoding (the block-verify path) and
EOS mid-stream. The JAX engine runs on the CPU with both of its attention
paths (`"pallas_paged"` in interpret mode, and the `"xla"` oracle); the port
runs `device="cpu"`, where its `"paged_kernel"` path takes the kernels'
plain versions.

Also here: the speculative primitives against JAX's, the sampler's
properties, and the engine's host-plane surface.
"""

import numpy as np
import pytest
import torch

import jax

from accelerate_tpu import paging as jax_paging
from accelerate_tpu import speculative as jax_spec
from accelerate_tpu.generation import _bucket_for as jax_bucket_for, _trim_at_eos as jax_trim_at_eos
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig, create_llama_model as jax_create
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher, Request as JaxRequest
from accelerate_tpu_torch import paging as port_paging
from accelerate_tpu_torch import speculative as port_spec
from accelerate_tpu_torch.generation import GenerationConfig, _bucket_for, _sample, _trim_at_eos
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model, llama_state_dict_from_flax
from accelerate_tpu_torch.serving import (
    FINISH_REASONS,
    ContinuousBatcher,
    EngineClosed,
    QueueFull,
    Request,
)

torch.set_num_threads(2)

VOCAB = 128
_CFG = dict(
    vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
    rope_theta=10000.0,
)


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


def _mixed(seed, n, prompt_lo=3, prompt_hi=20, new_lo=2, new_hi=10):
    rng = np.random.default_rng(seed)
    return [
        (i, rng.integers(1, VOCAB, (int(rng.integers(prompt_lo, prompt_hi)),)).astype(np.int32),
         int(rng.integers(new_lo, new_hi)))
        for i in range(n)
    ]


def _run_jax(jmodel, reqs, eos=None, **kw):
    engine = JaxBatcher(jmodel, max_queue=len(reqs) + 2, **kw)
    out = engine.run([JaxRequest(i, p, max_new_tokens=n, eos_token_id=eos) for i, p, n in reqs])
    return engine, {rid: list(map(int, t)) for rid, t in out.items()}


def _run_port(model, reqs, eos=None, **kw):
    engine = ContinuousBatcher(model, max_queue=len(reqs) + 2, device="cpu", **kw)
    out = engine.run([Request(i, p, max_new_tokens=n, eos_token_id=eos) for i, p, n in reqs])
    return engine, {rid: list(map(int, t)) for rid, t in out.items()}


@pytest.mark.parametrize(
    "page_size,jax_impl", [(4, "pallas_paged"), (8, "xla"), (16, "pallas_paged")]
)
def test_greedy_tokens_match_jax_engine(models, page_size, jax_impl):
    """Mixed prompt lengths and budgets, two slots so admissions interleave
    with decode: both port paths give the JAX engine's tokens exactly."""
    jmodel, model = models
    reqs = _mixed(page_size, 6)
    common = dict(num_slots=2, max_length=64, chunk_size=4, page_size=page_size)
    _, expect = _run_jax(jmodel, reqs, attention_impl=jax_impl, **common)
    for impl in ("paged_kernel", "gather"):
        engine, got = _run_port(model, reqs, attention_impl=impl, **common)
        assert got == expect, impl
        assert engine.stats["finish_reasons"]["length"] == len(reqs)
        assert engine.pool.pages_in_use == 0 and engine.pool.check_consistency() == []


def test_prefix_cache_wave_matches_jax_engine(models):
    """Wave 2 reuses wave 1's registered system-prompt pages: the port hits
    the cache exactly as often as the JAX engine and emits the same tokens."""
    jmodel, model = models
    rng = np.random.default_rng(8)
    system = rng.integers(1, VOCAB, (9,)).astype(np.int32)
    waves = [
        [(w * 4 + i, np.concatenate([system, rng.integers(1, VOCAB, (3 + i,)).astype(np.int32)]), 5)
         for i in range(4)]
        for w in range(2)
    ]
    common = dict(num_slots=2, max_length=64, chunk_size=4, page_size=4)
    jengine = JaxBatcher(jmodel, attention_impl="pallas_paged", max_queue=16, **common)
    pengine = ContinuousBatcher(model, attention_impl="paged_kernel", max_queue=16, device="cpu", **common)
    for wave in waves:
        expect = jengine.run([JaxRequest(i, p, max_new_tokens=n) for i, p, n in wave])
        got = pengine.run([Request(i, p, max_new_tokens=n) for i, p, n in wave])
        assert {k: list(map(int, v)) for k, v in got.items()} == {k: list(map(int, v)) for k, v in expect.items()}
    assert pengine.pool.check_consistency() == []
    hits = pengine.stats["prefix_cache"]["hits"]
    assert hits > 0 and hits == jengine.stats["prefix_cache"]["hits"]
    assert pengine.stats["prefix_cache"]["prefill_tokens_saved"] == jengine.stats["prefix_cache"]["prefill_tokens_saved"]


def test_speculative_matches_jax_engine_and_plain_decode(models):
    """Speculative decoding through the block-verify path: the port's spec
    run equals the JAX spec run and the port's plain run token for token,
    with drafts really accepted."""
    jmodel, model = models
    rng = np.random.default_rng(9)
    motif = rng.integers(1, VOCAB, (5,))
    reqs = [(i, np.tile(motif, 4).astype(np.int32)[: int(rng.integers(8, 16))], 24) for i in range(4)]
    common = dict(num_slots=2, max_length=64, chunk_size=3, page_size=4)
    jengine, expect = _run_jax(jmodel, reqs, speculative=True, draft_tokens=3, attention_impl="pallas_paged", **common)
    engine, got = _run_port(model, reqs, speculative=True, draft_tokens=3, **common)
    _, plain = _run_port(model, reqs, **common)
    assert got == expect == plain
    spec, jspec = engine.stats["speculative"], jengine.stats["speculative"]
    assert spec["verify_steps"] > 0 and spec["accepted"] > 0
    for key in ("verify_steps", "drafted", "accepted", "rejected"):
        assert spec[key] == jspec[key], key


@pytest.mark.parametrize("speculative", [False, True])
def test_eos_mid_stream_matches_jax_engine(models, speculative):
    """An EOS id taken from the middle of a greedy stream ends that request
    there (EOS kept) on both engines, plain and speculative alike."""
    jmodel, model = models
    reqs = _mixed(11, 4, new_lo=8, new_hi=12)
    common = dict(num_slots=2, max_length=64, chunk_size=4, page_size=8)
    if speculative:
        common.update(speculative=True, draft_tokens=4)
    _, free_run = _run_port(model, reqs, **common)
    eos = free_run[0][3]
    _, expect = _run_jax(jmodel, reqs, eos=eos, attention_impl="pallas_paged", **common)
    engine, got = _run_port(model, reqs, eos=eos, **common)
    assert got == expect
    assert got[0] == free_run[0][: free_run[0].index(eos) + 1]
    assert engine.results[0].finish_reason == "eos"
    reasons = engine.stats["finish_reasons"]
    assert reasons["eos"] >= 1 and reasons["eos"] + reasons["length"] == len(reqs)


def test_page_pool_copy_matches_jax():
    """The port's own copy of the page allocator and prefix cache hands out
    the same pages as JAX's under one random stream of reserves, prefix
    matches, registrations and releases (evictions included), and keeps its
    ledger consistent throughout."""
    rng = np.random.default_rng(13)
    pools = [port_paging.PagePool(12, 4), jax_paging.PagePool(12, 4)]
    prompts = [rng.integers(0, 3, (int(rng.integers(4, 17)),)) for _ in range(6)]
    assert port_paging.chain_hashes(prompts[0], 4) == jax_paging.chain_hashes(prompts[0], 4)
    held = [[], []]
    for step in range(200):
        op = rng.integers(0, 3)
        prompt = prompts[int(rng.integers(0, len(prompts)))]
        for side, pool in enumerate(pools):
            state = np.random.default_rng(step)
            if op == 0 or not held[side]:
                hashes = port_paging.chain_hashes(prompt, 4)
                shared = pool.match_prefix(hashes, len(hashes))
                private = pool.reserve(int(state.integers(0, 3)))
                if private is None:
                    pool.release(shared)
                    continue
                pages = shared + private
                pool.register_prefix(hashes[: len(pages)], pages, start=len(shared))
                held[side].append(pages)
            else:
                pool.release(held[side].pop(int(state.integers(0, len(held[side])))))
            assert pool.check_consistency() == []
        assert held[0] == held[1]
    assert pools[0].evictions == pools[1].evictions > 0
    assert (pools[0].pages_in_use, pools[0].pages_cached) == (pools[1].pages_in_use, pools[1].pages_cached)


@pytest.mark.parametrize("k,m", [(1, 1), (3, 2), (5, 3)])
def test_speculative_primitives_match_jax(k, m):
    """`propose_ngram_drafts` and `greedy_accept_length` against JAX's on
    histories over a small alphabet (so n-grams recur), with observed
    lengths from 0 to the whole row."""
    b, h = 6, 24
    for seed in range(12):
        rng = np.random.default_rng(seed)
        history = rng.integers(0, 4, (b, h)).astype(np.int32)
        hist_len = rng.integers(0, h + 1, (b,)).astype(np.int32)
        hist_len[:2] = (0, h)
        jd, jv = jax_spec.propose_ngram_drafts(history, hist_len, k, m)
        pd, pv = port_spec.propose_ngram_drafts(torch.as_tensor(history).long(), torch.as_tensor(hist_len), k, m)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        targets = np.where(rng.random((b, k)) < 0.7, np.asarray(jd), rng.integers(0, 4, (b, k))).astype(np.int32)
        expect = jax_spec.greedy_accept_length(np.asarray(jd), targets, np.asarray(jv))
        got = port_spec.greedy_accept_length(pd, torch.as_tensor(targets).long(), pv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("seed", range(6))
def test_sampler_properties(seed):
    """Greedy takes the first of tied maxima (as `jnp.argmax`); top-k samples
    stay inside the k best logits; top-p samples stay inside the smallest
    prefix of the descending order whose mass before them is under top_p, and
    a tiny top_p leaves only the top token. Each seed draws its own logits,
    top_k, top_p and temperature."""
    rng = np.random.default_rng(seed)
    logits = torch.as_tensor(rng.normal(size=(4, 16)).astype(np.float32))
    tied = logits.clone()
    tied[:, 3] = tied[:, 9] = tied.max() + 1.0
    assert _sample(tied, GenerationConfig(), None, 1.0).tolist() == [3] * 4
    gen = torch.Generator().manual_seed(seed)
    for _ in range(5):
        top_k, top_p = int(rng.integers(1, 7)), float(rng.uniform(0.0, 0.999))
        temperature = float(rng.uniform(0.3, 1.5))
        allowed = torch.topk(logits, top_k, dim=-1).indices
        tok = _sample(logits, GenerationConfig(do_sample=True, top_k=top_k), gen, temperature)
        assert (allowed == tok[:, None]).any(dim=-1).all()
        probs = torch.softmax(logits / temperature, -1)
        order = torch.argsort(probs, dim=-1, descending=True)
        mass_before = torch.cumsum(probs.gather(1, order), -1) - probs.gather(1, order)
        tok = _sample(logits, GenerationConfig(do_sample=True, top_p=top_p), gen, temperature)
        rank = (order == tok[:, None]).float().argmax(-1)
        assert (rank == 0).logical_or(mass_before.gather(1, rank[:, None])[:, 0] < top_p).all()
    tiny = GenerationConfig(do_sample=True, top_p=1e-9)
    assert torch.equal(_sample(logits, tiny, gen, 1.0), logits.argmax(-1))


def test_generation_helpers_match_jax():
    for n in (1, 2, 3, 5, 8, 9, 100):
        assert _bucket_for(n) == jax_bucket_for(n)
    toks = np.array([[5, 2, 9, 9], [2, 1, 1, 1]])
    np.testing.assert_array_equal(_trim_at_eos(toks, 2, 4), jax_trim_at_eos(toks, 2, 4))
    np.testing.assert_array_equal(_trim_at_eos(toks, 7, 4), jax_trim_at_eos(toks, 7, 4))


def test_sampled_engine_is_reproducible_from_its_seed(models):
    _, model = models
    reqs = _mixed(12, 3)
    common = dict(num_slots=2, max_length=64, chunk_size=4, page_size=4, do_sample=True, top_k=8, seed=5)
    assert _run_port(model, reqs, **common)[1] == _run_port(model, reqs, **common)[1]


def test_engine_surface_and_lifecycle(models):
    """submit validation, backpressure, cancel, deadlines, release, drain
    and close, on the port engine."""
    _, model = models
    engine = ContinuousBatcher(model, num_slots=1, max_length=32, chunk_size=2, page_size=4,
                               max_queue=2, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        engine.submit(Request(0, []))
    with pytest.raises(ValueError, match="capacity"):
        engine.submit(Request(0, [1] * 30, max_new_tokens=5))
    with pytest.raises(ValueError, match="token ids"):
        engine.submit(Request(0, [VOCAB], max_new_tokens=2))
    engine.submit(Request(0, [1, 2, 3], max_new_tokens=6))
    engine.submit(Request(1, [4, 5], max_new_tokens=6))
    with pytest.raises(QueueFull):
        engine.submit(Request(2, [6], max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        engine.submit(Request(1, [6], max_new_tokens=2))
    events = engine.step()
    assert events[0][0] == 0 and engine.free_slots == 0
    assert engine.cancel(1) and engine.results[1].finish_reason == "cancelled"
    engine.submit(Request(3, [7, 8], max_new_tokens=20, deadline_s=0.0))
    results = engine.drain()
    assert results[0].finish_reason == "length" and len(results[0].tokens) == 6
    assert results[3].finish_reason == "timeout"
    assert engine.release(0).request_id == 0 and 0 not in engine.results
    engine.submit(Request(4, [9, 10], max_new_tokens=8))
    engine.step()
    engine.close()
    assert engine.results[4].finish_reason == "cancelled" and engine.closed
    with pytest.raises(EngineClosed):
        engine.submit(Request(5, [1], max_new_tokens=2))
    assert set(engine.stats["finish_reasons"]) == set(FINISH_REASONS)


def test_failures_are_isolated(models, monkeypatch):
    """A failed insert errors only its request; a failed chunk errors the
    requests in flight, rebuilds the pools, and the engine keeps serving."""
    _, model = models
    engine = ContinuousBatcher(model, num_slots=2, max_length=32, chunk_size=2, page_size=4,
                               device="cpu")
    real_prefill = engine.programs.prefill
    calls = {"n": 0}

    def flaky_prefill(*args):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected insert fault")
        return real_prefill(*args)

    monkeypatch.setattr(engine.programs, "prefill", flaky_prefill)
    out = engine.run([Request(0, [1, 2, 3], max_new_tokens=4), Request(1, [4, 5], max_new_tokens=4)])
    assert engine.results[0].finish_reason == "error" and "injected" in engine.results[0].error
    assert engine.results[1].finish_reason == "length" and len(out[1]) == 4

    def broken_step(*args):
        raise RuntimeError("injected chunk fault")

    monkeypatch.setattr(engine.programs, "step", broken_step)
    engine.submit(Request(2, [6, 7], max_new_tokens=4))
    engine.step()
    assert engine.results[2].finish_reason == "error" and engine.pool.pages_in_use == 0
    monkeypatch.undo()
    engine.submit(Request(3, [6, 7], max_new_tokens=3))
    engine.drain()
    assert engine.results[3].finish_reason == "length" and len(engine.results[3].tokens) == 3


def test_the_card_is_the_default_device(models, monkeypatch):
    """With no CUDA device, an engine asked for no device raises instead of
    quietly serving on the CPU; bad options raise at construction."""
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(model)
    with pytest.raises(ValueError, match="speculative"):
        ContinuousBatcher(model, speculative=True, do_sample=True, device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        ContinuousBatcher(model, attention_impl="pallas_paged", device="cpu")
