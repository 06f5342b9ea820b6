"""GPT-NeoX, the second family behind `slot_cache_attention`, through the
port's engine held against the JAX engine on the same weights, at the
shape of JAX's own `test_engine_parity_gpt_neox` (`tests/test_paged_kernel.py`:
vocab 128, hidden 32, 4 heads of 8 with Hq = Hkv, half of each head
rotated, 2 layers): greedy tokens are IDENTICAL, request by request, for
the paged engine (the port's "gather" and "paged_kernel" paths against
JAX's "xla" and "pallas_paged", the latter in interpret mode), the
contiguous engine, the speculative engine and int8 weights over an int8 and
an fp8 cache. Every bias and LayerNorm scale of the carried weights is
moved by seeded noise, so a dropped bias would show.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.gpt_neox import GPTNeoXConfig as JaxConfig, create_gpt_neox_model as jax_create
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher, Request as JaxRequest
from accelerate_tpu_torch.models.gpt_neox import GPTNeoXConfig, create_gpt_neox_model, gpt_neox_state_dict_from_flax
from accelerate_tpu_torch.serving import ContinuousBatcher, Request

VOCAB = 128
_CFG = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            rotary_pct=0.5, max_position_embeddings=64)
COMMON = dict(num_slots=2, max_length=32, chunk_size=4, page_size=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """(JAX Model bundle, port model) on the same weights, biases and norm
    scales moved by normal noise (std 0.1)."""
    jmodel = jax_create(JaxConfig(**_CFG), seq_len=16)
    rng = np.random.default_rng(0)

    def move(path, x):
        x = np.asarray(x)
        return (x + rng.normal(0.0, 0.1, x.shape)).astype(x.dtype) if path[-1].key in ("bias", "scale") else x

    params = jax.tree_util.tree_map_with_path(move, jmodel.params)
    jmodel = dataclasses.replace(jmodel, params=jax.tree_util.tree_map(jnp.asarray, params))
    cfg = GPTNeoXConfig(**_CFG)
    model = create_gpt_neox_model(cfg, device="cpu")
    model.load_state_dict(gpt_neox_state_dict_from_flax(params, cfg))
    return jmodel, model


def _requests(seed, n=4, prompt_hi=12, new_hi=6):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, VOCAB, (int(rng.integers(2, prompt_hi)),)).astype(np.int32),
             int(rng.integers(2, new_hi))) for i in range(n)]


def _repeating(seed, n=4):
    """Prompts that repeat a motif, so the n-gram drafter's drafts are taken."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(1, VOCAB, (5,))
    return [(i, np.tile(motif, 4).astype(np.int32)[: int(rng.integers(8, 16))], 12) for i in range(n)]


def _tokens(out):
    return {rid: list(map(int, t)) for rid, t in out.items()}


@pytest.mark.parametrize(
    "jax_kw,port_impls,reqs",
    [
        (dict(attention_impl="xla"), ("gather", "paged_kernel"), "mixed"),
        (dict(attention_impl="pallas_paged"), ("gather", "paged_kernel"), "mixed"),
        (dict(attention_impl="xla", paged=False), ("gather",), "mixed"),
        (dict(attention_impl="pallas_paged", speculative=True, draft_tokens=3), ("gather", "paged_kernel"),
         "repeating"),
        (dict(attention_impl="pallas_paged", weight_dtype="int8", kv_cache_dtype="int8"),
         ("gather", "paged_kernel"), "mixed"),
        (dict(attention_impl="xla", weight_dtype="int8", kv_cache_dtype="fp8_e4m3"), ("gather", "paged_kernel"),
         "mixed"),
    ],
    ids=["paged-xla", "paged-pallas", "contiguous", "speculative", "w-int8-kv-int8", "w-int8-kv-fp8"],
)
def test_engine_tokens_match_jax_engine(models, jax_kw, port_impls, reqs):
    jmodel, model = models
    reqs = _repeating(9) if reqs == "repeating" else _requests(10)
    kw = {k: v for k, v in jax_kw.items() if k != "attention_impl"}
    jengine = JaxBatcher(jmodel, max_queue=8, attention_impl=jax_kw["attention_impl"], **COMMON, **kw)
    expect = _tokens(jengine.run([JaxRequest(i, p, max_new_tokens=n) for i, p, n in reqs]))
    for impl in port_impls:
        engine = ContinuousBatcher(model, max_queue=8, attention_impl=impl, device="cpu", **COMMON, **kw)
        got = _tokens(engine.run([Request(i, p, max_new_tokens=n) for i, p, n in reqs]))
        assert got == expect, impl
        assert engine.stats["finish_reasons"]["length"] == len(reqs)
        if engine.pool is not None:
            assert engine.pool.pages_in_use == 0 and engine.pool.check_consistency() == []
    if kw.get("speculative"):
        assert engine.stats["speculative"]["accepted"] == jengine.stats["speculative"]["accepted"] > 0


def test_int8_engine_keeps_the_biases_and_shares_them(models):
    """The engine's int8 copy quantizes every projection, biased ones
    included, and keeps each bias in the caller's own storage."""
    _, model = models
    engine = ContinuousBatcher(model, weight_dtype="int8", device="cpu", **COMMON)
    layer = engine.programs.model.layers[0].attention.wq
    assert layer.q.dtype == torch.int8
    assert layer.bias.data_ptr() == model.layers[0].attention.wq.bias.data_ptr()  # the same storage
    assert engine.programs.model.embed_out.bias is None
