"""The port's `generate` and static `Generator` held against the JAX
package's on carried-across weights: greedy tokens must be IDENTICAL, row for
row, for uniform and left-padded batches, with EOS and pad fill, with a
repetition penalty, and with speculative decoding at draft_tokens 1-4. Both
sides run f32 on the CPU (torch at one thread); inputs come from numpy
seeds.

Sampled draws are not compared with JAX's: the two random generators
(`torch.Generator`, JAX's threefry keys) differ, so the same seed draws
different tokens. Sampling is held to its own properties instead: a seed
repeats, top_p near 0 and top_k = 1 give the greedy tokens, and every draw
lies in the top-k of its step's logits.
"""

import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import generation as jax_generation
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig, create_llama_model as jax_create
from accelerate_tpu_torch import generation
from accelerate_tpu_torch.generation import GenerationConfig, Generator, _apply_repetition_penalty, generate
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model, llama_state_dict_from_flax
from accelerate_tpu_torch.ops.attention import DecodeCache, decode_cache_mask

VOCAB = 128
MAX_LEN = 64
_CFG = dict(
    vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=MAX_LEN,
    rope_theta=10000.0,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Exact comparisons on one thread (a second OpenMP thread can move
    `torch.exp` by an ulp under load)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """(JAX Model bundle, JAX Generator, port model, port Generator) on the
    same random weights."""
    jmodel = jax_create(JaxLlamaConfig(**_CFG), seq_len=32)
    cfg = LlamaConfig(**_CFG)
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(
        llama_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jmodel.params), cfg)
    )
    return jmodel, jax_generation.Generator(jmodel), model, Generator(model, device="cpu")


def _prompts(seed, b, n):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, n)).astype(np.int32)


def _left_padded(seed, lengths, width):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for row, n in enumerate(lengths):
        ids[row, width - n:] = rng.integers(1, VOCAB, (n,))
        mask[row, width - n:] = 1
    return ids, mask


def _jax(jgen, ids, mask=None, **cfg):
    return np.asarray(jgen(jnp.asarray(ids), jax_generation.GenerationConfig(**cfg), attention_mask=mask))


def _port(gen, ids, mask=None, **cfg):
    out = gen(ids, GenerationConfig(**cfg), attention_mask=mask)
    assert out.device.type == "cpu" and out.dtype == torch.long
    return out.numpy()


def _full_context_greedy(model, ids, n):
    """Reference: the full causal forward over the growing context each step."""
    ids = torch.as_tensor(ids, dtype=torch.long)
    with torch.no_grad():
        for _ in range(n):
            ids = torch.cat([ids, model(ids)[:, -1].argmax(-1)[:, None]], dim=1)
    return ids.numpy()


def test_greedy_generate_matches_jax_and_full_context(models):
    jmodel, _, model, _ = models
    ids = _prompts(0, 3, 9)
    got = generate(model, ids, max_new_tokens=13, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_generation.generate(jmodel, ids, max_new_tokens=13)))
    np.testing.assert_array_equal(got, _full_context_greedy(model, ids, 13))


def test_left_padded_ragged_batch_matches_jax_and_each_row_alone(models):
    _, jgen, _, gen = models
    ids, mask = _left_padded(1, (4, 9, 6), 9)
    got = _port(gen, ids, mask, max_new_tokens=10)
    np.testing.assert_array_equal(got, _jax(jgen, ids, mask, max_new_tokens=10))
    for row in range(3):
        n = int(mask[row].sum())
        alone = _port(gen, ids[row:row + 1, 9 - n:], max_new_tokens=10)
        np.testing.assert_array_equal(got[row, 9:], alone[0, n:])


def test_eos_stop_pad_fill_and_trim_match_jax(models):
    """Row 0 hits EOS early and is padded with pad_token_id while row 1 runs
    on; the output is cut after the step where both have finished, as
    JAX's. With no pad_token_id the fill is the EOS itself."""
    _, jgen, _, gen = models
    ids = _prompts(2, 2, 7)
    free = _port(gen, ids, max_new_tokens=20)[:, 7:]
    eos = int(free[0, 3])
    assert eos not in free[1, :5].tolist()
    for pad in (0, None):
        got = _port(gen, ids, max_new_tokens=20, eos_token_id=eos, pad_token_id=pad)
        np.testing.assert_array_equal(
            got, _jax(jgen, ids, max_new_tokens=20, eos_token_id=eos, pad_token_id=pad)
        )
        gen_part = got[:, 7:]
        first = int(np.argmax(gen_part[0] == eos))
        assert (gen_part[0, first + 1:] == (eos if pad is None else pad)).all()
    # Both rows emit the EOS, at different steps: the output stops after the
    # later one.
    ids = _prompts(14, 2, 7)
    free = _port(gen, ids, max_new_tokens=20)[:, 7:]
    eos = next(int(t) for t in free[0] if t in free[1] and np.argmax(free[0] == t) != np.argmax(free[1] == t))
    got = _port(gen, ids, max_new_tokens=20, eos_token_id=eos)
    np.testing.assert_array_equal(got, _jax(jgen, ids, max_new_tokens=20, eos_token_id=eos))
    last = max(int(np.argmax(free[row] == eos)) for row in range(2))
    assert got.shape == (2, 7 + last + 1)


def test_repetition_penalty_matches_jax_plain_and_left_padded(models):
    _, jgen, _, gen = models
    ids = _prompts(3, 2, 6)
    for penalty in (1.3, 0.8):
        got = _port(gen, ids, max_new_tokens=16, repetition_penalty=penalty)
        np.testing.assert_array_equal(got, _jax(jgen, ids, max_new_tokens=16, repetition_penalty=penalty))
    plain = _port(gen, ids, max_new_tokens=16)
    assert not np.array_equal(plain, _port(gen, ids, max_new_tokens=16, repetition_penalty=5.0))
    # Left pads (id 0) must not seed the seen set: each row as alone.
    pids, mask = _left_padded(4, (4, 7), 7)
    got = _port(gen, pids, mask, max_new_tokens=8, repetition_penalty=2.5)
    np.testing.assert_array_equal(got, _jax(jgen, pids, mask, max_new_tokens=8, repetition_penalty=2.5))
    for row, n in enumerate((4, 7)):
        alone = _port(gen, pids[row:row + 1, 7 - n:], max_new_tokens=8, repetition_penalty=2.5)
        np.testing.assert_array_equal(got[row, 7:], alone[0, n:])


def test_apply_repetition_penalty_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 50)).astype(np.float32)
    seen = rng.random((3, 50)) < 0.3
    for penalty in (1.7, 0.6):
        ref = np.asarray(jax_generation._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), penalty))
        got = _apply_repetition_penalty(torch.as_tensor(logits), torch.as_tensor(seen), penalty)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("draft_tokens", [1, 2, 3, 4])
def test_speculative_matches_plain_loop_and_jax(models, draft_tokens, monkeypatch):
    """Batch 1 on a prompt whose continuation cycles (drafts get accepted),
    batch 2 (the lockstep minimum), a ragged left-padded batch, and EOS
    emitted in a block that accepted drafts: all equal the plain loop and
    JAX's speculative loop."""
    _, jgen, _, gen = models
    k = dict(draft_tokens=draft_tokens)
    cycling = _prompts(13, 1, 8)
    cases = [
        (cycling, None, 24),
        (_prompts(7, 2, 8), None, 16),
        (*_left_padded(8, (5, 8), 8), 12),
    ]
    for ids, mask, n in cases:
        plain = _port(gen, ids, mask, max_new_tokens=n)
        got = _port(gen, ids, mask, max_new_tokens=n, **k)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, _jax(jgen, ids, mask, max_new_tokens=n, **k))
    rewinds = []
    rewind = DecodeCache.rewind
    monkeypatch.setattr(DecodeCache, "rewind", lambda self, d: (rewinds.append(d), rewind(self, d)))
    free = _port(gen, cycling, max_new_tokens=24)[0, 8:]
    eos = int(free[6])
    assert eos not in free[:6].tolist()
    plain = _port(gen, cycling, max_new_tokens=24, eos_token_id=eos)
    got = _port(gen, cycling, max_new_tokens=24, eos_token_id=eos, **k)
    assert rewinds[-1] < draft_tokens  # the block that emitted the EOS accepted a draft
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _jax(jgen, cycling, max_new_tokens=24, eos_token_id=eos, **k))


def test_speculative_at_cache_capacity_matches_plain_loop(models):
    """A budget that fills the cache: the last verify block runs past it.
    The port keeps the block's rows that fit (the rest are drafts no emitted
    token reads), so its tokens equal the plain loop's. JAX's loop clamps
    the block's start instead and diverges here (a fault of the reference),
    so this case is held to the plain loop only."""
    _, _, model, _ = models
    gen = Generator(model, max_length=24, device="cpu")
    for seed in range(4):
        motif = _prompts(seed, 1, 3)
        ids = np.tile(motif, 3)[:, :8]
        plain = _port(gen, ids, max_new_tokens=16)
        for draft_tokens in (2, 4):
            np.testing.assert_array_equal(_port(gen, ids, max_new_tokens=16, draft_tokens=draft_tokens), plain)


def test_refusals_use_jax_words(models):
    _, _, model, gen = models
    ids = _prompts(9, 1, 6)
    with pytest.raises(ValueError, match="greedy-only"):
        gen(ids, GenerationConfig(max_new_tokens=4, draft_tokens=2, do_sample=True))
    with pytest.raises(ValueError, match="repetition_penalty"):
        gen(ids, GenerationConfig(max_new_tokens=4, draft_tokens=2, repetition_penalty=1.5))
    right = np.ones((1, 6), np.int32)
    right[0, -2:] = 0
    with pytest.raises(ValueError, match="LEFT-padding"):
        gen(ids, GenerationConfig(max_new_tokens=2), attention_mask=right)
    with pytest.raises(ValueError, match=r"attention_mask must be \[batch, prompt_len\]"):
        gen(ids, GenerationConfig(max_new_tokens=2), attention_mask=np.ones((1, 5), np.int32))
    small = Generator(model, max_length=8, device="cpu")
    with pytest.raises(ValueError, match="leaves no room in the 8-token cache"):
        small(_prompts(9, 1, 8), GenerationConfig(max_new_tokens=2))
    # A budget past the cache is cut to what fits, as JAX's.
    assert small(_prompts(9, 1, 5), GenerationConfig(max_new_tokens=10)).shape == (1, 8)
    cache = model.make_decode_cache(1, 8)
    with pytest.raises(ValueError, match="rank-3 mask"):
        decode_cache_mask(cache, 2, torch.ones((1, 1, 2), dtype=torch.bool))


def test_decode_cache_index_mask_and_rewind():
    """The shared write index advances by each block, the mask stops at the
    written prefix and ANDs in the persisted pad mask, and a rewind moves
    the next write back."""
    cache = DecodeCache.create(1, 2, 8, 1, 4, torch.float32, "cpu")
    pad = torch.tensor([[0, 1, 1], [1, 1, 1]])
    mask = decode_cache_mask(cache, 3, pad)
    assert mask.shape == (2, 1, 3, 3)
    assert mask[0, 0, :, 0].tolist() == [False] * 3
    assert torch.equal(mask[1, 0], torch.ones(3, 3, dtype=torch.bool).tril())
    cache.index = 3
    step = decode_cache_mask(cache, 2)
    assert step.shape == (2, 1, 2, 5)
    assert step[0, 0, 0].tolist() == [False, True, True, True, False]
    cache.rewind(1)
    assert cache.index == 2


def test_sampling_seeds_and_filters(models):
    _, _, model, gen = models
    ids = _prompts(10, 2, 6)
    greedy = _port(gen, ids, max_new_tokens=10)

    def draw(seed, **cfg):
        rng = torch.Generator().manual_seed(seed)
        return gen(ids, GenerationConfig(max_new_tokens=10, do_sample=True, **cfg), rng=rng).numpy()

    np.testing.assert_array_equal(draw(3, temperature=1.5), draw(3, temperature=1.5))
    assert not np.array_equal(draw(3, temperature=1.5), draw(4, temperature=1.5))
    # The default generator is seeded 0 on every call.
    cfg = GenerationConfig(max_new_tokens=10, do_sample=True)
    np.testing.assert_array_equal(gen(ids, cfg).numpy(), gen(ids, cfg).numpy())
    np.testing.assert_array_equal(draw(5, top_p=1e-9), greedy)
    np.testing.assert_array_equal(draw(5, top_k=1), greedy)
    # Every draw lies in the top-3 of its step's logits.
    out = torch.as_tensor(draw(6, top_k=3, temperature=2.0))
    with torch.no_grad():
        logits = model(out)[:, 5:-1]
    top3 = logits.topk(3, dim=-1).indices
    assert (top3 == out[:, 6:, None]).any(-1).all()


def test_generate_reuses_one_generator_per_live_model(models, monkeypatch):
    _, _, model, _ = models
    generation._GENERATOR_CACHE.clear()
    builds = []
    init = Generator.__init__

    def counting_init(self, *args, **kwargs):
        builds.append(1)
        init(self, *args, **kwargs)

    monkeypatch.setattr(Generator, "__init__", counting_init)
    ids = _prompts(11, 1, 6)
    a = generate(model, ids, max_new_tokens=5, device="cpu")
    b = generate(model, ids, max_new_tokens=9, device="cpu")
    assert len(builds) == 1
    np.testing.assert_array_equal(a.numpy(), b.numpy()[:, :11])
    other = create_llama_model(LlamaConfig(**_CFG), seed=3, device="cpu")
    generate(other, ids, max_new_tokens=5, device="cpu")
    assert len(builds) == 2 and len(generation._GENERATOR_CACHE) == 2
    del other
    gc.collect()
    assert len(generation._GENERATOR_CACHE) == 1
    generation._GENERATOR_CACHE.clear()


def test_generator_runs_on_the_card_unless_asked(models):
    _, _, model, _ = models
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="the model lives on cpu"):
            Generator(model)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Generator(model)


def test_loops_read_the_device_back_rarely(models, monkeypatch):
    """The plain loop reads "every row finished?" at most once every 8
    steps (and never without an EOS); the speculative loop once per verify
    dispatch. Counted as tensor-to-host conversions inside the loops."""
    _, _, _, gen = models
    reads = []
    for name in ("__bool__", "__int__", "item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counting(self, *a, _orig=orig, **kw):
            reads.append(1)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    ids = _prompts(12, 2, 6)
    _port(gen, ids, max_new_tokens=32)
    assert len(reads) == 0
    _port(gen, ids, max_new_tokens=32, eos_token_id=VOCAB + 1)  # never hit
    assert len(reads) <= 31 // 8
    reads.clear()
    rewinds = []
    rewind = DecodeCache.rewind
    monkeypatch.setattr(DecodeCache, "rewind", lambda self, d: (rewinds.append(d), rewind(self, d)))
    _port(gen, ids, max_new_tokens=32, draft_tokens=3)
    assert len(reads) == len(rewinds) > 0  # one read per verify dispatch
