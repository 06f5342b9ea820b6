"""Quantized serving in the port (`accelerate_tpu_torch.ops.quantization`, the
paged kernels' fused-dequant mode, the quantized `ContinuousBatcher`) held
against the JAX package on the same numpy inputs and carried-across weights.

Tolerances:
  - int8/fp8 codes EQUAL and scales within rtol 1e-6: both sides run the same
    f32 divisions, roundings (half to even) and saturating casts;
  - the plain quantized K1/K2 against JAX's Pallas kernels in interpret mode:
    f32 atol 2e-5, the JAX test's own (`tests/test_quantization.py`): the
    same dequantized values, summed in another order;
  - greedy tokens of the port engine EQUAL the JAX engine's;
  - step-program logits over one token sequence: f32 atol 2e-2 with an int8
    cache and 5e-2 with fp8, a tenth of JAX's own quantization budgets (0.25
    and 0.45). The two sides differ by the f32 GEMM summation order, which
    can move a K/V value across a rounding boundary of its code.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
    create_llama_model as jax_create,
    llama_tiny as jax_llama_tiny,
)
from accelerate_tpu.ops import quantization as jq
from accelerate_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode,
    paged_verify_attention as jax_verify,
)
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher, Request as JaxRequest
from accelerate_tpu_torch.generation import CausalPrograms
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model, llama_state_dict_from_flax
from accelerate_tpu_torch.ops import paged_attention as port_paged
from accelerate_tpu_torch.ops import quantization as pq
from accelerate_tpu_torch.serving import ContinuousBatcher, Request
from accelerate_tpu_torch.utils.operations import gather_pages, scatter_pages, zero_cache_tail

KV_DTYPES = ("int8", "fp8_e4m3")
F32_ATOL = 2e-5
LOGIT_ATOL = {"int8": 2e-2, "fp8_e4m3": 5e-2}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one CPU thread, as in the other parity files: with a second
    OpenMP thread `torch.exp` was seen to come back about 1e-4 off now and
    then on a shared host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codes(x):
    """Stored codes as int64 bit patterns, from a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == pq.E4M3 else x).numpy().astype(np.int64)
    x = np.asarray(x)
    return (x.view(np.uint8) if x.dtype != np.int8 else x).astype(np.int64)


def _specs(kv_dtype):
    return pq.kv_quant_spec(kv_dtype), jq.kv_quant_spec(kv_dtype)


# ------------------------------------------------------------- the primitives
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_kv_page_quantization_matches_jax(kv_dtype):
    """Whole-page quantization (the insert's scatter): codes equal, scales
    within rtol 1e-6, dequantized pages equal; values far past the fp8 range
    saturate instead of turning NaN."""
    pspec, jspec = _specs(kv_dtype)
    rng = np.random.default_rng(0)
    blocks = (rng.normal(size=(5, 4, 2, 8)) * rng.uniform(0.01, 50, size=(5, 1, 2, 1))).astype(np.float32)
    blocks[0, 0, 0, 0] = 0.0
    blocks[1] = 0.0  # an all-zero page: scale 0, codes 0
    pq_, ps_ = pq.quantize_kv_pages(torch.as_tensor(blocks), pspec)
    jq_, js_ = jq.quantize_kv_pages(jnp.asarray(blocks), jspec)
    assert pq_.dtype == pspec[0] and tuple(ps_.shape) == (5, 2)
    np.testing.assert_array_equal(_codes(pq_), _codes(jq_))
    np.testing.assert_allclose(ps_.numpy(), np.asarray(js_), rtol=1e-6, atol=0)
    deq = pq.dequantize_kv_pages(pq_[None], ps_[None], torch.float32)[0]
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jq.dequantize_kv_pages(jq_[None], js_[None], jnp.float32))[0])
    huge = torch.tensor([1e6, -1e6, 500.0])
    assert torch.isfinite(pq.quantize_kv(huge, torch.tensor(1.0), *pspec).float()).all()


def _write_sequence(ps, h, d, rng):
    """(x, pid, off) writes: a page filled token by token with growing
    magnitude (the scale rises mid-page and its rows are requantized), an
    offset-0 write that resets a recycled page, inactive rows writing to
    scratch page 0 at distinct offsets beside a live row, and an s = 3 block
    straddling a page boundary."""
    writes = []
    for t in range(ps):  # growth mid-page on page 1
        writes.append((rng.normal(size=(1, 1, h, d)) * 0.1 * 4.0 ** t, [[1]], [[t]]))
    writes.append((rng.normal(size=(1, 1, h, d)) * 1e-3, [[1]], [[0]]))  # fresh occupant of page 1
    writes.append((rng.normal(size=(3, 1, h, d)) * 3.0, [[0], [2], [0]], [[1], [3], [2]]))  # scratch duplicates
    writes.append((rng.normal(size=(1, 3, h, d)) * [[[[0.5]], [[4.0]], [[0.2]]]], [[3, 3, 4]], [[ps - 2, ps - 1, 0]]))
    writes.append((rng.normal(size=(2, 1, h, d)) * 9.0, [[3], [4]], [[1], [1]]))  # both pages grow
    return [(x.astype(np.float32), np.asarray(p, np.int32), np.asarray(o, np.int32)) for x, p, o in writes]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_pool_write_sequence_matches_jax(kv_dtype):
    """The decode write path, in place in the port and functional in JAX,
    over a pool that starts with stale codes and scales: after every write
    the whole pool's codes are equal and its scales within rtol 1e-6."""
    pspec, jspec = _specs(kv_dtype)
    rng = np.random.default_rng(1)
    n, ps, h, d = 6, 4, 2, 8
    stale = rng.normal(size=(n, ps, h, d)).astype(np.float32) * 20.0
    stale_q, stale_s = jq.quantize_kv_pages(jnp.asarray(stale), jspec)
    jpool, jscale = stale_q, stale_s
    ppool = torch.as_tensor(_codes(stale_q).astype(np.uint8 if kv_dtype != "int8" else np.int8))
    ppool = ppool.view(pspec[0]) if kv_dtype != "int8" else ppool
    pscale = torch.as_tensor(np.array(stale_s))
    for i, (x, pid, off) in enumerate(_write_sequence(ps, h, d, rng)):
        jpool, jscale = jq.quantized_pool_write(jpool, jscale, jnp.asarray(x), jnp.asarray(pid), jnp.asarray(off), jspec)
        pq.quantized_pool_write(ppool, pscale, torch.as_tensor(x), torch.as_tensor(pid), torch.as_tensor(off), pspec)
        np.testing.assert_array_equal(_codes(ppool), _codes(jpool), err_msg=f"write {i}")
        np.testing.assert_allclose(pscale.numpy(), np.asarray(jscale), rtol=1e-6, atol=0, err_msg=f"write {i}")
    # The offset-0 write reset page 1: its scale covers only the new token.
    assert (pscale[1] <= 1e-3 * 5 / pspec[1]).all()


def test_quantize_weight_int8_matches_jax():
    """Per-output-channel int8: the port quantizes an nn.Linear weight [out,
    in], JAX a flax kernel [in, out]; same codes and scales, and
    `Int8Linear` computes JAX's `_int8_dense_apply`."""
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(24, 40)) * rng.uniform(0.01, 2.0, size=(1, 40))).astype(np.float32)  # [in, out]
    w[:, 3] = 0.0
    entry = jq.quantize_weight_int8(jnp.asarray(w))
    q, scale = pq.quantize_weight_int8(torch.as_tensor(w.T.copy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(entry["q"]).T)
    np.testing.assert_allclose(scale.numpy(), np.asarray(entry["scale"]), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        pq.dequantize_weight_int8(q, scale).numpy(), np.asarray(jq.dequantize_weight_int8(entry)).T
    )
    x = rng.normal(size=(3, 24)).astype(np.float32)
    expect = (np.asarray(jnp.asarray(x) @ entry["q"].astype(jnp.float32)) * np.asarray(entry["scale"]))
    got = pq.Int8Linear(q, scale)(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_linear_with_bias_matches_jax_int8_dense(dtype):
    """A biased layer (GPT-NeoX's projections): JAX's int8 Dense, a flax
    `nn.Dense` over `quantize_params_int8` params under `weight_autocast`,
    scales the f32 product, rounds it to x's dtype and adds the bias after;
    `Int8Linear.from_linear` keeps the bias in the layer's dtype and does
    the same. f32 within 1e-5; bf16 within the roundings of either side."""
    import flax.linen as fnn

    rng = np.random.default_rng(4)
    w = rng.normal(size=(24, 40)).astype(np.float32)  # flax kernel [in, out]
    b = rng.normal(size=(40,)).astype(np.float32)
    x = rng.normal(size=(3, 24)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qparams = jq.quantize_params_int8({"params": {"kernel": jnp.asarray(w, jdtype), "bias": jnp.asarray(b, jdtype)}})
    with jq.weight_autocast("int8"):
        expect = fnn.Dense(40).apply(qparams, jnp.asarray(x, jdtype))
    linear = torch.nn.Linear(24, 40).to(dtype)
    with torch.no_grad():
        linear.weight.copy_(torch.as_tensor(w.T))
        linear.bias.copy_(torch.as_tensor(b))
    layer = pq.Int8Linear.from_linear(linear)
    assert layer.bias.dtype == dtype and layer.q.dtype == torch.int8
    got = layer(torch.as_tensor(x).to(dtype))
    assert got.dtype == dtype
    expect = np.asarray(expect.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), expect, atol=1e-5, rtol=1e-6)
        return
    # bf16: the port rounds the product to bf16 twice (F.linear's output, then
    # after the scale), JAX once, and each rounds the sum with the bias once:
    # at most 3 * 2^-8 of |product| + |bias| apart, element by element.
    product = np.abs(x @ pq.dequantize_weight_int8(layer.q, layer.scale).numpy().T)
    limit = 1e-3 + 3 * 2 ** -8 * (product + np.abs(b))
    assert (np.abs(got.float().numpy() - expect) <= limit).all()


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_stale_rows_never_inflate_insert_scales(kv_dtype):
    """A recycled page's stale content past the prompt is zeroed before the
    insert's scatter, so the boundary page's scale is the valid rows' own
    (`tests/test_quantization.py`'s regression, through the port's
    gather / zero / scatter over a layer's pools)."""
    pspec, jspec = _specs(kv_dtype)
    ps, h, d, valid = 8, 2, 4, 5
    pool = torch.full((4, ps, h, d), 100.0)
    small = np.random.default_rng(3).normal(size=(valid, h, d)).astype(np.float32) * 0.01
    qpool, qscale = pq.quantize_kv_pages(pool, pspec)
    pools = [(qpool, qpool.clone(), qscale, qscale.clone())]
    dense = gather_pages(pools, [2, 3], torch.float32)
    assert dense[0][0].shape == (1, 2 * ps, h, d) and float(dense[0][0].abs().min()) > 99
    dense[0][0][0, :valid] = torch.as_tensor(small)
    dense[0][1][0, :valid] = torch.as_tensor(small)
    scatter_pages(pools, zero_cache_tail(dense, valid), [2, 3])
    _, expect_scale = jq.quantize_kv_pages(jnp.asarray(np.pad(small, ((0, ps - valid), (0, 0), (0, 0)))[None]), jspec)
    np.testing.assert_allclose(qscale[2].numpy(), np.asarray(expect_scale)[0], rtol=1e-6, atol=0)
    assert float(qscale[3].abs().max()) == 0.0  # a page wholly past the prompt holds zeros
    back = pq.dequantize_kv_pages(qpool[2:3], qscale[2:3], torch.float32)[0, :valid].numpy()
    bound = np.abs(small).max(axis=(0, 2))[None, :, None] * (0.5 / 127 if kv_dtype == "int8" else 0.07)
    assert (np.abs(back - small) <= bound + 1e-9).all()


# ---------------------------------------------------- K1/K2, quantized mode
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("s,page_size", [(1, 4), (1, 16), (3, 8), (5, 4)])
def test_plain_quantized_kernels_match_jax_pallas(kv_dtype, s, page_size):
    """The plain version of K1 (s = 1) and K2 against JAX's Pallas kernels in
    interpret mode with ``k_scale``/``v_scale``, on the same codes and
    scales: a shuffled table, ragged positions, GQA 4/2, and a poisoned
    scratch page (quantized too) behind short slots."""
    _, jspec = _specs(kv_dtype)
    rng = np.random.default_rng(10 * s + page_size)
    B, hq, hkv, D, P = 3, 4, 2, 16, 3
    N = B * P + 1
    L = P * page_size
    k = rng.normal(size=(N, page_size, hkv, D)).astype(np.float32)
    v = rng.normal(size=(N, page_size, hkv, D)).astype(np.float32)
    k[0], v[0] = 1e4, 1e4
    kq, ks = jq.quantize_kv_pages(jnp.asarray(k), jspec)
    vq, vs = jq.quantize_kv_pages(jnp.asarray(v), jspec)
    table = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    start = np.array([0, page_size + 1, L - s])
    table[0, 1:] = 0
    pos = (start[:, None] + np.arange(s)[None, :]).astype(np.int32)
    q = rng.normal(size=(B, s, hq, D)).astype(np.float32)
    jfn = jax_decode if s == 1 else jax_verify
    expect = np.asarray(jfn(jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(pos), k_scale=ks, v_scale=vs))

    def to_torch(codes):
        arr = torch.as_tensor(_codes(codes).astype(np.int8 if kv_dtype == "int8" else np.uint8))
        return arr if kv_dtype == "int8" else arr.view(pq.E4M3)

    pfn = port_paged.paged_decode_attention if s == 1 else port_paged.paged_verify_attention
    got = pfn(torch.as_tensor(q), to_torch(kq), to_torch(vq), torch.as_tensor(table), torch.as_tensor(pos),
              k_scale=torch.as_tensor(np.array(ks)), v_scale=torch.as_tensor(np.array(vs)))
    np.testing.assert_allclose(got.numpy(), expect, atol=F32_ATOL, rtol=0)


def test_quantized_kernel_wrapper_checks():
    """Both scales or neither, [num_pages, Hkv] f32; the CUDA launch path
    refuses an int8/fp8 pool without scales, mixed pool types and D not a
    multiple of 16 before it builds anything."""
    q = torch.randn(2, 1, 4, 16)
    pool = torch.zeros(5, 4, 2, 16, dtype=torch.int8)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[5], [2]], dtype=torch.int32)
    sc = torch.ones(5, 2)
    with pytest.raises(ValueError, match="BOTH k_scale and v_scale"):
        port_paged.paged_decode_attention(q, pool, pool, table, pos, k_scale=sc)
    with pytest.raises(ValueError, match="num_pages, Hkv"):
        port_paged.paged_decode_attention(q, pool, pool, table, pos, k_scale=sc[:4], v_scale=sc[:4])
    with pytest.raises(ValueError, match="needs k_scale and v_scale"):
        port_paged._launch("decode", q, pool, pool, table, pos, 1.0)
    with pytest.raises(ValueError, match="both be int8 or both float8_e4m3fn"):
        port_paged._launch("decode", q, pool, pool.view(pq.E4M3), table, pos, 1.0, sc, sc)
    with pytest.raises(ValueError, match="float32"):
        port_paged._launch("decode", q, pool, pool, table, pos, 1.0, sc.double(), sc.double())
    with pytest.raises(ValueError, match="% 16"):
        port_paged._launch("decode", q[..., :8].contiguous(), pool[..., :8].contiguous(),
                           pool[..., :8].contiguous(), table, pos, 1.0, sc, sc)


# ------------------------------------------------------------------ engines
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
    model.load_state_dict(llama_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jmodel.params), cfg))
    return jmodel, model


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, VOCAB, (int(rng.integers(3, 20)),)).astype(np.int32), int(rng.integers(3, 10)))
            for i in range(n)]


@pytest.mark.parametrize(
    "quant,extra",
    [
        (dict(kv_cache_dtype="int8"), dict(attention_impl="pallas_paged")),
        (dict(kv_cache_dtype="fp8_e4m3"), dict(attention_impl="xla")),
        (dict(weight_dtype="int8"), dict(attention_impl="xla")),
        (dict(weight_dtype="int8", kv_cache_dtype="int8"), dict(attention_impl="pallas_paged")),
        (dict(kv_cache_dtype="fp8_e4m3"), dict(attention_impl="pallas_paged", speculative=True, draft_tokens=3)),
    ],
    ids=["kv-int8", "kv-fp8", "w-int8", "w-int8-kv-int8", "kv-fp8-speculative"],
)
def test_quantized_engine_tokens_match_jax_engine(models, quant, extra):
    """Mixed prompts and budgets through two slots, page 4: both port paths
    give the JAX quantized engine's greedy tokens exactly."""
    jmodel, model = models
    reqs = _prompts(len(quant) * 7 + len(extra), 6)
    if extra.get("speculative"):
        rng = np.random.default_rng(9)
        motif = rng.integers(1, VOCAB, (5,))
        reqs = [(i, np.tile(motif, 4).astype(np.int32)[: int(rng.integers(8, 16))], 24) for i in range(4)]
    common = dict(num_slots=2, max_length=64, chunk_size=4, page_size=4, **quant)
    spec = {k: v for k, v in extra.items() if k != "attention_impl"}
    jengine = JaxBatcher(jmodel, max_queue=16, attention_impl=extra["attention_impl"], **common, **spec)
    expect = jengine.run([JaxRequest(i, p, max_new_tokens=n) for i, p, n in reqs])
    expect = {k: list(map(int, v)) for k, v in expect.items()}
    for impl in ("paged_kernel", "gather"):
        engine = ContinuousBatcher(model, max_queue=16, attention_impl=impl, device="cpu", **common, **spec)
        got = engine.run([Request(i, p, max_new_tokens=n) for i, p, n in reqs])
        assert {k: list(map(int, v)) for k, v in got.items()} == expect, impl
        assert engine.stats["weight_dtype"] == quant.get("weight_dtype", "bf16")
        assert engine.stats["kv_cache_dtype"] == quant.get("kv_cache_dtype", "bf16")
        assert engine.pool.pages_in_use == 0 and engine.pool.check_consistency() == []
    if extra.get("speculative"):
        assert engine.stats["speculative"]["accepted"] == jengine.stats["speculative"]["accepted"] > 0


def test_quantized_prefix_cache_wave_matches_jax_engine(models):
    """Wave 2 reads wave 1's shared system-prompt pages back dequantized
    (int8 weights, int8 cache): the same tokens and prefix hits as JAX."""
    jmodel, model = models
    rng = np.random.default_rng(8)
    system = rng.integers(1, VOCAB, (9,)).astype(np.int32)
    waves = [[(w * 4 + i, np.concatenate([system, rng.integers(1, VOCAB, (3 + i,)).astype(np.int32)]), 5)
              for i in range(4)] for w in range(2)]
    common = dict(num_slots=2, max_length=64, chunk_size=4, page_size=4, weight_dtype="int8", kv_cache_dtype="int8")
    jengine = JaxBatcher(jmodel, attention_impl="pallas_paged", max_queue=16, **common)
    pengine = ContinuousBatcher(model, attention_impl="paged_kernel", max_queue=16, device="cpu", **common)
    for wave in waves:
        expect = jengine.run([JaxRequest(i, p, max_new_tokens=n) for i, p, n in wave])
        got = pengine.run([Request(i, p, max_new_tokens=n) for i, p, n in wave])
        assert {k: list(map(int, v)) for k, v in got.items()} == {k: list(map(int, v)) for k, v in expect.items()}
    hits = pengine.stats["prefix_cache"]["hits"]
    assert hits > 0 and hits == jengine.stats["prefix_cache"]["hits"]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_fresh_prompt_first_tokens_are_exact(models, kv_dtype):
    """With only the cache quantized, a prompt that shares no prefix never
    attends its own quantized K/V at insert: every first token equals the
    unquantized engine's (JAX's engine-level pin)."""
    _, model = models
    reqs = _prompts(5, 6)

    def run(**kw):
        engine = ContinuousBatcher(model, num_slots=3, max_length=64, chunk_size=4, page_size=8,
                                   max_queue=16, device="cpu", **kw)
        return engine.run([Request(i, p, max_new_tokens=n) for i, p, n in reqs])

    base, quant = run(), run(kv_cache_dtype=kv_dtype)
    assert all(base[i][0] == quant[i][0] for i in base)


def _jax_step_logits(jmodel, kv_dtype, tokens, page_size=8, P=4):
    """JAX's serving step program over a fixed token sequence, one token a
    step, on a paged pool of `kv_dtype` (`tests/test_quantization.py`'s
    harness)."""
    from accelerate_tpu.generation import make_causal_programs

    B, T = tokens.shape
    cfg = dataclasses.replace(
        jmodel.module.config, decode_cache_length=P * page_size, decode_slot_cache=True,
        decode_page_size=page_size, decode_num_pages=B * P + 1, decode_kv_cache_dtype=kv_dtype,
    )
    module = JaxLlamaForCausalLM(cfg)
    _, step, _ = make_causal_programs(module, lambda p: p, step_mask_operand=True, verify_block=True)
    table = jnp.asarray(np.arange(1, B * P + 1, dtype=np.int32).reshape(B, P))
    shapes = jax.eval_shape(
        lambda p: module.apply(p, jnp.zeros((B, 1), jnp.int32), table, jnp.zeros((B, 1), jnp.int32),
                               mutable=["cache"])[1]["cache"],
        jmodel.params,
    )
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    step = jax.jit(step)
    out = []
    for t in range(T):
        logits, cache = step(jmodel.params, cache, jnp.asarray(tokens[:, t]), jnp.asarray(np.full(B, t, np.int32)), table)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out, axis=1)


def _port_step_logits(model, kv_dtype, tokens, page_size=8, P=4):
    B, T = tokens.shape
    cfg = model.config
    spec = pq.kv_quant_spec(kv_dtype)
    shape = (B * P + 1, page_size, cfg.num_key_value_heads, cfg.head_dim)
    pools = []
    for _ in range(cfg.num_hidden_layers):
        layer = (torch.zeros(shape, dtype=spec[0]), torch.zeros(shape, dtype=spec[0]))
        pools.append(layer + (torch.zeros(shape[0], shape[2]), torch.zeros(shape[0], shape[2])))
    table = torch.arange(1, B * P + 1, dtype=torch.int32).reshape(B, P)
    programs = CausalPrograms(model, "paged_kernel")
    out = [programs.step(torch.as_tensor(tokens[:, t]).long(), torch.full((B,), t), pools, table)
           for t in range(T)]
    return torch.stack(out, dim=1).numpy()


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_step_program_logits_match_jax(kv_dtype):
    """`llama_tiny` weights carried across; the same 12 tokens through each
    side's step program on a quantized pool: logits within a tenth of JAX's
    own quantization budget."""
    from accelerate_tpu_torch.models.llama import LlamaConfig as PortConfig

    jmodel = jax_create(jax_llama_tiny(), seq_len=16)
    cfg = PortConfig(**{f.name: getattr(jmodel.module.config, f.name) for f in dataclasses.fields(PortConfig)})
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jmodel.params), cfg))
    tokens = np.random.default_rng(0).integers(1, 500, (2, 12)).astype(np.int32)
    expect = _jax_step_logits(jmodel, kv_dtype, tokens)
    got = _port_step_logits(model, kv_dtype, tokens)
    np.testing.assert_allclose(got, expect, atol=LOGIT_ATOL[kv_dtype], rtol=0)


def test_engine_validation_and_the_callers_model(models):
    """JAX's error words for dtypes off the sets; int8 weights leave the
    caller's model as it was, quantize every linear layer of the engine's
    copy (and only those), and quantizing again changes nothing."""
    _, model = models
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ContinuousBatcher(model, kv_cache_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="weight_dtype"):
        ContinuousBatcher(model, weight_dtype="fp4", device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        pq.kv_quant_spec("fp8_e5m2")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    engine = ContinuousBatcher(model, max_length=32, page_size=8, weight_dtype="int8", kv_cache_dtype="int8",
                               device="cpu")
    after = model.state_dict()
    assert before.keys() == after.keys() and all(torch.equal(before[k], after[k]) for k in before)
    assert all(type(m) is not pq.Int8Linear for m in model.modules())
    qmodel = engine.programs.model
    linears = [name for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)]
    assert len(linears) == 2 * 7 + 1
    assert all(isinstance(qmodel.get_submodule(name), pq.Int8Linear) for name in linears)
    assert qmodel.embed_tokens.weight is model.embed_tokens.weight  # shared, not copied
    again = pq.quantize_model_int8(qmodel)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), qmodel.state_dict().values()))
    assert pq.params_nbytes(qmodel) < pq.params_nbytes(model) / 2
    assert engine.kv_pool_itemsize == 1 and engine.stats["kv_cache_dtype"] == "int8"
    n, ps, hkv, d = engine._pools[0][0].shape
    assert engine.kv_cache_nbytes == 2 * 2 * (n * ps * hkv * d + n * hkv * 4)
