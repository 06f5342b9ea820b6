"""Tests of the port that need an NVIDIA card: the hand-written kernels have
no CPU mode. Each skips, with its reason, where `torch.cuda.is_available()`
is False, deciding inside the test.

This file imports no JAX, so it also runs on a card's machine that has none:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

(`--noconftest` skips `tests/conftest.py`, which sets JAX up for the rest of
the suite.) Tolerances are those of `chip_smoke.py`: f32 atol 2e-5; bf16 atol
2e-3, rtol 1e-2, one bf16 rounding of the output above the fp32 summation
order, and well below the small outputs of long slots. The flash backward's
f32 gradients sum up to S products per value, in another order than the
plain version's matmuls: atol/rtol 1e-4. f32 flash kernels are held to
their plain versions on the same inputs widened to float64: at scale 1.0
(T5) the f32 plain version's own score products take most of the f32
limit (`chip_smoke.F32_REFERENCE`). The quantized mode of the paged
kernels dequantizes exactly as its plain version does (one f32 multiply per
value), so the same tolerances hold. bf16 K3, K4 and K5 run on the tensor
cores with P and dS rounded to bf16 (as FlashAttention-2/3 and SDPA do),
which their fp32 plain versions do not; in rows that see few keys (keys
that few rows see) that moves o, dq, dk and dv past atol 2e-3 where they
are small. So they are held, element by element, within atol 2e-3 + rtol
1e-2 |ref| plus the most that rounding can move each element
(`chip_smoke.flash_rounding_bound`: 2^-8 (P @ |V|), 2^-8 (|dS| @ |K|),
2^-8 (|dS|^T @ |Q|), 2^-8 (P^T @ |dO|)). fp16 K3-K5 run the same kernels
with fp16 operands: atol 1e-3 + rtol 5e-3 |ref| plus the same bound at
fp16's unit, 2^-11 (`chip_smoke.flash_tolerance`).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops import quantization as qz

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=0.0)
F32_GRAD = dict(atol=1e-4, rtol=1e-4)
LSE = dict(atol=2e-5, rtol=1e-5)
BF16 = dict(atol=2e-3, rtol=1e-2)
NARROW = {torch.bfloat16: BF16, torch.float16: dict(atol=1e-3, rtol=5e-3)}


def _launched(before, dtype, n=1):
    """The flash launch counts since `before` that `n` launches of each
    kernel on `dtype` tensors leave."""
    suffix = "_f16" if dtype == torch.float16 else ""
    return {key: n if key in {k + suffix for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")} else 0
            for key in before}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(device, dtype, s, seed=0, B=3, hq=8, hkv=2, d=64, P=6, ps=16):
    """Shuffled page table, ragged positions (the first cell, mid-page, the
    last page), scratch page 0 poisoned behind each slot's live pages."""
    rng = np.random.default_rng(seed)
    N = B * P + 1
    table = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    start = np.array([0, 37, P * ps - s])[:B]
    pos = (start[:, None] + np.arange(s)[None, :]).astype(np.int32)
    table[0, 1:] = 0  # slot 0 holds one live page
    k = rng.normal(size=(N, ps, hkv, d)).astype(np.float32)
    v = rng.normal(size=(N, ps, hkv, d)).astype(np.float32)
    k[0], v[0] = 1e4, 1e4
    q = rng.normal(size=(B, s, hq, d)).astype(np.float32)
    to = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return to(q).to(dtype), to(k).to(dtype), to(v).to(dtype), to(table), to(pos)


@pytest.mark.parametrize("page_size", [4, 16, 128])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, dtype, s, page_size):
    q, k, v, table, pos = _case(cuda, dtype, s, ps=page_size, P=max(2, 96 // page_size))
    kind = "decode" if s == 1 else "verify"
    fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
    before = pa.LAUNCHES[kind]
    out = fn(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[kind] == before + 1
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all()
    ref = pa.paged_attention_reference(q, k, v, table, pos)
    torch.testing.assert_close(out.float(), ref.float(), **(F32 if dtype == torch.float32 else BF16))


def test_large_shared_memory_launch_on_every_device(cuda):
    """Page 128 with s = 5 needs about 85 KB of shared memory per block, over
    the 48 KB default: the opt-in is per device, so each visible card takes
    the launch in turn, the first card again last."""
    devices = list(range(torch.cuda.device_count())) + [0]
    for index in devices:
        device = torch.device("cuda", index)
        q, k, v, table, pos = _case(device, torch.float32, 5, ps=128, P=2)
        out = pa.paged_verify_attention(q, k, v, table, pos)
        ref = pa.paged_attention_reference(q, k, v, table, pos)
        torch.testing.assert_close(out, ref, **F32)


def _quantized(k, v, kv_dtype):
    """The pools quantized whole-page (scratch page 0 too) and their scales."""
    spec = qz.kv_quant_spec(kv_dtype)
    kq, ks = qz.quantize_kv_pages(k.float(), spec)
    vq, vs = qz.quantize_kv_pages(v.float(), spec)
    return kq, vq, ks, vs


@pytest.mark.parametrize("page_size", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantized_kernel_matches_plain_version(cuda, kv_dtype, dtype, s, page_size):
    """The fused-dequant mode over int8/fp8 pools, ragged positions and a
    poisoned scratch page, against the plain version on the same codes and
    scales; one launch under the quantized key, none under the others."""
    q, k, v, table, pos = _case(cuda, torch.float32, s, ps=page_size, P=max(2, 96 // page_size), seed=page_size + s)
    kq, vq, ks, vs = _quantized(k, v, kv_dtype)
    q = q.to(dtype)
    kind = "decode" if s == 1 else "verify"
    fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
    before = dict(pa.LAUNCHES)
    out = fn(q, kq, vq, table, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert {key: pa.LAUNCHES[key] - before[key] for key in before} == {
        key: int(key == f"{kind}_{kv_dtype}") for key in before}
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all()
    ref = pa.paged_attention_reference(q, kq, vq, table, pos, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), **(F32 if dtype == torch.float32 else BF16))


def test_quantized_pool_launches_or_raises(cuda, monkeypatch):
    """On the card an int8/fp8 pool goes to the kernel or raises: with the
    plain dequantization and SDPA made to fail, the call still succeeds and
    counts one launch; a pool the kernel does not take raises."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA call dequantized the pool outside the kernel")

    monkeypatch.setattr(pa, "dequantize_kv_pages", forbidden)
    monkeypatch.setattr(pa, "paged_attention_reference", forbidden)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", forbidden)
    q, k, v, table, pos = _case(cuda, torch.bfloat16, 1)
    kq, vq, ks, vs = _quantized(k, v, "fp8_e4m3")
    before = pa.LAUNCHES["decode_fp8_e4m3"]
    out = pa.paged_decode_attention(q, kq, vq, table, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["decode_fp8_e4m3"] == before + 1 and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="needs k_scale and v_scale"):
        pa.paged_decode_attention(q, kq, vq, table, pos)
    with pytest.raises(ValueError, match="% 16"):
        short = _case(cuda, torch.bfloat16, 1, d=8)
        sq, sv, sks, svs = _quantized(short[1], short[2], "int8")
        pa.paged_decode_attention(short[0], sq, sv, short[3], short[4], k_scale=sks, v_scale=svs)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, table, pos = _case(cuda, torch.float32, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.paged_decode_attention(q.half(), k.half(), v.half(), table, pos)
    with pytest.raises(ValueError, match="is on"):
        pa.paged_decode_attention(q, k.cpu(), v, table, pos)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                                  v[..., :12].contiguous(), table, pos)


def _split_case(device, s, page_size, kv_dtype, dtype, seed=3, hq=8, hkv=2, d=64, max_length=2048):
    """Four slots of up to `max_length` tokens whose blocks end at the edges
    of the kernel's splits: decode at lengths 1, one split, one split + 1 and
    the full slot; verify blocks that start at 0, straddle the first split
    boundary (rows end in two splits), start on it and end the slot. Shuffled
    pages, scratch page 0 poisoned behind each slot's live pages; int8/fp8
    pools quantized whole-page."""
    rng = np.random.default_rng(seed)
    split = pa.split_tokens(page_size)
    P = max_length // page_size
    B = 4
    starts = [0, split - 1, split, max_length - 1] if s == 1 else [0, split - 3, split, max_length - s]
    pos = (np.array(starts)[:, None] + np.arange(s)[None, :]).astype(np.int32)
    N = B * P + 1
    pages = rng.permutation(np.arange(1, N))
    table = np.zeros((B, P), np.int32)
    for b in range(B):
        live = -(-(int(pos[b].max()) + 1) // page_size)
        table[b, :live] = pages[b * P: b * P + live]
    k = rng.normal(size=(N, page_size, hkv, d)).astype(np.float32)
    v = rng.normal(size=(N, page_size, hkv, d)).astype(np.float32)
    k[0], v[0] = 1e4, 1e4
    q = rng.normal(size=(B, s, hq, d)).astype(np.float32)
    to = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    k, v = to(k), to(v)
    scales = {}
    if kv_dtype in ("int8", "fp8_e4m3"):
        k, v, ks, vs = _quantized(k, v, kv_dtype)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return (to(q).to(dtype), k, v, to(table), to(pos)), scales


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("page_size", [4, 16, 128])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_split_edges_match_plain_version(cuda, dtype, s, page_size, kv_dtype, d, hq=8, hkv=2):
    """Slot lengths of 1, exactly one split, one past it and the full 2048,
    and verify blocks whose rows end in different splits, at pages of 4, 16
    and 128 over every pool type and at every head dimension the bf16
    tensor-core kernel is built for (G = 4: decode takes one m16 row tile;
    verify's 20 rows two tiles in one block at D 32 and 64, and two row
    groups, each reading the pages, at D 128): the split kernel and its
    merge against the plain version, one launch counted per call."""
    args, scales = _split_case(cuda, s, page_size, kv_dtype, dtype, d=d, hq=hq, hkv=hkv)
    kind = "decode" if s == 1 else "verify"
    key = kind if kv_dtype == "native" else f"{kind}_{kv_dtype}"
    fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
    before = dict(pa.LAUNCHES)
    out = fn(*args, **scales)
    torch.cuda.synchronize()
    assert {name: pa.LAUNCHES[name] - before[name] for name in before} == {
        name: int(name == key) for name in before}
    assert out.dtype == dtype and out.shape == args[0].shape and torch.isfinite(out).all()
    ref = pa.paged_attention_reference(*args, **scales)
    torch.testing.assert_close(out.float(), ref.float(), **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("d, kv_dtype", [(40, "native"), (48, "native"), (48, "int8"), (48, "fp8_e4m3"),
                                         (96, "native"), (96, "int8")])
@pytest.mark.parametrize("s", [1, 5])
def test_kernel_bf16_queries_at_other_head_dims(cuda, s, d, kv_dtype):
    """bf16 queries at head dimensions the tensor-core kernel is not built
    for run the scalar split kernel with bf16 q and output (D % 8 for bf16
    pools, D % 16 for 1-byte pools), held to the plain version at the bf16
    tolerance, one launch per call."""
    args, scales = _split_case(cuda, s, 16, kv_dtype, torch.bfloat16, d=d)
    kind = "decode" if s == 1 else "verify"
    key = kind if kv_dtype == "native" else f"{kind}_{kv_dtype}"
    fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
    before = pa.LAUNCHES[key]
    out = fn(*args, **scales)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[key] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape and torch.isfinite(out).all()
    ref = pa.paged_attention_reference(*args, **scales)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


@pytest.mark.parametrize("kv_dtype", ["native", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_neox_heads_matches_plain_version(cuda, dtype, s, page_size, kv_dtype):
    """GPT-NeoX-20B's attention, one K/V head per query head (G = 1) at head
    dimension 96, through the scalar split kernel over every pool type, at
    the split edges of `test_kernel_split_edges_match_plain_version`: held
    to the plain version, one launch counted per call."""
    test_kernel_split_edges_match_plain_version(cuda, dtype, s, page_size, kv_dtype, 96, hq=4, hkv=4)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_kernel_launch_never_synchronises(cuda, kv_dtype):
    """Under `torch.cuda.set_sync_debug_mode("error")` a decode and a verify
    call each go through (a synchronising call would raise), and each counts
    one launch: the wrapper allocates its workspace with torch.empty and
    reads no positions back to the host."""
    calls = []
    for s in (1, 5):
        args, scales = _split_case(cuda, s, 16, kv_dtype, torch.bfloat16)
        fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
        fn(*args, **scales)  # builds and loads the library outside the check
        calls.append((fn, args, scales, "decode" if s == 1 else "verify"))
    torch.cuda.synchronize()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, args, scales, kind in calls:
            key = kind if kv_dtype == "native" else f"{kind}_{kv_dtype}"
            before = pa.LAUNCHES[key]
            outs.append(fn(*args, **scales))
            assert pa.LAUNCHES[key] == before + 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for out, (fn, args, scales, _) in zip(outs, calls):
        ref = pa.paged_attention_reference(*args, **scales)
        torch.testing.assert_close(out.float(), ref.float(), **BF16)


def test_engine_kernel_path_matches_gather_path(cuda):
    """A small Llama served on the card: greedy tokens of the kernel path
    equal the gather path's in f32, plain and speculative, and the launch
    counts equal layers x dispatches."""
    from accelerate_tpu_torch import ContinuousBatcher, Request, create_llama_model
    from accelerate_tpu_torch.models import llama_tiny

    model = create_llama_model(llama_tiny(), seed=1, device=cuda)
    rng = np.random.default_rng(2)
    motif = rng.integers(0, 512, (7,))
    prompts = [rng.integers(0, 512, (int(n),)) for n in (5, 40, 17)] + [np.tile(motif, 6)]
    runs = {}
    for spec in (False, True):
        for impl in ("gather", "paged_kernel"):
            pa.reset_launch_counts()
            engine = ContinuousBatcher(model, num_slots=2, max_length=128, chunk_size=4, page_size=8,
                                       attention_impl=impl, speculative=spec, draft_tokens=4)
            out = engine.run([Request(i, p, max_new_tokens=24) for i, p in enumerate(prompts)])
            runs[spec, impl] = {rid: list(map(int, t)) for rid, t in out.items()}
            kind = "verify" if spec else "decode"
            expect = model.config.num_hidden_layers * engine.stats["decode_steps"] if impl == "paged_kernel" else 0
            assert pa.LAUNCHES[kind] == expect
        assert runs[spec, "gather"] == runs[spec, "paged_kernel"]
    assert runs[False, "paged_kernel"] == runs[True, "paged_kernel"]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantized_engine_kernel_path_matches_gather_path(cuda, kv_dtype):
    """A small Llama served on the card with a quantized cache and int8
    weights: f32 greedy tokens of the kernel path equal the gather path's,
    plain and speculative, and the quantized launch counts equal layers x
    dispatches while the unquantized ones stay 0."""
    from accelerate_tpu_torch import ContinuousBatcher, Request, create_llama_model
    from accelerate_tpu_torch.models import llama_tiny

    model = create_llama_model(llama_tiny(), seed=1, device=cuda)
    rng = np.random.default_rng(2)
    motif = rng.integers(0, 512, (7,))
    prompts = [rng.integers(0, 512, (int(n),)) for n in (5, 40, 17)] + [np.tile(motif, 6)]
    for spec in (False, True):
        runs = {}
        for impl in ("gather", "paged_kernel"):
            pa.reset_launch_counts()
            engine = ContinuousBatcher(model, num_slots=2, max_length=128, chunk_size=4, page_size=8,
                                       attention_impl=impl, speculative=spec, draft_tokens=4,
                                       weight_dtype="int8", kv_cache_dtype=kv_dtype)
            out = engine.run([Request(i, p, max_new_tokens=24) for i, p in enumerate(prompts)])
            runs[impl] = {rid: list(map(int, t)) for rid, t in out.items()}
            key = ("verify_" if spec else "decode_") + kv_dtype
            n = model.config.num_hidden_layers * engine.stats["decode_steps"] if impl == "paged_kernel" else 0
            assert pa.LAUNCHES == {k: n if k == key else 0 for k in pa.LAUNCHES}
        assert runs["gather"] == runs["paged_kernel"]


def _flash_case(device, dtype, bh, s, sk, d, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    to = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device).to(dtype)  # noqa: E731
    q, k, v, do = to(bh, s, d), to(bh, sk, d), to(bh, sk, d), to(bh, s, d)
    return (q * q_scale).to(dtype), k, v, do


def _assert_within(got, ref, tol, bound=None, what=""):
    """`got` within atol + rtol |ref| (+ `bound`) of `ref`, element by element."""
    report = chip_smoke.limit_report(got, ref, **tol, bound=bound)
    assert report["broken"] == 0, (what, report)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,s,sk", [(True, 192, 192), (False, 128, 200), (True, 64, 200),
                                         (True, 130, 250), (True, 1024, 1024)],
                         ids=["causal", "full-ragged", "causal-cross", "causal-ragged", "causal-1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, s, sk, d):
    """K3, K4 and K5 against their plain versions on the same inputs, each
    launched once; Sk = 200 and S, Sk = 130, 250 leave ragged last tiles
    of both sides (64-row query tiles, 64- and 128-key tiles)."""
    _hold_flash_kernels(cuda, dtype, causal, s, sk, d, d ** -0.5)


def _hold_flash_kernels(cuda, dtype, causal, s, sk, d, scale):
    q, k, v, do = _flash_case(cuda, dtype, 3, s, sk, d, seed=d + s)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert {key: fa.LAUNCHES[key] - before[key] for key in before} == _launched(before, dtype)
    # f32 against the plain versions on the same inputs widened to float64
    # (`chip_smoke.F32_REFERENCE`), the narrow types against fp32's.
    f32 = dtype == torch.float32
    wq, wk, wv, wdo = (x.to(chip_smoke.F32_REFERENCE) if f32 else x for x in (q, k, v, do))
    ref_o, ref_lse = fa.flash_fwd_reference(wq, wk, wv, causal, scale)
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (3, s)
    torch.testing.assert_close(lse, ref_lse.float(), **LSE)
    # The backward against its plain version from the same o and lse.
    ref_dq, ref_dk, ref_dv = fa.flash_bwd_reference(wq, wk, wv, o.to(wq.dtype) if f32 else o,
                                                    lse.to(wq.dtype) if f32 else lse, wdo, causal, scale)
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
    if f32:
        torch.testing.assert_close(o.float(), ref_o.float(), **F32)
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            torch.testing.assert_close(got.float(), ref.float(), **F32_GRAD, msg=lambda m: f"{name}: {m}")
        return
    delta = fa._delta(o, do)
    tol = NARROW[dtype]
    _assert_within(o, ref_o, tol, chip_smoke.flash_rounding_bound("flash_fwd", "o", q, k, v, do, ref_lse, None,
                                                                   causal, scale), "o")
    for name, key, got, ref in (("flash_bwd_dq", "dq", dq, ref_dq), ("flash_bwd_dkv", "dk", dk, ref_dk),
                                ("flash_bwd_dkv", "dv", dv, ref_dv)):
        bound = chip_smoke.flash_rounding_bound(name, key, q, k, v, do, lse, delta, causal, scale)
        _assert_within(got, ref, tol, bound, key)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s,sk", [(128, 256), (130, 250), (64, 1000), (1024, 2048)],
                         ids=["aligned", "ragged", "short-over-long", "t5-cross"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_match_plain_versions_non_causal_at_scale_one(cuda, dtype, s, sk, d):
    """K3-K5's non-causal mode over Sq < Skv at scale 1.0, T5's
    cross-attention: every key tile visible to every query tile, scores
    sqrt(D) times wider than at 1/sqrt(D), so P is sharper; the same limits."""
    _hold_flash_kernels(cuda, dtype, False, s, sk, d, 1.0)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_keep_to_their_head(cuda, dtype, d):
    """S = 130 and Sk = 250 leave ragged last tiles in every head. Head 2's
    Q, K, V and dO are set to inf: a kernel that filled head 1's ragged
    tile with the next head's rows (a 2-D [B*H*S, D] tensor map, say) would
    multiply them by its masked zeros and write NaN: K3 and K5 stream K/V
    tiles, K4 Q/dO tiles. Every other head's outputs equal those of a run
    where head 2 is finite, bit for bit."""
    q, k, v, do = _flash_case(cuda, dtype, 4, 130, 250, d, seed=d)
    scale = d ** -0.5
    poisoned = [x.clone() for x in (q, k, v, do)]
    for x in poisoned:
        x[2] = float("inf")
    others = [0, 1, 3]
    runs = []
    for qq, kk, vv, dd in ((q, k, v, do), poisoned):
        for causal in (True, False):
            o, lse = fa.flash_fwd(qq, kk, vv, causal=causal, scale=scale)
            dq, dk, dv = fa.flash_bwd(qq, kk, vv, o, lse, dd, causal=causal, scale=scale)
            runs.append([x[others] for x in (o, lse, dq, dk, dv)])
    torch.cuda.synchronize()
    for clean, poisoned in zip(runs[:2], runs[2:]):
        for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), clean, poisoned):
            assert torch.isfinite(b).all(), name
            assert torch.equal(a, b), name


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_softmax_rescales_large_scores(cuda, d, dtype):
    """bf16 (fp16) with q scaled by 8, so that scores spread 8 times wider
    and the running row maximum jumps between key tiles: K3's o and lse,
    K4's dk and dv and K5's dq against their plain versions (each within its
    rounding bound)."""
    q, k, v, do = _flash_case(cuda, dtype, 3, 192, 192, d, seed=d + 7, q_scale=8.0)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=True, scale=scale)
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, True, scale)
    delta = fa._delta(ref_o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=True, scale=scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True, scale=scale)
    torch.cuda.synchronize()
    bound = chip_smoke.flash_rounding_bound("flash_fwd", "o", q, k, v, do, ref_lse, delta, True, scale)
    _assert_within(o, ref_o, NARROW[dtype], bound, "o")
    torch.testing.assert_close(lse, ref_lse, **LSE)
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, do, ref_lse, delta, True, scale)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, ref_lse, delta, True, scale)
    for name, key, got, ref in (("flash_bwd_dq", "dq", dq, ref_dq), ("flash_bwd_dkv", "dk", dk, ref_dk),
                                ("flash_bwd_dkv", "dv", dv, ref_dv)):
        bound = chip_smoke.flash_rounding_bound(name, key, q, k, v, do, ref_lse, delta, True, scale)
        _assert_within(got, ref, NARROW[dtype], bound, key)


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("causal,s,sk", [(True, 192, 192), (False, 128, 200), (True, 64, 200),
                                         (True, 130, 250), (True, 1024, 1024)],
                         ids=["causal", "full-ragged", "causal-cross", "causal-ragged", "causal-1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_match_plain_versions_at_family_head_dims(cuda, dtype, causal, s, sk, d):
    """`test_flash_kernels_match_plain_versions` at GPT-NeoX-20B's head dim
    96 (three 64B-swizzled panels; scalar rows of 12 dims over 8 lanes) and
    GPT-J-6B's 256 (four 128B-swizzled panels; K4 over two column halves;
    scalar blocks of 32 rows)."""
    test_flash_kernels_match_plain_versions(cuda, dtype, causal, s, sk, d)


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_keep_to_their_head_at_family_head_dims(cuda, dtype, d):
    test_flash_kernels_keep_to_their_head(cuda, dtype, d)


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_softmax_rescales_large_scores_at_family_head_dims(cuda, d, dtype):
    test_flash_softmax_rescales_large_scores(cuda, d, dtype)


@pytest.mark.parametrize("causal,s,sk", [(True, 192, 192), (False, 128, 200), (True, 64, 200),
                                         (True, 130, 250), (True, 1024, 1024)],
                         ids=["causal", "full-ragged", "causal-cross", "causal-ragged", "causal-1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_match_plain_versions_at_head_dim_16(cuda, dtype, causal, s, sk):
    """`test_flash_kernels_match_plain_versions` at T5-tiny's head dim 16:
    one 32B-swizzled panel, the score product one k16 step, p.v and dK/dV
    m64n16 wgmmas; scalar rows of one thread."""
    test_flash_kernels_match_plain_versions(cuda, dtype, causal, s, sk, 16)


@pytest.mark.parametrize("s,sk", [(128, 256), (130, 250), (1024, 1024)], ids=["aligned", "ragged", "t5-tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_match_plain_versions_non_causal_at_head_dim_16(cuda, dtype, s, sk):
    """The non-causal mode at head dim 16 and scale 1.0, T5-tiny's
    cross-attention."""
    _hold_flash_kernels(cuda, dtype, False, s, sk, 16, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernels_keep_to_their_head_at_head_dim_16(cuda, dtype):
    test_flash_kernels_keep_to_their_head(cuda, dtype, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_softmax_rescales_large_scores_at_head_dim_16(cuda, dtype):
    test_flash_softmax_rescales_large_scores(cuda, 16, dtype)


def test_t5_tiny_at_head_dim_16_takes_the_flash_kernels(cuda, monkeypatch):
    """The repaired fault: an unmasked `t5-tiny` (d_kv 16) forward and
    backward at 1024 decoder over 1024 encoder tokens, f32, reaches the
    flash gate (the cross-attention: non-causal, scale 1.0) and launches
    K3-K5 on each of its 2 decoder layers, where it raised before; its loss
    equals the forced-plain run's within rtol 1e-5, and each parameter's
    gradient within `chip_smoke.T5_GRAD_RTOL` (the norm of the difference
    over the plain one's, as `chip_smoke.t5_f32_parity` holds T5)."""
    from accelerate_tpu_torch.models import create_named_model
    from accelerate_tpu_torch.models.t5 import seq2seq_lm_loss

    rng = np.random.default_rng(16)
    batch = {"input_ids": torch.as_tensor(rng.integers(1, 512, (1, 1024)), device=cuda),
             "decoder_input_ids": torch.as_tensor(rng.integers(1, 512, (1, 1024)), device=cuda),
             "labels": torch.as_tensor(rng.integers(0, 512, (1, 1024)), device=cuda)}
    runs = {}
    for impl in ("flash", "xla"):
        if impl == "xla":
            monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "xla")
        model = create_named_model("t5-tiny", seed=2, device=cuda)
        assert model.config.d_kv == 16
        fa.reset_launch_counts()
        loss = seq2seq_lm_loss(batch, model)
        loss.backward()
        torch.cuda.synchronize()
        n = model.config.num_decoder_layers if impl == "flash" else 0
        assert fa.LAUNCHES == _launched(fa.LAUNCHES, torch.float32, n), impl
        runs[impl] = (float(loss.detach()), {k: p.grad for k, p in model.named_parameters()})
    assert abs(runs["flash"][0] - runs["xla"][0]) <= 1e-5 * abs(runs["xla"][0])
    for name, g in runs["xla"][1].items():
        diff = float((runs["flash"][1][name] - g).norm() / g.norm().clamp_min(1e-30))
        assert diff <= chip_smoke.T5_GRAD_RTOL, (name, diff)


def test_bf16_flash_path_runs_the_tensor_core_kernels(cuda):
    """On bf16 CUDA tensors K3, K4 and K5 launch the wgmma kernels (the
    profiler's kernel names say so) and f32 the scalar ones, each call one
    launch; a tensor the TMA path cannot take raises before any launch."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = _flash_case(cuda, dtype, 2, 128, 128, 64)
        lse = torch.zeros(q.shape[:2], device=cuda)
        before = dict(fa.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_fwd(q, k, v, causal=True)
            fa.flash_bwd_dkv(q, k, v, do, lse, lse, causal=True)
            fa.flash_bwd_dq(q, k, v, do, lse, lse, causal=True)
            torch.cuda.synchronize()
        assert {key: fa.LAUNCHES[key] - before[key] for key in before} == _launched(before, dtype)
        names[dtype] = " ".join(e.key for e in prof.key_averages())
    for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert f"{kernel}_wgmma_kernel" in names[torch.bfloat16], kernel
        assert f"{kernel}_kernel" in names[torch.float32], kernel
    assert "wgmma" not in names[torch.float32]

    q, k, v, _ = _flash_case(cuda, torch.bfloat16, 2, 64, 64, 64)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)  # 2 bytes off
    shifted.copy_(q)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(shifted, k, v, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous())
    assert fa.LAUNCHES == before


def test_fp16_flash_path_runs_the_fp16_tensor_core_kernels(cuda):
    """fp16 K3, K4 and K5 launch the wgmma kernels' fp16 instantiations,
    each call one launch counted under its `_f16` name."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do = _flash_case(cuda, torch.float16, 2, 128, 128, 64)
    lse = torch.zeros(q.shape[:2], device=cuda)
    before = dict(fa.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_fwd(q, k, v, causal=True)
        fa.flash_bwd_dkv(q, k, v, do, lse, lse, causal=True)
        fa.flash_bwd_dq(q, k, v, do, lse, lse, causal=True)
        torch.cuda.synchronize()
    assert {key: fa.LAUNCHES[key] - before[key] for key in before} == _launched(before, torch.float16)
    names = " ".join(e.key for e in prof.key_averages())
    for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert f"{kernel}_wgmma_kernel<__half" in names, kernel


def test_fp16_flash_kernels_refuse_mixed_types(cuda):
    """fp16 q beside an fp16 lse (it must be f32), an f32 k or a bf16 dO is
    refused before any launch."""
    q, k, v, do = _flash_case(cuda, torch.float16, 2, 64, 64, 64)
    lse = torch.zeros(q.shape[:2], device=cuda)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="lse must be torch.float32"):
        fa.flash_bwd_dq(q, k, v, do, lse.half(), lse, causal=True)
    with pytest.raises(ValueError, match="k must be torch.float16"):
        fa.flash_fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="do must be torch.float16"):
        fa.flash_bwd_dkv(q, k, v, do.bfloat16(), lse, lse, causal=True)
    assert fa.LAUNCHES == before


def test_fp16_range_case(cuda):
    """chip_smoke's range case: dO and V large, as under loss scaling, so
    that the plain version's dS passes fp16's 65504 while dk, dv and dq fit;
    fp16 K4 and K5 write finite values within the fp16 limit (the function
    raises otherwise)."""
    rows = chip_smoke.flash_range_case(cuda)
    for name, row in rows.items():
        assert row["plain_ds_abs_max"] > chip_smoke.FP16_MAX, name
        assert all(entry["limit"]["broken"] == 0 for entry in row["errors"].values()), name


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, _ = _flash_case(cuda, torch.float32, 2, 64, 64, 64)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fa.flash_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1))
    with pytest.raises(ValueError, match="Sq <= Skv"):
        fa.flash_fwd(q, k[:, :32], v[:, :32], causal=True)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_fwd(q, k.cpu(), v)


def test_flash_attention_grads_through_autograd(cuda):
    """The public [B, S, H, D] op with GQA: forward and grads through the
    kernels equal autograd through the plain attention in f32."""
    from accelerate_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=cuda).requires_grad_()
               for shape in ((2, 256, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64)))
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = dot_product_attention(q, k, v, causal=True, implementation="xla")
    ref_grads = torch.autograd.grad(ref.square().sum(), (q, k, v))
    torch.testing.assert_close(out, ref, **F32)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **F32_GRAD)


def test_fused_training_steps_through_the_kernels(cuda, monkeypatch):
    """`llama_tiny` (head 32) trained on the card through `Accelerator.prepare`
    and `train_step`, sequence 128 with the flash path forced: three f32
    steps through K3-K5 give the losses of the plain attention (rtol 1e-4, as
    `chip_smoke.py`), and each kernel launches 2 layers x 3 steps times."""
    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader, create_llama_model
    from accelerate_tpu_torch.models import llama_tiny
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    rows = np.random.default_rng(3).integers(0, 512, (12, 128))
    data = [{"input_ids": r} for r in rows]
    losses = {}
    try:
        for impl in ("flash", "xla"):
            monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", impl)
            AcceleratorState._reset_state()
            GradientState._reset_state()
            model = create_llama_model(llama_tiny(), seed=1, device=cuda)
            accelerator = Accelerator()
            optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
            _, _, loader = accelerator.prepare(model, optimizer, SimpleDataLoader(data, BatchSampler(range(12), 4)))
            step_fn = accelerator.train_step(max_grad_norm=1.0)
            fa.reset_launch_counts()
            losses[impl] = [float(step_fn(b)) for b in loader]
            want = 6 if impl == "flash" else 0
            assert fa.LAUNCHES == {key: 0 if key.endswith("_f16") else want for key in fa.LAUNCHES}
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=1e-4)
    assert losses["flash"][-1] < losses["flash"][0]


def _tiny_pair(cuda):
    """llama_tiny in f32 on the CPU and the same weights on the card."""
    from accelerate_tpu_torch import create_llama_model
    from accelerate_tpu_torch.models import llama_tiny

    cpu = create_llama_model(llama_tiny(), seed=1, device="cpu")
    card = create_llama_model(llama_tiny(), seed=1, device="cpu").to(cuda)
    return cpu, card


def test_generate_on_the_card_matches_the_cpu_port(cuda):
    """f32 greedy tokens of `generate` on the card equal the CPU port's:
    uniform, left-padded, penalized and speculative."""
    from accelerate_tpu_torch import GenerationConfig, Generator

    cpu, card = _tiny_pair(cuda)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, (3, 40))
    mask = np.ones_like(ids)
    mask[0, :25], mask[1, :9] = 0, 0
    cases = [(ids, None, {}), (ids, mask, {}), (ids, None, dict(repetition_penalty=1.3)),
             (ids[:1], None, dict(draft_tokens=4))]
    on_cpu, on_card = Generator(cpu, device="cpu"), Generator(card)
    for prompt, m, extra in cases:
        config = GenerationConfig(max_new_tokens=24, **extra)
        got = on_card(prompt, config, attention_mask=m)
        assert got.device.type == "cuda"
        assert got.cpu().tolist() == on_cpu(prompt, config, attention_mask=m).tolist(), extra


def test_contiguous_engine_matches_paged_on_the_card(cuda):
    from accelerate_tpu_torch import ContinuousBatcher, Request

    _, card = _tiny_pair(cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, (int(n),)) for n in (5, 40, 17, 60)]
    runs = {}
    for paged in (True, False):
        for penalty in (False, True):
            engine = ContinuousBatcher(card, num_slots=2, max_length=128, chunk_size=4, paged=paged,
                                       use_repetition_penalty=penalty)
            out = engine.run([Request(i, p, max_new_tokens=20, repetition_penalty=1.2)
                              for i, p in enumerate(prompts)])
            runs[paged, penalty] = {rid: list(map(int, t)) for rid, t in out.items()}
    assert runs[True, False] == runs[False, False]
    assert runs[True, True] == runs[False, True] != runs[True, False]


def test_generate_and_contiguous_engine_launch_no_kernel(cuda):
    """The generate path and the contiguous engine attend plainly (masked
    attention never takes the flash gate; the contiguous layout has no page
    table): no K1-K5 launch count moves."""
    from accelerate_tpu_torch import ContinuousBatcher, GenerationConfig, Generator, Request

    _, card = _tiny_pair(cuda)
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    gen = Generator(card)
    ids = np.random.default_rng(5).integers(0, 512, (2, 200))
    gen(ids, GenerationConfig(max_new_tokens=16))
    gen(ids[:1], GenerationConfig(max_new_tokens=16, draft_tokens=4))
    engine = ContinuousBatcher(card, num_slots=2, max_length=256, chunk_size=4, paged=False)
    engine.run([Request(0, ids[0], max_new_tokens=8)])
    assert not any(pa.LAUNCHES.values()) and not any(fa.LAUNCHES.values())


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_launches_the_flash_forward_again_and_keeps_the_losses(cuda, monkeypatch, policy):
    """`llama_tiny` trained on the card with the flash path forced, f32, under
    `CompilationConfig(remat_policy=...)`: K3 launches twice per layer step
    (the forward, then the recompute in the backward), K4 and K5 once, and
    the losses equal those without remat within rtol 1e-6."""
    from accelerate_tpu_torch import (Accelerator, BatchSampler, CompilationConfig, SimpleDataLoader,
                                      create_llama_model)
    from accelerate_tpu_torch.models import llama_tiny
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "flash")
    rows = np.random.default_rng(3).integers(0, 512, (12, 128))
    data = [{"input_ids": r} for r in rows]
    losses, launches = {}, {}
    try:
        for remat in (None, policy):
            AcceleratorState._reset_state()
            GradientState._reset_state()
            model = create_llama_model(llama_tiny(), seed=1, device=cuda)
            accelerator = Accelerator(compilation_config=CompilationConfig(remat_policy=remat))
            optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
            _, _, loader = accelerator.prepare(model, optimizer, SimpleDataLoader(data, BatchSampler(range(12), 4)))
            step_fn = accelerator.train_step(max_grad_norm=1.0)
            fa.reset_launch_counts()
            losses[remat] = [float(step_fn(b)) for b in loader]
            launches[remat] = dict(fa.LAUNCHES)
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
    assert launches[None] == {key: 0 if key.endswith("_f16") else 6 for key in fa.LAUNCHES}
    assert launches[policy] == {**launches[None], "flash_fwd": 12}
    np.testing.assert_allclose(losses[policy], losses[None], rtol=1e-6)


def test_bert_logits_on_the_card_match_the_cpu(cuda):
    """f32 `bert-base` on one batch with a padding mask and token types: the
    card's logits equal the CPU's within atol 1e-4 (TF32 off)."""
    from accelerate_tpu_torch import create_named_model
    from accelerate_tpu_torch.models import bert_base

    cpu = create_named_model("bert-base", seed=0, device="cpu")
    card = create_named_model("bert-base", seed=0, device="cpu").to(cuda)
    ids, mask, types = chip_smoke.bert_batch(bert_base(), 4, 128)
    with torch.no_grad():
        ref = cpu(ids, mask, types)
        got = card(ids.to(cuda), mask.to(cuda), types.to(cuda))
    assert got.device.type == "cuda" and got.shape == (4, 2)
    torch.testing.assert_close(got.cpu(), ref, atol=chip_smoke.BERT_LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gpt-neox-tiny", "gptj-tiny", "opt-tiny"])
def test_family_on_the_card_matches_the_cpu_port(cuda, name):
    """Each family's tiny model, f32: logits on the card equal the CPU
    port's (atol 1e-4), and greedy `generate` gives the CPU's tokens."""
    from accelerate_tpu_torch import GenerationConfig, Generator, create_named_model

    cpu = create_named_model(name, seed=1, device="cpu")
    card = create_named_model(name, seed=1, device="cpu").to(cuda)
    ids = np.random.default_rng(5).integers(0, 512, (2, 40))
    with torch.no_grad():
        torch.testing.assert_close(card(torch.as_tensor(ids, device=cuda)).cpu(), cpu(torch.as_tensor(ids)),
                                   atol=1e-4, rtol=0)
    config = GenerationConfig(max_new_tokens=16)
    assert Generator(card)(ids, config).cpu().tolist() == Generator(cpu, device="cpu")(ids, config).tolist()


def test_neox_engine_kernel_path_matches_gather_path(cuda):
    """GPT-NeoX (Hq = Hkv, partial rotary, biases) through the engine on the
    card: the paged_kernel path's greedy tokens equal the gather path's,
    plain and speculative, unquantized and with int8 weights over an int8
    cache, and K1 (K2) launches layers x decode steps times."""
    from accelerate_tpu_torch import ContinuousBatcher, Request, create_named_model

    model = create_named_model("gpt-neox-tiny", seed=2, device=cuda)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, (int(n),)) for n in (5, 40, 17, 60)]
    for quant in ({}, dict(weight_dtype="int8", kv_cache_dtype="int8")):
        for spec in (False, True):
            runs = {}
            for impl in ("gather", "paged_kernel"):
                pa.reset_launch_counts()
                engine = ContinuousBatcher(model, num_slots=2, max_length=128, chunk_size=4, attention_impl=impl,
                                           speculative=spec, **quant)
                out = engine.run([Request(i, p, max_new_tokens=20) for i, p in enumerate(prompts)])
                runs[impl] = {rid: list(map(int, t)) for rid, t in out.items()}
                key = ("verify" if spec else "decode") + ("_int8" if quant else "")
                n = model.config.num_hidden_layers * engine.stats["decode_steps"] if impl == "paged_kernel" else 0
                assert pa.LAUNCHES == {k: n if k == key else 0 for k in pa.LAUNCHES}
            assert runs["gather"] == runs["paged_kernel"], (quant, spec)


@pytest.mark.parametrize("name", ["gpt-neox-tiny", "gptj-tiny", "opt-tiny"])
def test_family_training_steps_through_the_kernels(cuda, monkeypatch, name):
    """Each family's tiny model trained on the card, sequence 128, the flash
    path forced: three f32 steps through K3-K5 give the plain attention's
    losses (rtol 1e-4), each kernel launching 2 layers x 3 steps times."""
    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader, create_named_model
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    rows = np.random.default_rng(3).integers(0, 512, (12, 128))
    data = [{"input_ids": r} for r in rows]
    losses = {}
    try:
        for impl in ("flash", "xla"):
            monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", impl)
            AcceleratorState._reset_state()
            GradientState._reset_state()
            model = create_named_model(name, seed=1, device=cuda)
            accelerator = Accelerator()
            optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
            _, _, loader = accelerator.prepare(model, optimizer, SimpleDataLoader(data, BatchSampler(range(12), 4)))
            step_fn = accelerator.train_step(max_grad_norm=1.0)
            fa.reset_launch_counts()
            losses[impl] = [float(step_fn(b)) for b in loader]
            want = 6 if impl == "flash" else 0
            assert fa.LAUNCHES == {key: 0 if key.endswith("_f16") else want for key in fa.LAUNCHES}
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=1e-4)
    assert losses["flash"][-1] < losses["flash"][0]


def test_t5_on_the_card_matches_the_cpu_port(cuda):
    """t5_tiny, f32: logits on the card equal the CPU port's (atol 1e-4),
    with and without an encoder attention mask, and `Seq2SeqGenerator`'s
    greedy tokens equal the CPU's; no K1-K5 kernel launches."""
    from accelerate_tpu_torch import Seq2SeqGenerator, create_named_model

    cpu = create_named_model("t5-tiny", seed=1, device="cpu")
    card = create_named_model("t5-tiny", seed=1, device="cpu").to(cuda)
    rng = np.random.default_rng(8)
    ids, dec = rng.integers(1, 512, (3, 40)), rng.integers(1, 512, (3, 12))
    mask = np.ones_like(ids)
    mask[1, 25:] = 0
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        for m in (None, mask):
            got = card(*(torch.as_tensor(x, device=cuda) for x in (ids, dec)),
                       None if m is None else torch.as_tensor(m, device=cuda))
            ref = cpu(torch.as_tensor(ids), torch.as_tensor(dec), None if m is None else torch.as_tensor(m))
            torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=0)
    for m in (None, mask):
        kw = {} if m is None else {"attention_mask": m}
        on_card = Seq2SeqGenerator(card, max_new_tokens=12)(ids, **kw)
        assert on_card.device.type == "cuda"
        assert on_card.cpu().tolist() == Seq2SeqGenerator(cpu, max_new_tokens=12, device="cpu")(ids, **kw).tolist()
    assert fa.LAUNCHES == before


def test_t5_training_steps_through_the_non_causal_kernels(cuda, monkeypatch):
    """A tiny T5 (head 32) at 1024 encoder and decoder tokens, f32: its
    cross-attention takes the flash gate (non-causal, scale 1.0; the biased
    self-attention stays plain), and three AdamW steps give the plain
    attention's losses (rtol 1e-4), each kernel launching 2 decoder layers
    x 3 steps times."""
    import dataclasses

    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader
    from accelerate_tpu_torch.models import create_t5_model, t5_tiny
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    cfg = dataclasses.replace(t5_tiny(), d_kv=32)
    rng = np.random.default_rng(4)
    data = [{"input_ids": rng.integers(1, 512, (1024,)), "decoder_input_ids": rng.integers(1, 512, (1024,)),
             "labels": rng.integers(0, 512, (1024,))} for _ in range(6)]
    losses = {}
    try:
        for impl in ("flash", "xla"):
            if impl == "xla":
                monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "xla")
            AcceleratorState._reset_state()
            GradientState._reset_state()
            model = create_t5_model(cfg, seed=1, device=cuda)
            accelerator = Accelerator()
            optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
            _, _, loader = accelerator.prepare(model, optimizer, SimpleDataLoader(data, BatchSampler(range(6), 2)))
            step = accelerator.train_step(max_grad_norm=1.0)
            fa.reset_launch_counts()
            losses[impl] = [float(step(batch)) for batch in loader]
            n = 2 * 3 if impl == "flash" else 0
            assert fa.LAUNCHES == _launched(fa.LAUNCHES, torch.float32, n), impl
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=1e-4)


def test_mixtral_training_step_launches_the_flash_kernels_at_head_dim_128(cuda, monkeypatch):
    """One f32 `train_step` of a `mixtral_tiny` widened to head dim 128 (4
    heads of 128 over 2 KV heads) on 1024 tokens, where the flash gate
    opens: K3-K5 each launch once per layer, the router losses come back
    finite, and the loss equals the forced-plain run's (rtol 1e-4)."""
    import dataclasses

    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader
    from accelerate_tpu_torch.models import create_mixtral_model, mixtral_tiny
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    cfg = dataclasses.replace(mixtral_tiny(), hidden_size=512, max_position_embeddings=1024)
    assert cfg.head_dim == 128
    data = [{"input_ids": np.random.default_rng(10).integers(0, cfg.vocab_size, (1024,))}]
    losses = {}
    try:
        for impl in ("flash", "xla"):
            if impl == "xla":
                monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "xla")
            AcceleratorState._reset_state()
            GradientState._reset_state()
            model = create_mixtral_model(cfg, seed=1, device=cuda)
            accelerator = Accelerator()
            optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
            _, _, loader = accelerator.prepare(model, optimizer, SimpleDataLoader(data, BatchSampler(range(1), 1)))
            step = accelerator.train_step(max_grad_norm=1.0)
            fa.reset_launch_counts()
            loss, aux = step(next(iter(loader)))
            torch.cuda.synchronize()
            n = cfg.num_hidden_layers if impl == "flash" else 0
            assert fa.LAUNCHES == _launched(fa.LAUNCHES, torch.float32, n), impl
            assert sorted(aux) == ["ce", "load_balance_loss", "router_z_loss"]
            assert all(np.isfinite(float(v)) for v in aux.values())
            losses[impl] = float(loss)
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=1e-4)


def test_hf_checkpoint_loads_into_a_bf16_llama_on_the_card(cuda, tmp_path):
    """An HF checkpoint written from a CPU model loads into a bf16 Llama on
    the card: every tensor stays bf16 on the card and equals the CPU
    model's rounded to bf16; the bf16 engine then serves it through K1."""
    from accelerate_tpu_torch import ContinuousBatcher, Request, create_named_model
    from accelerate_tpu_torch.utils.hf_loading import load_hf_checkpoint_in_model, save_hf_checkpoint

    cpu = create_named_model("llama-tiny", seed=1, device="cpu")
    path = str(tmp_path / "model.safetensors")
    save_hf_checkpoint(cpu, "llama", cpu.config, path)
    card = create_named_model("llama-tiny", seed=2, dtype=torch.bfloat16, device=cuda)
    load_hf_checkpoint_in_model(card, path, "llama")
    want = cpu.state_dict()
    for name, t in card.state_dict().items():
        assert t.dtype == torch.bfloat16 and t.device.type == "cuda", name
        assert torch.equal(t.cpu(), want[name].bfloat16()), name
    pa.reset_launch_counts()
    engine = ContinuousBatcher(card, num_slots=2, max_length=128, chunk_size=4)
    out = engine.run([Request(0, np.arange(1, 30), max_new_tokens=8)])
    assert len(out[0]) == 8 and pa.LAUNCHES["decode"] == card.config.num_hidden_layers * engine.stats["decode_steps"]


@pytest.mark.parametrize("tokens,n_in,n_out", [(64, 128, 96), (4096, 2048, 512), (96, 32, 16)])
def test_fp8_products_run_scaled_mm_within_the_limit(cuda, tokens, n_in, n_out):
    """`fp8_matmul` on CUDA tensors runs `_scaled_mm`: forward, dx and dw
    (HYBRID: the gradient in e5m2) within `chip_smoke`'s fp8 limit of the
    plain version on the same fp8 operands and scales (one bf16 rounding and
    the tensor cores' accumulation), each counted once."""
    from accelerate_tpu_torch.ops import fp8 as pfp8

    pfp8.reset_product_counts()
    report = chip_smoke.fp8_product_case(cuda, tokens, n_in, n_out, timed=False)
    assert pfp8.PRODUCTS == {"fwd": 1, "dx": 1, "dw": 1}
    assert all(report[role]["limit"]["broken"] == 0 for role in ("fwd", "dx", "dw")), report


def test_fp8_product_of_a_shape_scaled_mm_refuses_raises(cuda):
    """A dimension that is not a multiple of 16 raises on the card: nothing
    falls back to the plain product."""
    from accelerate_tpu_torch.ops import fp8 as pfp8

    x = torch.randn(8, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        pfp8.fp8_matmul(x, torch.randn(24, 8, device=cuda, dtype=torch.bfloat16))


def test_trace_guard_names_a_planted_item_and_passes_a_sanctioned_readback(cuda):
    """The sync guard on the card: a `.item()` on a CUDA tensor inside a
    wrapped step raises TraceGuardViolation naming its line; the same read
    under `allow_sync` passes; a record-mode guard counts it once; the
    sync-debug mode is back to what it was after each window."""
    from accelerate_tpu_torch.analysis import TraceGuard, TraceGuardViolation, allow_sync

    x = torch.ones(4, device=cuda)

    def step(sanctioned):
        y = x * 2
        if sanctioned:
            with allow_sync():
                return y.sum().item()
        return y.sum().item()  # the planted sync

    site = f"{__file__}:{step.__code__.co_firstlineno + 5}"
    guard = TraceGuard(name="planted")
    wrapped = guard.wrap(step, warmup=0)
    assert wrapped(True) == 8.0 and guard.host_transfers == 0
    with pytest.raises(TraceGuardViolation) as excinfo:
        wrapped(False)
    assert site in str(excinfo.value), (site, str(excinfo.value))
    assert torch.cuda.get_sync_debug_mode() == 0
    recorder = TraceGuard(name="planted-record", on_violation="record")
    with pytest.raises(RuntimeError):
        recorder.wrap(step, warmup=0)(False)
    assert recorder.host_transfers == 1 and site in recorder.transfer_violations[0]
    log = TraceGuard(name="planted-log", transfer_guard="log", on_violation="record")
    with log:
        assert step(False) == 8.0
    assert log.host_transfers == 1 and site in log.transfer_violations[0]
    assert torch.cuda.get_sync_debug_mode() == 0


def test_warm_engine_and_fused_step_make_no_unsanctioned_sync(cuda):
    """llama_tiny on the card: a warm paged engine's steps and an
    `Accelerator(analyze=True)` fused step's steady calls build nothing and
    make no host sync outside the sanctioned pushes and readbacks."""
    from accelerate_tpu_torch import (Accelerator, BatchSampler, ContinuousBatcher, Request, SimpleDataLoader,
                                      create_llama_model)
    from accelerate_tpu_torch.analysis import TraceGuard
    from accelerate_tpu_torch.models import llama_tiny

    model = create_llama_model(llama_tiny(), seed=1, device=cuda)
    engine = ContinuousBatcher(model, num_slots=2, max_length=128, chunk_size=4)
    engine.run([Request(0, np.arange(1, 30), max_new_tokens=8)])
    guard = TraceGuard(name="engine", transfer_guard="log", on_violation="record")
    engine.trace_guard = guard
    with guard:
        engine.run([Request(1, np.arange(3, 40), max_new_tokens=8), Request(2, np.arange(5, 20), max_new_tokens=6)])
    assert guard.total_recompiles == 0 and guard.host_transfers == 0, guard.report().summary()

    accelerator = Accelerator(mixed_precision="bf16", analyze=True)
    train_model = create_llama_model(llama_tiny(), seed=1, device=cuda)
    ids = np.random.default_rng(0).integers(0, 128, (12, 64))
    loader = SimpleDataLoader([{"input_ids": row} for row in ids], BatchSampler(range(12), 2))
    _, _, loader = accelerator.prepare(train_model, torch.optim.AdamW(train_model.parameters(), lr=1e-3), loader)
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    losses = [step_fn(batch) for batch in loader]
    assert accelerator.trace_guard.steps == 4 and accelerator.trace_guard.host_transfers == 0
    assert all(np.isfinite(float(loss)) for loss in losses)


def test_nccl_world_one_strategies_match_the_bare_step(cuda):
    """NCCL at world 1 (the launcher's variables set for the run and put
    back; `chip_smoke.world_one_group`): a 2-layer Llama at llama_tiny's
    widths, 1024 tokens a row so that the flash gate opens, through
    NO_SHARD and FULL_SHARD beside the bare `Accelerator`. The backend is
    nccl; NO_SHARD's losses equal the bare step's within rtol 1e-6 and
    FULL_SHARD's within 1e-2 (`chip_smoke.DIST_*_RTOL`); K3, K4 and K5 are
    each launched layers x steps times in every run; no group is left."""
    from accelerate_tpu_torch.models import llama_tiny

    config = llama_tiny()
    runs = {s: chip_smoke.dist_run(cuda, config, s, batch=2, seq=1024, warmup=1, timed_steps=2)
            for s in ("bare", "NO_SHARD", "FULL_SHARD")}
    base = runs["bare"]["losses"]
    want = chip_smoke.expected_launches(config.num_hidden_layers * 3, torch.bfloat16)
    for strategy, run in runs.items():
        assert run["launches"] == want, (strategy, run["launches"])
        assert run["backend"] == (None if strategy == "bare" else "nccl")
        assert all(np.isfinite(run["losses"]))
    np.testing.assert_allclose(runs["NO_SHARD"]["losses"], base, rtol=chip_smoke.DIST_NO_SHARD_RTOL, atol=0)
    np.testing.assert_allclose(runs["FULL_SHARD"]["losses"], base, rtol=chip_smoke.DIST_SHARDED_RTOL, atol=0)
    assert not torch.distributed.is_initialized()


def _deep_opt(layers=7):
    import dataclasses

    from accelerate_tpu_torch.models import create_opt_model, opt_tiny

    cfg = dataclasses.replace(opt_tiny(), num_hidden_layers=layers, max_position_embeddings=2048)
    return cfg, lambda: create_opt_model(cfg, seed=3, dtype=torch.bfloat16, device="cuda")


@pytest.mark.parametrize("pattern", [("cpu", 0, "disk", "disk", 0, "cpu", "cpu"), ("disk",) * 7])
def test_streamed_opt_equals_resident_through_pinned_copies(cuda, pattern, tmp_path):
    """A 7-layer bf16 OPT streamed over pinned host RAM and the disk store
    on the side stream: the first logits and 4 greedy tokens equal the
    resident model's bit for bit at 1024 tokens (K3 at every layer), every
    copy came from pinned memory, and a second call reuses the slots."""
    from accelerate_tpu_torch.big_modeling import dispatch_model
    from accelerate_tpu_torch.models import OPTLayeredApply

    cfg, make = _deep_opt()
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=torch.Generator().manual_seed(0)).cuda()
    resident = dispatch_model(make(), {"": 0})
    want, want_tokens = resident(ids), resident.generate(ids, max_new_tokens=4)
    device_map = {"params/embed_positions": 0, "params/embed_tokens": 0, "params/final_norm": 0,
                  **{f"params/layer_{i}": tier for i, tier in enumerate(pattern)}}
    dm = dispatch_model(make(), device_map, offload_folder=str(tmp_path), layered=OPTLayeredApply(cfg))
    before = dict(fa.LAUNCHES)
    assert torch.equal(dm(ids), want) and torch.equal(dm(ids), want)
    assert fa.LAUNCHES["flash_fwd"] - before["flash_fwd"] == 2 * cfg.num_hidden_layers
    assert torch.equal(dm.generate(ids, max_new_tokens=4), want_tokens)
    assert dm.transfer_stats["pageable"] == 0 and dm.transfer_stats["copies"] > 0


def test_quantized_codes_on_the_card_equal_the_cpus(cuda):
    """int8, int4 and nf4 codes and scales made on the card equal the CPU's
    bit for bit (CUDA divides by a Python number through its reciprocal;
    the port divides by a device tensor)."""
    from accelerate_tpu_torch.utils import quantization as q

    w = torch.randn(257, 384, generator=torch.Generator().manual_seed(1)) * 0.05
    for fn in (q.quantize_int8, q.quantize_int4, q.quantize_nf4):
        cpu, card = fn(w), fn(w.cuda())
        assert torch.equal(card.q.cpu(), cpu.q) and torch.equal(card.scale.cpu(), cpu.scale)
