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
plain version's matmuls: atol/rtol 1e-4. The quantized mode of the paged
kernels dequantizes exactly as its plain version does (one f32 multiply per
value), so the same tolerances hold.
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops import quantization as qz

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=0.0)
F32_GRAD = dict(atol=1e-4, rtol=1e-4)
LSE = dict(atol=2e-5, rtol=1e-5)
BF16 = dict(atol=2e-3, rtol=1e-2)


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


def _flash_case(device, dtype, bh, s, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    to = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device).to(dtype)  # noqa: E731
    return to(bh, s, d), to(bh, sk, d), to(bh, sk, d), to(bh, s, d)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,s,sk", [(True, 192, 192), (False, 128, 200), (True, 64, 200)],
                         ids=["causal", "full-ragged", "causal-cross"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, s, sk, d):
    """K3, K4 and K5 against their plain versions on the same inputs, each
    launched once; Sk = 200 leaves a ragged last tile."""
    q, k, v, do = _flash_case(cuda, dtype, 3, s, sk, d, seed=d + s)
    scale = d ** -0.5
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert {key: fa.LAUNCHES[key] - before[key] for key in before} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    tol, grad_tol = (F32, F32_GRAD) if dtype == torch.float32 else (BF16, BF16)
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (3, s)
    torch.testing.assert_close(o.float(), ref_o.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **LSE)
    # The backward against its plain version from the same o and lse.
    ref_dq, ref_dk, ref_dv = fa.flash_bwd_reference(q, k, v, o, lse, do, causal, scale)
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        torch.testing.assert_close(got.float(), ref.float(), **grad_tol, msg=lambda m: f"{name}: {m}")


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, _ = _flash_case(cuda, torch.float32, 2, 64, 64, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), k.half(), v.half())
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
            assert fa.LAUNCHES == {key: want for key in fa.LAUNCHES}
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=1e-4)
    assert losses["flash"][-1] < losses["flash"][0]
