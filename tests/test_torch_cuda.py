"""Tests of the port that need an NVIDIA card: the hand-written kernels have
no CPU mode. Each skips, with its reason, where `torch.cuda.is_available()`
is False, deciding inside the test.

This file imports no JAX, so it also runs on a card's machine that has none:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

(`--noconftest` skips `tests/conftest.py`, which sets JAX up for the rest of
the suite.) Tolerances are those of `chip_smoke.py`: f32 atol 2e-5; bf16 atol
2e-3, rtol 1e-2, one bf16 rounding of the output above the fp32 summation
order, and well below the small outputs of long slots.
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=0.0)
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
